"""Encoder visualizations (counterpart of
latentsplat_tpu/model/encoder/visualization.py): epipolar samples, depth,
Gaussians, attention, and PLY export of a prediction.

`capture_attention` runs the encoder once with forward hooks, as the
reference's visualizer did: on each attention module's softmax (`attend`)
and on the epipolar transformer, whose sampling the panels draw. The
panels draw on the context's device (`visualization.drawing`) and are
assembled on the host (numpy), like every labeled image of the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ...misc.heterogeneous_pairings import generate_heterogeneous_index
from ...ops.gaussians import covariance_to_scale_rotation
from ...visualization.annotation import add_label
from ...visualization.color_map import apply_color_map, apply_depth_color_map, turbo
from ...visualization.colors import get_distinct_color
from ...visualization.drawing.lines import draw_lines
from ...visualization.drawing.points import draw_points
from ...visualization.layout import add_border, hcat, vcat
from ..ply_export import export_ply
from .epipolar_sampler import sample_epipolar_features


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _ray_indices(n: int, num_rays: int) -> np.ndarray:
    return np.linspace(0, n - 1, num_rays).astype(int)


def visualize_epipolar_samples(
    context: dict, sampling, ray_indices: Optional[np.ndarray] = None, num_rays: int = 8,
) -> np.ndarray:
    """Chosen rays in view 0 and their epipolar samples in view 1."""
    images = context["image"][0]                         # (v, h, w, 3)
    xy_ray = sampling.xy_ray[0, 0]
    xy_ray = xy_ray.reshape(xy_ray.shape[0], -1)[:, :2]
    xy_sample = sampling.xy_sample[0, 0, 0]              # (ray, sample, 2)
    if ray_indices is None:
        ray_indices = _ray_indices(xy_ray.shape[0], num_rays)
    colors = turbo(np.linspace(0.15, 0.9, len(ray_indices)))

    left = draw_points(images[0], xy_ray[ray_indices], colors, radius=3.0)
    right = images[1 % images.shape[0]]
    for idx, color in zip(ray_indices, colors):
        points = xy_sample[idx]
        right = draw_lines(right, points[:-1], points[1:], color, radius=1.0)
        right = draw_points(right, points, color, radius=1.5)
    return add_border(hcat(add_label(_host(left), "Rays"), add_label(_host(right), "Epipolar Samples")))


def visualize_depth(context: dict, gaussians, gaussians_per_pixel: int) -> np.ndarray:
    """Each pixel's mean Gaussian distance from its camera, as a turbo map."""
    images = _host(context["image"][0])
    v, h, w = images.shape[:3]
    per_view = _host(gaussians.means[0]).reshape(v, -1, 3)
    origins = _host(context["extrinsics"][0, :, :3, 3])
    rows = []
    for i in range(v):
        dist = np.linalg.norm(per_view[i] - origins[i], axis=-1)
        dist = dist.reshape(-1, gaussians_per_pixel).mean(-1)
        side = int(np.sqrt(dist.shape[0] * w / h) + 0.5)
        try:
            depth_image = dist.reshape(h, w)
        except ValueError:
            depth_image = dist.reshape(dist.shape[0] // side if side else h, -1)
        rows.append(vcat(images[i], apply_depth_color_map(depth_image), gap=2))
    return add_border(add_label(hcat(*rows), "Depth"))


def capture_attention(
    encoder: torch.nn.Module, context: dict, global_step: int = 0, prefix: str = "",
) -> Dict:
    """Run the encoder deterministically, keeping what its visualizations
    need: {"gaussians": the encoder's output, "sampling": the epipolar
    transformer's EpipolarSampling (None without one), "attention":
    {module path: softmax weights (batch, heads, queries, keys)}} for every
    attention module whose path starts with `prefix` (the full-width DINO
    trunk's own weights take ~1 GB, so callers on the card pass
    "epipolar_transformer")."""
    captured: Dict = {"sampling": None, "attention": {}}
    handles = []

    def keep(path):
        def hook(module, args, output):
            captured["attention"][path] = output.detach()
        return hook

    def keep_sampling(module, args, output):
        captured["sampling"] = output[1]

    for name, module in encoder.named_modules():
        if name.endswith(".attend") and name.startswith(prefix):
            handles.append(module.register_forward_hook(keep(name[: -len(".attend")])))
        elif name == "epipolar_transformer":
            handles.append(module.register_forward_hook(keep_sampling))
    try:
        with torch.no_grad():
            captured["gaussians"] = encoder(context, global_step, deterministic=True)
    finally:
        for handle in handles:
            handle.remove()
    return captured


def export_gaussians_ply(gaussians, context: dict, path: Path) -> None:
    """The first scene's Gaussians as a PLY, in the frame of its first
    context camera."""
    with torch.no_grad():
        scales, rotations = covariance_to_scale_rotation(gaussians.covariances[0])
    export_ply(
        context["extrinsics"][0, 0], gaussians.means[0], scales, rotations,
        gaussians.color_harmonics[0], gaussians.opacities[0], Path(path),
    )


def visualize_overlaps(
    context: dict, sampling, downscale: int = 1, is_monocular: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Each view's valid-epipolar-sample masks, one per other view, tinted
    green over the image the JAX package tints (the view's own)."""
    images = _host(context["image"][0])
    v, h, w = images.shape[:3]
    valid = _host(sampling.valid[0]).astype(np.float32)
    green = np.asarray([0.235, 0.706, 0.294], np.float32)
    valid = valid.reshape(v, -1, h // downscale, w // downscale)
    valid = valid.repeat(downscale, axis=-2).repeat(downscale, axis=-1)
    index, _ = generate_heterogeneous_index(v)
    rows = []
    for i in range(v):
        tinted = [valid[i, j, :, :, None] * (green + images[index[i, j]]) / 2 for j in range(valid.shape[1])]
        rows.append(hcat(images[i], *tinted))
    vis = add_label(vcat(*rows), "Context Overlaps")
    if is_monocular is not None:
        mono = _host(is_monocular[0]).astype(np.float32)
        vis = hcat(vis, add_label(vcat(*[np.repeat(m[:, :, None], 3, axis=-1) for m in mono]), "Monocular?"))
    return add_border(vis)


def visualize_gaussians(context: dict, gaussians, gaussians_per_pixel: int) -> np.ndarray:
    """Grids of opacity, DC color (weighted by opacity and raw) and the
    covariance's determinant, per sample and view; Gaussians come ordered
    (view, row, column, sample) as the encoder emits them."""
    images = _host(context["image"][0])
    v, h, w = images.shape[:3]
    spp = gaussians_per_pixel
    opacities = _host(gaussians.opacities[0]).reshape(v, h, w, spp)
    colors = _host(gaussians.color_harmonics[0, :, :, 0]).reshape(v, h, w, spp, 3)
    det = np.linalg.det(_host(gaussians.covariances[0]))
    det = apply_color_map(det / max(det.max(), 1e-12), "inferno").reshape(v, h, w, spp, 3)

    def grid(x):
        return vcat(*[hcat(*[x[i, :, :, s] for i in range(v)]) for s in range(spp)])

    return add_border(
        hcat(
            add_label(hcat(*images), "Context"),
            add_label(grid(np.repeat(opacities[..., None], 3, axis=-1)), "Opacities"),
            add_label(grid(colors * opacities[..., None]), "Colors"),
            add_label(grid(colors), "Colors (Raw)"),
            add_label(grid(det), "Determinant"),
        )
    )


def _ray_view(image: torch.Tensor, xy_ray: torch.Tensor, ray_indices: np.ndarray):
    """The chosen rays in view 0, each ringed in black, and their colors."""
    colors = np.asarray([get_distinct_color(i) for i in range(len(ray_indices))])
    ray_view = draw_points(image, xy_ray[ray_indices], np.zeros((len(ray_indices), 3)), radius=4.0)
    return draw_points(ray_view, xy_ray[ray_indices], colors, radius=3.0), colors


def _paint_segments(image: torch.Tensor, sampling, ray_indices, weights: np.ndarray, colors, radius):
    """Each sample's segment of the chosen rays' epipolar lines, in its ray's
    color scaled by `weights` (ray, sample)."""
    near = sampling.xy_sample_near[0, 0, 0, ray_indices].reshape(-1, 2)
    far = sampling.xy_sample_far[0, 0, 0, ray_indices].reshape(-1, 2)
    seg_colors = (weights[:, :, None] * colors[:, None, :]).reshape(-1, 3)
    return draw_lines(image, near, far, seg_colors, radius=radius)


def visualize_probabilities(context: dict, sampling, pdf, num_rays: int = 8) -> np.ndarray:
    """A pdf (b, v, ray, sample) painted along the epipolar segments, raw
    and magnified per ray."""
    images = context["image"][0]
    ray_indices = _ray_indices(sampling.xy_ray.shape[2], num_rays)
    ray_view, colors = _ray_view(images[0], sampling.xy_ray[0, 0], ray_indices)
    p = np.asarray(_host(pdf) if isinstance(pdf, torch.Tensor) else pdf)[0, 0, ray_indices]
    other = images[1 % images.shape[0]]
    magnified = p / np.maximum(p.max(axis=1, keepdims=True), 1e-12)
    return add_border(
        hcat(
            add_label(_host(ray_view), "Rays"),
            add_label(_host(_paint_segments(other, sampling, ray_indices, p, colors, 3.0)), "Samples"),
            add_label(_host(_paint_segments(other, sampling, ray_indices, magnified, colors, 3.0)),
                      "Samples (Magnified PDF)"),
        )
    )


def visualize_attention_maps(context: dict, sampling, attention, num_rays: int = 8) -> np.ndarray:
    """Cross-attention weights (layer, head, ray, sample), of view 0's rays
    on view 1, painted along the epipolar segments, a panel per (layer,
    head)."""
    images = context["image"][0]
    ray_indices = _ray_indices(sampling.xy_ray.shape[2], num_rays)
    ray_view, colors = _ray_view(images[0], sampling.xy_ray[0, 0], ray_indices)
    attention = np.asarray(_host(attention) if isinstance(attention, torch.Tensor) else attention)
    attention = attention[:, :, ray_indices]
    other = images[1 % images.shape[0]]
    layers = []
    for il in range(attention.shape[0]):
        heads = [
            _host(_paint_segments(other, sampling, ray_indices, attention[il, ih], colors, 2.0))
            for ih in range(attention.shape[1])
        ]
        layers.append(add_label(vcat(*heads), f"Layer {il}"))
    keys = add_label(add_border(hcat(*layers)), "Keys & Values")
    return add_border(hcat(add_label(_host(ray_view), "Rays"), keys))


def visualize_epipolar_color_samples(context: dict, num_rays: int = 8, num_samples: int = 32) -> np.ndarray:
    """The sampler run over the raw images: each epipolar sample drawn in
    the color it samples from the other view, ringed in its ray's color."""
    images = context["image"]
    sampling = sample_epipolar_features(
        images, context["extrinsics"], context["intrinsics"], context["near"], context["far"],
        num_samples=num_samples,
    )
    ray_indices = _ray_indices(sampling.xy_ray.shape[2], num_rays)
    ray_view, colors = _ray_view(images[0, 0], sampling.xy_ray[0, 0], ray_indices)
    xy = sampling.xy_sample[0, 0, 0, ray_indices].reshape(-1, 2)
    rgb = sampling.features[0, 0, 0, ray_indices].reshape(-1, 3)
    sample_view = draw_points(images[0, 1 % images.shape[1]], xy, np.repeat(colors, num_samples, axis=0), radius=4.0)
    sample_view = draw_points(sample_view, xy, rgb, radius=3.0)
    return add_border(hcat(add_label(_host(ray_view), "Ray View"), add_label(_host(sample_view), "Sample View")))
