"""Rendering API (counterpart of `render` and `render_depth` in
latentsplat_tpu/ops/rasterize/api.py).

Per view: SH colors (+0.5, clamped at 0) and SH features (+0.5, no clamp)
evaluated towards the camera, or their DC coefficients as they are with
`use_sh=False`; the scene pre-normalized by 1/near when `scale_invariant`;
EWA projection, then the tiled (CUDA) or dense (oracle) compositor. Views
and scenes run in a Python loop and share the Gaussians. With `remat` each
view's render is checkpointed (non-reentrant): the backward renders the
view again, the kernels included, instead of keeping its pair buffers. `render_depth`
composites each view's camera-space depth (or its disparity, relative
disparity or log) as a 3-channel color. `render_orthographic` pulls a
camera far back along its look axis and renders through the tiled kernels,
each Gaussian's rect spanning its whole above-threshold footprint, so that
no pair the dense render draws is dropped.
"""

from __future__ import annotations

import dataclasses
from math import isqrt
from typing import Literal, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ...geometry.conversions import depth_to_relative_disparity
from ...geometry.projection import homogenize_points, invert_se3
from ..sh import eval_sh
from .camera import project_gaussians_to_screen
from .dense import composite_dense
from .tiled import composite_tiled, covering_cap, dense_extent
from .types import RenderOutput

DepthRenderingMode = Literal["depth", "disparity", "relative_disparity", "log"]


def view_channels(
    means: torch.Tensor, color_sh: Optional[torch.Tensor],
    feature_sh: Optional[torch.Tensor], camera: torch.Tensor, use_sh: bool = True,
) -> torch.Tensor:
    """Per-Gaussian composited payload for one camera position: (G, C).
    Without `use_sh` the DC coefficients are the payload as they are."""
    if not use_sh:
        return torch.cat([sh[..., 0] for sh in (color_sh, feature_sh) if sh is not None], dim=-1)
    direction = means - camera[None, :]
    direction = direction / (torch.linalg.norm(direction, dim=-1, keepdim=True) + 1e-12)
    parts = []
    if color_sh is not None:
        degree = isqrt(color_sh.shape[-1]) - 1
        parts.append(torch.clamp(eval_sh(degree, color_sh, direction) + 0.5, min=0.0))
    if feature_sh is not None:
        degree = isqrt(feature_sh.shape[-1]) - 1
        parts.append(eval_sh(degree, feature_sh, direction) + 0.5)
    return torch.cat(parts, dim=-1)


def render(
    extrinsics: torch.Tensor,            # (B, V, 4, 4)
    intrinsics: torch.Tensor,            # (B, V, 3, 3)
    near: torch.Tensor,                  # (B, V)
    far: torch.Tensor,                   # (B, V)
    image_shape: tuple[int, int],
    background_color: torch.Tensor,      # (B, 3)
    gaussian_means: torch.Tensor,        # (B, G, 3)
    gaussian_covariances: torch.Tensor,  # (B, G, 3, 3)
    gaussian_opacities: torch.Tensor,    # (B, G)
    gaussian_color_sh: Optional[torch.Tensor] = None,    # (B, G, 3, d_sh)
    gaussian_feature_sh: Optional[torch.Tensor] = None,  # (B, G, C, d_sh)
    scale_invariant: bool = True,
    use_sh: bool = True,
    backend: str = "tiled",
    max_tiles_per_gaussian: Optional[int] = 9,
    remat: bool = False,
) -> RenderOutput:
    """Returns color (B, V, 3, H, W), feature (B, V, C, H, W), mask and
    depth (B, V, H, W). With `scale_invariant` the depth stays in the
    1/near-normalized space. With `max_tiles_per_gaussian` None the tiled
    backend keeps every pair the dense one draws: each Gaussian's rect
    spans its whole above-threshold footprint (`dense_extent`, not clipped
    at 3 sigma) and each view's cap is its largest rect (`covering_cap`)."""
    assert gaussian_color_sh is not None or gaussian_feature_sh is not None
    if not use_sh:
        assert all(sh is None or sh.shape[-1] == 1 for sh in (gaussian_color_sh, gaussian_feature_sh))
    n_color = 3 if gaussian_color_sh is not None else 0

    def render_view(means, covs, opacities, color_sh, feature_sh, ext, intr, near_ij, background_color):
        channels = view_channels(means, color_sh, feature_sh, ext[:3, 3], use_sh)
        background = torch.zeros(channels.shape[-1], device=channels.device)
        background[:n_color] = background_color[:n_color]
        if scale_invariant:
            s = 1.0 / near_ij
            ext_s = ext.clone()
            ext_s[:3, 3] = ext[:3, 3] * s
            means_s, covs_s = means * s, covs * (s * s)
        else:
            ext_s, means_s, covs_s = ext, means, covs
        sg = project_gaussians_to_screen(means_s, covs_s, opacities, channels, ext_s, intr, image_shape)
        if backend == "dense":
            return (*composite_dense(sg, image_shape, background), 0)
        if backend == "tiled":
            cap = max_tiles_per_gaussian
            if cap is None:
                sg = dataclasses.replace(sg, extent=dense_extent(sg))
                cap = covering_cap(sg, image_shape)
            return composite_tiled(sg, image_shape, background, cap)
        raise ValueError(f"unknown backend {backend!r}")

    if remat and torch.is_grad_enabled():
        def body(*args):
            return checkpoint(render_view, *args, use_reentrant=False)
    else:
        body = render_view
    b, v = extrinsics.shape[:2]
    images, masks, depths, pairs = [], [], [], []
    for i in range(b):
        color_sh = gaussian_color_sh[i] if n_color else None
        feature_sh = gaussian_feature_sh[i] if gaussian_feature_sh is not None else None
        for j in range(v):
            image, mask, depth, num_pairs = body(
                gaussian_means[i], gaussian_covariances[i], gaussian_opacities[i], color_sh, feature_sh,
                extrinsics[i, j], intrinsics[i, j], near[i, j], background_color[i],
            )
            images.append(image)
            masks.append(mask)
            depths.append(depth)
            pairs.append(num_pairs)

    h, w = image_shape
    images = torch.stack(images).reshape(b, v, -1, h, w)
    feature = images[:, :, n_color:] if images.shape[2] > n_color else None
    return RenderOutput(
        color=images[:, :, :n_color] if n_color else None,
        feature=feature,
        mask=torch.stack(masks).reshape(b, v, h, w),
        depth=torch.stack(depths).reshape(b, v, h, w),
        num_pairs=torch.tensor(pairs).reshape(b, v),
    )


def render_depth(
    extrinsics: torch.Tensor,            # (B, V, 4, 4)
    intrinsics: torch.Tensor,            # (B, V, 3, 3)
    near: torch.Tensor,                  # (B, V)
    far: torch.Tensor,                   # (B, V)
    image_shape: tuple[int, int],
    gaussian_means: torch.Tensor,        # (B, G, 3)
    gaussian_covariances: torch.Tensor,  # (B, G, 3, 3)
    gaussian_opacities: torch.Tensor,    # (B, G)
    scale_invariant: bool = True,
    mode: DepthRenderingMode = "depth",
    backend: str = "tiled",
) -> torch.Tensor:
    """Depth (B, V, H, W): each Gaussian's camera-space z in the view (its
    inverse, relative disparity or log with `mode`) composited as a
    3-channel DC color on a zero background, averaged over the channels.

    Each (scene, view) is rendered as a scene of one view with its own
    payload, as in the JAX package, which flattens (B, V) into scenes; here
    the scene's Gaussians are sliced for it, not copied.
    """
    b, v = extrinsics.shape[:2]
    w2c = invert_se3(extrinsics)                                   # (B, V, 4, 4)
    cam_points = torch.einsum("bvij,bgj->bvgi", w2c, homogenize_points(gaussian_means))
    fake_color = cam_points[..., 2]                                # (B, V, G)
    if mode == "disparity":
        fake_color = 1.0 / fake_color
    elif mode == "relative_disparity":
        fake_color = depth_to_relative_disparity(fake_color, near[:, :, None], far[:, :, None])
    elif mode == "log":
        fake_color = torch.log(torch.clamp(fake_color, min=torch.minimum(near, far)[:, :, None]))
    elif mode != "depth":
        raise ValueError(f"unknown depth rendering mode {mode!r}")

    g = gaussian_means.shape[1]
    views = []
    for i in range(b):
        for j in range(v):
            views.append(render(
                extrinsics[i : i + 1, j : j + 1], intrinsics[i : i + 1, j : j + 1],
                near[i : i + 1, j : j + 1], far[i : i + 1, j : j + 1], image_shape,
                fake_color.new_zeros((1, 3)), gaussian_means[i : i + 1],
                gaussian_covariances[i : i + 1], gaussian_opacities[i : i + 1],
                gaussian_color_sh=fake_color[i, j].reshape(1, g, 1, 1).expand(1, g, 3, 1),
                scale_invariant=scale_invariant, use_sh=False, backend=backend,
            ).color[0, 0])                                         # (3, H, W)
    h, w = image_shape
    return torch.stack(views).mean(dim=1).reshape(b, v, h, w)


def render_orthographic(
    extrinsics: torch.Tensor,            # (B, 4, 4) camera-to-world
    width: torch.Tensor,                 # (B,) world-space view width
    height: torch.Tensor,                # (B,) world-space view height
    near: torch.Tensor,                  # (B,)
    far: torch.Tensor,                   # (B,)
    image_shape: tuple[int, int],
    background_color: torch.Tensor,      # (B, 3)
    gaussian_means: torch.Tensor,        # (B, G, 3)
    gaussian_covariances: torch.Tensor,  # (B, G, 3, 3)
    gaussian_opacities: torch.Tensor,    # (B, G)
    gaussian_color_sh: Optional[torch.Tensor] = None,
    gaussian_feature_sh: Optional[torch.Tensor] = None,
    fov_degrees: float = 0.1,
    use_sh: bool = True,
    backend: str = "tiled",
) -> RenderOutput:
    """A nearly orthographic render for visualization: the camera moves back
    along its look axis until `width` subtends `fov_degrees`, and the view
    is rendered scale-invariantly with near and far pushed back as far.
    The tiled backend keeps every pair the dense render (the JAX package's
    backend here) draws: each rect spans the Gaussian's whole
    above-threshold footprint and the cap is sized per view; a rect beyond
    what the slot mask holds raises."""
    fov_x = torch.deg2rad(torch.tensor(fov_degrees, dtype=torch.float32, device=width.device))
    distance_to_near = (0.5 * width) / torch.tan(0.5 * fov_x)

    look = extrinsics[..., :3, 2]
    ext = extrinsics.clone()
    ext[..., :3, 3] = extrinsics[..., :3, 3] - look * distance_to_near[..., None]

    b = extrinsics.shape[0]
    intr = torch.zeros((b, 3, 3), dtype=torch.float32, device=extrinsics.device)
    intr[:, 0, 0] = distance_to_near / width
    intr[:, 1, 1] = distance_to_near / height
    intr[:, 0, 2] = 0.5
    intr[:, 1, 2] = 0.5
    intr[:, 2, 2] = 1.0

    return render(
        ext[:, None], intr[:, None],
        (near + distance_to_near)[:, None], (far + distance_to_near)[:, None],
        image_shape, background_color, gaussian_means, gaussian_covariances, gaussian_opacities,
        gaussian_color_sh, gaussian_feature_sh, scale_invariant=True, use_sh=use_sh,
        backend=backend, max_tiles_per_gaussian=None,
    )
