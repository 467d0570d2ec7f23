"""Rendering API (counterpart of `render` and `render_depth` in
latentsplat_tpu/ops/rasterize/api.py).

Per (scene, view) item: SH colors (+0.5, clamped at 0) and SH features
(+0.5, no clamp) evaluated towards the camera, or their DC coefficients as
they are with `use_sh=False`; the scene pre-normalized by 1/near when
`scale_invariant`; EWA projection, then the tiled (CUDA) or dense (oracle)
compositor. The JAX package maps over views and scenes inside one compiled
program; here a call's items are rendered in passes (`pass_ranges`), each
pass over all its items at once: one launch of each kernel, one stable
sort and one host read a pass, and a call splits into more than one pass
only where a pass would hold more than PASS_ROWS (item, Gaussian) rows. An
item's outputs are the bits a pass of that item alone gives: every
per-item operation is elementwise or a fixed-order sum (`eval_sh` adds its
terms in coefficient order), and a scene-level input's gradient is summed
over its items in item order (`_FanOut`). With `remat` each pass is
checkpointed (non-reentrant): the backward renders the pass again, the
kernels included, instead of keeping its pair buffers, as the JAX package
checkpoints each view. `precision` is one of the JAX package's rasterizer
precisions (tiled.PRECISIONS); those with the bf16 SH knob ("fast",
"fast_nocoef", "exact_bf16_sh") round each scene's SH tables to bfloat16
once, before either compositor, and the dense compositor ignores the rest.
`render_depth` composites each item's camera-space depth (or its
disparity, relative disparity or log) as a 3-channel color.
`render_orthographic` pulls a camera far back along its look axis and
renders through the tiled kernels, each Gaussian's rect spanning its whole
above-threshold footprint, so that no pair the dense render draws is
dropped.
"""

from __future__ import annotations

import dataclasses
from math import isqrt
from typing import Literal, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ...geometry.conversions import depth_to_relative_disparity
from ...geometry.projection import homogenize_points, invert_se3
from ...misc.profiler import span
from ..sh import eval_sh
from .camera import project_gaussians_to_screen
from .dense import composite_dense
from .tiled import composite_tiled, covering_cap, dense_extent, precision_knobs
from .types import RenderOutput, ScreenGaussians

DepthRenderingMode = Literal["depth", "disparity", "relative_disparity", "log"]

# The most (item, Gaussian) rows a pass holds; a pass's memory grows with
# its rows. On an H100 (chip_smoke.py's pass phase: the peak of allocated
# memory over a one-pass render, over its rows) serving bench_render's
# 64 x 393,216 rows took 350 B a row at exact and 425 at fast, and a train
# render of 2 x 4 flagship views, forward and backward, 972 and 1,192. At
# 2**25 rows (85 flagship views) a serving pass stays under 14 GiB and a
# train pass under 38 GiB of the card's 80 GB.
PASS_ROWS = 1 << 25


def pass_ranges(items: int, gaussians: int) -> list[tuple[int, int]]:
    """The [start, stop) item ranges of a call's passes, in item order."""
    per_pass = max(1, PASS_ROWS // max(1, gaussians))
    return [(n, min(n + per_pass, items)) for n in range(0, items, per_pass)]


def view_channels(
    means: torch.Tensor, color_sh: Optional[torch.Tensor],
    feature_sh: Optional[torch.Tensor], camera: torch.Tensor, use_sh: bool = True,
) -> torch.Tensor:
    """Per-Gaussian composited payload of each item's camera position:
    means (..., G, 3) and camera (..., 3) with the items' axes (...), one
    scene's SH tables (G, C, K) -> (..., G, C), float32 (bfloat16 tables
    are evaluated in float32). Without `use_sh` the DC coefficients are
    the payload as they are."""
    color_sh, feature_sh = (sh.float() if sh is not None else None for sh in (color_sh, feature_sh))
    if not use_sh:
        dc = torch.cat([sh[..., 0] for sh in (color_sh, feature_sh) if sh is not None], dim=-1)
        return dc.expand(*means.shape[:-1], dc.shape[-1])
    direction = means - camera[..., None, :]
    x, y, z = direction.unbind(-1)
    direction = direction / (torch.sqrt(x * x + y * y + z * z)[..., None] + 1e-12)
    parts = []
    if color_sh is not None:
        parts.append(torch.clamp(eval_sh(isqrt(color_sh.shape[-1]) - 1, color_sh, direction) + 0.5, min=0.0))
    if feature_sh is not None:
        parts.append(eval_sh(isqrt(feature_sh.shape[-1]) - 1, feature_sh, direction) + 0.5)
    return torch.cat(parts, dim=-1)


class _FanOut(torch.autograd.Function):
    """One view of each scene-level tensor a pass; the backward sums the
    passes' gradients in pass order (a tensor's items in item order, as
    the reduction over one pass's items adds them), so that a call's
    gradients do not depend on how its items split into passes."""

    @staticmethod
    def forward(ctx, copies, *tensors):
        ctx.set_materialize_grads(False)
        ctx.copies, ctx.n = copies, len(tensors)
        return tuple(t.view_as(t) for _ in range(copies) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        sums = []
        for i in range(ctx.n):
            total = None
            for k in range(ctx.copies):
                g = grads[k * ctx.n + i]
                if g is not None:
                    total = g if total is None else total + g
            sums.append(total)
        return None, *sums


def _segments(start: int, stop: int, views: int) -> list[tuple[int, int]]:
    """(scene, item count) of each scene's run of the items [start, stop)."""
    out = []
    for n in range(start, stop):
        if out and out[-1][0] == n // views:
            out[-1] = (out[-1][0], out[-1][1] + 1)
        else:
            out.append((n // views, 1))
    return out


def _render(
    extrinsics, intrinsics, near, image_shape, background_color, gaussian_means, gaussian_covariances,
    gaussian_opacities, color_sh, feature_sh, payload, scale_invariant, use_sh, backend,
    max_tiles_per_gaussian, remat, precision,
):
    """The passes of `render` (see there); `payload` (B, V, G, C), when
    given, is each item's composited payload in place of the SH tables'.
    Returns (images (B V, C, H, W), masks, depths (B V, H, W), pairs (B V,)
    int64 on the CPU)."""
    b, v = extrinsics.shape[:2]
    n_color = 3 if color_sh is not None or payload is not None else 0
    tables = {name: x for name, x in (("color", color_sh), ("feature", feature_sh)) if x is not None}
    scene = [gaussian_means, gaussian_covariances, gaussian_opacities, background_color, *tables.values()]
    ranges = pass_ranges(b * v, gaussian_means.shape[1])
    fanned = _FanOut.apply(len(ranges), *scene)
    per_item = [x.reshape(b * v, *x.shape[2:]) for x in (extrinsics, intrinsics, near)]
    if payload is not None:
        per_item.append(payload.reshape(b * v, *payload.shape[2:]))

    def render_pass(start, stop, means, covs, opacities, background, *rest):
        sh = dict(zip(tables, rest))
        ext, intr, near_n, *item_payload = rest[len(tables) :]
        segments = _segments(start, stop, v)

        def gather(x):   # a scene-level tensor's rows of the pass's items
            return torch.cat([x[s : s + 1].expand(c, *x.shape[1:]) for s, c in segments])

        with span("render.shade"):
            means, covs, opacities, background = map(gather, (means, covs, opacities, background))
            if item_payload:
                channels = item_payload[0]
            else:
                # Each scene's SH tables against its run of items' cameras.
                parts, i = [], 0
                for s, c in segments:
                    color, feature = (sh[name][s] if name in sh else None for name in ("color", "feature"))
                    parts.append(view_channels(means[i : i + c], color, feature, ext[i : i + c, :3, 3], use_sh))
                    i += c
                channels = torch.cat(parts)
            fill = torch.zeros(channels.shape[0], channels.shape[-1], device=channels.device)
            fill[:, :n_color] = background[:, :n_color]
            if scale_invariant:
                scale = 1.0 / near_n
                ext_s = ext.clone()
                ext_s[:, :3, 3] = ext[:, :3, 3] * scale[:, None]
                means_s, covs_s = means * scale[:, None, None], covs * (scale * scale)[:, None, None, None]
            else:
                ext_s, means_s, covs_s = ext, means, covs
            sg = project_gaussians_to_screen(means_s, covs_s, opacities, channels, ext_s, intr, image_shape)
        if backend == "dense":
            views = [composite_dense(ScreenGaussians(**{f.name: getattr(sg, f.name)[n] for f in
                                                        dataclasses.fields(sg)}), image_shape, fill[n])
                     for n in range(stop - start)]
            return (*(torch.stack(x) for x in zip(*views)), torch.zeros(stop - start, dtype=torch.int64))
        if backend == "tiled":
            cap = max_tiles_per_gaussian
            if cap is None:
                with span("render.cull"):
                    sg = dataclasses.replace(sg, extent=dense_extent(sg))
                    cap = covering_cap(sg, image_shape)
            return composite_tiled(sg, image_shape, fill, cap, precision)
        raise ValueError(f"unknown backend {backend!r}")

    body = render_pass
    if remat and torch.is_grad_enabled():
        def body(*args):
            return checkpoint(render_pass, *args, use_reentrant=False)
    k = len(scene)
    outs = [body(start, stop, *fanned[i * k : (i + 1) * k], *(x[start:stop] for x in per_item))
            for i, (start, stop) in enumerate(ranges)]
    images, masks, depths, pairs = (torch.cat(x) for x in zip(*outs))
    return images, masks, depths, pairs


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
    precision: str = "exact",
) -> RenderOutput:
    """Returns color (B, V, 3, H, W), feature (B, V, C, H, W), mask and
    depth (B, V, H, W). With `scale_invariant` the depth stays in the
    1/near-normalized space. With `max_tiles_per_gaussian` None the tiled
    backend keeps every pair the dense one draws: each Gaussian's rect
    spans its whole above-threshold footprint (`dense_extent`, not clipped
    at 3 sigma) and each pass's cap is its largest rect (`covering_cap`)."""
    assert gaussian_color_sh is not None or gaussian_feature_sh is not None
    if not use_sh:
        assert all(sh is None or sh.shape[-1] == 1 for sh in (gaussian_color_sh, gaussian_feature_sh))
    n_color = 3 if gaussian_color_sh is not None else 0
    tables = (gaussian_color_sh, gaussian_feature_sh)
    if precision_knobs(precision).bf16_sh:
        # Once a scene, before the passes, as the JAX package casts before
        # its view loop; the passes read float32 copies of the bfloat16
        # values, so that the cast's gradient rounds the sum over all views.
        tables = (sh.to(torch.bfloat16).float() if sh is not None else None for sh in tables)
    images, masks, depths, pairs = _render(
        extrinsics, intrinsics, near, image_shape, background_color, gaussian_means, gaussian_covariances,
        gaussian_opacities, *tables, None, scale_invariant, use_sh, backend, max_tiles_per_gaussian, remat,
        precision,
    )
    b, v = extrinsics.shape[:2]
    h, w = image_shape
    images = images.reshape(b, v, -1, h, w)
    return RenderOutput(
        color=images[:, :, :n_color] if n_color else None,
        feature=images[:, :, n_color:] if images.shape[2] > n_color else None,
        mask=masks.reshape(b, v, h, w),
        depth=depths.reshape(b, v, h, w),
        num_pairs=pairs.reshape(b, v),
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

    Each (scene, view) item carries its own payload, as in the JAX package,
    which flattens (B, V) into scenes of one view each; here the items
    render in `render`'s passes with a payload an item.
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

    images, _, _, _ = _render(
        extrinsics, intrinsics, near, image_shape, fake_color.new_zeros((b, 3)), gaussian_means,
        gaussian_covariances, gaussian_opacities, None, None, fake_color[..., None].expand(*fake_color.shape, 3),
        scale_invariant, False, backend, 9, False, "exact",
    )
    h, w = image_shape
    return images.mean(dim=1).reshape(b, v, h, w)


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
