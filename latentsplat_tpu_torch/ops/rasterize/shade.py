"""The shade of a render pass: each (item, Gaussian) row's composited payload
and its screen projection, the `ScreenGaussians` that the compositors take.

Per item: SH colors (+0.5, clamped at 0) and SH features (+0.5, no clamp)
evaluated towards the item's camera (`view_channels`), or an item payload
as it is; the scene pre-normalized by 1/near when `scale_invariant`; EWA
projection (`camera.project_gaussians_to_screen`). A pass's items are the
global items start .. start + N - 1 of a call with `views` views a scene:
item n's scene is (start + n) // views, and its Gaussians are that scene's
rows of the scene-level inputs.

`shade` launches the `shade_project` kernel (csrc/shade_project.cu; one
launch a pass, the plain version's bits) where every input is on CUDA and
no input needs a gradient (grad mode off, or no input requires one); the
kernel raises on what it does not take (a dtype other than float32, an SH
degree above 4). `use_sh=False`'s DC coefficients go to it as a payload.
Everywhere else, under autograd and on the CPU, `shade` runs
`shade_reference`, the PyTorch version that the kernel repeats.
"""

from __future__ import annotations

from math import isqrt
from typing import Optional

import torch

from ...cuda_build import launch
from ..sh import eval_sh
from . import kernels
from .camera import project_gaussians_to_screen
from .types import ScreenGaussians

# The highest SH degree the kernel evaluates (the basis of ops/sh.py).
MAX_SH_DEGREE = 4


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


def segments(start: int, stop: int, views: int) -> list[tuple[int, int]]:
    """(scene, item count) of each scene's run of the items [start, stop)."""
    out = []
    for n in range(start, stop):
        if out and out[-1][0] == n // views:
            out[-1] = (out[-1][0], out[-1][1] + 1)
        else:
            out.append((n // views, 1))
    return out


def gather(x: torch.Tensor, runs: list[tuple[int, int]]) -> torch.Tensor:
    """A scene-level tensor's rows of a pass's items (`segments`)."""
    return torch.cat([x[s : s + 1].expand(c, *x.shape[1:]) for s, c in runs])


def shade_reference(
    means, covariances, opacities, tables: dict, extrinsics, intrinsics, near, start: int, views: int,
    payload: Optional[torch.Tensor], scale_invariant: bool, use_sh: bool, image_shape: tuple[int, int],
) -> ScreenGaussians:
    """Plain version of `shade` (the `shade_project` kernel), on any device
    and under autograd: scene-level means (B, G, 3), covariances (B, G, 3,
    3), opacities (B, G) and SH `tables` {"color": (B, G, 3, K), "feature":
    (B, G, C, K)}; the pass's extrinsics (N, 4, 4), intrinsics (N, 3, 3)
    and near (N,); `payload` (N, G, C), when given, in place of the
    tables'."""
    runs = segments(start, start + extrinsics.shape[0], views)
    means, covariances, opacities = (gather(x, runs) for x in (means, covariances, opacities))
    if payload is not None:
        channels = payload
    else:
        # Each scene's SH tables against its run of items' cameras.
        parts, i = [], 0
        for s, c in runs:
            color, feature = (tables[name][s] if name in tables else None for name in ("color", "feature"))
            parts.append(view_channels(means[i : i + c], color, feature, extrinsics[i : i + c, :3, 3], use_sh))
            i += c
        channels = torch.cat(parts)
    if scale_invariant:
        scale = 1.0 / near
        ext_s = extrinsics.clone()
        ext_s[:, :3, 3] = extrinsics[:, :3, 3] * scale[:, None]
        means_s, covs_s = means * scale[:, None, None], covariances * (scale * scale)[:, None, None, None]
    else:
        ext_s, means_s, covs_s = extrinsics, means, covariances
    return project_gaussians_to_screen(means_s, covs_s, opacities, channels, ext_s, intrinsics, image_shape)


def _degree(table: torch.Tensor) -> int:
    return isqrt(table.shape[-1]) - 1


def shade_project(
    means, covariances, opacities, tables: dict, extrinsics, intrinsics, near, start: int, views: int,
    payload: Optional[torch.Tensor], scale_invariant: bool, image_shape: tuple[int, int],
) -> ScreenGaussians:
    """`shade_reference` with `use_sh` in one launch of the `shade_project`
    kernel (CUDA tensors only; no gradient). Raises on what the kernel does
    not take: another dtype than float32, other shapes, an SH degree above
    MAX_SH_DEGREE; the launch reports tables whose coefficients do not fit
    a block's shared memory."""
    b, g = means.shape[:2]
    n = extrinsics.shape[0]
    h, w = image_shape
    expected = {
        "means": (means, (b, g, 3)), "covariances": (covariances, (b, g, 3, 3)), "opacities": (opacities, (b, g)),
        "extrinsics": (extrinsics, (n, 4, 4)), "intrinsics": (intrinsics, (n, 3, 3)), "near": (near, (n,)),
    }
    for name, table in tables.items():
        expected[f"{name} SH"] = (table, (b, g, 3 if name == "color" else table.shape[2], table.shape[-1]))
    if not kernels._on_cuda(*(t for t, _ in expected.values())):
        raise ValueError("shade_project: the kernel takes CUDA tensors")
    for name, (t, shape) in expected.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"shade_project: {name} must be float32 of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if payload is None and not tables:
        raise ValueError("shade_project: no SH table and no payload")
    if payload is not None and (payload.dtype != torch.float32 or tuple(payload.shape[:2]) != (n, g)):
        raise ValueError(f"shade_project: the payload must be float32 of ({n}, {g}) rows, got {payload.dtype} "
                         f"{tuple(payload.shape)}")
    if any(_degree(t) > MAX_SH_DEGREE for t in tables.values()):
        raise ValueError(f"shade_project: SH degrees {[_degree(t) for t in tables.values()]} exceed "
                         f"{MAX_SH_DEGREE}")
    if not 0 <= start < start + n <= b * views:
        raise ValueError(f"shade_project: items {start} .. {start + n - 1} of {b} scenes of {views} views")
    if n * g >= 2**31:
        raise ValueError(f"shade_project: {n * g} rows exceed the kernel's int32 index")
    color, feature = (tables.get(name) if payload is None else None for name in ("color", "feature"))
    inputs = [t.detach().contiguous() for t in (means, covariances, opacities, extrinsics, intrinsics, near)]
    sh = [t.detach().contiguous() if t is not None else None for t in (color, feature)]
    device = means.device
    channels = None
    if payload is None:
        channels = torch.empty(n, g, sum(t.shape[-2] for t in sh if t is not None), device=device)
    out = {name: torch.empty(n, g, *width, device=device) for name, width in
           (("mean2d", (2,)), ("conic", (3,)), ("depth", ()), ("radius", ()), ("opacity", ()), ("extent", (2,)))}
    launch(
        "shade_project", n, g, start, views, w, h, int(scale_invariant),
        color.shape[-1] if color is not None else 0, _degree(color) if color is not None else -1,
        feature.shape[-2] if feature is not None else 0, feature.shape[-1] if feature is not None else 0,
        _degree(feature) if feature is not None else -1,
        *(t.data_ptr() for t in inputs[:3]), *(t.data_ptr() if t is not None else None for t in sh),
        *(t.data_ptr() for t in inputs[3:]),
        *(out[k].data_ptr() for k in ("mean2d", "conic", "depth", "radius", "opacity")),
        channels.data_ptr() if channels is not None else None, out["extent"].data_ptr(), kernels._stream(),
        kernel="shade_project",
    )
    return ScreenGaussians(channels=payload if payload is not None else channels, **out)


def shade(
    means, covariances, opacities, tables: dict, extrinsics, intrinsics, near, start: int, views: int,
    payload: Optional[torch.Tensor], scale_invariant: bool, use_sh: bool, image_shape: tuple[int, int],
) -> ScreenGaussians:
    """A pass's screen Gaussians (see `shade_reference` for the arguments):
    the `shade_project` kernel on CUDA where no input needs a gradient (the
    module's head), else the plain version."""
    inputs = [means, covariances, opacities, extrinsics, intrinsics, near, *tables.values()]
    inputs += [payload] if payload is not None else []
    args = (means, covariances, opacities, tables, extrinsics, intrinsics, near, start, views)
    if not kernels._on_cuda(*inputs) or (torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
        return shade_reference(*args, payload, scale_invariant, use_sh, image_shape)
    if payload is None and not use_sh:
        # The DC coefficients as they are, each item its scene's: a payload
        # (view_channels without `use_sh`).
        dc = torch.cat([t[..., 0] for t in tables.values()], dim=-1)
        payload = gather(dc, segments(start, start + extrinsics.shape[0], views))
    return shade_project(*args, payload, scale_invariant, image_shape)
