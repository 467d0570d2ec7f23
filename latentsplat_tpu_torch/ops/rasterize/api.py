"""Rendering API (counterpart of `render` in
latentsplat_tpu/ops/rasterize/api.py).

Per view: SH colors (+0.5, clamped at 0) and SH features (+0.5, no clamp)
evaluated towards the camera, the scene pre-normalized by 1/near, EWA
projection, then the tiled (CUDA) or dense (oracle) compositor. Views and
scenes run in a Python loop and share the Gaussians. `render_depth` and
`render_orthographic` are not ported yet.
"""

from __future__ import annotations

from math import isqrt
from typing import Optional

import torch

from ..sh import eval_sh
from .camera import project_gaussians_to_screen
from .dense import composite_dense
from .tiled import composite_tiled
from .types import RenderOutput


def view_channels(
    means: torch.Tensor, color_sh: Optional[torch.Tensor],
    feature_sh: Optional[torch.Tensor], camera: torch.Tensor,
) -> torch.Tensor:
    """Per-Gaussian composited payload for one camera position: (G, C)."""
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
    backend: str = "tiled",
    max_tiles_per_gaussian: int = 9,
) -> RenderOutput:
    """Returns color (B, V, 3, H, W), feature (B, V, C, H, W), mask and
    depth (B, V, H, W). Depth stays in the 1/near-normalized space."""
    assert gaussian_color_sh is not None or gaussian_feature_sh is not None
    n_color = 3 if gaussian_color_sh is not None else 0
    b, v = extrinsics.shape[:2]
    images, masks, depths, pairs = [], [], [], []
    for i in range(b):
        color_sh = gaussian_color_sh[i] if n_color else None
        feature_sh = gaussian_feature_sh[i] if gaussian_feature_sh is not None else None
        means, covs = gaussian_means[i], gaussian_covariances[i]
        for j in range(v):
            ext = extrinsics[i, j]
            channels = view_channels(means, color_sh, feature_sh, ext[:3, 3])
            background = torch.zeros(channels.shape[-1], device=channels.device)
            background[:n_color] = background_color[i, :n_color]
            s = 1.0 / near[i, j]
            ext_s = ext.clone()
            ext_s[:3, 3] = ext[:3, 3] * s
            sg = project_gaussians_to_screen(
                means * s, covs * (s * s), gaussian_opacities[i], channels,
                ext_s, intrinsics[i, j], image_shape,
            )
            if backend == "dense":
                image, mask, depth = composite_dense(sg, image_shape, background)
                num_pairs = 0
            elif backend == "tiled":
                image, mask, depth, num_pairs = composite_tiled(
                    sg, image_shape, background, max_tiles_per_gaussian
                )
            else:
                raise ValueError(f"unknown backend {backend!r}")
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
