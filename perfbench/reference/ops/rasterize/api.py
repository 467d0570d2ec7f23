"""The reference's render: per (scene, view) item, SH colors (+0.5,
clamped at 0) and SH features (+0.5) evaluated towards the camera, the
scene pre-normalized by 1/near, EWA projection (`camera.py`) and the plain
compositor (`plain.py`), one item at a time."""

from __future__ import annotations

from math import isqrt
from typing import Optional

import torch

from ..sh import eval_sh
from . import plain
from .camera import project_gaussians_to_screen
from .types import RenderOutput


def view_channels(means: torch.Tensor, color_sh: Optional[torch.Tensor], feature_sh: Optional[torch.Tensor],
                  camera: torch.Tensor) -> torch.Tensor:
    """(G, C) payload of one scene's Gaussians (G, 3) seen from `camera` (3,)."""
    direction = means - camera[None, :]
    direction = direction / (direction.norm(dim=-1, keepdim=True) + 1e-12)
    parts = []
    if color_sh is not None:
        parts.append(torch.clamp(eval_sh(isqrt(color_sh.shape[-1]) - 1, color_sh, direction) + 0.5, min=0.0))
    if feature_sh is not None:
        parts.append(eval_sh(isqrt(feature_sh.shape[-1]) - 1, feature_sh, direction) + 0.5)
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
    max_tiles_per_gaussian: int = 9,
) -> RenderOutput:
    """Returns color (B, V, 3, H, W), feature (B, V, C, H, W), mask and
    depth (B, V, H, W), the depth in the 1/near-normalized space."""
    b, v = extrinsics.shape[:2]
    n_color = 3 if gaussian_color_sh is not None else 0
    images, masks, depths, pairs = [], [], [], []
    for i in range(b):
        for j in range(v):
            ext = extrinsics[i, j]
            color = gaussian_color_sh[i].float() if gaussian_color_sh is not None else None
            feature = gaussian_feature_sh[i].float() if gaussian_feature_sh is not None else None
            channels = view_channels(gaussian_means[i], color, feature, ext[:3, 3])
            background = torch.zeros(channels.shape[-1], device=channels.device)
            background[:n_color] = background_color[i, :n_color]
            scale = 1.0 / near[i, j]
            ext_s = torch.cat([ext[:3, :3], ext[:3, 3:] * scale], dim=1)
            ext_s = torch.cat([ext_s, ext[3:]], dim=0)
            sg = project_gaussians_to_screen(
                gaussian_means[i] * scale, gaussian_covariances[i] * (scale * scale), gaussian_opacities[i],
                channels, ext_s, intrinsics[i, j], image_shape)
            image, mask, depth, n = plain.composite(sg, image_shape, background, max_tiles_per_gaussian)
            images.append(image)
            masks.append(mask)
            depths.append(depth)
            pairs.append(n)
    h, w = image_shape
    images = torch.stack(images).reshape(b, v, -1, h, w)
    return RenderOutput(
        color=images[:, :, :n_color] if n_color else None,
        feature=images[:, :, n_color:] if images.shape[2] > n_color else None,
        mask=torch.stack(masks).reshape(b, v, h, w),
        depth=torch.stack(depths).reshape(b, v, h, w),
        num_pairs=torch.tensor(pairs).reshape(b, v),
    )
