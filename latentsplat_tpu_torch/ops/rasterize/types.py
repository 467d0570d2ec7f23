"""Rasterizer containers (counterpart of latentsplat_tpu/ops/rasterize/types.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class ScreenGaussians:
    """One view's Gaussians after projection and culling, or a pass's: every
    tensor has the Gaussian axis G, after the items' axes (...) of a pass.
    The shapes below are one view's."""

    mean2d: torch.Tensor     # (G, 2) pixel coordinates (pixel i center = i)
    conic: torch.Tensor      # (G, 3) upper triangle (a, b, c) of the inverse 2D covariance
    depth: torch.Tensor      # (G,) camera-space z
    radius: torch.Tensor     # (G,) 3-sigma screen radius, 0 if culled
    opacity: torch.Tensor    # (G,) in [0, 1]
    channels: torch.Tensor   # (G, C) composited payload
    extent: torch.Tensor     # (G, 2) threshold-aware half-extents (<= radius)

    @property
    def num_gaussians(self) -> int:
        return self.mean2d.shape[-2]

    @property
    def num_channels(self) -> int:
        return self.channels.shape[-1]


@dataclass
class RenderOutput:
    color: Optional[torch.Tensor]    # (B, V, 3, H, W) or None
    feature: Optional[torch.Tensor]  # (B, V, C, H, W) or None
    mask: torch.Tensor               # (B, V, H, W) accumulated alpha
    depth: torch.Tensor              # (B, V, H, W) expected depth
    num_pairs: Optional[torch.Tensor] = None  # (B, V) tile pairs composited (tiled only)
