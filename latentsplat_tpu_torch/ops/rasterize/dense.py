"""Dense O(G * pixels) compositing oracle (counterpart of
latentsplat_tpu/ops/rasterize/dense.py). Used only by tests.

With `tile_size` set, the per-(gaussian, pixel) visibility test reproduces
the tiled rasterizer's radius-rect tile cull.
"""

from __future__ import annotations

from typing import Optional

import torch

from .camera import ALPHA_CLAMP, ALPHA_THRESHOLD
from .types import ScreenGaussians


def composite_dense(
    sg: ScreenGaussians,
    image_shape: tuple[int, int],
    background: Optional[torch.Tensor] = None,   # (C,)
    tile_size: Optional[int] = None,
    chunk: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (channels (C, H, W), mask (H, W), expected depth (H, W))."""
    h, w = image_shape
    device = sg.mean2d.device
    order = torch.argsort(sg.depth, stable=True)
    mean2d, conic = sg.mean2d[order], sg.conic[order]
    opacity, channels = sg.opacity[order], sg.channels[order]
    depth, radius = sg.depth[order], sg.radius[order]

    py, px = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    px, py = px.reshape(-1), py.reshape(-1)
    p = h * w
    c = channels.shape[-1]
    out = torch.zeros((p, c), device=device)
    out_depth = torch.zeros((p,), device=device)
    transmittance = torch.ones((p,), device=device)

    for start in range(0, sg.num_gaussians, chunk):
        sl = slice(start, start + chunk)
        m, co, op, ch, de, ra = mean2d[sl], conic[sl], opacity[sl], channels[sl], depth[sl], radius[sl]
        dx = px[None, :] - m[:, 0:1]
        dy = py[None, :] - m[:, 1:2]
        power = -0.5 * (co[:, 0:1] * dx * dx + co[:, 2:3] * dy * dy) - co[:, 1:2] * dx * dy
        alpha = torch.clamp(op[:, None] * torch.exp(torch.clamp(power, max=0.0)), max=ALPHA_CLAMP)
        alpha = torch.where(power > 0.0, 0.0, alpha)
        alpha = torch.where(alpha < ALPHA_THRESHOLD, 0.0, alpha)
        alpha = torch.where(ra[:, None] > 0.0, alpha, 0.0)
        if tile_size is not None:
            tx = torch.floor(px / tile_size)
            ty = torch.floor(py / tile_size)
            gx0 = torch.floor((m[:, 0:1] - ra[:, None]) / tile_size)
            gx1 = torch.floor((m[:, 0:1] + ra[:, None]) / tile_size)
            gy0 = torch.floor((m[:, 1:2] - ra[:, None]) / tile_size)
            gy1 = torch.floor((m[:, 1:2] + ra[:, None]) / tile_size)
            touches = (tx >= gx0) & (tx <= gx1) & (ty >= gy0) & (ty <= gy1)
            alpha = torch.where(touches, alpha, 0.0)

        one_minus = 1.0 - alpha
        t_within = torch.cat(
            [torch.ones((1, p), device=device), torch.cumprod(one_minus, dim=0)[:-1]], dim=0
        )
        weight = alpha * t_within * transmittance[None, :]
        out = out + weight.T @ ch
        out_depth = out_depth + weight.T @ de
        transmittance = transmittance * one_minus.prod(dim=0)

    mask = 1.0 - transmittance
    if background is not None:
        out = out + transmittance[:, None] * background[None, :]
    return out.T.reshape(c, h, w), mask.reshape(h, w), out_depth.reshape(h, w)
