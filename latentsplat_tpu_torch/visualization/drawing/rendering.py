"""Soft 2D drawing by distance fields with k x k supersampling (counterpart
of latentsplat_tpu/visualization/drawing/rendering.py), on the image's
device.

A distance function maps sample points to the distance to, and the color
of, the nearest drawn entity; a sample's coverage is clip(radius + 0.5 -
distance, 0, 1), and each pixel averages its k x k samples. The samples
are float64, as the JAX package's numpy grid is, and are evaluated a band
of image rows at a time so that (sample, entity) intermediates stay near
`SAMPLE_BUDGET` elements: a 256² canvas at k = 4 against a few hundred
segments fits the card comfortably.
"""

from __future__ import annotations

from typing import Callable

import torch

DistanceFn = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
# points (n, 2) float64 -> (distance (n,), color (n, 3))

SAMPLE_BUDGET = 1 << 23


def generate_sample_grid(rows: range, width: int, supersample: int, device) -> torch.Tensor:
    """Supersampled pixel-center coordinates of image rows `rows`,
    (len(rows) * k, width * k, 2) in xy order, float64."""
    k = supersample
    ys = (torch.arange(rows.start * k, rows.stop * k, device=device, dtype=torch.float64) + 0.5) / k
    xs = (torch.arange(width * k, device=device, dtype=torch.float64) + 0.5) / k
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def render(
    shape: tuple[int, int],
    distance_fn: DistanceFn,
    radius: float,
    supersample: int = 4,
    num_entities: int = 1,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a distance field -> (color (h, w, 3), alpha (h, w)), float64."""
    h, w = shape
    k = supersample
    rows_per_band = max(1, SAMPLE_BUDGET // max(1, k * k * w * num_entities))
    colors, alphas = [], []
    for start in range(0, h, rows_per_band):
        rows = range(start, min(h, start + rows_per_band))
        grid = generate_sample_grid(rows, w, k, device).reshape(-1, 2)
        distance, color = distance_fn(grid)
        alpha = torch.clamp(radius + 0.5 - distance, 0.0, 1.0)
        n = len(rows)
        alphas.append(alpha.reshape(n, k, w, k).mean(dim=(1, 3)))
        colors.append(color.reshape(n, k, w, k, 3).mean(dim=(1, 3)))
    return torch.cat(colors), torch.cat(alphas)


def render_over_image(
    image: torch.Tensor, distance_fn: DistanceFn, radius: float, supersample: int = 4,
    num_entities: int = 1,
) -> torch.Tensor:
    """Composite the distance field over `image` (h, w, 3); same dtype back."""
    color, alpha = render(image.shape[:2], distance_fn, radius, supersample, num_entities, image.device)
    out = image.double() * (1.0 - alpha[..., None]) + color * alpha[..., None]
    return out.to(image.dtype)
