"""Anti-aliased 2D line segments with round caps (counterpart of
latentsplat_tpu/visualization/drawing/lines.py), on the image's device;
coordinates are in [0, 1] image space unless ranges are given."""

from __future__ import annotations

import torch

from .coordinate_conversion import generate_conversions
from .points import as_colors, as_points
from .rendering import render_over_image


def draw_lines(
    image: torch.Tensor,        # (h, w, 3) float in [0, 1]
    start,                      # (n, 2) xy
    end,                        # (n, 2) xy
    color,                      # (3,) or (n, 3)
    radius: float = 1.0,        # pixels
    x_range: tuple[float, float] = (0.0, 1.0),
    y_range: tuple[float, float] = (0.0, 1.0),
    supersample: int = 4,
) -> torch.Tensor:
    start = as_points(start, image.device)
    end = as_points(end, image.device)
    color = as_colors(color, start.shape[0], image.device)
    conversions = generate_conversions(image.shape[:2], x_range, y_range)
    a = conversions.world_to_pixel(start)
    b = conversions.world_to_pixel(end)

    def distance_fn(points: torch.Tensor):
        # Distance from each sample to the nearest point of each segment.
        p = points[:, None, :]
        ab = (b - a)[None]
        ap = p - a[None]
        denom = torch.clamp((ab * ab).sum(dim=-1), min=1e-12)
        t = torch.clamp((ap * ab).sum(dim=-1) / denom, 0.0, 1.0)
        diff = p - (a[None] + t[..., None] * ab)
        d = torch.sqrt((diff * diff).sum(dim=-1))
        distance, index = d.min(dim=-1)
        return distance, color[index]

    return render_over_image(image, distance_fn, radius, supersample, start.shape[0])
