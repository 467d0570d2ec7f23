"""Anti-aliased 2D points (counterpart of
latentsplat_tpu/visualization/drawing/points.py), on the image's device."""

from __future__ import annotations

import torch

from .coordinate_conversion import generate_conversions
from .rendering import render_over_image


def as_points(x, device) -> torch.Tensor:
    """Points as a 2D float32 tensor on `device` ((2,) becomes (1, 2))."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.reshape(1, -1) if x.dim() == 1 else x


def as_colors(color, n: int, device) -> torch.Tensor:
    """(3,) or (n, 3) colors -> (n, 3) float32 on `device`."""
    color = torch.as_tensor(color, dtype=torch.float32, device=device)
    return color.expand(n, 3) if color.dim() == 1 else color


def draw_points(
    image: torch.Tensor,        # (h, w, 3) float in [0, 1]
    points,                     # (n, 2) xy
    color,                      # (3,) or (n, 3)
    radius: float = 1.0,        # pixels
    x_range: tuple[float, float] = (0.0, 1.0),
    y_range: tuple[float, float] = (0.0, 1.0),
    supersample: int = 4,
) -> torch.Tensor:
    points = as_points(points, image.device)
    color = as_colors(color, points.shape[0], image.device)
    centers = generate_conversions(image.shape[:2], x_range, y_range).world_to_pixel(points)

    def distance_fn(samples: torch.Tensor):
        diff = samples[:, None, :] - centers[None]
        d = torch.sqrt((diff * diff).sum(dim=-1))
        distance, index = d.min(dim=-1)
        return distance, color[index]

    return render_over_image(image, distance_fn, radius, supersample, points.shape[0])
