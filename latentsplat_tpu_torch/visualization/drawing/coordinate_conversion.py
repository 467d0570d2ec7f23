"""World <-> pixel coordinates of an image being drawn on (counterpart of
latentsplat_tpu/visualization/drawing/coordinate_conversion.py)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Conversions(NamedTuple):
    world_to_pixel: Callable[[torch.Tensor], torch.Tensor]
    pixel_to_world: Callable[[torch.Tensor], torch.Tensor]


def generate_conversions(
    shape: tuple[int, int],
    x_range: tuple[float, float] = (0.0, 1.0),
    y_range: tuple[float, float] = (0.0, 1.0),
) -> Conversions:
    """`x_range` and `y_range` map onto [0, w] and [0, h] pixels."""
    h, w = shape
    x0, x1 = x_range
    y0, y1 = y_range

    def world_to_pixel(xy: torch.Tensor) -> torch.Tensor:
        x = (xy[..., 0] - x0) / (x1 - x0) * w
        y = (xy[..., 1] - y0) / (y1 - y0) * h
        return torch.stack([x, y], dim=-1)

    def pixel_to_world(xy: torch.Tensor) -> torch.Tensor:
        x = xy[..., 0] / w * (x1 - x0) + x0
        y = xy[..., 1] / h * (y1 - y0) + y0
        return torch.stack([x, y], dim=-1)

    return Conversions(world_to_pixel, pixel_to_world)
