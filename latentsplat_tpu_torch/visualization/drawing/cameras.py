"""Camera frusta in three axis-aligned projections (counterpart of
latentsplat_tpu/visualization/drawing/cameras.py). Geometry and drawing
run on the cameras' device; the labeled images come back as numpy."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..annotation import add_label
from .lines import draw_lines


def unproject_frustum_corners(
    extrinsics: torch.Tensor,   # (b, 4, 4)
    intrinsics: torch.Tensor,   # (b, 3, 3) normalized
    depth,                      # (b,) or a scalar
) -> torch.Tensor:              # (b, 4, 3)
    b = extrinsics.shape[0]
    depth = torch.as_tensor(depth, dtype=torch.float32, device=extrinsics.device).expand(b)
    # Image corners in circular order.
    xy = torch.tensor([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=torch.float32, device=extrinsics.device)
    xy_h = torch.cat([xy, torch.ones((4, 1), device=xy.device)], dim=-1)
    directions = torch.einsum("bij,pj->bpi", torch.linalg.inv(intrinsics), xy_h)
    directions = directions / directions[..., -1:]
    directions = torch.einsum("bij,bpj->bpi", extrinsics[:, :3, :3], directions)
    origins = extrinsics[:, None, :3, 3]
    return origins + depth[:, None, None] * directions


def compute_aabb(
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: Optional[torch.Tensor] = None,
    far: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    points = [extrinsics[:, :3, 3]]
    for depth in (near, far):
        if depth is not None:
            points.append(unproject_frustum_corners(extrinsics, intrinsics, depth).reshape(-1, 3))
    points = torch.cat(points)
    return points.min(dim=0).values, points.max(dim=0).values


def compute_equal_aabb_with_margin(minima, maxima, margin: float = 0.1):
    """A cube around the box, its side the box's largest side * (1 + margin);
    batched along leading axes like the JAX package's (the largest side over
    all of them)."""
    midpoint = (maxima + minima) * 0.5
    span = (maxima - minima).max() * (1 + margin)
    return midpoint - 0.5 * span, midpoint + 0.5 * span


def draw_cameras(
    resolution: int,
    extrinsics: torch.Tensor,   # (b, 4, 4)
    intrinsics: torch.Tensor,   # (b, 3, 3)
    color,                      # (b, 3)
    near: Optional[torch.Tensor] = None,
    far: Optional[torch.Tensor] = None,
    margin: float = 0.1,
    frustum_scale: float = 0.05,
) -> list[np.ndarray]:
    """Three labeled axis-aligned projections of the camera rig."""
    device = extrinsics.device
    extrinsics = extrinsics.float()
    intrinsics = intrinsics.float()
    color = torch.as_tensor(color, dtype=torch.float32, device=device)

    minima, maxima = compute_aabb(extrinsics, intrinsics, near, far)
    scene_minima, scene_maxima = compute_equal_aabb_with_margin(minima, maxima, margin)
    span = (scene_maxima - scene_minima).max()
    frustum_corners = unproject_frustum_corners(extrinsics, intrinsics, span * frustum_scale)
    near_corners = unproject_frustum_corners(extrinsics, intrinsics, near) if near is not None else None
    far_corners = unproject_frustum_corners(extrinsics, intrinsics, far) if far is not None else None
    gray = torch.tensor([0.25, 0.25, 0.25], device=device)

    projections = []
    for projected_axis in range(3):
        ix = (projected_axis + 1) % 3
        iy = (projected_axis + 2) % 3

        def project(points):
            return torch.stack([points[..., ix], points[..., iy]], dim=-1)

        ranges = dict(radius=1.0, x_range=(scene_minima[ix], scene_maxima[ix]),
                      y_range=(scene_minima[iy], scene_maxima[iy]))
        image = torch.zeros((resolution, resolution, 3), device=device)
        if near_corners is not None:
            pn = project(near_corners)
            image = draw_lines(image, pn.reshape(-1, 2), pn.roll(1, dims=1).reshape(-1, 2), gray, **ranges)
        if far_corners is not None:
            pf = project(far_corners)
            image = draw_lines(image, pf.reshape(-1, 2), pf.roll(1, dims=1).reshape(-1, 2), gray, **ranges)
        if near_corners is not None and far_corners is not None:
            image = draw_lines(
                image, project(near_corners).reshape(-1, 2), project(far_corners).reshape(-1, 2), gray, **ranges
            )

        origins = project(extrinsics[:, :3, 3])            # (b, 2)
        corners = project(frustum_corners)                 # (b, 4, 2)
        start = torch.cat([origins[:, None].expand(-1, 4, 2), corners.roll(1, dims=1)], dim=1)
        end = torch.cat([corners, corners], dim=1)
        line_color = color[:, None].expand(-1, 8, 3).reshape(-1, 3)
        image = draw_lines(image, start.reshape(-1, 2), end.reshape(-1, 2), line_color, **ranges)
        projections.append(add_label(image.cpu().numpy(), f"{'XYZ'[ix]}{'XYZ'[iy]} Projection"))
    return projections
