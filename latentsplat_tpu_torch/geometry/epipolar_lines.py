"""Epipolar ray-segment projection (counterpart of
latentsplat_tpu/geometry/epipolar_lines.py): every edge case resolves with
`torch.where` selects, so the function has no data-dependent shapes."""

from __future__ import annotations

from typing import Optional

import torch

from .projection import (
    get_world_rays,
    homogenize_points,
    homogenize_vectors,
    intersect_rays,
    invert_se3,
    project_camera_space,
)


def _is_in_bounds(xy: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return (xy >= -epsilon).all(dim=-1) & (xy <= 1 + epsilon).all(dim=-1)


def _is_in_front_of_camera(xyz: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return xyz[..., -1] > -epsilon


def _is_positive_t(t: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return t > -epsilon


def _intersect_image_coordinate(intrinsics, origins, directions, dimension, value):
    """Intersection of a camera-space ray's projection with one image border."""
    dim = "xy".index(dimension)
    other = 1 - dim
    fs = intrinsics[..., dim, dim]
    fo = intrinsics[..., other, other]
    cs = intrinsics[..., dim, 2]
    co = intrinsics[..., other, 2]
    os_, oo = origins[..., dim], origins[..., other]
    ds, do = directions[..., dim], directions[..., other]
    oz, dz = origins[..., 2], directions[..., 2]
    c = (value - cs) / fs

    t = (c * oz - os_) / (ds - c * dz)
    coordinate_other = co + (fo * (oo * (c * dz - ds) + do * (os_ - c * oz))) / (
        dz * os_ - ds * oz
    )
    coordinate_same = torch.full_like(coordinate_other, value)
    if other == 0:
        xy = torch.stack([coordinate_other, coordinate_same], dim=-1)
    else:
        xy = torch.stack([coordinate_same, coordinate_other], dim=-1)
    xyz = origins + t[..., None] * directions
    valid = _is_in_bounds(xy) & _is_in_front_of_camera(xyz) & _is_positive_t(t)
    valid = valid & torch.isfinite(t)
    return {"t": t, "xy": xy, "valid": valid}


def _compare_projections(intersections: list[dict], reduction: str) -> dict:
    t = torch.stack([i["t"] for i in intersections], dim=0)
    xy = torch.stack([i["xy"] for i in intersections], dim=0)
    valid = torch.stack([i["valid"] for i in intersections], dim=0)

    lowest = float("inf") if reduction == "min" else float("-inf")
    t = torch.where(valid, t, torch.full_like(t, lowest))
    t = torch.nan_to_num(t, nan=lowest)
    selector = t.argmin(dim=0) if reduction == "min" else t.argmax(dim=0)

    reduced = torch.gather(t, 0, selector[None])[0]
    xy_index = selector[None, ..., None].expand(1, *selector.shape, 2)
    xy_sel = torch.gather(xy, 0, xy_index)[0]
    valid_sel = torch.gather(valid, 0, selector[None])[0]
    return {"t": reduced, "xy": xy_sel, "valid": valid_sel}


def _compute_point_projection(xyz, t, intrinsics) -> dict:
    xy = project_camera_space(xyz, intrinsics)
    valid = _is_in_bounds(xy) & _is_in_front_of_camera(xyz) & _is_positive_t(t)
    return {"t": t, "xy": xy, "valid": valid}


def project_rays(
    origins: torch.Tensor,
    directions: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: Optional[torch.Tensor] = None,
    far: Optional[torch.Tensor] = None,
    epsilon: float = 1e-6,
) -> dict:
    """Project world-space ray segments onto another camera's image plane.

    Returns dict(t_min, t_max, xy_min, xy_max, overlaps_image)."""
    world_to_cam = invert_se3(extrinsics)
    origins_c = torch.einsum(
        "...ij,...j->...i", world_to_cam, homogenize_points(origins)
    )[..., :3]
    directions_c = torch.einsum(
        "...ij,...j->...i", world_to_cam, homogenize_vectors(directions)
    )[..., :3]

    shape = torch.broadcast_shapes(origins_c.shape, directions_c.shape)
    shape_k = torch.broadcast_shapes(shape[:-1], intrinsics.shape[:-2])
    origins_c = origins_c.expand(*shape_k, 3)
    directions_c = directions_c.expand(*shape_k, 3)
    intrinsics_b = intrinsics.expand(*shape_k, 3, 3)

    frame = [
        _intersect_image_coordinate(intrinsics_b, origins_c, directions_c, "x", 0.0),
        _intersect_image_coordinate(intrinsics_b, origins_c, directions_c, "x", 1.0),
        _intersect_image_coordinate(intrinsics_b, origins_c, directions_c, "y", 0.0),
        _intersect_image_coordinate(intrinsics_b, origins_c, directions_c, "y", 1.0),
    ]
    frame_min = _compare_projections(frame, "min")
    frame_max = _compare_projections(frame, "max")

    if near is None:
        mask_depth_zero = origins_c[..., -1] < epsilon
        mask_at_camera = torch.linalg.norm(origins_c, dim=-1) < epsilon
        origins_for_projection = torch.where(
            mask_at_camera[..., None], directions_c, origins_c
        )
        at_zero = _compute_point_projection(
            origins_for_projection, torch.zeros_like(frame_min["t"]), intrinsics_b
        )
        at_zero["valid"] = at_zero["valid"] & ~(mask_depth_zero & ~mask_at_camera)
    else:
        near_b = near.expand(frame_min["t"].shape)
        at_zero = _compute_point_projection(
            origins_c + near_b[..., None] * directions_c, near_b, intrinsics_b
        )

    if far is None:
        at_infinity = _compute_point_projection(
            directions_c, torch.full_like(frame_min["t"], float("inf")), intrinsics_b
        )
    else:
        far_b = far.expand(frame_min["t"].shape)
        at_infinity = _compute_point_projection(
            origins_c + far_b[..., None] * directions_c, far_b, intrinsics_b
        )

    def pick(use_endpoint, endpoint, border):
        return {
            "t": torch.where(use_endpoint, endpoint["t"], border["t"]),
            "xy": torch.where(use_endpoint[..., None], endpoint["xy"], border["xy"]),
            "valid": torch.where(use_endpoint, endpoint["valid"], border["valid"]),
        }

    chosen_min = pick(at_zero["valid"], at_zero, frame_min)
    chosen_max = pick(at_infinity["valid"], at_infinity, frame_max)
    return {
        "t_min": chosen_min["t"],
        "t_max": chosen_max["t"],
        "xy_min": chosen_min["xy"],
        "xy_max": chosen_max["xy"],
        "overlaps_image": chosen_min["valid"] & chosen_max["valid"],
    }


def lift_to_3d(origins, directions, xy, extrinsics, intrinsics) -> torch.Tensor:
    """3D points on epipolar lines for 2D image points."""
    xy_origins, xy_directions = get_world_rays(xy, extrinsics, intrinsics)
    return intersect_rays(origins, directions, xy_origins, xy_directions)


def get_depth(origins, directions, xy, extrinsics, intrinsics) -> torch.Tensor:
    """Distance from the ray origin to the triangulated point."""
    xyz = lift_to_3d(origins, directions, xy, extrinsics, intrinsics)
    return torch.linalg.norm(xyz - origins, dim=-1)
