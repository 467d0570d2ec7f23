"""Camera projection / ray geometry (counterpart of
latentsplat_tpu/geometry/projection.py).

Extrinsics are OpenCV-style camera-to-world 4x4 matrices; intrinsics are
3x3, normalized to [0, 1] image coordinates (x right, y down).
"""

from __future__ import annotations

import torch

from ..misc.profiler import host_read

_F32_EPS = float(torch.finfo(torch.float32).eps)


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vectors(vectors: torch.Tensor) -> torch.Tensor:
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(xyzw: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", transformation, xyzw)


def invert_se3(extrinsics: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse [R^T | -R^T t] of rigid transforms (..., 4, 4)."""
    rot_inv = extrinsics[..., :3, :3].transpose(-1, -2)
    t_inv = -rot_inv @ extrinsics[..., :3, 3:]
    top = torch.cat([rot_inv, t_inv], dim=-1)
    with host_read("invert_se3"):
        bottom = extrinsics.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def invert_intrinsics(intrinsics: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [[fx, s, cx], [0, fy, cy], [0, 0, 1]]."""
    fx = intrinsics[..., 0, 0]
    s = intrinsics[..., 0, 1]
    cx = intrinsics[..., 0, 2]
    fy = intrinsics[..., 1, 1]
    cy = intrinsics[..., 1, 2]
    inv_fx = 1.0 / fx
    inv_fy = 1.0 / fy
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack(
        [inv_fx, -s * inv_fx * inv_fy, (s * cy - cx * fy) * inv_fx * inv_fy], dim=-1
    )
    row1 = torch.stack([zeros, inv_fy, -cy * inv_fy], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def project_camera_space(
    points: torch.Tensor, intrinsics: torch.Tensor,
    epsilon: float = _F32_EPS, infinity: float = 1e8,
) -> torch.Tensor:
    points = points / (points[..., -1:] + epsilon)
    points = torch.nan_to_num(points, posinf=infinity, neginf=-infinity)
    points = torch.einsum("...ij,...j->...i", intrinsics, points)
    return points[..., :-1]


def unproject(
    coordinates: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor
) -> torch.Tensor:
    coordinates = homogenize_points(coordinates)
    ray_directions = torch.einsum(
        "...ij,...j->...i", invert_intrinsics(intrinsics), coordinates
    )
    return ray_directions * z[..., None]


def get_world_rays(
    coordinates: torch.Tensor, extrinsics: torch.Tensor, intrinsics: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world rays (origins, unit directions)."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    directions = transform_rigid(homogenize_vectors(directions), extrinsics)[..., :-1]
    origins = extrinsics[..., :-1, -1].expand(directions.shape)
    return origins, directions


def sample_image_grid(
    shape: tuple[int, int], device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center xy coordinates in (0, 1) and ij indices, each (h, w, 2)."""
    h, w = shape
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    ij = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    y = (ys.float() + 0.5) / h
    x = (xs.float() + 0.5) / w
    xy = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
    return xy, ij


def _inverse_3x3(matrix: torch.Tensor, eps: float = 1e-12):
    """Adjugate-based batched 3x3 inverse: (inverse, |det| > eps mask)."""
    a = matrix
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    adj = torch.stack(
        [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    ok = det.abs() > eps
    safe_det = torch.where(ok, det, torch.ones_like(det))
    return adj / safe_det[..., None, None], ok


def intersect_rays(
    origins_x: torch.Tensor, directions_x: torch.Tensor,
    origins_y: torch.Tensor, directions_y: torch.Tensor,
    eps: float = 1e-5, inf: float = 1e10,
) -> torch.Tensor:
    """Least-squares intersection of two rays; parallel pairs give `inf`."""
    shape = torch.broadcast_shapes(
        origins_x.shape, directions_x.shape, origins_y.shape, directions_y.shape
    )
    origins = torch.stack([origins_x.expand(shape), origins_y.expand(shape)], dim=0)
    directions = torch.stack(
        [directions_x.expand(shape), directions_y.expand(shape)], dim=0
    )
    parallel = (directions[0] * directions[1]).sum(dim=-1) > 1 - eps
    n = directions[..., :, None] * directions[..., None, :]
    n = n - torch.eye(3, dtype=origins.dtype, device=origins.device)
    lhs = n.sum(dim=0)
    rhs = torch.einsum("r...ij,r...j->r...i", n, origins).sum(dim=0)
    lhs_inv, ok = _inverse_3x3(lhs)
    result = torch.einsum("...ij,...j->...i", lhs_inv, rhs)
    bad = parallel | ~ok
    return torch.where(bad[..., None], torch.full_like(result, inf), result)
