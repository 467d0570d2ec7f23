"""Pose interpolation for videos (counterpart of
latentsplat_tpu/visualization/camera_trajectory/interpolation.py). Host
numpy and scipy.

Extrinsics are interpolated by rotating about the least-squares focus
point of the two look rays, in a 5-DoF pivot parameterization (3
translation components in a look-aligned frame, an in-plane angle and a
twist) with the angles interpolated along the shorter arc; cameras that
look in parallel pivot about the midpoint of their origins. The pivot
parameters are found in float64 and mapped back in float32, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


def interpolate_intrinsics(
    initial: np.ndarray,  # (*batch, 3, 3)
    final: np.ndarray,    # (*batch, 3, 3)
    t: np.ndarray,        # (time,)
) -> np.ndarray:          # (*batch, time, 3, 3)
    initial = np.asarray(initial, np.float32)[..., None, :, :]
    final = np.asarray(final, np.float32)[..., None, :, :]
    t = np.asarray(t, np.float32)[:, None, None]
    return initial + (final - initial) * t


def intersect_rays(
    a_origins: np.ndarray, a_directions: np.ndarray,
    b_origins: np.ndarray, b_directions: np.ndarray,
) -> np.ndarray:
    """Least-squares intersection point of two ray bundles."""
    a_origins, a_directions, b_origins, b_directions = np.broadcast_arrays(
        a_origins, a_directions, b_origins, b_directions
    )
    origins = np.stack((a_origins, b_origins), axis=-2)
    directions = np.stack((a_directions, b_directions), axis=-2)
    n = directions[..., :, None] * directions[..., None, :]
    n = n - np.eye(3, dtype=origins.dtype)
    lhs = n.sum(axis=-3)
    rhs = np.einsum("...nij,...nj->...ni", n, origins).sum(axis=-2)
    batch = rhs.shape[:-1]
    solutions = np.stack([
        np.linalg.lstsq(l, r, rcond=None)[0] for l, r in zip(lhs.reshape(-1, 3, 3), rhs.reshape(-1, 3))
    ])
    return solutions.reshape(*batch, 3)


def _normalize(a: np.ndarray) -> np.ndarray:
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def generate_coordinate_frame(y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Frame from perpendicular unit Y and Z vectors; columns [y x z, y, z]."""
    y, z = np.broadcast_arrays(y, z)
    return np.stack([np.cross(y, z), y, z], axis=-1)


def generate_rotation_coordinate_frame(a: np.ndarray, b: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Frame whose Y axis is normal to the plane spanned by unit vectors a, b."""
    b = np.array(b, copy=True)
    parallel = np.abs(np.abs(np.einsum("...i,...i->...", a, b)) - 1) < eps
    b[parallel] = np.array([0.0, 0.0, 1.0], b.dtype)
    parallel = np.abs(np.abs(np.einsum("...i,...i->...", a, b)) - 1) < eps
    b[parallel] = np.array([0.0, 1.0, 0.0], b.dtype)
    return generate_coordinate_frame(_normalize(np.cross(a, b)), a)


def _matrix_to_euler(rotations: np.ndarray, pattern: str) -> np.ndarray:
    batch = rotations.shape[:-2]
    return R.from_matrix(rotations.reshape(-1, 3, 3)).as_euler(pattern).reshape(*batch, 3)


def _euler_to_matrix(angles: np.ndarray, pattern: str) -> np.ndarray:
    batch = angles.shape[:-1]
    return R.from_euler(pattern, angles.reshape(-1, 3)).as_matrix().reshape(*batch, 3, 3)


def extrinsics_to_pivot_parameters(
    extrinsics: np.ndarray,              # (*batch, 4, 4)
    pivot_coordinate_frame: np.ndarray,  # (*batch, 3, 3)
    pivot_point: np.ndarray,             # (*batch, 3)
) -> np.ndarray:                         # (*batch, 5)
    pivot_axis = pivot_coordinate_frame[..., :, 1]
    translation_frame = generate_coordinate_frame(pivot_axis, extrinsics[..., :3, 2])
    delta = pivot_point - extrinsics[..., :3, 3]
    translation = np.einsum("...ij,...i->...j", translation_frame, delta)

    inverted = np.linalg.inv(pivot_coordinate_frame) @ extrinsics[..., :3, :3]
    euler = _matrix_to_euler(inverted, "YXZ")
    return np.concatenate([translation, euler[..., 0:1], euler[..., 2:3]], axis=-1)


def pivot_parameters_to_extrinsics(
    parameters: np.ndarray,              # (*batch, 5)
    pivot_coordinate_frame: np.ndarray,  # (*batch, 3, 3)
    pivot_point: np.ndarray,             # (*batch, 3)
) -> np.ndarray:                         # (*batch, 4, 4)
    translation = parameters[..., :3]
    y = parameters[..., 3:4]
    z = parameters[..., 4:5]
    euler = np.concatenate([y, np.zeros_like(y), z], axis=-1)
    rotation = pivot_coordinate_frame @ _euler_to_matrix(euler, "YXZ")

    pivot_axis = pivot_coordinate_frame[..., :, 1]
    translation_frame = generate_coordinate_frame(pivot_axis, rotation[..., :3, 2])
    delta = np.einsum("...ij,...j->...i", translation_frame, translation)
    origin = pivot_point - delta

    batch = origin.shape[:-1]
    extrinsics = np.broadcast_to(np.eye(4, dtype=np.float32), (*batch, 4, 4)).copy()
    extrinsics[..., :3, :3] = rotation
    extrinsics[..., :3, 3] = origin
    return extrinsics


def interpolate_circular(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Angle lerp along the shorter arc."""
    a, b, t = np.broadcast_arrays(a, b, t)
    tau = 2 * np.pi
    a = a % tau
    b = b % tau
    d = np.abs(b - a)
    a_left = a - tau
    d_left = np.abs(b - a_left)
    a_right = a + tau
    d_right = np.abs(b - a_right)
    use_d = (d < d_left) & (d < d_right)
    use_d_left = (d_left < d_right) & ~use_d

    result = a + (b - a) * t
    result = np.where(use_d_left, a_left + (b - a_left) * t, result)
    return np.where(~use_d & ~use_d_left, a_right + (b - a_right) * t, result)


def interpolate_pivot_parameters(initial: np.ndarray, final: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(*batch, 5) twice and (time,) -> (*batch, time, 5)."""
    initial = initial[..., None, :]
    final = final[..., None, :]
    t = np.asarray(t)[:, None]
    ti, ri = initial[..., :3], initial[..., 3:]
    tf, rf = final[..., :3], final[..., 3:]
    t_lerp = ti + (tf - ti) * t
    r_lerp = interpolate_circular(ri, rf, t)
    return np.concatenate([t_lerp, r_lerp], axis=-1)


def interpolate_extrinsics(
    initial: np.ndarray,  # (*batch, 4, 4)
    final: np.ndarray,    # (*batch, 4, 4)
    t: np.ndarray,        # (time,)
    eps: float = 1e-4,
) -> np.ndarray:          # (*batch, time, 4, 4)
    """Interpolate camera-to-world poses about their look rays' focus point."""
    initial = np.asarray(initial, np.float64)
    final = np.asarray(final, np.float64)
    t = np.asarray(t, np.float64)

    initial_look = initial[..., :3, 2]
    final_look = final[..., :3, 2]
    dots = np.einsum("...i,...i->...", initial_look, final_look)
    parallel = np.abs(np.abs(dots) - 1) < eps

    initial_origin = initial[..., :3, 3]
    final_origin = final[..., :3, 3]
    pivot_point = 0.5 * (initial_origin + final_origin)
    if np.any(~parallel):
        pivot_point[~parallel] = intersect_rays(
            initial_origin[~parallel], initial_look[~parallel],
            final_origin[~parallel], final_look[~parallel],
        )

    pivot_frame = generate_rotation_coordinate_frame(initial_look, final_look, eps=eps)
    initial_params = extrinsics_to_pivot_parameters(initial, pivot_frame, pivot_point)
    final_params = extrinsics_to_pivot_parameters(final, pivot_frame, pivot_point)
    interpolated = interpolate_pivot_parameters(initial_params, final_params, t)
    return pivot_parameters_to_extrinsics(
        interpolated.astype(np.float32),
        pivot_frame[..., None, :, :].astype(np.float32),
        pivot_point[..., None, :].astype(np.float32),
    ).astype(np.float32)
