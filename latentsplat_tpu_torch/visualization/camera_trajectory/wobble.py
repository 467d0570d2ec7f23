"""Camera wobble (counterpart of
latentsplat_tpu/visualization/camera_trajectory/wobble.py): a circular
translation in the image plane, its radius growing with t, right-multiplied
onto camera-to-world extrinsics. Host numpy.
"""

from __future__ import annotations

import numpy as np


def generate_wobble_transformation(
    radius: np.ndarray,          # (*batch,)
    t: np.ndarray,               # (time,)
    num_rotations: int = 1,
    scale_radius_with_t: bool = True,
) -> np.ndarray:                 # (*batch, time, 4, 4)
    radius = np.asarray(radius, np.float32)
    t = np.asarray(t, np.float32)
    tf = np.broadcast_to(np.eye(4, dtype=np.float32), (*radius.shape, t.shape[0], 4, 4)).copy()
    r = radius[..., None]
    if scale_radius_with_t:
        r = r * t
    tf[..., 0, 3] = np.sin(2 * np.pi * num_rotations * t) * r
    tf[..., 1, 3] = -np.cos(2 * np.pi * num_rotations * t) * r
    return tf


def generate_wobble(
    extrinsics: np.ndarray,      # (*batch, 4, 4)
    radius: np.ndarray,          # (*batch,)
    t: np.ndarray,               # (time,)
) -> np.ndarray:                 # (*batch, time, 4, 4)
    tf = generate_wobble_transformation(radius, t)
    return np.asarray(extrinsics, np.float32)[..., None, :, :] @ tf
