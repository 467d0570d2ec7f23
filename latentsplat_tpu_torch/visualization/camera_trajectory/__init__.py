"""Camera trajectories for videos (counterpart of
latentsplat_tpu/visualization/camera_trajectory)."""

from .interpolation import interpolate_extrinsics, interpolate_intrinsics
from .spin import generate_spin
from .wobble import generate_wobble, generate_wobble_transformation

__all__ = [
    "interpolate_extrinsics",
    "interpolate_intrinsics",
    "generate_wobble",
    "generate_wobble_transformation",
    "generate_spin",
]
