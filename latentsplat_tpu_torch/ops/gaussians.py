"""Quaternion -> rotation matrix and Gaussian covariance construction
(counterpart of latentsplat_tpu/ops/gaussians.py; xyzw quaternion order)."""

from __future__ import annotations

import torch


def quaternion_to_matrix(quaternions: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 4) xyzw quaternions -> (..., 3, 3) rotation matrices."""
    i, j, k, r = quaternions.unbind(-1)
    two_s = 2.0 / ((quaternions * quaternions).sum(dim=-1) + eps)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(*o.shape[:-1], 3, 3)


def build_covariance(scale: torch.Tensor, rotation_xyzw: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T from per-axis scales (..., 3) and quaternions (..., 4)."""
    rotation = quaternion_to_matrix(rotation_xyzw)
    rs = rotation * (scale**2)[..., None, :]
    return rs @ rotation.transpose(-1, -2)
