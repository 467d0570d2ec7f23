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


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) unit xyzw quaternions.

    Shepperd's method, branch-free: each of the four standard formulas
    divides by a component recovered from the diagonal, and the one whose
    component is largest (at least 1/2) is taken, so no division is by
    a number near zero, also near half-turns."""
    m = matrix
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    # 4 * (w^2, x^2, y^2, z^2), each from the diagonal.
    squares = torch.stack(
        [1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    d21, d12 = m[..., 2, 1], m[..., 1, 2]
    d02, d20 = m[..., 0, 2], m[..., 2, 0]
    d10, d01 = m[..., 1, 0], m[..., 0, 1]
    # Row k: 4 * component_k * (x, y, z, w).
    candidates = torch.stack(
        [
            torch.stack([d21 - d12, d02 - d20, d10 - d01, squares[..., 0]], dim=-1),
            torch.stack([squares[..., 1], d01 + d10, d02 + d20, d21 - d12], dim=-1),
            torch.stack([d01 + d10, squares[..., 2], d12 + d21, d02 - d20], dim=-1),
            torch.stack([d02 + d20, d12 + d21, squares[..., 3], d10 - d01], dim=-1),
        ],
        dim=-2,
    )
    best = squares.argmax(dim=-1)
    chosen = torch.take_along_dim(candidates, best[..., None, None], dim=-2)[..., 0, :]
    return chosen / torch.linalg.norm(chosen, dim=-1, keepdim=True)


JACOBI_SWEEPS = 8


def symmetric_eigh_3x3(matrices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (..., 3), ascending, and eigenvectors (..., 3, 3) as
    columns, of symmetric 3x3 matrices: cyclic Jacobi rotations in float64,
    a fixed number of sweeps (convergence is quadratic: 8 sweeps reach
    float64 rounding), elementwise over any batch on any device. The card's
    batched `torch.linalg.eigh` (cuSOLVER's syevBatched) refuses a batch of
    3x3 matrices of this size (CUSOLVER_STATUS_INVALID_VALUE)."""
    dtype = matrices.dtype
    a = matrices.reshape(-1, 3, 3).double()
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(a)
    v = eye.clone()
    for _ in range(JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = a[:, p, q]
            rotate = apq != 0.0
            theta = (a[:, q, q] - a[:, p, p]) / (2.0 * torch.where(rotate, apq, 1.0))
            t = torch.where(theta >= 0.0, 1.0, -1.0) / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(rotate, t, 0.0)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            j = eye.clone()
            j[:, p, p], j[:, q, q], j[:, p, q], j[:, q, p] = c, c, s, -s
            a = j.transpose(-1, -2) @ a @ j
            v = v @ j
    eigenvalues, order = torch.diagonal(a, dim1=-2, dim2=-1).sort(dim=-1)
    eigenvectors = torch.take_along_dim(v, order[:, None, :], dim=-1)
    return (eigenvalues.to(dtype).reshape(matrices.shape[:-1]),
            eigenvectors.to(dtype).reshape(matrices.shape))


def covariance_to_scale_rotation(covariances: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `build_covariance`: (..., 3, 3) -> scales (..., 3) and
    xyzw quaternions (..., 4), for the PLY export, through
    `symmetric_eigh_3x3`. The eigenvectors' order and signs are arbitrary,
    as rendering does not see them; the last axis is flipped where needed
    to make a rotation (det +1). The JAX package reads the quaternion off
    the trace alone, which loses accuracy near half-turns;
    `matrix_to_quaternion` does not."""
    eigvals, eigvecs = symmetric_eigh_3x3(covariances)
    sign = torch.sign(torch.linalg.det(eigvecs))
    eigvecs = torch.cat([eigvecs[..., :2], eigvecs[..., 2:] * sign[..., None, None]], dim=-1)
    return torch.sqrt(torch.clamp(eigvals, min=1e-20)), matrix_to_quaternion(eigvecs)
