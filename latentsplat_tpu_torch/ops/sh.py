"""Real spherical harmonics: evaluation and rotation (counterpart of
latentsplat_tpu/ops/sh.py).

Same basis convention as the reference (degrees 0..4). Rotation recovers
each band's coefficient transform from fixed sample directions:
c' = B^+ @ basis_l(R^T D) @ c, with B^+ the pseudo-inverse of the basis at
the sample directions D. Both constants are built with numpy at import.
"""

from __future__ import annotations

from math import isqrt

import numpy as np
import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = [1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396]
_C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435]
_C4 = [2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761]


def _sh_basis_terms(dirs, degree: int, xp) -> list:
    """Backend-generic (numpy or torch) SH basis evaluation: the
    (degree + 1)**2 basis values, each of the shape dirs.shape[:-1]."""
    assert 0 <= degree <= 4
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [_C0 * xp.ones_like(x)]
    if degree >= 1:
        out += [-_C1 * x, _C1 * y, -_C1 * z]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xz,
            _C2[1] * xy,
            _C2[2] * (2.0 * yy - zz - xx),
            _C2[3] * yz,
            _C2[4] * (zz - xx),
        ]
    if degree >= 3:
        out += [
            _C3[0] * x * (3 * zz - xx),
            _C3[1] * xz * y,
            _C3[2] * x * (4 * yy - zz - xx),
            _C3[3] * y * (2 * yy - 3 * zz - 3 * xx),
            _C3[4] * z * (4 * yy - zz - xx),
            _C3[5] * y * (zz - xx),
            _C3[6] * z * (zz - 3 * xx),
        ]
    if degree >= 4:
        out += [
            _C4[0] * xz * (zz - xx),
            _C4[1] * xy * (3 * zz - xx),
            _C4[2] * xz * (7 * yy - 1),
            _C4[3] * xy * (7 * yy - 3),
            _C4[4] * (yy * (35 * yy - 30) + 3),
            _C4[5] * yz * (7 * yy - 3),
            _C4[6] * (zz - xx) * (7 * yy - 1),
            _C4[7] * yz * (zz - 3 * xx),
            _C4[8] * (zz * (zz - 3 * xx) - xx * (3 * zz - xx)),
        ]
    return out


def _sh_basis_impl(dirs, degree: int, xp):
    return xp.stack(_sh_basis_terms(dirs, degree, xp), -1)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., 3) unit directions -> (..., (degree+1)**2) basis values."""
    return _sh_basis_impl(dirs, degree, torch)


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh (..., C, n_coeffs) at unit dirs (..., 3) -> (..., C). The terms
    are added in coefficient order, elementwise, so that a value does not
    depend on how many others share the call (a matrix product's rounding
    could); each term reads its coefficients and basis values contiguous
    (coefficient-major)."""
    coeff = (degree + 1) ** 2
    assert sh.shape[-1] >= coeff
    basis = _sh_basis_terms(dirs, degree, torch)
    coefficients = sh[..., :coeff].movedim(-1, 0).contiguous()      # (coeff, ..., C)
    out = coefficients[0] * basis[0][..., None]
    for k in range(1, coeff):
        out = out + coefficients[k] * basis[k][..., None]
    return out


def _rotation_constants(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """(sample dirs (K, 3), pinv of the band-`degree` basis (2l+1, K))."""
    n = 2 * (2 * degree + 1)
    rng = np.random.RandomState(1234 + degree)
    d = rng.normal(size=(n, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float64)
    full = _sh_basis_impl(dirs, degree, np)
    return dirs, np.linalg.pinv(full[:, degree**2 : (degree + 1) ** 2])


_ROTATION_CONSTANTS = {degree: _rotation_constants(degree) for degree in range(1, 5)}


def sh_rotation_matrix(rotations: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 2l+1, 2l+1) band-l coefficient rotation."""
    dirs_np, pinv_np = _ROTATION_CONSTANTS[degree]
    dirs = torch.as_tensor(dirs_np, dtype=rotations.dtype, device=rotations.device)
    pinv = torch.as_tensor(pinv_np, dtype=rotations.dtype, device=rotations.device)
    rotated = torch.einsum("...ji,kj->...ki", rotations, dirs)
    b_r = sh_basis(rotated, degree)[..., degree**2 : (degree + 1) ** 2]
    return torch.einsum("mk,...ki->...mi", pinv, b_r)


def rotate_sh(sh_coefficients: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Rotate the represented function by R: eval(rotate_sh(c, R), R d) == eval(c, d)."""
    n = sh_coefficients.shape[-1]
    max_degree = isqrt(n)
    assert max_degree * max_degree == n, "coefficient count must be a square"
    parts = [sh_coefficients[..., :1]]
    for degree in range(1, max_degree):
        m_t = sh_rotation_matrix(rotations, degree)
        band = sh_coefficients[..., degree**2 : (degree + 1) ** 2]
        parts.append(torch.einsum("...mi,...i->...m", m_t, band))
    return torch.cat(parts, dim=-1)
