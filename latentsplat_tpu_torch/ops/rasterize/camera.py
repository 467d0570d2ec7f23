"""Screen-space projection of 3D Gaussians, EWA splatting (counterpart of
latentsplat_tpu/ops/rasterize/camera.py).

Near-plane cull at z <= 0.2 (the scene is pre-normalized by 1/near), a
1.3 * tan(fov/2) guard band for the Jacobian, a 0.3 low-pass on the 2D
covariance, the |rho| <= 0.99 correlation clamp, a 3-sigma radius and
threshold-aware per-axis extents.
"""

from __future__ import annotations

import torch

from .types import ScreenGaussians

ALPHA_THRESHOLD = 1.0 / 255.0
ALPHA_CLAMP = 0.99
NEAR_CULL_Z = 0.2
COV2D_BLUR = 0.3


def world_to_camera(extrinsics: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R^T (..., 3, 3), -R^T t (..., 3)) of cam-to-world transforms
    (..., 4, 4), the product summed in index order elementwise (a batched
    matrix product's rounding could vary with the batch)."""
    rot = extrinsics[..., :3, :3].transpose(-1, -2)
    t = extrinsics[..., :3, 3]
    trans = -(rot[..., 0] * t[..., 0:1] + rot[..., 1] * t[..., 1:2] + rot[..., 2] * t[..., 2:3])
    return rot, trans


def project_gaussians_to_screen(
    means: torch.Tensor,        # (..., G, 3) world
    covariances: torch.Tensor,  # (..., G, 3, 3) world
    opacities: torch.Tensor,    # (..., G)
    channels: torch.Tensor,     # (..., G, C)
    extrinsics: torch.Tensor,   # (..., 4, 4) cam-to-world
    intrinsics: torch.Tensor,   # (..., 3, 3) normalized
    image_shape: tuple[int, int],
) -> ScreenGaussians:
    """Projects each item's Gaussians through its camera; the leading axes
    (...) are the items of a pass (none for one view). Every operation is
    elementwise or a sum of three, so an item's values do not depend on the
    other items."""
    h, w = image_shape
    rot, trans = world_to_camera(extrinsics)
    rot, trans = rot[..., None, :, :], trans[..., None, :]    # against the G axis

    m0, m1, m2 = means[..., 0], means[..., 1], means[..., 2]
    p_x = rot[..., 0, 0] * m0 + rot[..., 0, 1] * m1 + rot[..., 0, 2] * m2 + trans[..., 0]
    p_y = rot[..., 1, 0] * m0 + rot[..., 1, 1] * m1 + rot[..., 1, 2] * m2 + trans[..., 1]
    z = rot[..., 2, 0] * m0 + rot[..., 2, 1] * m1 + rot[..., 2, 2] * m2 + trans[..., 2]

    fx = intrinsics[..., 0, 0, None] * w
    fy = intrinsics[..., 1, 1, None] * h
    cx = intrinsics[..., 0, 2, None] * w
    cy = intrinsics[..., 1, 2, None] * h

    safe_z = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    mean2d = torch.stack([fx * p_x / safe_z + cx - 0.5, fy * p_y / safe_z + cy - 0.5], dim=-1)

    lim_x = 1.3 * (0.5 * w / fx)
    lim_y = 1.3 * (0.5 * h / fy)
    tx = torch.maximum(torch.minimum(p_x / safe_z, lim_x), -lim_x) * safe_z
    ty = torch.maximum(torch.minimum(p_y / safe_z, lim_y), -lim_y) * safe_z

    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    t0 = j00[..., None] * rot[..., 0, :] + j02[..., None] * rot[..., 2, :]
    t1 = j11[..., None] * rot[..., 1, :] + j12[..., None] * rot[..., 2, :]
    s0, s1, s2 = covariances[..., 0, :], covariances[..., 1, :], covariances[..., 2, :]
    st0 = t0[..., 0:1] * s0 + t0[..., 1:2] * s1 + t0[..., 2:3] * s2
    st1 = t1[..., 0:1] * s0 + t1[..., 1:2] * s1 + t1[..., 2:3] * s2
    c00 = (t0 * st0).sum(dim=-1) + COV2D_BLUR
    c01 = (t0 * st1).sum(dim=-1)
    c11 = (t1 * st1).sum(dim=-1) + COV2D_BLUR
    # Clamp the correlation to |rho| <= 0.99 so the conic stays strictly
    # positive definite.
    c01_max = 0.99 * torch.sqrt(torch.clamp(c00 * c11, min=0.0))
    c01 = torch.maximum(torch.minimum(c01, c01_max), -c01_max)

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c11 / safe_det, -c01 / safe_det, c00 / safe_det], dim=-1)

    mid = 0.5 * (c00 + c11)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))

    valid = (z > NEAR_CULL_Z) & det_ok & (opacities > ALPHA_THRESHOLD)
    valid &= (mean2d[..., 0] + radius >= -0.5) & (mean2d[..., 0] - radius <= w - 0.5)
    valid &= (mean2d[..., 1] + radius >= -0.5) & (mean2d[..., 1] - radius <= h - 0.5)

    zero = torch.zeros_like(radius)
    radius = torch.where(valid, radius, zero)
    opacity = torch.where(valid, opacities, zero)

    # Pixels beyond these per-axis extents provably fall below the alpha
    # threshold (min over dy of the quadratic form is dx^2 / c00).
    log_op = torch.log(255.0 * torch.clamp(opacities, min=1e-12)) + 1e-3
    two_lo = 2.0 * torch.clamp(log_op, min=0.0)
    ext_x = torch.minimum(radius, torch.sqrt(two_lo * torch.clamp(c00, min=0.0)) + 0.01)
    ext_y = torch.minimum(radius, torch.sqrt(two_lo * torch.clamp(c11, min=0.0)) + 0.01)
    extent = torch.where(valid[..., None], torch.stack([ext_x, ext_y], dim=-1), 0.0)

    return ScreenGaussians(
        mean2d=mean2d, conic=conic, depth=z, radius=radius, opacity=opacity,
        channels=channels, extent=extent,
    )
