"""Epipolar feature sampling (counterpart of
latentsplat_tpu/model/encoder/epipolar_sampler.py).

For each ordered view pair, per-pixel rays are projected onto the other
view; `num_samples` equally spaced points along the clipped epipolar
segment are bilinearly sampled (`F.grid_sample`, zeros padding,
align_corners=False) from the other view's feature map, and rays with no
image overlap are zeroed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...geometry import get_world_rays, project_rays, sample_image_grid
from ...misc.heterogeneous_pairings import (
    generate_heterogeneous_index,
    generate_heterogeneous_index_transpose,
)
from ...misc.profiler import host_read


class EpipolarSampling(NamedTuple):
    features: torch.Tensor        # (b, v, ov, ray, sample, c)
    valid: torch.Tensor           # (b, v, ov, ray) bool
    xy_ray: torch.Tensor          # (b, v, ray, 2)
    xy_sample: torch.Tensor       # (b, v, ov, ray, sample, 2)
    xy_sample_near: torch.Tensor  # (b, v, ov, ray, sample, 2) each sample's segment start
    xy_sample_far: torch.Tensor   # (b, v, ov, ray, sample, 2) and end
    origins: torch.Tensor         # (b, v, ray, 3)
    directions: torch.Tensor      # (b, v, ray, 3)


def sample_epipolar_features(
    features: torch.Tensor,     # (b, v, h, w, c)
    extrinsics: torch.Tensor,   # (b, v, 4, 4)
    intrinsics: torch.Tensor,   # (b, v, 3, 3)
    near: torch.Tensor,         # (b, v)
    far: torch.Tensor,          # (b, v)
    num_samples: int,
) -> EpipolarSampling:
    b, v, h, w, c = features.shape
    device = features.device
    _, index_v = generate_heterogeneous_index(v)
    t_v, t_ov = generate_heterogeneous_index_transpose(v)
    with host_read("epipolar_index"):
        index_v = torch.as_tensor(index_v, device=device)
        t_v = torch.as_tensor(t_v, device=device)
        t_ov = torch.as_tensor(t_ov, device=device)

    xy, _ = sample_image_grid((h, w), device)
    xy_flat = xy.reshape(-1, 2)
    origins, directions = get_world_rays(
        xy_flat[None, None], extrinsics[:, :, None], intrinsics[:, :, None]
    )                                                     # (b, v, r, 3)

    projection = project_rays(
        origins[:, :, None],
        directions[:, :, None],
        extrinsics[:, index_v][:, :, :, None],            # (b, v, ov, 1, 4, 4)
        intrinsics[:, index_v][:, :, :, None],
        near=near[:, :, None, None],
        far=far[:, :, None, None],
    )

    s = num_samples
    sample_depth = ((torch.arange(s, device=device, dtype=torch.float32) + 0.5) / s)[:, None]
    overlaps = projection["overlaps_image"]
    xy_min = torch.nan_to_num(projection["xy_min"], posinf=0.0, neginf=0.0)
    xy_min = (xy_min * overlaps[..., None])[..., None, :]
    xy_max = torch.nan_to_num(projection["xy_max"], posinf=0.0, neginf=0.0)
    xy_max = (xy_max * overlaps[..., None])[..., None, :]
    xy_sample = xy_min + sample_depth * (xy_max - xy_min)   # (b, v, ov, r, s, 2)

    # Transpose so the view axis indexes the view the samples are drawn
    # FROM, sample each feature map once, then transpose back.
    samples_xy = xy_sample[:, t_v, t_ov]
    grid = (2.0 * samples_xy - 1.0).reshape(b * v, 1, -1, 2)
    image = features.reshape(b * v, h, w, c).permute(0, 3, 1, 2)
    sampled = F.grid_sample(
        image, grid, mode="bilinear", padding_mode="zeros", align_corners=False
    )                                                     # (b*v, c, 1, ov*r*s)
    sampled = sampled[:, :, 0].transpose(1, 2).reshape(b, v, v - 1, h * w, s, c)
    sampled = sampled[:, t_v, t_ov] * overlaps[..., None, None]

    half_span = 0.5 / s
    return EpipolarSampling(
        features=sampled,
        valid=overlaps,
        xy_ray=xy_flat[None, None].expand(b, v, h * w, 2),
        xy_sample=xy_sample,
        xy_sample_near=xy_min + (sample_depth - half_span) * (xy_max - xy_min),
        xy_sample_far=xy_min + (sample_depth + half_span) * (xy_max - xy_min),
        origins=origins,
        directions=directions,
    )
