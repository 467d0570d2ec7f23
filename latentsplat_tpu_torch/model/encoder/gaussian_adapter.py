"""Raw per-pixel feature vector -> world-space Gaussian parameters
(counterpart of latentsplat_tpu/model/encoder/gaussian_adapter.py).
No learnable parameters."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ...geometry import get_world_rays
from ...ops.gaussians import build_covariance
from ...ops.sh import rotate_sh


@dataclass
class GaussianAdapterCfg:
    gaussian_scale_min: float
    gaussian_scale_max: float
    color_sh_degree: int
    feature_sh_degree: int


class AdapterGaussians(NamedTuple):
    means: torch.Tensor              # (..., 3)
    covariances: torch.Tensor        # (..., 3, 3)
    color_harmonics: torch.Tensor    # (..., 3, d_color_sh)
    feature_harmonics: torch.Tensor  # (..., C, d_feature_sh)
    opacities: torch.Tensor          # (...)


def _sh_mask(degree: int) -> np.ndarray:
    """DC-biased init mask."""
    mask = np.ones(((degree + 1) ** 2,), np.float32)
    for deg in range(1, degree + 1):
        mask[deg**2 : (deg + 1) ** 2] = 0.1 * 0.25**deg
    return mask


class GaussianAdapter:
    def __init__(self, cfg: GaussianAdapterCfg, n_feature_channels: int):
        self.cfg = cfg
        self.n_feature_channels = n_feature_channels
        self.color_sh_mask = torch.from_numpy(_sh_mask(cfg.color_sh_degree))
        self.feature_sh_mask = torch.from_numpy(_sh_mask(cfg.feature_sh_degree))

    @property
    def d_color_sh(self) -> int:
        return (self.cfg.color_sh_degree + 1) ** 2

    @property
    def d_feature_sh(self) -> int:
        return (self.cfg.feature_sh_degree + 1) ** 2

    @property
    def d_in(self) -> int:
        return 7 + 3 * self.d_color_sh + self.n_feature_channels * self.d_feature_sh

    def __call__(
        self,
        extrinsics: torch.Tensor,     # (*#batch, 4, 4)
        intrinsics: torch.Tensor,     # (*#batch, 3, 3)
        coordinates: torch.Tensor,    # (*#batch, 2)
        depths: torch.Tensor,         # (*#batch)
        opacities: torch.Tensor,      # (*#batch)
        raw_gaussians: torch.Tensor,  # (*#batch, d_in)
        image_shape: tuple[int, int],
        eps: float = 1e-8,
    ) -> AdapterGaussians:
        cfg = self.cfg
        scales, rotations, color_sh, feature_sh = raw_gaussians.split(
            [3, 4, 3 * self.d_color_sh, self.n_feature_channels * self.d_feature_sh], dim=-1
        )
        h, w = image_shape
        scales = cfg.gaussian_scale_min + (
            cfg.gaussian_scale_max - cfg.gaussian_scale_min
        ) * torch.sigmoid(scales)
        pixel_size = torch.tensor([1.0 / w, 1.0 / h], device=scales.device)
        multiplier = self.get_scale_multiplier(intrinsics, pixel_size)
        scales = scales * depths[..., None] * multiplier[..., None]

        rotations = rotations / (torch.linalg.norm(rotations, dim=-1, keepdim=True) + eps)

        device = raw_gaussians.device
        color_sh = color_sh.reshape(*color_sh.shape[:-1], 3, self.d_color_sh)
        feature_sh = feature_sh.reshape(
            *feature_sh.shape[:-1], self.n_feature_channels, self.d_feature_sh
        )
        color_sh = color_sh.expand(*opacities.shape, 3, self.d_color_sh) * (
            self.color_sh_mask.to(device)
        )
        feature_sh = feature_sh.expand(
            *opacities.shape, self.n_feature_channels, self.d_feature_sh
        ) * self.feature_sh_mask.to(device)

        covariances = build_covariance(scales, rotations)
        c2w = extrinsics[..., :3, :3]
        covariances = c2w @ covariances @ c2w.transpose(-1, -2)

        origins, directions = get_world_rays(coordinates, extrinsics, intrinsics)
        means = origins + directions * depths[..., None]
        return AdapterGaussians(
            means=means,
            covariances=covariances,
            color_harmonics=rotate_sh(color_sh, c2w[..., None, :, :]),
            feature_harmonics=rotate_sh(feature_sh, c2w[..., None, :, :]),
            opacities=opacities,
        )

    @staticmethod
    def get_scale_multiplier(
        intrinsics: torch.Tensor, pixel_size: torch.Tensor, multiplier: float = 0.1
    ) -> torch.Tensor:
        """0.1 * (K[0:2, 0:2]^-1 @ pixel_size), summed over x and y."""
        a = intrinsics[..., 0, 0]
        b = intrinsics[..., 0, 1]
        c = intrinsics[..., 1, 0]
        d = intrinsics[..., 1, 1]
        det = a * d - b * c
        inv_row0 = torch.stack([d, -b], dim=-1) / det[..., None]
        inv_row1 = torch.stack([-c, a], dim=-1) / det[..., None]
        k_inv = torch.stack([inv_row0, inv_row1], dim=-2)
        return (multiplier * torch.einsum("...ij,j->...i", k_inv, pixel_size)).sum(dim=-1)
