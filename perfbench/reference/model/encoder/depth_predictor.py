"""Monocular depth predictor (counterpart of
latentsplat_tpu/model/encoder/depth_predictor.py): a per-pixel pdf over
disparity buckets plus per-bucket offsets; inverse-CDF sampling or top-k."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...geometry import relative_disparity_to_depth
from ...ops.distributions import gather_discrete_topk, sample_discrete_distribution


class DepthPredictorMonocular(nn.Module):
    def __init__(self, d_in: int, num_samples: int, num_surfaces: int, use_transmittance: bool):
        super().__init__()
        self.num_samples = num_samples
        self.num_surfaces = num_surfaces
        self.use_transmittance = use_transmittance
        self.projection = nn.Linear(d_in, 2 * num_samples * num_surfaces)

    def forward(
        self,
        features: torch.Tensor,   # (b, v, r, c)
        near: torch.Tensor,       # (b, v)
        far: torch.Tensor,        # (b, v)
        deterministic: bool,
        gaussians_per_pixel: int,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (depth, opacity), each (b, v, r, srf, spp). `noise` holds
        the uniform samples of the stochastic draw, (b, v, r, srf, spp)."""
        s, srf = self.num_samples, self.num_surfaces
        y = self.projection(F.relu(features))
        y = y.reshape(*y.shape[:-1], s, srf, 2)
        pdf = y[..., 0].movedim(-2, -1).softmax(dim=-1)       # (..., srf, dpt)
        offset = torch.sigmoid(y[..., 1].movedim(-2, -1))

        if deterministic:
            index, pdf_i = gather_discrete_topk(pdf, gaussians_per_pixel)
        else:
            index, pdf_i = sample_discrete_distribution(
                pdf, gaussians_per_pixel, generator=generator, noise=noise
            )

        offset_i = torch.gather(offset, -1, index)
        relative_disparity = (index.float() + offset_i) / s
        depth = relative_disparity_to_depth(
            relative_disparity, near[:, :, None, None, None], far[:, :, None, None, None]
        )
        if self.use_transmittance:
            partial = pdf.cumsum(dim=-1)
            partial = torch.cat([torch.zeros_like(partial[..., :1]), partial[..., :-1]], dim=-1)
            opacity = torch.gather(pdf / (1.0 - partial + 1e-10), -1, index)
        else:
            opacity = pdf_i
        return depth, opacity
