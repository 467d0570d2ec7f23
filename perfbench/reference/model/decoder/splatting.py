"""Splatting decoder: Gaussians -> target-view renders, through the
reference's plain render. When the render is not variational, the feature
posterior's logvar is log(1 - mask); with `variational: latents` the
rendered channels are the posterior's mean and logvar."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...ops.distributions import DiagonalGaussian
from ...ops.rasterize.api import render
from ..types import Gaussians


@dataclass
class DecoderOutput:
    color: Optional[torch.Tensor]                     # (b, v, h, w, 3)
    feature_posterior: Optional[DiagonalGaussian]     # over (b, v, h, w, c)
    mask: torch.Tensor                                # (b, v, h, w)
    depth: torch.Tensor                               # (b, v, h, w)
    num_pairs: Optional[torch.Tensor] = None          # (b, v)


class DecoderSplatting:
    def __init__(self, cfg: DecoderSplattingCfg, background_color=(0.0, 0.0, 0.0),
                 variational: bool = False):
        self.cfg = cfg
        self.background_color = tuple(background_color)
        self.variational = variational

    def __call__(
        self, gaussians: Gaussians, extrinsics: torch.Tensor, intrinsics: torch.Tensor,
        near: torch.Tensor, far: torch.Tensor, image_shape: tuple[int, int],
        return_colors: bool = True, return_features: bool = True,
    ) -> DecoderOutput:
        b = extrinsics.shape[0]
        background = torch.tensor(self.background_color, device=extrinsics.device)
        out = render(
            extrinsics, intrinsics, near, far, image_shape, background.expand(b, 3),
            gaussians.means, gaussians.covariances, gaussians.opacities,
            gaussians.color_harmonics if return_colors else None,
            gaussians.feature_harmonics if return_features else None,
            max_tiles_per_gaussian=self.cfg.max_tiles_per_gaussian,
        )
        color = out.color.permute(0, 1, 3, 4, 2) if out.color is not None else None
        posterior = None
        if out.feature is not None:
            features = out.feature.permute(0, 1, 3, 4, 2)
            if self.variational:
                posterior = DiagonalGaussian.from_params(features, dim=-1)
            else:
                logvar = torch.log1p(-out.mask.detach())[..., None].expand(features.shape)
                posterior = DiagonalGaussian(features, logvar)
        return DecoderOutput(color, posterior, out.mask, out.depth, out.num_pairs)
