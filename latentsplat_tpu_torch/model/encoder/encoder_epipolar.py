"""The epipolar encoder: context images -> variational 3D Gaussians
(counterpart of latentsplat_tpu/model/encoder/encoder_epipolar.py).

Context dict layout (NHWC): image (b, v, h, w, 3), extrinsics (b, v, 4, 4),
normalized intrinsics (b, v, 3, 3), near/far (b, v). With `features` (the
VAE latents of the context images under `encode_latents`) the backbone
consumes those instead of the images.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...geometry import sample_image_grid
from ...misc.profiler import host_read, span
from ...ops.distributions import DiagonalGaussian
from ..types import VariationalGaussians
from .backbone import BackboneCfg, get_backbone
from .depth_predictor import DepthPredictorMonocular
from .epipolar_transformer import EpipolarTransformer, EpipolarTransformerCfg
from .gaussian_adapter import GaussianAdapter, GaussianAdapterCfg


@dataclass
class OpacityMappingCfg:
    initial: float
    final: float
    warm_up: int


@dataclass
class EncoderEpipolarCfg:
    name: str
    d_backbone: int
    d_feature: int
    num_monocular_samples: int
    num_surfaces: int
    predict_opacity: bool
    backbone: BackboneCfg
    near_disparity: float
    gaussian_adapter: GaussianAdapterCfg
    apply_bounds_shim: bool
    epipolar_transformer: EpipolarTransformerCfg
    opacity_mapping: OpacityMappingCfg
    gaussians_per_pixel: int
    use_epipolar_transformer: bool
    use_transmittance: bool


class EncoderEpipolar(nn.Module):
    """`input_downscale` is the image grid over the grid of the backbone's
    input: 1 for images, the autoencoder's downscale for its latents. The
    high-resolution skip (a 7x7 conv of the context images) exists only
    where the feature grid can equal the image grid."""

    def __init__(
        self, cfg: EncoderEpipolarCfg, d_in: int, n_feature_channels: int,
        scale_factor: Fraction, variational: bool, input_downscale: int = 1,
    ):
        super().__init__()
        self.cfg = cfg
        self.scale_factor = scale_factor
        self.variational = variational
        self.adapter = GaussianAdapter(
            cfg.gaussian_adapter,
            2 * n_feature_channels if variational else n_feature_channels,
        )
        self.backbone = get_backbone(cfg.backbone, d_in, cfg.d_backbone, scale_factor)
        self.backbone_projection = nn.Linear(cfg.d_backbone, cfg.d_feature)
        if cfg.use_epipolar_transformer:
            self.epipolar_transformer = EpipolarTransformer(
                cfg.epipolar_transformer, cfg.d_feature
            )
        if scale_factor == 1 and input_downscale == 1:
            self.high_resolution_skip = nn.Conv2d(3, cfg.d_feature, 7, padding=3)
        self.depth_predictor = DepthPredictorMonocular(
            cfg.d_feature, cfg.num_monocular_samples, cfg.num_surfaces, cfg.use_transmittance
        )
        self.to_gaussians = nn.Linear(
            cfg.d_feature, cfg.num_surfaces * (2 + self.adapter.d_in)
        )
        if cfg.predict_opacity:
            self.to_opacity = nn.Linear(cfg.d_feature, 1)

    def map_pdf_to_opacity(self, pdf: torch.Tensor, global_step: int) -> torch.Tensor:
        cfg = self.cfg.opacity_mapping
        x = cfg.initial + min(global_step / max(cfg.warm_up, 1), 1.0) * (
            cfg.final - cfg.initial
        )
        exponent = 2.0**x
        return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))

    def forward(
        self,
        context: dict,
        global_step: int = 0,
        deterministic: bool = False,
        generator: Optional[torch.Generator] = None,
        depth_noise: Optional[torch.Tensor] = None,
        features: Optional[torch.Tensor] = None,
    ) -> VariationalGaussians:
        """`features`: latents (b, v, h', w', c) or (b * v, h', w', c) to
        encode in place of the images."""
        cfg = self.cfg
        image = context["image"]
        b, v = image.shape[:2]

        with span("encoder.backbone"):
            if features is None:
                features = image
            features = self.backbone(features.reshape(b * v, *features.shape[-3:]))
            h, w = features.shape[1:3]
            features = self.backbone_projection(F.relu(features))
            features = features.reshape(b, v, h, w, cfg.d_feature)

        with span("encoder.epipolar"):
            if cfg.use_epipolar_transformer:
                features, _ = self.epipolar_transformer(
                    features, context["extrinsics"], context["intrinsics"],
                    context["near"], context["far"],
                )

            if hasattr(self, "high_resolution_skip") and (h, w) == tuple(image.shape[2:4]):
                skip = self.high_resolution_skip(
                    image.reshape(b * v, h, w, -1).permute(0, 3, 1, 2)
                )
                features = features + F.relu(skip).permute(0, 2, 3, 1).reshape(
                    b, v, h, w, cfg.d_feature
                )

        with span("encoder.gaussians"):
            features = features.reshape(b, v, h * w, cfg.d_feature)
            gpp = 1 if deterministic else cfg.gaussians_per_pixel
            depths, densities = self.depth_predictor(
                features, context["near"], context["far"], deterministic, gpp,
                generator=generator, noise=depth_noise,
            )

            raw = self.to_gaussians(F.relu(features))
            raw = raw.reshape(b, v, h * w, cfg.num_surfaces, 2 + self.adapter.d_in)

            xy_ray, _ = sample_image_grid((h, w), image.device)
            xy_ray = xy_ray.reshape(h * w, 1, 2)
            offset_xy = torch.sigmoid(raw[..., :2])
            with host_read("pixel_size"):
                pixel_size = torch.tensor([1.0 / w, 1.0 / h], device=image.device)
            xy_ray = xy_ray[None, None] + (offset_xy - 0.5) * pixel_size

            gaussians = self.adapter(
                context["extrinsics"][:, :, None, None, None],
                context["intrinsics"][:, :, None, None, None],
                xy_ray[:, :, :, :, None],
                depths,
                self.map_pdf_to_opacity(densities, global_step) / cfg.gaussians_per_pixel,
                raw[..., None, 2:],
                (h, w),
            )

            if cfg.predict_opacity:
                opacity_multiplier = torch.sigmoid(self.to_opacity(F.relu(features)))[..., None]
            else:
                opacity_multiplier = 1.0

            def flatten_g(x):
                # (b, v, r, srf, spp, ...) -> (b, v*r*srf*spp, ...)
                return x.reshape(b, -1, *x.shape[5:])

            feature_harmonics = flatten_g(gaussians.feature_harmonics)
            feature_dist = (
                DiagonalGaussian.from_params(feature_harmonics, dim=-2)
                if self.variational
                else DiagonalGaussian(feature_harmonics)
            )
            return VariationalGaussians(
                means=flatten_g(gaussians.means),
                covariances=flatten_g(gaussians.covariances),
                opacities=flatten_g(opacity_multiplier * gaussians.opacities),
                color_harmonics=flatten_g(gaussians.color_harmonics),
                feature_harmonics=feature_dist,
            )
