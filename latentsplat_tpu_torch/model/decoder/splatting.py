"""Splatting decoder: Gaussians -> target-view renders (counterpart of
latentsplat_tpu/model/decoder/splatting.py).

When the render is not variational, the feature posterior's logvar is
log(1 - mask), so empty pixels have unit variance around the zero
background; when it is (`variational: latents`), the rendered channels are
the posterior's mean and logvar. `remat` checkpoints each view's render.
A `depth_mode` other than "depth" replaces the render's own
(normalized) depth with `render_depth` in that mode, which renders at
"exact" as in the JAX package. `precision` takes the JAX package's names
(ops/rasterize/tiled.py PRECISIONS: "exact", "fast" and the diagnostic
precisions)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...misc.profiler import host_read
from ...ops.distributions import DiagonalGaussian
from ...ops.rasterize.api import DepthRenderingMode, render, render_depth
from ...ops.rasterize.tiled import precision_knobs
from ..types import Gaussians


@dataclass
class DecoderSplattingCfg:
    name: str = "splatting"
    backend: str = "tiled"
    max_tiles_per_gaussian: int = 9
    pair_budget_factor: float = 4.0
    remat: bool = False
    precision: str = "exact"


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
        precision_knobs(cfg.precision)   # raises on a name the JAX package does not take
        self.cfg = cfg
        self.background_color = tuple(background_color)
        self.variational = variational

    def __call__(
        self, gaussians: Gaussians, extrinsics: torch.Tensor, intrinsics: torch.Tensor,
        near: torch.Tensor, far: torch.Tensor, image_shape: tuple[int, int],
        depth_mode: Optional[DepthRenderingMode] = None, return_colors: bool = True,
        return_features: bool = True,
    ) -> DecoderOutput:
        b = extrinsics.shape[0]
        with host_read("background"):
            background = torch.tensor(self.background_color, device=extrinsics.device)
        out = render(
            extrinsics, intrinsics, near, far, image_shape, background.expand(b, 3),
            gaussians.means, gaussians.covariances, gaussians.opacities,
            gaussians.color_harmonics if return_colors else None,
            gaussians.feature_harmonics if return_features else None,
            backend=self.cfg.backend, max_tiles_per_gaussian=self.cfg.max_tiles_per_gaussian,
            remat=self.cfg.remat, precision=self.cfg.precision,
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
        depth = out.depth
        if depth_mode is not None and depth_mode != "depth":
            depth = self.render_special_depth(gaussians, extrinsics, intrinsics, near, far, image_shape, depth_mode)
        return DecoderOutput(color, posterior, out.mask, depth, out.num_pairs)

    def render_special_depth(
        self, gaussians: Gaussians, extrinsics: torch.Tensor, intrinsics: torch.Tensor,
        near: torch.Tensor, far: torch.Tensor, image_shape: tuple[int, int],
        mode: DepthRenderingMode = "depth",
    ) -> torch.Tensor:
        return render_depth(
            extrinsics, intrinsics, near, far, image_shape,
            gaussians.means, gaussians.covariances, gaussians.opacities,
            mode=mode, backend=self.cfg.backend,
        )
