"""Model-level containers: Gaussians and the loss sites' predictions and
ground truths (counterpart of latentsplat_tpu/model/types.py). Images are
NHWC, (batch, view, height, width, channel)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.distributions import DiagonalGaussian


@dataclass
class Gaussians:
    means: torch.Tensor                               # (batch, gaussian, 3)
    covariances: torch.Tensor                         # (batch, gaussian, 3, 3)
    opacities: torch.Tensor                           # (batch, gaussian)
    color_harmonics: Optional[torch.Tensor] = None    # (b, g, 3, d_color_sh)
    feature_harmonics: Optional[torch.Tensor] = None  # (b, g, c, d_feature_sh)


@dataclass
class VariationalGaussians:
    """Gaussians whose feature harmonics form a diagonal Gaussian posterior."""

    means: torch.Tensor
    covariances: torch.Tensor
    opacities: torch.Tensor
    color_harmonics: Optional[torch.Tensor] = None
    feature_harmonics: Optional[DiagonalGaussian] = None

    def _with_features(self, feature_harmonics: torch.Tensor) -> Gaussians:
        return Gaussians(
            self.means, self.covariances, self.opacities, self.color_harmonics,
            feature_harmonics,
        )

    def flatten(self) -> Gaussians:
        """Mean and logvar packed along the channel axis: the payload of a
        `variational: latents` render."""
        return self._with_features(self.feature_harmonics.params(dim=-2))

    def mode(self) -> Gaussians:
        return self._with_features(self.feature_harmonics.mode())

    def sample(
        self, generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Gaussians:
        return self._with_features(self.feature_harmonics.sample(generator, noise))


@dataclass
class Prediction:
    """What a supervision site predicts (counterpart of the JAX Prediction)."""

    image: Optional[torch.Tensor] = None          # (b, v, h, w, c)
    posterior: Optional[DiagonalGaussian] = None
    depth: Optional[torch.Tensor] = None          # (b, v, h, w)
    logits_fake: Optional[torch.Tensor] = None    # (b, v, h', w', 1)
    logits_real: Optional[torch.Tensor] = None
    harmonics: Optional[torch.Tensor] = None      # (b, g, 3, d_sh) color SH, gaussian site


@dataclass
class GroundTruth:
    image: Optional[torch.Tensor] = None          # (b, v, h, w, c)
    near: Optional[torch.Tensor] = None           # (b, v)
    far: Optional[torch.Tensor] = None            # (b, v)
