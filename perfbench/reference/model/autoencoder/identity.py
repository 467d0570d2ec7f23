"""Identity autoencoder for pixel-space ablations (counterpart of
latentsplat_tpu/model/autoencoder/identity.py): RGB passes through,
downscale 1, a zero-variance posterior, no parameters."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...ops.distributions import DiagonalGaussian
from .base import Autoencoder


@dataclass
class AutoencoderIdCfg:
    name: str = "id"
    skip_connections: bool = False


class AutoencoderId(Autoencoder):
    def __init__(self, cfg: AutoencoderIdCfg, d_in: int = 3):
        super().__init__()
        self.cfg = cfg
        self.d_in = d_in

    def encode(self, images: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian(images)

    def decode(self, z: torch.Tensor, skip_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        return z

    @property
    def downscale_factor(self) -> int:
        return 1

    @property
    def d_latent(self) -> int:
        return self.d_in

    @property
    def expects_skip(self) -> bool:
        return False

    @property
    def expects_skip_extra(self) -> bool:
        return False
