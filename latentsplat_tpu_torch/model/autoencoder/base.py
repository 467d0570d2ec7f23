"""The autoencoder interface (counterpart of
latentsplat_tpu/model/autoencoder/base.py).

An autoencoder is an `nn.Module` with `encode(images) -> DiagonalGaussian`
and `decode(z, skip_z) -> images` over channel-last tensors, the
properties below, and `last_layer()`: the parameter that anchors the
adaptive GAN weight, or None when it has none (the step then anchors on
the encoder's).
"""

from __future__ import annotations

from typing import Optional

from torch import nn


class Autoencoder(nn.Module):
    @property
    def downscale_factor(self) -> int:
        raise NotImplementedError

    @property
    def d_latent(self) -> int:
        raise NotImplementedError

    @property
    def expects_skip(self) -> bool:
        raise NotImplementedError

    @property
    def expects_skip_extra(self) -> bool:
        raise NotImplementedError

    def last_layer(self) -> Optional[nn.Parameter]:
        return None
