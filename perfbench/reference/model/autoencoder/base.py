"""The autoencoder interface (counterpart of
latentsplat_tpu/model/autoencoder/base.py).

An autoencoder is an `nn.Module` with `encode(images) -> DiagonalGaussian`
and `decode(z, skip_z) -> images` over channel-last tensors, the
properties below, and `last_layer()`: the parameter that anchors the
adaptive GAN weight, or None when it has none (the step then anchors on
the encoder's). `decode` is `decode_out(decode_hidden(z, skip_z),
batch_dims)`, split before the last layer, so that a checkpoint of
`decode_hidden` leaves the anchor outside it; an autoencoder without a last
layer decodes whole in `decode_hidden`.
"""

from __future__ import annotations

from typing import Optional

import torch
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

    def decode_hidden(self, z: torch.Tensor, skip_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(z, skip_z)

    def decode_out(self, hidden: torch.Tensor, batch_dims: tuple) -> torch.Tensor:
        return hidden
