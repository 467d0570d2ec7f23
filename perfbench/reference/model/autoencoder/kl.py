"""KL-regularized f8 VAE (counterpart of
latentsplat_tpu/model/autoencoder/kl.py). NHWC at the public methods.

`encode` maps [0, 1] images to a diagonal Gaussian over the latents (the
encoder's moments through the 1x1 quant_conv); `decode` maps latents back.
The decoder carries latentSplat's per-up-block 1x1 skip convolutions, fed
with the skip tensor (rendered color + latent sample) resized bilinearly
with align_corners=True. Both halves are always built, as in the JAX
package, so a JAX parameter tree carries over whole. Submodule names follow
the JAX parameter tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.distributions import DiagonalGaussian
from ..transformer import attention
from .base import Autoencoder

GROUP_NORM_EPS = 1e-6


def _group_norm(channels: int) -> nn.GroupNorm:
    """32 groups at production widths; gcd(32, c) for narrow test nets."""
    return nn.GroupNorm(math.gcd(32, channels), channels, eps=GROUP_NORM_EPS)


@dataclass
class AutoencoderKLCfg:
    name: str = "kl"
    model: str = "kl_f8"
    down_block_types: List[str] = field(default_factory=lambda: ["DownEncoderBlock2D"] * 4)
    up_block_types: List[str] = field(default_factory=lambda: ["UpDecoderBlock2D"] * 4)
    block_out_channels: List[int] = field(default_factory=lambda: [128, 256, 512, 512])
    layers_per_block: int = 2
    latent_channels: int = 4
    skip_connections: bool = False
    skip_extra: bool = True
    skip_zero: bool = True
    pretrained: bool = True


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _group_norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _group_norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (the SD VAE mid-block attention)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = _group_norm(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)[:, None]   # (b, 1, hw, c)
        y = attention(self.to_q(y), self.to_k(y), self.to_v(y))[:, 0]
        y = self.to_out(y).transpose(1, 2).reshape(b, c, h, w)
        return x + y


class Downsample(nn.Module):
    """Pad (0, 1) at the bottom and right, then a stride-2 valid 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class VaeEncoder(nn.Module):
    """NCHW image in [-1, 1] -> NCHW moments (2 x latent channels)."""

    def __init__(self, cfg: AutoencoderKLCfg, d_in: int):
        super().__init__()
        self.cfg = cfg
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(d_in, chans[0], 3, padding=1)
        prev = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                setattr(self, f"down_{i}_resnet_{j}", ResnetBlock(prev, ch))
                prev = ch
            if i < len(chans) - 1:
                setattr(self, f"down_{i}_downsample", Downsample(ch))
        self.mid_resnet_0 = ResnetBlock(prev, prev)
        self.mid_attn = AttnBlock(prev)
        self.mid_resnet_1 = ResnetBlock(prev, prev)
        self.conv_norm_out = _group_norm(prev)
        self.conv_out = nn.Conv2d(prev, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_blocks = len(self.cfg.block_out_channels)
        h = self.conv_in(x)
        for i in range(n_blocks):
            for j in range(self.cfg.layers_per_block):
                h = getattr(self, f"down_{i}_resnet_{j}")(h)
            if i < n_blocks - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VaeDecoder(nn.Module):
    """NCHW latent (+ NCHW skip) -> NCHW image in [-1, 1] (before rescale)."""

    def __init__(self, cfg: AutoencoderKLCfg, d_out: int, d_skip: int):
        super().__init__()
        self.cfg = cfg
        chans = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_resnet_0 = ResnetBlock(chans[0], chans[0])
        self.mid_attn = AttnBlock(chans[0])
        self.mid_resnet_1 = ResnetBlock(chans[0], chans[0])
        prev = chans[0]
        for i, ch in enumerate(chans):
            if cfg.skip_connections:
                setattr(self, f"skip_conv_{i}", nn.Conv2d(d_skip, prev, 1))
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{i}_resnet_{j}", ResnetBlock(prev, ch))
                prev = ch
            if i < len(chans) - 1:
                setattr(self, f"up_{i}_upsample", Upsample(ch))
        self.conv_norm_out = _group_norm(prev)
        self.conv_out = nn.Conv2d(prev, d_out, 3, padding=1)

    def forward(self, z: torch.Tensor, skip_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.conv_out(self.hidden(z, skip_z))

    def hidden(self, z: torch.Tensor, skip_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Everything but conv_out: its NCHW input."""
        cfg = self.cfg
        n_blocks = len(cfg.block_out_channels)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(self.conv_in(z))))
        for i in range(n_blocks):
            if cfg.skip_connections:
                assert skip_z is not None, "decoder expects skip_z"
                resized = F.interpolate(
                    skip_z, size=h.shape[-2:], mode="bilinear", align_corners=True
                )
                h = h + getattr(self, f"skip_conv_{i}")(resized)
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_resnet_{j}")(h)
            if i < n_blocks - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return F.silu(self.conv_norm_out(h))


class AutoencoderKL(Autoencoder):
    def __init__(self, cfg: AutoencoderKLCfg, d_in: int = 3, d_skip_extra: int = 0):
        super().__init__()
        self.cfg = cfg
        d_skip = cfg.latent_channels + (d_skip_extra if cfg.skip_extra else 0)
        self.encoder = VaeEncoder(cfg, d_in)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.decoder = VaeDecoder(cfg, d_in, d_skip)

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.cfg.block_out_channels) - 1)

    @property
    def d_latent(self) -> int:
        return self.cfg.latent_channels

    @property
    def expects_skip(self) -> bool:
        return self.cfg.skip_connections

    @property
    def expects_skip_extra(self) -> bool:
        return self.cfg.skip_extra

    def last_layer(self) -> nn.Parameter:
        return self.decoder.conv_out.weight

    def encode(self, images: torch.Tensor) -> DiagonalGaussian:
        """[0, 1] images (..., h, w, c) -> the latent posterior over
        (..., h', w', z)."""
        batch_dims = images.shape[:-3]
        x = (2.0 * images - 1.0).reshape(-1, *images.shape[-3:]).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)
        moments = moments.reshape(*batch_dims, *moments.shape[1:])
        mean, logvar = torch.chunk(moments, 2, dim=-1)
        return DiagonalGaussian(mean, logvar)

    def decode(self, z: torch.Tensor, skip_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents (..., h', w', z) [+ skip (..., H, W, d_skip)] -> [0, 1] images."""
        return self.decode_out(self.decode_hidden(z, skip_z), z.shape[:-3])

    def decode_hidden(self, z: torch.Tensor, skip_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decode up to its last layer: the NCHW input of conv_out."""
        z_flat = z.reshape(-1, *z.shape[-3:]).permute(0, 3, 1, 2)
        skip_flat = None
        if skip_z is not None:
            skip_flat = skip_z.reshape(-1, *skip_z.shape[-3:]).permute(0, 3, 1, 2)
        return self.decoder.hidden(self.post_quant_conv(z_flat), skip_flat)

    def decode_out(self, hidden: torch.Tensor, batch_dims: tuple) -> torch.Tensor:
        """The decode's last layer (`last_layer()`) on `decode_hidden`'s
        output, as images (*batch_dims, H, W, c)."""
        y = ((self.decoder.conv_out(hidden) + 1.0) / 2.0).permute(0, 2, 3, 1)
        return y.reshape(*batch_dims, *y.shape[1:])
