"""KL-regularized f8 VAE (counterpart of
latentsplat_tpu/model/autoencoder/kl.py). NHWC at the public methods.

`encode` maps [0, 1] images to a diagonal Gaussian over the latents (the
encoder's moments through the 1x1 quant_conv); `decode` maps latents back.
The decoder carries latentSplat's per-up-block 1x1 skip convolutions, fed
with the skip tensor (rendered color + latent sample) resized bilinearly
with align_corners=True. Both halves are always built, as in the JAX
package, so a JAX parameter tree carries over whole. Submodule names follow
the JAX parameter tree.

The modules take and give logical (N, C, H, W) tensors, and the public
methods hand them channels-last (NHWC) memory, the layout their NHWC
inputs already have: every convolution, norm, resize and residual add then
stays channels-last (on the card cuDNN runs its NHWC kernels with no
transposes around them), the attention's flatten and the outputs' permute
to (..., H, W, c) are views. Each group norm, with the SiLU after it, is
one `ops/group_norm.py::group_norm_silu` call (a kernel on the card).

The convolutions whose output a group norm or a residual or skip sum reads
next (`BiasLaterConv2d`: conv_in, the resnets' convs, the resampling and
skip convs) run without their bias, which the module still holds (the
parameters are nn.Conv2d's): that reader adds it, the norm as its shift,
the sum (`ops/residual_add.py::residual_add`, a kernel on the card) as
the bias of its operand, so no conv output is written, read and written
again to add a per-channel constant. A conv output read by a norm and a
sum (conv_in, a Downsample's) gives both its bias; one read by a
conv_shortcut takes its bias first (a one-operand residual_add). The
other convolutions (quant_conv, post_quant_conv, conv_out) keep theirs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.distributions import DiagonalGaussian
from ...ops.group_norm import group_norm_silu
from ...ops.residual_add import residual_add
from ..transformer import attention
from .base import Autoencoder

GROUP_NORM_EPS = 1e-6


def _nchw_view(t: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (N, C, H, W) in channels-last memory: a view of a
    contiguous input."""
    flat = t.reshape(-1, *t.shape[-3:]).permute(0, 3, 1, 2)
    return flat.contiguous(memory_format=torch.channels_last)


def _group_norm(channels: int) -> nn.GroupNorm:
    """32 groups at production widths; gcd(32, c) for narrow test nets."""
    return nn.GroupNorm(math.gcd(32, channels), channels, eps=GROUP_NORM_EPS)


class BiasLaterConv2d(nn.Conv2d):
    """nn.Conv2d whose call leaves out the bias: the caller hands
    `self.bias` to whatever reads the output next."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight, None)


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
        self.conv1 = BiasLaterConv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _group_norm(out_channels)
        self.conv2 = BiasLaterConv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = BiasLaterConv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, x_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The block on x + x_bias (x_bias: the bias a BiasLaterConv2d left
        out of x, or None). Callers pass x_bias by keyword: module hooks see
        the positional inputs only, and a parameter among them breaks
        torch's multi-grad hooks (FlopCounterMode's module tracker) under
        torch.autograd.grad."""
        shortcut = getattr(self, "conv_shortcut", None)
        if shortcut is not None and x_bias is not None:
            x, x_bias = residual_add(x, x_bias), None
        h = self.conv1(group_norm_silu(x, self.norm1, silu=True, shift=x_bias))
        h = self.conv2(group_norm_silu(h, self.norm2, silu=True, shift=self.conv1.bias))
        if shortcut is not None:
            return residual_add(shortcut(x), shortcut.bias, h, self.conv2.bias)
        return residual_add(x, x_bias, h, self.conv2.bias)


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
        y = group_norm_silu(x, self.group_norm, silu=False).flatten(2).transpose(1, 2)[:, None]   # (b, 1, hw, c)
        y = attention(self.to_q(y), self.to_k(y), self.to_v(y))[:, 0]
        y = self.to_out(y).transpose(1, 2).reshape(b, c, h, w)
        return x + y


class Downsample(nn.Module):
    """Pad (0, 1) at the bottom and right, then a stride-2 valid 3x3 conv
    (without its bias)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = BiasLaterConv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x (each pixel repeated into a 2x2 block), then a 3x3 conv
    (without its bias). The repeat is one copy of a broadcast view of the
    NHWC memory into a channels-last tensor (on the card 1.8x as fast as
    F.interpolate's channels-last kernel, the same values)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = BiasLaterConv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        nhwc = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
        return self.conv(nhwc.reshape(n, 2 * h, 2 * w, c).permute(0, 3, 1, 2))


class VaeEncoder(nn.Module):
    """(N, C, H, W) image in [-1, 1] -> (N, 2 x latent channels, h, w)
    moments, in the input's memory layout."""

    def __init__(self, cfg: AutoencoderKLCfg, d_in: int):
        super().__init__()
        self.cfg = cfg
        chans = cfg.block_out_channels
        self.conv_in = BiasLaterConv2d(d_in, chans[0], 3, padding=1)
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
        h, h_bias = self.conv_in(x), self.conv_in.bias   # h + h_bias: the activation
        for i in range(n_blocks):
            for j in range(self.cfg.layers_per_block):
                h, h_bias = getattr(self, f"down_{i}_resnet_{j}")(h, x_bias=h_bias), None
            if i < n_blocks - 1:
                down = getattr(self, f"down_{i}_downsample")
                h, h_bias = down(h), down.conv.bias
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h, x_bias=h_bias)))
        return self.conv_out(group_norm_silu(h, self.conv_norm_out, silu=True))


class VaeDecoder(nn.Module):
    """(N, C, h, w) latent (+ (N, d_skip, H, W) skip) -> (N, c, H, W) image
    in [-1, 1] (before rescale), in the inputs' memory layout."""

    def __init__(self, cfg: AutoencoderKLCfg, d_out: int, d_skip: int):
        super().__init__()
        self.cfg = cfg
        chans = list(reversed(cfg.block_out_channels))
        self.conv_in = BiasLaterConv2d(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_resnet_0 = ResnetBlock(chans[0], chans[0])
        self.mid_attn = AttnBlock(chans[0])
        self.mid_resnet_1 = ResnetBlock(chans[0], chans[0])
        prev = chans[0]
        for i, ch in enumerate(chans):
            if cfg.skip_connections:
                setattr(self, f"skip_conv_{i}", BiasLaterConv2d(d_skip, prev, 1))
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
        """Everything but conv_out: its input."""
        cfg = self.cfg
        n_blocks = len(cfg.block_out_channels)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(self.conv_in(z), x_bias=self.conv_in.bias)))
        h_bias = None   # h + h_bias: the activation
        for i in range(n_blocks):
            if cfg.skip_connections:
                assert skip_z is not None, "decoder expects skip_z"
                resized = F.interpolate(
                    skip_z, size=h.shape[-2:], mode="bilinear", align_corners=True
                )
                skip_conv = getattr(self, f"skip_conv_{i}")
                h, h_bias = residual_add(h, h_bias, skip_conv(resized), skip_conv.bias), None
            for j in range(cfg.layers_per_block + 1):
                h, h_bias = getattr(self, f"up_{i}_resnet_{j}")(h, x_bias=h_bias), None
            if i < n_blocks - 1:
                up = getattr(self, f"up_{i}_upsample")
                h, h_bias = up(h), up.conv.bias
        return group_norm_silu(h, self.conv_norm_out, silu=True)


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
        x = _nchw_view(2.0 * images - 1.0)
        moments = self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)
        moments = moments.reshape(*batch_dims, *moments.shape[1:])
        mean, logvar = torch.chunk(moments, 2, dim=-1)
        return DiagonalGaussian(mean, logvar)

    def decode(self, z: torch.Tensor, skip_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents (..., h', w', z) [+ skip (..., H, W, d_skip)] -> [0, 1] images."""
        return self.decode_out(self.decode_hidden(z, skip_z), z.shape[:-3])

    def decode_hidden(self, z: torch.Tensor, skip_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decode up to its last layer: the input of conv_out, (N, C, H,
        W) in channels-last memory."""
        skip_flat = None if skip_z is None else _nchw_view(skip_z)
        return self.decoder.hidden(self.post_quant_conv(_nchw_view(z)), skip_flat)

    def decode_out(self, hidden: torch.Tensor, batch_dims: tuple) -> torch.Tensor:
        """The decode's last layer (`last_layer()`) on `decode_hidden`'s
        output, as images (*batch_dims, H, W, c)."""
        y = ((self.decoder.conv_out(hidden) + 1.0) / 2.0).permute(0, 2, 3, 1)
        return y.reshape(*batch_dims, *y.shape[1:])
