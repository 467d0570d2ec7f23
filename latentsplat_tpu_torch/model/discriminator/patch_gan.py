"""Pix2Pix PatchGAN discriminator (counterpart of
latentsplat_tpu/model/discriminator/patch_gan.py). NHWC at the public call.

4x4 convolutions (stride 2 with padding 1 while downscaling), LeakyReLU 0.2
and train-mode BatchNorm: batch statistics with the biased variance, eps
1e-5, affine parameters, no running statistics (the discriminator only ever
runs in train mode). Submodule names follow the flax tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class DiscriminatorPatchGan(nn.Module):
    def __init__(self, cfg, d_in: int = 3):
        super().__init__()
        self.cfg = cfg
        k, s, pad = cfg.kernel_size, cfg.downscale_factor, cfg.padding
        self.conv_0 = nn.Conv2d(d_in, cfg.base_dim, k, stride=s, padding=pad)
        prev = cfg.base_dim
        for n in range(1, cfg.n_layers + 1):
            ch = cfg.base_dim * min(cfg.downscale_factor**n, cfg.max_dim_mult)
            stride = s if n < cfg.n_layers else 1
            setattr(self, f"conv_{n}", nn.Conv2d(prev, ch, k, stride=stride, padding=pad, bias=False))
            setattr(self, f"bn_{n}", nn.BatchNorm2d(ch, eps=1e-5, track_running_stats=False))
            prev = ch
        self.conv_out = nn.Conv2d(prev, 1, k, stride=1, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, d_in) -> (B, H', W', 1) patch logits."""
        slope = self.cfg.leaky_relu_neg_slope
        y = F.leaky_relu(self.conv_0(x.permute(0, 3, 1, 2)), slope)
        for n in range(1, self.cfg.n_layers + 1):
            y = getattr(self, f"bn_{n}")(getattr(self, f"conv_{n}")(y))
            y = F.leaky_relu(y, slope)
        return self.conv_out(y).permute(0, 2, 3, 1)
