"""Pix2Pix PatchGAN discriminator (counterpart of
latentsplat_tpu/model/discriminator/patch_gan.py). NHWC at the public call.

4x4 convolutions (stride 2 with padding 1 while downscaling), LeakyReLU 0.2
and train-mode BatchNorm: batch statistics with the biased variance, eps
1e-5, affine parameters, no running statistics (the discriminator only ever
runs in train mode). Submodule names follow the flax tree.

Under data parallelism (`parallel.mesh`) the BatchNorms take the global
batch's statistics, as the JAX package's do when XLA shards the batch:
`set_batch_norm_group` gives them the process group, and each call
all-reduces its per-channel count and sum, then the sum of squared
deviations from the global mean, through the differentiable
`torch.distributed.nn.functional.all_reduce`, so that gradients flow back
to every rank's activations. One process takes the same sums without the
all-reduce, so both round alike. Fakes and reals are separate calls, each
with its own statistics, as in the JAX step.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class BatchNormTrain(nn.BatchNorm2d):
    """Train-mode BatchNorm2d (see the module docstring): the mean, then
    the mean squared deviation from it, as the JAX package takes them, over
    this process's batch or, with `process_group` set, over its ranks'."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, track_running_stats=False)
        self.process_group: Optional[dist.ProcessGroup] = None

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        if self.process_group is None:
            return x
        from torch.distributed.nn.functional import all_reduce

        with warnings.catch_warnings():   # the one differentiable all_reduce, deprecated in newer torch
            warnings.simplefilter("ignore", FutureWarning)
            return all_reduce(x, group=self.process_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The statistics in float32 whatever the input's dtype (bfloat16 under
        # compute_dtype), as F.batch_norm takes them; the output in x's.
        dims = (0, 2, 3)
        x32 = x.float()
        count = x32.new_full((1,), x.numel() // x.shape[1])
        totals = self._sum(torch.cat([count, x32.sum(dim=dims)]))
        centered = x32 - (totals[1:] / totals[0])[None, :, None, None]
        var = self._sum(centered.square().sum(dim=dims)) / totals[0]
        y = centered / torch.sqrt(var + self.eps)[None, :, None, None]
        return (y * self.weight[None, :, None, None] + self.bias[None, :, None, None]).to(x.dtype)


def set_batch_norm_group(module: nn.Module, group: Optional[dist.ProcessGroup]) -> None:
    """Every BatchNormTrain of `module` takes its statistics over `group`'s
    ranks (None: over this process's batch)."""
    for m in module.modules():
        if isinstance(m, BatchNormTrain):
            m.process_group = group


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
            setattr(self, f"bn_{n}", BatchNormTrain(ch))
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
