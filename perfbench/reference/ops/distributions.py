"""Diagonal Gaussians and discrete sampling (counterpart of
latentsplat_tpu/ops/distributions.py).

Every sampler takes either a `torch.Generator` or an explicit noise tensor,
so a caller can feed both packages the same random numbers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)
_LOG_TWO_PI = math.log(2.0 * math.pi)


def clamp_logvar(raw: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Straight-through clamp: forward values are clipped to [lo, hi], the
    gradient passes 1:1 outside the bounds. Infinite inputs take the plain
    clip (the straight-through form would give -inf + inf = NaN there)."""
    clipped = raw.clamp(lo, hi)
    straight_through = raw + (clipped - raw).detach()
    return torch.where(torch.isfinite(raw), straight_through, clipped)


def standard_normal(
    shape, like: torch.Tensor, generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if noise is not None:
        assert tuple(noise.shape) == tuple(shape), (noise.shape, shape)
        return noise.to(device=like.device, dtype=like.dtype)
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


@dataclass
class DiagonalGaussian:
    """Diagonal Gaussian over tensors of any shape; `logvar=None` is a
    degenerate (zero-variance) distribution."""

    mean: torch.Tensor
    logvar: Optional[torch.Tensor] = None
    logvar_interval: Tuple[float, float] = (-30.0, 20.0)

    def __post_init__(self):
        if self.logvar is not None:
            self.logvar = clamp_logvar(self.logvar, *self.logvar_interval)

    @classmethod
    def from_params(cls, params: torch.Tensor, dim: int = 0) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(params, 2, dim=dim)
        return cls(mean, logvar)

    def params(self, dim: int = 0) -> torch.Tensor:
        """Mean and logvar concatenated along `dim` (from_params' inverse)."""
        assert self.logvar is not None
        return torch.cat([self.mean, self.logvar], dim=dim)

    @property
    def std(self):
        return 0.0 if self.logvar is None else torch.exp(0.5 * self.logvar)

    def sample(
        self, generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self.logvar is None:
            return self.mean
        eps = standard_normal(self.mean.shape, self.mean, generator, noise)
        return self.mean + self.std * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """Elementwise KL divergence from N(0, 1)."""
        if self.logvar is None:
            return torch.zeros_like(self.mean)
        return 0.5 * (self.mean**2 + torch.exp(self.logvar) - 1.0 - self.logvar)


def sample_discrete_distribution(
    pdf: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    eps: float = _F32_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse-CDF multinomial sampling: pdf (*batch, bucket) unnormalized ->
    (index (*batch, sample) int64, density (*batch, sample)). `noise` holds
    the uniform samples in [0, 1) of shape (*batch, sample)."""
    *batch, bucket = pdf.shape
    normalized_pdf = pdf / (eps + pdf.sum(dim=-1, keepdim=True))
    cdf = normalized_pdf.cumsum(dim=-1)
    shape = (*batch, num_samples)
    if noise is not None:
        assert tuple(noise.shape) == shape, (noise.shape, shape)
        samples = noise.to(device=pdf.device, dtype=pdf.dtype)
    else:
        samples = torch.rand(shape, generator=generator, device=pdf.device, dtype=pdf.dtype)
    index = (cdf[..., None, :] <= samples[..., :, None]).sum(dim=-1)
    index = index.clamp(max=bucket - 1)
    density = torch.gather(normalized_pdf, -1, index)
    return index, density


def gather_discrete_topk(
    pdf: torch.Tensor, num_samples: int, eps: float = _F32_EPS
) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic top-k buckets and their normalized densities."""
    normalized_pdf = pdf / (eps + pdf.sum(dim=-1, keepdim=True))
    index = pdf.topk(num_samples, dim=-1).indices
    density = torch.gather(normalized_pdf, -1, index)
    return index, density
