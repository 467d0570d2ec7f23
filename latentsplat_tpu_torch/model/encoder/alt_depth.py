"""Alternative depth-distribution heads, off the main path (counterpart of
latentsplat_tpu/model/encoder/alt_depth.py): a softmax QK-attention
distribution over keys and a depth predictor that samples (or takes the
argmax of) a bucket of it. The shipped experiments use the monocular depth
predictor instead; these keep the same ablation surface. Submodule names
follow the flax tree, so `weights.params_from_jax` maps its parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.distributions import sample_discrete_distribution


class AttentionDistribution(nn.Module):
    """Softmax QK attention as a discrete distribution over keys."""

    def __init__(self, d_query: int, d_key: int, dim_inner: int = 64):
        super().__init__()
        self.dim_inner = dim_inner
        self.to_q = nn.Linear(d_query, dim_inner, bias=False)
        self.to_k = nn.Linear(d_key, dim_inner, bias=False)

    def forward(
        self,
        queries: torch.Tensor,                            # (b, q, d_query)
        keys: torch.Tensor,                               # (b, k, d_key)
        force_last_token: Optional[torch.Tensor] = None,  # (b,) bool
    ) -> torch.Tensor:                                    # (b, q, k)
        q, k = self.to_q(queries), self.to_k(keys)
        weights = torch.softmax(torch.einsum("bqd,bkd->bqk", q, k) * self.dim_inner**-0.5, dim=-1)
        if force_last_token is None:
            return weights
        last = torch.zeros(keys.shape[1], dtype=weights.dtype, device=weights.device)
        last[-1] = 1.0
        return torch.where(force_last_token[:, None, None], last, weights)


class DistributionDepthPredictor(nn.Module):
    """Depth from an attention distribution over per-sample tokens: a bucket
    sampled by inverse CDF (or the argmax when deterministic), then that
    bucket's candidate depth and its probability."""

    def __init__(self, d_query: int, d_key: int, dim_inner: int = 64):
        super().__init__()
        self.distribution = AttentionDistribution(d_query, d_key, dim_inner)

    def forward(
        self,
        queries: torch.Tensor,           # (b, q, d_query) per-ray tokens
        keys: torch.Tensor,              # (b, k, d_key) per-sample tokens
        candidate_depths: torch.Tensor,  # (b, q, k)
        deterministic: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,   # (b * q, 1) uniforms in [0, 1)
    ) -> tuple[torch.Tensor, torch.Tensor]:
        pdf = self.distribution(queries, keys)
        b, q, k = pdf.shape
        flat = pdf.reshape(b * q, k)
        if deterministic:
            index = flat.argmax(dim=-1)
            density = torch.gather(flat, -1, index[:, None])[:, 0]
        else:
            index, density = sample_discrete_distribution(flat, 1, generator, noise)
            index, density = index.reshape(-1), density.reshape(-1)
        depth = torch.gather(candidate_depths.reshape(b * q, k), -1, index[:, None])[:, 0]
        return depth.reshape(b, q), density.reshape(b, q)
