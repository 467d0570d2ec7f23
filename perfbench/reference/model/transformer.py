"""Pre-norm transformer blocks (counterpart of
latentsplat_tpu/model/transformer.py).

Submodule names follow the JAX package's parameter tree (attn_i, norm_ff_i,
Dense_0, ...) so weights.params_from_jax maps parameters by path. Attention
is written out as softmax(q k^T / sqrt(d)) v.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# Flax's LayerNorm default epsilon.
LAYER_NORM_EPS = 1e-6


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attend: Optional[nn.Module] = None
) -> torch.Tensor:
    """(b, h, n, d) x (b, h, m, d) x (b, h, m, e) -> (b, h, n, e). `attend`
    is the module that takes the softmax over the keys (a hook on it sees
    the attention weights), or None."""
    dots = torch.einsum("bhid,bhjd->bhij", q, k) * q.shape[-1] ** -0.5
    weights = attend(dots) if attend is not None else dots.softmax(dim=-1)
    return torch.einsum("bhij,bhjd->bhid", weights, v)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, kv_dim: Optional[int] = None):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        if kv_dim is None:
            self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        else:
            self.to_q = nn.Linear(dim, inner, bias=False)
            self.to_kv = nn.Linear(kv_dim, inner * 2, bias=False)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.to_out = nn.Linear(inner, dim)
        self.attend = nn.Softmax(dim=-1)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        if z is None:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        else:
            q = self.to_q(x)
            k, v = self.to_kv(z).chunk(2, dim=-1)

        def split_heads(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        out = attention(split_heads(q), split_heads(k), split_heads(v), self.attend)
        out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
        return self.to_out(out) if self.project_out else out


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x)))


class Transformer(nn.Module):
    """Stack of pre-norm attention + feed-forward residual blocks.

    With `feed_forward_factory` the feed-forward modules are named
    `<Class>_i`, as flax auto-names modules built inside a compact call."""

    def __init__(
        self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
        kv_dim: Optional[int] = None,
        feed_forward_factory: Optional[Callable[[], nn.Module]] = None,
    ):
        super().__init__()
        self.depth = depth
        self.ff_names = []
        for i in range(depth):
            setattr(self, f"norm_attn_{i}", nn.LayerNorm(dim, eps=LAYER_NORM_EPS))
            setattr(self, f"attn_{i}", Attention(dim, heads, dim_head, kv_dim))
            setattr(self, f"norm_ff_{i}", nn.LayerNorm(dim, eps=LAYER_NORM_EPS))
            if feed_forward_factory is None:
                ff, name = FeedForward(dim, mlp_dim), f"ff_{i}"
            else:
                ff = feed_forward_factory()
                name = f"{type(ff).__name__}_{i}"
            setattr(self, name, ff)
            self.ff_names.append(name)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None, **ff_kwargs):
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(getattr(self, f"norm_attn_{i}")(x), z=z) + x
            ff_in = getattr(self, f"norm_ff_{i}")(x)
            x = getattr(self, self.ff_names[i])(ff_in, **ff_kwargs) + x
        return x
