"""DINO ViT backbone (counterpart of DinoViT and BackboneDino in
latentsplat_tpu/model/encoder/backbone.py). NHWC in, NHWC out.

Submodule names follow the JAX parameter tree (block_i, LayerNorm_0,
MultiHeadDotProductAttention_0, Dense_i, ...). The ResNet, ViT and ensemble
backbones are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import torch
import torch.nn.functional as F
from torch import nn

from ..transformer import LAYER_NORM_EPS, attention

_VIT_SPECS = {
    # (patch, dim, depth, heads)
    "dino_vits16": (16, 384, 12, 6),
    "dino_vits8": (8, 384, 12, 6),
    "dino_vitb16": (16, 768, 12, 12),
    "dino_vitb8": (8, 768, 12, 12),
}


@dataclass
class BackboneDinoCfg:
    name: str = "dino"
    model: str = "dino_vitb8"
    upscale_mode: str = "repeat"


def get_integer(value) -> int:
    value = Fraction(value)
    assert value.denominator == 1, f"{value} is not an integer"
    return int(value)


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape

        def split_heads(t):
            return t.reshape(b, n, self.heads, d // self.heads).transpose(1, 2)

        y = attention(split_heads(self.query(x)), split_heads(self.key(x)),
                      split_heads(self.value(x)))
        return self.out(y.transpose(1, 2).reshape(b, n, d))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, heads)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.Dense_0 = nn.Linear(dim, dim * 4)
        self.Dense_1 = nn.Linear(dim * 4, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        return x + self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x))))


class DinoViT(nn.Module):
    """DINO ViT trunk returning the full token sequence (cls + patches)."""

    def __init__(self, patch_size: int, dim: int, depth: int, heads: int):
        super().__init__()
        self.patch_size = patch_size
        self.base = 224 // patch_size
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.base**2 + 1, dim))
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block_{i}", ViTBlock(dim, heads))
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        tokens = self.patch_embed(x.permute(0, 3, 1, 2))       # (b, dim, nh, nw)
        nh, nw = tokens.shape[-2:]
        tokens = tokens.flatten(2).transpose(1, 2)
        dim = tokens.shape[-1]

        cls_pos, patch_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (nh, nw) != (self.base, self.base):
            # DINO's interpolate_pos_encoding, including its +0.1 scale fudge.
            grid = patch_pos.reshape(1, self.base, self.base, dim).permute(0, 3, 1, 2)
            grid = F.interpolate(
                grid, scale_factor=((nh + 0.1) / self.base, (nw + 0.1) / self.base),
                mode="bicubic", align_corners=False,
            )
            patch_pos = grid.permute(0, 2, 3, 1).reshape(1, nh * nw, dim)

        cls = (self.cls_token + cls_pos).expand(b, 1, dim)
        tokens = torch.cat([cls, tokens + patch_pos], dim=1)
        for i in range(self.depth):
            tokens = getattr(self, f"block_{i}")(tokens)
        return self.LayerNorm_0(tokens)


class BackboneDino(nn.Module):
    """(B, H, W, 3) -> (B, H*sf, W*sf, d_out): local token MLP upscaled and
    added to the global (cls) token MLP."""

    def __init__(self, cfg: BackboneDinoCfg, d_in: int, d_out: int, scale_factor: Fraction):
        super().__init__()
        assert d_in == 3
        patch, dim, depth, heads = _VIT_SPECS[cfg.model]
        self.cfg = cfg
        self.patch = patch
        self.d_out = d_out
        self.scale_factor = scale_factor
        self.dino = DinoViT(patch, dim, depth, heads)
        # global_mlp = Dense_0 -> relu -> Dense_1; local_mlp = Dense_2 -> relu -> Dense_3.
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, d_out)
        self.Dense_2 = nn.Linear(dim, dim)
        self.Dense_3 = nn.Linear(dim, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        assert h % self.patch == 0 and w % self.patch == 0
        tokens = self.dino(x)
        global_token = self.Dense_1(F.relu(self.Dense_0(tokens[:, 0])))
        local = self.Dense_3(F.relu(self.Dense_2(tokens[:, 1:])))
        local = local.reshape(b, h // self.patch, w // self.patch, self.d_out)
        if self.cfg.upscale_mode == "repeat":
            reps = get_integer(self.scale_factor * self.patch)
            local = local.repeat_interleave(reps, dim=1).repeat_interleave(reps, dim=2)
        elif self.cfg.upscale_mode == "interpolate":
            out_hw = (get_integer(self.scale_factor * h), get_integer(self.scale_factor * w))
            local = F.interpolate(
                local.permute(0, 3, 1, 2), size=out_hw, mode="bilinear", align_corners=True
            ).permute(0, 2, 3, 1)
        else:
            raise ValueError(f"unknown upscale_mode {self.cfg.upscale_mode}")
        return local + global_token[:, None, None, :]


def get_backbone(cfg, d_in: int, d_out: int, scale_factor: Fraction) -> nn.Module:
    if cfg.name != "dino":
        raise NotImplementedError(f"backbone {cfg.name!r} is not ported yet")
    return BackboneDino(cfg, d_in, d_out, scale_factor)
