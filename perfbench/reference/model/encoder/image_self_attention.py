"""Patchwise image self-attention (counterpart of
latentsplat_tpu/model/encoder/image_self_attention.py): patch-embed conv +
2D positional encoding -> self-attention transformer -> conv-transpose back
to pixel resolution. NHWC in and out."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...geometry import sample_image_grid
from ..encodings import positional_encoding
from ..transformer import Transformer


@dataclass
class ImageSelfAttentionCfg:
    patch_size: int
    num_octaves: int
    num_layers: int
    num_heads: int
    d_token: int
    d_dot: int
    d_mlp: int


class ImageSelfAttention(nn.Module):
    def __init__(self, cfg: ImageSelfAttentionCfg, d_in: int, d_out: int):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_embed = nn.Conv2d(d_in, cfg.d_token, p, stride=p)
        self.pe_proj = nn.Linear(2 * cfg.num_octaves * 2, cfg.d_token)
        self.transformer = Transformer(
            cfg.d_token, cfg.num_layers, cfg.num_heads, cfg.d_dot, cfg.d_mlp
        )
        self.resampler = nn.ConvTranspose2d(cfg.d_token, d_out, p, stride=p)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, d_in) -> (B, H, W, d_out)."""
        tokens = F.relu(self.patch_embed(image.permute(0, 3, 1, 2)))
        b, d, nh, nw = tokens.shape
        xy, _ = sample_image_grid((nh, nw), image.device)
        pe = self.pe_proj(positional_encoding(xy, self.cfg.num_octaves))   # (nh, nw, d)
        tokens = tokens.permute(0, 2, 3, 1) + pe[None]
        tokens = self.transformer(tokens.reshape(b, nh * nw, d))
        tokens = tokens.reshape(b, nh, nw, d).permute(0, 3, 1, 2)
        return self.resampler(tokens).permute(0, 2, 3, 1)
