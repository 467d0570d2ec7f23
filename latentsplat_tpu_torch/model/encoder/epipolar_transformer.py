"""Epipolar cross-attention transformer (counterpart of
latentsplat_tpu/model/encoder/epipolar_transformer.py): conv downscale ->
epipolar samples + depth positional encoding as keys/values -> cross
attention with a ConvFeedForward -> conv-transpose upscale and refine."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...geometry import depth_to_relative_disparity, get_depth
from ...misc.heterogeneous_pairings import generate_heterogeneous_index
from ...misc.profiler import host_read
from ..encodings import positional_encoding
from ..transformer import Transformer
from .epipolar_sampler import EpipolarSampling, sample_epipolar_features
from .image_self_attention import ImageSelfAttention, ImageSelfAttentionCfg


@dataclass
class EpipolarTransformerCfg:
    self_attention: ImageSelfAttentionCfg
    num_octaves: int
    num_layers: int
    num_heads: int
    num_samples: int
    d_dot: int
    d_mlp: int
    downscale: int


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvFeedForward(nn.Module):
    """ImageSelfAttention + 7x7 convs acting on the image grid."""

    def __init__(self, cfg: ImageSelfAttentionCfg, d_in: int, d_hidden: int):
        super().__init__()
        self.self_attention = ImageSelfAttention(cfg, d_in, d_in)
        self.Conv_0 = nn.Conv2d(d_in, d_hidden, 7, padding=3)
        self.Conv_1 = nn.Conv2d(d_hidden, d_in, 7, padding=3)

    def forward(self, x: torch.Tensor, b: int, v: int, h: int, w: int) -> torch.Tensor:
        c = x.shape[-1]
        grid = x.reshape(b * v, h, w, c)
        y = grid + self.self_attention(grid)
        y = _conv_nhwc(self.Conv_1, F.gelu(_conv_nhwc(self.Conv_0, y)))
        return y.reshape(b * v * h * w, 1, c)


class EpipolarTransformer(nn.Module):
    def __init__(self, cfg: EpipolarTransformerCfg, d_in: int):
        super().__init__()
        self.cfg = cfg
        self.d_in = d_in
        ds = cfg.downscale
        if ds > 1:
            self.downscaler = nn.Conv2d(d_in, d_in, ds, stride=ds)
            self.upscaler = nn.ConvTranspose2d(d_in, d_in, ds, stride=ds)
            self.refine_0 = nn.Conv2d(d_in, d_in * 2, 7, padding=3)
            self.refine_1 = nn.Conv2d(d_in * 2, d_in, 7, padding=3)
        if cfg.num_octaves > 0:
            self.depth_encoding = nn.Linear(cfg.num_octaves * 2, d_in)
        self.transformer = Transformer(
            d_in, cfg.num_layers, cfg.num_heads, cfg.d_dot, cfg.d_mlp, kv_dim=d_in,
            feed_forward_factory=lambda: ConvFeedForward(cfg.self_attention, d_in, cfg.d_mlp),
        )

    def forward(self, features, extrinsics, intrinsics, near, far):
        """features (b, v, h, w, c) -> (features, EpipolarSampling)."""
        c = self.cfg
        b, v, h0, w0, d = features.shape
        if c.downscale > 1:
            features = _conv_nhwc(self.downscaler, features.reshape(b * v, h0, w0, d))
            features = features.reshape(b, v, *features.shape[1:])
        h, w = features.shape[2:4]

        sampling = sample_epipolar_features(
            features, extrinsics, intrinsics, near, far, c.num_samples
        )
        q = sampling.features
        if c.num_octaves > 0:
            _, index_v = generate_heterogeneous_index(v)
            with host_read("epipolar_index"):
                index_v = torch.as_tensor(index_v, device=features.device)
            depths = get_depth(
                sampling.origins[:, :, None, :, None],
                sampling.directions[:, :, None, :, None],
                sampling.xy_sample,
                extrinsics[:, index_v][:, :, :, None, None],
                intrinsics[:, index_v][:, :, :, None, None],
            )
            near_b = near[:, :, None, None, None]
            far_b = far[:, :, None, None, None]
            depths = torch.minimum(torch.maximum(depths, near_b), far_b)
            depths = depth_to_relative_disparity(depths, near_b, far_b)
            q = q + self.depth_encoding(positional_encoding(depths[..., None], c.num_octaves))

        ov, s = q.shape[2], q.shape[4]
        kv = q.permute(0, 1, 3, 2, 4, 5).reshape(b * v * h * w, ov * s, d)
        x = features.reshape(b * v * h * w, 1, d)
        x = self.transformer(x, z=kv, b=b, v=v, h=h, w=w)
        features = x.reshape(b, v, h, w, d)

        if c.downscale > 1:
            y = _conv_nhwc(self.upscaler, features.reshape(b * v, h, w, d))
            r = _conv_nhwc(self.refine_1, F.gelu(_conv_nhwc(self.refine_0, y)))
            features = (r + y).reshape(b, v, h0, w0, d)
        return features, sampling
