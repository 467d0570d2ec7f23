"""DINO ViT, ViT, ResNet and ensemble backbones (counterparts of
BackboneDino, BackboneVit, BackboneResnet and BackboneEnsemble in
latentsplat_tpu/model/encoder/backbone.py). NHWC in, NHWC out.

Submodule names follow the JAX parameter tree (block_i, LayerNorm_0,
MultiHeadDotProductAttention_0, Dense_i, BasicBlock_i, Conv_i,
component_i, ...). A list of backbone configs is an ensemble.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import List, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...misc.fraction_utils import get_integer
from ..transformer import LAYER_NORM_EPS, attention

_VIT_SPECS = {
    # (patch, dim, depth, heads)
    "dino_vits16": (16, 384, 12, 6),
    "dino_vits8": (8, 384, 12, 6),
    "dino_vitb16": (16, 768, 12, 12),
    "dino_vitb8": (8, 768, 12, 12),
}


_RESNET_SPECS = {
    # (block type, per-stage block counts, stage widths, embedding width)
    "resnet18": ("basic", (2, 2, 2, 2), (64, 128, 256, 512), 64),
    "resnet34": ("basic", (3, 4, 6, 3), (64, 128, 256, 512), 64),
    "resnet50": ("bottleneck", (3, 4, 6, 3), (256, 512, 1024, 2048), 64),
    "dino_resnet50": ("bottleneck", (3, 4, 6, 3), (256, 512, 1024, 2048), 64),
}


@dataclass
class BackboneDinoCfg:
    name: str = "dino"
    model: str = "dino_vitb8"
    upscale_mode: str = "repeat"


@dataclass
class BackboneVitCfg:
    """The DINO trunk with 768-wide token MLPs and `interpolate` upscaling
    by default."""

    name: str = "vit"
    model: str = "dino_vitb8"
    upscale_mode: str = "interpolate"


@dataclass
class BackboneResnetCfg:
    name: str = "resnet"
    model: str = "resnet50"
    num_layers: int = 4
    use_first_pool: bool = False


SingleBackboneCfg = Union[BackboneResnetCfg, BackboneDinoCfg, BackboneVitCfg]


@dataclass
class BackboneEnsembleCfg:
    name: str = "ensemble"
    components: List[SingleBackboneCfg] = field(default_factory=list)


BackboneCfg = Union[SingleBackboneCfg, BackboneEnsembleCfg, List[SingleBackboneCfg]]


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.attend = nn.Softmax(dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape

        def split_heads(t):
            return t.reshape(b, n, self.heads, d // self.heads).transpose(1, 2)

        y = attention(split_heads(self.query(x)), split_heads(self.key(x)),
                      split_heads(self.value(x)), self.attend)
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
    added to the global (cls) token MLP. The trunk is registered as `dino`
    (`vit` for BackboneVit) and the MLPs are `mlp_width` wide (None: the
    trunk's width)."""

    trunk_name = "dino"
    mlp_width = None

    def __init__(self, cfg, d_in: int, d_out: int, scale_factor: Fraction):
        super().__init__()
        assert d_in == 3
        patch, dim, depth, heads = _VIT_SPECS[cfg.model]
        self.cfg = cfg
        self.patch = patch
        self.d_out = d_out
        self.scale_factor = scale_factor
        setattr(self, self.trunk_name, DinoViT(patch, dim, depth, heads))
        hidden = self.mlp_width or dim
        # global_mlp = Dense_0 -> relu -> Dense_1; local_mlp = Dense_2 -> relu -> Dense_3.
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, d_out)
        self.Dense_2 = nn.Linear(dim, hidden)
        self.Dense_3 = nn.Linear(hidden, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        assert h % self.patch == 0 and w % self.patch == 0
        tokens = getattr(self, self.trunk_name)(x)
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


class BackboneVit(BackboneDino):
    """The same trunk, registered as `vit`, with 768-wide token MLPs
    whatever the model's width (as the JAX package and its reference)."""

    trunk_name = "vit"
    mlp_width = 768


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel spatial normalization (affine=False), NCHW."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class BasicBlock(nn.Module):
    def __init__(self, d_in: int, width: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(d_in, width, 3, stride=stride, padding=1, bias=False)
        self.Conv_1 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        if d_in != width or stride != 1:
            self.Conv_2 = nn.Conv2d(d_in, width, 1, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _instance_norm(self.Conv_1(F.relu(_instance_norm(self.Conv_0(x)))))
        residual = _instance_norm(self.Conv_2(x)) if hasattr(self, "Conv_2") else x
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    def __init__(self, d_in: int, width: int, stride: int = 1):
        super().__init__()
        inner = width // 4
        self.Conv_0 = nn.Conv2d(d_in, inner, 1, bias=False)
        self.Conv_1 = nn.Conv2d(inner, inner, 3, stride=stride, padding=1, bias=False)
        self.Conv_2 = nn.Conv2d(inner, width, 1, bias=False)
        if d_in != width or stride != 1:
            self.Conv_3 = nn.Conv2d(d_in, width, 1, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_instance_norm(self.Conv_0(x)))
        y = F.relu(_instance_norm(self.Conv_1(y)))
        y = _instance_norm(self.Conv_2(y))
        residual = _instance_norm(self.Conv_3(x)) if hasattr(self, "Conv_3") else x
        return F.relu(y + residual)


class BackboneResnet(nn.Module):
    """(B, H, W, d_in) -> (B, H*sf, W*sf, d_out): per-stage 1x1 projections,
    resized bilinearly with align_corners=True and summed. InstanceNorm
    without affine parameters stands in for BatchNorm, as in the JAX package."""

    def __init__(self, cfg: BackboneResnetCfg, d_in: int, d_out: int, scale_factor: Fraction):
        super().__init__()
        kind, depths, widths, embed = _RESNET_SPECS[cfg.model]
        block_cls = BasicBlock if kind == "basic" else BottleneckBlock
        self.cfg = cfg
        self.scale_factor = scale_factor
        self.Conv_0 = nn.Conv2d(d_in, embed, 7, stride=2, padding=3, bias=False)
        self.proj_stem = nn.Conv2d(embed, d_out, 1)
        self.blocks = []
        prev, index = embed, 0
        for i in range(cfg.num_layers):
            for b in range(depths[i]):
                name = f"{block_cls.__name__}_{index}"
                setattr(self, name, block_cls(prev, widths[i], (1 if i == 0 else 2) if b == 0 else 1))
                self.blocks.append((i, name))
                prev, index = widths[i], index + 1
            setattr(self, f"proj_{i}", nn.Conv2d(prev, d_out, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        out_hw = (get_integer(self.scale_factor * h), get_integer(self.scale_factor * w))

        def project(name, y):
            y = getattr(self, name)(y)
            if tuple(y.shape[-2:]) == out_hw:
                return y
            return F.interpolate(y, size=out_hw, mode="bilinear", align_corners=True)

        y = F.relu(_instance_norm(self.Conv_0(x.permute(0, 3, 1, 2))))
        if self.cfg.use_first_pool:
            y = F.max_pool2d(y, 3, stride=2, padding=1)
        total = project("proj_stem", y)
        for i in range(self.cfg.num_layers):
            for stage, name in self.blocks:
                if stage == i:
                    y = getattr(self, name)(y)
            total = total + project(f"proj_{i}", y)
        return total.permute(0, 2, 3, 1)


class BackboneEnsemble(nn.Module):
    """The sum of its components' outputs."""

    def __init__(self, cfg: BackboneEnsembleCfg, d_in: int, d_out: int, scale_factor: Fraction):
        super().__init__()
        self.components = len(cfg.components)
        for i, sub in enumerate(cfg.components):
            setattr(self, f"component_{i}", get_backbone(sub, d_in, d_out, scale_factor))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sum(getattr(self, f"component_{i}")(x) for i in range(self.components))


_BACKBONES = {
    "resnet": BackboneResnet,
    "dino": BackboneDino,
    "vit": BackboneVit,
    "ensemble": BackboneEnsemble,
}


def get_backbone(cfg: BackboneCfg, d_in: int, d_out: int, scale_factor: Fraction) -> nn.Module:
    if isinstance(cfg, list):
        cfg = BackboneEnsembleCfg(components=cfg)
    return _BACKBONES[cfg.name](cfg, d_in, d_out, scale_factor)
