"""LPIPS perceptual distance on a VGG16 written by hand (counterpart of
latentsplat_tpu/loss/lpips.py). NHWC at the public call.

The input is mapped from [0, 1] to [-1, 1] and through the LPIPS shift and
scale; VGG16 features are tapped after each of the 5 conv stages (3x3
convolutions, ReLU, 2x2 max-pool between stages), unit-normalized over
channels (eps 1e-10 added to the norm), and their squared differences are
weighted by 1x1 lin heads without bias, averaged over space and summed over
stages. Submodule names follow the flax tree (vgg.conv_i, lin_i).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_VGG16_STAGES = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]


class Vgg16Features(nn.Module):
    def __init__(self):
        super().__init__()
        prev, index = 3, 0
        for n_convs, ch in _VGG16_STAGES:
            for _ in range(n_convs):
                setattr(self, f"conv_{index}", nn.Conv2d(prev, ch, 3, padding=1))
                prev, index = ch, index + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NCHW image -> the 5 stage outputs (NCHW)."""
        feats, index = [], 0
        for stage, (n_convs, _) in enumerate(_VGG16_STAGES):
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"conv_{index}")(x))
                index += 1
            feats.append(x)
            if stage < len(_VGG16_STAGES) - 1:
                x = F.max_pool2d(x, 2, stride=2)
        return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x**2).sum(dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Perceptual distance between two [0, 1] NHWC image batches: (B,)."""

    def __init__(self):
        super().__init__()
        self.vgg = Vgg16Features()
        for i, (_, ch) in enumerate(_VGG16_STAGES):
            setattr(self, f"lin_{i}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None], persistent=False)

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        b = pred.shape[0]
        images = torch.cat([pred, target]).permute(0, 3, 1, 2)
        feats = self.vgg(((2.0 * images - 1.0) - self.shift) / self.scale)
        total = 0.0
        for i, f in enumerate(feats):
            diff = (_unit_normalize(f[:b]) - _unit_normalize(f[b:])) ** 2
            total = total + getattr(self, f"lin_{i}")(diff).mean(dim=(1, 2, 3))
        return total
