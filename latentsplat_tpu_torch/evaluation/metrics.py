"""Image metrics on NHWC images in [0, 1] (counterpart of
latentsplat_tpu/evaluation/metrics.py), plain PyTorch on any device:

  * PSNR: both images clipped to [0, 1], -10 log10(mse) per image;
  * SSIM: the Gaussian-weighted SSIM of skimage's structural_similarity
    (window 11, sigma 1.5, data range 1, sample covariance NP / (NP - 1)),
    the 'valid' part of a separable filter, per channel, then averaged;
  * LPIPS through a perceptual network such as `loss.lpips.LPIPS`;
  * DISTS: `DISTSNet`, a VGG16 trunk with a 3x3 Hann L2 pooling, the raw
    image as stage 0, and per-channel texture and structure similarities
    weighted by alpha and beta.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """(..., h, w, c) -> (...,) PSNR in dB over [0, 1] images."""
    ground_truth = ground_truth.clamp(0.0, 1.0)
    predicted = predicted.clamp(0.0, 1.0)
    mse = ((ground_truth - predicted) ** 2).mean(dim=(-3, -2, -1))
    return -10.0 * torch.log10(mse.clamp(min=1e-12))


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def compute_ssim(
    ground_truth: torch.Tensor,
    predicted: torch.Tensor,
    win_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """(..., h, w, c) -> (...,) mean SSIM with skimage's gaussian_weights semantics."""
    batch_shape = ground_truth.shape[:-3]
    h, w, c = ground_truth.shape[-3:]

    def maps(x):   # every channel of every image becomes a (1, h, w) map
        return x.reshape(-1, h, w, c).permute(0, 3, 1, 2).reshape(-1, 1, h, w)

    gt, pr = maps(ground_truth), maps(predicted)
    kernel = _gaussian_kernel1d(sigma, (win_size - 1) // 2, gt.device)

    def filt(x):
        return F.conv2d(F.conv2d(x, kernel.view(1, 1, -1, 1)), kernel.view(1, 1, 1, -1))

    ux, uy = filt(gt), filt(pr)
    uxx, uyy, uxy = filt(gt * gt), filt(pr * pr), filt(gt * pr)
    cov_norm = win_size**2 / (win_size**2 - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return s.mean(dim=(-3, -2, -1)).reshape(*batch_shape, c).mean(dim=-1)


def compute_lpips(ground_truth: torch.Tensor, predicted: torch.Tensor, lpips_fn) -> torch.Tensor:
    """(..., h, w, c) -> (...,); `lpips_fn(a, b)` takes two (n, h, w, c) batches."""
    batch_shape = ground_truth.shape[:-3]
    gt = ground_truth.reshape(-1, *ground_truth.shape[-3:])
    pr = predicted.reshape(-1, *predicted.shape[-3:])
    return lpips_fn(gt, pr).reshape(batch_shape)


def compute_dists(ground_truth: torch.Tensor, predicted: torch.Tensor, dists_fn) -> torch.Tensor:
    """(..., h, w, c) -> (...,); `dists_fn(a, b)` takes two (n, h, w, c) batches."""
    batch_shape = ground_truth.shape[:-3]
    gt = ground_truth.reshape(-1, *ground_truth.shape[-3:])
    pr = predicted.reshape(-1, *predicted.shape[-3:])
    return dists_fn(gt, pr).reshape(batch_shape)


_VGG16_STAGES = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _l2_pool(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Energy-preserving pooling of NCHW `x`: sqrt of the 3x3 Hann-weighted
    mean of x^2, stride 2, padding 1."""
    c = x.shape[1]
    y = F.conv2d(x * x, window.expand(c, 1, 3, 3), stride=2, padding=1, groups=c)
    return torch.sqrt(y.clamp(min=1e-12))


class DISTSNet(nn.Module):
    """DISTS between two NHWC [0, 1] image batches: (n,). Convolutions are
    named conv_0 ... conv_12 as in the flax tree; `alpha` and `beta` hold
    one weight per channel of the six stages (3 + 64 + 128 + 256 + 512 + 512)."""

    def __init__(self):
        super().__init__()
        prev, index = 3, 0
        for n_convs, ch in _VGG16_STAGES:
            for _ in range(n_convs):
                setattr(self, f"conv_{index}", nn.Conv2d(prev, ch, 3, padding=1))
                prev, index = ch, index + 1
        self.channels = [3] + [ch for _, ch in _VGG16_STAGES]
        self.alpha = nn.Parameter(torch.full((sum(self.channels),), 0.1))
        self.beta = nn.Parameter(torch.full((sum(self.channels),), 0.1))
        hann = torch.tensor([0.5, 1.0, 0.5])
        window = torch.outer(hann, hann)
        self.register_buffer("window", (window / window.sum())[None, None], persistent=False)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN)[None, :, None, None], persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD)[None, :, None, None], persistent=False)

    def features(self, image: torch.Tensor) -> list[torch.Tensor]:
        """NCHW image -> the raw image and the 5 stages' outputs."""
        feats = [image]
        h = (image - self.mean) / self.std
        index = 0
        for stage, (n_convs, _) in enumerate(_VGG16_STAGES):
            if stage > 0:
                h = _l2_pool(h, self.window)
            for _ in range(n_convs):
                h = F.relu(getattr(self, f"conv_{index}")(h))
                index += 1
            feats.append(h)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.features(x.permute(0, 3, 1, 2))
        fy = self.features(y.permute(0, 3, 1, 2))
        norm = self.alpha.sum() + self.beta.sum()
        c1 = c2 = 1e-6
        dist1 = dist2 = 0.0
        offset = 0
        for k, ch in enumerate(self.channels):
            a = self.alpha[offset : offset + ch] / norm
            b = self.beta[offset : offset + ch] / norm
            offset += ch
            x_mean = fx[k].mean(dim=(2, 3))
            y_mean = fy[k].mean(dim=(2, 3))
            s1 = (2 * x_mean * y_mean + c1) / (x_mean**2 + y_mean**2 + c1)
            dist1 = dist1 + (a * s1).sum(dim=-1)
            # The centered covariance E[(x - mx)(y - my)]: E[xy] - mx my
            # cancels catastrophically on near-constant features.
            x_c = fx[k] - x_mean[:, :, None, None]
            y_c = fy[k] - y_mean[:, :, None, None]
            x_var = (x_c**2).mean(dim=(2, 3))
            y_var = (y_c**2).mean(dim=(2, 3))
            xy_cov = (x_c * y_c).mean(dim=(2, 3))
            s2 = (2 * xy_cov + c2) / (x_var + y_var + c2)
            dist2 = dist2 + (b * s2).sum(dim=-1)
        return 1.0 - (dist1 + dist2)
