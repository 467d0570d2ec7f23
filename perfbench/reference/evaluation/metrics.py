"""PSNR on NHWC images in [0, 1]."""

from __future__ import annotations

import torch


def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """(..., h, w, c) -> (...,) PSNR in dB over [0, 1] images."""
    ground_truth = ground_truth.clamp(0.0, 1.0)
    predicted = predicted.clamp(0.0, 1.0)
    mse = ((ground_truth - predicted) ** 2).mean(dim=(-3, -2, -1))
    return -10.0 * torch.log10(mse.clamp(min=1e-12))
