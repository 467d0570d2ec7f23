"""Antialiased bilinear resize (counterpart of latentsplat_tpu/ops/resize.py):
the separable triangle filter as two dense (out x in) sampling matrices.
For downscaling the filter support stretches by the scale ratio."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..misc.profiler import host_read


@lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Row-stochastic (out, in) triangle-filter sampling matrix."""
    ratio = in_size / out_size
    support = max(1.0, ratio)
    centers = (np.arange(out_size) + 0.5) * ratio - 0.5
    idx = np.arange(in_size)
    dist = np.abs(idx[None, :] - centers[:, None]) / support
    weights = np.clip(1.0 - dist, 0.0, None)
    weights /= weights.sum(axis=1, keepdims=True)
    return weights.astype(np.float32)


def resize_antialias(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize (..., H, W, C) images to (..., out_h, out_w, C)."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == tuple(out_hw):
        return x
    with host_read("resize_matrix"):
        m_h = torch.from_numpy(_resize_matrix(h, out_hw[0])).to(x.device)
        m_w = torch.from_numpy(_resize_matrix(w, out_hw[1])).to(x.device)
    x = torch.einsum("oh,...hwc->...owc", m_h, x)
    return torch.einsum("ow,...hwc->...hoc", m_w, x)
