"""Sinusoidal positional encoding (counterpart of
latentsplat_tpu/model/encodings.py): values in [0, 1], lowest frequency has
period 1, sin and cos phases interleaved per octave."""

from __future__ import annotations

import math

import torch

from ..misc.profiler import host_read


def positional_encoding(samples: torch.Tensor, num_octaves: int) -> torch.Tensor:
    """(..., d) -> (..., d * num_octaves * 2)."""
    octaves = torch.arange(num_octaves, dtype=torch.float32, device=samples.device)
    frequencies = 2.0 * math.pi * 2.0**octaves
    with host_read("positional_encoding"):
        phases = torch.tensor([0.0, 0.5 * math.pi], dtype=torch.float32, device=samples.device)
    angle = samples[..., None, None] * frequencies[:, None] + phases
    out = torch.sin(angle)
    return out.reshape(*samples.shape[:-1], samples.shape[-1] * num_octaves * 2)
