"""Command-line tools of the port (counterparts of latentsplat_tpu/scripts)."""

from __future__ import annotations

import torch


def resolve_device(device, program: str) -> torch.device:
    """`device` None means the card: a command exits with a message where
    there is none. Callers pass "cpu" to run on the CPU."""
    if device is None and not torch.cuda.is_available():
        raise SystemExit(f"{program}: no CUDA device found; call main(argv, device='cpu') to run on the CPU")
    return torch.device("cuda" if device is None else device)
