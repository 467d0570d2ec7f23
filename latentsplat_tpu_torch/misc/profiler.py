"""Device tracing (counterpart of latentsplat_tpu/misc/profiler.py).

`torch.profiler` in place of `jax.profiler`, with the same tag ergonomics
as the Benchmarker, so that both can bracket the same code:

    with trace(Path("outputs/trace")):
        with annotate("encoder"):
            gaussians = encoder(...)
        torch.cuda.synchronize()

`trace` records CPU activity, and CUDA activity when a card is present,
and writes one Chrome trace (`trace.json`, read by Perfetto or
chrome://tracing) into the directory; the profile is kept on the context
manager's value for `key_averages()`.
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextmanager
def trace(log_dir: Path):
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def annotate(name: str):
    """Name a region inside an active trace (a span around the operations
    dispatched within)."""
    return record_function(name)


def device_memory_profile(path: Path) -> None:
    """Dump the CUDA caching allocator's snapshot of the memory in use (a
    pickle of its segments and blocks that pytorch.org/memory_viz reads);
    raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device: it snapshots the card's allocator")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.memory._dump_snapshot(str(path))
