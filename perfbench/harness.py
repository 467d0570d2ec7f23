"""What the serving and training cells share: the run's context, the
precision each side computes in, the traced window, and the comparison
that decides `correct`."""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace

# The traced run profiles at most this many seconds of its window: the
# per-layer metrics are per request or per step, and a longer trace only
# costs time to read.
TRACE_SECONDS = 10.0


@dataclass
class Ctx:
    """One run: the cell's files, the command line and the device."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float


@dataclass
class Outcome:
    """What a cell's run hands back to run.py."""

    attempted: int
    failed: int
    end_to_end: dict                 # name -> value
    compared: list                   # [name, value, limit]
    memory_peak_bytes: int
    summary: dict = field(default_factory=dict)   # the traced run's numbers for the per-layer readers


def stamp(ctx: Ctx, label: str) -> None:
    """A set-up milestone on standard error, seconds since process start."""
    print(f"perfbench: {label} at {time.perf_counter() - ctx.t_start:.3f} s", file=sys.stderr, flush=True)


def program_precision(config: dict) -> None:
    """The precision the configuration states, for the program."""
    p = config["precision"]
    torch.backends.cudnn.allow_tf32 = p["torch.backends.cudnn.allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = p["torch.backends.cuda.matmul.allow_tf32"]


def reference_precision() -> None:
    """The reference computes in float32 throughout: no TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def traced(ctx: Ctx, span_names, out: dict):
    """The measured window, under torch.profiler when the run traces; the
    trace's summary lands in `out`. Yields the program's `timer`."""
    if not ctx.trace:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            yield torch.profiler.record_function
        sync(ctx.device)
    with tempfile.TemporaryDirectory(prefix="perfbench_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        out.update(trace.summarize(json.loads(path.read_text()), span_names))


def window_seconds(ctx: Ctx) -> float:
    return min(ctx.seconds, TRACE_SECONDS) if ctx.trace else ctx.seconds


def view_gaps(value: torch.Tensor, reference: torch.Tensor, views: int, q: float) -> list:
    """Each view's q-quantile of |value - reference| over its elements,
    over the root mean square of the whole reference: the gap of most of a
    view's pixels, which a few pixels that sampled another depth bucket do
    not move, while one view gone wrong shows in its own. `reference` holds
    `views` equal rows; a view that `value` lacks reads as zeros."""
    ref = reference.double().reshape(views, -1)
    val = value.double().reshape(-1, ref.shape[1])
    if val.shape[0] < views:
        val = torch.cat([val, val.new_zeros(views - val.shape[0], ref.shape[1])])
    d = (val - ref).abs()
    k = max(1, min(d.shape[1], int(round(q * d.shape[1]))))
    rms = ref.pow(2).mean().sqrt().clamp(min=1e-30)
    return (d.kthvalue(k, dim=1).values / rms).tolist()


def limit(ctx: Ctx, name: str) -> float:
    return float(ctx.limits[name]["limit"])
