"""Device tracing and the program's spans (counterpart of
latentsplat_tpu/misc/profiler.py).

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

`span(name)` marks a region of the program. It is on exactly while a
torch.profiler session records (`trace` or any other); off, it returns one
shared no-op context manager after that single check. On, a span opens
`record_function(name)`, so that it sits in the Chrome trace on the clock
of the device's kernels, and keeps a `Span` record in memory: its id, its
parent's, its root's (the outermost span of the request or step, which
every span of it shares), its thread, its host interval and, where it
keeps one (`interval=True`), its interval on the current stream, read
lazily from two CUDA events (the host interval on a CPU run). The newest
RING records of all threads are kept in one ring; `records()` returns
them for readers. A thread's first span takes the span opened last on any
thread and still open as its parent, so that a recomputation under remat,
which runs on autograd's thread, sits under the step's backward.
`annotate` is `span`.

`host_read(site)` is a span named `host_read.<site>`, without a stream
interval, around each call on the served and training paths at which the
host waits for the device on a card: a read of device values (the
rasterizer's pair totals), or a copy of host values to the device, which
torch follows with a wait for the stream when the values lie in pageable
memory (a constant made with `torch.tensor(..., device=)`).
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# Spans the ring keeps: a traced window of ~100 requests of ~40 spans fits
# many times over, and a long traced session cannot grow unbounded.
RING = 1 << 16

_NOOP = nullcontext()
_ids = itertools.count(1)
_local = threading.local()      # .stack: the thread's open spans
_ring: deque = deque(maxlen=RING)
_last: Optional["Span"] = None  # the span opened last on any thread


class Span:
    """One span's record. `device_ms` is the span's interval on its stream
    (CUDA events, resolved when first read; on the CPU it is `host_ms`), or
    None where the span keeps no interval."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns", "end_ns", "_events", "_device_ms",
                 "_on_host")

    def __init__(self, name: str, parent: Optional["Span"], interval: bool):
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.thread = threading.get_ident()
        self.start_ns = time.perf_counter_ns()
        self.end_ns = None
        self._events = None
        self._device_ms = None
        self._on_host = False
        if interval and torch.cuda.is_available() and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        else:
            self._on_host = interval

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        if self._on_host:
            return self.host_ms
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


class _Open:
    """An open span: record_function, the record, and the caller's timer."""

    __slots__ = ("name", "timer", "interval", "_function", "_timed", "_span", "_parent")

    def __init__(self, name: str, timer, interval: bool):
        self.name, self.timer, self.interval = name, timer, interval

    def __enter__(self):
        global _last
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self._parent = stack[-1]
        else:
            self._parent = _last if _last is not None and _last.end_ns is None else None
        self._function = record_function(self.name)
        self._function.__enter__()
        self._span = _last = Span(self.name, self._parent, self.interval)
        stack.append(self._span)
        _ring.append(self._span)
        self._timed = None
        if self.timer is not None:
            try:
                timed = self.timer(self.name)
                timed.__enter__()
            except BaseException:
                self.__exit__(*sys.exc_info())
                raise
            self._timed = timed
        return self._span

    def __exit__(self, *exc):
        global _last
        try:
            if self._timed is not None:
                self._timed.__exit__(*exc)
        finally:
            span = self._span
            if span._events is not None:
                span._events[1].record()
            span.end_ns = time.perf_counter_ns()
            _local.stack.pop()
            _last = self._parent
            self._function.__exit__(*exc)
        return False


def span(name: str, timer=None, interval: bool = True):
    """A region of the program named `name` (see the module's docstring);
    `interval=False` keeps no stream interval (no CUDA events). `timer`, a
    context-manager factory (a stage's caller's, such as a Benchmarker's),
    is entered with `name` inside the span, whether or not the span is on;
    `record_function` and `annotate` as timers are the span itself."""
    if timer is record_function or timer is annotate:
        timer = None
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP if timer is None else timer(name)
    return _Open(name, timer, interval)


def host_read(site: str):
    """The span `host_read.<site>` around a wait of the host for the device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Open(f"host_read.{site}", None, False)


def annotate(name: str):
    """Name a region inside an active trace: a `span`."""
    return span(name)


def records() -> list[Span]:
    """The closed spans the ring keeps (the newest RING opened), in the
    order they opened."""
    return [s for s in list(_ring) if s.end_ns is not None]


def clear() -> None:
    """Drop every kept span."""
    _ring.clear()


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


def device_memory_profile(path: Path) -> None:
    """Dump the CUDA caching allocator's snapshot of the memory in use (a
    pickle of its segments and blocks that pytorch.org/memory_viz reads);
    raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device: it snapshots the card's allocator")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.memory._dump_snapshot(str(path))
