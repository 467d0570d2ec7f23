"""Tagged wall-clock timers and peak device memory (counterpart of
latentsplat_tpu/misc/benchmarker.py): times collect into {tag: [seconds]}
and dump as benchmark.json, the peak memory of each CUDA device as
peak_memory.json.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List

import torch


def _on_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return any(_on_cuda(getattr(tree, f)) for f in tree.__dataclass_fields__)
    return False


class Benchmarker:
    def __init__(self):
        self.execution_times: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def time(self, tag: str, num_calls: int = 1):
        """Time the block; its seconds go to `tag` as `num_calls` equal
        shares. The block must wait for the device itself."""
        try:
            start_time = time.perf_counter()
            yield
        finally:
            end_time = time.perf_counter()
            for _ in range(num_calls):
                self.execution_times[tag].append((end_time - start_time) / num_calls)

    def time_fn(self, tag: str, fn, *args, num_calls: int = 1, **kwargs):
        """Run fn; when its outputs lie on CUDA, wait for the device so its
        time is included."""
        with self.time(tag, num_calls=num_calls):
            out = fn(*args, **kwargs)
            if _on_cuda(out):
                torch.cuda.synchronize()
        return out

    def dump(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        path.write_text(json.dumps(dict(self.execution_times)))

    def dump_memory(self, path: Path) -> None:
        """Peak bytes allocated on each CUDA device ({} without one)."""
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        stats = {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                stats[f"cuda:{i}"] = torch.cuda.max_memory_allocated(i)
        path.write_text(json.dumps(stats))

    def summarize(self) -> Dict[str, float]:
        return {tag: sum(times) / len(times) for tag, times in self.execution_times.items() if times}

    def clear_history(self) -> None:
        self.execution_times = defaultdict(list)
