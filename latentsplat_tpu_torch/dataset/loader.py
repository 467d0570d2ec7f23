"""Host-side batching and background prefetch (counterpart of
latentsplat_tpu/dataset/loader.py).

A thread (or, for disk-backed datasets, forkserver worker processes)
collates numpy examples while the device runs the previous step. Batches
stay numpy; the trainer moves them to the device on its own thread.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import random
import threading
import warnings
from typing import Dict, Iterable, Iterator, Optional

import numpy as np


def collate(examples: list) -> Dict:
    """Stack a list of example dicts into a batched dict (leading axis b)."""

    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        if isinstance(first, str):
            return list(items)
        return np.stack([np.asarray(it) for it in items])

    return stack(examples)


def batch_iterator(
    dataset: Iterable, batch_size: int, drop_last: bool = True, repeat: bool = False,
) -> Iterator[Dict]:
    """Collated batches; with `repeat`, loops over the dataset forever."""
    while True:
        buf = []
        for example in dataset:
            buf.append(example)
            if len(buf) == batch_size:
                yield collate(buf)
                buf = []
        if buf and not drop_last:
            yield collate(buf)
        if not repeat:
            return


class PrefetchIterator:
    """Wrap an iterator with a daemon-thread prefetch queue."""

    _DONE = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None

        def worker():
            try:
                for item in iterator:
                    self._queue.put(item)
            except BaseException as e:  # handed to the consumer
                self._error = e
            finally:
                self._queue.put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def make_loader(
    dataset: Iterable,
    batch_size: int,
    *,
    repeat: bool = False,
    drop_last: bool = True,
    prefetch: int = 2,
    num_workers: int = 0,
    seed: int = 0,
    stage: str = "train",
) -> Iterator[Dict]:
    """num_workers > 0 starts that many loader processes; 0 keeps the
    in-process thread prefetch."""
    if num_workers > 0:
        return MultiprocessLoader(
            dataset, batch_size, num_workers=num_workers, repeat=repeat,
            drop_last=drop_last, seed=seed, stage=stage,
        )
    it = batch_iterator(dataset, batch_size, drop_last=drop_last, repeat=repeat)
    if prefetch > 0:
        return PrefetchIterator(it, depth=prefetch)
    return it


# -- worker processes ---------------------------------------------------------


def _compose_shard(dataset, worker_id: int, num_workers: int) -> None:
    """Compose worker sharding with any existing sharding: worker w of shard
    h reads the items i with i % (H * W) == h * W + w."""
    if hasattr(dataset, "num_shards"):
        base_idx = getattr(dataset, "shard_index", 0)
        base_n = getattr(dataset, "num_shards", 1)
        dataset.shard_index = base_idx * num_workers + worker_id
        dataset.num_shards = base_n * num_workers


def _worker_loop(dataset, batch_size, drop_last, repeat, seed, worker_id, num_workers, out_queue, stage):
    """A worker process: seed, shard (test stage), iterate, collate, push,
    and a None sentinel at the end. The dataset arrives pickled (forkserver),
    a StepTracker with it."""
    random.seed(seed + worker_id)
    np.random.seed((seed + worker_id) % (2**32))
    if hasattr(dataset, "rng"):
        dataset.rng = np.random.default_rng(seed + worker_id)
    if stage == "test":
        _compose_shard(dataset, worker_id, num_workers)

    try:
        while True:
            buf = []
            for example in dataset:
                buf.append(example)
                if len(buf) == batch_size:
                    out_queue.put(collate(buf))
                    buf = []
            if buf and not drop_last:
                out_queue.put(collate(buf))
            if not repeat:
                break
    finally:
        out_queue.put(None)


class MultiprocessLoader:
    """N worker processes put collated batches on one queue. Batch order
    across workers is not deterministic; within a worker it follows its
    seeded shuffle. In the train stage every worker walks the whole dataset
    with its own random stream; in the test stage the workers shard it.

    Workers start from the forkserver context, so they never inherit the
    parent's CUDA context or threads; the dataset must pickle."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        num_workers: int,
        repeat: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        stage: str = "train",
        prefetch_per_worker: int = 2,
        mp_context: str = "forkserver",
    ):
        ctx = mp.get_context(mp_context)
        self._queue = ctx.Queue(maxsize=max(2, prefetch_per_worker * num_workers))
        self._procs = [
            ctx.Process(
                target=_worker_loop,
                args=(dataset, batch_size, drop_last, repeat, seed, w, num_workers, self._queue, stage),
                daemon=True,
            )
            for w in range(num_workers)
        ]
        for p in self._procs:
            p.start()
        self._live = num_workers

    def __iter__(self):
        return self

    def __next__(self):
        while self._live > 0:
            try:
                item = self._queue.get(timeout=5.0)
            except queue.Empty:
                # A worker that died without its sentinel (a crash, an OOM
                # kill) must not hang the consumer: a dead worker adds nothing
                # beyond what is queued, so after one more drain the sentinels
                # above the count of live workers are lost.
                n_alive = sum(1 for p in self._procs if p.is_alive())
                if self._live <= n_alive:
                    continue
                try:
                    item = self._queue.get(timeout=1.0)
                except queue.Empty:
                    lost = self._live - n_alive
                    self._live = n_alive
                    warnings.warn(f"{lost} loader worker(s) died without a sentinel; continuing with the survivors")
                    continue
            if item is None:
                self._live -= 1
                continue
            return item
        raise StopIteration

    def close(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5)
