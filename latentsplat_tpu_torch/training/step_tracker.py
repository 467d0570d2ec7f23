"""The global step, shared with data-loader workers (counterpart of
latentsplat_tpu/training/step_tracker.py).

Backed by a multiprocessing.Value from the forkserver context, so the view
samplers' curriculum sees the trainer's step in loader threads and in
forkserver worker processes alike: the shared segment and its lock pickle
through Process construction.
"""

from __future__ import annotations

import multiprocessing


class StepTracker:
    def __init__(self, step_offset: int = 0):
        self.step_offset = step_offset
        # The loader's start method: a lock from the default (fork) context
        # cannot be pickled into a forkserver child.
        self._value = multiprocessing.get_context("forkserver").Value("q", 0)

    def set_step(self, step: int) -> None:
        with self._value.get_lock():
            self._value.value = self.step_offset + step

    def get_step(self) -> int:
        with self._value.get_lock():
            return self._value.value
