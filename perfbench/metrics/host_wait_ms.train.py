"""Host milliseconds a step spends in the calls at which the program's host
waits for the device: the host time inside its `host_read.<site>` spans
(misc/profiler.py)."""

from perfbench import spans


def read(summary: dict):
    return spans.per_unit(summary, "train_step", "host_read.*", "host_ms")
