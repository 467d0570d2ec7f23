"""The calls of a request at which the program's host waits for the device:
its `host_read.<site>` spans (misc/profiler.py: the rasterizer's read of
the pair totals, and each copy of a host constant to the card, which waits
for the stream)."""

from perfbench import spans


def read(summary: dict):
    return spans.per_unit(summary, "render_full", "host_read.*", "count")
