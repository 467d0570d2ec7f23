"""Milliseconds a request spends in the rasterizer's `render.sort` span
(ops/rasterize/tiled.py: `duplicate_with_keys` with its host read, and
`sort_pairs`): the span's interval on the stream, from the two CUDA events
the program records at its ends, idle time inside it included. Where the
host paces the region, it follows the host, not the device's work there."""

from perfbench import spans


def read(summary: dict):
    return spans.per_unit(summary, "render_full", "render.sort", "device_ms")
