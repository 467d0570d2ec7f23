"""Milliseconds a request spends in the rasterizer's `render.composite` span
(ops/rasterize/tiled.py::composite_tiled: the attribute rows,
`composite_forward` and the background term): the span's interval on the
stream, from the two CUDA events the program records at its ends, idle
time inside it included. Where the host paces the region, it follows the
host, not the device's work there."""

from perfbench import spans


def read(summary: dict):
    return spans.per_unit(summary, "render_full", "render.composite", "device_ms")
