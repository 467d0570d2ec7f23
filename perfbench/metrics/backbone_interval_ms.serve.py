"""Milliseconds a request spends in the program's `encoder.backbone` span
(model/encoder/encoder_epipolar.py: the backbone and its projection): the
span's interval on the stream, from the two CUDA events the program
records at its ends, idle time inside it included. Where the host paces
the region, it follows the host, not the device's work there."""

from perfbench import spans


def read(summary: dict):
    return spans.per_unit(summary, "render_full", "encoder.backbone", "device_ms")
