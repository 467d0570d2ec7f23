"""Host milliseconds a request spends inside the program's `encoder` span.
Read beside `encoder_ms.serve` (the device's busy time there): a host time
at or above it means the encoder is bound by its launches."""

from perfbench import spans


def read(summary: dict):
    return spans.per_unit(summary, "render_full", "encoder", "host_ms")
