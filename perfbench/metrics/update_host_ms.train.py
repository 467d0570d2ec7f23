"""Host milliseconds a step spends inside the program's `generator_update`
span (training/optim.py: the per-group clip and the Adam loop's launches).
Read beside `update_ms.train` (the device's busy time there)."""

from perfbench import spans


def read(summary: dict):
    return spans.per_unit(summary, "train_step", "generator_update", "host_ms")
