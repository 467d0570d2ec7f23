"""Device milliseconds a step spends in the program's `generator_update`
span (training/optim.py: per-group clip and Adam over every leaf)."""


def read(summary: dict):
    value = summary.get("unit_device_s", {}).get("generator_update")
    return value * 1e3 if value else None
