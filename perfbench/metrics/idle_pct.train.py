"""Percent of the traced window in which no operation ran on the device:
100 (1 - the union of device events over the window / its length)."""


def read(summary: dict):
    if not summary.get("busy_s") or not summary.get("window_s"):
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
