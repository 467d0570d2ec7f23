"""The 90th percentile of the traced window's request latencies, issue to
images on the host, in ms. A per-layer metric and not an end-to-end one:
the card sits idle for more than half of this cell's window (PERF.md), so
the tail follows the host's noise."""


def read(summary: dict):
    value = summary.get("latency_p90_s")
    return value * 1e3 if value else None
