"""The traced run's reading of a torch.profiler Chrome trace.

`self_times` is a frozen copy of latentsplat_tpu_torch/scripts/
bench_trace_step.py::self_times; `span_device_us` follows its
`trace_breakdown` (each device event belongs to the program span whose
host interval holds its launch, matched by correlation id);
`busy_and_gaps` follows scripts/trace_render.py::trace_summary (the union of device events over the window, the longest
gaps between them, each named by the host operators across its middle).
"""

from __future__ import annotations

import bisect
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "perfbench.window"
TOP = 10


def self_times(trace_json: dict, cats=DEVICE_CATS) -> dict:
    """{name: [self microseconds, count]} over the complete events of the
    categories `cats`: each event's duration less its children's on its
    track (pid, tid), names stripped of a trailing ".N"."""
    tracks: dict = {}
    for e in trace_json["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in cats:
            tracks.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out: dict = {}

    def close(frame):
        end, name, children, dur = frame
        row = out.setdefault(name, [0.0, 0])
        row[0] += dur - children
        row[1] += 1

    for events in tracks.values():
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: list = []
        for e in events:
            ts, dur = e["ts"], e.get("dur", 0.0)
            while stack and ts >= stack[-1][0]:
                frame = stack.pop()
                close(frame)
                if stack:
                    stack[-1][2] += frame[3]
            stack.append([ts + dur, re.sub(r"\.\d+$", "", e.get("name", "?")), 0.0, dur])
        while stack:
            frame = stack.pop()
            close(frame)
            if stack:
                stack[-1][2] += frame[3]
    return out


def span_device_us(events: list, device: list, span_names) -> dict:
    """{span name: device microseconds launched inside it}: each device
    event goes to the span of `span_names` whose host interval holds the
    launch with the event's correlation id."""
    spans = sorted((e for e in events if e.get("cat") == "user_annotation" and e.get("name") in span_names),
                   key=lambda e: e["ts"])
    starts = [s["ts"] for s in spans]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    out = {name: 0.0 for name in span_names}
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        # The program's stage spans follow one another; none holds another.
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i]["ts"] + spans[i]["dur"]:
            out[spans[i]["name"]] += e["dur"]
    return out


def _host_ops(host: list, a: float, b: float) -> str:
    mid = 0.5 * (a + b)
    holding = sorted((e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]), key=lambda e: e["dur"])
    if not holding:
        return "no host operator"
    inner, outer = holding[0]["name"], holding[-1]["name"]
    return inner if inner == outer else f"{inner} in {outer}"


def busy_and_gaps(events: list, device: list, start: float, end: float) -> tuple[float, list]:
    """(device-busy microseconds within [start, end], the TOP longest idle
    gaps there as [host operators across it, seconds])."""
    busy, gaps, cursor = 0.0, [], start
    for e in sorted(device, key=lambda e: e["ts"]):
        a, b = max(e["ts"], start), min(e["ts"] + e["dur"], end)
        if b <= a:
            continue
        if a > cursor:
            gaps.append((a - cursor, cursor))
        busy += max(0.0, b - max(cursor, a))
        cursor = max(cursor, b)
    if end > cursor:
        gaps.append((end - cursor, cursor))
    host = [e for e in events if e.get("cat") == "cpu_op"]
    top = [[_host_ops(host, a, a + dur), dur / 1e6] for dur, a in sorted(gaps, key=lambda g: -g[0])[:TOP]]
    return busy, top


def summarize(trace_json: dict, span_names) -> dict:
    """The traced window's numbers: window and busy seconds, device
    seconds per program span, the top device operations by self time and
    the longest idle gaps."""
    events = [e for e in trace_json["traceEvents"] if e.get("ph") == "X"]
    window = next(e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW_SPAN)
    start, end = window["ts"], window["ts"] + window["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS and start <= e["ts"] <= end]
    busy_us, gaps = busy_and_gaps(events, device, start, end)
    inside = {"traceEvents": device}
    ops = sorted(((name, us / 1e6) for name, (us, _) in self_times(inside).items()), key=lambda kv: -kv[1])
    return {
        "window_s": (end - start) / 1e6,
        "busy_s": busy_us / 1e6,
        "span_device_s": {k: v / 1e6 for k, v in span_device_us(events, device, span_names).items()},
        "breakdown": {"device_ops": [[n, s] for n, s in ops[:TOP]], "idle_gaps": gaps},
    }
