"""A profiler trace of one train step, its time by kernel (the port's
counterpart of the repository's root bench_trace_step.py and
tools_parse_trace.py):

    python -m latentsplat_tpu_torch.scripts.bench_trace_step [--top 10] [--out DIR]

The flagship VAE-GAN step at the `bench_train --full --batch 2` shape
(256x256, batch 2, 2 + 4 views, model.remat with the policy
vae:off,lpips:off and model.decoder.remat, the whole objective live; weights
from seed 0) runs twice to warm up, then once under `misc.profiler.trace`
with its stages annotated. From the Chrome trace: each device event's self
time (its duration less its children's on the same track, as
tools_parse_trace.py takes it; on the CPU, where there is no device, the
CPU operators'), summed by name, and the top N printed beside the wall
time; then `trace_breakdown`'s lines per stage. The trace stays in --out
when given. The command line runs on the card; `main(argv, device="cpu")`
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..misc.profiler import annotate, trace
from . import resolve_device
from .measure import OBJECTIVE, device_name, sync, train_setup

SIZE, BATCH = 256, 2
TOP = 10
OVERRIDES = ["model.remat_policy=vae:off,lpips:off", "model.remat=true", "model.decoder.remat=true", *OBJECTIVE]
# Device activity in a Chrome trace of torch.profiler; on the CPU, its
# operators stand in.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RASTER_KERNELS = ("duplicate_with_keys", "composite_forward", "composite_backward", "reduce_pairs", "RadixSort")


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


def trace_breakdown(trace_json: dict) -> list[str]:
    """Per stage marked with record_function: the device work it launched
    (each kernel, copy or fill goes to the stage whose host span holds its
    launch, matched by correlation id), its device span from first start
    to last end, the busy share of that span, and the top kernels; then
    the rasterizer's kernels' share of the device's busy time."""
    events = [e for e in trace_json["traceEvents"] if e.get("ph") == "X"]
    stages = [e for e in events if e.get("cat") == "user_annotation"]
    launch_ts = {
        e["args"]["correlation"]: e["ts"] for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
    }
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    per_stage: dict[str, list[dict]] = {}
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        owner = next((s["name"] for s in stages if ts is not None and s["ts"] <= ts <= s["ts"] + s["dur"]),
                     "(outside the stages)")
        per_stage.setdefault(owner, []).append(e)
    lines = []
    for name, items in list(per_stage.items()) + [("all", device)]:
        if not items:
            continue
        busy_us = sum(e["dur"] for e in items)
        span_us = max(e["ts"] + e["dur"] for e in items) - min(e["ts"] for e in items)
        by_name: dict[str, float] = {}
        for e in items:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        lines.append(
            f"{name}: device span {span_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
            f"({busy_us / max(span_us, 1e-9):.0%}), {len(items)} launches; top: "
            + "; ".join(f"{k[:70]} {v / 1e3:.3f}" for k, v in top)
        )
    raster: dict[str, list[float]] = {}
    for e in device:
        name = next((k for k in RASTER_KERNELS if k in e["name"]), None)
        if name:
            raster.setdefault(name, []).append(e["dur"])
    busy_us = sum(e["dur"] for e in device)
    raster_us = sum(sum(v) for v in raster.values())
    lines.append(
        f"rasterizer kernels: {raster_us / 1e3:.3f} ms, {raster_us / max(busy_us, 1e-9):.2%} of device busy; "
        + "; ".join(f"{k} {sum(v) / 1e3:.3f} ms in {len(v)} launches" for k, v in raster.items())
    )
    return lines


def main(argv=None, device=None) -> dict:
    """Returns {"wall_ms", "self_ms", "events", "top": [(name, ms, count)], "stages": [lines]}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=SIZE)
    parser.add_argument("--top", type=int, default=TOP)
    parser.add_argument("--out", type=Path, help="keep the Chrome trace (trace.json) in this directory")
    parser.add_argument("overrides", nargs="*", help="config overrides key=value")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(device, "bench_trace_step")
    size = args.size
    overrides = [f"dataset.image_shape=[{size},{size}]", *OVERRIDES, *args.overrides]
    _, state, _, train_step, batch = train_setup(overrides, BATCH, size, device)
    generator = torch.Generator(device=device).manual_seed(1)
    for _ in range(2):
        state, logs = train_step(state, batch, 0, generator=generator)
        float(logs["generator/total"])
    with tempfile.TemporaryDirectory(prefix="bench_trace_step_") as tmp:
        out_dir = args.out or Path(tmp)
        sync(device)
        with trace(out_dir):
            start = time.perf_counter()
            state, logs = train_step(state, batch, 0, generator=generator, timer=annotate)
            float(logs["generator/total"])
            sync(device)
            wall_ms = (time.perf_counter() - start) * 1e3
        trace_json = json.loads((out_dir / "trace.json").read_text())
    times = self_times(trace_json, DEVICE_CATS if device.type == "cuda" else ("cpu_op",))
    total_us = sum(t for t, _ in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[: args.top]
    kind = "device kernels, copies and fills" if device.type == "cuda" else "CPU operators (no device)"
    print(f"device: {device_name(device)}")
    print(f"trace of one {size}px batch-{BATCH} step: wall {wall_ms:.1f} ms; self time of the {kind} "
          f"{total_us / 1e3:.1f} ms over {sum(c for _, c in times.values())} events")
    for name, (us, count) in top:
        print(f"{us / 1e3:9.2f} ms  x{count:<5d} {name[:100]}")
    stages = trace_breakdown(trace_json)
    for line in stages:
        print(f"  {line}")
    return {"wall_ms": wall_ms, "self_ms": total_us / 1e3, "events": sum(c for _, c in times.values()),
            "top": [(name, us / 1e3, count) for name, (us, count) in top], "stages": stages}


if __name__ == "__main__":
    main()
