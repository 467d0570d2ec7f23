"""Where a render call's time goes: bench_render's call (64 views of a
393,216-Gaussian scene at 256x256) timed and traced at fast and exact:

    python -m latentsplat_tpu_torch.scripts.trace_render [--views 64] [--iters 5] [--out DIR]

For each precision: `bench_render.time_render` (one warm-up call, then
--iters timed calls; views/s and ms a view from the median) and the peak of
the card's allocated memory over one more call; then one call under
`misc.profiler.trace`. From its Chrome trace: the device events (kernels,
copies, fills) and their count a view, the device's busy share (the union
of the device events over the call's wall span, from the call's start on
the host to the last device event's end), the device-to-host copies (the
host reads), and the longest gaps between device events, each with the
host operators that ran across it (the innermost and the outermost that
hold the gap's middle) and the kernel that ended it. Where the package
renders in passes (`api.pass_ranges`), also each stage of the call's one
pass alone (`bench_render_stages.pass_stages`, --iters calls).

The imports are absolute, so that the file also runs by its path against
another checkout of the package (PYTHONPATH=<checkout>), which is how two
trees are compared on one card. Prints the card's name and power limit,
then one JSON line. The command line runs on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from latentsplat_tpu_torch.misc.profiler import annotate, trace
from latentsplat_tpu_torch.ops.rasterize import api
from latentsplat_tpu_torch.scripts.bench_render import N_VIEWS, SIDE, SIZE, make_scene, render_scene, time_render
from latentsplat_tpu_torch.scripts.bench_trace_step import DEVICE_CATS
from latentsplat_tpu_torch.scripts.measure import device_name

PRECISIONS = ("fast", "exact")
TOP_GAPS = 6


def trace_summary(trace_json: dict, n_views: int, span_name: str = "render") -> dict:
    """The call's device events, busy share, host reads and longest gaps
    (see the module docstring) from a Chrome trace whose call is the
    user annotation `span_name`."""
    events = [e for e in trace_json["traceEvents"] if e.get("ph") == "X"]
    span = next(e for e in events if e.get("cat") == "user_annotation" and e.get("name") == span_name)
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    host = [e for e in events if e.get("cat") == "cpu_op"]
    launcher = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    start = span["ts"]
    end = max([span["ts"] + span["dur"]] + [e["ts"] + e["dur"] for e in device])
    busy, gaps = 0.0, []
    cursor = start
    for e in device:
        if e["ts"] > cursor:
            gaps.append((e["ts"] - cursor, cursor, e))
        busy += max(0.0, e["ts"] + e["dur"] - max(cursor, e["ts"]))
        cursor = max(cursor, e["ts"] + e["dur"])
    if end > cursor:
        gaps.append((end - cursor, cursor, None))

    def host_ops(a: float, b: float) -> str:
        mid = 0.5 * (a + b)
        holding = sorted((e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]), key=lambda e: e["dur"])
        if not holding:
            return "no host operator"
        inner, outer = holding[0]["name"], holding[-1]["name"]
        return inner if inner == outer else f"{inner} in {outer}"

    top = []
    for dur, a, nxt in sorted(gaps, key=lambda g: -g[0])[:TOP_GAPS]:
        ended_by = "the call's end"
        if nxt is not None:
            launch = launcher.get(nxt.get("args", {}).get("correlation"))
            ended_by = nxt["name"][:60] + (f" (launched by {launch['name']})" if launch else "")
        top.append({"ms": dur / 1e3, "host": host_ops(a, a + dur), "ended_by": ended_by})
    launched = [e for e in device if e.get("cat") == "kernel"]
    reads = [e for e in device if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]]
    wall = end - start
    return {
        "wall_ms": wall / 1e3,
        "device_events": len(device),
        "kernels": len(launched),
        "device_events_per_view": len(device) / n_views,
        "busy_ms": busy / 1e3,
        "busy_share": busy / max(wall, 1e-9),
        "host_reads": len(reads),
        "top_gaps": top,
    }


def traced_call(scene: dict, size: int, precision: str, out_dir: Path) -> dict:
    """One call of `render_scene` at `precision` under the profiler."""
    torch.cuda.synchronize()
    with trace(out_dir / precision):
        with annotate("render"):
            render_scene(scene, size, 7, precision)
        torch.cuda.synchronize()
    raw = out_dir / precision / "trace.json"
    return trace_summary(json.loads(raw.read_text()), scene["extrinsics"].shape[1])


def peak_gib(scene: dict, size: int, precision: str) -> float:
    """The card's peak allocated memory over one call, GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render_scene(scene, size, 3, precision)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--side", type=int, default=SIDE)
    parser.add_argument("--views", type=int, default=N_VIEWS)
    parser.add_argument("--size", type=int, default=SIZE)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--no-trace", action="store_true", help="time only")
    parser.add_argument("--out", type=Path, default=None, help="keep the Chrome traces here")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if not torch.cuda.is_available():
        raise SystemExit("trace_render: no CUDA device found")
    device = torch.device("cuda")
    scene = make_scene(args.seed, args.side, args.views, device)
    result = {"card": device_name(device), "views": args.views, "gaussians": scene["gaussian_means"].shape[1],
              "size": args.size}
    out_dir = args.out or Path(tempfile.mkdtemp(prefix="trace_render_"))
    for precision in PRECISIONS:
        started = time.perf_counter()
        timing = time_render(scene, args.size, args.iters, precision)
        row = {
            "views_per_s": args.views / timing["median_s"],
            "ms_per_view": 1e3 * timing["median_s"] / args.views,
            "call_seconds": timing["seconds"],
            "launches": timing["launches"],
            "peak_gib": peak_gib(scene, args.size, precision),
        }
        if not args.no_trace:
            row["trace"] = traced_call(scene, args.size, precision, out_dir)
        if hasattr(api, "pass_ranges"):
            from latentsplat_tpu_torch.scripts.bench_render_stages import pass_stages
            row["pass_stages_ms"] = pass_stages(scene, args.size, precision, args.iters, device)
        row["phase_s"] = time.perf_counter() - started
        result[precision] = row
    print(result["card"])
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
