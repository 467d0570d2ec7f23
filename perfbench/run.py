"""The benchmark of latentsplat_tpu_torch: one run of one cell.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from BENCHMARK.json: the cell's configuration
file (`configs/<config>.json`), its traffic mix (`traffic/<mix>.json`,
whose `kind` names the module that runs it: serve.py or train.py), the
limits of its comparison (`limits/<cell>.json`), its model FLOPs a request
or step (`flops/<cell>.json`) and each per-layer metric's reader
(`metrics/<metric>.py`, a function `read(summary)` of the traced run's
summary that returns None where it finds nothing to read).

A run sets up the program, warms up the cell's shapes, measures for
--seconds (at most harness.TRACE_SECONDS under --trace 1, profiled),
checks what the window produced against the plain reference, and prints
one JSON line last: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with --trace 1 its per-layer ones),
`device`, `breakdown` when traced, and last `compared`, each number
compared with its limit (also the last lines of standard error). It exits
non-zero, printing no line, without a CUDA card, and if the JAX package
or JAX was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# Every cache of the program at a fixed path inside the checkout: the
# kernel library lands in build/kernels/ (cuda_build.py) on its own.
CACHES = {
    "TRITON_CACHE_DIR": ROOT / "build" / "triton",
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
    "CUDA_CACHE_PATH": ROOT / "build" / "cuda_cache",
}
FORBIDDEN = ("jax", "jaxlib", "flax", "latentsplat_tpu")
for _key, _path in CACHES.items():
    os.environ[_key] = str(_path)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(bench: dict, cell: str) -> dict:
    """The cell's entry and the files it names."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    flops = HERE / "flops" / f"{cell}.json"
    return {
        "entry": entry,
        "config": load_json(ROOT / config_entry["file"]),
        "traffic": load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{cell}.json"),
        "flops": load_json(flops) if flops.exists() else None,
    }


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The end-to-end (or, traced, per-layer) metrics the cell reports."""
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def read_metric(name: str, summary: dict):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(summary)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
            config: dict | None = None, t_start: float = T_START) -> dict:
    """One run of `cell`; returns the result line as a dict. `config`
    replaces the cell's configuration file (the tests' tiny model)."""
    files = cell_files(bench, cell)
    ctx = harness.Ctx(cell, config or files["config"], files["traffic"], files["limits"], seed, seconds, trace,
                      device, t_start)
    kind = importlib.import_module(f"perfbench.{files['traffic']['kind']}")
    outcome = kind.run(ctx)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run imported {bad}")
    metrics = {}
    summary = dict(outcome.summary, flops_per_unit=(files["flops"] or {}).get("flops"))
    for m in cell_metrics(bench, cell, trace):
        value = outcome.end_to_end.get(m["name"]) if not trace else read_metric(m["name"], summary)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = outcome.failed == 0 and bool(outcome.compared) and all(v <= lim for _, v, lim in outcome.compared)
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": files["entry"]["chips"],
        "memory_peak_bytes": outcome.memory_peak_bytes,
    }
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
            "device": dev}
    if trace:
        dev.update(busy_s=outcome.summary["busy_s"], window_s=outcome.summary["window_s"])
        line["breakdown"] = outcome.summary["breakdown"]
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.compared}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = cell_files(bench, args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
