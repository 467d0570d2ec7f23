"""Counts a cell's model FLOPs a request or a train step, once, on the
reference at the cell's shapes, and writes flops/<cell>.json:

    python -m perfbench.count_flops --workload <cell> [--out DIR]

FlopCounterMode counts the matrix products, convolutions and attention
of one request's forward (serving) or one step's forward, probes and
backward (training; the reference has no recomputation). The plain
compositor's forward products run outside the count: they are the
rasterizer's padded pixel sums, not model work (their backward, under 1%
of a step, is counted).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from . import harness, models, scenes, train
from .reference.model.latentsplat import render_full
from .reference.ops.rasterize import plain
from .run import HERE, ROOT, cell_files, load_json


def _uncounted(fn):
    def wrapped(*args):
        with _disable_current_modes():
            return fn(*args)
    return wrapped


def count(ctx) -> int:
    harness.reference_precision()
    plain._composite_block = _uncounted(plain._composite_block)
    counter = FlopCounterMode(display=False)
    if ctx.traffic["kind"] == "serve":
        model = models.reference_generator(ctx.config, ctx.seed, ctx.device)
        batch, noise = scenes.make_request(ctx.config, ctx.traffic, ctx.seed, 0, ctx.device)
        with torch.no_grad(), counter:
            render_full(model, batch, noise=noise)
    else:
        state, step = models.reference_train_state(ctx.config, ctx.traffic["scenes"], ctx.seed, ctx.device)
        with counter:
            train._step(ctx, state, step, 0)
    return counter.get_total_flops()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--out", type=Path, default=HERE / "flops")
    args = parser.parse_args(argv)
    files = cell_files(load_json(ROOT / "BENCHMARK.json"), args.workload)
    ctx = harness.Ctx(args.workload, files["config"], files["traffic"], files["limits"], 0, 0.0, False,
                      torch.device("cuda", 0), time.perf_counter())
    flops = count(ctx)
    args.out.mkdir(parents=True, exist_ok=True)
    record = {"flops": flops, "unit": "request" if files["traffic"]["kind"] == "serve" else "step",
              "counted_by": "perfbench/count_flops.py: FlopCounterMode over the reference, seed 0"}
    (args.out / f"{args.workload}.json").write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
