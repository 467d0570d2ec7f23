"""Readings that set a cell's limits (limits/<cell>.json), made on the card
at the cell's own size, several seeds in one process:

    python -m perfbench.control --workload <cell> --seeds 1 2 3 ... [--out FILE]

For each seed: the program's numbers (what a run compares: its outputs,
or its first steps, against the float32 reference), and the control's:
the reference computed one precision lower than the configuration states
(bfloat16 autocast; the configuration is float32 with TF32 convolutions)
in the program's place, against the same float32 reference. For a
training cell also the fault of half of each batch left out, the mean
taken over the rest. The lower reading of a number is the largest the
program gives, the upper the smallest the control (or a fault) gives.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from . import harness, models, scenes, serve, train
from .run import ROOT, cell_files, load_json

BF16 = torch.bfloat16
TILE = 16


def _serve_outputs(ctx, model, indices, render_full, autocast=False) -> dict:
    out = {}
    with torch.no_grad(), torch.autocast("cuda", dtype=BF16, enabled=autocast):
        for i in indices:
            batch, noise = scenes.make_request(ctx.config, ctx.traffic, ctx.seed, i, ctx.device)
            o = render_full(model, batch, noise=noise)
            out[i] = {k: o[k].float().cpu() for k in serve.OUTPUTS}
    return out


def tile_gaps(value: torch.Tensor, reference: torch.Tensor, views: int, tile: int = TILE) -> torch.Tensor:
    """Each (view, tile x tile block)'s median of |value - reference| over
    the reference's root mean square: what a fault in one tile moves. A
    diagnostic beside the compared numbers."""
    ref = reference.double().reshape(views, *reference.shape[2:])
    if ref.dim() == 3:
        ref = ref[..., None]
    val = value.double().reshape(ref.shape)
    v, h, w, c = ref.shape
    d = (val - ref).abs().reshape(v, h // tile, tile, w // tile, tile, c).permute(0, 1, 3, 2, 4, 5)
    rms = ref.pow(2).mean().sqrt().clamp(min=1e-30)
    return d.reshape(v * (h // tile) * (w // tile), -1).median(dim=1).values / rms


def _gaps(ctx, outputs: dict, reference: dict) -> dict:
    """The compared numbers, worst over the requests' views, and beside them
    the worst tile's median (`<out>_tile50`) and each view's q90
    (`<out>_views`) of the worst request."""
    views = ctx.traffic["scenes"] * ctx.traffic["targets"]["count"]
    out = {}
    for k in serve.OUTPUTS:
        per_view = [harness.view_gaps(outputs[i][k], reference[i][k], views, serve.QUANTILE) for i in reference]
        out[f"{k}_q90"] = max(max(v) for v in per_view)
        out[f"{k}_views"] = max(per_view, key=max)
        out[f"{k}_tile50"] = max(float(tile_gaps(outputs[i][k], reference[i][k], views).max()) for i in reference)
    return out


def serve_readings(ctx) -> dict:
    from latentsplat_tpu_torch.model.latentsplat import render_full as program_render

    from .reference.model.latentsplat import render_full as reference_render

    indices = list(range(ctx.traffic["check_requests"]))
    harness.program_precision(ctx.config)
    _, model = models.program_generator(ctx.config, ctx.seed, ctx.device)
    program = _serve_outputs(ctx, model, indices, program_render)
    del model
    harness.reference_precision()
    model = models.reference_generator(ctx.config, ctx.seed, ctx.device)
    reference = _serve_outputs(ctx, model, indices, reference_render)
    control = _serve_outputs(ctx, model, indices, reference_render, autocast=True)
    return {"program": _gaps(ctx, program, reference), "control": _gaps(ctx, control, reference)}


def _half_batch(train_step):
    """The fault: each step sees the first half of its scenes only."""
    def step(state, batch, index, **kwargs):
        half = {side: {k: v[: max(1, v.shape[0] // 2)] for k, v in views.items()} for side, views in batch.items()}
        noise = {k: v[: max(1, v.shape[0] // 2)] for k, v in kwargs.pop("noise").items()}
        return train_step(state, half, index, noise=noise, **kwargs)
    return step


def _train_numbers(program: dict, reference: dict) -> dict:
    """train.numbers, with each measure's worst leaves beside them."""
    grads = reference["grads"]
    median = statistics.median(grads.values())
    moved = [n for n in grads if grads[n] >= train.CHANGE_FLOOR * median]
    grad_gaps = train.leaf_gaps(program["grads"], grads, grads)
    change_gaps = train.leaf_gaps(program["change"], reference["change"], moved)

    def worst(gaps, values, ref, k=4):
        return [[n, gaps[n], values[n], ref[n], grads[n]] for n in sorted(gaps, key=lambda n: -gaps[n])[:k]]

    return {
        **train.numbers(program, reference),
        "loss_gap": max(abs(p - r) / max(abs(r), 1e-30) for ps, rs in zip(program["losses"], reference["losses"])
                        for p, r in zip(ps, rs)),
        "grad_worst_leaf_gap": max(grad_gaps.values()),
        "grad_norm_gap": {k: abs(v - reference["logs"][0][k]) / max(abs(reference["logs"][0][k]), 1e-30)
                          for k, v in program["logs"][0].items() if k.startswith("grad_norm/")},
        "change_worst_leaf_gap": max(change_gaps.values()),
        "worst_grad": worst(grad_gaps, program["grads"], grads),
        "worst_change": worst(change_gaps, program["change"], reference["change"]),
    }


def train_readings(ctx, raw: bool = False) -> dict:
    batch = ctx.traffic["scenes"]
    harness.program_precision(ctx.config)
    _, state, step = models.program_train_state(ctx.config, batch, ctx.seed, ctx.device)
    program = train.follow(ctx, state, step, train.program_gradients)
    del state, step
    _, state, step = models.program_train_state(ctx.config, batch, ctx.seed, ctx.device)
    half = train.follow(ctx, state, _half_batch(step), train.program_gradients)
    del state, step
    torch.cuda.empty_cache()
    harness.reference_precision()
    state, step = models.reference_train_state(ctx.config, batch, ctx.seed, ctx.device)
    reference = train.follow(ctx, state, step, train.reference_gradients)
    del state, step
    state, step = models.reference_train_state(ctx.config, batch, ctx.seed, ctx.device)
    with torch.autocast("cuda", dtype=BF16):
        control = train.follow(ctx, state, step, train.reference_gradients)
    out = {"program": _train_numbers(program, reference), "control": _train_numbers(control, reference),
           "half_batch": _train_numbers(half, reference)}
    if raw:
        out["raw"] = {side: {k: v for k, v in r.items() if k not in train.RENDERED} for side, r in
                      (("program", program), ("reference", reference), ("control", control), ("half_batch", half))}
    return out


def readings(cell: str, seed: int, raw: bool = False) -> dict:
    """{"program": numbers, "control": numbers[, "half_batch": numbers]}
    of one seed at the cell's own size, on the card; with `raw`, a training
    cell's also each side's logs and leaf norms."""
    files = cell_files(load_json(ROOT / "BENCHMARK.json"), cell)
    ctx = harness.Ctx(cell, files["config"], files["traffic"], files["limits"], seed, 0.0, False,
                      torch.device("cuda", 0), time.perf_counter())
    if files["traffic"]["kind"] == "serve":
        return serve_readings(ctx)
    return train_readings(ctx, raw)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", type=Path)
    parser.add_argument("--raw", action="store_true", help="keep each side's logs and leaf norms (training)")
    args = parser.parse_args(argv)
    rows = []
    for seed in args.seeds:
        start = time.perf_counter()
        row = {"seed": seed, **readings(args.workload, seed, args.raw)}
        row["seconds"] = time.perf_counter() - start
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "raw"})[:2000], flush=True)
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
