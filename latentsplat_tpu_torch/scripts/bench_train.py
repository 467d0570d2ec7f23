"""Train-step benchmark: the flagship VAE-GAN step's time on one card (the
port's counterpart of the repository's root bench_train.py):

    python -m latentsplat_tpu_torch.scripts.bench_train [--full] [--batch B] [--bf16]
        [--compute SITE:DTYPE,...] [--remat-policy POLICY] [--no-decoder-remat] [key=value ...]

The fused step (encoder -> splat -> VAE decode -> losses with the GAN and
its adaptive weight -> both optimizer updates) of the flagship re10k model
at full width, weights from seed 0 (`entry.flagship_model`), on
`entry.arc_batch(B, 2, 4, size, size)` at step 0 with the whole objective
live. The default is 128x128 with batch 1; --full is the reference's
training shape, 256x256 (batch 2 with --batch 2), with model.remat and
model.decoder.remat on (--no-decoder-remat keeps the render's residuals).
One warm-up step, then ITERS timed steps (host clock between
synchronizes); the median is the step time. The peak memory is taken over
those steps; then one more step, not timed, runs under
torch.utils.flop_counter.FlopCounterMode, whose count (matrix products and
convolutions, the recomputations of remat included) over the card's dense
bf16 peak gives `train_mfu`.

Prints the card's name and power limit, then ONE JSON line (metric
train_step_<size>px_batch<B>_vae_gan<variant>, the names of bench_train.py;
unit steps/sec/chip) and writes it with the device and the time to
outputs/bench/ (--out-dir), where bench_render finds the newest. --fast
trains at model.decoder.precision=fast, as bench_train.py's --fast does.
Trailing key=value arguments override the config further (tests pass a
narrow model). The command line runs on the card; `main(argv,
device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..cuda_build import KERNELS, launched
from . import resolve_device
from .measure import BF16_FLOPS, OBJECTIVE, RECORD_DIR, device_name, median_seconds, sync, train_setup

ITERS = 4


def parse_args(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full", action="store_true", help="256x256 with model.remat and model.decoder.remat")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--bf16", action="store_true", help="model.compute_dtype=bfloat16")
    parser.add_argument("--compute", help="model.compute_dtype per site, e.g. encoder:bfloat16,vae:bfloat16")
    parser.add_argument("--remat-policy", default="nothing")
    parser.add_argument("--no-decoder-remat", action="store_true")
    parser.add_argument("--fast", action="store_true", help="model.decoder.precision=fast")
    parser.add_argument("--size", type=int, help="image side (default 256 with --full, else 128)")
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("--out-dir", type=Path, default=RECORD_DIR)
    parser.add_argument("overrides", nargs="*", help="config overrides key=value")
    args = parser.parse_args(argv)
    if args.size is None:
        args.size = 256 if args.full else 128
    return args


def train_overrides(args: argparse.Namespace) -> list:
    """bench_train.py's overrides for these flags."""
    if args.compute:
        compute = [f"model.compute_dtype={args.compute}"]
    else:
        compute = ["model.compute_dtype=bfloat16"] if args.bf16 else []
    return [
        f"dataset.image_shape=[{args.size},{args.size}]",
        f"model.remat_policy={args.remat_policy}",
        *compute,
        *(["model.decoder.precision=fast"] if args.fast else []),
        f"model.remat={'true' if args.full else 'false'}",
        f"model.decoder.remat={'true' if args.full and not args.no_decoder_remat else 'false'}",
        *OBJECTIVE,
    ]


def metric_name(args: argparse.Namespace) -> str:
    """bench_train.py's metric name for these flags."""
    variant = "_fast" if args.fast else ""
    if args.compute:
        variant += "_" + args.compute.replace(":", "-").replace(",", "+")
    elif args.bf16:
        variant += "_bf16"
    if args.remat_policy != "nothing":
        variant += "_" + args.remat_policy.replace(":", "-").replace(",", "+")
    if args.no_decoder_remat:
        variant += "_keepres"
    return f"train_step_{args.size}px_batch{args.batch}_vae_gan{variant}"


def run(args: argparse.Namespace, device: torch.device) -> dict:
    """The benchmark; returns its record (see the module docstring)."""
    cfg, state, _, train_step, batch = train_setup([*train_overrides(args), *args.overrides], args.batch,
                                                   args.size, device)
    generator = torch.Generator(device=device).manual_seed(1)
    totals = []

    def step(_=None):
        nonlocal state
        state, logs = train_step(state, batch, 0, generator=generator)
        totals.append(float(logs["generator/total"]))   # the host read ends the step

    before = {k: launched(k) for k in KERNELS}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    step()
    sync(device)
    first_s = time.perf_counter() - start
    median, seconds = median_seconds(step, args.iters, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    with FlopCounterMode(display=False) as counter:
        step()
    flops = counter.get_total_flops()
    launches = {k: launched(k) - before[k] for k in KERNELS}
    if not all(math.isfinite(t) for t in totals):
        raise AssertionError(f"bench_train: non-finite generator/total {totals}")
    on_card = device.type == "cuda"
    return {
        "metric": metric_name(args),
        "value": 1.0 / median,
        "unit": "steps/sec/chip",
        # The reference trains this shape on a 40 GB A100 and publishes no
        # step time; bench_train.py's working anchor is 1 step/s.
        "vs_baseline": 1.0 / median,
        "device": device_name(device),
        "size": args.size,
        "batch": args.batch,
        "overrides": [*train_overrides(args), *args.overrides],
        "step_seconds": seconds,
        "first_step_seconds": first_s,
        "peak_gib": peak / 2**30 if peak is not None else None,
        "train_flops_per_step": flops,
        "train_mfu": flops / median / BF16_FLOPS if on_card else None,
        "train_mfu_peak": "H100 SXM dense bf16, 989 TFLOP/s (NVIDIA's data sheet, 700 W)",
        "train_flops_note": "FlopCounterMode over one untimed step: matrix products, convolutions and "
                            "attention, remat's recomputations included; elementwise work and the "
                            "rasterizer's kernels are not counted",
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32, "matmul": torch.backends.cuda.matmul.allow_tf32},
        "generator_total": totals,
        "steps_run": len(totals),
        "decoder_remat": cfg.model.decoder.remat,
        "precision": cfg.model.decoder.precision,
        "launches": launches,
    }


def main(argv=None, device=None) -> dict:
    """Returns the JSON record it prints and writes."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(device, "bench_train")
    print(f"bench_train: {args.size}px, batch {args.batch} on {device}", file=sys.stderr)
    result = run(args, device)
    print(f"bench_train: train_mfu against {result['train_mfu_peak']}; step seconds "
          f"{[round(s, 4) for s in result['step_seconds']]}", file=sys.stderr)
    print(f"device: {result['device']}")
    print(json.dumps(result))
    args.out_dir.mkdir(parents=True, exist_ok=True)
    name = f"train_step_{args.size}px_b{args.batch}{result['metric'].split('_vae_gan', 1)[1]}.json"
    (args.out_dir / name).write_text(json.dumps({**result, "measured_unix": int(time.time())}, indent=1))
    return result


if __name__ == "__main__":
    main()
