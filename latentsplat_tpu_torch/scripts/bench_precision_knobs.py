"""Per-knob PSNR attribution of the fast rasterizer precision (the port's
counterpart of the repository's root bench_precision_knobs.py):

    python -m latentsplat_tpu_torch.scripts.bench_precision_knobs [--views 8] [--modes a,b,c]

Renders bench_render's scene (`make_scene`, 393,216 Gaussians at 256x256;
its first --views views of the 64-view arc) at "exact" and at each mode:
"fast", "fast_nocoef" and the diagnostic precisions, each "exact" plus one
of fast's knobs (ops/rasterize/tiled.py DIAGNOSTIC_PRECISIONS but
exact_bf16_grads, which changes only gradients). Against the exact render,
per mode: the PSNR of the colors (clipped to [0, 1]) and of the features,
the largest color difference, and the median and largest relative depth
error over the pixels the exact render covers (mask >= ALPHA_FLOOR; on
nearly empty pixels both depths are ~0 and their ratio means nothing).

Prints the card's name and power limit, then ONE JSON line (metric
precision_knob_psnr, `value` the fast colors' PSNR in dB against exact,
each mode's numbers under "knobs") and writes it to
precision_knobs_psnr.json in --out-dir (outputs/bench/). Sizes are
arguments so that tests can shrink the scene. The command line runs on the
card; `main(argv, device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import resolve_device
from .bench_render import N_VIEWS, SIDE, SIZE, make_scene, render_scene
from .measure import RECORD_DIR, device_name

MODES = (
    "fast",
    "fast_nocoef",
    "exact_wide_cull",
    "exact_tie_depth",
    "exact_bf16_mm",
    "exact_q12_channels",
    "exact_f16_xy",
    "exact_bf16_conic",
    "exact_depth_val",
    "exact_bf16_sh",
)
ALPHA_FLOOR = 0.1


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = (a - b).square().mean().item()
    return -10.0 * math.log10(max(mse, 1e-12))


def knob_errors(scene: dict, size: int, modes) -> dict:
    """Each mode's errors against the exact render of `scene`, and the
    exact render's covered share."""

    def outputs(precision):
        out = render_scene(scene, size, 0, precision)
        return out.color.clamp(0.0, 1.0), out.feature, out.depth, out.mask

    color_ref, feature_ref, depth_ref, mask_ref = outputs("exact")
    covered = mask_ref >= ALPHA_FLOOR
    knobs = {}
    for mode in modes:
        start = time.perf_counter()
        color, feature, depth, _ = outputs(mode)
        rel = ((depth - depth_ref).abs() / depth_ref.abs().clamp(min=1e-6))[covered]
        knobs[mode] = {
            "color_psnr_db": psnr(color, color_ref),
            "feature_psnr_db": psnr(feature, feature_ref),
            "color_max_abs_diff": (color - color_ref).abs().max().item(),
            "depth_rel_err": rel.median().item(),
            "depth_rel_err_max": rel.max().item(),
        }
        print(f"[{mode}] {time.perf_counter() - start:.3f} s: {knobs[mode]}", file=sys.stderr)
    return {"knobs": knobs, "depth_coverage_fraction": covered.float().mean().item()}


def main(argv=None, device=None) -> dict:
    """Returns the JSON record it prints and writes."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--views", type=int, default=8)
    parser.add_argument("--modes", default=",".join(MODES))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--side", type=int, default=SIDE, help="the depth surface's grid side (Gaussians: 6 side^2)")
    parser.add_argument("--size", type=int, default=SIZE)
    parser.add_argument("--out-dir", type=Path, default=RECORD_DIR)
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    modes = args.modes.split(",")
    unknown = sorted(set(modes) - set(MODES))
    if unknown:
        raise SystemExit(f"bench_precision_knobs: unknown modes {unknown}; expected some of {MODES}")
    device = resolve_device(device, "bench_precision_knobs")
    scene = make_scene(args.seed, args.side, N_VIEWS, device)
    for key in ("extrinsics", "intrinsics", "near", "far"):
        scene[key] = scene[key][:, : args.views]
    errors = knob_errors(scene, args.size, modes)
    result = {
        "metric": "precision_knob_psnr",
        "value": errors["knobs"]["fast"]["color_psnr_db"] if "fast" in errors["knobs"] else None,
        "unit": "dB(fast vs exact)",
        "device": device_name(device),
        "views": args.views,
        "gaussians": scene["gaussian_means"].shape[1],
        "size": args.size,
        "depth_alpha_floor": ALPHA_FLOOR,
        **errors,
        "note": "each exact_* hybrid enables exactly one fast-mode knob on the exact path; "
                "'fast' is all knobs at once (the headline mode)",
    }
    print(f"device: {result['device']}")
    print(json.dumps(result))
    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / "precision_knobs_psnr.json").write_text(
        json.dumps({**result, "measured_unix": int(time.time())}, indent=1))
    return result


if __name__ == "__main__":
    main()
