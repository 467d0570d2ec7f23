"""Render benchmark: target views per second of a 393,216-Gaussian scene at
256x256 (the port's counterpart of the repository's root bench.py), at the
fast precision (the headline) and at exact:

    python -m latentsplat_tpu_torch.scripts.bench_render [--seed 0]

The scene has the flagship re10k test shape (`make_scene`): 2 context views
x 256^2 pixels x 3 Gaussians a pixel on a smooth depth surface, color SH of
degree 4 (25 coefficients), 4 latent feature channels of degree 2 (9), 64
target views on an arc, near 0.5 and far 20. At each precision ("fast",
then "exact"): one warm-up call, then ITERS calls of the tiled render of
all 64 views (opacities scaled by 1 - 1e-6 i so that no call repeats
another), each ended by a device synchronize; the median over the views
gives views/s. Every call's pairs per view are held against the total
that the tile cull (at the precision's margin) counts for that call's
inputs: a render that composited fewer pairs than it counted raises.
`fast_vs_exact_psnr_db` is the PSNR of the fast render's colors (clipped
to [0, 1]) against the exact render's, over all views, as bench.py takes it.

The fast render's float32 operations per view are counted as PERF.md
counts the composite kernels' (`composite_work` on each view's kernel
outputs: 14 per (pair, pixel) evaluation, 2 C + 3 per composited (pair,
pixel)), plus the SH evaluation and projection of every Gaussian, counted
by running them under `count_operations`. `render_mfu` is that over the
card's float32 peak.

Prints the card's name and power limit, then ONE JSON line: metric
render_256px_393k_gaussians_fwd in views/sec/chip, `value` = `value_fast`,
`value_exact`, `fast_vs_exact_psnr_db`, the mean pairs per view, the
operations, `render_mfu`, and the newest record of bench_train in
outputs/bench/. Sizes are arguments so that tests can shrink the scene.
The command line runs on the card; `main(argv, device="cpu")` on the CPU.

With --shade it times only the render's shade stage instead, on one pass
of all the views (the video cell's pass: --views 30), and prints one JSON
line (`time_shade`): the `shade_project` kernel's device ms with L2
flushed and warm, the plain shade's (`shade_reference`), the
kernel's least time on the card (its bytes over HBM's rate) and its share
of it (tests/test_torch_cuda.py holds the kernel to the plain shade's
bits):

    python -m latentsplat_tpu_torch.scripts.bench_render --shade --views 30
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..entry import arc_cameras
from ..cuda_build import KERNELS, launched
from ..ops.rasterize import kernels
from ..ops.rasterize.api import render
from ..ops.rasterize.shade import shade_project, shade_reference
from ..ops.rasterize.tiled import (
    CULL_MARGIN,
    FAST_CULL_MARGIN,
    depth_code_bits,
    pack_attributes,
    precision_knobs,
    quantize_attributes,
    tile_pairs,
    tile_rects,
)
from . import resolve_device
from .measure import (
    FLUSH_BYTES,
    FP32_FLOPS,
    RECORD_DIR,
    bound,
    device_ms,
    device_name,
    median_seconds,
    screen_view,
    sync,
    timed_ms,
)

METRIC = "render_256px_393k_gaussians_fwd"
REFERENCE_VIEWS_PER_SEC = 100.0  # bench.py's anchor: the reference CUDA rasterizer on an A100, assumed
SIZE = 256
SIDE = 256                # the depth surface's pixel grid per context view
GAUSSIANS_PER_PIXEL = 3
N_VIEWS = 64
N_FEATURES = 4
COLOR_SH = 25             # degree 4
FEATURE_SH = 9            # degree 2
ITERS = 5
# Measured in this order; the first is the headline `value`.
PRECISIONS = ("fast", "exact")
# Rounded float32 operations (an expf, a min or a compare counts as one)
# that composite_forward spends per (pair, pixel) evaluation, and per
# composited (pair, pixel) on top: the weight, the channel sums and the
# transmittance.
EVAL_OPS = 14


def forward_composited_ops(n_ch: int) -> int:
    return 2 * n_ch + 3


def scene_draws(rng: np.random.Generator, n: int) -> dict:
    """make_scene's random draws in bench.make_scene's order: the surface
    jitter's normals, the scales' and opacities' uniforms, the color and
    feature harmonics' normals."""
    return {
        "jitter": rng.standard_normal((n, 3), dtype=np.float32),
        "scale": rng.uniform(5e-3, 2e-2, (n, 3)).astype(np.float32),
        "opacity": rng.uniform(0.3, 1.0, (n,)).astype(np.float32),
        "color_sh": rng.standard_normal((n, 3, COLOR_SH), dtype=np.float32),
        "feature_sh": rng.standard_normal((n, N_FEATURES, FEATURE_SH), dtype=np.float32),
    }


def make_scene(seed: int = 0, side: int = SIDE, n_views: int = N_VIEWS, device="cpu") -> dict:
    """bench.make_scene from a numpy generator: surface Gaussians like the
    encoder emits, 2 x side^2 x GAUSSIANS_PER_PIXEL of them on a smooth depth
    surface sampled on a side x side grid (jittered along depth), scales in
    [5e-3, 2e-2), opacities in [0.3, 1), harmonics N(0, 0.3^2); n_views
    cameras on an arc; one scene, as tensors with a leading axis of 1."""
    n = 2 * GAUSSIANS_PER_PIXEL * side * side
    d = scene_draws(np.random.default_rng(seed), n)
    u, v = np.meshgrid(np.linspace(-1.5, 1.5, side, dtype=np.float32), np.linspace(-1.5, 1.5, side, dtype=np.float32))
    base_depth = np.float32(4.0) + np.float32(0.8) * np.sin(2 * u) * np.cos(np.float32(1.5) * v) + np.float32(0.3) * u
    grid = np.stack([u, v, base_depth], axis=-1).reshape(-1, 3)
    means = np.tile(grid[None], (2 * GAUSSIANS_PER_PIXEL, 1, 1)).reshape(-1, 3)
    means = means + d["jitter"] * np.asarray([5e-3, 5e-3, 8e-2], np.float32)
    extrinsics, intrinsics = arc_cameras(n_views)
    arrays = {
        "extrinsics": extrinsics, "intrinsics": intrinsics,
        "near": np.full((n_views,), 0.5, np.float32), "far": np.full((n_views,), 20.0, np.float32),
        "background_color": np.zeros((3,), np.float32),
        "gaussian_means": means,
        "gaussian_covariances": np.eye(3, dtype=np.float32)[None] * (d["scale"] ** 2)[:, :, None],
        "gaussian_opacities": d["opacity"],
        "gaussian_color_sh": d["color_sh"] * np.float32(0.3),
        "gaussian_feature_sh": d["feature_sh"] * np.float32(0.3),
    }
    return {k: torch.from_numpy(a)[None].to(device) for k, a in arrays.items()}


def render_scene(scene: dict, size: int, i: int = 0, precision: str = "exact"):
    """The tiled render of every view at `precision`, opacities scaled by
    1 - 1e-6 i."""
    with torch.no_grad():
        return render(
            scene["extrinsics"], scene["intrinsics"], scene["near"], scene["far"], (size, size),
            scene["background_color"], scene["gaussian_means"], scene["gaussian_covariances"],
            scene["gaussian_opacities"] * (1.0 - 1e-6 * i), scene["gaussian_color_sh"], scene["gaussian_feature_sh"],
            precision=precision,
        )


def counted_pairs(scene: dict, size: int, i: int = 0, precision: str = "exact") -> list:
    """Each view's pair total as the tile cull counts it at `precision`'s
    margin (what duplicate_with_keys allocates), opacities scaled by
    1 - 1e-6 i. Launches only the tile cull, once a view."""
    tiles = size // kernels.TILE
    margin = FAST_CULL_MARGIN if precision_knobs(precision).wide_cull else CULL_MARGIN
    with torch.no_grad():
        return [int(tile_rects(screen_view(scene, size, j, i), tiles, tiles, 9, margin)[0].sum())
                for j in range(scene["extrinsics"].shape[1])]


def time_render(scene: dict, size: int, iters: int = ITERS, precision: str = "exact") -> dict:
    """One warm-up call, then `iters` timed calls of `render_scene` at
    `precision`; each call's pairs per view, its seconds and the kernels'
    launches over all the calls."""
    device = scene["gaussian_means"].device
    before = {k: launched(k) for k in KERNELS}
    pairs = []

    def call(i):
        pairs.append(render_scene(scene, size, i, precision).num_pairs.reshape(-1).tolist())

    sync(device)
    call(0)
    sync(device)
    median, seconds = median_seconds(call, iters, device)
    return {"median_s": median, "seconds": seconds, "pairs": pairs,
            "launches": {k: launched(k) - before[k] for k in KERNELS}}


def check_pairs(scene: dict, size: int, pairs: list, precision: str = "exact") -> None:
    """Raises unless call i composited, in every view, the pairs its inputs
    count (`counted_pairs` with opacities scaled as call i's)."""
    for i, got in enumerate(pairs):
        counted = counted_pairs(scene, size, i, precision)
        if got != counted:
            dropped = [(j, c - g) for j, (c, g) in enumerate(zip(counted, got)) if c != g]
            raise AssertionError(f"render call {i} composited other pair totals than it counted (view, "
                                 f"counted - composited): {dropped[:8]}")


def warp_blocks(x: torch.Tensor) -> torch.Tensor:
    """(..., 256) row-major tile pixels -> (..., 8, 32) by the tile's 4x8-pixel
    blocks, which composite_forward's warps own: pixel 16 r + c is lane
    8 (r % 4) + c % 8 of block 2 (r // 4) + c // 8."""
    x = x.reshape(*x.shape[:-1], kernels.TILE // kernels.WARP_ROWS, kernels.WARP_ROWS,
                  kernels.TILE // kernels.WARP_COLS, kernels.WARP_COLS)
    return x.transpose(-3, -2).reshape(*x.shape[:-4], kernels.TILE * kernels.TILE // 32, 32)


def composite_work(view: dict) -> dict:
    """The (pair, pixel) work this view's (or pass's) inputs need, counted on its
    device: the forward's evaluations (each pixel up to its `last` if it
    saturated, else to its tile's end), the backward's (each pixel up to
    its `last`), the composited (pair, pixel) combinations and the pairs
    some pixel composited. Then the (pair, warp) steps of each composite
    kernel's warps: the forward's 4x8-pixel warps (all pairs up to the
    warp's stop, those whose footprint box meets the warp's pixels, those
    where some lane composited) and the backward's two-row warps (all
    pairs up to the tile's largest `last`, those below the warp's largest
    `last`, those where some lane composited), with each kernel's median
    and longest tile walk. `view` holds the sorted gids, tile ranges,
    attribute rows, tiles_x, (h, w) and composite_forward's `t_final` and
    `last`. Raises if a lane composited a pair whose box misses its warp:
    the forward's cull must drop no such pair."""
    gids, ranges, attrs, tiles_x, (h, w) = (view[k] for k in ("gids", "ranges", "attrs", "tiles_x", "shape"))
    tiles_y = h // kernels.TILE
    num_tiles = ranges.shape[0] - 1                                              # N T, N items of T tiles
    n_warps = kernels.PIX // 32
    device = attrs.device
    starts, stops = ranges[:-1].long(), ranges[1:].long()
    last = kernels.tile(view["last"], tiles_x, tiles_y).long()                   # (N T, 256)
    saturated = kernels.tile(view["t_final"], tiles_x, tiles_y) < kernels.TRANSMITTANCE_MIN
    forward_end = torch.where(saturated, last, stops[:, None])                   # each pixel's stop
    warp_end = warp_blocks(forward_end).max(dim=2).values                        # (N T, 8)
    px, py = (x.repeat(num_tiles // (tiles_x * tiles_y), 1) for x in kernels._tile_pixels(tiles_x * tiles_y, tiles_x,
                                                                                            device))
    # Top-left pixel of each forward warp's 4x8 block, (N T, 8).
    warp_x0 = warp_blocks(px).amin(dim=2)
    warp_y0 = warp_blocks(py).amin(dim=2)
    pair_tile = torch.repeat_interleave(torch.arange(num_tiles, device=device), stops - starts)
    used = used_pairs = used_steps = kept_steps = composited_steps = culled_composited = 0
    for lo in range(0, gids.shape[0], 1 << 15):
        hi = min(lo + (1 << 15), gids.shape[0])
        t = pair_tile[lo:hi]
        a = attrs[gids[lo:hi].long()]
        dx, dy = px[t] - a[:, 0:1], py[t] - a[:, 1:2]
        power = -0.5 * (a[:, 2:3] * dx * dx + a[:, 4:5] * dy * dy) - a[:, 3:4] * dx * dy
        alpha = torch.clamp(a[:, 5:6] * torch.exp(power), max=kernels.ALPHA_CLAMP)
        pos = torch.arange(lo, hi, device=device)[:, None]
        use = (pos < last[t]) & (power <= 0.0) & (alpha >= kernels.ALPHA_THRESHOLD)
        used += int(use.sum())
        used_pairs += int(use.any(dim=1).sum())
        used_steps += int(use.view(-1, n_warps, 32).any(dim=2).sum())
        box = kernels.footprint_box_reference(a)
        x0, y0 = warp_x0[t], warp_y0[t]
        kept = ((box[:, 0:1] <= x0 + (kernels.WARP_COLS - 1)) & (box[:, 1:2] >= x0)
                & (box[:, 2:3] <= y0 + (kernels.WARP_ROWS - 1)) & (box[:, 3:4] >= y0))
        composited = warp_blocks(use).any(dim=2)
        kept_steps += int((kept & (pos < warp_end[t])).sum())
        composited_steps += int(composited.sum())
        culled_composited += int((composited & ~kept).sum())
    walk = last.max(dim=1).values - starts                 # pairs each tile's backward walks
    forward_walk = forward_end.max(dim=1).values - starts
    if culled_composited:
        raise AssertionError(f"{culled_composited} composited (pair, warp) steps lie outside the footprint box")
    return {
        "forward_evaluations": int((forward_end - starts[:, None]).sum()),
        "backward_evaluations": int((last - starts[:, None]).sum()),
        "composited": used, "composited_pairs": used_pairs,
        "forward_warp_steps": int((warp_end - starts[:, None]).sum()),
        "forward_warp_steps_kept": kept_steps,
        "forward_warp_steps_composited": composited_steps,
        "forward_tile_walk_median": int(forward_walk.median()),
        "forward_tile_walk_max": int(forward_walk.max()),
        "warp_steps": int(walk.sum()) * n_warps,
        "warp_steps_below_warp_last": int((last.view(num_tiles, -1, 32).max(dim=2).values - starts[:, None]).sum()),
        "warp_steps_composited": used_steps,
        "tile_walk_median": int(walk.median()), "tile_walk_max": int(walk.max()),
    }


def view_work(scene: dict, size: int, j: int, precision: str = "exact") -> tuple[dict, int]:
    """(composite_work, channels composited) of view j, through the
    render's own pipeline at `precision` (one launch of each forward
    kernel, composite_forward in the variant a render without gradient
    takes); the work is counted on the Gaussians' rows as the kernel reads
    them (the f16_xy knob's per-pair rounding aside)."""
    tiles = size // kernels.TILE
    knobs = precision_knobs(precision)
    with torch.no_grad():
        sg = screen_view(scene, size, j, precision=precision)
        gids, ranges, _, _, _ = tile_pairs(sg, (size, size), 9, precision)
        attrs = quantize_attributes(pack_attributes(sg), knobs, depth_code_bits(tiles * tiles)[1])
        _, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size), f16_xy=knobs.f16_xy,
                                                     bf16_mm=knobs.bf16_mm, coef=knobs.coef)
        view = {"gids": gids, "ranges": ranges, "attrs": attrs, "tiles_x": tiles, "shape": (size, size),
                "t_final": t_final, "last": last}
        return composite_work(view), attrs.shape[1] - 6


class _PointwiseCount(TorchDispatchMode):
    """Counts one operation per output element of each pointwise op and one
    per input element of each reduction."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.Tag.pointwise in func.tags and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        elif torch.Tag.reduction in func.tags and args and isinstance(args[0], torch.Tensor):
            self.ops += args[0].numel()
        return out


def count_operations(fn, *args) -> int:
    """Operations of fn(*args) as its code runs them: 2 m n k a matrix
    product (FlopCounterMode), one per output element of a pointwise op,
    one per input element of a reduction."""
    with FlopCounterMode(display=False) as flops, _PointwiseCount() as pointwise:
        fn(*args)
    return flops.get_total_flops() + pointwise.ops


def render_operations(scene: dict, size: int, precision: str = "exact") -> dict:
    """Float32 operations of one view at `precision`, the mean over all
    views: the SH evaluation and projection of every Gaussian (counted by
    running them), and composite_forward's, from each view's
    `composite_work`. Launches each forward kernel once a view."""
    with torch.no_grad():
        project = count_operations(screen_view, scene, size, 0, 0, precision)
    composite = []
    for j in range(scene["extrinsics"].shape[1]):
        work, n_ch = view_work(scene, size, j, precision)
        composite.append(EVAL_OPS * work["forward_evaluations"] + forward_composited_ops(n_ch) * work["composited"])
    return {"total": project + statistics.fmean(composite), "project_sh": project,
            "composite": statistics.fmean(composite)}


def shade_inputs(scene: dict) -> tuple:
    """`shade`'s arguments for one pass of all of the scene's views (no
    `use_sh`): as `render` hands them to it, scale-invariant."""
    tables = {"color": scene["gaussian_color_sh"], "feature": scene["gaussian_feature_sh"]}
    per_item = (scene[k][0] for k in ("extrinsics", "intrinsics", "near"))
    return (scene["gaussian_means"], scene["gaussian_covariances"], scene["gaussian_opacities"], tables, *per_item,
            0, scene["extrinsics"].shape[1], None, True)


def shade_bytes(scene: dict) -> int:
    """The least bytes the shade of a pass of all views moves: each
    Gaussian's geometry and SH tables read once, each (item, Gaussian) row's
    ScreenGaussians fields written once (mean2d 2, conic 3, depth, radius,
    opacity, extent 2 and the channels, float32)."""
    g = scene["gaussian_means"].shape[1]
    n = scene["extrinsics"].shape[1]
    sh = sum(scene[k][0, 0].numel() for k in ("gaussian_color_sh", "gaussian_feature_sh"))
    channels = scene["gaussian_color_sh"].shape[-2] + scene["gaussian_feature_sh"].shape[-2]
    return 4 * (g * (3 + 9 + 1 + sh) + n * g * (10 + channels))


def time_shade(scene: dict, size: int) -> dict:
    """The shade kernel and the plain shade on one pass of all views: the
    kernel's device ms (`device_ms`, L2 flushed before each call, and warm),
    the plain shade's (`timed_ms`: host clock around synchronized calls,
    which the device paces), the bound and the share."""
    args = shade_inputs(scene)
    device = scene["gaussian_means"].device
    flush = torch.empty(FLUSH_BYTES // 4, device=device)
    with torch.no_grad():
        ms = device_ms(lambda: shade_project(*args, (size, size)), flush=flush)
        warm_ms = device_ms(lambda: shade_project(*args, (size, size)))
        plain_ms = timed_ms(lambda _: shade_reference(*args, True, (size, size)), 5, device)
    n_bytes = shade_bytes(scene)
    bound_ms, bound_by = bound(n_bytes)
    return {"metric": "shade_project_ms", "device": device_name(device),
            "views": scene["extrinsics"].shape[1], "gaussians": scene["gaussian_means"].shape[1], "size": size,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bytes": n_bytes, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / ms}


def newest_train_record(record_dir: Path):
    """The newest train_step record that bench_train wrote to `record_dir`."""
    records = [json.loads(p.read_text()) for p in sorted(Path(record_dir).glob("train_step_*.json"))]
    return max(records, key=lambda r: r.get("measured_unix", 0), default=None)


def fast_vs_exact_psnr(scene: dict, size: int) -> float:
    """PSNR of the fast render's colors against the exact render's over all
    views, both clipped to [0, 1] (bench.py's _fast_vs_exact_psnr)."""
    fast, exact = (render_scene(scene, size, 0, p).color.clamp(0.0, 1.0) for p in ("fast", "exact"))
    mse = (fast - exact).square().mean().item()
    return -10.0 * math.log10(max(mse, 1e-12))


def summarize(scene: dict, size: int, timings: dict, device: torch.device, record_dir: Path) -> dict:
    """The JSON record of a `time_render` run at each of PRECISIONS
    (`timings` by precision; checks their pairs first)."""
    for precision, timing in timings.items():
        check_pairs(scene, size, timing["pairs"], precision)
    n_views = scene["extrinsics"].shape[1]
    vps = {p: n_views / timing["median_s"] for p, timing in timings.items()}
    fast, exact = timings["fast"], timings["exact"]
    ops = render_operations(scene, size, "fast")
    on_card = device.type == "cuda"
    result = {
        "metric": METRIC,
        "value": vps["fast"],
        "unit": "views/sec/chip",
        "vs_baseline": vps["fast"] / REFERENCE_VIEWS_PER_SEC,
        "value_fast": vps["fast"],
        "value_exact": vps["exact"],
        "fast_vs_exact_psnr_db": fast_vs_exact_psnr(scene, size),
        "precision": "fast",
        "device": device_name(device),
        "views": n_views,
        "gaussians": scene["gaussian_means"].shape[1],
        "size": size,
        "ms_per_view": 1e3 * fast["median_s"] / n_views,
        "ms_per_view_exact": 1e3 * exact["median_s"] / n_views,
        "call_seconds": fast["seconds"],
        "call_seconds_exact": exact["seconds"],
        "pairs_per_view_mean": statistics.fmean(fast["pairs"][0]),
        "pairs_per_view_mean_exact": statistics.fmean(exact["pairs"][0]),
        "render_flops_per_view": ops["total"],
        "render_mfu": ops["total"] * vps["fast"] / FP32_FLOPS if on_card else None,
        "render_flops_note": (
            f"float32 operations per fast view: SH evaluation + projection {ops['project_sh']:.4g} (counted by "
            f"running them) + composite_forward {ops['composite']:.4g} (14 per (pair, pixel) evaluation, "
            "2 C + 3 per composited (pair, pixel), counted on each view's kernel outputs); render_mfu "
            "over the H100 SXM float32 peak, 67 TFLOP/s (NVIDIA's data sheet, 700 W)"
        ),
        "launches": {p: timing["launches"] for p, timing in timings.items()},
    }
    train = newest_train_record(record_dir)
    if train is not None:
        result.update({
            "train_step_steps_per_sec": train["value"], "train_step_config": train["metric"],
            "train_step_measured_unix": train.get("measured_unix"), "train_mfu": train.get("train_mfu"),
            "train_step_device": train.get("device"),
        })
    return result


def main(argv=None, device=None) -> dict:
    """Returns the JSON record it prints."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--side", type=int, default=SIDE, help="the depth surface's grid side (Gaussians: 6 side^2)")
    parser.add_argument("--views", type=int, default=N_VIEWS)
    parser.add_argument("--size", type=int, default=SIZE)
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("--records", type=Path, default=RECORD_DIR, help="where bench_train's records are")
    parser.add_argument("--shade", action="store_true", help="time the shade kernel against the plain shade only")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(device, "bench_render")
    scene = make_scene(args.seed, args.side, args.views, device)
    if args.shade:
        result = time_shade(scene, args.size)
        print(f"device: {result['device']}")
        print(json.dumps(result))
        return result
    timings = {p: time_render(scene, args.size, args.iters, p) for p in PRECISIONS}
    result = summarize(scene, args.size, timings, device, args.records)
    print(f"bench_render: {result['views']} views of {result['gaussians']} Gaussians at {args.size}x{args.size}, "
          + "; ".join(f"{p} call seconds {[round(x, 4) for x in t['seconds']]}" for p, t in timings.items()),
          file=sys.stderr)
    print(f"device: {result['device']}")
    print(json.dumps(result))
    if not all(math.isfinite(x) and x > 0 for x in (result["value"], result["value_exact"],
                                                    result["render_flops_per_view"], result["fast_vs_exact_psnr_db"])):
        raise AssertionError(f"bench_render: a non-finite or non-positive result {result}")
    return result


if __name__ == "__main__":
    main()
