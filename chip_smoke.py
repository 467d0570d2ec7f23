"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N] [--profile DIR] [--parent DIR]

1. Builds the CUDA kernels from latentsplat_tpu_torch/csrc (sm_90a).
2. Kernel phase: on the Gaussians of the flagship model's first target
   view, holds each forward kernel against its plain PyTorch version (ids,
   keys, tile ranges and each pixel's last contributor exactly; channels
   and transmittance within 1e-5), times both with CUDA events (a
   kernel's device time with the host queued ahead; duplicate_with_keys'
   launch alone with L2 flushed, and its wrapper with the host's read of
   the pair total) and counts on the card the (pair, pixel) and (pair,
   warp) work the view needs, from which each kernel's bound follows.
   With --parent DIR, builds the forward kernels of the checkout DIR,
   holds them against this tree's and times both in turns on the same
   inputs.
3. Backward kernel phase: on the same view, with a seeded random
   cotangent, holds composite_backward against its plain version (within
   1e-4 of each gradient column's largest value; bit-identical on a
   second launch) and reduce_pairs against its plain version run on the CPU
   (exactly), and times both; reduce_pairs with L2 flushed and warm, in
   three rounds beside index_add_ and segment_reduce.
4. Slice phase: serves one batch (1 scene, 2 context and 4 target views at
   256x256, probabilistic) through `render_full` on the flagship re10k
   model at full width with seeded random weights, checks the output and
   that both forward kernels ran on that path.
5. Train phase: 3 VAE-GAN train steps of the flagship re10k model at full
   width (random weights for the generator, the PatchGAN discriminator and
   LPIPS) on one batch of 2 scenes, 2 context + 4 target views at 256x256,
   at step 125000, where every re10k loss is live. Checks finite losses and
   gradient norms, the adaptive weight in [0, 1], changed parameters of
   both nets and that all four kernels ran; prints seconds per step, a
   stage split and the peak memory.
6. Trainer phase: the program's entry point, `latentsplat_tpu_torch.main.main`,
   on the flagship model at full width and the synthetic dataset at
   256x256: train from step 0 (2 steps, a validation, the 48-view test),
   a resume at step 125000 (2 steps with every loss live, its test), and
   test mode with an evaluation index. Checks the logs, checkpoints, PNGs,
   benchmark.json and that all four kernels ran; prints the benchmark.json
   means, steps/s and peak memory.
7. Small-input checks: the tiled (kernel) render of a narrow model against
   the dense oracle render, and the narrow model's train-step gradients
   through the tiled kernels against those through the dense oracle.

Prints the card's name and power limit, one JSON line describing the
kernels (device ms, plain ms, the bound and its share, the library call's
ms, launches on the main path and in the trainer phase; duplicate_with_keys
also its wrapper's ms), and last `{"ok": true, "device": {...}}`. Any
failed check raises.
Exits non-zero without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

KERNEL_ATOL = 1e-5
# composite_backward sums each pair's partials over the tile in its own
# order and recovers T with one reciprocal, the plain version sums in
# torch.sum's order and divides: float32 rounding of ~256-term sums.
BACKWARD_RTOL = 1e-4
# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Rounded float32 operations (an expf, a min or a compare counts as one)
# that the composite kernels spend per (pair, pixel) evaluation, and per
# composited (pair, pixel) on top: the forward's weight, channel sums and
# transmittance; the backward's value path, 6 + n_ch partials and its
# share of their sum over the tile's pixels.
EVAL_OPS = 14
FLUSH_BYTES = 128 << 20


def forward_composited_ops(n_ch: int) -> int:
    return 2 * n_ch + 3


def backward_composited_ops(n_ch: int) -> int:
    return 3 * n_ch + 29 + (6 + n_ch)
TRAIN_STEP = 125000
FORWARD_KERNELS = ("duplicate_with_keys", "composite_forward")
SMALL_OVERRIDES = [
    "model.encoder.backbone.model=dino_vits8",
    "model.encoder.d_feature=32",
    "model.encoder.epipolar_transformer.num_layers=1",
    "model.encoder.epipolar_transformer.self_attention.num_layers=1",
    "model.autoencoder.block_out_channels=[16,16,16,16]",
]


def make_batch(rng: np.random.Generator, n_context: int, n_target: int, size: int, device,
               scenes: int = 1) -> dict:
    """Cameras on a short horizontal track looking down +z, turned slightly
    inwards, with random images; target views lie between the context views.
    Every scene has the same cameras and its own images."""

    def views(n, positions):
        ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for i, x in enumerate(positions):
            c, s = math.cos(-0.2 * x), math.sin(-0.2 * x)
            ext[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            ext[i, :3, 3] = [x, 0.0, 0.0]
        intr = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (n, 1, 1))
        image = rng.uniform(0.0, 1.0, (scenes, n, size, size, 3)).astype(np.float32)
        arrays = {"image": image, "extrinsics": np.repeat(ext[None], scenes, 0),
                  "intrinsics": np.repeat(intr[None], scenes, 0),
                  "near": np.ones((scenes, n), np.float32), "far": np.full((scenes, n), 100.0, np.float32)}
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    return {
        "context": views(n_context, np.linspace(-0.2, 0.2, n_context)),
        "target": views(n_target, np.linspace(-0.15, 0.15, n_target)),
    }


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def like_trained(model, peaked_depth: bool = True):
    """Random weights that look like trained ones where it matters: the
    zero-initialized leaves get random values too, so nothing rides on a
    zero, and (with `peaked_depth`) the depth head is scaled so that each
    pixel's depth pdf is peaked, as a trained one is: the scene is mostly
    opaque and the compositor's early stop is exercised."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("cls_token", "pos_embed")) or "skip_conv" in name:
                p.normal_(0.0, 0.02)
        if peaked_depth:
            model.encoder.depth_predictor.projection.weight.mul_(50.0)
    return model


def build_model(cfg, seed: int, device, peaked_depth: bool = True):
    from latentsplat_tpu_torch.model.latentsplat import LatentSplat

    torch.manual_seed(seed)
    return like_trained(LatentSplat(cfg.model).to(device).eval(), peaked_depth)


def cuda_ms(fn, repeats: int) -> float:
    """Median milliseconds of `fn` over `repeats` runs, timed with CUDA events
    around each call: the host's time inside the call counts too."""
    fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, repeats: int = 20, flush: torch.Tensor | None = None) -> float:
    """Median device milliseconds of one `fn` call. All calls are queued
    behind a sleeping kernel, so the host's time in them (checks,
    allocation, the ctypes call) overlaps the device's and is not counted;
    with `flush` (>= 64 MB) written before each call, L2 starts cold. `fn`
    must not wait for the device."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 21
    for _ in range(6):
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(repeats)]
        asleep = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        asleep.record()
        for start, end in pairs:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()
        queued_ahead = not asleep.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return statistics.median(start.elapsed_time(end) for start, end in pairs)
        cycles *= 4
    raise RuntimeError("device_ms: the host never got ahead of the device")


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """Least milliseconds one H100 SXM could take: the larger of the bytes
    over HBM's rate and the operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name: str, source: str, replaces: str, err: float, ms: float, plain_ms: float,
          n_bytes: int, n_ops: int, library_ms: float | None = None, **extra: float) -> dict:
    """One kernel's record of the `kernels` JSON line (launches come later)."""
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"{name}: bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes, {n_ops} operations), "
          f"{ms:.4f} ms: {bound_ms / ms:.1%} of the bound")
    return {"name": name, "route": "cuda", "source": f"latentsplat_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
            "library_ms": library_ms, **extra}


def warp_blocks(x: torch.Tensor) -> torch.Tensor:
    """(..., 256) row-major tile pixels -> (..., 8, 32) by the tile's 4x8-pixel
    blocks, which composite_forward's warps own: pixel 16 r + c is lane
    8 (r % 4) + c % 8 of block 2 (r // 4) + c // 8."""
    from latentsplat_tpu_torch.ops.rasterize.kernels import TILE, WARP_COLS, WARP_ROWS

    x = x.reshape(*x.shape[:-1], TILE // WARP_ROWS, WARP_ROWS, TILE // WARP_COLS, WARP_COLS)
    return x.transpose(-3, -2).reshape(*x.shape[:-4], TILE * TILE // 32, 32)


def composite_work(view: dict) -> dict:
    """The (pair, pixel) work this view's inputs need, counted on the card:
    the forward's evaluations (each pixel up to its `last` if it
    saturated, else to its tile's end), the backward's (each pixel up to
    its `last`), the composited (pair, pixel) combinations and the pairs
    some pixel composited. Then the (pair, warp) steps of each composite
    kernel's warps: the forward's 4x8-pixel warps (all pairs up to the
    warp's stop, those whose footprint box meets the warp's pixels, those
    where some lane composited) and the backward's two-row warps (all
    pairs up to the tile's largest `last`, those below the warp's largest
    `last`, those where some lane composited), with each kernel's median
    and longest tile walk. Raises if a lane composited a pair whose box
    misses its warp: the forward's cull must drop no such pair."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    gids, ranges, attrs, tiles_x, (h, w) = (view[k] for k in ("gids", "ranges", "attrs", "tiles_x", "shape"))
    tiles_y = h // kernels.TILE
    num_tiles = tiles_x * tiles_y
    n_warps = kernels.PIX // 32
    device = attrs.device
    starts, stops = ranges[:-1].long(), ranges[1:].long()
    last = kernels.tile(view["last"], tiles_x, tiles_y).long()                   # (T, 256)
    saturated = kernels.tile(view["t_final"], tiles_x, tiles_y) < kernels.TRANSMITTANCE_MIN
    forward_end = torch.where(saturated, last, stops[:, None])                   # each pixel's stop
    warp_end = warp_blocks(forward_end).max(dim=2).values                        # (T, 8)
    px, py = kernels._tile_pixels(num_tiles, tiles_x, device)
    # Top-left pixel of each forward warp's 4x8 block, (T, 8).
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
    work = {
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
    print("composite work (counted on the card): " + ", ".join(f"{k} {v}" for k, v in work.items()))
    if culled_composited:
        raise AssertionError(f"{culled_composited} composited (pair, warp) steps lie outside the footprint box")
    return work


def kernel_phase(model, batch, seed: int, parent: str | None = None) -> tuple[dict, list[dict]]:
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.ops.rasterize.api import view_channels
    from latentsplat_tpu_torch.ops.rasterize.camera import project_gaussians_to_screen
    from latentsplat_tpu_torch.ops.rasterize.tiled import pack_attributes, sort_pairs, tile_rects

    gen = torch.Generator(device=batch["target"]["image"].device).manual_seed(seed)
    with torch.no_grad():
        shimmed = model.data_shim(batch)
        gaussians = model.encoder(shimmed["context"], 0, generator=gen).sample(gen)
        target = shimmed["target"]
        ext, intr, near = target["extrinsics"][0, 0], target["intrinsics"][0, 0], target["near"][0, 0]
        h, w = target["image"].shape[2:4]
        channels = view_channels(
            gaussians.means[0], gaussians.color_harmonics[0], gaussians.feature_harmonics[0], ext[:3, 3]
        )
        s = 1.0 / near
        ext_s = ext.clone()
        ext_s[:3, 3] *= s
        sg = project_gaussians_to_screen(
            gaussians.means[0] * s, gaussians.covariances[0] * (s * s), gaussians.opacities[0],
            channels, ext_s, intr, (h, w),
        )
    tiles_x, tiles_y = w // 16, h // 16
    counts, base, nx, mask = tile_rects(sg, tiles_x, tiles_y)
    depth = sg.depth.contiguous()
    g_count, p_count = sg.num_gaussians, int(counts.sum())
    print(f"kernel phase: {g_count} Gaussians, {p_count} pairs, "
          f"{channels.shape[-1] + 1} channels, {tiles_x * tiles_y} tiles")

    # duplicate_with_keys
    gids, keys = kernels.duplicate_with_keys(counts, mask, base, nx, depth, tiles_x, 9)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, depth, tiles_x, 9)
    torch.cuda.synchronize()
    if not (torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)):
        raise AssertionError("duplicate_with_keys disagrees with its plain version")
    dup_err = max((gids - ref_gids).abs().max().item(), (keys - ref_keys).abs().max().item())
    sorted_gids, ranges, order = sort_pairs(gids, keys, tiles_x * tiles_y)
    ref_sorted, ref_ranges, _ = sort_pairs(ref_gids, ref_keys, tiles_x * tiles_y)
    if not (torch.equal(sorted_gids, ref_sorted) and torch.equal(ranges, ref_ranges)):
        raise AssertionError("sorted pairs or tile ranges differ")
    # The kernel's launch alone, as the wrapper makes it once the pair total
    # is known, with L2 flushed; then the whole wrapper, whose read of the
    # total waits on the device.
    flush = torch.empty(FLUSH_BYTES // 4, device=depth.device)
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    dup_args = (offsets, mask, base, nx, depth, tiles_x, torch.empty_like(gids), torch.empty_like(keys))
    dup_ms = device_ms(lambda: kernels._launch_duplicate_with_keys(*dup_args), flush=flush)
    dup_wrapper_ms = cuda_ms(lambda: kernels.duplicate_with_keys(counts, mask, base, nx, depth, tiles_x, 9), 20)
    dup_plain_ms = cuda_ms(
        lambda: kernels.duplicate_with_keys_reference(counts, mask, base, nx, depth, tiles_x, 9), 5
    )
    # Yardsticks: the kernel warm, a one-element fill (the least device_ms
    # reads for any launch) and a copy reading and writing as many bytes as
    # the kernel's bound counts, L2 flushed.
    dup_warm_ms = device_ms(lambda: kernels._launch_duplicate_with_keys(*dup_args))
    tiny = torch.empty(1, device=depth.device)
    n_copy = (16 * g_count + 12 * p_count) // 8
    copy_src, copy_dst = torch.empty(n_copy, device=depth.device), torch.empty(n_copy, device=depth.device)
    print(f"duplicate_with_keys: exact match; {dup_ms:.4f} ms (device, L2 flushed), {dup_warm_ms:.4f} warm, "
          f"wrapper {dup_wrapper_ms:.4f} ms (host read included: {dup_wrapper_ms - dup_ms:.4f} ms more) vs "
          f"plain {dup_plain_ms:.4f} ms; a one-element fill {device_ms(tiny.zero_):.4f} ms, a copy of as many "
          f"bytes {device_ms(lambda: copy_dst.copy_(copy_src), flush=flush):.4f} ms (L2 flushed)")

    # composite_forward
    attrs = pack_attributes(sg)
    comp_args = (sorted_gids, ranges, attrs, tiles_x, (h, w))
    out = kernels.composite_forward(*comp_args)
    ref = kernels.composite_forward_reference(*comp_args)
    torch.cuda.synchronize()
    err_ch = (out[0] - ref[0]).abs().max().item()
    err_t = (out[1] - ref[1]).abs().max().item()
    last_mismatch = int((out[2] != ref[2]).sum())
    saturated = (ref[1] < kernels.TRANSMITTANCE_MIN).float().mean().item()
    print(f"composite_forward: max |channels err| {err_ch:.3e}, max |T err| {err_t:.3e}, "
          f"last-contributor mismatches {last_mismatch}, saturated pixels {saturated:.3f}")
    if not (err_ch <= KERNEL_ATOL and err_t <= KERNEL_ATOL):
        raise AssertionError(f"composite_forward disagrees with its plain version beyond {KERNEL_ATOL}")
    if last_mismatch:
        raise AssertionError("composite_forward's last contributors differ from its plain version's")
    comp_ms = device_ms(lambda: kernels.composite_forward(*comp_args))
    comp_plain_ms = cuda_ms(lambda: kernels.composite_forward_reference(*comp_args), 3)
    print(f"composite_forward: {comp_ms:.4f} ms (device) vs plain {comp_plain_ms:.4f} ms")
    view = {"gids": sorted_gids, "ranges": ranges, "order": order, "counts": counts, "attrs": attrs,
            "tiles_x": tiles_x, "shape": (h, w), "t_final": out[1], "last": out[2]}
    view["work"] = work = composite_work(view)
    print(f"composite_forward: {comp_ms * 1e6 / work['forward_tile_walk_max']:.1f} ns per pair of the "
          f"longest tile walk")
    if parent:
        parent_comparison(parent, dup_args, (gids, keys), comp_args, out, flush)
    n_ch, row, plane = attrs.shape[1] - 6, attrs.shape[1], h * w
    return view, [
        # Mask, base, nx and depth of each Gaussian, one exclusive offset per
        # block of 512 Gaussians, and 12 bytes per pair written.
        entry("duplicate_with_keys", "duplicate_with_keys.cu", "latentsplat_tpu/ops/rasterize/expand.py:159",
              float(dup_err), dup_ms, dup_plain_ms,
              n_bytes=16 * g_count + 8 * math.ceil(g_count / 512) + 12 * p_count, n_ops=0,
              wrapper_ms=dup_wrapper_ms),
        entry("composite_forward", "composite_forward.cu",
              "latentsplat_tpu/ops/rasterize/pallas_kernels.py:399", max(err_ch, err_t), comp_ms,
              comp_plain_ms,
              n_bytes=4 * p_count + 4 * ranges.numel() + 4 * row * g_count + 4 * (n_ch + 2) * plane,
              n_ops=EVAL_OPS * work["forward_evaluations"] + forward_composited_ops(n_ch) * work["composited"]),
    ]


def backward_kernel_phase(view: dict, seed: int) -> list[dict]:
    """composite_backward and reduce_pairs at the shapes of one flagship
    view, against their plain versions, with a seeded random cotangent."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    gids, ranges, order, attrs, tiles_x, shape = (
        view[k] for k in ("gids", "ranges", "order", "attrs", "tiles_x", "shape"))
    device = attrs.device
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    g_out = torch.randn((attrs.shape[1] - 6, *shape), generator=gen, device=device)
    g_t = torch.randn(shape, generator=gen, device=device)
    args = (gids, ranges, order, attrs, tiles_x, shape, view["last"], view["t_final"], g_out, g_t)
    d_rows = kernels.composite_backward(*args)
    ref = kernels.composite_backward_reference(*args)
    torch.cuda.synchronize()
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    bwd_err = ((d_rows - ref).abs() / scale).max().item()
    print(f"composite_backward: {gids.shape[0]} pair rows of {attrs.shape[1]}, max error relative to "
          f"each column's largest value {bwd_err:.3e} (tolerance {BACKWARD_RTOL})")
    if not bwd_err <= BACKWARD_RTOL:
        raise AssertionError("composite_backward disagrees with its plain version")
    if not torch.equal(d_rows, kernels.composite_backward(*args)):
        raise AssertionError("composite_backward is not deterministic")
    bwd_ms = device_ms(lambda: kernels.composite_backward(*args))
    bwd_plain_ms = cuda_ms(lambda: kernels.composite_backward_reference(*args), 3)
    print(f"composite_backward: {bwd_ms:.4f} ms (device) vs plain {bwd_plain_ms:.4f} ms; "
          f"{bwd_ms * 1e6 / view['work']['tile_walk_max']:.1f} ns per pair of the longest tile walk")

    counts = view["counts"]
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    rows = kernels.reduce_pairs(d_rows, offsets)
    # The plain version on the CPU adds each Gaussian's rows in slot order,
    # as the kernel does: the same bits.
    ref_rows = kernels.reduce_pairs_reference(d_rows.cpu(), offsets.cpu())
    torch.cuda.synchronize()
    red_err = (rows.cpu() - ref_rows).abs().max().item()
    print(f"reduce_pairs: {rows.shape[0]} Gaussians, max abs error {red_err:.3e} (exact expected)")
    if not torch.equal(rows.cpu(), ref_rows):
        raise AssertionError("reduce_pairs disagrees with its plain version")
    # Yardsticks, never called by the port: index_add_ of the sorted rows by
    # Gaussian id (what the plain version was), and segment_reduce of the
    # Gaussian-major rows.
    g_count, row = rows.shape
    sorted_rows, sorted_ids, lengths = d_rows[order], gids.long(), counts.long()

    def index_add():
        return torch.zeros((g_count, row), device=device).index_add_(0, sorted_ids, sorted_rows)

    def segment_reduce():
        return torch.segment_reduce(d_rows, "sum", lengths=lengths, axis=0, unsafe=True)

    lib_err = {f.__name__: ((f() - rows).abs().max() / rows.abs().max()).item() for f in (index_add, segment_reduce)}
    print(f"reduce_pairs yardsticks, max error relative to the largest sum: {lib_err}")
    flush = torch.empty(FLUSH_BYTES // 4, device=device)
    # The card's streaming rate at this size: a copy that reads and writes
    # as many bytes in all as the kernel's bound counts.
    n_bytes = 4 * row * d_rows.shape[0] + 8 * g_count + 4 * row * g_count
    copy_src = torch.empty(n_bytes // 8, dtype=torch.float32, device=device)
    copy_dst = torch.empty_like(copy_src)
    rounds = []
    for _ in range(3):
        rounds.append({
            "kernel": device_ms(lambda: kernels.reduce_pairs(d_rows, offsets), flush=flush),
            "index_add_": device_ms(index_add, flush=flush),
            "segment_reduce": device_ms(segment_reduce, flush=flush),
            "kernel_warm": device_ms(lambda: kernels.reduce_pairs(d_rows, offsets)),
            "index_add_warm": device_ms(index_add),
            "segment_reduce_warm": device_ms(segment_reduce),
            "copy_same_bytes": device_ms(lambda: copy_dst.copy_(copy_src), flush=flush),
        })
    for i, r in enumerate(rounds):
        print(f"reduce_pairs round {i} (device ms, L2 flushed / warm): "
              + ", ".join(f"{k} {v:.4f}" for k, v in r.items()))
    wins = sum(r["kernel"] <= min(r["index_add_"], r["segment_reduce"]) for r in rounds)
    red_ms = statistics.median(r["kernel"] for r in rounds)
    library_ms = min(statistics.median(r[k] for r in rounds) for k in ("index_add_", "segment_reduce"))
    red_plain_ms = cuda_ms(lambda: kernels.reduce_pairs_reference(d_rows, offsets), 5)
    print(f"reduce_pairs: {red_ms:.4f} ms (device, L2 flushed), warm "
          f"{statistics.median(r['kernel_warm'] for r in rounds):.4f} ms; library {library_ms:.4f} ms; "
          f"no slower than the library in {wins} of {len(rounds)} rounds; plain on the card "
          f"{red_plain_ms:.4f} ms")

    work, n_ch, p_count = view["work"], attrs.shape[1] - 6, gids.shape[0]
    plane = shape[0] * shape[1]
    return [
        entry("composite_backward", "composite_backward.cu",
              "latentsplat_tpu/ops/rasterize/pallas_kernels.py:667", (d_rows - ref).abs().max().item(),
              bwd_ms, bwd_plain_ms,
              n_bytes=4 * p_count + 4 * ranges.numel() + 8 * p_count + 4 * (n_ch + 6) * attrs.shape[0]
              + 4 * (n_ch + 3) * plane + 4 * (n_ch + 6) * p_count,
              n_ops=EVAL_OPS * work["backward_evaluations"] + backward_composited_ops(n_ch) * work["composited"]),
        entry("reduce_pairs", "reduce_pairs.cu", "latentsplat_tpu/ops/rasterize/expand.py:254", red_err,
              red_ms, red_plain_ms, n_bytes=4 * row * p_count + 8 * g_count + 4 * row * g_count, n_ops=0,
              library_ms=library_ms),
    ]


def parent_comparison(parent: str, dup_args: tuple, dup_out: tuple, comp_args: tuple, comp_out: tuple,
                      flush: torch.Tensor) -> None:
    """Builds the forward kernels of the checkout `parent` (the same C
    interfaces as this tree's), holds their outputs against this tree's
    (ids, keys and last contributors exactly, channels and T within
    KERNEL_ATOL) and times both on the same inputs in turns (parent, this
    tree, this tree, parent): duplicate_with_keys' launch with L2 flushed,
    composite_forward as the kernel phase times it."""
    import ctypes

    from latentsplat_tpu_torch import cuda_build
    from latentsplat_tpu_torch.ops.rasterize import kernels

    sources = [Path(parent) / "latentsplat_tpu_torch" / "csrc" / f
               for f in ("duplicate_with_keys.cu", "composite_forward.cu")]
    lib_path = cuda_build.BUILD_DIR.parent / "parent_kernels" / "libparent.so"
    start = time.perf_counter()
    cuda_build.compile_library(sources, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.duplicate_with_keys.argtypes = [i, p, p, p, p, p, i, p, p, p]
    lib.composite_forward.argtypes = [i, i, p, p, p, i, i, i, p, p, p, p]
    lib.duplicate_with_keys.restype = lib.composite_forward.restype = i
    print(f"parent kernels from {parent} built in {time.perf_counter() - start:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  parent ptxas:", line.strip())

    stream = torch.cuda.current_stream().cuda_stream
    offsets, mask, base, nx, depth, tiles_x, _, _ = dup_args
    old_ids, old_keys = (torch.empty_like(x) for x in dup_out)

    def parent_duplicate():
        cuda_build.check(lib.duplicate_with_keys(
            offsets.shape[0], offsets.data_ptr(), mask.data_ptr(), base.data_ptr(), nx.data_ptr(),
            depth.data_ptr(), tiles_x, old_ids.data_ptr(), old_keys.data_ptr(), stream),
            "parent duplicate_with_keys")

    gids, ranges, attrs, _, (h, w) = comp_args
    old_out = tuple(torch.empty_like(x) for x in comp_out)

    def parent_composite():
        cuda_build.check(lib.composite_forward(
            attrs.shape[1] - 6, ranges.numel() - 1, gids.data_ptr(), ranges.data_ptr(), attrs.data_ptr(),
            tiles_x, h, w, *(x.data_ptr() for x in old_out), stream), "parent composite_forward")

    parent_duplicate()
    parent_composite()
    torch.cuda.synchronize()
    if not (torch.equal(old_ids, dup_out[0]) and torch.equal(old_keys, dup_out[1])):
        raise AssertionError("the parent's duplicate_with_keys and this tree's disagree")
    errs = [(a - b).abs().max().item() for a, b in zip(old_out[:2], comp_out[:2])]
    same = all(torch.equal(a, b) for a, b in zip(old_out, comp_out))
    print(f"parent vs this tree: duplicate_with_keys ids and keys equal; composite_forward max |channels "
          f"diff| {errs[0]:.3e}, max |T diff| {errs[1]:.3e}, last equal "
          f"{torch.equal(old_out[2], comp_out[2])}, the same bits {same}")
    if not (max(errs) <= KERNEL_ATOL and torch.equal(old_out[2], comp_out[2])):
        raise AssertionError("the parent's composite_forward and this tree's disagree")
    timings = {"duplicate_with_keys": [], "composite_forward": []}
    for turn in ("parent", "this tree", "this tree", "parent"):
        if turn == "parent":
            dup = device_ms(parent_duplicate, flush=flush)
            comp = device_ms(parent_composite)
        else:
            dup = device_ms(lambda: kernels._launch_duplicate_with_keys(*dup_args), flush=flush)
            comp = device_ms(lambda: kernels.composite_forward(*comp_args))
        timings["duplicate_with_keys"].append((turn, dup))
        timings["composite_forward"].append((turn, comp))
    for key, values in timings.items():
        print(f"parent vs this tree, {key} (device ms" + (", L2 flushed" if key == "duplicate_with_keys" else "")
              + "): " + ", ".join(f"{turn} {v:.4f}" for turn, v in values))


def slice_phase(model, batch, seed: int, profile_dir: str | None = None) -> dict:
    from latentsplat_tpu_torch.model.latentsplat import render_full
    from latentsplat_tpu_torch.ops.rasterize import kernels

    stage_s: dict[str, float] = {}

    @contextmanager
    def timer(name):
        torch.cuda.synchronize()
        start = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stage_s[name] = time.perf_counter() - start

    gen = torch.Generator(device=batch["target"]["image"].device)
    render_full(model, batch, generator=gen.manual_seed(seed))    # warm-up
    for key in kernels.launch_counts:
        kernels.launch_counts[key] = 0
    out = render_full(model, batch, generator=gen.manual_seed(seed), timer=timer)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    image = out["image"]
    n_target = batch["target"]["image"].shape[1]
    expected = (1, n_target, *batch["target"]["image"].shape[2:4], 3)
    if tuple(image.shape) != expected:
        raise AssertionError(f"image shape {tuple(image.shape)} != {expected}")
    for key in ("image", "render", "depth"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"non-finite values in {key}")
    if min(launches[k] for k in FORWARD_KERNELS) < 1:
        raise AssertionError(f"a kernel of the serving path did not run: {launches}")
    pairs = out["num_pairs"].reshape(-1).tolist()
    print(f"slice: image {tuple(image.shape)}, mean {image.mean().item():.4f}, "
          f"render mean {out['render'].mean().item():.4f}, pairs per view {pairs}")
    print("slice stage seconds (host clock around synchronized stages): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stage_s.items())
          + f"; per target view: render {stage_s['decoder'] / n_target:.4f}, "
          f"VAE decode {stage_s['autoencoder_decoder'] / n_target:.4f}")
    print(f"slice launches: {launches}")
    if profile_dir:
        from latentsplat_tpu_torch.model.latentsplat import render_full

        profile_once(
            "render_full", lambda timer: render_full(model, batch, generator=gen.manual_seed(seed), timer=timer),
            profile_dir,
        )
    return launches


# Device activity in a Chrome trace of torch.profiler.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RASTER_KERNELS = ("duplicate_with_keys", "composite_forward", "composite_backward", "reduce_pairs",
                   "RadixSort")
_TRACE_KEEP_BYTES = 16 << 20


def trace_breakdown(trace: dict) -> list[str]:
    """Per stage marked with record_function: the device work it launched
    (each kernel, copy or fill goes to the stage whose host span holds its
    launch, matched by correlation id), its device span from first start
    to last end, the busy share of that span, and the top kernels."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    stages = [e for e in events if e.get("cat") == "user_annotation"]
    launch_ts = {
        e["args"]["correlation"]: e["ts"] for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
    }
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
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
    # The rasterizer's kernels (the port's four and the library sort).
    raster: dict[str, list[float]] = {}
    for e in device:
        name = next((k for k in _RASTER_KERNELS if k in e["name"]), None)
        if name:
            raster.setdefault(name, []).append(e["dur"])
    busy_us = sum(e["dur"] for e in device)
    raster_us = sum(sum(v) for v in raster.values())
    lines.append(
        f"rasterizer kernels: {raster_us / 1e3:.3f} ms, {raster_us / max(busy_us, 1e-9):.2%} of device busy; "
        + "; ".join(f"{k} {sum(v) / 1e3:.3f} ms in {len(v)} launches" for k, v in raster.items())
    )
    return lines


def profile_once(label: str, fn, out_dir: str) -> None:
    """Runs fn(timer=record_function) once more under torch.profiler and
    writes an operator table, the per-stage breakdown and (if small) a
    gzipped Chrome trace to `out_dir`; prints the breakdown."""
    import gzip

    from torch.profiler import ProfilerActivity, profile, record_function

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn(record_function)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    (out / f"{label}_ops.txt").write_text(prof.key_averages().table(sort_by="cuda_time_total", row_limit=50))
    raw = out / f"{label}_trace.json"
    prof.export_chrome_trace(str(raw))
    lines = trace_breakdown(json.loads(raw.read_text()))
    (out / f"{label}_stages.txt").write_text("\n".join(lines) + "\n")
    packed = gzip.compress(raw.read_bytes())
    raw.unlink()
    if len(packed) <= _TRACE_KEEP_BYTES:
        (out / f"{label}_trace.json.gz").write_bytes(packed)
    print(f"profile {label}: {wall_ms:.3f} ms on the host clock under the profiler; files in {out_dir}")
    for line in lines:
        print(f"  {line}")


def build_trainer(cfg, seed: int, device, peaked_depth: bool = True):
    """The train state that `Trainer.init_state` builds for `cfg` with
    `seed` (generator, PatchGAN discriminator and LPIPS with random weights,
    their optimizers, the preset's losses), the generator as `like_trained`
    leaves it; returns (state, losses, train_step)."""
    from latentsplat_tpu_torch.training.step import make_train_step
    from latentsplat_tpu_torch.training.trainer import Trainer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trainer = Trainer(dataclasses.replace(cfg, seed=seed), tmp, device)
        state = trainer.init_state()
        trainer.logger.close()
    like_trained(state.model.train(), peaked_depth)
    g = cfg.optimizer.generator
    return state, trainer.losses, make_train_step(trainer.losses, g.skip_loss_spike_factor, g.skip_loss_spike_patience)


def train_phase(cfg, seed: int, device, profile_dir: str | None = None, size: int = 256) -> dict:
    """3 flagship train steps on one batch; returns the kernels' launch
    counts over those steps."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    scenes = 2
    state, _, train_step = build_trainer(cfg, seed, device)
    # As in a run resumed at this step: the optimizers have counted as many
    # updates (their moments start at zero), so the warm-up is over.
    for opt in (state.opt_gen, state.opt_disc):
        for group in opt.state.values():
            group["count"].fill_(TRAIN_STEP)
    batch = state.model.data_shim(make_batch(np.random.default_rng(seed + 2), 2, 4, size, device, scenes))
    n_gen = sum(p.numel() for p in state.model.parameters())
    n_disc = sum(p.numel() for p in state.discriminator.parameters())
    print(f"train phase: {scenes} scenes, 2 context + 4 target views at {size}x{size}, step {TRAIN_STEP}; "
          f"generator {n_gen} parameters, discriminator {n_disc}")
    before = {
        "generator": [p.detach().clone() for p in state.model.parameters()],
        "discriminator": [p.detach().clone() for p in state.discriminator.parameters()],
    }
    stage_s: dict[str, list[float]] = {}

    @contextmanager
    def timer(name):
        torch.cuda.synchronize()
        start = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stage_s.setdefault(name, []).append(time.perf_counter() - start)

    gen = torch.Generator(device=device).manual_seed(seed + 3)
    for key in kernels.launch_counts:
        kernels.launch_counts[key] = 0
    torch.cuda.reset_peak_memory_stats()
    step_s, all_logs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, logs = train_step(state, batch, TRAIN_STEP, generator=gen, timer=timer)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
        all_logs.append({k: float(v) for k, v in logs.items()})
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    for i, logs in enumerate(all_logs):
        print(f"train step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(logs.items())))
    for logs in all_logs:
        bad = [k for k, v in logs.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite train logs: {bad}")
        if not 0.0 <= logs["target_combined/adaptive_weight"] <= 1.0:
            raise AssertionError("adaptive weight outside [0, 1]")
    for net, module in (("generator", state.model), ("discriminator", state.discriminator)):
        same = [n for (n, p), q in zip(module.named_parameters(), before[net]) if torch.equal(p.detach(), q)]
        changed = len(before[net]) - len(same)
        print(f"train: {net} tensors changed {changed} of {len(before[net])}; unchanged {same[:8]}")
        if changed == 0:
            raise AssertionError(f"the {net}'s parameters did not change")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the train path did not run: {launches}")
    later = step_s[1:]
    print(f"train seconds per step: {[round(x, 4) for x in step_s]}; median after the first "
          f"{statistics.median(later):.4f} (host clock around synchronized steps, stage timers on)")
    print("train stage seconds, median after the first step: " + ", ".join(
        f"{k} {statistics.median(v[1:]):.4f}" for k, v in stage_s.items()))
    print(f"train peak memory allocated: {peak / 2**30:.3f} GiB")
    print(f"train launches: {launches}")
    if profile_dir:
        profile_once(
            "train_step", lambda timer: train_step(state, batch, TRAIN_STEP, generator=gen, timer=timer),
            profile_dir,
        )
    return launches


def read_records(run: Path) -> list[dict]:
    return [json.loads(line) for line in (run / "local" / "metrics.jsonl").read_text().splitlines()]


def check_test_output(root: Path, n_views: int) -> dict:
    """One 256x256 RGB PNG per target view and benchmark.json with the three
    tags; returns the tags' mean seconds."""
    from latentsplat_tpu_torch.misc.image_io import load_image

    pngs = sorted(root.rglob("color/*.png"))
    if len(pngs) != n_views:
        raise AssertionError(f"{root}: {len(pngs)} color PNGs, expected {n_views}")
    bad = [p for p in pngs if load_image(p).shape != (256, 256, 3)]
    if bad:
        raise AssertionError(f"PNGs of the wrong shape: {bad[:3]}")
    bench = json.loads((root / "benchmark.json").read_text())
    if set(bench) != {"encoder", "decoder", "autoencoder_decoder"}:
        raise AssertionError(f"benchmark.json tags: {sorted(bench)}")
    means = {tag: statistics.mean(v) for tag, v in bench.items()}
    print(f"  {root.name}: {len(pngs)} PNGs of 256x256x3; benchmark.json means (s): "
          + ", ".join(f"{k} {v:.4f} (median {statistics.median(bench[k]):.4f}, {len(bench[k])} entries)"
                      for k, v in means.items())
          + f"; peak_memory.json {json.loads((root / 'peak_memory.json').read_text())}")
    return means


def trainer_phase(seed: int, device) -> tuple[dict, dict]:
    """The entry point, `latentsplat_tpu_torch.main.main`, on the flagship
    re10k model at full width and the synthetic dataset at 256x256 (4
    scenes of 48 frames, so the preset's bounded gaps fit at steps 0 and
    125000; train batch 2): (a) mode=train from step 0 for 2 steps with a
    validation and a checkpoint at step 2, then the test that train mode
    runs (the bounded sampler's test stage: 48 target views a scene); (b) a
    resume from a checkpoint at step 125000, where every re10k loss is live,
    for 2 steps, then its test; (c) mode=test from (a)'s checkpoint with an
    evaluation index of 2 context and 3 target views a scene. The weights
    are random from `seed`, the generator's as `like_trained` leaves them
    (loaded into (a) as its `checkpointing.load`). Checkpoints go to a
    temporary directory that is deleted. Returns the kernels' launch counts
    over (a)+(b) and over (c)."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.main import main as run_main
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.training.checkpointing import latest_checkpoint, save_checkpoint
    from latentsplat_tpu_torch.training.trainer import Trainer

    print(f"trainer phase on {card()}")
    sampler = dataclasses.asdict(load_config("re10k").dataset.view_sampler)
    data = {"name": "synthetic", "num_scenes": 4, "num_frames": 48, "image_shape": [256, 256],
            "view_sampler": sampler}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        tmp = Path(tmp)
        common = [f"seed={seed}", f"dataset={json.dumps(data)}", "trainer.log_every_n_steps=1",
                  "checkpointing.every_n_train_steps=2"]

        def call(name: str, *extra: str) -> Path:
            args = ["+experiment=re10k", *common, f"output_dir={tmp / name}", f"test.output_path={tmp / name / 'test'}",
                    *extra]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            run = run_main(args, device=device)
            print(f"trainer phase ({name}): main(... {' '.join(extra)}) took {time.perf_counter() - start:.2f} s")
            return run

        def state_of(*extra: str):
            trainer = Trainer(load_config("re10k", common + list(extra)), tmp / "prep", device)
            return trainer, trainer.init_state()

        # The starting generator, saved the way every checkpoint is saved.
        trainer, state = state_of()
        like_trained(state.model)
        init = save_checkpoint(state, tmp / "prep", 0)
        trainer.logger.close()
        del trainer, state

        for key in kernels.launch_counts:
            kernels.launch_counts[key] = 0
        run_a = call("a", "mode=train", f"checkpointing.load={init}", "trainer.max_steps=2",
                     "trainer.val_check_interval=2")
        init.unlink()    # ~1.9 GB each at full width
        ckpt_a = latest_checkpoint(run_a / "checkpoints")
        if ckpt_a is None or ckpt_a.name != "step_00000002":
            raise AssertionError(f"(a) wrote no checkpoint at step 2: {ckpt_a}")
        records = read_records(run_a)
        val = [r for r in records if "val/psnr_deterministic" in r]
        if len(val) != 1 or not all(math.isfinite(val[0][k]) for k in ("val/psnr_probabilistic", "val/psnr_deterministic")):
            raise AssertionError(f"(a) validation: {val}")
        if not (run_a / "local" / "comparison" / "000002.png").exists():
            raise AssertionError("(a) wrote no comparison grid")
        train_a = [r for r in records if "generator/total" in r]
        print(f"  (a) validation at step 2: " + ", ".join(f"{k} {v:.4f}" for k, v in val[0].items() if k.startswith("val/")))
        means_a = check_test_output(tmp / "a" / "test" / "latentsplat_tpu", 4 * 48)

        # As a run resumed at step 125000 would have it: (a)'s state with the
        # step and both optimizers' counts at 125000 (the moments as they are).
        trainer, state = state_of(f"checkpointing.load={ckpt_a}", "checkpointing.resume=true")
        if trainer.step != 2:
            raise AssertionError(f"(a)'s checkpoint resumed at step {trainer.step}")
        for opt in (state.opt_gen, state.opt_disc):
            for group in opt.state.values():
                group["count"].fill_(TRAIN_STEP)
        resume = save_checkpoint(state, tmp / "prep", TRAIN_STEP)
        trainer.logger.close()
        del trainer, state
        run_b = call("b", "mode=train", f"checkpointing.load={resume}", "checkpointing.resume=true",
                     f"trainer.max_steps={TRAIN_STEP + 2}")
        fit_launches = dict(kernels.launch_counts)
        resume.unlink()
        train_b = read_records(run_b)
        if [r["step"] for r in train_b] != [TRAIN_STEP + 1, TRAIN_STEP + 2]:
            raise AssertionError(f"(b) logged steps {[r['step'] for r in train_b]}")
        if latest_checkpoint(run_b / "checkpoints").name != f"step_{TRAIN_STEP + 2:08d}":
            raise AssertionError("(b) did not end at step 125002")
        live = ("target_render_image/mse", "target_render_image/lpips", "target_combined/l1",
                "target_combined/lpips", "target_combined/generator", "discriminator/total")
        if not all(k in r for r in train_b for k in live):
            raise AssertionError(f"(b): not every re10k loss is live: {sorted(train_b[0])}")
        for label, rows in (("a", train_a), ("b", train_b)):
            bad = [r["step"] for r in rows if not math.isfinite(r["generator/total"])]
            if bad or not rows:
                raise AssertionError(f"({label}) non-finite generator/total at steps {bad}")
            for r in rows:
                print(f"  ({label}) step {r['step']}: steps_per_sec {r['steps_per_sec']:.4f}, "
                      + ", ".join(f"{k} {r[k]:.5g}" for k in ("generator/total", "discriminator/total",
                                                             "target_combined/adaptive_weight") if k in r))
        means_b = check_test_output(tmp / "b" / "test" / "latentsplat_tpu", 4 * 48)

        index = tmp / "evaluation_index.json"
        index.write_text(json.dumps({f"synthetic_{i:04d}": {"context": [2, 40], "target": [9, 21, 33]}
                                     for i in range(4)}))
        for key in kernels.launch_counts:
            kernels.launch_counts[key] = 0
        call("c", "mode=test", f"checkpointing.load={ckpt_a}", "wandb.name=evaluation",
             f"dataset.view_sampler={{name: evaluation, index_path: {index}}}")
        test_launches = dict(kernels.launch_counts)
        means_c = check_test_output(tmp / "c" / "test" / "evaluation", 4 * 3)

    print(f"trainer phase launches: (a)+(b) {fit_launches}, (c) {test_launches}")
    if min(fit_launches.values()) < 1:
        raise AssertionError(f"a kernel did not run in the trainer's fit: {fit_launches}")
    if min(test_launches[k] for k in FORWARD_KERNELS) < 1:
        raise AssertionError(f"a forward kernel did not run in the trainer's test: {test_launches}")
    print("trainer phase benchmark.json means per scene (encoder) and per view: "
          + "; ".join(f"({n}) " + ", ".join(f"{k} {v:.4f}" for k, v in m.items())
                      for n, m in (("a", means_a), ("b", means_b), ("c", means_c))))
    return fit_launches, test_launches


def small_gradient_check(seed: int, device) -> None:
    """The narrow model's train-step gradients through the tiled kernels
    against those through the dense oracle, same weights and noise;
    normalised by each leaf's largest gradient, atol 5e-3 (the JAX
    package's tiled-vs-dense gradient tolerance). The depth head is left
    unscaled: on a mostly opaque scene the tiled path stops each pixel at
    T < 1e-4 and the dense oracle never stops, which moves the gradients
    of a few encoder leaves by ~7e-3 by design (no kernel fault)."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.training.step import generator_grads, make_step_flags

    cfg = load_config("re10k", SMALL_OVERRIDES)
    state, losses, _ = build_trainer(cfg, seed, device, peaked_depth=False)
    batch = state.model.data_shim(make_batch(np.random.default_rng(seed), 2, 2, 32, device))
    gen = torch.Generator(device=device).manual_seed(seed)
    gpp = cfg.model.encoder.gaussians_per_pixel
    d_sh = (cfg.model.encoder.gaussian_adapter.feature_sh_degree + 1) ** 2
    c = cfg.model.autoencoder.latent_channels
    noise = {
        "depth": torch.rand((1, 2, 32 * 32, 1, gpp), generator=gen, device=device),
        "gaussians": torch.randn((1, 2 * 32 * 32 * gpp, c, d_sh), generator=gen, device=device),
        "latent": torch.randn((1, 2, 32, 32, c), generator=gen, device=device),
    }
    flags = make_step_flags(losses, TRAIN_STEP)
    before = dict(kernels.launch_counts)
    tiled, _, _, _ = generator_grads(state, losses, flags, batch, TRAIN_STEP, noise=noise)
    if not all(kernels.launch_counts[k] > before[k] for k in before):
        raise AssertionError("the tiled gradients did not run every kernel")
    state.model.decoder.cfg.backend = "dense"
    dense, _, _, _ = generator_grads(state, losses, flags, batch, TRAIN_STEP, noise=noise)
    state.model.decoder.cfg.backend = "tiled"
    # A leaf whose gradient is zero but for rounding (a conv bias right
    # before a GroupNorm) is normalised by 1e-4 of the largest gradient.
    floor = 1e-4 * max(g.abs().max() for g in dense.values())
    errs = sorted(
        (((tiled[name] - g).abs().max() / torch.clamp(g.abs().max(), min=floor)).item(), name)
        for name, g in dense.items()
    )
    worst = errs[-1][0]
    print(f"small input, train-step gradients tiled vs dense oracle: {len(dense)} leaves, normalised "
          f"by each leaf's largest gradient (floor {floor.item():.3e}); worst "
          + ", ".join(f"{n} {e:.3e}" for e, n in reversed(errs[-3:])))
    if worst > 5e-3:
        raise AssertionError("tiled train-step gradients disagree with the dense oracle")


def small_input_check(seed: int, device) -> None:
    """Tiled (kernel) render of a narrow model against the dense oracle."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.model.latentsplat import render_full

    cfg = load_config("re10k", SMALL_OVERRIDES)
    model = build_model(cfg, seed, device)
    batch = make_batch(np.random.default_rng(seed), 2, 2, 32, device)
    tiled = render_full(model, batch, deterministic=True)
    model.decoder.cfg.backend = "dense"
    dense = render_full(model, batch, deterministic=True)
    errs = {k: (tiled[k] - dense[k]).abs().max().item() for k in ("render", "depth", "image")}
    print(f"small input, tiled vs dense oracle: {errs}")
    if errs["render"] > 2e-4 or errs["depth"] > 2e-3 or errs["image"] > 2e-3:
        raise AssertionError(f"tiled render disagrees with the dense oracle: {errs}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", metavar="DIR", help="also profile one render_full and one train step into DIR")
    parser.add_argument("--parent", metavar="DIR",
                        help="also time the forward kernels of the checkout DIR beside this tree's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    from latentsplat_tpu_torch import cuda_build
    from latentsplat_tpu_torch.config import load_config

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    cuda_build.load_library()
    info = cuda_build.build_info
    print(f"kernels: {'built' if info['built'] else 'loaded'} {info['path']} in {info['seconds']:.2f} s "
          f"from {info['sources']} with {' '.join(cuda_build.NVCC_FLAGS)}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    cfg = load_config("re10k")
    model = build_model(cfg, args.seed, device)
    batch = make_batch(np.random.default_rng(args.seed), 2, 4, 256, device)
    view, results = kernel_phase(model, batch, args.seed, args.parent)
    results += backward_kernel_phase(view, args.seed)
    del view
    serve_launches = slice_phase(model, batch, args.seed, args.profile)
    del model
    train_launches = train_phase(cfg, args.seed, device, args.profile)
    fit_launches, test_launches = trainer_phase(args.seed, device)
    # Each kernel's count comes from the path it serves: the forward kernels
    # from serving, the backward kernels from training; beside them, the
    # counts of the trainer's fit (a)+(b) and of its test mode (c).
    for entry in results:
        path = serve_launches if entry["name"] in FORWARD_KERNELS else train_launches
        entry["launches"] = path[entry["name"]]
        entry["trainer_fit_launches"] = fit_launches[entry["name"]]
        entry["trainer_test_launches"] = test_launches[entry["name"]]
    small_input_check(args.seed, device)
    small_gradient_check(args.seed, device)

    print(card())
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
