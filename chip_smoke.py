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
5. Depth phase: on the slice's Gaussians, composite_forward at 4 channels
   (render_depth's payload) against its plain version and timed at view 0;
   the splatting decoder in each depth mode (depth, disparity,
   relative_disparity, log) over the 4 target views, with finite depths,
   the 4-channel launches, each mode's time per view and the invariant
   depth x disparity >= mask^2.
6. Train phase: 3 VAE-GAN train steps of the flagship re10k model at full
   width (random weights for the generator, the PatchGAN discriminator and
   LPIPS) on one batch of 2 scenes, 2 context + 4 target views at 256x256,
   at step 125000, where every re10k loss is live. Checks finite losses and
   gradient norms, the adaptive weight in [0, 1], changed parameters of
   both nets and that all four kernels ran; prints seconds per step, a
   stage split and the peak memory.
7. Trainer phase: the program's entry point, `latentsplat_tpu_torch.main.main`,
   on the flagship model at full width and the synthetic dataset at
   256x256: train from step 0 (2 steps, a validation with the wobble and
   interpolation videos, the 48-view test), a resume at step 125000 (2
   steps with every loss live, its test), an evaluation index written by
   scripts.generate_evaluation_index, test mode over it, then
   scripts.compute_metrics, the MetricComputer with LPIPS and DISTS on the
   card and scripts.generate_benchmark_table over that test's output.
   Checks the logs, checkpoints, videos, PNGs, benchmark.json, the index,
   the scores and that all four kernels ran as often as the runs need;
   prints the benchmark.json means, steps/s, peak memory and the metric
   passes' seconds per image.
8. Data phase: the real-data input path. Builds the host C library (JPEG
   decoder, LANCZOS resampler), decodes and crop-shims every committed
   fixture (tests/torch_fixtures/jpeg) and holds each against its
   manifest's sha256 (PIL's bits), and checks that the progressive one
   raises; times decode and crop shim per 640x360 frame and the RE10k
   train loader with 0 and 4 workers; writes an RE10k root and a CO3D tree
   of fixture frames and drives `main` at full width over them through
   forkserver loader workers: re10k train (2 steps, a validation, its test),
   scripts.generate_evaluation_index, test over it; co3d_hydrant train (2
   steps, its test), scripts.generate_co3d_evaluation_index, test over it,
   scripts.generate_gt_image_directory. Checks losses, checkpoints, PNGs,
   the indexes, the first train batch against the parent's own decode and
   the kernels' launches in each run.
9. Switches phase: the model's remaining switches on the flagship at full
   width, step 125000, 2 scenes x (2 + 4) views at 256x256. (s1) the
   context, target_autoencoder (l1 + lpips + generator + hinge) and
   target_render_latent (mse) loss sites, all live (without the VAE's skip
   connections, which those sites' decodes cannot feed; 1 scene if 2 do
   not fit); (s2) encode_latents with the ResNet-50 backbone: a serving
   batch, 2 train steps and `main` in test mode, whose benchmark.json holds
   autoencoder_encoder; (s3) variational=latents: composite_forward and
   composite_backward at 12 channels and reduce_pairs at rows of 18 against
   their plain versions and timed at view 0, then 2 train steps; (s4)
   model.remat with decoder.remat under the policies nothing, dots and
   vae:off,lpips:off against the plain step on the same batch and noise
   (generator/total within 1e-6 relative, each gradient leaf within 1e-6
   of its largest value or 4x the plain step's own repeat difference; 8 + 8
   forward launches a step); (s5) compute_dtype bfloat16 and
   vae/lpips/disc:bfloat16 (generator/total within 5% of float32, float32
   master parameters); (s6) the vit (dino_vitb8) backbone and an ensemble
   of dino + resnet50. Prints step seconds, stage splits, peaks and
   launches of every run.
10. Inspection phase (run between the data and switches phases): what a
   user does with a released model, on the flagship at full width. (i) The seeded
   generator and PatchGAN written in the released checkpoint's layout,
   converted by scripts.convert_checkpoint (every tensor mapped, none left
   seeded) and served by `main` mode=test over 2 synthetic scenes: the
   same PNGs, bit for bit, as the model's own checkpoint; (ii)
   render_projections at 256x256 of a scene's 393,216 Gaussians through
   the tiled kernels (each axis's largest rect, pairs, ms, 3 launches of
   composite_forward<4>), duplicate_with_keys at its inputs with int32 and
   int64 masks against its plain version, a 128x128 projection of 32,768
   Gaussians against the dense plain version within 2e-4; (iii) the
   encoder panels and the PLY export, read back exactly; (iv)
   scripts.render_uncertainty and scripts.visualize_epipolar_lines.
11. Small-input checks: the tiled (kernel) render of a narrow model against
   the dense oracle render, composite_backward and reduce_pairs at 4
   channels against their plain versions, and the narrow model's
   train-step gradients through the tiled kernels against those through
   the dense oracle.

Prints the card's name and power limit, one JSON line describing the
kernels (device ms, plain ms, the bound and its share, the library call's
ms, launches on the main path, in the trainer phase, in each run of the
data phase and in each step of the inspection phase; duplicate_with_keys
also its wrapper's ms; composite_forward once at the flagship's 8 channels,
once at render_depth's 4 and once at variational=latents' 12, and
composite_backward and reduce_pairs also at 12 channels), and last
`{"ok": true, "device": {...}}`.
Any failed check raises.
Exits non-zero without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
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
ALL_KERNELS = (*FORWARD_KERNELS, "composite_backward", "reduce_pairs")
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


def slice_gaussians(model, batch, seed: int, flatten: bool = False):
    """The slice batch after the data shims and its Gaussians, sampled with
    a generator seeded with `seed` (or, with `flatten`, their feature
    posteriors' mean and logvar packed, as `variational: latents` renders)."""
    gen = torch.Generator(device=batch["target"]["image"].device).manual_seed(seed)
    with torch.no_grad():
        shimmed = model.data_shim(batch)
        gaussians = model.encoder(shimmed["context"], 0, generator=gen)
        return shimmed, gaussians.flatten() if flatten else gaussians.sample(gen)


def first_view(model, batch, seed: int, depth_payload: bool = False, flatten: bool = False):
    """The screen Gaussians of the slice's first target view, as `render`
    gives them to the compositor: the SH colors and features towards the
    camera, or (`depth_payload`) each Gaussian's camera-space z as the
    3-channel DC color of `render_depth`; then (sg, (h, w))."""
    from latentsplat_tpu_torch.geometry.projection import homogenize_points, invert_se3
    from latentsplat_tpu_torch.ops.rasterize.api import view_channels
    from latentsplat_tpu_torch.ops.rasterize.camera import project_gaussians_to_screen

    shimmed, gaussians = slice_gaussians(model, batch, seed, flatten)
    target = shimmed["target"]
    ext, intr, near = target["extrinsics"][0, 0], target["intrinsics"][0, 0], target["near"][0, 0]
    h, w = target["image"].shape[2:4]
    means = gaussians.means[0]
    with torch.no_grad():
        if depth_payload:
            z = torch.einsum("ij,gj->gi", invert_se3(ext), homogenize_points(means))[:, 2]
            channels = view_channels(means, z[:, None, None].expand(-1, 3, 1), None, ext[:3, 3], use_sh=False)
        else:
            channels = view_channels(means, gaussians.color_harmonics[0], gaussians.feature_harmonics[0], ext[:3, 3])
        s = 1.0 / near
        ext_s = ext.clone()
        ext_s[:3, 3] *= s
        sg = project_gaussians_to_screen(
            means * s, gaussians.covariances[0] * (s * s), gaussians.opacities[0], channels, ext_s, intr, (h, w),
        )
    return sg, (h, w)


def kernel_phase(model, batch, seed: int, parent: str | None = None) -> tuple[dict, list[dict]]:
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.ops.rasterize.tiled import pack_attributes, sort_pairs, tile_rects

    sg, (h, w) = first_view(model, batch, seed)
    channels = sg.channels
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
    return view, [
        # Mask, base, nx and depth of each Gaussian, one exclusive offset per
        # block of 512 Gaussians, and 12 bytes per pair written.
        entry("duplicate_with_keys", "duplicate_with_keys.cu", "latentsplat_tpu/ops/rasterize/expand.py:159",
              float(dup_err), dup_ms, dup_plain_ms,
              n_bytes=16 * g_count + 8 * math.ceil(g_count / 512) + 12 * p_count, n_ops=0,
              wrapper_ms=dup_wrapper_ms),
        forward_entry(max(err_ch, err_t), comp_ms, comp_plain_ms, view),
    ]


def forward_entry(err: float, ms: float, plain_ms: float, view: dict) -> dict:
    """composite_forward's record: the pairs' ids, the tile ranges and every
    Gaussian's attribute row read once, the channels, T and `last` written;
    operations as counted by `composite_work`."""
    attrs, ranges, work = view["attrs"], view["ranges"], view["work"]
    p_count, (g_count, row) = view["gids"].shape[0], attrs.shape
    n_ch, plane = row - 6, view["shape"][0] * view["shape"][1]
    return entry("composite_forward", "composite_forward.cu", "latentsplat_tpu/ops/rasterize/pallas_kernels.py:399",
                 err, ms, plain_ms,
                 n_bytes=4 * p_count + 4 * ranges.numel() + 4 * row * g_count + 4 * (n_ch + 2) * plane,
                 n_ops=EVAL_OPS * work["forward_evaluations"] + forward_composited_ops(n_ch) * work["composited"],
                 channels=n_ch)


DEPTH_MODES = ("depth", "disparity", "relative_disparity", "log")


def depth_view(sg, shape: tuple[int, int]) -> dict:
    """Pairs and attribute rows of the screen Gaussians `sg`, duplicated and
    sorted by the kernels (ids, keys and tile ranges held exactly against
    the plain versions), with composite_forward's outputs."""
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.ops.rasterize.tiled import pack_attributes, sort_pairs, tile_rects

    h, w = shape
    tiles_x, tiles_y = w // 16, h // 16
    counts, base, nx, mask = tile_rects(sg, tiles_x, tiles_y)
    depth = sg.depth.contiguous()
    gids, keys = kernels.duplicate_with_keys(counts, mask, base, nx, depth, tiles_x, 9)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, depth, tiles_x, 9)
    sorted_gids, ranges, order = sort_pairs(gids, keys, tiles_x * tiles_y)
    ref_sorted, ref_ranges, _ = sort_pairs(ref_gids, ref_keys, tiles_x * tiles_y)
    if not (torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys) and torch.equal(sorted_gids, ref_sorted)
            and torch.equal(ranges, ref_ranges)):
        raise AssertionError("duplicate_with_keys or the sort disagrees with its plain version")
    attrs = pack_attributes(sg)
    _, t_final, last = kernels.composite_forward(sorted_gids, ranges, attrs, tiles_x, shape)
    return {"gids": sorted_gids, "ranges": ranges, "order": order, "counts": counts, "attrs": attrs,
            "tiles_x": tiles_x, "shape": shape, "t_final": t_final, "last": last}


def check_forward(view: dict, label: str) -> float:
    """composite_forward against its plain version on `view`: `last`
    exactly, T within KERNEL_ATOL and each channel within KERNEL_ATOL of
    its largest value (render_depth's channels carry depths, up to ~100).
    Returns the largest of those errors."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    args = (view["gids"], view["ranges"], view["attrs"], view["tiles_x"], view["shape"])
    out = kernels.composite_forward(*args)
    ref = kernels.composite_forward_reference(*args)
    torch.cuda.synchronize()
    scale = ref[0].abs().amax(dim=(1, 2)).clamp(min=1e-30)
    err_ch = ((out[0] - ref[0]).abs().amax(dim=(1, 2)) / scale).max().item()
    err_t = (out[1] - ref[1]).abs().max().item()
    last_mismatch = int((out[2] != ref[2]).sum())
    print(f"{label}: composite_forward at {view['attrs'].shape[1] - 6} channels, max channel error relative to "
          f"its largest value {err_ch:.3e}, max |T err| {err_t:.3e}, last-contributor mismatches {last_mismatch}")
    if not (err_ch <= KERNEL_ATOL and err_t <= KERNEL_ATOL) or last_mismatch:
        raise AssertionError(f"{label}: composite_forward disagrees with its plain version")
    return max(err_ch, err_t)


def depth_phase(model, batch, seed: int) -> tuple[dict, dict]:
    """render_depth on the slice's Gaussians: composite_forward at 4
    channels (render_depth's 3-channel payload + the expected depth) held
    against its plain version and timed at view 0; then `DecoderSplatting`
    in each depth mode over the 4 target views (the counted run), finite
    depths, each mode's render_depth time per view, and the invariant
    depth x disparity >= mask^2 (Cauchy-Schwarz over the same composite
    weights). Returns the 4-channel composite_forward's record and the
    launches of the counted run ({kernel: n} and composite_forward's by
    channel count)."""
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.ops.rasterize.api import render_depth

    sg, shape = first_view(model, batch, seed, depth_payload=True)
    view = depth_view(sg, shape)
    err = check_forward(view, "depth phase, view 0")
    args = (view["gids"], view["ranges"], view["attrs"], view["tiles_x"], shape)
    ms = device_ms(lambda: kernels.composite_forward(*args))
    plain_ms = cuda_ms(lambda: kernels.composite_forward_reference(*args), 3)
    view["work"] = composite_work(view)
    print(f"depth phase: composite_forward at 4 channels {ms:.4f} ms (device) vs plain {plain_ms:.4f} ms; "
          f"{view['gids'].shape[0]} pairs")
    record = forward_entry(err, ms, plain_ms, view)
    del view

    shimmed, gaussians = slice_gaussians(model, batch, seed)
    target = shimmed["target"]
    cams = (target["extrinsics"], target["intrinsics"], target["near"], target["far"])
    n_views = cams[0].shape[1]
    size = model.scaled_size(model.scale_factor, target["image"].shape[2:4])
    for key in kernels.launch_counts:
        kernels.launch_counts[key] = 0
    kernels.composite_forward_launches.clear()
    outs, seconds = {}, {}
    with torch.no_grad():
        for mode in DEPTH_MODES:
            torch.cuda.synchronize()
            start = time.perf_counter()
            outs[mode] = model.decoder(gaussians, *cams, size, depth_mode=mode)
            torch.cuda.synchronize()
            seconds[mode] = time.perf_counter() - start
    launches = dict(kernels.launch_counts)
    launches["composite_forward_by_channels"] = dict(kernels.composite_forward_launches)
    print(f"depth phase launches (4 modes x {n_views} views): {launches}")
    if launches["composite_forward_by_channels"].get(4) != (len(DEPTH_MODES) - 1) * n_views:
        raise AssertionError("render_depth did not composite each view once at 4 channels in each special mode")
    with torch.no_grad():
        for mode, out in outs.items():
            d = out.depth
            if d.shape != (1, n_views, *size) or not torch.isfinite(d).all():
                raise AssertionError(f"depth mode {mode}: shape {tuple(d.shape)} or non-finite values")
            per_view = cuda_ms(lambda: render_depth(*cams, size, gaussians.means, gaussians.covariances,
                                                    gaussians.opacities, mode=mode), 3) / n_views
            print(f"depth mode {mode}: decoder {seconds[mode]:.4f} s for {n_views} views (host clock, synchronized); "
                  f"render_depth {per_view:.4f} ms per view (CUDA events, host included); depth min "
                  f"{d.min().item():.4g}, mean {d.mean().item():.4g}, max {d.max().item():.4g}")
        gaussian_args = (gaussians.means, gaussians.covariances, gaussians.opacities)
        depth = render_depth(*cams, size, *gaussian_args, mode="depth")
        disparity = render_depth(*cams, size, *gaussian_args, mode="disparity")
        mask = outs["depth"].mask
        worst = (depth * disparity - mask**2 * (1 - 1e-4)).min().item()
    print(f"depth phase: min of depth x disparity - mask^2 (1 - 1e-4) = {worst:.4e} (must be >= 0); "
          f"mask mean {mask.mean().item():.4f}")
    if worst < 0:
        raise AssertionError("depth x disparity < mask^2: the depth renders do not share their weights")
    return record, launches


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
    state, _, train_step = switch_state(cfg, seed, device)
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
    validation, its wobble and interpolation videos (30 views each, looped
    back to 58 frames) and a checkpoint at step 2, then the test that train
    mode runs (the bounded sampler's test stage: 48 target views a scene);
    (b) a resume from a checkpoint at step 125000, where every re10k loss is
    live, for 2 steps, then its test; then the evaluation path: an index
    written by `scripts.generate_evaluation_index`, (c) mode=test from
    (a)'s checkpoint over that index (2 context and 3 target views a
    scene), and `evaluation_phase` over (c)'s output. The weights are
    random from `seed`, the generator's as `like_trained` leaves them
    (loaded into (a) as its `checkpointing.load`). Checkpoints go to a
    temporary directory that is deleted. Returns the kernels' launch counts
    over (a)+(b) and over (c), composite_forward's also by channel count."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.main import main as run_main
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.scripts import generate_evaluation_index
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
        kernels.composite_forward_launches.clear()
        videos = []
        with watch_videos(videos):
            run_a = call("a", "mode=train", f"checkpointing.load={init}", "trainer.max_steps=2",
                         "trainer.val_check_interval=2", "train.video_wobble=true", "train.video_interpolation=true")
        check_videos(videos, run_a)
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
        fit_launches["composite_forward_by_channels"] = dict(kernels.composite_forward_launches)
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

        # The evaluation index of the synthetic scenes, with the JAX script's
        # defaults: context pairs 45 or more frames apart whose rays overlap
        # by at least 60%, 3 target views between them.
        start = time.perf_counter()
        index = generate_evaluation_index.main(
            ["+experiment=re10k", f"dataset={json.dumps(dict(data, view_sampler={'name': 'all'}))}",
             f"index_generator.output_path={tmp / 'index'}"], device=device)
        entries = json.loads(index.read_text())
        print(f"  evaluation index in {time.perf_counter() - start:.2f} s: {entries}")
        if sorted(entries) != [f"synthetic_{i:04d}" for i in range(4)] or not all(
                len(v) == 1 and len(v[0]["target"]) == 3 for v in entries.values()):
            raise AssertionError("the evaluation index does not hold one entry of 3 targets for each scene")
        for key in kernels.launch_counts:
            kernels.launch_counts[key] = 0
        kernels.composite_forward_launches.clear()
        evaluation = {"name": "evaluation", "index_path": str(index)}
        call("c", "mode=test", f"checkpointing.load={ckpt_a}", "wandb.name=evaluation",
             f"dataset.view_sampler={json.dumps(evaluation)}")
        test_launches = dict(kernels.launch_counts)
        test_launches["composite_forward_by_channels"] = dict(kernels.composite_forward_launches)
        means_c = check_test_output(tmp / "c" / "test" / "evaluation", 4 * 3)
        evaluation_phase(seed, device, dict(data, view_sampler=evaluation), tmp / "c" / "test" / "evaluation", tmp)

    print(f"trainer phase launches: (a)+(b) {fit_launches}, (c) {test_launches}")
    if min(fit_launches[k] for k in kernels.launch_counts) < 1:
        raise AssertionError(f"a kernel did not run in the trainer's fit: {fit_launches}")
    # 4 train steps of 2 scenes x 4 target views, the validation's two passes
    # over 4 views, two videos of 30 views and two tests of 4 x 48 views.
    expected = 4 * 2 * 4 + 2 * 4 + 2 * 30 + 2 * 4 * 48
    if any(fit_launches[k] != expected for k in FORWARD_KERNELS):
        raise AssertionError(f"the trainer's fit launched the forward kernels {fit_launches}, not {expected} times")
    if min(test_launches[k] for k in FORWARD_KERNELS) < 1:
        raise AssertionError(f"a forward kernel did not run in the trainer's test: {test_launches}")
    print("trainer phase benchmark.json means per scene (encoder) and per view: "
          + "; ".join(f"({n}) " + ", ".join(f"{k} {v:.4f}" for k, v in m.items())
                      for n, m in (("a", means_a), ("b", means_b), ("c", means_c))))
    return fit_launches, test_launches


@contextmanager
def watch_videos(videos: list):
    """While open, every `Trainer.render_video` call appends its mode, its
    frames, seconds, kernel launches and the peak memory since the
    enclosing call's start to `videos`."""
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.training.trainer import Trainer

    original = Trainer.render_video

    def render_video(self, params_gen, batch, mode, step, **kwargs):
        logged = {}
        log_video = self.logger.log_video
        self.logger.log_video = lambda key, frames, step_: logged.update(frames=frames) or log_video(key, frames, step_)
        before = dict(kernels.launch_counts)
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            original(self, params_gen, batch, mode, step, **kwargs)
        finally:
            self.logger.log_video = log_video
        torch.cuda.synchronize()
        videos.append({"mode": mode, "step": step, "frames": logged.get("frames", []),
                       "seconds": time.perf_counter() - start, "peak": torch.cuda.max_memory_allocated(),
                       "launches": {k: v - before[k] for k, v in kernels.launch_counts.items()}})

    Trainer.render_video = render_video
    try:
        yield
    finally:
        Trainer.render_video = original


def check_videos(videos: list, run: Path, size: int = 256) -> None:
    """Both videos of (a)'s validation: 58 finite frames (the size x size
    image over its depth in color, 2 pixels apart), each view through both forward
    kernels once, and the file the logger wrote (an mp4 with ffmpeg, else
    the frames as PNGs)."""
    if [v["mode"] for v in videos] != ["wobble", "interpolation"]:
        raise AssertionError(f"(a) rendered the videos {[v['mode'] for v in videos]}")
    for v in videos:
        frames = v["frames"]
        if len(frames) != 58 or any(f.shape != (2 * size + 2, size, 3) or not np.isfinite(f).all() for f in frames):
            raise AssertionError(f"video {v['mode']}: {len(frames)} frames, shapes {sorted({f.shape for f in frames})}")
        if any(v["launches"][k] != 30 for k in FORWARD_KERNELS):
            raise AssertionError(f"video {v['mode']}: launches {v['launches']}, not 30 of each forward kernel")
        mp4 = run / "local" / "video" / v["mode"] / f"{v['step']:0>6}.mp4"
        pngs = sorted(mp4.with_suffix("").glob("*.png"))
        if not (mp4.exists() or len(pngs) == 58):
            raise AssertionError(f"video {v['mode']}: neither {mp4} nor 58 PNG frames")
        print(f"  (a) video/{v['mode']}: 58 frames of {frames[0].shape}, "
              + (f"mp4 of {mp4.stat().st_size} bytes" if mp4.exists() else "58 PNGs (no ffmpeg)")
              + f", {v['seconds']:.2f} s, launches {v['launches']}, peak memory since (a)'s start "
              f"{v['peak'] / 1e9:.2f} GB")


def evaluation_phase(seed: int, device, data: dict, rendered: Path, tmp: Path, n_scenes: int = 4) -> None:
    """What follows a test run, on (c)'s PNGs: `scripts.compute_metrics`
    (PSNR and SSIM of every indexed view, per scene and their means); the
    `MetricComputer` once more with the port's LPIPS and DISTSNet (seeded
    random weights) as its networks, and DISTS of each image against itself;
    `scripts.generate_benchmark_table` over (c)'s benchmark.json. Prints the
    seconds per image of both metric passes."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.dataset import get_dataset
    from latentsplat_tpu_torch.dataset.view_samplers import get_view_sampler
    from latentsplat_tpu_torch.evaluation.metric_computer import EvaluationCfg, MethodCfg, MetricComputer
    from latentsplat_tpu_torch.evaluation.metrics import DISTSNet
    from latentsplat_tpu_torch.loss.lpips import LPIPS
    from latentsplat_tpu_torch.scripts import compute_metrics, generate_benchmark_table
    from latentsplat_tpu_torch.training.step_tracker import StepTracker

    n_images = len(list(rendered.rglob("color/*.png")))
    dataset_arg = f"dataset={json.dumps(data)}"
    method = f"{{name: latentSplat, key: ours, path: {rendered}}}"
    start = time.perf_counter()
    computer = compute_metrics.main(
        ["+experiment=re10k", dataset_arg, f"evaluation.methods=[{method}]",
         f"evaluation.output_metrics_path={tmp / 'metrics' / 'scores.json'}"], device=device)
    metrics_s = time.perf_counter() - start
    means = json.loads((tmp / "metrics" / "scores.mean.json").read_text())
    scores = computer.scores
    if len(scores["psnr"]) != n_scenes or len(scores["ssim"]) != n_scenes:
        raise AssertionError(f"compute_metrics scored {sorted(scores['psnr'])}")
    values = [v["ours"] for m in ("psnr", "ssim") for v in scores[m].values()]
    if not all(math.isfinite(x) for x in values) or not all(-1.0 <= v["ours"] <= 1.0 for v in scores["ssim"].values()):
        raise AssertionError(f"compute_metrics: {scores}")
    print(f"evaluation: compute_metrics over {n_images} images of {n_scenes} scenes in {metrics_s:.2f} s "
          f"({metrics_s / n_images:.4f} s per image, the ground truth's numpy rendering included); means {means}")

    torch.manual_seed(seed)
    lpips, dists = LPIPS().to(device).eval(), DISTSNet().to(device).eval()
    computer = MetricComputer(EvaluationCfg([MethodCfg("latentSplat", "ours", rendered)]), lpips_fn=lpips,
                              dists_fn=dists, device=device)
    cfg = load_config("re10k", [dataset_arg])
    sampler = get_view_sampler(cfg.dataset.view_sampler, "test", False, False, StepTracker())
    self_dists, step_s = [], 0.0
    for example in get_dataset(cfg.dataset, "test", sampler):
        batch = {"scene": example["scene"], "context": {"index": example["context"]["index"]},
                 "target": {"index": example["target"]["index"], "image": example["target"]["image"][None]}}
        torch.cuda.synchronize()
        start = time.perf_counter()
        computer.step(batch, verbose=False)
        torch.cuda.synchronize()
        step_s += time.perf_counter() - start
        with torch.no_grad():
            gt = torch.from_numpy(example["target"]["image"]).to(device)
            self_dists.append(dists(gt, gt).abs().max().item())
    scores = computer.mean_scores()
    print(f"evaluation: MetricComputer with LPIPS and DISTS (random weights) on the card, means {scores}; "
          f"{step_s / n_images:.4f} s per image (host clock, synchronized, PNG reads included); "
          f"largest |DISTS(x, x)| {max(self_dists):.3e}")
    if set(scores) != {"psnr", "lpips", "dists", "ssim"} or not all(
            math.isfinite(v["ours"]) for v in scores.values()):
        raise AssertionError(f"MetricComputer with LPIPS and DISTS: {scores}")
    if max(self_dists) > 1e-5:
        raise AssertionError("DISTS of an image against itself is not 0")

    table = generate_benchmark_table.main(
        [f"methods=[{{name: latentSplat, path: {rendered}}}]", f"output_path={tmp / 'benchmark_table.tex'}"])
    if not all(f"{tag} (ms)" in table for tag in ("encoder", "decoder", "autoencoder decoder")):
        raise AssertionError("the benchmark table lacks a tag")


# -- the released checkpoint's layout (inspection phase) ------------------------
#
# The reference's module paths for the port's, as the released latentSplat
# .ckpt names them: the inverse of training/pretrained.py's key maps, kept
# here so that the converters are held against a map written apart from
# them. Each rule is (port pattern, reference template); every rule whose
# pattern matches the whole name rewrites it, in order.
_REFERENCE_RULES = [
    # DINO trunk (facebookresearch/dino); the query/key/value Linears are
    # fused into qkv below.
    (r"encoder\.backbone\.dino\.patch_embed\.(weight|bias)", r"encoder.backbone.dino.patch_embed.proj.\1"),
    (r"encoder\.backbone\.dino\.block_(\d+)\.LayerNorm_0\.(.*)", r"encoder.backbone.dino.blocks.\1.norm1.\2"),
    (r"encoder\.backbone\.dino\.block_(\d+)\.LayerNorm_1\.(.*)", r"encoder.backbone.dino.blocks.\1.norm2.\2"),
    (r"encoder\.backbone\.dino\.block_(\d+)\.MultiHeadDotProductAttention_0\.out\.(.*)",
     r"encoder.backbone.dino.blocks.\1.attn.proj.\2"),
    (r"encoder\.backbone\.dino\.block_(\d+)\.Dense_0\.(.*)", r"encoder.backbone.dino.blocks.\1.mlp.fc1.\2"),
    (r"encoder\.backbone\.dino\.block_(\d+)\.Dense_1\.(.*)", r"encoder.backbone.dino.blocks.\1.mlp.fc2.\2"),
    (r"encoder\.backbone\.dino\.LayerNorm_0\.(.*)", r"encoder.backbone.dino.norm.\1"),
    (r"encoder\.backbone\.dino\.(cls_token|pos_embed)", r"encoder.backbone.dino.\1"),
    (r"encoder\.backbone\.Dense_0\.(.*)", r"encoder.backbone.global_token_mlp.0.\1"),
    (r"encoder\.backbone\.Dense_1\.(.*)", r"encoder.backbone.global_token_mlp.2.\1"),
    (r"encoder\.backbone\.Dense_2\.(.*)", r"encoder.backbone.local_token_mlp.0.\1"),
    (r"encoder\.backbone\.Dense_3\.(.*)", r"encoder.backbone.local_token_mlp.2.\1"),
    (r"encoder\.backbone_projection\.(.*)", r"encoder.backbone_projection.1.\1"),
    # Epipolar transformer and the SRT transformers inside it: attention in
    # layers.{i}.0, the feed-forward in layers.{i}.1 (an MLP net =
    # Sequential(Linear, GELU, Dropout, Linear, Dropout), or ConvFeedForward
    # with its convolutions at layers.0 and layers.3).
    (r"(.*)\.refine_0\.(.*)", r"\1.upscale_refinement.0.\2"),
    (r"(.*)\.refine_1\.(.*)", r"\1.upscale_refinement.2.\2"),
    (r"(.*)\.depth_encoding\.(.*)", r"\1.depth_encoding.1.\2"),
    (r"(.*)\.pe_proj\.(.*)", r"\1.positional_encoding.1.\2"),
    (r"(.*)\.self_attention\.patch_embed\.(.*)", r"\1.self_attention.patch_embedder.0.\2"),
    (r"(.*)\.norm_attn_(\d+)\.(.*)", r"\1.layers.\2.0.norm.\3"),
    (r"(.*)\.attn_(\d+)\.to_out\.(.*)", r"\1.layers.\2.0.fn.to_out.0.\3"),
    (r"(.*)\.attn_(\d+)\.(to_q|to_kv|to_qkv)\.(.*)", r"\1.layers.\2.0.fn.\3.\4"),
    (r"(.*)\.norm_ff_(\d+)\.(.*)", r"\1.layers.\2.1.norm.\3"),
    (r"(.*)\.ff_(\d+)\.Dense_0\.(.*)", r"\1.layers.\2.1.fn.net.0.\3"),
    (r"(.*)\.ff_(\d+)\.Dense_1\.(.*)", r"\1.layers.\2.1.fn.net.3.\3"),
    (r"(.*)\.ConvFeedForward_(\d+)\.Conv_0\.(.*)", r"\1.layers.\2.1.fn.layers.0.\3"),
    (r"(.*)\.ConvFeedForward_(\d+)\.Conv_1\.(.*)", r"\1.layers.\2.1.fn.layers.3.\3"),
    (r"(.*)\.ConvFeedForward_(\d+)\.self_attention\.(.*)", r"\1.layers.\2.1.fn.self_attention.\3"),
    (r"encoder\.high_resolution_skip\.(.*)", r"encoder.high_resolution_skip.0.\1"),
    (r"encoder\.to_gaussians\.(.*)", r"encoder.to_gaussians.1.\1"),
    (r"encoder\.depth_predictor\.projection\.(.*)", r"encoder.depth_predictor.projection.1.\1"),
    # The VAE (diffusers AutoencoderKL under autoencoder.model) and
    # latentSplat's skip convolutions beside it.
    (r"autoencoder\.decoder\.skip_conv_(\d+)\.(.*)", r"autoencoder.skip_convs.\1.\2"),
    (r"autoencoder\.encoder\.down_(\d+)_resnet_(\d+)\.(.*)", r"autoencoder.model.encoder.down_blocks.\1.resnets.\2.\3"),
    (r"autoencoder\.encoder\.down_(\d+)_downsample\.(.*)", r"autoencoder.model.encoder.down_blocks.\1.downsamplers.0.\2"),
    (r"autoencoder\.decoder\.up_(\d+)_resnet_(\d+)\.(.*)", r"autoencoder.model.decoder.up_blocks.\1.resnets.\2.\3"),
    (r"autoencoder\.decoder\.up_(\d+)_upsample\.(.*)", r"autoencoder.model.decoder.up_blocks.\1.upsamplers.0.\2"),
    (r"autoencoder\.(encoder|decoder)\.mid_resnet_(\d+)\.(.*)", r"autoencoder.model.\1.mid_block.resnets.\2.\3"),
    (r"autoencoder\.(encoder|decoder)\.mid_attn\.to_out\.(.*)", r"autoencoder.model.\1.mid_block.attentions.0.to_out.0.\2"),
    (r"autoencoder\.(encoder|decoder)\.mid_attn\.(.*)", r"autoencoder.model.\1.mid_block.attentions.0.\2"),
    (r"autoencoder\.(?!model\.|skip_convs\.)(.*)", r"autoencoder.model.\1"),
    (r"(encoder\..*)", r"\1"),
]


def reference_state_dict(generator: dict, discriminator: dict | None, n_layers: int = 3) -> dict:
    """The port's generator (and PatchGAN) state dicts in the released
    checkpoint's layout: fused DINO qkv projections, taming's
    NLayerDiscriminator `main.{i}` Sequential with BatchNorm running
    statistics (which the port's train-mode BatchNorm does not keep)."""
    import re

    out = {}
    qkv = {}
    for key, value in generator.items():
        m = re.fullmatch(r"encoder\.backbone\.dino\.block_(\d+)\.MultiHeadDotProductAttention_0\."
                         r"(query|key|value)\.(weight|bias)", key)
        if m:
            qkv.setdefault((m[1], m[3]), {})[m[2]] = value
            continue
        name, matched = key, False
        for pattern, template in _REFERENCE_RULES:
            if re.fullmatch(pattern, name):
                name, matched = re.sub(pattern, template, name), True
        if not matched:
            raise KeyError(f"no reference name for {key}")
        out[name] = value
    for (block, part), values in qkv.items():
        out[f"encoder.backbone.dino.blocks.{block}.attn.qkv.{part}"] = torch.cat(
            [values["query"], values["key"], values["value"]])
    if discriminator is not None:
        # [Conv, LeakyReLU], n_layers x [Conv, BatchNorm, LeakyReLU], Conv.
        def index(name):
            kind, n = name.split("_")
            if n == "out":
                return 3 * n_layers + 2
            return 0 if n == "0" else 3 * int(n) - (kind == "conv")

        for key, value in discriminator.items():
            name, part = key.rsplit(".", 1)
            kind = name.split("_")[0]
            out[f"discriminator.main.{index(name)}.{part}"] = value
            if kind == "bn":
                out[f"discriminator.main.{index(name)}.running_mean"] = torch.zeros_like(value)
                out[f"discriminator.main.{index(name)}.running_var"] = torch.ones_like(value)
                out[f"discriminator.main.{index(name)}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out


def inspection_phase(seed: int, device, model_overrides: tuple = (), size: int = 256) -> dict:
    """What a user does with a released model, on the flagship re10k model
    at full width (seeded weights as `like_trained` leaves them):
      (i) convert and serve: the generator and PatchGAN written in the
          released checkpoint's layout (`reference_state_dict`), converted by
          scripts.convert_checkpoint, then `main` mode=test over 2 synthetic
          scenes (3 target views each, from an evaluation index) from the
          converted file and from the model's own checkpoint: every
          reference tensor mapped, no generator tensor left seeded, the PNGs
          bit for bit the same, 6 launches of each forward kernel a run;
      (ii) `render_projections` at 256x256 of one scene's 393,216 Gaussians:
          each axis's largest tile rect (its cap), pairs, ms, and 3
          composite_forward<4> launches; a 128x128
          projection of a 32,768-Gaussian subset against the dense plain
          version within 2e-4; duplicate_with_keys at the widest
          projection's inputs with its cap and with 64 slots (int64 masks)
          against its plain version (exactly) and timed;
      (iii) the encoder panels (capture_attention on the epipolar
          transformer) and export_gaussians_ply of the 393,216 Gaussians,
          read back exactly by load_ply;
      (iv) scripts.render_uncertainty on (i)'s converted checkpoint and
          scripts.visualize_epipolar_lines on an RE10k root written from the
          fixtures: finite images of the expected shapes.
    Returns the launches of (i)'s converted run, (ii) and (iv)'s
    render_uncertainty, and the phase's numbers. (`model_overrides` and
    `size` shrink the model and the images for a rehearsal on the CPU.)"""
    import functools

    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.main import main as run_main
    from latentsplat_tpu_torch.misc.image_io import load_image
    from latentsplat_tpu_torch.model.discriminator.patch_gan import DiscriminatorPatchGan
    from latentsplat_tpu_torch.model.encoder import visualization as encvis
    from latentsplat_tpu_torch.model.latentsplat import LatentSplat
    from latentsplat_tpu_torch.model.ply_export import load_ply
    from latentsplat_tpu_torch.model.types import Gaussians
    from latentsplat_tpu_torch.ops.rasterize import api, kernels
    from latentsplat_tpu_torch.ops.rasterize.tiled import MAX_TILES_PER_GAUSSIAN, tile_rects
    from latentsplat_tpu_torch.scripts import convert_checkpoint, render_uncertainty, visualize_epipolar_lines
    from latentsplat_tpu_torch.visualization import validation_in_3d

    on_card = device.type == "cuda"   # the kernels launch (and count) only there

    def sync():
        if on_card:
            torch.cuda.synchronize()

    print(f"inspection phase on {card() if device.type == 'cuda' else device}")
    phase_start = time.perf_counter()
    out: dict = {"launches": {}, "seconds": {}}
    cfg = load_config("re10k", [f"seed={seed}", *model_overrides])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_inspection_") as tmp:
        tmp = Path(tmp)
        # (i) convert and serve
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = like_trained(LatentSplat(cfg.model, tuple(cfg.dataset.background_color)))
            torch.manual_seed(seed)
            discriminator = DiscriminatorPatchGan(cfg.model.discriminator)
        own = tmp / "own.ckpt"
        torch.save({"step": 0, "generator": model.state_dict(), "discriminator": discriminator.state_dict()}, own)
        released = tmp / "re10k.ckpt"
        torch.save({"state_dict": reference_state_dict(model.state_dict(), discriminator.state_dict(),
                                                       cfg.model.discriminator.n_layers),
                    "global_step": 0}, released)
        del discriminator
        start = time.perf_counter()
        counts = convert_checkpoint.main([str(released), str(tmp / "converted.ckpt"), "+experiment=re10k", f"seed={seed}",
                                          *model_overrides])
        out["seconds"]["convert"] = time.perf_counter() - start
        released.unlink()
        if counts["unmapped"] or counts["seeded"] or counts["mapped"] + counts["batch_norm_statistics"] != counts["read"]:
            raise AssertionError(f"(i) the conversion left tensors unmapped or seeded: {counts}")
        index = tmp / "index.json"
        index.write_text(json.dumps({f"synthetic_{i:04d}": {"context": [0, 45], "target": [10, 22, 35]}
                                     for i in range(2)}))
        data = {"name": "synthetic", "num_scenes": 2, "num_frames": 48, "image_shape": [size, size],
                "view_sampler": {"name": "evaluation", "index_path": str(index)}}
        common = ["+experiment=re10k", f"seed={seed}", f"dataset={json.dumps(data)}", *model_overrides]

        def serve(name: str, checkpoint: Path) -> tuple[dict, dict]:
            reset_launches()
            start = time.perf_counter()
            run_main([*common, "mode=test", f"output_dir={tmp / name}", f"test.output_path={tmp / name / 'test'}",
                      f"checkpointing.load={checkpoint}"], device=device)
            out["seconds"][f"serve_{name}"] = time.perf_counter() - start
            pngs = {p.relative_to(tmp / name / "test"): p.read_bytes() for p in (tmp / name / "test").rglob("*.png")}
            return read_launches(), pngs

        _, own_pngs = serve("own", own)
        own.unlink()
        launches, converted_pngs = serve("converted", tmp / "converted.ckpt")
        out["launches"]["serve_converted"] = launches
        if len(own_pngs) != 6 or own_pngs != converted_pngs:
            raise AssertionError(f"(i) the converted checkpoint served other PNGs ({len(converted_pngs)} "
                                 f"against {len(own_pngs)}, {sum(own_pngs.get(k) != v for k, v in converted_pngs.items())} differ)")
        if on_card and any(launches[k] != 6 for k in FORWARD_KERNELS):
            raise AssertionError(f"(i) forward kernel launches {launches}, not 6 each")
        print(f"  (i) convert_checkpoint: {counts}; serving the converted file: 6 PNGs bit for bit those of the "
              f"model's own checkpoint, launches {launches}")

        # (ii) projections
        model = model.to(device).eval()
        batch = make_batch(np.random.default_rng(seed), 2, 4, size, device)
        shimmed, gaussians = slice_gaussians(model, batch, seed)
        records = []
        composite_tiled = api.composite_tiled
        render_orthographic = validation_in_3d.render_orthographic

        def spy_composite(sg, shape, background, cap):
            result = composite_tiled(sg, shape, background, cap)
            records.append({"cap": cap, "pairs": result[3], "sg": sg})
            return result

        def timed_orthographic(*args, **kwargs):
            sync()
            start = time.perf_counter()
            result = render_orthographic(*args, **kwargs)
            sync()
            records[-1]["ms"] = 1e3 * (time.perf_counter() - start)
            return result

        api.composite_tiled = spy_composite
        validation_in_3d.render_orthographic = timed_orthographic
        try:
            validation_in_3d.render_projections(gaussians, size)          # warm-up
            records.clear()
            reset_launches()
            images = validation_in_3d.render_projections(gaussians, size)
            launches = read_launches()
        finally:
            api.composite_tiled = composite_tiled
            validation_in_3d.render_orthographic = render_orthographic
        out["launches"]["projections"] = launches
        if images.shape[:2] != (1, 3) or not np.isfinite(images).all():
            raise AssertionError(f"(ii) projections {images.shape}, finite {np.isfinite(images).all()}")
        if on_card and (launches["composite_forward_by_channels"] != {4: 3} or launches["duplicate_with_keys"] != 3):
            raise AssertionError(f"(ii) projection launches {launches}, not 3 of composite_forward<4>")
        out["projections"] = [{k: r[k] for k in ("cap", "pairs", "ms")} for r in records]
        print(f"  (ii) projections at {size}x{size} of {gaussians.means.shape[1]} Gaussians, per axis (largest rect in "
              f"tiles = cap, pairs, ms): {out['projections']}; launches {launches}")
        # duplicate_with_keys at the widest projection's inputs, with its
        # covering cap and with the most slots an int64 mask holds (the
        # 64-bit instantiation): both exact against the plain version, the
        # same pairs (the covering cap keeps every slot), and timed.
        widest = max(records, key=lambda r: r["cap"])
        sg, cap = widest["sg"], widest["cap"]
        depth = sg.depth.contiguous()
        flush = torch.empty(FLUSH_BYTES // 4, device=device) if on_card else None
        pairs, out["duplicate_ms"] = [], {}
        for slots in (cap, MAX_TILES_PER_GAUSSIAN):
            counts_, base, nx, mask = tile_rects(sg, size // 16, size // 16, slots)
            ids, keys = kernels.duplicate_with_keys(counts_, mask, base, nx, depth, size // 16, slots)
            ref_ids, ref_keys = kernels.duplicate_with_keys_reference(counts_, mask, base, nx, depth, size // 16, slots)
            if not (torch.equal(ids, ref_ids) and torch.equal(keys, ref_keys)):
                raise AssertionError(f"(ii) duplicate_with_keys ({mask.dtype} mask, cap {slots}) differs from its plain version")
            pairs.append((ids, keys))
            if on_card:
                args = (torch.cumsum(counts_, dim=0, dtype=torch.int64), mask, base, nx, depth, size // 16,
                        torch.empty_like(ids), torch.empty_like(keys))
                out["duplicate_ms"][f"{mask.dtype}, cap {slots}"] = device_ms(
                    lambda: kernels._launch_duplicate_with_keys(*args), flush=flush)
        if not all(torch.equal(a, b) for a, b in zip(*pairs)):
            raise AssertionError("(ii) the covering cap dropped pairs that the widest mask keeps")
        del records, sg, widest, pairs, flush
        subset = torch.randperm(gaussians.means.shape[1], generator=torch.Generator().manual_seed(seed))[:32768]
        subset = subset.to(device)
        small = Gaussians(gaussians.means[:, subset], gaussians.covariances[:, subset], gaussians.opacities[:, subset],
                          gaussians.color_harmonics[:, subset])
        tiled = validation_in_3d.render_projections(small, size // 2, draw_label=False)
        validation_in_3d.render_orthographic = functools.partial(render_orthographic, backend="dense")
        try:
            dense = validation_in_3d.render_projections(small, size // 2, draw_label=False)
        finally:
            validation_in_3d.render_orthographic = render_orthographic
        err = float(np.abs(tiled - dense).max())
        out["projection_vs_dense"] = err
        print(f"  (ii) duplicate_with_keys at the widest projection, covering cap {cap} and cap "
              f"{MAX_TILES_PER_GAUSSIAN}: exact, the same pairs; launch ms (L2 flushed) {out['duplicate_ms']}; "
              f"{size // 2}x{size // 2} projections of 32,768 Gaussians, tiled vs dense plain: max |diff| {err:.3g}")
        if err > 2e-4:
            raise AssertionError(f"(ii) tiled projection vs dense: {err} > 2e-4")

        # (iii) encoder panels and PLY
        sync()
        start = time.perf_counter()
        context = shimmed["context"]
        captured = encvis.capture_attention(model.encoder, context, prefix="epipolar_transformer.transformer.attn")
        sampling, det = captured["sampling"], captured["gaussians"]
        b, v = context["image"].shape[:2]
        rays, s = sampling.xy_sample.shape[3:5]
        layers = []
        for name in sorted(captured["attention"]):
            weights = captured["attention"][name]                  # (b v r, heads, 1, ov s)
            heads = weights.shape[1]
            layers.append(weights.reshape(b, v, rays, heads, v - 1, s)[0, 0, :, :, 0].permute(1, 0, 2))
        attention = torch.stack(layers)                            # (layer, head, ray, sample)
        pdf = attention[-1].mean(dim=0)[None, None]
        panels = {
            "epipolar_samples": encvis.visualize_epipolar_samples(context, sampling),
            "depth": encvis.visualize_depth(context, det, 1),
            "overlaps": encvis.visualize_overlaps(context, sampling, downscale=cfg.model.encoder.epipolar_transformer.downscale),
            "gaussians": encvis.visualize_gaussians(context, det, 1),
            "probabilities": encvis.visualize_probabilities(context, sampling, pdf),
            "attention_maps": encvis.visualize_attention_maps(context, sampling, attention),
            "epipolar_color_samples": encvis.visualize_epipolar_color_samples(context),
        }
        out["seconds"]["panels"] = time.perf_counter() - start
        for name, panel in panels.items():
            if panel.ndim != 3 or panel.shape[-1] != 3 or not np.isfinite(panel).all():
                raise AssertionError(f"(iii) panel {name}: {panel.shape}, finite {np.isfinite(panel).all()}")
        start = time.perf_counter()
        ply = tmp / "scene.ply"
        encvis.export_gaussians_ply(gaussians, context, ply)
        out["seconds"]["ply"] = time.perf_counter() - start
        columns = load_ply(ply)
        written = ply.read_bytes().split(b"end_header\n", 1)[1]
        n = gaussians.means.shape[1]
        if len(columns) != 17 or any(c.shape != (n,) for c in columns.values()) or \
                np.stack(list(columns.values()), axis=1).tobytes() != written or \
                not all(np.isfinite(c).all() for c in columns.values()):
            raise AssertionError("(iii) load_ply does not read back what export_ply wrote")
        out["ply_bytes"] = ply.stat().st_size
        print(f"  (iii) panels {{{', '.join(f'{k}: {p.shape}' for k, p in panels.items())}}} in "
              f"{out['seconds']['panels']:.2f} s; PLY of {n} Gaussians: {out['ply_bytes']} bytes in "
              f"{out['seconds']['ply']:.2f} s, read back exactly")
        del model, gaussians, det, captured, small, shimmed

        # (iv) the scripts
        reset_launches()
        start = time.perf_counter()
        render_uncertainty.main([*common, f"checkpointing.load={tmp / 'converted.ckpt'}",
                                 f"output_dir={tmp / 'uncertainty_run'}", f"output_path={tmp / 'uncertainty'}"],
                                device=device)
        out["seconds"]["render_uncertainty"] = time.perf_counter() - start
        out["launches"]["render_uncertainty"] = launches = read_launches()
        pngs = sorted((tmp / "uncertainty").rglob("*.png"))
        images = [load_image(p) for p in pngs]
        if len(pngs) != 6 or any(i.shape != (size, 3 * size + 16, 3) for i in images):
            raise AssertionError(f"(iv) render_uncertainty wrote {[i.shape for i in images]}")
        if on_card and any(launches[k] != 6 for k in FORWARD_KERNELS):
            raise AssertionError(f"(iv) render_uncertainty launches {launches}, not 6 each")
        root = tmp / "re10k"
        jpeg_tools().write_re10k_root(root, scenes=2, frames=48)
        start = time.perf_counter()
        visualize_epipolar_lines.main(["+experiment=re10k", f"dataset.roots=[{root}]", f"dataset.image_shape=[{size}, {size}]",
                                       f"output_path={tmp / 'epipolar'}"], device=device)
        out["seconds"]["visualize_epipolar_lines"] = time.perf_counter() - start
        lines = [load_image(p) for p in sorted((tmp / "epipolar").glob("*.png"))]
        if len(lines) != 2 or any(i.shape != (size, 2 * size + 8, 3) for i in lines):
            raise AssertionError(f"(iv) visualize_epipolar_lines wrote {[i.shape for i in lines]}")
        print(f"  (iv) render_uncertainty: {len(pngs)} PNGs of {images[0].shape} in "
              f"{out['seconds']['render_uncertainty']:.2f} s, launches {launches}; visualize_epipolar_lines: "
              f"{len(lines)} PNGs of {lines[0].shape} in {out['seconds']['visualize_epipolar_lines']:.2f} s")
    out["seconds"]["phase"] = time.perf_counter() - phase_start
    print(f"inspection phase seconds: " + json.dumps({k: round(v, 4) for k, v in out["seconds"].items()}))
    return out


def reset_launches() -> None:
    from latentsplat_tpu_torch.ops.rasterize import kernels

    for key in kernels.launch_counts:
        kernels.launch_counts[key] = 0
    kernels.composite_forward_launches.clear()


def read_launches() -> dict:
    """Each kernel's launches, and composite_forward's by channel count."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    return {**kernels.launch_counts, "composite_forward_by_channels": dict(kernels.composite_forward_launches)}


def jpeg_tools():
    """tests/torch_jpeg_tools.py (fixture paths, hashes and the fixture-data
    writers), loaded by its path: a machine may have an installed package
    named `tests` that would shadow the repository's directory."""
    import importlib.util

    name = "torch_jpeg_tools"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / "tests" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def check_host_library() -> None:
    """(i) Build the host C library and hold every fixture's decode and crop
    shim (256x256) against the sha256 in its manifest, which PIL's decode
    matched where the fixtures were made; the progressive fixture must raise."""
    from latentsplat_tpu_torch import host_build
    from latentsplat_tpu_torch.dataset.jpeg import CorruptJPEGError, decode_jpeg
    tools = jpeg_tools()

    start = time.perf_counter()
    host_build.load_library()
    print(f"data phase: host library {host_build.library_path().name} ready in {time.perf_counter() - start:.2f} s "
          f"(cc {' '.join(host_build.CFLAGS)})")
    manifest = json.loads((tools.FIXTURE_DIR / "manifest.json").read_text())
    for name, entry in manifest.items():
        data = (tools.FIXTURE_DIR / name).read_bytes()
        if "error" in entry:
            try:
                decode_jpeg(data)
            except ValueError as e:
                if entry["error"] not in str(e) or isinstance(e, CorruptJPEGError):
                    raise AssertionError(f"{name}: raised {e!r}, which does not name {entry['error']}") from e
                continue
            raise AssertionError(f"{name}: decoded, but must raise naming {entry['error']}")
        rgb = decode_jpeg(data)
        if tools.sha256(rgb) != entry["port_sha256"] or entry["port_sha256"] != entry["pil_sha256"]:
            raise AssertionError(f"{name} ({entry['mode']}): the decode's sha256 differs from the manifest's")
        if tools.crop_shim_hash(rgb) != entry["crop_sha256"]:
            raise AssertionError(f"{name} ({entry['mode']}): the crop shim's sha256 differs from the manifest's")
    print(f"data phase: {len(manifest)} fixtures decoded and cropped with the manifest's sha256 "
          "(PIL's bits); the progressive one raised")


def time_input_path(root: Path) -> dict:
    """(ii) The host input path on this machine's CPU: decode and crop-shim
    milliseconds per 640x360 frame (medians), and the RE10k train loader's
    examples/s with 0 and 4 worker processes, beside the 2 examples a train
    step takes."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.dataset import get_dataset
    from latentsplat_tpu_torch.dataset.jpeg import decode_jpeg
    from latentsplat_tpu_torch.dataset.loader import make_loader
    from latentsplat_tpu_torch.dataset.shims import rescale_and_crop
    from latentsplat_tpu_torch.dataset.view_samplers import get_view_sampler
    from latentsplat_tpu_torch.training.step_tracker import StepTracker
    tools = jpeg_tools()

    frames = [tools.fixture_bytes(name) for name in sorted(tools.RE10K_FRAMES)]
    decode_ms, crop_ms = [], []
    intrinsics = np.eye(3, dtype=np.float32)[None]
    for _ in range(5):
        for data in frames:
            start = time.perf_counter()
            rgb = decode_jpeg(data)
            decode_ms.append((time.perf_counter() - start) * 1e3)
            start = time.perf_counter()
            rescale_and_crop(rgb[None], intrinsics, (256, 256))
            crop_ms.append((time.perf_counter() - start) * 1e3)
    out = {"decode_ms": statistics.median(decode_ms), "crop_ms": statistics.median(crop_ms)}

    cfg = load_config("re10k", [f"dataset.roots=[{root}]"])
    for workers, n_batches in ((0, 12), (4, 24)):
        sampler = get_view_sampler(cfg.dataset.view_sampler, "train", False, False, StepTracker())
        loader = make_loader(get_dataset(cfg.dataset, "train", sampler), 2, repeat=True, num_workers=workers,
                             seed=1234)
        try:
            start = time.perf_counter()
            next(loader)
            first_s = time.perf_counter() - start
            start = time.perf_counter()
            for _ in range(n_batches):
                next(loader)
            rate = 2 * n_batches / (time.perf_counter() - start)
        finally:
            if workers:
                loader.close()
        out[f"examples_per_s_{workers}_workers"] = rate
        out[f"first_batch_s_{workers}_workers"] = first_s
    print(f"data phase on {card()} (host CPU: {os.cpu_count()} cores): decode {out['decode_ms']:.3f} ms and crop "
          f"shim {out['crop_ms']:.3f} ms per 640x360 frame (medians of 30); RE10k train loader "
          f"{out['examples_per_s_0_workers']:.2f} examples/s with 0 workers (first batch "
          f"{out['first_batch_s_0_workers']:.2f} s), {out['examples_per_s_4_workers']:.2f} with 4 (first batch "
          f"{out['first_batch_s_4_workers']:.2f} s), against 2 examples a train step")
    return out


@contextmanager
def first_train_batch(store: list):
    """While open, the first batch that the trainer's fit takes from its
    loader (before `strip_batch` drops its scenes and indices) goes to `store`."""
    from latentsplat_tpu_torch.training import trainer

    original = trainer.strip_batch

    def strip_batch(batch):
        if not store:
            store.append(batch)
        return original(batch)

    trainer.strip_batch = strip_batch
    try:
        yield
    finally:
        trainer.strip_batch = original


def check_first_batch(batch: dict, chunk_path: Path, size: int) -> str:
    """The first train batch's context images, which worker processes
    decoded and cropped, against the same frames decoded and cropped here:
    equal bit for bit, as decoded or mirrored before the crop (the
    augmentation flips before the crop shim, whose window is off-center by
    a column when the margin is odd)."""
    from latentsplat_tpu_torch.dataset.jpeg import decode_jpeg
    from latentsplat_tpu_torch.dataset.shims import rescale_and_crop

    chunk = {scene["key"]: scene for scene in torch.load(chunk_path, weights_only=True)}
    kinds = []
    for b, scene in enumerate(batch["scene"]):
        indices = batch["context"]["index"][b]
        rgb = np.stack([decode_jpeg(chunk[scene]["images"][int(i)].numpy().tobytes()) for i in indices])
        intrinsics = np.tile(np.eye(3, dtype=np.float32), (len(indices), 1, 1))
        got = batch["context"]["image"][b]
        if np.array_equal(got, rescale_and_crop(rgb, intrinsics, (size, size))[0]):
            kinds.append(f"{scene} {indices.tolist()} as decoded")
        elif np.array_equal(got, rescale_and_crop(rgb[..., ::-1, :].copy(), intrinsics, (size, size))[0]):
            kinds.append(f"{scene} {indices.tolist()} flipped")
        else:
            raise AssertionError(f"first train batch, {scene} {indices.tolist()}: the workers' context images "
                                 "differ from the parent's decode")
    return "; ".join(kinds)


def check_run(run: Path, label: str, steps: int = 2) -> list[float]:
    """Finite generator losses at steps 1..steps, and the checkpoint of the last step."""
    from latentsplat_tpu_torch.training.checkpointing import latest_checkpoint

    records = [r for r in read_records(run) if "generator/total" in r]
    losses = [r["generator/total"] for r in records]
    if [r["step"] for r in records] != list(range(1, steps + 1)) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"({label}) logged {[(r['step'], r['generator/total']) for r in records]}")
    ckpt = latest_checkpoint(run / "checkpoints")
    if ckpt is None or ckpt.name != f"step_{steps:08d}":
        raise AssertionError(f"({label}) wrote no checkpoint at step {steps}: {ckpt}")
    return losses


def data_phase(seed: int, device, model_overrides: tuple = (), size: int = 256) -> dict:
    """The real-data input path: (i) the host library and the fixtures'
    hashes, (ii) its times, (iii) an RE10k root (2 scenes of 48 frames, the
    640x360 fixtures' JPEG bytes, the synthetic dataset's cameras) and a CO3D
    tree (2 sequences of 48 frames from the CO3D-like fixtures, one frame of
    each at a larger size) in a temporary directory, and (iv) the entry
    point on both at full width (256x256), through forkserver loader workers
    (4 for train, 2 for val and test):
      (d) +experiment=re10k mode=train, 2 steps, a validation, its test (the
          bounded sampler's 48 target views a scene); the evaluation index
          over the test stage (scripts.generate_evaluation_index); (e) mode=test
          over it (3 target views a scene);
      (f) +experiment=co3d_hydrant mode=train, 2 steps, its test (48 target
          views a sequence: max_distance_to_context_views cut from 100 to 11);
          scripts.generate_co3d_evaluation_index; (g) mode=test over it;
          scripts.generate_gt_image_directory over that index.
    (v) Checks finite losses, checkpoints, one PNG per target view, the
    ground-truth PNGs and the first train batch of (d) against the parent's
    decode. Returns the times and each run's kernel launches. (`model_overrides`
    and `size` shrink the model and the images for a rehearsal on the CPU.)"""
    from latentsplat_tpu_torch.main import main as run_main
    from latentsplat_tpu_torch.misc.image_io import load_image
    from latentsplat_tpu_torch.scripts import (
        generate_co3d_evaluation_index,
        generate_evaluation_index,
        generate_gt_image_directory,
    )
    from latentsplat_tpu_torch.training.checkpointing import latest_checkpoint
    tools = jpeg_tools()

    check_host_library()
    out = {"launches": {}, "seconds": {}, "peak_gb": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        tmp = Path(tmp)
        re10k, co3d = tmp / "re10k", tmp / "co3d"
        scenes = tools.write_re10k_root(re10k, scenes=2, frames=48)
        split = tools.write_co3d_tree(co3d, sequences=2, frames=48)
        out.update(time_input_path(re10k))
        workers = ["data_loader.train.num_workers=4", "data_loader.val.num_workers=2",
                   "data_loader.test.num_workers=2"]
        common = [f"seed={seed}", "trainer.log_every_n_steps=1", "checkpointing.every_n_train_steps=2",
                  f"dataset.image_shape=[{size}, {size}]", *workers, *model_overrides]

        def call(name: str, experiment: str, *extra: str) -> Path:
            args = [f"+experiment={experiment}", *common, f"output_dir={tmp / name}",
                    f"test.output_path={tmp / name / 'test'}", *extra]
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            reset_launches()
            start = time.perf_counter()
            run = run_main(args, device=device)
            out["seconds"][name] = time.perf_counter() - start
            out["launches"][name] = read_launches()
            out["peak_gb"][name] = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None
            print(f"data phase ({name}): main(+experiment={experiment} ... {' '.join(extra)}) took "
                  f"{out['seconds'][name]:.2f} s, peak memory {out['peak_gb'][name]} GB, "
                  f"launches {out['launches'][name]}")
            return run

        def count_pngs(root: Path, n: int, pattern: str = "color/*.png") -> None:
            pngs = sorted(root.rglob(pattern))
            if len(pngs) != n or any(load_image(p).shape != (size, size, 3) for p in pngs):
                raise AssertionError(f"{root}: {len(pngs)} PNGs ({pattern}), expected {n} of {size}x{size}")

        # RE10k: train, the index, test over it.
        first = []
        with first_train_batch(first):
            run_d = call("d", "re10k", f"dataset.roots=[{re10k}]", "mode=train", "trainer.max_steps=2",
                         "trainer.val_check_interval=2")
        losses = check_run(run_d, "d")
        print(f"  (d) generator/total {losses}; first train batch: {check_first_batch(first[0], re10k / 'train' / '000000.torch', size)}")
        count_pngs(tmp / "d" / "test" / "latentsplat_tpu", 2 * 48)
        if len([r for r in read_records(run_d) if "val/psnr_deterministic" in r]) != 1:
            raise AssertionError("(d) ran no validation")
        index = generate_evaluation_index.main(
            ["+experiment=re10k", f"dataset.roots=[{re10k}]", f"dataset.image_shape=[{size}, {size}]",
             "dataset.view_sampler={name: all}",
             f"index_generator.output_path={tmp / 'index_re10k'}"], device=device)
        entries = json.loads(index.read_text())
        print(f"  RE10k evaluation index: {entries}")
        if sorted(entries) != scenes or not all(len(v) == 1 and len(v[0]["target"]) == 3 for v in entries.values()):
            raise AssertionError("the RE10k evaluation index does not hold one entry of 3 targets for each scene")
        call("e", "re10k", f"dataset.roots=[{re10k}]", "mode=test", f"checkpointing.load={latest_checkpoint(run_d / 'checkpoints')}",
             "wandb.name=evaluation", f"dataset.view_sampler={{name: evaluation, index_path: {index}}}")
        count_pngs(tmp / "e" / "test" / "evaluation", 2 * 3)

        # CO3D: train, the index, test over it, the ground truth.
        co3d_data = [f"dataset.roots=[{co3d}]", f"dataset.train_split_json={split}", f"dataset.eval_split_json={split}",
                     f"dataset.image_shape=[{size}, {size}]"]
        run_f = call("f", "co3d_hydrant", *co3d_data, "mode=train", "trainer.max_steps=2",
                     "dataset.view_sampler.max_distance_to_context_views=11")
        losses = check_run(run_f, "f")
        print(f"  (f) generator/total {losses}")
        count_pngs(tmp / "f" / "test" / "latentsplat_tpu", 2 * 48)
        index = generate_co3d_evaluation_index.main(
            ["+experiment=co3d_hydrant", *co3d_data, "dataset.view_sampler={name: all}",
             f"index_generator.output_path={tmp / 'index_co3d'}"])
        entries = json.loads(index.read_text())
        print(f"  CO3D evaluation index: {entries}")
        if len(entries) != 2 or not all(len(v) == 1 and len(v[0]["target"]) == 3 for v in entries.values()):
            raise AssertionError("the CO3D evaluation index does not hold one entry of 3 targets for each sequence")
        evaluation = f"dataset.view_sampler={{name: evaluation, index_path: {index}}}"
        call("g", "co3d_hydrant", *co3d_data, "mode=test", f"checkpointing.load={latest_checkpoint(run_f / 'checkpoints')}",
             "wandb.name=evaluation", evaluation)
        count_pngs(tmp / "g" / "test" / "evaluation", 2 * 3)
        start = time.perf_counter()
        generate_gt_image_directory.main(["+experiment=co3d_hydrant", *co3d_data, evaluation, f"output_path={tmp / 'gt'}"])
        count_pngs(tmp / "gt", 2 * 3)
        count_pngs(tmp / "gt", 2 * 2, "context/*.png")
        print(f"  ground truth: {2 * 5} PNGs in {time.perf_counter() - start:.2f} s")

    if device.type == "cuda":
        for name, launches in out["launches"].items():
            kernel_names = ALL_KERNELS if name in ("d", "f") else FORWARD_KERNELS
            if min(launches[k] for k in kernel_names) < 1:
                raise AssertionError(f"({name}): a kernel of {kernel_names} did not run: {launches}")
    return out


# -- switches phase ------------------------------------------------------------

SITE_LOSSES = [
    # context and target_autoencoder: l1 + lpips + generator 0.5 + hinge
    # discriminator; target_render_latent: mse. The two autoencoder sites
    # decode without a skip tensor, so the VAE runs without skip connections.
    "model.autoencoder.skip_connections=false",
    *(f"loss.{site}={{nll: [{{name: l1}}, {{name: lpips}}], generator: {{name: generator, weight: 0.5}}, "
      f"discriminator: {{name: discriminator, loss: hinge}}}}" for site in ("context", "target_autoencoder")),
    "loss.target_render_latent={nll: [{name: mse}]}",
]
RESNET50 = "model.encoder.backbone={name: resnet, model: resnet50}"


def switch_state(cfg, seed: int, device):
    """build_trainer's state as in a run resumed at TRAIN_STEP: both
    optimizers have counted as many updates (their moments start at zero),
    so the warm-up is over."""
    state, losses, train_step = build_trainer(cfg, seed, device)
    for opt in (state.opt_gen, state.opt_disc):
        for group in opt.state.values():
            group["count"].fill_(TRAIN_STEP)
    return state, losses, train_step


def timed_steps(label: str, state, train_step, batch, seed: int, n: int):
    """`n` train steps at TRAIN_STEP: prints each step's seconds, the stage
    split and the peak, checks finite logs; returns (state, logs of each
    step, seconds of each step, peak bytes, launches over the steps)."""
    stage_s: dict[str, list[float]] = {}

    @contextmanager
    def timer(name):
        torch.cuda.synchronize()
        start = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stage_s.setdefault(name, []).append(time.perf_counter() - start)

    gen = torch.Generator(device=batch["target"]["image"].device).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seconds, all_logs = [], []
    for _ in range(n):
        start = time.perf_counter()
        state, logs = train_step(state, batch, TRAIN_STEP, generator=gen, timer=timer)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        all_logs.append({k: float(v) for k, v in logs.items()})
    launches, peak = read_launches(), torch.cuda.max_memory_allocated()
    bad = sorted({k for logs in all_logs for k, v in logs.items() if not math.isfinite(v)})
    if bad:
        raise AssertionError(f"{label}: non-finite logs {bad}")
    print(f"{label}: seconds per step {[round(x, 4) for x in seconds]}; stages (last step) "
          + ", ".join(f"{k} {v[-1]:.4f}" for k, v in stage_s.items())
          + f"; peak {peak / 2**30:.3f} GiB; launches {launches}")
    return state, all_logs, seconds, peak, launches


def flagship_noise(model, batch, seed: int) -> dict:
    """Explicit noise for one flagship step (depth uniforms, Gaussian and
    latent normals), so two runs take the same random numbers."""
    ctx, tgt = batch["context"], batch["target"]
    gen = torch.Generator(device=ctx["image"].device).manual_seed(seed)
    shape = model.depth_noise_shape(ctx)
    enc = model.cfg.encoder
    n_gaussians = shape[1] * shape[2] * shape[3] * shape[4]
    d_sh = (enc.gaussian_adapter.feature_sh_degree + 1) ** 2
    c = model.autoencoder.d_latent
    size = model.scaled_size(model.scale_factor, tgt["image"].shape[2:4])
    return {
        "depth": torch.rand(shape, generator=gen, device=gen.device),
        "gaussians": torch.randn((shape[0], n_gaussians, c, d_sh), generator=gen, device=gen.device),
        "latent": torch.randn((shape[0], tgt["image"].shape[1], *size, c), generator=gen, device=gen.device),
    }


def switch_sites(seed: int, device, size: int = 256) -> None:
    """(s1) The context, target_autoencoder and target_render_latent loss
    sites, all live, on the flagship at full width: 2 scenes, or 1 if 2 do
    not fit the card (said so)."""
    from latentsplat_tpu_torch.config import load_config

    cfg = load_config("re10k", SITE_LOSSES)
    state, _, train_step = switch_state(cfg, seed, device)
    for scenes in (2, 1):
        batch = state.model.data_shim(make_batch(np.random.default_rng(seed + 2), 2, 4, size, device, scenes))
        try:
            state, all_logs, _, _, launches = timed_steps(
                f"switches (s1) loss sites, {scenes} scenes", state, train_step, batch, seed + 3, 3)
            break
        except torch.cuda.OutOfMemoryError:
            del batch
            torch.cuda.empty_cache()
            print(f"switches (s1): {scenes} scenes do not fit the card; 1 scene")
    logs = all_logs[-1]
    for site in ("context", "target_autoencoder", "target_combined"):
        keys = (f"{site}/generator", f"{site}/discriminator/fake", f"{site}/discriminator/real",
                f"{site}/adaptive_weight")
        missing = [k for k in keys if k not in logs]
        if missing:
            raise AssertionError(f"(s1): the {site} GAN site logged no {missing}")
        print(f"switches (s1) {site}: -mean fake logits {logs[keys[0]]:.5g}, discriminator fake {logs[keys[1]]:.5g}, "
              f"real {logs[keys[2]]:.5g}, adaptive weight {logs[keys[3]]:.5g}")
    for key in ("train/context/psnr", "train/target_autoencoder/psnr", "target_render_latent/mse",
                "context/l1", "context/lpips", "target_autoencoder/l1", "target_autoencoder/lpips"):
        if key not in logs:
            raise AssertionError(f"(s1): no {key} in the logs")
    print("switches (s1) last step: " + ", ".join(f"{k} {v:.5g}" for k, v in sorted(logs.items())
                                                 if k.startswith(("train/", "target_render_latent", "context/",
                                                                  "target_autoencoder/", "generator/"))))
    if min(launches[k] for k in ALL_KERNELS) < 1:
        raise AssertionError(f"(s1): a kernel did not run: {launches}")


def switch_encode_latents(seed: int, device, size: int = 256) -> None:
    """(s2) encode_latents with the ResNet-50 backbone: one serving batch,
    2 train steps and `main` in test mode, whose benchmark.json must hold
    autoencoder_encoder."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.main import main as run_main
    from latentsplat_tpu_torch.model.latentsplat import render_full
    from latentsplat_tpu_torch.training.checkpointing import save_checkpoint

    overrides = ["model.encode_latents=true", RESNET50]
    cfg = load_config("re10k", overrides)
    state, _, train_step = switch_state(cfg, seed, device)
    model = state.model
    batch = make_batch(np.random.default_rng(seed), 2, 4, size, device)
    stage_s: dict[str, float] = {}

    @contextmanager
    def timer(name):
        torch.cuda.synchronize()
        start = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stage_s[name] = time.perf_counter() - start

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        shimmed = model.data_shim(batch)
        latents = model.autoencoder.encode(shimmed["context"]["image"]).mode()
        gaussians = model.encoder(shimmed["context"], 0, generator=gen, features=latents)
    n_gaussians = gaussians.means.shape[1]
    del gaussians
    model.eval()
    render_full(model, batch, generator=gen.manual_seed(seed))
    reset_launches()
    out = render_full(model, batch, generator=gen.manual_seed(seed), timer=timer)
    torch.cuda.synchronize()
    launches = read_launches()
    model.train()
    if not torch.isfinite(out["image"]).all() or tuple(out["image"].shape) != (1, 4, size, size, 3):
        raise AssertionError("(s2): the served image is not finite or has the wrong shape")
    print(f"switches (s2) encode_latents, resnet50: latents {tuple(latents.shape)}, {n_gaussians} Gaussians "
          f"a scene; serving stages (s) " + ", ".join(f"{k} {v:.4f}" for k, v in stage_s.items())
          + f"; launches {launches}")
    if n_gaussians != 2 * size * size * cfg.model.encoder.gaussians_per_pixel:
        raise AssertionError(f"(s2): {n_gaussians} Gaussians a scene")
    if min(launches[k] for k in FORWARD_KERNELS) < 1 or "autoencoder_encoder" not in stage_s:
        raise AssertionError("(s2): the serving path skipped the VAE encoder or a kernel")
    batch = model.data_shim(make_batch(np.random.default_rng(seed + 2), 2, 4, size, device, 2))
    before = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("autoencoder.encoder.")}
    _, _, _, _, launches = timed_steps("switches (s2) encode_latents train", state, train_step, batch, seed + 3, 2)
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters() if n in before)
    print(f"switches (s2): VAE encoder tensors changed by the steps {moved} of {len(before)}")
    if moved == 0 or min(launches[k] for k in ALL_KERNELS) < 1:
        raise AssertionError("(s2): the VAE encoder did not train or a kernel did not run")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_latents_") as tmp:
        tmp = Path(tmp)
        ckpt = save_checkpoint(state, tmp / "checkpoints", 2)
        del state, model, train_step, batch, before
        torch.cuda.empty_cache()
        index = tmp / "index.json"
        entry = {"context": [0, 45], "target": [10, 22, 35]}
        index.write_text(json.dumps({f"synthetic_{i:04d}": [entry] for i in range(2)}))
        data = {"name": "synthetic", "num_scenes": 2, "num_frames": 48, "image_shape": [size, size],
                "view_sampler": {"name": "evaluation", "index_path": str(index)}}
        reset_launches()
        start = time.perf_counter()
        run_main(["+experiment=re10k", *overrides, "mode=test", f"seed={seed}", f"dataset={json.dumps(data)}",
                  f"checkpointing.load={ckpt}", "wandb.name=latents", f"output_dir={tmp / 'run'}",
                  f"test.output_path={tmp / 'test'}"], device=device)
        launches = read_launches()
        root = tmp / "test" / "latents"
        bench = json.loads((root / "benchmark.json").read_text())
        pngs = sorted(root.rglob("color/*.png"))
    print(f"switches (s2) main test mode: {time.perf_counter() - start:.2f} s, {len(pngs)} PNGs, benchmark.json "
          + ", ".join(f"{k} mean {statistics.mean(v):.4f} s ({len(v)} entries)" for k, v in bench.items())
          + f"; launches {launches}")
    if set(bench) != {"autoencoder_encoder", "encoder", "decoder", "autoencoder_decoder"} or len(pngs) != 6:
        raise AssertionError(f"(s2) test mode: tags {sorted(bench)}, {len(pngs)} PNGs")
    if launches["composite_forward"] != 6:
        raise AssertionError(f"(s2) test mode: composite_forward ran {launches['composite_forward']} times, not 6")


def switch_latents(seed: int, device, size: int = 256) -> tuple[list[dict], dict]:
    """(s3) variational=latents: at view 0 composite_forward and
    composite_backward at 12 channels and reduce_pairs at rows of 18 against
    their plain versions, timed beside their bounds; then 2 train steps.
    Returns the three records and the steps' launches."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.ops.rasterize import kernels

    cfg = load_config("re10k", ["model.variational=latents"])
    state, _, train_step = switch_state(cfg, seed, device)
    model = state.model.eval()
    sg, shape = first_view(model, make_batch(np.random.default_rng(seed), 2, 4, size, device), seed, flatten=True)
    view = depth_view(sg, shape)
    if view["attrs"].shape[1] != 18:
        raise AssertionError(f"(s3): rows of {view['attrs'].shape[1]}, not 6 + 12")
    err = check_forward(view, "switches (s3) view 0")
    args = (view["gids"], view["ranges"], view["attrs"], view["tiles_x"], shape)
    ms = device_ms(lambda: kernels.composite_forward(*args))
    plain_ms = cuda_ms(lambda: kernels.composite_forward_reference(*args), 3)
    view["work"] = composite_work(view)
    print(f"switches (s3): composite_forward at 12 channels {ms:.4f} ms (device) vs plain {plain_ms:.4f} ms; "
          f"{view['gids'].shape[0]} pairs")
    records = [forward_entry(err, ms, plain_ms, view)]
    records += backward_kernel_phase(view, seed)
    records[1]["channels"] = 12
    records[2]["row"] = 18
    del view, sg
    model.train()
    batch = model.data_shim(make_batch(np.random.default_rng(seed + 2), 2, 4, size, device, 2))
    _, _, _, _, launches = timed_steps("switches (s3) variational=latents train", state, train_step, batch,
                                       seed + 3, 2)
    by_channels = launches["composite_forward_by_channels"]
    if by_channels.get(12) != 2 * 8 or launches["composite_backward"] != 2 * 8 or launches["reduce_pairs"] != 2 * 8:
        raise AssertionError(f"(s3): the 12-channel kernels ran {launches}, not 8 times a step")
    return records, launches


def leaf_errors(a: dict, b: dict) -> tuple[float, str]:
    """The largest |a - b| of any leaf relative to that leaf's largest |b|,
    and its name. A leaf whose gradient is zero but for rounding (a conv
    bias right before a GroupNorm) is normalised by 1e-4 of the largest
    gradient of all."""
    floor = 1e-4 * max(g.abs().max() for g in b.values())
    return max((((a[n] - g).abs().max() / g.abs().max().clamp(min=floor)).item(), n) for n, g in b.items())


def switch_remat_bf16(seed: int, device, size: int = 256) -> None:
    """(s4) model.remat with decoder.remat under three policies against the
    plain step, and (s5) bfloat16 compute against float32, on one flagship
    state, one batch of 2 scenes and the same noise tensors."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.training.step import generator_grads, make_step_flags

    cfg = load_config("re10k")
    state, losses, train_step = switch_state(cfg, seed, device)
    model = state.model
    mcfg = model.cfg
    batch = model.data_shim(make_batch(np.random.default_rng(seed + 2), 2, 4, size, device, 2))
    noise = flagship_noise(model, batch, seed + 5)
    flags = make_step_flags(losses, TRAIN_STEP)

    def grads_of(label: str):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = time.perf_counter()
        grads, total, _, _ = generator_grads(state, losses, flags, batch, TRAIN_STEP, noise=noise)
        torch.cuda.synchronize()
        seconds, peak, launches = time.perf_counter() - start, torch.cuda.max_memory_allocated(), read_launches()
        print(f"switches {label}: generator/total {float(total)!r}, forward + backward {seconds:.4f} s, "
              f"peak {peak / 2**30:.3f} GiB, launches {launches}")
        return grads, float(total), launches

    # The comparisons run with cuDNN's deterministic algorithms, so that the
    # plain step repeats itself as closely as the card allows.
    torch.backends.cudnn.deterministic = True
    plain, plain_total, _ = grads_of("(s4) plain")
    again, again_total, _ = grads_of("(s4) plain, again")
    floor_err, floor_leaf = leaf_errors(again, plain)
    print(f"switches (s4): plain vs plain, generator/total equal {again_total == plain_total}; largest leaf "
          f"difference {floor_err:.3e} of its largest value ({floor_leaf}): the card's nondeterministic "
          f"backward kernels (atomic adds)")
    del again
    mcfg.remat = True
    model.decoder.cfg.remat = True
    for policy in ("nothing", "dots", "vae:off,lpips:off"):
        mcfg.remat_policy = policy
        grads, total, launches = grads_of(f"(s4) remat {policy}")
        err, leaf = leaf_errors(grads, plain)
        print(f"switches (s4) remat {policy}: generator/total equal to plain {total == plain_total} "
              f"({abs(total - plain_total) / abs(plain_total):.3e} relative); largest leaf difference {err:.3e} "
              f"of its largest value ({leaf}); bit-identical {all(torch.equal(grads[n], plain[n]) for n in plain)}")
        if abs(total - plain_total) > 1e-6 * abs(plain_total) or err > max(1e-6, 4 * floor_err):
            raise AssertionError(f"(s4) remat {policy} differs from the plain step")
        if launches["composite_forward"] != 16 or launches["duplicate_with_keys"] != 16:
            raise AssertionError(f"(s4) remat {policy}: {launches['composite_forward']} forward launches, not 8 + 8")
        del grads
    mcfg.remat, mcfg.remat_policy = False, "nothing"
    model.decoder.cfg.remat = False
    torch.backends.cudnn.deterministic = False

    for dtype in ("bfloat16", "vae:bfloat16,lpips:bfloat16,disc:bfloat16"):
        mcfg.compute_dtype = dtype
        grads, total, _ = grads_of(f"(s5) compute_dtype={dtype}")
        rel = abs(total - plain_total) / abs(plain_total)
        err, leaf = leaf_errors(grads, plain)
        print(f"switches (s5) {dtype}: generator/total {total:.6g} vs float32 {plain_total:.6g}, {rel:.3e} relative "
              f"(tolerance 0.05); largest leaf difference {err:.3e} of its largest value ({leaf})")
        if not rel <= 0.05:
            raise AssertionError(f"(s5) {dtype}: generator/total {rel:.3e} relative from float32")
        del grads
    del plain
    for dtype in ("float32", "bfloat16", "vae:bfloat16,lpips:bfloat16,disc:bfloat16"):
        mcfg.compute_dtype = dtype
        state, _, seconds, peak, _ = timed_steps(f"switches (s5) compute_dtype={dtype} train", state, train_step,
                                                 batch, seed + 3, 3)
        print(f"switches (s5) {dtype}: median step after the first {statistics.median(seconds[1:]):.4f} s, "
              f"peak {peak / 2**30:.3f} GiB")
        wrong = {p.dtype for p in model.parameters()} | {p.dtype for p in state.discriminator.parameters()}
        if wrong != {torch.float32}:
            raise AssertionError(f"(s5) {dtype}: master parameters of {wrong}")
    mcfg.remat, model.decoder.cfg.remat = True, True
    for policy in ("nothing", "dots", "vae:off,lpips:off"):
        mcfg.remat_policy = policy
        mcfg.compute_dtype = "float32"
        state, _, seconds, peak, _ = timed_steps(f"switches (s4) remat {policy} train", state, train_step, batch,
                                                 seed + 3, 2)
        print(f"switches (s4) remat {policy}: step {seconds[-1]:.4f} s, peak {peak / 2**30:.3f} GiB")


def switch_backbones(seed: int, device, size: int = 256) -> None:
    """(s6) The vit (dino_vitb8) backbone and an ensemble of dino + resnet50:
    one serving batch and one train step each."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.model.latentsplat import render_full

    for label, override in (
        ("vit dino_vitb8", "model.encoder.backbone={name: vit, model: dino_vitb8}"),
        ("ensemble dino + resnet50", "model.encoder.backbone=[{name: dino, model: dino_vitb8}, "
                                     "{name: resnet, model: resnet50}]"),
    ):
        cfg = load_config("re10k", [override])
        state, _, train_step = switch_state(cfg, seed, device)
        model = state.model.eval()
        batch = make_batch(np.random.default_rng(seed), 2, 4, size, device)
        gen = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize()
        start = time.perf_counter()
        reset_launches()
        out = render_full(model, batch, generator=gen)
        torch.cuda.synchronize()
        serve_s, launches = time.perf_counter() - start, read_launches()
        if not torch.isfinite(out["image"]).all():
            raise AssertionError(f"(s6) {label}: non-finite image")
        n_params = sum(p.numel() for p in model.encoder.backbone.parameters())
        print(f"switches (s6) {label}: backbone {n_params} parameters, serving batch {serve_s:.4f} s (first call), "
              f"launches {launches}")
        model.train()
        batch = model.data_shim(make_batch(np.random.default_rng(seed + 2), 2, 4, size, device, 2))
        timed_steps(f"switches (s6) {label} train", state, train_step, batch, seed + 3, 1)
        del state, model, train_step, batch, out
        torch.cuda.empty_cache()


def switches_phase(seed: int, device) -> list[dict]:
    """(s1)-(s6); returns the 12-channel composite kernels' and the row-18
    reduce_pairs' records."""
    print(f"switches phase on {card()}")
    start = time.perf_counter()
    switch_sites(seed, device)
    torch.cuda.empty_cache()
    switch_encode_latents(seed, device)
    torch.cuda.empty_cache()
    records, launches = switch_latents(seed, device)
    for record in records:
        record["launches"] = (launches["composite_forward_by_channels"][12] if record["name"] == "composite_forward"
                              else launches[record["name"]])
    torch.cuda.empty_cache()
    switch_remat_bf16(seed, device)
    torch.cuda.empty_cache()
    switch_backbones(seed, device)
    print(f"switches phase: {time.perf_counter() - start:.1f} s")
    return records


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


def small_depth_backward_check(seed: int, device) -> None:
    """composite_backward at 4 channels (render_depth's payload) against its
    plain version on the narrow model's first view at 32x32, with a seeded
    random cotangent: 1e-4 of each gradient column's largest value, the
    same bits on a second launch; reduce_pairs over its rows (10 floats)
    exactly against its plain version on the CPU."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.ops.rasterize import kernels

    model = build_model(load_config("re10k", SMALL_OVERRIDES), seed, device)
    sg, shape = first_view(model, make_batch(np.random.default_rng(seed), 2, 2, 32, device), seed, depth_payload=True)
    view = depth_view(sg, shape)
    check_forward(view, "small input")
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    args = (view["gids"], view["ranges"], view["order"], view["attrs"], view["tiles_x"], shape, view["last"],
            view["t_final"], torch.randn((4, *shape), generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device))
    d_rows = kernels.composite_backward(*args)
    ref = kernels.composite_backward_reference(*args)
    torch.cuda.synchronize()
    err = ((d_rows - ref).abs() / ref.abs().amax(dim=0).clamp(min=1e-30)).max().item()
    offsets = torch.cumsum(view["counts"], dim=0, dtype=torch.int64)
    rows = kernels.reduce_pairs(d_rows, offsets)
    exact = torch.equal(rows.cpu(), kernels.reduce_pairs_reference(d_rows.cpu(), offsets.cpu()))
    print(f"small input, composite_backward at 4 channels: {d_rows.shape[0]} pair rows, max error relative to each "
          f"column's largest value {err:.3e} (tolerance {BACKWARD_RTOL}); reduce_pairs exact {exact}")
    if not (err <= BACKWARD_RTOL and torch.equal(d_rows, kernels.composite_backward(*args)) and exact):
        raise AssertionError("composite_backward or reduce_pairs at 4 channels disagrees with its plain version")


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
    depth_record, depth_launches = depth_phase(model, batch, args.seed)
    del model
    train_launches = train_phase(cfg, args.seed, device, args.profile)
    fit_launches, test_launches = trainer_phase(args.seed, device)
    data = data_phase(args.seed, device)
    inspection = inspection_phase(args.seed, device)
    # Each kernel's count comes from the path it serves: the forward kernels
    # from serving, the backward kernels from training, the 4-channel
    # composite_forward from the depth modes; beside them, the counts of the
    # trainer's fit (a)+(b) and of its test mode (c).
    for entry in results:
        path = serve_launches if entry["name"] in FORWARD_KERNELS else train_launches
        entry["launches"] = path[entry["name"]]
        entry["trainer_fit_launches"] = fit_launches[entry["name"]]
        entry["trainer_test_launches"] = test_launches[entry["name"]]
        entry["data_launches"] = {run: launches[entry["name"]] for run, launches in data["launches"].items()}
        entry["inspection_launches"] = {step: launches[entry["name"]]
                                        for step, launches in inspection["launches"].items()}
    depth_record["launches"] = depth_launches["composite_forward_by_channels"][4]
    depth_record["data_launches"] = {run: launches["composite_forward_by_channels"].get(4, 0)
                                     for run, launches in data["launches"].items()}
    for key, launches in (("trainer_fit_launches", fit_launches), ("trainer_test_launches", test_launches)):
        depth_record[key] = launches["composite_forward_by_channels"].get(4, 0)
    depth_record["inspection_launches"] = {step: launches["composite_forward_by_channels"].get(4, 0)
                                           for step, launches in inspection["launches"].items()}
    results.append(depth_record)
    results += switches_phase(args.seed, device)
    small_input_check(args.seed, device)
    small_depth_backward_check(args.seed, device)
    small_gradient_check(args.seed, device)

    print(f"data phase summary on {card()}: " + json.dumps({k: v for k, v in data.items() if k != "launches"}))
    print(f"inspection phase summary on {card()}: "
          + json.dumps({k: v for k, v in inspection.items() if k != "launches"}))
    print(card())
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
