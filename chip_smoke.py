"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N] [--profile DIR] [--parent DIR]

1. Builds the CUDA kernels from latentsplat_tpu_torch/csrc (sm_90a).
   With --parent DIR, first runs TURN_CODE (bench_render's views/s, ms a
   view and peak at fast and exact, the slice's decoder seconds,
   bench_train --full --batch 2's seconds a step and peak) in the checkout
   DIR and in this tree, in turns (parent, this tree, this tree, parent),
   each in its own process.
2. Kernel phase: on a pass of the flagship model's 4 target views (the
   items of one render call, each view's own pair count), holds each
   forward kernel against its plain PyTorch version (ids, keys, each
   view's pair total, tile ranges and each pixel's last contributor
   exactly; channels and transmittance within 1e-5), times both with CUDA
   events (a kernel's device time with the host queued ahead, per launch
   and per view; duplicate_with_keys' launch alone with L2 flushed, and
   its wrapper with the host's one read of the per-view pair totals) and
   counts on the card the (pair, pixel) and (pair, warp) work the pass
   needs, from which each kernel's bound follows.
3. Backward kernel phase: on the same pass, with a seeded random
   cotangent, holds composite_backward against its plain version (within
   1e-4 of each gradient column's largest value; bit-identical on a
   second launch) and reduce_pairs against its plain version run on the CPU
   (exactly), and times both; reduce_pairs with L2 flushed and warm, in
   three rounds beside index_add_ and segment_reduce.
4. Slice phase: serves one batch (1 scene, 2 context and 4 target views at
   256x256, probabilistic) through `render_full` on the flagship re10k
   model at full width with seeded random weights, checks the output and
   that both forward kernels ran on that path once, in one pass of the 4
   target views with one host read.
4b. Fast phase (model.decoder.precision=fast): on the kernel phase's pass, the pairs and
   rows composite_tiled prepares at "fast"; composite_forward's coef
   (serving) and fast (training, writing the block state) variants and
   composite_backward's fast variant (on the fast forward's outputs and
   block state, a seeded random cotangent) held against their plain
   versions (forward: `last` exactly, T 1e-5, each channel 1e-5 of its
   largest value, the block state exactly; backward: 1e-4 of each column's
   largest value or one bfloat16 step of the value, the same bits again),
   timed and their work counted, with the shape of the fast backward's
   split walk (pairs and scan blocks a tile, counted from each view's
   first pair, the thread blocks it runs); then `render_full` at
   precision fast on the slice batch: finite outputs, the coef variant
   launched once (one pass) and no exact composite, the render's PSNR
   against exact.
5. Depth phase: on the slice's Gaussians, composite_forward at 4 channels
   (render_depth's payload) against its plain version and timed on a pass
   of the 4 target views; the splatting decoder in each depth mode (depth,
   disparity, relative_disparity, log) over the 4 target views, with
   finite depths, one 4-channel launch in each special mode, each mode's
   time per view and the invariant depth x disparity >= mask^2.
5b. Pass phase: bench_render's 64 views in one pass against one item a
   pass (api.PASS_ROWS patched to 1), at exact and fast serving: the
   outputs and pair counts the same bits, one launch of each forward
   kernel and one host read (also counted by torch.cuda's sync debug
   mode) against 64; then a train render of 2 scenes x 4 views at exact
   and fast: the forward the same bits, every input's gradient within
   1e-4 of its largest value (fast: or one bfloat16 step).
6. Train phase: 3 VAE-GAN train steps of the flagship re10k model at full
   width (random weights for the generator, the PatchGAN discriminator and
   LPIPS) on one batch of 2 scenes, 2 context + 4 target views at 256x256,
   at step 125000, where every re10k loss is live. Checks finite losses and
   gradient norms, the adaptive weight in [0, 1], changed parameters of
   both nets and that all four kernels ran; prints seconds per step, a
   stage split and the peak memory. Then 2 steps at precision fast: finite
   logs, the fast forward and backward variants once a step (the step's
   2 x 4 target views are one pass) and no exact composite.
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
   their plain versions and timed on a pass of the 4 target views, the fast
   family's variants at 12 channels as in the fast phase, then 2 train
   steps, a render without gradient and 1 train step at precision fast (1
   coef, 1 fast forward and 1 fast backward launch: one pass each); (s4)
   model.remat with decoder.remat under the policies nothing, dots and
   vae:off,lpips:off against the plain step on the same batch and noise
   (generator/total within 1e-6 relative, each gradient leaf within 1e-6
   of its largest value or 4x the plain step's own repeat difference; 1 + 1
   forward launches a step: the pass and its recomputation), and the peak
   memory of each setting and of no
   remat in one process, on one state, batch and noise, at the forward's
   end, after each probe backward and in the final backward: `nothing`
   must have the smallest peak and `dots` one at or below no remat's;
   (s5) compute_dtype bfloat16 and vae/lpips/disc:bfloat16
   (generator/total within 5% of float32, float32 master parameters); (s6) the vit (dino_vitb8) backbone and an ensemble
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
11. Parallel phase (run after the switches phase): (p1) the data-parallel
   train step, two ranks on the one card over gloo (`parallel.spawn`), 1
   scene each, against the one-process step on both scenes (2 context + 4
   target views at 256x256, step 125000, the same weights, noise and Adam
   moments of one earlier step): generator/total within max(1e-6, 4x the
   one-process repeats') relative, each adaptive weight within that of
   the one-process weight whose nll probe is taken scene by scene, the
   generator's averaged gradients within max(1e-6, 4x the repeats') and
   both nets' updated parameters within max(1e-5, 4x the repeats') of
   each leaf's largest value (the repeats: the one-process step on images
   1, 2, ..., 8 rounding steps up), both ranks' states bit-identical, each
   kernel on each rank; seconds per step, peaks, the state's broadcast; (p2)
   `make_view_parallel_render` over [cuda, cuda] on the 30-view video
   trajectory, bit-equal to the plain render; (p3) a `misc.profiler` trace
   of one `render_full` and one render backward, holding both annotated
   spans and the four kernels; (p4) the six `paper/` generators over the
   trainer phase's test output (c), each figure at its layout's size.
12. Small-input checks: the tiled (kernel) render of a narrow model against
   the dense oracle render, composite_backward and reduce_pairs at 4
   channels against their plain versions, and the narrow model's
   train-step gradients through the tiled kernels against those through
   the dense oracle.
13. Bench phase: the port's bench scripts (latentsplat_tpu_torch.scripts)
   at their full shapes with PyTorch's TF32 defaults, as a user runs
   them: bench_train at 128x128 batch 1, --full --batch 2, --full
   --batch 2 --bf16 and --fast (finite positive steps/s and FLOPs, each
   kernel's launches exactly what the steps and model.decoder.remat imply,
   in the precision's variant, the --full --batch 2 peak below 80 GB);
   bench_render, 64 views of 393,216 Gaussians at 256x256 at precision fast
   (the headline) and exact (duplicate_with_keys and composite_forward<8>
   launched exactly 6 times at each, coef and exact, one pass of the 64
   views a call, with one host read a call; no pair dropped,
   value_fast, value_exact and fast_vs_exact_psnr_db finite);
   bench_precision_knobs --views 8 (every mode finite); bench_render_stages,
   bench_enc_stages and bench_train_stages (finite positive times);
   bench_trace_step's top kernels (device self time within the wall time);
   entry.dryrun_multichip(2) with both ranks on the card. Prints every
   JSON line.
14. Convergence phase (last): scripts.convergence, the flagship at full
   width overfitting one synthetic scene (2 context + 4 target views at
   128x128, seed 0) with the whole VAE-GAN objective and sh_l2 at 0.01 for
   150 steps, cuDNN's TF32 on as in `main`: every logged loss finite, the
   render PSNR of steps 140-149 at least 8 dB above steps 0-9, each kernel
   launched once a step (4 target views, one pass); prints the PSNR curve
   at every 10th step.

Prints the card's name and power limit, one JSON line describing the
kernels (device ms, plain ms, the bound and its share, the library call's
ms, launches on the main path, in the trainer phase, in each run of the
data phase, in each step of the inspection phase, in each rank's step of
the parallel phase, in each run of the bench phase and over the
convergence phase; duplicate_with_keys
also its wrapper's ms; composite_forward once at the flagship's 8 channels,
once at render_depth's 4 and once at variational=latents' 12, and
composite_backward and reduce_pairs also at 12 channels; the fast family's
rows, marked "variant", at 8 and 12 channels: composite_forward's coef and
fast, composite_backward's fast, with the launches of serving and training
at precision fast), and last
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
import shutil
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
FLUSH_BYTES = 128 << 20


def backward_composited_ops(n_ch: int) -> int:
    """Rounded float32 operations of composite_backward per composited
    (pair, pixel) on top of its evaluation's (bench_render.EVAL_OPS, as
    composite_forward's): the value path, 6 + n_ch partials and its share
    of their sum over the tile's pixels."""
    return 3 * n_ch + 29 + (6 + n_ch)
TRAIN_STEP = 125000
FORWARD_KERNELS = ("duplicate_with_keys", "composite_forward")
ALL_KERNELS = (*FORWARD_KERNELS, "composite_backward", "reduce_pairs")
# The flagship's Gaussians at 256x256: 2 context views x 256^2 pixels x 3.
FLAGSHIP_GAUSSIANS = 2 * 256 * 256 * 3


def passes(items: int, gaussians: int = FLAGSHIP_GAUSSIANS) -> int:
    """The passes of a render call of `items` (scene, view) items
    (api.pass_ranges): one launch of each kernel and one host read a pass."""
    from latentsplat_tpu_torch.ops.rasterize.api import pass_ranges

    return len(pass_ranges(items, gaussians))
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


def counted_work(view: dict) -> dict:
    """bench_render.composite_work of `view`, printed."""
    from latentsplat_tpu_torch.scripts.bench_render import composite_work

    work = composite_work(view)
    print("composite work (counted on the card): " + ", ".join(f"{k} {v}" for k, v in work.items()))
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


def target_views(model, batch, seed: int, depth_payload: bool = False, flatten: bool = False):
    """The screen Gaussians of the slice's target views as one pass (the
    items' axis first), as `render` gives them to the compositor: the SH
    colors and features towards each camera, or (`depth_payload`) each
    Gaussian's camera-space z as the 3-channel DC color of `render_depth`;
    then (sg, (h, w))."""
    from latentsplat_tpu_torch.geometry.projection import homogenize_points, invert_se3
    from latentsplat_tpu_torch.ops.rasterize.api import view_channels
    from latentsplat_tpu_torch.ops.rasterize.camera import project_gaussians_to_screen

    shimmed, gaussians = slice_gaussians(model, batch, seed, flatten)
    target = shimmed["target"]
    ext, intr, near = target["extrinsics"][0], target["intrinsics"][0], target["near"][0]
    h, w = target["image"].shape[2:4]
    n = ext.shape[0]
    means = gaussians.means[0].expand(n, -1, -1)
    with torch.no_grad():
        if depth_payload:
            z = torch.einsum("vij,vgj->vgi", invert_se3(ext), homogenize_points(means))[..., 2]
            channels = z[..., None].expand(*z.shape, 3)
        else:
            channels = view_channels(means, gaussians.color_harmonics[0], gaussians.feature_harmonics[0], ext[:, :3, 3])
        s = 1.0 / near
        ext_s = ext.clone()
        ext_s[:, :3, 3] *= s[:, None]
        sg = project_gaussians_to_screen(
            means * s[:, None, None], gaussians.covariances[0] * (s * s)[:, None, None, None],
            gaussians.opacities[0].expand(n, -1), channels, ext_s, intr, (h, w),
        )
    return sg, (h, w)


def kernel_phase(model, batch, seed: int) -> tuple[dict, list[dict]]:
    """The forward kernels on a pass of the slice's target views (each
    view's own pair count): duplicate_with_keys (ids and keys exactly, the
    per-item pair totals against the counts), the sort's ranges, and
    composite_forward (`last` exactly, T and each channel within
    KERNEL_ATOL) against their plain versions, timed, with the work the
    pass needs counted on the card."""
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.ops.rasterize.tiled import pack_attributes, sort_pairs, tile_rects

    sg, (h, w) = target_views(model, batch, seed)
    n_items = sg.radius.shape[0]
    channels = sg.channels
    tiles_x, tiles_y = w // 16, h // 16
    n_tiles = n_items * tiles_x * tiles_y
    counts, base, nx, mask = tile_rects(sg, tiles_x, tiles_y)
    depth = sg.depth.reshape(-1).contiguous()
    g_count, p_count = counts.shape[0], int(counts.sum())
    counted = counts.reshape(n_items, -1).sum(dim=1).tolist()
    print(f"kernel phase: a pass of {n_items} views, {g_count} (item, Gaussian) rows, {p_count} pairs "
          f"(per view {counted}), {channels.shape[-1] + 1} channels, {n_tiles} tiles")
    if len(set(counted)) < n_items:
        raise AssertionError(f"kernel phase: the pass's views should differ in pair count, got {counted}")

    # duplicate_with_keys
    gids, keys, pairs = kernels.duplicate_with_keys(counts, mask, base, nx, depth, tiles_x, 9, n_items)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, depth, tiles_x, 9)
    torch.cuda.synchronize()
    if not (torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)) or pairs.tolist() != counted:
        raise AssertionError("duplicate_with_keys disagrees with its plain version or the counts")
    dup_err = max((gids - ref_gids).abs().max().item(), (keys - ref_keys).abs().max().item())
    sorted_gids, ranges, order = sort_pairs(gids, keys, n_tiles)
    ref_sorted, ref_ranges, _ = sort_pairs(ref_gids, ref_keys, n_tiles)
    if not (torch.equal(sorted_gids, ref_sorted) and torch.equal(ranges, ref_ranges)):
        raise AssertionError("sorted pairs or tile ranges differ")
    # The kernel's launch alone, as the wrapper makes it once the pair total
    # is known, with L2 flushed; then the whole wrapper, whose read of the
    # per-item totals waits on the device.
    flush = torch.empty(FLUSH_BYTES // 4, device=depth.device)
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    dup_args = (offsets, mask, base, nx, depth, tiles_x, torch.empty_like(gids), torch.empty_like(keys))
    dup_ms = device_ms(lambda: kernels._launch_duplicate_with_keys(*dup_args), flush=flush)
    dup_wrapper_ms = cuda_ms(lambda: kernels.duplicate_with_keys(counts, mask, base, nx, depth, tiles_x, 9, n_items),
                             20)
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
          f"bytes {device_ms(lambda: copy_dst.copy_(copy_src), flush=flush):.4f} ms (L2 flushed); per view "
          f"{dup_ms / n_items:.4f} ms, wrapper {dup_wrapper_ms / n_items:.4f} ms")

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
    err = max(err_ch, err_t)
    comp_ms = device_ms(lambda: kernels.composite_forward(*comp_args))
    comp_plain_ms = cuda_ms(lambda: kernels.composite_forward_reference(*comp_args), 3)
    print(f"composite_forward: {comp_ms:.4f} ms (device) vs plain {comp_plain_ms:.4f} ms; per view "
          f"{comp_ms / n_items:.4f} ms")
    view = {"gids": sorted_gids, "ranges": ranges, "order": order, "counts": counts, "attrs": attrs,
            "tiles_x": tiles_x, "shape": (h, w), "t_final": out[1], "last": out[2], "items": n_items}
    view["work"] = work = counted_work(view)
    print(f"composite_forward: {comp_ms * 1e6 / work['forward_tile_walk_max']:.1f} ns per pair of the "
          f"longest tile walk")
    return view, [
        # Mask, base, nx and depth of each Gaussian, one exclusive offset per
        # block of 512 Gaussians, and 12 bytes per pair written.
        entry("duplicate_with_keys", "duplicate_with_keys.cu", "latentsplat_tpu/ops/rasterize/expand.py:159",
              float(dup_err), dup_ms, dup_plain_ms,
              n_bytes=16 * g_count + 8 * math.ceil(g_count / 512) + 12 * p_count, n_ops=0,
              wrapper_ms=dup_wrapper_ms, views=n_items),
        forward_entry(err, comp_ms, comp_plain_ms, view),
    ]


def forward_entry(err: float, ms: float, plain_ms: float, view: dict, variant: str = "exact",
                  extra_bytes: int = 0) -> dict:
    """composite_forward's record: the pairs' ids, the tile ranges and every
    Gaussian's attribute row read once, the channels, T and `last` written
    (and `extra_bytes`: a fast variant's block state); operations as counted
    by `composite_work`."""
    from latentsplat_tpu_torch.scripts.bench_render import EVAL_OPS, forward_composited_ops

    attrs, ranges, work = view["attrs"], view["ranges"], view["work"]
    p_count, (g_count, row) = view["gids"].shape[0], attrs.shape
    n_ch, plane = row - 6, view["items"] * view["shape"][0] * view["shape"][1]
    record = entry("composite_forward", "composite_forward.cu", "latentsplat_tpu/ops/rasterize/pallas_kernels.py:399",
                   err, ms, plain_ms,
                   n_bytes=4 * p_count + 4 * ranges.numel() + 4 * row * g_count + 4 * (n_ch + 2) * plane + extra_bytes,
                   n_ops=EVAL_OPS * work["forward_evaluations"] + forward_composited_ops(n_ch) * work["composited"],
                   channels=n_ch, views=view["items"])
    return {**record, "variant": variant} if variant != "exact" else record


def backward_entry(err: float, ms: float, plain_ms: float, view: dict, variant: str = "exact",
                   extra_bytes: int = 0) -> dict:
    """composite_backward's record: ids, ranges, order, the attribute rows,
    `last`, T and the cotangents read once, the pair rows written (and
    `extra_bytes`: a fast variant's block state read); operations as
    counted by `composite_work`."""
    from latentsplat_tpu_torch.scripts.bench_render import EVAL_OPS

    attrs, ranges, work = view["attrs"], view["ranges"], view["work"]
    p_count, n_ch = view["gids"].shape[0], attrs.shape[1] - 6
    plane = view["items"] * view["shape"][0] * view["shape"][1]
    record = entry("composite_backward", "composite_backward.cu", "latentsplat_tpu/ops/rasterize/pallas_kernels.py:667",
                   err, ms, plain_ms,
                   n_bytes=4 * p_count + 4 * ranges.numel() + 8 * p_count + 4 * (n_ch + 6) * attrs.shape[0]
                   + 4 * (n_ch + 3) * plane + 4 * (n_ch + 6) * p_count + extra_bytes,
                   n_ops=EVAL_OPS * work["backward_evaluations"] + backward_composited_ops(n_ch) * work["composited"],
                   views=view["items"])
    return {**record, "variant": variant} if variant != "exact" else record


DEPTH_MODES = ("depth", "disparity", "relative_disparity", "log")


def depth_view(sg, shape: tuple[int, int]) -> dict:
    """Pairs and attribute rows of the screen Gaussians `sg`, duplicated and
    sorted by the kernels (ids, keys and tile ranges held exactly against
    the plain versions), with composite_forward's outputs."""
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.ops.rasterize.tiled import pack_attributes, sort_pairs, tile_rects

    h, w = shape
    tiles_x, tiles_y = w // 16, h // 16
    n_items = sg.radius.shape[0]
    counts, base, nx, mask = tile_rects(sg, tiles_x, tiles_y)
    depth = sg.depth.reshape(-1).contiguous()
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, depth, tiles_x, 9, n_items)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, depth, tiles_x, 9)
    sorted_gids, ranges, order = sort_pairs(gids, keys, n_items * tiles_x * tiles_y)
    ref_sorted, ref_ranges, _ = sort_pairs(ref_gids, ref_keys, n_items * tiles_x * tiles_y)
    if not (torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys) and torch.equal(sorted_gids, ref_sorted)
            and torch.equal(ranges, ref_ranges)):
        raise AssertionError("duplicate_with_keys or the sort disagrees with its plain version")
    attrs = pack_attributes(sg)
    _, t_final, last = kernels.composite_forward(sorted_gids, ranges, attrs, tiles_x, shape)
    return {"gids": sorted_gids, "ranges": ranges, "order": order, "counts": counts, "attrs": attrs,
            "tiles_x": tiles_x, "shape": shape, "t_final": t_final, "last": last, "items": n_items}


def held_forward(out: tuple, ref: tuple, label: str) -> float:
    """composite_forward's outputs against its plain version's: `last`
    exactly, T within KERNEL_ATOL and each item's each channel within
    KERNEL_ATOL of its largest value; raises, else returns the largest
    error."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    scale = ref[0].abs().amax(dim=(2, 3)).clamp(min=1e-30)            # each item's each channel
    err_ch = ((out[0] - ref[0]).abs().amax(dim=(2, 3)) / scale).max().item()
    err_t = (out[1] - ref[1]).abs().max().item()
    last_mismatch = int((out[2] != ref[2]).sum())
    saturated = (ref[1] < kernels.TRANSMITTANCE_MIN).float().mean().item()
    print(f"{label}: max channel error relative to its largest value {err_ch:.3e}, max |T err| {err_t:.3e}, "
          f"last-contributor mismatches {last_mismatch}, saturated pixels {saturated:.3f}")
    if not (err_ch <= KERNEL_ATOL and err_t <= KERNEL_ATOL) or last_mismatch:
        raise AssertionError(f"{label} disagrees with its plain version")
    return max(err_ch, err_t)


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
    return held_forward(out, ref, f"{label}: composite_forward at {view['attrs'].shape[1] - 6} channels")


def depth_phase(model, batch, seed: int) -> tuple[dict, dict]:
    """render_depth on the slice's Gaussians: composite_forward at 4
    channels (render_depth's 3-channel payload + the expected depth) held
    against its plain version and timed on a pass of the 4 target views;
    then `DecoderSplatting` in each depth mode over the 4 target views (the
    counted run: render_depth is one pass, one 4-channel launch, in each of
    the 3 special modes), finite depths, each mode's render_depth time per
    view, and the invariant
    depth x disparity >= mask^2 (Cauchy-Schwarz over the same composite
    weights). Returns the 4-channel composite_forward's record and the
    launches of the counted run ({kernel: n} and composite_forward's by
    channel count)."""
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.ops.rasterize.api import render_depth

    sg, shape = target_views(model, batch, seed, depth_payload=True)
    view = depth_view(sg, shape)
    err = check_forward(view, "depth phase, a pass of the target views")
    args = (view["gids"], view["ranges"], view["attrs"], view["tiles_x"], shape)
    ms = device_ms(lambda: kernels.composite_forward(*args))
    plain_ms = cuda_ms(lambda: kernels.composite_forward_reference(*args), 3)
    view["work"] = counted_work(view)
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
    kernels.launches_by_channels["composite_forward"].clear()
    outs, seconds = {}, {}
    with torch.no_grad():
        for mode in DEPTH_MODES:
            torch.cuda.synchronize()
            start = time.perf_counter()
            outs[mode] = model.decoder(gaussians, *cams, size, depth_mode=mode)
            torch.cuda.synchronize()
            seconds[mode] = time.perf_counter() - start
    launches = dict(kernels.launch_counts)
    launches["composite_forward_by_channels"] = dict(kernels.launches_by_channels["composite_forward"])
    print(f"depth phase launches (4 modes x {n_views} views): {launches}")
    if launches["composite_forward_by_channels"].get(4) != (len(DEPTH_MODES) - 1) * passes(n_views):
        raise AssertionError("render_depth did not composite its views in one pass at 4 channels in each special mode")
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
    """composite_backward and reduce_pairs on the kernel phase's pass of
    flagship views, against their plain versions, with a seeded random
    cotangent."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    gids, ranges, order, attrs, tiles_x, shape = (
        view[k] for k in ("gids", "ranges", "order", "attrs", "tiles_x", "shape"))
    device = attrs.device
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    g_out = torch.randn((view["items"], attrs.shape[1] - 6, *shape), generator=gen, device=device)
    g_t = torch.randn((view["items"], *shape), generator=gen, device=device)
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

    p_count = gids.shape[0]
    return [
        backward_entry((d_rows - ref).abs().max().item(), bwd_ms, bwd_plain_ms, view),
        entry("reduce_pairs", "reduce_pairs.cu", "latentsplat_tpu/ops/rasterize/expand.py:254", red_err,
              red_ms, red_plain_ms, n_bytes=4 * row * p_count + 8 * g_count + 4 * row * g_count, n_ops=0,
              library_ms=library_ms, views=view["items"]),
    ]


# A fast-family gradient row is rounded to bfloat16 when it is written; a
# row whose float32 sum the kernel takes in another order than the plain
# version may round the other way: one bfloat16 step, at most 2^-7 of the value.
BF16_STEP = 2.0**-7


def timed_once(fn):
    """(fn(), its milliseconds by CUDA events, the host's time included): a
    plain version, slow enough at flagship shapes that one call is timed."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def split_report(view: dict, blocks, label: str) -> None:
    """The shape of the fast backward's split walk at this view: pairs a
    tile (mean, p99, max), scan blocks a tile, and the blocks each launch
    of composite_backward's split walk runs (one per block-state row) and
    how many of them walk pairs (scan blocks below their tile's largest
    `last`), beside the forward's 4 quarter blocks a tile; printed."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    ranges, tiles_x, shape = view["ranges"], view["tiles_x"], view["shape"]
    starts, stops = ranges[:-1].long(), ranges[1:].long()
    pairs = (stops - starts).float()
    item_first = kernels.item_starts(ranges, tiles_x * (shape[0] // kernels.TILE))
    first = (starts - item_first) // kernels.SCAN_BLOCK
    n_blocks = torch.where(stops > starts, (stops - 1 - item_first) // kernels.SCAN_BLOCK - first + 1, 0)
    end = kernels.tile(view["last"], tiles_x, shape[0] // kernels.TILE).long().amax(dim=1)
    walked = torch.where(end > starts, (end - 1 - item_first) // kernels.SCAN_BLOCK - first + 1, 0)
    report = {
        "pairs_per_tile_mean": pairs.mean().item(), "pairs_per_tile_p99": torch.quantile(pairs, 0.99).item(),
        "pairs_per_tile_max": int(pairs.max()), "blocks_per_tile_mean": n_blocks.float().mean().item(),
        "blocks_per_tile_max": int(n_blocks.max()), "scan_blocks": int(n_blocks.sum()),
        "backward_blocks_per_launch": blocks[1].shape[0], "backward_working_blocks": int(walked.sum()),
        "serial_backward_blocks": ranges.numel() - 1, "forward_blocks": 4 * (ranges.numel() - 1),
    }
    print(f"{label}: split walk: " + json.dumps(report))


def kernel_times(fn, n: int = 10) -> dict:
    """Device milliseconds a call of each CUDA kernel that `fn` launches:
    the kernels' self times in a torch.profiler trace of n calls
    (bench_trace_step.self_times), by name."""
    from latentsplat_tpu_torch.misc.profiler import trace
    from latentsplat_tpu_torch.scripts.bench_trace_step import self_times

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(Path(tmp)):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        times = self_times(json.loads((Path(tmp) / "trace.json").read_text()), ("kernel",))
    return {name: us / 1e3 / n for name, (us, _) in times.items()}


def fast_kernel_checks(sg, shape: tuple[int, int], seed: int, label: str) -> list[dict]:
    """The fast family's kernel variants on a pass of screen Gaussians `sg`
    (the items' axis first), with
    the pairs and rows `composite_tiled` prepares at "fast" (the wider cull,
    the truncated depth order, bf16 conic and opacity, 12-bit channels, the
    code's depth): composite_forward's coef (serving) and fast (training,
    writing the block state) variants, and composite_backward's fast
    variant on the fast forward's outputs and block state with a seeded
    random cotangent, each against its plain version on the same inputs
    (forward: the exact rows' bounds, and the block state exactly;
    backward: BACKWARD_RTOL of each column's largest value, or one bfloat16
    step of the value, and the same bits again) and timed (the plain
    version once, by CUDA events: seconds at these shapes); the work each
    needs counted on the card; the backward's split walk described
    (`split_report`) and its two launches timed apart (`kernel_times`).
    Returns their records (launches come later)."""
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.ops.rasterize.tiled import (
        depth_code_bits, pack_attributes, precision_knobs, quantize_attributes, tile_pairs)

    h, w = shape
    tiles_x = w // 16
    n_items = sg.radius.shape[0]
    gids, ranges, order, counts, pairs = tile_pairs(sg, shape, 9, "fast")
    attrs = quantize_attributes(pack_attributes(sg), precision_knobs("fast"), depth_code_bits(tiles_x * (h // 16))[1],
                                n_items)
    base = (gids, ranges, attrs, tiles_x, shape)
    n_ch = attrs.shape[1] - 6
    print(f"{label}: fast pairs {gids.shape[0]} (per view {pairs.tolist()}), {n_ch} channels")
    records = []

    out = kernels.composite_forward(*base, coef=True)
    ref, plain_ms = timed_once(lambda: kernels.composite_forward_reference(*base, coef=True))
    err = held_forward(out, ref, f"{label}: composite_forward (coef)")
    ms = device_ms(lambda: kernels.composite_forward(*base, coef=True))
    view = {"gids": gids, "ranges": ranges, "order": order, "counts": counts, "attrs": attrs, "tiles_x": tiles_x,
            "shape": shape, "t_final": out[1], "last": out[2], "items": n_items}
    view["work"] = counted_work(view)
    print(f"{label}: composite_forward (coef) {ms:.4f} ms (device) vs plain {plain_ms:.4f} ms")
    records.append(forward_entry(err, ms, plain_ms, view, "coef"))

    blocks = kernels.block_state(ranges, gids.shape[0], tiles_x * (h // 16))
    blocks[1].zero_()
    ref_blocks = (blocks[0], torch.zeros_like(blocks[1]))
    fast = dict(f16_xy=True, bf16_mm=True)
    out = kernels.composite_forward(*base, **fast, blocks=blocks)
    ref, plain_ms = timed_once(lambda: kernels.composite_forward_reference(*base, **fast, blocks=ref_blocks))
    err = held_forward(out, ref, f"{label}: composite_forward (fast)")
    written = int((blocks[1][..., 1] != 0).sum())
    if not torch.equal(blocks[1], ref_blocks[1]) or written == 0:
        raise AssertionError(f"{label}: composite_forward (fast) wrote another block state than its plain version")
    ms = device_ms(lambda: kernels.composite_forward(*base, **fast, blocks=blocks))
    view = {**view, "t_final": out[1], "last": out[2]}
    view["work"] = counted_work(view)
    print(f"{label}: composite_forward (fast) {ms:.4f} ms (device) vs plain {plain_ms:.4f} ms; block state equal, "
          f"{written} (block, pixel) entries written of {blocks[1].shape[0] * blocks[1].shape[1]}")
    records.append(forward_entry(err, ms, plain_ms, view, "fast", extra_bytes=8 * written))
    split_report(view, blocks, label)

    gen = torch.Generator(device=attrs.device).manual_seed(seed + 1)
    g_out = torch.randn((n_items, n_ch, *shape), generator=gen, device=attrs.device)
    g_t = torch.randn((n_items, *shape), generator=gen, device=attrs.device)
    args = (gids, ranges, order, attrs, tiles_x, shape, out[2], out[1], g_out, g_t)
    knobs = dict(f16_xy=True, bf16_mm=True, bf16_grads=True, blocks=blocks)
    d_rows = kernels.composite_backward(*args, **knobs)
    ref, plain_ms = timed_once(lambda: kernels.composite_backward_reference(*args, **knobs))
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    excess = (d_rows - ref).abs() - BACKWARD_RTOL * scale - BF16_STEP * ref.abs()
    rel = ((d_rows - ref).abs() / scale).max().item()
    print(f"{label}: composite_backward (fast): {gids.shape[0]} pair rows, max error relative to each column's "
          f"largest value {rel:.3e}; {int((d_rows != ref).sum())} elements differ, {int((excess > 0).sum())} beyond "
          f"{BACKWARD_RTOL} of the column or one bfloat16 step")
    if (excess > 0).any() or not torch.equal(d_rows, kernels.composite_backward(*args, **knobs)):
        raise AssertionError(f"{label}: composite_backward (fast) disagrees with its plain version")
    ms = device_ms(lambda: kernels.composite_backward(*args, **knobs))
    print(f"{label}: composite_backward (fast) {ms:.4f} ms (device) vs plain {plain_ms:.4f} ms")
    records.append(backward_entry((d_rows - ref).abs().max().item(), ms, plain_ms, view, "fast",
                                  extra_bytes=8 * written))
    # The split walk's two launches apart.
    times = kernel_times(lambda: kernels.composite_backward(*args, **knobs))
    passes = {key: [v for name, v in times.items() if kernel in name]
              for key, kernel in (("suffix_pass_ms", "suffix_kernel"), ("walk_ms", "composite_backward_kernel"))}
    passes = {key: sum(v) if v else None for key, v in passes.items()}
    print(f"{label}: composite_backward (fast) by launch (torch.profiler, device ms a call): {passes}; "
          f"the trace's kernels: {sorted(name[:60] for name in times)}")
    records[-1].update(passes)
    for record in records:
        record["channels"] = n_ch
    return records


def fast_serve_phase(model, batch, seed: int) -> tuple[list[dict], dict]:
    """The fast precision on the flagship: the kernel variants on a pass of
    the target views (`fast_kernel_checks`, 8 channels), then `render_full`
    at model.decoder.precision=fast on the slice batch (the counted run):
    the coefficient-layout forward once a pass and no exact composite,
    finite outputs of the slice's shapes, and the render's PSNR against the
    exact one on the same noise. Returns the records and the launches."""
    from latentsplat_tpu_torch.model.latentsplat import render_full

    sg, shape = target_views(model, batch, seed)
    records = fast_kernel_checks(sg, shape, seed, "fast phase, the target views")
    del sg
    gen = torch.Generator(device=batch["target"]["image"].device)
    exact = render_full(model, batch, generator=gen.manual_seed(seed))
    model.decoder.cfg.precision = "fast"
    try:
        render_full(model, batch, generator=gen.manual_seed(seed))     # warm-up
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        out = render_full(model, batch, generator=gen.manual_seed(seed))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_launches()
    finally:
        model.decoder.cfg.precision = "exact"
    n_target = batch["target"]["image"].shape[1]
    for key in ("image", "render", "depth"):
        if out[key].shape != exact[key].shape or not torch.isfinite(out[key]).all():
            raise AssertionError(f"fast phase: {key} of shape {tuple(out[key].shape)} or non-finite")
    expected = {"composite_forward": {"coef": {8: passes(n_target)}}, "composite_backward": {}}
    if launches["by_variant"] != expected or launches["duplicate_with_keys"] != passes(n_target):
        raise AssertionError(f"fast phase: render_full launched {launches}, not {expected}")
    mse = {k: (out[k].clamp(0, 1) - exact[k].clamp(0, 1)).square().mean().item() for k in ("render", "image")}
    print(f"fast phase: render_full at precision fast {seconds:.4f} s (host clock, synchronized); render PSNR "
          f"against exact {-10 * math.log10(max(mse['render'], 1e-12)):.3f} dB, decoded image "
          f"{-10 * math.log10(max(mse['image'], 1e-12)):.3f} dB; pairs per view {out['num_pairs'].reshape(-1).tolist()} "
          f"(exact {exact['num_pairs'].reshape(-1).tolist()}); launches {launches['by_variant']}")
    return records, launches


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
    reads = dict(kernels.host_reads)
    out = render_full(model, batch, generator=gen.manual_seed(seed), timer=timer)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    reads = {k: kernels.host_reads[k] - v for k, v in reads.items()}
    image = out["image"]
    n_target = batch["target"]["image"].shape[1]
    expected = (1, n_target, *batch["target"]["image"].shape[2:4], 3)
    if tuple(image.shape) != expected:
        raise AssertionError(f"image shape {tuple(image.shape)} != {expected}")
    for key in ("image", "render", "depth"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"non-finite values in {key}")
    n_passes = passes(n_target)
    if any(launches[k] != n_passes for k in FORWARD_KERNELS) or reads["duplicate_with_keys"] != n_passes:
        raise AssertionError(f"the serving path launched {launches} with host reads {reads}, not one each a pass "
                             f"({n_passes})")
    pairs = out["num_pairs"].reshape(-1).tolist()
    print(f"slice: image {tuple(image.shape)}, mean {image.mean().item():.4f}, "
          f"render mean {out['render'].mean().item():.4f}, pairs per view {pairs}")
    print("slice stage seconds (host clock around synchronized stages): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stage_s.items())
          + f"; per target view: render {stage_s['decoder'] / n_target:.4f}, "
          f"VAE decode {stage_s['autoencoder_decoder'] / n_target:.4f}")
    print(f"slice launches: {launches}; host reads {reads} ({n_passes} pass of {n_target} views)")
    if profile_dir:
        from latentsplat_tpu_torch.model.latentsplat import render_full

        profile_once(
            "render_full", lambda timer: render_full(model, batch, generator=gen.manual_seed(seed), timer=timer),
            profile_dir,
        )
    return launches


_TRACE_KEEP_BYTES = 16 << 20


def profile_once(label: str, fn, out_dir: str) -> None:
    """Runs fn(timer=annotate) once more under `misc.profiler.trace` and
    writes an operator table, the per-stage breakdown and (if small) a
    gzipped Chrome trace to `out_dir`; prints the breakdown."""
    import gzip

    from latentsplat_tpu_torch.misc.profiler import annotate, trace
    from latentsplat_tpu_torch.scripts.bench_trace_step import trace_breakdown

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with trace(out / label) as prof:
        start = time.perf_counter()
        fn(annotate)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    (out / f"{label}_ops.txt").write_text(prof.key_averages().table(sort_by="cuda_time_total", row_limit=50))
    raw = out / label / "trace.json"
    lines = trace_breakdown(json.loads(raw.read_text()))
    (out / f"{label}_stages.txt").write_text("\n".join(lines) + "\n")
    packed = gzip.compress(raw.read_bytes())
    shutil.rmtree(out / label)
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


def train_phase(cfg, seed: int, device, profile_dir: str | None = None, size: int = 256) -> tuple[dict, dict]:
    """3 flagship train steps on one batch, then 2 at precision fast;
    returns the kernels' launch counts over each run."""
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
    # Then two steps at precision fast (the counted run of the fast
    # family's training variants): the step renders its 2 x 4 target views
    # in one pass, one forward and one backward launch a step.
    state.model.decoder.cfg.precision = "fast"
    try:
        state, _, _, _, fast_launches = timed_steps("train phase at precision fast", state, train_step, batch,
                                                    seed + 4, 2)
    finally:
        state.model.decoder.cfg.precision = "exact"
    n = 2 * passes(scenes * 4)
    expected = {"composite_forward": {"fast": {8: n}}, "composite_backward": {"fast": {8: n}}}
    if fast_launches["by_variant"] != expected or fast_launches["reduce_pairs"] != n:
        raise AssertionError(f"train phase at precision fast: launches {fast_launches}, not {expected}")
    if profile_dir:
        profile_once(
            "train_step", lambda timer: train_step(state, batch, TRAIN_STEP, generator=gen, timer=timer),
            profile_dir,
        )
    return launches, fast_launches


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


def trainer_phase(seed: int, device, keep: Path | None = None) -> tuple[dict, dict]:
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
    temporary directory that is deleted; with `keep`, (c)'s test output and
    its mean scores are copied to keep/test and keep/scores.mean.json.
    Returns the kernels' launch counts over (a)+(b) and over (c),
    composite_forward's also by channel count."""
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
        kernels.launches_by_channels["composite_forward"].clear()
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
        fit_launches["composite_forward_by_channels"] = dict(kernels.launches_by_channels["composite_forward"])
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
        kernels.launches_by_channels["composite_forward"].clear()
        evaluation = {"name": "evaluation", "index_path": str(index)}
        call("c", "mode=test", f"checkpointing.load={ckpt_a}", "wandb.name=evaluation",
             f"dataset.view_sampler={json.dumps(evaluation)}")
        test_launches = dict(kernels.launch_counts)
        test_launches["composite_forward_by_channels"] = dict(kernels.launches_by_channels["composite_forward"])
        means_c = check_test_output(tmp / "c" / "test" / "evaluation", 4 * 3)
        evaluation_phase(seed, device, dict(data, view_sampler=evaluation), tmp / "c" / "test" / "evaluation", tmp)
        if keep is not None:
            shutil.copytree(tmp / "c" / "test" / "evaluation", keep / "test")
            shutil.copy(tmp / "metrics" / "scores.mean.json", keep / "scores.mean.json")

    print(f"trainer phase launches: (a)+(b) {fit_launches}, (c) {test_launches}")
    if min(fit_launches[k] for k in kernels.launch_counts) < 1:
        raise AssertionError(f"a kernel did not run in the trainer's fit: {fit_launches}")
    # 4 train steps of 2 scenes x 4 target views, the validation's two
    # renders of 4 views, two videos of 30 views and two tests of 4 scenes
    # of 48 views: a render call's views are its passes.
    expected = 4 * passes(2 * 4) + 2 * passes(4) + 2 * passes(30) + 2 * 4 * passes(48)
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
    image over its depth in color, 2 pixels apart), the 30 views in one pass
    of both forward kernels, and the file the logger wrote (an mp4 with
    ffmpeg, else the frames as PNGs)."""
    if [v["mode"] for v in videos] != ["wobble", "interpolation"]:
        raise AssertionError(f"(a) rendered the videos {[v['mode'] for v in videos]}")
    for v in videos:
        frames = v["frames"]
        if len(frames) != 58 or any(f.shape != (2 * size + 2, size, 3) or not np.isfinite(f).all() for f in frames):
            raise AssertionError(f"video {v['mode']}: {len(frames)} frames, shapes {sorted({f.shape for f in frames})}")
        if any(v["launches"][k] != passes(30) for k in FORWARD_KERNELS):
            raise AssertionError(f"video {v['mode']}: launches {v['launches']}, not {passes(30)} of each forward kernel")
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
        if on_card and any(launches[k] != 2 * passes(3) for k in FORWARD_KERNELS):
            raise AssertionError(f"(i) forward kernel launches {launches}, not {2 * passes(3)} each (a pass a scene)")
        print(f"  (i) convert_checkpoint: {counts}; serving the converted file: 6 PNGs bit for bit those of the "
              f"model's own checkpoint, launches {launches}")

        # (ii) projections
        model = model.to(device).eval()
        batch = make_batch(np.random.default_rng(seed), 2, 4, size, device)
        shimmed, gaussians = slice_gaussians(model, batch, seed)
        records = []
        composite_tiled = api.composite_tiled
        render_orthographic = validation_in_3d.render_orthographic

        def spy_composite(sg, shape, background, cap, *args, **kwargs):
            result = composite_tiled(sg, shape, background, cap, *args, **kwargs)
            records.append({"cap": cap, "pairs": int(result[3].sum()), "sg": sg})
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
        depth = sg.depth.reshape(-1).contiguous()
        flush = torch.empty(FLUSH_BYTES // 4, device=device) if on_card else None
        pairs, out["duplicate_ms"] = [], {}
        for slots in (cap, MAX_TILES_PER_GAUSSIAN):
            counts_, base, nx, mask = tile_rects(sg, size // 16, size // 16, slots)
            ids, keys, _ = kernels.duplicate_with_keys(counts_, mask, base, nx, depth, size // 16, slots)
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
        if on_card and any(launches[k] != 2 * passes(3) for k in FORWARD_KERNELS):
            raise AssertionError(f"(iv) render_uncertainty launches {launches}, not {2 * passes(3)} each")
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


def launches_at(launches: dict, entry: dict) -> int:
    """A kernel row's launches in `launches` (read_launches' dict), the
    compositing kernels' read at the row's channel count (the kernel and
    backward phases' rows are the flagship's 8 channels) and the two
    composite kernels' at the row's variant ("exact" unless it names one)."""
    name = entry["name"]
    if name == "duplicate_with_keys":
        return launches[name]
    channels = entry.get("channels", entry.get("row", 14) - 6)
    if name in launches["by_variant"]:
        return launches["by_variant"][name].get(entry.get("variant", "exact"), {}).get(channels, 0)
    return launches["by_channels"][name].get(channels, 0)


def reset_launches() -> None:
    from latentsplat_tpu_torch.ops.rasterize import kernels

    for key in kernels.launch_counts:
        kernels.launch_counts[key] = 0
    for counts in (*kernels.launches_by_channels.values(), *kernels.launches_by_variant.values()):
        counts.clear()


def read_launches() -> dict:
    """Each kernel's launches, composite_forward's by channel count, each
    compositing kernel's by channel count under "by_channels" and the
    composite kernels' by variant and channel count under "by_variant"."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    return {**kernels.launch_counts,
            "composite_forward_by_channels": dict(kernels.launches_by_channels["composite_forward"]),
            "by_channels": {k: dict(v) for k, v in kernels.launches_by_channels.items()},
            "by_variant": {k: {variant: dict(c) for variant, c in v.items()}
                           for k, v in kernels.launches_by_variant.items()}}


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
    if launches["composite_forward"] != 2 * passes(3):
        raise AssertionError(f"(s2) test mode: composite_forward ran {launches['composite_forward']} times, "
                             f"not {2 * passes(3)} (a pass a scene)")


def switch_latents(seed: int, device, size: int = 256) -> tuple[list[dict], dict]:
    """(s3) variational=latents: on a pass of the target views
    composite_forward and composite_backward at 12 channels and reduce_pairs
    at rows of 18 against
    their plain versions, timed beside their bounds, and the fast family's
    variants at 12 channels (`fast_kernel_checks`); then 2 train steps, a
    render without gradient and 1 train step at precision fast. Returns the
    records (the fast ones with their launches) and the exact steps'
    launches."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.ops.rasterize import kernels

    cfg = load_config("re10k", ["model.variational=latents"])
    state, _, train_step = switch_state(cfg, seed, device)
    model = state.model.eval()
    sg, shape = target_views(model, make_batch(np.random.default_rng(seed), 2, 4, size, device), seed, flatten=True)
    view = depth_view(sg, shape)
    if view["attrs"].shape[1] != 18:
        raise AssertionError(f"(s3): rows of {view['attrs'].shape[1]}, not 6 + 12")
    err = check_forward(view, "switches (s3) target views")
    args = (view["gids"], view["ranges"], view["attrs"], view["tiles_x"], shape)
    ms = device_ms(lambda: kernels.composite_forward(*args))
    plain_ms = cuda_ms(lambda: kernels.composite_forward_reference(*args), 3)
    view["work"] = counted_work(view)
    print(f"switches (s3): composite_forward at 12 channels {ms:.4f} ms (device) vs plain {plain_ms:.4f} ms; "
          f"{view['gids'].shape[0]} pairs")
    records = [forward_entry(err, ms, plain_ms, view)]
    records += backward_kernel_phase(view, seed)
    records[1]["channels"] = 12
    records[2]["row"] = 18
    fast_records = fast_kernel_checks(sg, shape, seed, "switches (s3) target views")
    del view, sg
    serve_batch = make_batch(np.random.default_rng(seed), 2, 4, size, device)
    model.train()
    batch = model.data_shim(make_batch(np.random.default_rng(seed + 2), 2, 4, size, device, 2))
    _, _, _, _, launches = timed_steps("switches (s3) variational=latents train", state, train_step, batch,
                                       seed + 3, 2)
    by_channels = launches["composite_forward_by_channels"]
    n = 2 * passes(2 * 4)
    if by_channels.get(12) != n or launches["composite_backward"] != n or launches["reduce_pairs"] != n:
        raise AssertionError(f"(s3): the 12-channel kernels ran {launches}, not once a pass, {n} in 2 steps")
    # At precision fast: the decoder without gradient on a batch's mean and
    # logvar Gaussians, as the step renders them (the coef variant once a
    # pass; render_full, like the JAX package's, samples the Gaussians and
    # serves no `latents` model), and one train step (the fast variants
    # once a pass), whose launches the 12-channel fast rows take.
    model.decoder.cfg.precision = "fast"
    try:
        model.eval()
        shimmed, flat = slice_gaussians(model, serve_batch, seed, flatten=True)
        target = shimmed["target"]
        size = model.scaled_size(model.scale_factor, target["image"].shape[2:4])
        reset_launches()
        with torch.no_grad():
            served = model.decoder(flat, target["extrinsics"], target["intrinsics"], target["near"], target["far"],
                                   size)
        torch.cuda.synchronize()
        serve_launches = read_launches()
        model.train()
        _, _, _, _, fast_launches = timed_steps("switches (s3) variational=latents train at precision fast", state,
                                                train_step, batch, seed + 4, 1)
    finally:
        model.decoder.cfg.precision = "exact"
    if not all(torch.isfinite(x).all() for x in (served.color, served.feature_posterior.mean, served.depth)):
        raise AssertionError("(s3) at precision fast: non-finite render")
    expected = ({"composite_forward": {"coef": {12: passes(4)}}, "composite_backward": {}},
                {"composite_forward": {"fast": {12: passes(8)}}, "composite_backward": {"fast": {12: passes(8)}}})
    if (serve_launches["by_variant"], fast_launches["by_variant"]) != expected:
        raise AssertionError(f"(s3) at precision fast: launches {serve_launches['by_variant']} serving, "
                             f"{fast_launches['by_variant']} training, not {expected}")
    for record in fast_records:
        record["launches"] = launches_at(serve_launches if record["variant"] == "coef" else fast_launches, record)
    return records + fast_records, launches


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
    from latentsplat_tpu_torch.training import step as step_module
    from latentsplat_tpu_torch.training.step import generator_grads, make_step_flags

    grads = step_module._grads
    cfg = load_config("re10k")
    state, losses, train_step = switch_state(cfg, seed, device)
    model = state.model
    mcfg = model.cfg
    batch = model.data_shim(make_batch(np.random.default_rng(seed + 2), 2, 4, size, device, 2))
    noise = flagship_noise(model, batch, seed + 5)
    flags = make_step_flags(losses, TRAIN_STEP)

    stages: dict[str, dict[str, tuple[float, float]]] = {}

    def grads_of(label: str):
        """generator_grads on the state, batch and noise; keeps under
        stages[label] each stage's (peak, held at its end) in GiB: the
        forward, each probe backward, the final backward."""
        marks = stages[label] = {}

        def mark(name):
            torch.cuda.synchronize()
            marks[name] = (torch.cuda.max_memory_allocated() / 2**30, torch.cuda.memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()

        @contextmanager
        def timer(name):
            yield
            if name == "generator_forward":
                mark("forward")

        def staged_grads(output, params, retain_graph=False):
            out = grads(output, params, retain_graph)
            mark(f"probe {sum(k.startswith('probe') for k in marks) + 1}" if retain_graph else "final backward")
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = time.perf_counter()
        step_module._grads = staged_grads
        try:
            out, total, _, _ = generator_grads(state, losses, flags, batch, TRAIN_STEP, noise=noise, timer=timer)
        finally:
            step_module._grads = grads
        torch.cuda.synchronize()
        seconds, launches = time.perf_counter() - start, read_launches()
        peak = max(p for p, _ in marks.values())
        print(f"switches {label}: generator/total {float(total)!r}, forward + backward {seconds:.4f} s, "
              f"peak {peak:.3f} GiB, launches {launches}; GiB (peak, held after) "
              + ", ".join(f"{k} ({p:.3f}, {h:.3f})" for k, (p, h) in marks.items()))
        return out, float(total), launches

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
        out, total, launches = grads_of(f"(s4) remat {policy}")
        err, leaf = leaf_errors(out, plain)
        print(f"switches (s4) remat {policy}: generator/total equal to plain {total == plain_total} "
              f"({abs(total - plain_total) / abs(plain_total):.3e} relative); largest leaf difference {err:.3e} "
              f"of its largest value ({leaf}); bit-identical {all(torch.equal(out[n], plain[n]) for n in plain)}")
        if abs(total - plain_total) > 1e-6 * abs(plain_total) or err > max(1e-6, 4 * floor_err):
            raise AssertionError(f"(s4) remat {policy} differs from the plain step")
        n = 2 * passes(2 * 4)
        if launches["composite_forward"] != n or launches["duplicate_with_keys"] != n:
            raise AssertionError(f"(s4) remat {policy}: {launches['composite_forward']} forward launches, not {n}: "
                                 "the pass and its recomputation")
        del out
    mcfg.remat, mcfg.remat_policy = False, "nothing"
    model.decoder.cfg.remat = False
    torch.backends.cudnn.deterministic = False
    remat_peaks(stages, card())

    for dtype in ("bfloat16", "vae:bfloat16,lpips:bfloat16,disc:bfloat16"):
        mcfg.compute_dtype = dtype
        out, total, _ = grads_of(f"(s5) compute_dtype={dtype}")
        rel = abs(total - plain_total) / abs(plain_total)
        err, leaf = leaf_errors(out, plain)
        print(f"switches (s5) {dtype}: generator/total {total:.6g} vs float32 {plain_total:.6g}, {rel:.3e} relative "
              f"(tolerance 0.05); largest leaf difference {err:.3e} of its largest value ({leaf})")
        if not rel <= 0.05:
            raise AssertionError(f"(s5) {dtype}: generator/total {rel:.3e} relative from float32")
        del out
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


def remat_peaks(stages: dict, device_name: str) -> dict:
    """(s4)'s peaks of generator_grads in one process on one state, batch
    and noise: no remat, then each policy. Prints each setting's peak, the
    stage that sets it and what the probes leave held; asserts that
    `nothing` has the smallest peak and `dots` one at or below no remat's.
    Returns {setting: peak GiB}."""
    settings = {"none": "(s4) plain", "nothing": "(s4) remat nothing", "dots": "(s4) remat dots",
                "vae:off,lpips:off": "(s4) remat vae:off,lpips:off"}
    peaks = {}
    for setting, label in settings.items():
        marks = stages[label]
        peak, stage = max((p, k) for k, (p, _) in marks.items())
        probes = [k for k in marks if k.startswith("probe")]
        kept = marks[probes[-1]][1] - marks["forward"][1] if probes else 0.0
        peaks[setting] = peak
        print(f"switches (s4) remat peak, {setting}: {peak:.3f} GiB in the {stage} (forward {marks['forward'][0]:.3f}, "
              f"final backward {marks['final backward'][0]:.3f}); the probes leave {kept:.3f} GiB held; "
              f"{device_name}")
    print("switches (s4) remat peaks (GiB, one process): " + json.dumps({k: round(v, 4) for k, v in peaks.items()}))
    if peaks["nothing"] > min(peaks.values()):
        raise AssertionError(f"(s4) remat nothing is not the smallest peak: {peaks}")
    if peaks["dots"] > peaks["none"]:
        raise AssertionError(f"(s4) remat dots peaks above no remat: {peaks}")
    return peaks


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
        if "launches" not in record:
            record["launches"] = (launches["composite_forward_by_channels"][12]
                                  if record["name"] == "composite_forward" else launches[record["name"]])
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
    plain version on a pass of the narrow model's 2 target views at 32x32, with a seeded
    random cotangent: 1e-4 of each gradient column's largest value, the
    same bits on a second launch; reduce_pairs over its rows (10 floats)
    exactly against its plain version on the CPU."""
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.ops.rasterize import kernels

    model = build_model(load_config("re10k", SMALL_OVERRIDES), seed, device)
    sg, shape = target_views(model, make_batch(np.random.default_rng(seed), 2, 2, 32, device), seed,
                             depth_payload=True)
    view = depth_view(sg, shape)
    check_forward(view, "small input")
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    n = view["items"]
    args = (view["gids"], view["ranges"], view["order"], view["attrs"], view["tiles_x"], shape, view["last"],
            view["t_final"], torch.randn((n, 4, *shape), generator=gen, device=device),
            torch.randn((n, *shape), generator=gen, device=device))
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


# -- the parallel phase ----------------------------------------------------------


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def capturing(base):
    """`base` (a train step's reduce) that also keeps a CPU copy of the
    gradient averages it returns: the generator's, then the
    discriminator's."""

    class Capturing(base):
        def mean_grads(self, grads):
            out = super().mean_grads(grads)
            prefix = "discriminator." if hasattr(self, "grads") else "generator."
            self.grads = {**getattr(self, "grads", {}),
                          **{prefix + n: g.detach().cpu().clone() for n, g in out.items()}}
            return out

    return Capturing


class DiscriminatorCalls:
    """A train step's `timer` that keeps the discriminator's calls in the
    step's "discriminator" stage: each call's input and logits, detached,
    in the step's order (per GAN site, its fakes, then its reals)."""

    def __init__(self, discriminator):
        self.calls, self.active = [], False
        self.handle = discriminator.register_forward_hook(self.keep)

    def keep(self, module, args, output):
        if self.active:
            self.calls.append((args[0].detach(), output.detach()))

    @contextmanager
    def __call__(self, name):
        self.active = name == "discriminator"
        try:
            yield
        finally:
            self.active = False


def hinge_masks(logits: list) -> list:
    """Each discriminator call's hinge mask, the logits whose loss term has
    a gradient: relu(1 + l) on the fakes (even calls), relu(1 - l) on the
    reals (odd calls)."""
    return [l > -1.0 if k % 2 == 0 else l < 1.0 for k, l in enumerate(logits)]


def hinge_coefficients(losses, n_calls: int) -> list:
    """Each discriminator call's d(loss)/d(logit) where its hinge mask is
    set, times the call's logit count: +-weight / 2 (+ on the fakes, - on
    the reals), at TRAIN_STEP's gate."""
    from latentsplat_tpu_torch.training.step import make_step_flags

    flags = make_step_flags(losses, TRAIN_STEP)
    out = []
    for k in range(n_calls):
        d = losses[flags.disc[k // 2]].cfg.discriminator
        if d.loss != "hinge":
            raise AssertionError(f"(p1) counts hinge masks; {flags.disc[k // 2]} has a {d.loss} loss")
        gate = 1.0 if TRAIN_STEP >= d.apply_after_step else 0.0
        out.append((1.0 if k % 2 == 0 else -1.0) * d.weight / 2.0 * gate)
    return out


def masked_disc_grads(state, losses, calls: list, params: dict, masks: list, reduce) -> dict:
    """The discriminator's gradients, averaged by `reduce`, of the step's
    hinge loss with each logit's hinge mask given (`masks`, one per call)
    instead of taken from the logit, at `params` on the calls' inputs; the
    step's own gradients where the masks are the logits' own. The
    discriminator's parameters are left as they were."""
    from latentsplat_tpu_torch.training.step import _grads

    named = dict(state.discriminator.named_parameters())
    now = {n: p.detach().clone() for n, p in named.items()}
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(params[n])
    total = 0.0
    for (x, _), mask, coef in zip(calls, masks, hinge_coefficients(losses, len(calls))):
        total = total + coef / mask.numel() * (state.discriminator(x) * mask).sum()
    grads = reduce.mean_grads(_grads(total, named))
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(now[n])
    return {f"discriminator.{n}": g.detach().cpu() for n, g in grads.items()}


def parallel_rank(mesh, cfg, seed: int, initial: str, batch: dict, noise: dict, ref_logits: list) -> dict:
    """One rank of (p1), in its own process: the flagship state at
    TRAIN_STEP with the reference's initial tensors (read from the file
    `initial`), broadcast from rank 0 and checked equal, then two
    data-parallel steps on this rank's rows of the batch and noise. Returns
    the first step's logs (and, on rank 0, its averaged gradients and
    updated parameters, on the CPU), each step's seconds and launches,
    the broadcast's seconds and this process's peak memory; and, of the
    first step's discriminator calls, this rank's hinge masks against
    those of the one-process logits `ref_logits` at its rows (mask sums,
    the logits whose masks differ and their largest distance from the
    hinge's edge), and on rank 0 the averaged discriminator gradients
    recomputed with the one-process masks and with the ranks' own."""
    from latentsplat_tpu_torch.model.discriminator.patch_gan import set_batch_norm_group
    from latentsplat_tpu_torch.parallel import replicate_state, shard_batch
    from latentsplat_tpu_torch.parallel.mesh import RankReduce, assert_replicated, state_tensors
    from latentsplat_tpu_torch.training.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, losses, _ = switch_state(cfg, seed, mesh.device)
    tensors = state_tensors(state)
    with torch.no_grad():
        for k, t in torch.load(initial, map_location="cpu", mmap=True, weights_only=True).items():
            tensors[k].copy_(t)
    sync(mesh.device)
    start = time.perf_counter()
    replicate_state(state, mesh)
    sync(mesh.device)
    replicate_s = time.perf_counter() - start
    set_batch_norm_group(state.discriminator, mesh.group)
    g = cfg.optimizer.generator
    reduces = [(capturing(RankReduce) if mesh.is_main else RankReduce)(mesh), RankReduce(mesh)]
    rows, rows_noise = shard_batch(batch, mesh), shard_batch(noise, mesh)
    disc_before = {n: p.detach().clone() for n, p in state.discriminator.named_parameters()}
    calls = DiscriminatorCalls(state.discriminator)
    sync(mesh.device)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    out = {"seconds": [], "launches": [], "replicate_s": replicate_s}
    for i, reduce in enumerate(reduces):
        train_step = make_train_step(losses, g.skip_loss_spike_factor, g.skip_loss_spike_patience, reduce=reduce)
        reset_launches()
        sync(mesh.device)
        start = time.perf_counter()
        state, logs = train_step(state, rows, TRAIN_STEP, noise=rows_noise, timer=calls if i == 0 else None)
        sync(mesh.device)
        out["seconds"].append(time.perf_counter() - start)
        out["launches"].append(read_launches())
        if i == 0:
            calls.handle.remove()
            assert_replicated(state_tensors(state), mesh, "the state after the first data-parallel step")
            out["logs"] = {k: float(v) for k, v in logs.items()}
            if mesh.is_main:
                out["grads"], out["params"] = reduce.grads, updated_params(state)
            own = [l for _, l in calls.calls]
            n = own[0].shape[0]
            ref = [torch.as_tensor(l[mesh.rank * n : (mesh.rank + 1) * n], device=mesh.device) for l in ref_logits]
            own_masks, ref_masks = hinge_masks(own), hinge_masks(ref)
            out["hinge"] = [
                {"own": int(a.sum()), "ref": int(b.sum()), "differ": int((a != b).sum()),
                 "edge": max([float((l[a != b].abs() - 1.0).abs().max()) for l in (o, r) if (a != b).any()],
                             default=0.0)}
                for a, b, o, r in zip(own_masks, ref_masks, own, ref)]
            # Collectives on both ranks alike: the BatchNorms' sums, the average.
            masked = {label: masked_disc_grads(state, losses, calls.calls, disc_before, masks, RankReduce(mesh))
                      for label, masks in (("ref_masks", ref_masks), ("own_masks", own_masks))}
            if mesh.is_main:
                out.update(masked)
            del calls, own, ref, masked
    out["peak"] = peak_bytes(mesh.device)
    return out


def updated_params(state) -> dict:
    """The generator's and the discriminator's parameters, on the CPU."""
    nets = {f"generator.{n}": p for n, p in state.model.named_parameters()}
    nets.update({f"discriminator.{n}": p for n, p in state.discriminator.named_parameters()})
    return {n: p.detach().cpu().clone() for n, p in nets.items()}


def split_probe_weights(state, losses, batch: dict, noise: dict) -> dict:
    """Each GAN site's adaptive weight with the nll probe taken scene by
    scene and averaged, as the ranks take it, and the generator-loss probe
    of the whole batch: the one-process weight without the rounding that
    the batch size alone brings (an l1 loss's gradient flips its sign
    where the decoded image meets the target within rounding)."""
    from latentsplat_tpu_torch.loss.losses import adaptive_gan_weight
    from latentsplat_tpu_torch.training.step import _grads, generator_forward, make_step_flags

    flags = make_step_flags(losses, TRAIN_STEP)
    leaf = {"last": state.model.last_layer()}

    def probes(b, n):
        _, gan_nll, gan_g, _, _ = generator_forward(state, losses, flags, b, TRAIN_STEP, None, n)
        return [(_grads(x, leaf, retain_graph=True)["last"], _grads(y, leaf, retain_graph=True)["last"])
                for x, y in zip(gan_nll, gan_g)]

    def scene(tree, s):
        return {k: scene(v, s) if isinstance(v, dict) else v[s : s + 1] for k, v in tree.items()}

    whole = probes(batch, noise)
    scenes = [probes(scene(batch, s), scene(noise, s)) for s in range(2)]
    return {f"{name}/adaptive_weight": float(adaptive_gan_weight((scenes[0][i][0] + scenes[1][i][0]) / 2, whole[i][1]))
            for i, name in enumerate(flags.gen_gan)}


# One-process repeats that set (p1)'s bounds: with 3, 1 run in 10 had 3
# updated parameters over their bound, each on another leaf than the
# earlier misses; with 8, none of the same 10 runs had one.
P1_REPEATS = 8


def leaf_report(ours: dict, ref: dict, repeats: list, floor: float = 1e-6) -> tuple[list, str]:
    """Each leaf's error against `ref` as a share of its largest |ref| (at
    least 1e-4 of the largest of all leaves, as `leaf_errors` takes it, for
    leaves that are zero but for rounding), and its bound max(floor, 4x the
    largest of the repeats' errors); (leaves over their bound, a summary
    line)."""
    over, worst = [], (0.0, None, None)
    least = 1e-4 * max(float(v.abs().max()) for v in ref.values())
    for name, value in ref.items():
        scale = max(float(value.abs().max()), least)
        err = float((ours[name] - value).abs().max()) / scale
        bound = max(floor, 4 * max(float((rep[name] - value).abs().max()) for rep in repeats) / scale)
        if err > bound:
            over.append((name, err, bound))
        if worst[1] is None or err / bound > worst[0] / worst[2]:
            worst = (err, name, bound)
    return over, (f"{len(ref)} leaves, {len(over)} over their bound; closest to or furthest over its bound "
                  f"{worst[1]} {worst[0]:.3e} of its largest value (bound {worst[2]:.3e})")


def parallel_step_check(cfg, seed: int, device, size: int = 256, n_repeats: int = P1_REPEATS) -> dict:
    """(p1) Two ranks on the one card over gloo, each with 1 scene, against
    the one-process step on the same 2 scenes (2 context + 4 target views at
    256x256, step 125000), weights, noise and Adam moments (of one earlier
    step). The repeats are the one-process step on images 1, 2, ...,
    `n_repeats` rounding steps up. Held: generator/total within max(1e-6, 4x the
    repeats' difference) relative; each adaptive weight within max(1e-6,
    4x the repeats') of the one-process weight whose nll probe is taken
    scene by scene (`split_probe_weights`); the generator's averaged
    gradients, each leaf (of its largest value) within max(1e-6, 4x the
    repeats'), and both nets' updated parameters within max(1e-5, 4x the
    repeats'); both ranks' states bit-identical after the step; each kernel
    launched on each rank in each step. The reference runs first and
    leaves the card before the ranks start."""
    from latentsplat_tpu_torch.parallel import spawn
    from latentsplat_tpu_torch.parallel.mesh import state_tensors
    from latentsplat_tpu_torch.training.step import LocalReduce, make_train_step

    state, losses, _ = switch_state(cfg, seed, device)
    g = cfg.optimizer.generator
    batches = [state.model.data_shim(make_batch(np.random.default_rng(seed + 5 + i), 2, 4, size, device, 2))
               for i in range(2)]
    noises = [flagship_noise(state.model, b, seed + 7 + i) for i, b in enumerate(batches)]
    # A step on another batch first, so that Adam's moments hold a history
    # as a run's do at step 125000: from zero moments every element moves
    # by the learning rate times the sign of its gradient, and a gradient
    # at the level of rounding would flip its move.
    step = make_train_step(losses, g.skip_loss_spike_factor, g.skip_loss_spike_patience)
    state, _ = step(state, batches[1], TRAIN_STEP, noise=noises[1])
    batch, noise = batches[0], noises[0]
    split = split_probe_weights(state, losses, batch, noise)
    initial = {k: t.detach().cpu().clone() for k, t in state_tensors(state).items()}
    # The repeats: the same step on images 1, 2, ... rounding steps up
    # (each pixel moved to the next float32 above it, n times): how far the
    # step's own rounding moves its results, l1's sign flips where a
    # decoded pixel meets its target included, as a batch of another size
    # rounds differently.
    inputs = [batch]
    for _ in range(n_repeats):
        inputs.append({key: dict(views, image=torch.nextafter(views["image"], views["image"] + 1.0))
                       for key, views in inputs[-1].items()})
    refs, ref_s, ref_logits = [], [], []
    for images in inputs:
        with torch.no_grad():
            for k, t in state_tensors(state).items():
                t.copy_(initial[k])
        reduce = capturing(LocalReduce)()
        train_step = make_train_step(losses, g.skip_loss_spike_factor, g.skip_loss_spike_patience, reduce=reduce)
        calls = DiscriminatorCalls(state.discriminator)
        sync(device)
        start = time.perf_counter()
        state, logs = train_step(state, images, TRAIN_STEP, noise=noise, timer=calls)
        sync(device)
        ref_s.append(time.perf_counter() - start)
        calls.handle.remove()
        refs.append(({k: float(v) for k, v in logs.items()}, reduce.grads, updated_params(state)))
        ref_logits.append([l.cpu().numpy() for _, l in calls.calls])
        del calls
    ref_logs = refs[0][0]
    coefs = hinge_coefficients(losses, len(ref_logits[0]))
    # The repeats' hinge masks against the reference's: how often rounding
    # alone moves a logit across the hinge's edge.
    repeat_flips = [sum(int((a != b).sum()) for a, b in zip(hinge_masks([torch.as_tensor(l) for l in rep]),
                                                            hinge_masks([torch.as_tensor(l) for l in ref_logits[0]])))
                    for rep in ref_logits[1:]]
    # The ranks take numpy arrays and a file: tensors handed to a spawned
    # process would pass through shared memory, which a container may cap.
    host = lambda tree: {k: host(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in tree.items()}  # noqa: E731
    batch, noise = host(batch), host(noise)
    del state, train_step, step, reduce, inputs, batches, noises
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        torch.save(initial, Path(tmp) / "initial.pt")
        del initial
        start = time.perf_counter()
        ranks = spawn(parallel_rank, [device, device], "gloo",
                      (cfg, seed, str(Path(tmp) / "initial.pt"), batch, noise, ref_logits[0]), join_timeout=600)
        spawn_s = time.perf_counter() - start
    ours, failures = ranks[0], []
    total, ref_total = ours["logs"]["generator/total"], ref_logs["generator/total"]
    total_err = abs(total - ref_total) / abs(ref_total)
    # The encoder samples each ray's depth bucket by inverse CDF: rounding
    # moves a sample across a bucket's edge now and then, so the total's own
    # repeats differ by more than float32's rounding.
    total_repeat = max(abs(r[0]["generator/total"] - ref_total) for r in refs[1:]) / abs(ref_total)
    print(f"parallel (p1) on {card()}: generator/total 2 ranks {total!r}, one process {ref_total!r} "
          f"(repeats {[r[0]['generator/total'] for r in refs[1:]]}); relative difference {total_err:.3e}, "
          f"the repeats' {total_repeat:.3e}")
    if total_err > max(1e-6, 4 * total_repeat) or ranks[1]["logs"]["generator/total"] != total:
        failures.append("generator/total")
    if not split:
        failures.append("no adaptive weight at step 125000")
    for key, w_split in split.items():
        err, repeat = abs(ours["logs"][key] - w_split), max(abs(r[0][key] - ref_logs[key]) for r in refs[1:])
        print(f"parallel (p1) on {card()}: {key} 2 ranks {ours['logs'][key]!r}; one process {ref_logs[key]!r}, with its "
              f"nll probe scene by scene {w_split!r}; difference from the latter {err:.3e}, from the former "
              f"{abs(ours['logs'][key] - ref_logs[key]):.3e}; one-process repeat {repeat:.3e}")
        if err > max(1e-6, 4 * repeat):
            failures.append(key)
    # The discriminator's hinge loss has a gradient of +-weight / 2 / M at
    # each of a call's M logits inside its hinge (fake > -1, real < 1) and
    # none elsewhere, so conv_out.bias's gradient is the sum of those
    # shares: with every logit inside, +weight / 2 on the fakes and
    # -weight / 2 on the reals cancel, and what is left is the float32
    # rounding of the two sums. Held: on each side that gradient is the
    # shares of its own masks' counts, within 64 float32 epsilons of the
    # shares' absolute sum (a logit's share is ~100 times that), so a
    # logit that the ranks' BatchNorm sums (two halves) round across an
    # edge shows in the counts and explains the gap; recomputed with the
    # ranks' own masks, the ranks' gradients are the step's within 1e-6;
    # recomputed with the one-process masks, they are the one-process
    # gradients within max(1e-6, 4x the repeats'), of those repeats whose
    # masks are the one-process step's, every leaf but the bias.
    hinge = [{k: sum(r["hinge"][c][k] for r in ranks) if k != "edge" else max(r["hinge"][c][k] for r in ranks)
              for k in ranks[0]["hinge"][c]} for c in range(len(coefs))]
    m = [l.size for l in ref_logits[0]]
    bias = "discriminator.conv_out.bias"
    eps = float(torch.finfo(torch.float32).eps)
    print(f"parallel (p1) on {card()}: hinge masks of the discriminator's {len(coefs)} calls ({m} logits; inside "
          f"the hinge, 2 ranks {[h['own'] for h in hinge]}, one process {[h['ref'] for h in hinge]}): "
          f"{[h['differ'] for h in hinge]} logits differ (furthest from the edge {max(h['edge'] for h in hinge):.3e}); "
          f"the repeats' against the one process {repeat_flips}; one logit's share "
          f"{min(abs(c) / n for c, n in zip(coefs, m))!r}")
    for label, value, key in (("2 ranks' step", ours["grads"][bias], "own"),
                              ("one process's step", refs[0][1][bias], "ref"),
                              ("2 ranks recomputed with the one-process masks", ours["ref_masks"][bias], "ref")):
        shares = sum(c / n * h[key] for c, n, h in zip(coefs, m, hinge))
        tol = 64 * eps * sum(abs(c) / n * h[key] for c, n, h in zip(coefs, m, hinge))
        err = abs(float(value.sum()) - shares)
        print(f"parallel (p1) on {card()}: {bias} gradient, {label}: {float(value.sum())!r}; its masks' shares "
              f"{shares!r}, apart {err:.3e} (bound {tol:.3e})")
        if err > tol:
            failures.append(f"{bias}, {label}: {float(value.sum())!r} is not its masks' shares {shares!r}")

    def only(tree, prefix):
        return {k: v for k, v in tree.items() if k.startswith(prefix) and k != bias}

    # Held: the generator's averaged gradients and both nets' updated
    # parameters. Adam's update divides two moments, so an element whose
    # gradient is small beside its history carries the gradient's rounding
    # into the parameter magnified: the parameters' floor is 1e-5.
    disc_ref = only(refs[0][1], "discriminator.")
    for label, got, ref, repeats, floor in (
        ("averaged generator gradients", only(ours["grads"], "generator."), only(refs[0][1], "generator."),
         [only(r[1], "generator.") for r in refs[1:]], 1e-6),
        ("averaged discriminator gradients recomputed with the ranks' own hinge masks, against the step's",
         ours["own_masks"], {**only(ours["grads"], "discriminator."), bias: ours["grads"][bias]}, None, 1e-6),
        (f"averaged discriminator gradients but {bias}, recomputed with the one-process hinge masks",
         only(ours["ref_masks"], "discriminator."), disc_ref,
         [only(r[1], "discriminator.") for r, f in zip(refs[1:], repeat_flips) if f == 0], 1e-6),
        ("updated parameters", ours["params"], refs[0][2], [r[2] for r in refs[1:]], 1e-5),
    ):
        over, line = leaf_report(got, ref, repeats or [ref], floor)
        print(f"parallel (p1) on {card()}: {label}: {line}; over: {[(n, f'{e:.2e}', f'{u:.2e}') for n, e, u in over[:6]]}")
        if repeats and len(repeats) > 3:   # the bound of the first three repeats, beside it
            first = leaf_report(got, ref, repeats[:3], floor)[0]
            print(f"parallel (p1): {label}, bound of repeats 1-3 only: {len(first)} over: "
                  f"{[(n, f'{e:.2e}', f'{u:.2e}') for n, e, u in first[:6]]}")
        if over:
            failures.append(f"{len(over)} {label}")
    for r, rank in enumerate(ranks):
        for i, launches in enumerate(rank["launches"]):
            if min((launches[k] for k in ALL_KERNELS), default=1) < 1:
                failures.append(f"rank {r}'s step {i + 1} launches {launches}")
    print(f"parallel (p1) on {card()}: seconds per step (host clock, synchronized) rank 0 "
          f"{[round(x, 4) for x in ranks[0]['seconds']]}, rank 1 {[round(x, 4) for x in ranks[1]['seconds']]}; "
          f"one process with both scenes {[round(x, 4) for x in ref_s]}; peak memory rank 0 "
          f"{ranks[0]['peak'] / 2**30:.3f} GiB, rank 1 {ranks[1]['peak'] / 2**30:.3f} GiB; state broadcast "
          f"{ranks[0]['replicate_s']:.2f} s; the ranks' whole run {spawn_s:.1f} s; launches a step, rank 0 "
          f"{ranks[0]['launches'][1]}, rank 1 {ranks[1]['launches'][1]}")
    if failures:
        raise AssertionError(f"the 2-rank step differs from the one-process step: {failures}")
    return {"launches_per_rank_step": ranks[0]["launches"][1],
            "seconds": [r["seconds"][1] for r in ranks], "one_process_seconds": ref_s[1],
            "peak_gib": [r["peak"] / 2**30 for r in ranks]}


def video_cameras(context: dict, num_frames: int = 30) -> dict:
    """`Trainer.render_video`'s interpolation between the first and last
    context views of scene 0, as (1, V, ...) tensors."""
    from latentsplat_tpu_torch.visualization.camera_trajectory import interpolate_extrinsics, interpolate_intrinsics

    t = np.linspace(0, 1, num_frames, dtype=np.float32)
    t = (np.cos(np.pi * (t + 1)) + 1) / 2
    ext, intr = context["extrinsics"][0].cpu().numpy(), context["intrinsics"][0].cpu().numpy()
    device = context["extrinsics"].device
    return {
        "extrinsics": torch.from_numpy(interpolate_extrinsics(ext[0], ext[-1], t)[None]).to(device),
        "intrinsics": torch.from_numpy(interpolate_intrinsics(intr[0], intr[-1], t)[None]).to(device),
        "near": context["near"][:1, :1].expand(1, num_frames).contiguous(),
        "far": context["far"][:1, :1].expand(1, num_frames).contiguous(),
    }


def parallel_render_check(cfg, seed: int, device, size: int = 256) -> None:
    """(p2) `make_view_parallel_render` over [cuda:0, cuda:0] on the 30-view
    video trajectory of the slice's Gaussians, bit-equal to the plain
    render; (p3) a trace of one `render_full` and one render backward
    through `misc.profiler`, holding its annotated spans and the four
    kernels."""
    from latentsplat_tpu_torch.misc.profiler import annotate, trace
    from latentsplat_tpu_torch.model.latentsplat import render_full
    from latentsplat_tpu_torch.ops.rasterize.api import render
    from latentsplat_tpu_torch.parallel import make_view_parallel_render

    model = build_model(cfg, seed, device)
    batch = make_batch(np.random.default_rng(seed), 2, 4, size, device)
    shimmed, gaussians = slice_gaussians(model, batch, seed)
    cams = video_cameras(shimmed["context"])
    gauss = {"background_color": torch.zeros(1, 3, device=device), "gaussian_means": gaussians.means,
             "gaussian_covariances": gaussians.covariances, "gaussian_opacities": gaussians.opacities,
             "gaussian_color_sh": gaussians.color_harmonics, "gaussian_feature_sh": gaussians.feature_harmonics}
    view_parallel = make_view_parallel_render([device, device], (size, size))

    def plain():
        return render(*(cams[k] for k in ("extrinsics", "intrinsics", "near", "far")), (size, size), **gauss)

    with torch.no_grad():
        outs, seconds = {}, {}
        for name, fn in (("plain", plain), ("view_parallel", lambda: view_parallel(cams, gauss))):
            sync(device)
            start = time.perf_counter()
            outs[name] = fn()
            sync(device)
            seconds[name] = time.perf_counter() - start
    for field in ("color", "feature", "mask", "depth", "num_pairs"):
        if not torch.equal(getattr(outs["plain"], field), getattr(outs["view_parallel"], field)):
            raise AssertionError(f"the view-parallel render's {field} differs from the plain render's")
    print(f"parallel (p2) on {card()}: 30 views at {size}x{size}, view-parallel over 2 shards on one card bit-equal "
          f"to the plain render; {seconds['view_parallel']:.4f} s against {seconds['plain']:.4f} s (host clock)")

    gen = torch.Generator(device=device).manual_seed(seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        with trace(Path(tmp)):
            with annotate("render_full"), torch.no_grad():
                render_full(model, batch, generator=gen)
            with annotate("render_backward"):
                opacities = gauss["gaussian_opacities"].detach().requires_grad_(True)
                out = render(*(cams[k][:, :1] for k in ("extrinsics", "intrinsics", "near", "far")), (size, size),
                             **dict(gauss, gaussian_opacities=opacities))
                out.color.sum().backward()
            sync(device)
        events = json.loads((Path(tmp) / "trace.json").read_text())["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    kernels = {k: sum(1 for e in events if e.get("cat") == "kernel" and f"{k}_kernel" in e.get("name", ""))
               for k in ALL_KERNELS}
    found = sorted(spans & {"render_full", "render_backward"})
    print(f"parallel (p3) on {card()}: the trace holds the spans {found} and the kernels {kernels} "
          f"({len(events)} events)")
    if not {"render_full", "render_backward"} <= spans or min(kernels.values(), default=1) < 1:
        raise AssertionError("the profiler's trace lacks an annotated span or a kernel")


def paper_check(rendered: Path, scores: Path, out: Path) -> None:
    """(p4) Each of the six paper generators once over the trainer phase's
    test output (c): the files written, each figure at the size its layout
    gives."""
    from latentsplat_tpu_torch.misc.image_io import load_image
    from latentsplat_tpu_torch.paper import (
        generate_ablation_image_comparison,
        generate_benchmark_table,
        generate_comparison_table,
        generate_feature_image,
        generate_image_comparison,
        generate_teaser,
    )
    from latentsplat_tpu_torch.paper.common import MARGIN
    from latentsplat_tpu_torch.visualization.annotation import draw_label

    pngs = sorted(rendered.rglob("color/*.png"))
    scene, ctx_key = pngs[0].parent.parent.parent.name, pngs[0].parent.parent.name
    indices = sorted(int(p.stem) for p in pngs if p.parent.parent.parent.name == scene)
    row = f"rows=[{{scene: {scene}, ctx_key: '{ctx_key}', index: {indices[0]}}}]"
    method = f"{{name: Ours, path: {rendered}}}"
    start = time.perf_counter()
    generate_comparison_table.main([f"metrics_path={scores}", "methods=[{name: Ours, key: ours}]",
                                    f"output_path={out / 'table.tex'}"])
    generate_benchmark_table.main([f"methods=[{method}]", f"output_path={out / 'benchmark_table.tex'}"])
    generate_image_comparison.main([f"methods=[{method}]", row, f"output_path={out / 'comparison.png'}"])
    generate_ablation_image_comparison.main([f"methods=[{method}, {method}]", row, f"output_path={out / 'ablation.png'}"])
    generate_teaser.main([f"method_path={rendered}", f"rows=[{{scene: {scene}, ctx_key: '{ctx_key}', indices: {indices}}}]",
                          f"output_path={out / 'teaser.png'}"])
    generate_feature_image.main([f"method_path={rendered}", "modalities=[{name: Color, kind: color}]", row,
                                 f"output_path={out / 'features.png'}"])
    seconds = time.perf_counter() - start
    table, bench = (out / "table.tex").read_text(), (out / "benchmark_table.tex").read_text()
    if "PSNR $\\uparrow$" not in table or "Ours" not in table or "Decoding (s)" not in bench:
        raise AssertionError("a paper table lacks its headers or its method")

    def column(label: str, width: int = 256) -> tuple[int, int]:
        """A labelled column of one 256-pixel-high image or context panel."""
        h, w = draw_label(label, font_size=18).shape[:2]
        return h + 2 + 256, max(w, width)

    def grid(*cols) -> tuple[int, int]:
        return max(h for h, _ in cols), sum(w for _, w in cols) + MARGIN * (len(cols) - 1)

    half = (256 - MARGIN) // 2   # the context panel's two views, stacked
    expected = {
        "comparison.png": grid(column("Ref.", half), column("Ours")),
        "ablation.png": grid(column("Ours"), column("Ours")),
        "teaser.png": (192, (192 - MARGIN) // 2 + (192 + MARGIN) * len(indices)),
        "features.png": grid(column("Ref.", half), column("Target View"), column("Color")),
    }
    sizes = {name: load_image(out / name).shape[:2] for name in expected}
    print(f"parallel (p4) on {card()}: the six paper generators over {len(pngs)} test PNGs in {seconds:.2f} s; "
          f"figures {sizes}")
    if sizes != expected:
        raise AssertionError(f"paper figures of sizes {sizes}, not {expected}")


def parallel_phase(seed: int, device, trainer_output: Path) -> dict:
    """(p1)-(p4); returns (p1)'s numbers."""
    from latentsplat_tpu_torch.config import load_config

    cfg = load_config("re10k")
    record = parallel_step_check(cfg, seed, device)
    parallel_render_check(cfg, seed, device)
    paper_check(trainer_output / "test", trainer_output / "scores.mean.json", trainer_output)
    return record


# -- the parent's end-to-end numbers beside this tree's --------------------------

# One turn, run in a fresh process from a checkout's root with its own
# package on the path: bench_render (64 views of 393,216 Gaussians at
# 256x256; views/s, ms a view and peak memory at fast and exact), the
# slice's decoder seconds (render_full on chip_smoke's slice batch, the
# median of 5 after a warm-up) and bench_train --full --batch 2 (seconds a
# step, peak). It calls only what the parent's checkout has too.
TURN_CODE = """
import json, statistics, tempfile, time
from contextlib import contextmanager
import numpy as np
import torch
import chip_smoke as cs
from latentsplat_tpu_torch.config import load_config
from latentsplat_tpu_torch.model.latentsplat import render_full
from latentsplat_tpu_torch.scripts import bench_train
from latentsplat_tpu_torch.scripts.bench_render import make_scene, time_render

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
device = torch.device("cuda")
out = {}
scene = make_scene(0, device=device)
n = scene["extrinsics"].shape[1]
for precision in ("fast", "exact"):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time_render(scene, 256, precision=precision)
    out[precision] = {"views_per_s": n / t["median_s"], "ms_per_view": 1e3 * t["median_s"] / n,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
del scene
model = cs.build_model(load_config("re10k"), 0, device)
batch = cs.make_batch(np.random.default_rng(0), 2, 4, 256, device)
decoder = []

@contextmanager
def timer(name):
    torch.cuda.synchronize()
    start = time.perf_counter()
    yield
    torch.cuda.synchronize()
    if name == "decoder":
        decoder.append(time.perf_counter() - start)

gen = torch.Generator(device=device)
for i in range(6):
    render_full(model, batch, generator=gen.manual_seed(i), timer=timer)
out["decoder_s"] = statistics.median(decoder[1:])
del model, batch
torch.cuda.empty_cache()
torch.backends.cudnn.allow_tf32 = True
with tempfile.TemporaryDirectory() as tmp:
    record = bench_train.main(["--full", "--batch", "2", "--out-dir", tmp], device=device)
out["full_step_s"] = 1.0 / record["value"]
out["full_peak_gib"] = record["peak_gib"]
print("TURN " + json.dumps(out))
"""


def parent_turns(parent: str) -> list:
    """TURN_CODE in the checkout `parent` and in this tree, in turns
    (parent, this tree, this tree, parent), each in its own process;
    prints and returns each turn's numbers."""
    roots = {"parent": Path(parent).resolve(), "this tree": Path(__file__).resolve().parent}
    turns = []
    for turn in ("parent", "this tree", "this tree", "parent"):
        root = roots[turn]
        proc = subprocess.run([sys.executable, "-c", TURN_CODE], cwd=root, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": str(root)}, timeout=1200)
        line = next((x for x in proc.stdout.splitlines() if x.startswith("TURN ")), None)
        if proc.returncode or line is None:
            raise AssertionError(f"--parent: the {turn}'s turn failed: {proc.stderr[-4000:]}")
        turns.append((turn, json.loads(line[5:])))
        print(f"parent vs this tree on {card()}, turn {len(turns)} ({turn}): {line[5:]}")
    return turns


# -- the pass phase --------------------------------------------------------------


def pass_phase(seed: int, device) -> dict:
    """A render call's items in one pass against one item a pass (the bound
    api.PASS_ROWS patched to 1): bench_render's 64 views of 393,216
    Gaussians at 256x256, at exact and at fast (serving, the coef
    variant), without gradient: color, feature, mask, depth and num_pairs
    the same bits, one pass and one host read (kernels.host_reads, and the
    synchronizing calls that torch.cuda's sync debug mode reports) against
    64 and 64; then a train render of 2 scenes x 4 views of that scene
    (the second scene's opacities scaled by 0.9) with gradient at exact
    and fast: the forward the same bits, each input's gradient within
    BACKWARD_RTOL of its largest value (fast: or one bfloat16 step of the
    value), the per-item passes summing a scene's gradient over its views
    in another order. Each one-pass render's peak of allocated memory
    above what was allocated before it, over its (item, Gaussian) rows,
    is printed: what api.PASS_ROWS is sized from. Returns the seconds of
    each render and these bytes a row."""
    import warnings

    from latentsplat_tpu_torch.ops.rasterize import api, kernels
    from latentsplat_tpu_torch.scripts.bench_render import make_scene

    scene = make_scene(seed, device=device)
    names = ("color", "feature", "mask", "depth")
    out = {}

    def call(precision: str, one_item: bool, inputs: dict, grad: bool):
        old = api.PASS_ROWS
        api.PASS_ROWS = 1 if one_item else old
        reset_launches()
        reads = dict(kernels.host_reads)
        try:
            sync(device)
            start = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught, torch.set_grad_enabled(grad):
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    result = api.render(
                        inputs["extrinsics"], inputs["intrinsics"], inputs["near"], inputs["far"], (256, 256),
                        inputs["background_color"], inputs["gaussian_means"], inputs["gaussian_covariances"],
                        inputs["gaussian_opacities"], inputs["gaussian_color_sh"], inputs["gaussian_feature_sh"],
                        precision=precision)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            sync(device)
            seconds = time.perf_counter() - start
        finally:
            api.PASS_ROWS = old
        syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
        reads = {k: kernels.host_reads[k] - v for k, v in reads.items()}
        return result, seconds, read_launches(), reads, syncs

    def row_bytes(base: int, rows: int) -> float:
        return (torch.cuda.max_memory_allocated(device) - base) / rows

    gaussians = scene["gaussian_means"].shape[1]
    for precision in ("exact", "fast"):
        with torch.no_grad():
            sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            one, one_s, one_launches, one_reads, one_syncs = call(precision, False, scene, False)
            out[f"{precision}_pass_bytes_a_row"] = row_bytes(base, scene["extrinsics"].shape[1] * gaussians)
            per, per_s, per_launches, per_reads, per_syncs = call(precision, True, scene, False)
        n_views = scene["extrinsics"].shape[1]
        same = {k: torch.equal(getattr(one, k), getattr(per, k)) for k in (*names, "num_pairs")}
        print(f"pass phase, {precision}: {n_views} views in one pass {one_s:.4f} s (launches "
              f"{one_launches['duplicate_with_keys']}, host reads {one_reads}, synchronizing calls {one_syncs}), one "
              f"item a pass {per_s:.4f} s (launches {per_launches['duplicate_with_keys']}, host reads {per_reads}, "
              f"synchronizing calls {per_syncs}); the same bits {same}; pairs per view "
              f"{one.num_pairs.reshape(-1).tolist()[:8]}...; one pass's peak "
              f"{out[f'{precision}_pass_bytes_a_row']:.1f} B a (item, Gaussian) row")
        if not all(same.values()):
            raise AssertionError(f"pass phase, {precision}: one pass and one item a pass differ: {same}")
        if (one_launches["duplicate_with_keys"], one_launches["composite_forward"], one_reads["duplicate_with_keys"],
                one_syncs) != (1, 1, 1, 1):
            raise AssertionError(f"pass phase, {precision}: one pass launched {one_launches} with host reads "
                                 f"{one_reads} and {one_syncs} synchronizing calls, not one each")
        if (per_launches["composite_forward"], per_reads["duplicate_with_keys"], per_syncs) != (n_views,) * 3:
            raise AssertionError(f"pass phase, {precision}: one item a pass launched {per_launches} with host "
                                 f"reads {per_reads} and {per_syncs} synchronizing calls, not {n_views} each")
        out[f"{precision}_one_pass_s"], out[f"{precision}_one_item_a_pass_s"] = one_s, per_s
        del one, per

    # The train render: 2 scenes x 4 views with gradient.
    train = {}
    for k, v in scene.items():
        if k in ("extrinsics", "intrinsics", "near", "far"):
            train[k] = torch.cat([v[:, :4], v[:, 4:8]])             # 2 scenes of 4 views
        else:
            train[k] = torch.cat([v, v * 0.9 if k == "gaussian_opacities" else v])
    del scene
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    for precision in ("exact", "fast"):
        grads = []
        for one_item in (False, True):
            inputs = {k: v.clone().requires_grad_(v.dtype.is_floating_point and k not in ("near", "far"))
                      for k, v in train.items()}
            sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            result, seconds, launches, reads, _ = call(precision, one_item, inputs, True)
            weights = [torch.randn(getattr(result, k).shape, generator=gen.manual_seed(seed + i), device=device)
                       for i, k in enumerate(names)]
            loss = sum((getattr(result, k) * w).sum() for k, w in zip(names, weights))
            leaves = [k for k, v in inputs.items() if v.requires_grad]
            grads.append((result, dict(zip(leaves, torch.autograd.grad(loss, [inputs[k] for k in leaves])))))
            peak = ""
            if not one_item:
                out[f"train_{precision}_pass_bytes_a_row"] = row_bytes(base, train["near"].numel() * gaussians)
                peak = f", peak {out[f'train_{precision}_pass_bytes_a_row']:.1f} B a (item, Gaussian) row"
            print(f"pass phase, train render at {precision}, {'one item a pass' if one_item else 'one pass'}: "
                  f"{seconds:.4f} s forward, launches {launches['composite_forward']}, host reads {reads}{peak}")
        (one, g_one), (per, g_per) = grads
        same = {k: torch.equal(getattr(one, k), getattr(per, k)) for k in (*names, "num_pairs")}
        errs = {}
        for k, g in g_one.items():
            scale = g.abs().max().clamp(min=1e-30)
            slack = BACKWARD_RTOL * scale + (BF16_STEP * g_per[k].abs() if precision == "fast" else 0.0)
            errs[k] = ((g - g_per[k]).abs().max() / scale).item()
            if ((g - g_per[k]).abs() > slack).any():
                raise AssertionError(f"pass phase, train render at {precision}: the gradient of {k} differs by "
                                     f"{errs[k]:.3e} of its largest value")
        print(f"pass phase, train render at {precision}: forward the same bits {same}; gradients, largest difference "
              f"relative to each input's largest value: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        if not all(same.values()):
            raise AssertionError(f"pass phase, train render at {precision}: the forwards differ: {same}")
        del grads, one, per, g_one, g_per
    return out


# -- the bench phase -------------------------------------------------------------

BENCH_TRAIN_RUNS = {"default": [], "full_b2": ["--full", "--batch", "2"],
                    "full_b2_bf16": ["--full", "--batch", "2", "--bf16"], "fast": ["--fast"]}
CARD_BYTES = 80e9


def bench_phase(seed: int, device) -> dict:
    """The port's bench scripts at their full shapes, as a user runs them
    (`main`), each JSON line printed on its own: bench_train four times
    (128x128 batch 1; --full --batch 2; --full --batch 2 --bf16; --fast at
    128x128 batch 1), each with finite positive steps/s and FLOPs and its
    kernels launched exactly as often as its steps need, in the variant its
    precision takes (a step renders its batch x 4 target views in one pass:
    one launch a step of the backward kernels and, under
    model.decoder.remat, two of the forward ones, which render the pass
    again in the backward), --full --batch 2's peak below the card's 80 GB;
    bench_render (64 views of 393,216 Gaussians at 256x256, fast then
    exact, one pass a call) with duplicate_with_keys and
    composite_forward<8> launched exactly 6 times at each precision (coef,
    then exact) in its warm-up and 5 timed calls, and one host read a call
    (its operation count and PSNR, which launch more, run after), no pair
    dropped, finite value_fast, value_exact
    and fast_vs_exact_psnr_db; bench_precision_knobs --views 8 with every
    mode finite; the three stage benches with finite positive stage
    times; bench_trace_step's top kernels, with device self time within
    the step's wall time; and entry.dryrun_multichip(2), its two ranks
    sharing the card. Records go to a temp dir. Returns each run's
    launches."""
    from latentsplat_tpu_torch.entry import dryrun_multichip
    from latentsplat_tpu_torch.ops.rasterize import kernels
    from latentsplat_tpu_torch.scripts.bench_enc_stages import main as enc_stages
    from latentsplat_tpu_torch.scripts.bench_precision_knobs import MODES as PRECISION_KNOB_MODES
    from latentsplat_tpu_torch.scripts.bench_precision_knobs import main as precision_knobs_bench
    from latentsplat_tpu_torch.scripts.bench_render import PRECISIONS as RENDER_PRECISIONS
    from latentsplat_tpu_torch.scripts.bench_render import make_scene, summarize, time_render
    from latentsplat_tpu_torch.scripts.bench_render_stages import main as render_stages
    from latentsplat_tpu_torch.scripts.bench_trace_step import main as trace_step
    from latentsplat_tpu_torch.scripts.bench_train import main as train_bench
    from latentsplat_tpu_torch.scripts.bench_train_stages import main as train_stages

    start = time.perf_counter()
    launches = {}
    # PyTorch's TF32 defaults, as the scripts run from the command line.
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as records:
        for label, argv in BENCH_TRAIN_RUNS.items():
            reset_launches()
            result = train_bench([*argv, "--out-dir", records], device=device)
            sync(device)
            launches[label] = read_launches()
            per_step = result["steps_run"] * passes(result["batch"] * 4, 2 * result["size"] ** 2 * 3)
            expected = {"duplicate_with_keys": per_step * (2 if result["decoder_remat"] else 1),
                        "composite_backward": per_step, "reduce_pairs": per_step}
            expected["composite_forward"] = expected["duplicate_with_keys"]
            got = {k: launches[label][k] for k in expected}
            print(f"bench phase: bench_train {' '.join(argv) or '(default)'}: {result['value']!r} steps/s, peak "
                  f"{result['peak_gib']!r} GiB, {result['train_flops_per_step']!r} FLOPs a step, train_mfu "
                  f"{result['train_mfu']!r}; launches {got} over {result['steps_run']} steps")
            variant = "fast" if "--fast" in argv else "exact"
            by_variant = {"composite_forward": {variant: {8: expected["composite_forward"]}},
                          "composite_backward": {variant: {8: expected["composite_backward"]}}}
            if got != expected or launches[label]["by_variant"] != by_variant:
                raise AssertionError(f"bench_train {argv}: launches {launches[label]}, not {expected} ({by_variant})")
            if not (math.isfinite(result["value"]) and result["value"] > 0 and result["train_flops_per_step"] > 0):
                raise AssertionError(f"bench_train {argv}: {result}")
            if label == "full_b2" and not result["peak_gib"] * 2**30 < CARD_BYTES:
                raise AssertionError(f"bench_train --full --batch 2: peak {result['peak_gib']} GiB, over 80 GB")

        scene = make_scene(seed, device=device)
        reset_launches()
        reads = dict(kernels.host_reads)
        timings = {p: time_render(scene, 256, precision=p) for p in RENDER_PRECISIONS}
        sync(device)
        launches["render"] = read_launches()
        reads = {k: kernels.host_reads[k] - v for k, v in reads.items()}
        n_calls, n_views = 1 + len(timings["fast"]["seconds"]), scene["extrinsics"].shape[1]
        n = n_calls * passes(n_views, scene["gaussian_means"].shape[1])
        if reads != {"duplicate_with_keys": 2 * n, "covering_cap": 0}:
            raise AssertionError(f"bench_render: host reads {reads}, not one a pass ({2 * n})")
        expected = {"duplicate_with_keys": 2 * n, "composite_forward": 2 * n, "composite_backward": 0,
                    "reduce_pairs": 0}
        by_variant = {"composite_forward": {"coef": {8: n}, "exact": {8: n}}, "composite_backward": {}}
        if {k: launches["render"][k] for k in expected} != expected or launches["render"]["by_variant"] != by_variant:
            raise AssertionError(f"bench_render: launches {launches['render']}, not {expected} ({by_variant})")
        render = summarize(scene, 256, timings, device, Path(records))   # raises on a dropped pair
        print(f"device: {render['device']}")
        print(json.dumps(render))
        print(f"bench phase: bench_render value_fast {render['value_fast']!r} views/s ({render['ms_per_view']!r} ms "
              f"a view), value_exact {render['value_exact']!r} views/s ({render['ms_per_view_exact']!r} ms), "
              f"fast_vs_exact_psnr_db {render['fast_vs_exact_psnr_db']!r}, {render['pairs_per_view_mean']!r} pairs a "
              f"fast view ({render['pairs_per_view_mean_exact']!r} exact), render_mfu {render['render_mfu']!r}; "
              f"launches {by_variant} and host reads {reads} in {n_calls} calls of {n_views} views at each precision")
        if not all(math.isfinite(render[k]) and render[k] > 0
                   for k in ("value", "value_exact", "render_flops_per_view", "fast_vs_exact_psnr_db")):
            raise AssertionError(f"bench_render: {render}")
        del scene
        knobs = precision_knobs_bench(["--views", "8", "--out-dir", records], device=device)
        bad = {m: k for m, k in knobs["knobs"].items() if not all(math.isfinite(v) for v in k.values())}
        print(f"bench phase: bench_precision_knobs --views 8: fast {knobs['value']!r} dB against exact; " + "; ".join(
            f"{m} color {k['color_psnr_db']:.3f} dB, feature {k['feature_psnr_db']:.3f} dB, depth rel err median "
            f"{k['depth_rel_err']:.3e} max {k['depth_rel_err_max']:.3e}" for m, k in knobs["knobs"].items()))
        if bad or set(knobs["knobs"]) != set(PRECISION_KNOB_MODES):
            raise AssertionError(f"bench_precision_knobs: non-finite or missing modes {bad}")

        stages = {"render": render_stages([], device=device), "encoder": enc_stages([], device=device),
                  "train": train_stages(["--out-dir", records], device=device)}
        bad = {k: v for k, v in stages.items() if not all(math.isfinite(ms) and ms > 0 for ms in v.values())}
        if bad:
            raise AssertionError(f"bench phase: stage times not finite and positive {bad}")
        traced = trace_step([], device=device)
        if not 0 < traced["self_ms"] <= traced["wall_ms"]:
            raise AssertionError(f"bench_trace_step: device self time {traced['self_ms']} ms, wall {traced['wall_ms']} ms")
    torch.backends.cudnn.allow_tf32 = False
    dry = dryrun_multichip(2)
    print(f"bench phase on {card()}: {time.perf_counter() - start:.1f} s in all; stages {json.dumps(stages)}; "
          f"trace: wall {traced['wall_ms']:.1f} ms, device self {traced['self_ms']:.1f} ms; dryrun_multichip(2) "
          f"generator/total {dry['generator/total']!r}")
    return launches


# -- the convergence phase -------------------------------------------------------

CONVERGENCE_STEPS = 150
CONVERGENCE_GAIN_DB = 8.0


def convergence_phase(seed: int, device) -> dict:
    """The port's convergence run (scripts.convergence) for CONVERGENCE_STEPS
    steps at 128x128 with sh_l2 at 0.01: every logged loss finite, the
    render PSNR of the last 10 steps at least CONVERGENCE_GAIN_DB above the
    first 10, and each kernel launched once a step (1 scene x 4 target
    views in one pass, no remat at 128x128). The run takes PyTorch's TF32 default for cuDNN
    (on), as `main` does; the other phases turn it off. Prints the PSNR
    curve at every 10th step; returns the launches over the run."""
    from latentsplat_tpu_torch.scripts import convergence

    size, steps = 128, CONVERGENCE_STEPS
    start = time.perf_counter()
    reset_launches()
    torch.backends.cudnn.allow_tf32 = True
    try:
        record = convergence.run(size, steps, seed, 0.01, device)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    launches = read_launches()
    curves = record["curves"]
    render, combined = curves["train/target_render/psnr"], curves["train/target_combined/psnr"]
    print(f"convergence phase on {card()}: {steps} steps at {size}x{size}, seed {seed}, sh_l2 0.01, "
          f"TF32 {record['tf32']}, {time.perf_counter() - start:.1f} s in all, median step "
          f"{record['seconds_per_step_median']:.4f} s, first {record['first_step_seconds']:.2f} s; launches {launches}")
    print("convergence phase PSNR (step: render, combined): "
          + ", ".join(f"{i}: {render[i]:.3f}, {combined[i]:.3f}" for i in range(0, steps, 10)))
    print(f"convergence phase: max|SH| largest {record['max_abs_color_sh_largest']:.5g}, final "
          f"{record['max_abs_color_sh_final']:.5g}; adaptive weight last "
          f"{curves['target_combined/adaptive_weight'][-1]:.5g}")
    bad = sorted(k for k, values in curves.items() if any(v is None or not math.isfinite(v) for v in values))
    if bad:
        raise AssertionError(f"convergence phase: non-finite logs {bad}")
    gain = statistics.fmean(render[-10:]) - statistics.fmean(render[:10])
    print(f"convergence phase: render PSNR of steps {steps - 10}-{steps - 1} is {gain:.3f} dB above steps 0-9 "
          f"(gate {CONVERGENCE_GAIN_DB} dB)")
    if not gain >= CONVERGENCE_GAIN_DB:
        raise AssertionError(f"convergence phase: render PSNR gained {gain:.3f} dB, under {CONVERGENCE_GAIN_DB}")
    n = steps * passes(4, 2 * size * size * 3)
    wrong = {k: launches[k] for k in ALL_KERNELS if launches[k] != n}
    if wrong:
        raise AssertionError(f"convergence phase: launches {wrong}, not {n} each")
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", metavar="DIR", help="also profile one render_full and one train step into DIR")
    parser.add_argument("--parent", metavar="DIR",
                        help="also measure the checkout DIR's render and train step beside this tree's, in turns")
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

    if args.parent:
        parent_turns(args.parent)
    cfg = load_config("re10k")
    model = build_model(cfg, args.seed, device)
    batch = make_batch(np.random.default_rng(args.seed), 2, 4, 256, device)
    view, results = kernel_phase(model, batch, args.seed)
    results += backward_kernel_phase(view, args.seed)
    del view
    serve_launches = slice_phase(model, batch, args.seed, args.profile)
    fast_records, fast_serve_launches = fast_serve_phase(model, batch, args.seed)
    depth_record, depth_launches = depth_phase(model, batch, args.seed)
    del model
    torch.cuda.empty_cache()
    pass_phase(args.seed, device)
    torch.cuda.empty_cache()
    train_launches, fast_train_launches = train_phase(cfg, args.seed, device, args.profile)
    trainer_output = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_output_"))
    fit_launches, test_launches = trainer_phase(args.seed, device, trainer_output)
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
    # The fast family's rows: coef from serving at precision fast, the
    # training variants from the train phase's fast steps.
    for record in fast_records:
        record["launches"] = launches_at(
            fast_serve_launches if record.get("variant") == "coef" else fast_train_launches, record)
    results += fast_records
    results += switches_phase(args.seed, device)
    parallel = parallel_phase(args.seed, device, trainer_output)
    shutil.rmtree(trainer_output)
    # The parallel phase's launches: rank 0's in one data-parallel step (1
    # scene of 4 target views).
    for entry in results:
        entry["parallel_launches_per_rank_step"] = launches_at(parallel["launches_per_rank_step"], entry)
    small_input_check(args.seed, device)
    small_depth_backward_check(args.seed, device)
    small_gradient_check(args.seed, device)
    torch.cuda.empty_cache()
    bench_launches = bench_phase(args.seed, device)
    torch.cuda.empty_cache()
    convergence_launches = convergence_phase(args.seed, device)
    for entry in results:
        entry["bench_launches"] = {run: launches_at(launches, entry) for run, launches in bench_launches.items()}
        entry["convergence_launches"] = launches_at(convergence_launches, entry)

    print(f"data phase summary on {card()}: " + json.dumps({k: v for k, v in data.items() if k != "launches"}))
    print(f"inspection phase summary on {card()}: "
          + json.dumps({k: v for k, v in inspection.items() if k != "launches"}))
    print(f"parallel phase summary on {card()}: "
          + json.dumps({k: v for k, v in parallel.items() if k != "launches_per_rank_step"}))
    print(card())
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
