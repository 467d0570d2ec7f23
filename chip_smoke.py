"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N] [--profile DIR]

1. Builds the CUDA kernels from latentsplat_tpu_torch/csrc (sm_90a).
2. Kernel phase: on the Gaussians of the flagship model's first target
   view, holds each forward kernel against its plain PyTorch version (ids,
   keys and tile ranges exactly; channels and transmittance within 1e-5)
   and times both with CUDA events.
3. Backward kernel phase: on the same view, with a seeded random
   cotangent, holds composite_backward against its plain version (within
   1e-4 of each gradient column's largest value) and reduce_pairs against
   its plain version run on the CPU (exactly), and times both.
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
6. Small-input checks: the tiled (kernel) render of a narrow model against
   the dense oracle render, and the narrow model's train-step gradients
   through the tiled kernels against those through the dense oracle.

Prints the card's name and power limit, one JSON line describing the
kernels, and last `{"ok": true, "device": {...}}`. Any failed check raises.
Exits non-zero without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

KERNEL_ATOL = 1e-5
# composite_backward sums each pair's partials over the tile in warp order,
# the plain version in torch.sum's order: float32 rounding of ~256-term sums.
BACKWARD_RTOL = 1e-4
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


def build_model(cfg, seed: int, device, peaked_depth: bool = True):
    from latentsplat_tpu_torch.model.latentsplat import LatentSplat

    torch.manual_seed(seed)
    model = LatentSplat(cfg.model).to(device).eval()
    with torch.no_grad():
        # Zero-initialized leaves get random values too, so nothing rides on
        # a zero.
        for name, p in model.named_parameters():
            if name.endswith(("cls_token", "pos_embed")) or "skip_conv" in name:
                p.normal_(0.0, 0.02)
        # A trained depth head puts most of each pixel's mass in one
        # bucket; scale the random one so the scene is mostly opaque and the
        # compositor's early stop is exercised.
        if peaked_depth:
            model.encoder.depth_predictor.projection.weight.mul_(50.0)
    return model


def cuda_ms(fn, repeats: int) -> float:
    """Median milliseconds of `fn` over `repeats` runs, timed with CUDA events."""
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


def kernel_phase(model, batch, seed: int) -> tuple[dict, list[dict]]:
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
    print(f"kernel phase: {sg.num_gaussians} Gaussians, {int(counts.sum())} pairs, "
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
    dup_ms = cuda_ms(lambda: kernels.duplicate_with_keys(counts, mask, base, nx, depth, tiles_x, 9), 20)
    dup_plain_ms = cuda_ms(
        lambda: kernels.duplicate_with_keys_reference(counts, mask, base, nx, depth, tiles_x, 9), 5
    )
    print(f"duplicate_with_keys: exact match; {dup_ms:.4f} ms vs plain {dup_plain_ms:.4f} ms")

    # composite_forward
    attrs = pack_attributes(sg)
    out = kernels.composite_forward(sorted_gids, ranges, attrs, tiles_x, (h, w))
    ref = kernels.composite_forward_reference(sorted_gids, ranges, attrs, tiles_x, (h, w))
    torch.cuda.synchronize()
    err_ch = (out[0] - ref[0]).abs().max().item()
    err_t = (out[1] - ref[1]).abs().max().item()
    last_mismatch = int((out[2] != ref[2]).sum())
    saturated = (ref[1] < kernels.TRANSMITTANCE_MIN).float().mean().item()
    print(f"composite_forward: max |channels err| {err_ch:.3e}, max |T err| {err_t:.3e}, "
          f"last-contributor mismatches {last_mismatch}, saturated pixels {saturated:.3f}")
    if not (err_ch <= KERNEL_ATOL and err_t <= KERNEL_ATOL):
        raise AssertionError(f"composite_forward disagrees with its plain version beyond {KERNEL_ATOL}")
    comp_ms = cuda_ms(lambda: kernels.composite_forward(sorted_gids, ranges, attrs, tiles_x, (h, w)), 20)
    comp_plain_ms = cuda_ms(
        lambda: kernels.composite_forward_reference(sorted_gids, ranges, attrs, tiles_x, (h, w)), 3
    )
    print(f"composite_forward: {comp_ms:.4f} ms vs plain {comp_plain_ms:.4f} ms")
    view = {"gids": sorted_gids, "ranges": ranges, "order": order, "counts": counts, "attrs": attrs,
            "tiles_x": tiles_x, "shape": (h, w), "t_final": out[1], "last": out[2]}
    return view, [
        {"name": "duplicate_with_keys", "route": "cuda",
         "source": "latentsplat_tpu_torch/csrc/duplicate_with_keys.cu",
         "replaces": "latentsplat_tpu/ops/rasterize/expand.py:159",
         "max_abs_err": float(dup_err), "ms": dup_ms, "plain_ms": dup_plain_ms},
        {"name": "composite_forward", "route": "cuda",
         "source": "latentsplat_tpu_torch/csrc/composite_forward.cu",
         "replaces": "latentsplat_tpu/ops/rasterize/pallas_kernels.py:399",
         "max_abs_err": max(err_ch, err_t), "ms": comp_ms, "plain_ms": comp_plain_ms},
    ]


def backward_kernel_phase(view: dict, seed: int) -> list[dict]:
    """composite_backward and reduce_pairs at the shapes of one flagship
    view, against their plain versions, with a seeded random cotangent."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    gids, ranges, attrs, tiles_x, shape = (view[k] for k in ("gids", "ranges", "attrs", "tiles_x", "shape"))
    device = attrs.device
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    g_out = torch.randn((attrs.shape[1] - 6, *shape), generator=gen, device=device)
    g_t = torch.randn(shape, generator=gen, device=device)
    args = (gids, ranges, attrs, tiles_x, shape, view["last"], view["t_final"], g_out, g_t)
    d_pairs = kernels.composite_backward(*args)
    ref = kernels.composite_backward_reference(*args)
    torch.cuda.synchronize()
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    bwd_err = ((d_pairs - ref).abs() / scale).max().item()
    print(f"composite_backward: {gids.shape[0]} pair rows of {attrs.shape[1]}, max error relative to "
          f"each column's largest value {bwd_err:.3e} (tolerance {BACKWARD_RTOL})")
    if not bwd_err <= BACKWARD_RTOL:
        raise AssertionError("composite_backward disagrees with its plain version")
    if not torch.equal(d_pairs, kernels.composite_backward(*args)):
        raise AssertionError("composite_backward is not deterministic")
    bwd_ms = cuda_ms(lambda: kernels.composite_backward(*args), 20)
    bwd_plain_ms = cuda_ms(lambda: kernels.composite_backward_reference(*args), 3)
    print(f"composite_backward: {bwd_ms:.4f} ms vs plain {bwd_plain_ms:.4f} ms")

    order = view["order"]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=device)
    offsets = torch.cumsum(view["counts"], dim=0, dtype=torch.int64)
    rows = kernels.reduce_pairs(d_pairs, gids, inverse, offsets)
    # The plain version on the CPU adds in index order, which is each
    # Gaussian's tile order, as the kernel does: the same bits.
    ref_rows = kernels.reduce_pairs_reference(d_pairs.cpu(), gids.cpu(), offsets.shape[0])
    torch.cuda.synchronize()
    red_err = (rows.cpu() - ref_rows).abs().max().item()
    print(f"reduce_pairs: {rows.shape[0]} Gaussians, max abs error {red_err:.3e} (exact expected)")
    if not torch.equal(rows.cpu(), ref_rows):
        raise AssertionError("reduce_pairs disagrees with its plain version")
    red_ms = cuda_ms(lambda: kernels.reduce_pairs(d_pairs, gids, inverse, offsets), 20)
    red_plain_ms = cuda_ms(lambda: kernels.reduce_pairs_reference(d_pairs, gids, offsets.shape[0]), 5)
    print(f"reduce_pairs: {red_ms:.4f} ms vs plain (index_add_ on the card) {red_plain_ms:.4f} ms")
    return [
        {"name": "composite_backward", "route": "cuda",
         "source": "latentsplat_tpu_torch/csrc/composite_backward.cu",
         "replaces": "latentsplat_tpu/ops/rasterize/pallas_kernels.py:667",
         "max_abs_err": (d_pairs - ref).abs().max().item(), "ms": bwd_ms, "plain_ms": bwd_plain_ms},
        {"name": "reduce_pairs", "route": "cuda",
         "source": "latentsplat_tpu_torch/csrc/reduce_pairs.cu",
         "replaces": "latentsplat_tpu/ops/rasterize/expand.py:254",
         "max_abs_err": red_err, "ms": red_ms, "plain_ms": red_plain_ms},
    ]


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
    return lines


def profile_once(label: str, fn, out_dir: str) -> None:
    """Runs fn(timer=record_function) once more under torch.profiler and
    writes an operator table, the per-stage breakdown and (if small) a
    gzipped Chrome trace to `out_dir`; prints the breakdown."""
    import gzip
    from pathlib import Path

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


def build_trainer(cfg, seed: int, device, effective_batch_size: int, peaked_depth: bool = True):
    """Generator, PatchGAN discriminator, LPIPS (random, seeded) and their
    optimizers, with the preset's losses; returns (state, losses, train_step)."""
    from latentsplat_tpu_torch.loss.losses import LossGroup
    from latentsplat_tpu_torch.loss.lpips import LPIPS
    from latentsplat_tpu_torch.model.discriminator.patch_gan import DiscriminatorPatchGan
    from latentsplat_tpu_torch.training.optim import build_optimizers
    from latentsplat_tpu_torch.training.step import GROUP_NAMES, TrainState, make_train_step

    model = build_model(cfg, seed, device, peaked_depth).train()
    torch.manual_seed(seed + 1)
    disc = DiscriminatorPatchGan(cfg.model.discriminator).to(device)
    lpips = LPIPS().to(device).requires_grad_(False)
    opt_gen, opt_disc = build_optimizers(model, disc, cfg.optimizer, effective_batch_size, cfg.freeze)
    g = cfg.optimizer.generator
    state = TrainState(model, disc, lpips, opt_gen, opt_disc)
    if g.skip_loss_spike_factor is not None:
        state.gen_loss_ema = torch.zeros((), device=device)
        state.spike_skip_count = torch.zeros((), dtype=torch.int32, device=device)
    losses = {name: LossGroup(name, getattr(cfg.loss, name)) for name in GROUP_NAMES}
    return state, losses, make_train_step(losses, g.skip_loss_spike_factor, g.skip_loss_spike_patience)


def train_phase(cfg, seed: int, device, profile_dir: str | None = None, size: int = 256) -> dict:
    """3 flagship train steps on one batch; returns the kernels' launch
    counts over those steps."""
    from latentsplat_tpu_torch.ops.rasterize import kernels

    scenes = 2
    state, _, train_step = build_trainer(cfg, seed, device, effective_batch_size=scenes)
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
    state, losses, _ = build_trainer(cfg, seed, device, effective_batch_size=1, peaked_depth=False)
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
    parser.add_argument("--profile", metavar="DIR", help="also profile one render_full into DIR")
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
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    cfg = load_config("re10k")
    model = build_model(cfg, args.seed, device)
    batch = make_batch(np.random.default_rng(args.seed), 2, 4, 256, device)
    view, results = kernel_phase(model, batch, args.seed)
    results += backward_kernel_phase(view, args.seed)
    del view
    serve_launches = slice_phase(model, batch, args.seed, args.profile)
    del model
    train_launches = train_phase(cfg, args.seed, device, args.profile)
    # Each kernel's count comes from the path it serves: the forward kernels
    # from serving, the backward kernels from training.
    for entry in results:
        path = serve_launches if entry["name"] in FORWARD_KERNELS else train_launches
        entry["launches"] = path[entry["name"]]
    small_input_check(args.seed, device)
    small_gradient_check(args.seed, device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
