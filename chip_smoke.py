"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

1. Builds the CUDA kernels from latentsplat_tpu_torch/csrc (sm_90a).
2. Kernel phase: on the Gaussians of the flagship model's first target
   view, holds each kernel against its plain PyTorch version (ids, keys and
   tile ranges exactly; channels and transmittance within 1e-5) and times
   both with CUDA events.
3. Slice phase: serves one batch (1 scene, 2 context and 4 target views at
   256x256, probabilistic) through `render_full` on the flagship re10k
   model at full width with seeded random weights, checks the output and
   that both kernels ran on that path.
4. Small-input check: the tiled (kernel) render of a narrow model against
   the dense oracle render of the same model.

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
SMALL_OVERRIDES = [
    "model.encoder.backbone.model=dino_vits8",
    "model.encoder.d_feature=32",
    "model.encoder.epipolar_transformer.num_layers=1",
    "model.encoder.epipolar_transformer.self_attention.num_layers=1",
    "model.autoencoder.block_out_channels=[16,16,16,16]",
]


def make_batch(rng: np.random.Generator, n_context: int, n_target: int, size: int, device) -> dict:
    """Cameras on a short horizontal track looking down +z, turned slightly
    inwards, with random images; target views lie between the context views."""

    def views(n, positions):
        ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for i, x in enumerate(positions):
            c, s = math.cos(-0.2 * x), math.sin(-0.2 * x)
            ext[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            ext[i, :3, 3] = [x, 0.0, 0.0]
        intr = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (n, 1, 1))
        image = rng.uniform(0.0, 1.0, (1, n, size, size, 3)).astype(np.float32)
        arrays = {"image": image, "extrinsics": ext[None], "intrinsics": intr[None],
                  "near": np.ones((1, n), np.float32), "far": np.full((1, n), 100.0, np.float32)}
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    return {
        "context": views(n_context, np.linspace(-0.2, 0.2, n_context)),
        "target": views(n_target, np.linspace(-0.15, 0.15, n_target)),
    }


def build_model(cfg, seed: int, device):
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


def kernel_phase(model, batch, seed: int) -> list[dict]:
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
    sorted_gids, ranges = sort_pairs(gids, keys, tiles_x * tiles_y)
    ref_sorted, ref_ranges = sort_pairs(ref_gids, ref_keys, tiles_x * tiles_y)
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
    return [
        {"name": "duplicate_with_keys", "route": "cuda",
         "source": "latentsplat_tpu_torch/csrc/duplicate_with_keys.cu",
         "replaces": "latentsplat_tpu/ops/rasterize/expand.py:159",
         "max_abs_err": float(dup_err), "ms": dup_ms, "plain_ms": dup_plain_ms},
        {"name": "composite_forward", "route": "cuda",
         "source": "latentsplat_tpu_torch/csrc/composite_forward.cu",
         "replaces": "latentsplat_tpu/ops/rasterize/pallas_kernels.py:399",
         "max_abs_err": max(err_ch, err_t), "ms": comp_ms, "plain_ms": comp_plain_ms},
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
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    pairs = out["num_pairs"].reshape(-1).tolist()
    print(f"slice: image {tuple(image.shape)}, mean {image.mean().item():.4f}, "
          f"render mean {out['render'].mean().item():.4f}, pairs per view {pairs}")
    print("slice stage seconds (host clock around synchronized stages): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stage_s.items())
          + f"; per target view: render {stage_s['decoder'] / n_target:.4f}, "
          f"VAE decode {stage_s['autoencoder_decoder'] / n_target:.4f}")
    print(f"slice launches: {launches}")
    if profile_dir:
        profile_render(model, batch, gen.manual_seed(seed), profile_dir)
    return launches


def profile_render(model, batch, gen, out_dir: str) -> None:
    """One more render_full under torch.profiler, its stages marked with
    record_function: a table of operators by device time and a Chrome trace,
    written to `out_dir`."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile, record_function

    from latentsplat_tpu_torch.model.latentsplat import render_full

    Path(out_dir).mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        render_full(model, batch, generator=gen, timer=record_function)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    averages = prof.key_averages()
    Path(out_dir, "render_full_ops.txt").write_text(averages.table(sort_by="cuda_time_total", row_limit=40))
    prof.export_chrome_trace(str(Path(out_dir, "render_full_trace.json")))
    # Kernel time only: operators' self device time repeats their kernels'.
    device_ms = sum(
        e.self_device_time_total for e in averages
        if e.device_type.name == "CUDA" and not e.is_user_annotation
    ) / 1e3
    print(f"profile: {device_ms:.3f} ms of kernel time in {wall_ms:.3f} ms of render_full under the "
          f"profiler; table and trace in {out_dir}")


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
    results = kernel_phase(model, batch, args.seed)
    launches = slice_phase(model, batch, args.seed, args.profile)
    for entry in results:
        entry["launches"] = launches[entry["name"]]
    del model
    small_input_check(args.seed, device)

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
