"""What the bench scripts and chip_smoke.py share (bench_render,
bench_train, bench_vae, the stage benches, bench_trace_step): the card's
published peaks, its name and power limit, synchronized median timing,
CUDA-event timing (`cuda_ms`), a kernel's device time with L2 cold or warm
(`device_ms`) and its least time on the card (`bound`), the directory of
their records, a
view's screen Gaussians as the render makes them, and the train shape's
setup (the flagship, its train state, step and batch)."""

from __future__ import annotations

import statistics
import time
from pathlib import Path

import torch

from ..entry import arc_batch, flagship_model, to_tensors
from ..loss.losses import LossGroup
from ..ops.rasterize.shade import view_channels
from ..ops.rasterize.camera import project_gaussians_to_screen
from ..ops.rasterize.tiled import precision_knobs
from ..training.step import GROUP_NAMES, make_step_flags, make_train_step
from ..training.trainer import init_train_state
from .convergence import device_name

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# Bytes written between two timed calls to leave nothing of them in the
# 50 MB L2.
FLUSH_BYTES = 128 << 20
# Where bench_train writes its records and bench_render reads the newest
# (gitignored).
RECORD_DIR = Path(__file__).resolve().parents[2] / "outputs" / "bench"
V_CONTEXT, V_TARGET = 2, 4
# The whole objective from step 0 (the reference's late-schedule losses are
# the expensive ones).
OBJECTIVE = [
    "loss.target_render_image.nll=[{name: mse, weight: 10}, {name: lpips, weight: 0.5}]",
    "loss.target_combined.nll=[{name: l1}, {name: lpips}]",
    "loss.target_combined.generator={name: generator, weight: 0.5}",
    "loss.target_combined.discriminator={name: discriminator, loss: hinge}",
]

__all__ = ["BF16_FLOPS", "FLUSH_BYTES", "FP32_FLOPS", "HBM_BYTES_PER_S", "OBJECTIVE", "RECORD_DIR", "bound",
           "cuda_ms", "device_ms", "device_name", "gaussian_sum", "grad_sum", "median_seconds", "screen_view", "sync",
           "timed_ms", "train_setup"]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_seconds(fn, iters: int, device: torch.device) -> tuple[float, list]:
    """(median, all) seconds of `iters` calls fn(i), i = 1..iters, each on
    the host clock from a synchronized device to a synchronized device."""
    times = []
    for i in range(1, iters + 1):
        sync(device)
        start = time.perf_counter()
        fn(i)
        sync(device)
        times.append(time.perf_counter() - start)
    return statistics.median(times), times


def cuda_ms(fn, repeats: int, warm_up: bool = True) -> list[float]:
    """Milliseconds of each of `repeats` calls of `fn` (after one warm-up
    call where `warm_up`), timed with CUDA events around each call: the
    host's time inside the call counts too."""
    if warm_up:
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def device_ms(fn, repeats: int = 20, flush: torch.Tensor | None = None) -> float:
    """Median device milliseconds of one `fn` call on the card. All calls
    are queued behind a sleeping kernel, so the host's time in them
    (checks, allocation, the ctypes call) overlaps the device's and is not
    counted; with `flush` (>= FLUSH_BYTES) written before each call, L2
    starts cold. `fn` must not wait for the device."""
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


def bound(n_bytes: int, n_ops: int = 0) -> tuple[float, str]:
    """Least milliseconds one H100 SXM could take to move `n_bytes` and
    compute `n_ops` float32 operations: the larger of the bytes over HBM's
    rate and the operations over the float32 rate, and which it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_ms(fn, iters: int, device: torch.device) -> float:
    """Median milliseconds of `iters` calls after one warm-up."""
    fn(0)
    sync(device)
    return 1e3 * median_seconds(fn, iters, device)[0]


def grad_sum(loss: torch.Tensor, inputs: list) -> float:
    """The sum of every gradient of `loss` over `inputs` (the host read ends
    the backward)."""
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return float(sum(g.sum() for g in grads if g is not None))


def screen_view(scene: dict, size: int, j: int, i: int = 0, precision: str = "exact"):
    """View j's screen Gaussians as `render` hands them to the compositor
    at `precision` (SH towards the camera, in bfloat16 under its bf16 SH
    knob; the scene scaled by 1/near), opacities scaled by 1 - 1e-6 i."""
    means, ext, near = scene["gaussian_means"][0], scene["extrinsics"][0, j], scene["near"][0, j]
    sh = (scene["gaussian_color_sh"][0], scene["gaussian_feature_sh"][0])
    if precision_knobs(precision).bf16_sh:
        sh = tuple(x.to(torch.bfloat16) for x in sh)
    channels = view_channels(means, *sh, ext[:3, 3])
    s = 1.0 / near
    ext_s = ext.clone()
    ext_s[:3, 3] = ext[:3, 3] * s
    return project_gaussians_to_screen(
        means * s, scene["gaussian_covariances"][0] * (s * s), scene["gaussian_opacities"][0] * (1.0 - 1e-6 * i),
        channels, ext_s, scene["intrinsics"][0, j], (size, size),
    )


def gaussian_sum(g) -> torch.Tensor:
    """The sum of every tensor of the encoder's variational Gaussians (the
    feature posterior by its mean)."""
    return (g.means.sum() + g.covariances.sum() + g.opacities.sum() + g.color_harmonics.sum()
            + g.feature_harmonics.mean.sum())


def train_setup(overrides: list, batch_size: int, size: int, device: torch.device) -> tuple:
    """(cfg, state, losses, train_step, batch): the flagship with `overrides`
    and weights from seed 0, its discriminator, LPIPS and optimizers
    (`init_train_state`), the step, and `arc_batch(batch_size, 2, 4, size,
    size)` on `device`, as the step takes it (no data shims)."""
    cfg, model = flagship_model(overrides, device)
    state = init_train_state(cfg, model.train(), device, batch_size, seed=0)
    losses = {name: LossGroup(name, getattr(cfg.loss, name)) for name in GROUP_NAMES}
    flags = make_step_flags(losses, 0)
    if not (flags.disc and flags.gen_gan):
        raise RuntimeError("the GAN path must be live from step 0")
    g = cfg.optimizer.generator
    train_step = make_train_step(losses, g.skip_loss_spike_factor, g.skip_loss_spike_patience)
    batch = to_tensors({side: {k: v for k, v in views.items() if k != "index"} for side, views in
                        arc_batch(batch_size, V_CONTEXT, V_TARGET, size, size).items()}, device)
    return cfg, state, losses, train_step, batch
