"""Convergence run of the port's VAE-GAN train step (the counterpart of the
root bench_convergence.py --precision exact; the trailing override
model.decoder.precision=fast runs its default):

    python -m latentsplat_tpu_torch.scripts.convergence --size 128 --steps 600 --seed 0 \\
        --sh-l2 0.01 --out outputs/convergence/seed0.json [key=value ...]

Overfits the flagship re10k model, its weights drawn from --seed by the
trainer's own init (`Trainer.init_state`), on one synthetic scene: 2
context views at the ends of an arc and 4 target views between them at
--size x --size (`overfit_batch`, bench_convergence.py's batch). The whole
objective is live from step 0: mse + lpips on the render, l1 + lpips on the
decoded image, the generator loss at 0.5 with the adaptive weight, the
hinge discriminator, kl at 1e-4 and, with --sh-l2 W, the color-SH L2 pin
at W; the generator's warm-up is cut to 50 steps from a factor of 0.1, and
remat is on only from 256x256. Trailing key=value arguments override the
config further (tests pass a narrow model). As in bench_convergence.py
the batch goes to the step without the data shims.

Every step's logs go into the JSON file --out: the curves (generator and
discriminator totals, both PSNRs, the loss terms, the `diag/*` maxima, the
adaptive weight, the gradient norms), the initial and final render and
combined PSNR (the mean of the first and last min(10, steps // 5) steps),
the steps whose generator total is not finite, the largest and the final
max |color SH|, and the seconds a step beside the device's name and power
limit and the TF32 switches it ran under (PyTorch's defaults, as `main`
runs, unless the caller set them). The command line runs on the card;
`main(argv, device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..dataset.synthetic import DatasetSynthetic, render_blob_scene
from ..dataset.types import DatasetSyntheticCfg
from ..training.step import make_train_step
from ..training.trainer import Trainer
from . import resolve_device

V_TARGET = 4


def overfit_batch(size: int) -> dict:
    """bench_convergence.py's batch: scene 3 of the synthetic dataset, 2
    context views at the arc's ends and V_TARGET targets between them, as
    numpy (1, v, ...)."""
    n_frames = V_TARGET + 2
    cfg = DatasetSyntheticCfg(image_shape=[size, size], background_color=[0.0, 0.0, 0.0], num_scenes=8,
                              num_frames=n_frames, seed=0)
    ds = DatasetSynthetic(cfg, "test", view_sampler=None)
    means, colors, radii, extrinsics, intrinsics = ds._scene(3)

    def views(indices):
        images = np.stack([
            render_blob_scene(means, colors, radii, extrinsics[i], intrinsics[i], (size, size)) for i in indices
        ])
        k = len(indices)
        return {
            "extrinsics": extrinsics[indices][None],
            "intrinsics": intrinsics[indices][None],
            "image": images[None].astype(np.float32),
            "near": np.full((1, k), ds.near, np.float32),
            "far": np.full((1, k), ds.far, np.float32),
            "index": np.asarray(indices, np.int32)[None],
        }

    return {"context": views(np.asarray([0, n_frames - 1])), "target": views(np.arange(1, 1 + V_TARGET))}


def objective_overrides(size: int, seed: int, sh_l2: float) -> list:
    """bench_convergence.py's run_mode overrides at exact precision."""
    remat = "true" if size >= 256 else "false"
    gaussian = "[{name: kl, weight: 0.0001}" + (f", {{name: sh_l2, weight: {sh_l2}}}]" if sh_l2 else "]")
    return [
        f"seed={seed}",
        f"dataset.image_shape=[{size},{size}]",
        "data_loader.train.batch_size=1",
        f"model.remat={remat}",
        f"model.decoder.remat={remat}",
        "loss.target_render_image.nll=[{name: mse, weight: 10}, {name: lpips, weight: 0.5}]",
        "loss.target_combined.nll=[{name: l1}, {name: lpips}]",
        "loss.target_combined.generator={name: generator, weight: 0.5}",
        "loss.target_combined.discriminator={name: discriminator, loss: hinge}",
        f"loss.gaussian.nll={gaussian}",
        "optimizer.generator.warm_up_steps=50",
        "optimizer.generator.warm_up_start_factor=0.1",
    ]


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device's type off the card."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[device.index or 0]


def smoothed(values: list, first: bool) -> float:
    """bench_convergence.py's smoothing: the mean of the first (or last)
    min(10, n // 5) finite values, at least one."""
    values = [v for v in values if math.isfinite(v)]
    if not values:
        return float("nan")
    n = max(1, min(10, len(values) // 5))
    return statistics.fmean(values[:n] if first else values[-n:])


def run(size: int, steps: int, seed: int, sh_l2: float, device, overrides: tuple = (), log=None) -> dict:
    """`steps` train steps on the overfit batch; returns the record that
    `main` writes (see the module docstring). `log(step, logs)`, if given,
    is called after every step with its logs as floats."""
    device = torch.device(device)
    cfg = load_config("re10k", [*objective_overrides(size, seed, sh_l2), *overrides])
    with tempfile.TemporaryDirectory(prefix="convergence_") as tmp:
        trainer = Trainer(cfg, tmp, device)
        state = trainer.init_state()
        trainer.logger.close()
    gan = trainer.losses["target_combined"]
    if not (gan.is_generator_active(0) and gan.is_discriminator_active(0)):
        raise ValueError("the GAN pair of target_combined must be live from step 0")
    g = cfg.optimizer.generator
    train_step = make_train_step(trainer.losses, g.skip_loss_spike_factor, g.skip_loss_spike_patience)
    batch = {side: {k: torch.from_numpy(v).to(device) for k, v in views.items() if k != "index"}
             for side, views in overfit_batch(size).items()}
    generator = torch.Generator(device=device).manual_seed(7 + 1000 * seed)

    curves: dict = {"step": []}
    seconds = []
    for i in range(steps):
        start = time.perf_counter()
        state, logs = train_step(state, batch, i, generator=generator)
        logs = {k: float(v) for k, v in logs.items()}   # the host read ends the step
        seconds.append(time.perf_counter() - start)
        curves["step"].append(i)
        for key, value in logs.items():
            curves.setdefault(key, [None] * i).append(value)
        if log is not None:
            log(i, logs)

    sh = [v for v in curves.get("diag/max_abs_color_sh", []) if v is not None]
    later = seconds[1:] or seconds
    return {
        "metric": f"convergence_{size}px",
        "device": device_name(device),
        "seed": seed,
        "size": size,
        "steps": steps,
        "sh_l2_weight": sh_l2,
        "overrides": list(overrides),
        "objective": "mse + lpips render, l1 + lpips combined, adaptive-weighted generator 0.5, hinge "
                     "discriminator, kl 1e-4" + (f", sh_l2 {sh_l2}" if sh_l2 else ""),
        "initial_render_psnr": smoothed(curves["train/target_render/psnr"], True),
        "final_render_psnr": smoothed(curves["train/target_render/psnr"], False),
        "initial_combined_psnr": smoothed(curves["train/target_combined/psnr"], True),
        "final_combined_psnr": smoothed(curves["train/target_combined/psnr"], False),
        "nan_steps": [s for s, v in zip(curves["step"], curves["generator/total"]) if not math.isfinite(v)],
        "max_abs_color_sh_largest": max(sh) if sh else None,
        "max_abs_color_sh_final": sh[-1] if sh else None,
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32, "matmul": torch.backends.cuda.matmul.allow_tf32},
        "seconds_per_step_median": statistics.median(later),
        "seconds_per_step_mean": statistics.fmean(later),
        "first_step_seconds": seconds[0],
        "curves": curves,
    }


def main(argv=None, device=None) -> Path:
    """Returns the path of the JSON file."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sh-l2", type=float, default=0.0, help="the color-SH L2 weight; 0 leaves it out")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("overrides", nargs="*", help="config overrides key=value")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(device, "convergence")

    def log(i, logs):
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i}: generator {logs['generator/total']:.4f} discriminator "
                  f"{logs.get('discriminator/total', float('nan')):.4f} render_psnr "
                  f"{logs['train/target_render/psnr']:.2f} combined_psnr {logs['train/target_combined/psnr']:.2f} "
                  f"max|SH| {logs.get('diag/max_abs_color_sh', float('nan')):.4g}", file=sys.stderr)

    record = run(args.size, args.steps, args.seed, args.sh_l2, device, tuple(args.overrides), log)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record))
    print(f"seed {args.seed}, sh_l2 {args.sh_l2}: render PSNR {record['initial_render_psnr']:.3f} -> "
          f"{record['final_render_psnr']:.3f} dB, combined {record['initial_combined_psnr']:.3f} -> "
          f"{record['final_combined_psnr']:.3f} dB, NaN steps {len(record['nan_steps'])}, max|SH| largest "
          f"{record['max_abs_color_sh_largest']} final {record['max_abs_color_sh_final']}, "
          f"{record['seconds_per_step_median']:.4f} s a step ({record['device']}); wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
