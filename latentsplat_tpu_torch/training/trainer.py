"""Training, validation and test (counterpart of
latentsplat_tpu/training/trainer.py).

  * `fit` - the fused generator + discriminator step (`training.step`) over
    the train loader, logs, validation and checkpoints;
  * `validate` - a probabilistic and a deterministic pass, PSNR and a
    labelled comparison grid;
  * `test` - every test scene rendered to PNGs, with benchmark.json (the
    stages' times under the tags encoder, decoder and autoencoder_decoder)
    and peak_memory.json.

Randomness comes from `torch.Generator`s seeded in the JAX trainer's roles:
`seed` for the weights, `seed + 1` for training, `seed + 2` for validation,
`seed + 3` for test. Batches arrive as numpy from the loader and move to
the device here, on the calling thread.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from ..dataset import get_dataset
from ..dataset.loader import make_loader
from ..dataset.view_samplers import get_view_sampler
from ..evaluation.metrics import compute_psnr
from ..loss.losses import LossGroup
from ..loss.lpips import LPIPS
from ..misc.benchmarker import Benchmarker
from ..misc.image_io import save_image
from ..model.discriminator.patch_gan import DiscriminatorPatchGan
from ..model.latentsplat import LatentSplat, render_full
from ..visualization.annotation import add_label
from ..visualization.layout import add_border, hcat, vcat
from .checkpointing import load_checkpoint, load_generator_weights, resolve_checkpoint_uri, save_checkpoint
from .logger import get_logger
from .optim import build_optimizers
from .step import GROUP_NAMES, TrainState, make_train_step
from .step_tracker import StepTracker


def _device_keys(views: dict) -> dict:
    return {k: views[k] for k in ("extrinsics", "intrinsics", "image", "near", "far") if k in views}


def strip_batch(batch: dict) -> dict:
    """Keep only the array fields the model consumes (drops "scene" and "index")."""
    return {"context": _device_keys(batch["context"]), "target": _device_keys(batch["target"])}


def to_device(batch: dict, device: torch.device) -> dict:
    """A stripped numpy batch -> the same dict of tensors on `device`."""
    return {
        key: {name: torch.as_tensor(np.ascontiguousarray(array), device=device) for name, array in views.items()}
        for key, views in batch.items()
    }


class Trainer:
    """`device` None means the card ("cuda"); tests pass "cpu"."""

    def __init__(self, cfg, output_dir: Optional[Path] = None, device=None):
        if cfg.trainer.num_devices is not None and cfg.trainer.num_devices > 1:
            raise NotImplementedError(
                "trainer.num_devices > 1 needs data-parallel training (DDP), not ported yet (ROADMAP queue 1 item 8)"
            )
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        self.output_dir = Path(output_dir or cfg.output_dir)
        # The generator's weights come from `seed` on the CPU, so every
        # device starts from the same ones.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.model = LatentSplat(cfg.model, tuple(cfg.dataset.background_color)).to(self.device)
        self.losses = {name: LossGroup(name, getattr(cfg.loss, name)) for name in GROUP_NAMES}
        self.step_tracker = StepTracker(cfg.train.step_offset)
        self.logger = get_logger(cfg.wandb, self.output_dir / "local")
        self.benchmarker = Benchmarker()
        self.checkpoint_dir = self.output_dir / "checkpoints"
        self.step = 0   # the port's TrainState has no step: the trainer keeps it

    # -- data -------------------------------------------------------------------
    def _dataset(self, stage: str):
        view_sampler = get_view_sampler(
            self.cfg.dataset.view_sampler, stage, self.cfg.dataset.overfit_to_scene is not None,
            self.cfg.dataset.cameras_are_circular, self.step_tracker,
        )
        return get_dataset(self.cfg.dataset, stage, view_sampler)

    def _loader(self, stage: str, batch_size: int, repeat: bool) -> Iterator:
        lcfg = getattr(self.cfg.data_loader, stage)
        # Worker processes pay off only for disk-backed datasets; the
        # in-memory synthetic one stays on the prefetch thread.
        num_workers = lcfg.num_workers if self.cfg.dataset.name != "synthetic" else 0
        seed = lcfg.seed if lcfg.seed is not None else self.cfg.seed
        return make_loader(
            self._dataset(stage), batch_size, repeat=repeat, drop_last=stage == "train",
            num_workers=num_workers, seed=seed, stage=stage,
        )

    def data_shim(self, batch: dict) -> dict:
        """Patch and bounds shims on a device batch (the model's own)."""
        return self.model.data_shim(batch)

    def _generator(self, params_gen) -> LatentSplat:
        """A TrainState, a LatentSplat, or a generator state_dict (loaded into
        the trainer's model) -> the LatentSplat to render with."""
        if isinstance(params_gen, TrainState):
            return params_gen.model
        if isinstance(params_gen, nn.Module):
            return params_gen
        self.model.load_state_dict(params_gen)
        return self.model

    # -- state ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """The trainer's generator with a seeded discriminator and LPIPS,
        their optimizers, and the spike guard's state; then the checkpoint
        of `checkpointing.load`, whole (`resume`) or the generator's weights
        only. Sets `self.step`."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            disc = DiscriminatorPatchGan(cfg.model.discriminator) if cfg.model.discriminator else None
            lpips = LPIPS().requires_grad_(False)
        disc = disc.to(self.device) if disc is not None else None
        lpips = lpips.to(self.device)
        self.opt_gen, self.opt_disc = build_optimizers(
            self.model, disc, cfg.optimizer, cfg.data_loader.train.batch_size, freeze=cfg.freeze
        )
        state = TrainState(self.model, disc, lpips, self.opt_gen, self.opt_disc)
        if cfg.optimizer.generator.skip_loss_spike_factor is not None:
            state.gen_loss_ema = torch.zeros((), device=self.device)
            state.spike_skip_count = torch.zeros((), dtype=torch.int32, device=self.device)

        self.step = 0
        ckpt = cfg.checkpointing
        if ckpt.load is not None:
            path = resolve_checkpoint_uri(ckpt.load)
            if ckpt.resume:
                self.step = int(load_checkpoint(path, state, self.device)["step"])
                print(f"resumed full state at step {self.step} from {ckpt.load}")
            else:
                load_generator_weights(path, self.model)
                print(f"loaded generator weights from {ckpt.load}")
        return state

    # -- training ---------------------------------------------------------------
    def fit(self, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        max_steps = max_steps if max_steps is not None else cfg.trainer.max_steps
        loader = self._loader("train", cfg.data_loader.train.batch_size, repeat=True)
        batch = strip_batch(next(loader))
        state = self.init_state()
        g = cfg.optimizer.generator
        train_step = make_train_step(self.losses, g.skip_loss_spike_factor, g.skip_loss_spike_patience)
        generator = torch.Generator(self.device).manual_seed(cfg.seed + 1)

        step = self.step
        log_every = cfg.trainer.log_every_n_steps
        t_last = time.perf_counter()
        while step < max_steps:
            self.step_tracker.set_step(step)
            state, logs = train_step(state, self.data_shim(to_device(batch, self.device)), step, generator=generator)
            # The next batch is taken while the device runs this step.
            batch = strip_batch(next(loader))
            step += 1
            self.step = step

            if step % log_every == 0 or step == 1:
                host_logs = {k: float(v) for k, v in logs.items()}
                dt = (time.perf_counter() - t_last) / (log_every if step > 1 else 1)
                t_last = time.perf_counter()
                host_logs["steps_per_sec"] = 1.0 / max(dt, 1e-9)
                self.logger.log_scalars(host_logs, step)
                gen_total = host_logs.get("generator/total", float("nan"))
                print(f"step {step}: generator/total={gen_total:.4f} ({host_logs['steps_per_sec']:.2f} it/s)")

            if cfg.trainer.val_check_interval and step % cfg.trainer.val_check_interval == 0:
                self.validate(state, step)

            if cfg.checkpointing.every_n_train_steps and step % cfg.checkpointing.every_n_train_steps == 0:
                save_checkpoint(state, self.checkpoint_dir, step)

        save_checkpoint(state, self.checkpoint_dir, step)
        return state

    # -- forward passes for evaluation ------------------------------------------
    def _render_full(self, params_gen, batch: dict, generator: torch.Generator, deterministic: bool) -> dict:
        """encoder -> splat -> VAE decode on a device batch (the data shims
        are applied once, inside `render_full`)."""
        return render_full(self._generator(params_gen), batch, deterministic=deterministic, generator=generator)

    def _render_full_timed(
        self, params_gen, batch: dict, generator: torch.Generator, deterministic: bool, benchmarker: Benchmarker,
    ) -> dict:
        """`_render_full` with its three stages timed under the tags
        encoder (per scene), decoder and autoencoder_decoder (per target
        view: `num_calls` = views), each waiting for the device at its ends."""
        v = batch["target"]["image"].shape[1]
        on_cuda = self.device.type == "cuda"

        @contextmanager
        def timer(name):
            if on_cuda:
                torch.cuda.synchronize(self.device)
            with benchmarker.time(name, num_calls=1 if name == "encoder" else v):
                yield
                if on_cuda:
                    torch.cuda.synchronize(self.device)

        return render_full(
            self._generator(params_gen), batch, deterministic=deterministic, generator=generator, timer=timer
        )

    # -- validation -------------------------------------------------------------
    def validate(self, state: TrainState, step: int, num_batches: int = 1) -> Dict[str, float]:
        """A probabilistic and a deterministic pass over the val loader."""
        return self.validate_params(state.model, step, num_batches)

    def validate_params(self, params_gen, step: int = 0, num_batches: int = 1) -> Dict[str, float]:
        cfg = self.cfg
        loader = self._loader("val", cfg.data_loader.val.batch_size, repeat=False)
        metrics: Dict[str, list] = {}
        for i, batch in enumerate(loader):
            if i >= num_batches:
                break
            batch = to_device(strip_batch(batch), self.device)
            outs = {}
            for name, det in (("probabilistic", False), ("deterministic", True)):
                generator = torch.Generator(self.device).manual_seed(cfg.seed + 2)
                outs[name] = self._render_full(params_gen, batch, generator, det)
            target = outs["probabilistic"]["target_shim"]
            rows = []
            for name, out in outs.items():
                metrics.setdefault(f"val/psnr_{name}", []).append(float(compute_psnr(target, out["image"]).mean()))
                rows.append(hcat(*out["image"][0].cpu().numpy()))
            grid = add_border(vcat(
                add_label(hcat(*target[0].cpu().numpy()), "Ground Truth"),
                add_label(rows[0], "Probabilistic"),
                add_label(rows[1], "Deterministic"),
            ))
            self.logger.log_image("comparison", grid, step)

        out = {k: float(np.mean(v)) for k, v in metrics.items()}
        if out:
            self.logger.log_scalars(out, step)
            print("  val:", {k: round(v, 3) for k, v in out.items()})
        if cfg.train.video_wobble or cfg.train.video_interpolation:
            self.render_video(params_gen, None, "wobble" if cfg.train.video_wobble else "interpolation", step)
        return out

    def render_video(self, params_gen, batch: dict, mode: str, step: int) -> None:
        raise NotImplementedError(
            "validation videos need visualization.camera_trajectory and color_map, not ported yet "
            "(ROADMAP queue 1 item 11); set train.video_wobble and train.video_interpolation to false"
        )

    # -- test -------------------------------------------------------------------
    def test(self, state_or_params, name: str = "latentsplat_tpu") -> None:
        """Render every test scene, write its target views as
        <test.output_path>/<name>/<scene>/<context indices>/color/NNNNNN.png,
        then benchmark.json and peak_memory.json beside them."""
        cfg = self.cfg
        model = self._generator(state_or_params)
        out_root = Path(cfg.test.output_path) / name
        for batch in self._loader("test", 1, repeat=False):
            scene = batch["scene"][0] if isinstance(batch["scene"], list) else batch["scene"]
            generator = torch.Generator(self.device).manual_seed(cfg.seed + 3)
            out = self._render_full_timed(
                model, to_device(strip_batch(batch), self.device), generator, False, self.benchmarker
            )
            images = out["image"][0].cpu().numpy()
            ctx_str = "_".join(str(int(i)) for i in np.sort(batch["context"]["index"][0]))
            for v, index in enumerate(batch["target"]["index"][0]):
                save_image(images[v], out_root / scene / ctx_str / "color" / f"{int(index):0>6}.png")
        self.benchmarker.dump(out_root / "benchmark.json")
        self.benchmarker.dump_memory(out_root / "peak_memory.json")
