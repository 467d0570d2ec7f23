"""Training, validation and test (counterpart of
latentsplat_tpu/training/trainer.py).

  * `fit` - the fused generator + discriminator step (`training.step`) over
    the train loader, logs, validation and checkpoints;
  * `validate` - a probabilistic and a deterministic pass, PSNR and a
    labelled comparison grid, and the wobble and interpolation videos
    (`render_video`) when `train.video_wobble` / `train.video_interpolation`
    are set;
  * `test` - every test scene rendered to PNGs, with benchmark.json (the
    stages' times under the tags encoder, decoder and autoencoder_decoder,
    and autoencoder_encoder under `encode_latents`) and peak_memory.json.

Randomness comes from `torch.Generator`s seeded in the JAX trainer's roles:
`seed` for the weights, `seed + 1` for training, `seed + 2` for validation,
`seed + 3` for test, `seed + 4` for the videos. Batches arrive as numpy
from the loader and move to the device here, on the calling thread.

Data parallelism (`mesh`, one rank of `parallel.mesh`): the global batch
is data_loader.train.batch_size x world_size examples in the one-process
order, and each rank reads and decodes only its own contiguous rows
(`RowShard`; a loader's workers are taken in turn, so every rank's batch
k holds its rows of the same global batch); across hosts each host's datasets also take its scene shard
(`shard_index`, `num_shards`), as in the JAX trainer. Every rank builds the
same seeded state, which is broadcast from rank 0 after the init and a
resume and checked equal. The step reduces over the global batch
(`make_parallel_train_step`). Each rank draws its training noise from
its own generator, seeded from `seed + 1` and its rank, so a run on N
ranks is not draw for draw a run on one. Rank 0 alone logs, validates and
writes checkpoints; the other ranks wait for it at a barrier.
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
from ..dataset.types import RowShard
from ..dataset.view_samplers import get_view_sampler
from ..evaluation.metrics import compute_psnr
from ..loss.losses import LossGroup
from ..loss.lpips import LPIPS
from ..misc.benchmarker import Benchmarker
from ..misc.image_io import save_image
from ..model.discriminator.patch_gan import DiscriminatorPatchGan
from ..model.latentsplat import LatentSplat, render_full
from ..parallel.mesh import Mesh, make_parallel_train_step, replicate_state, single_mesh
from ..visualization.annotation import add_label
from ..visualization.camera_trajectory import generate_wobble, interpolate_extrinsics, interpolate_intrinsics
from ..visualization.color_map import apply_depth_color_map
from ..visualization.layout import add_border, hcat, vcat
from .checkpointing import (
    load_checkpoint,
    load_generator_state,
    load_generator_weights,
    resolve_checkpoint_uri,
    save_checkpoint,
)
from .logger import get_logger
from .optim import build_optimizers
from .step import GROUP_NAMES, TrainState
from .step_tracker import StepTracker


def _device_keys(views: dict) -> dict:
    return {k: views[k] for k in ("extrinsics", "intrinsics", "image", "near", "far") if k in views}


def strip_batch(batch: dict) -> dict:
    """Keep only the array fields the model consumes (drops "scene" and "index")."""
    return {"context": _device_keys(batch["context"]), "target": _device_keys(batch["target"])}


@contextmanager
def _closing(loader: Iterator):
    """Stops the loader's worker processes (or ends its generator) on leaving,
    where it has a close(); the thread prefetcher's daemon thread stays."""
    try:
        yield loader
    finally:
        close = getattr(loader, "close", None)
        if close is not None:
            close()


def to_device(batch: dict, device: torch.device) -> dict:
    """A stripped numpy batch -> the same dict of tensors on `device`."""
    return {
        key: {name: torch.as_tensor(np.ascontiguousarray(array), device=device) for name, array in views.items()}
        for key, views in batch.items()
    }


def init_train_state(cfg, model: LatentSplat, device, effective_batch_size: int, seed: int) -> TrainState:
    """`model` with a PatchGAN discriminator and LPIPS whose weights come
    from `seed` on the CPU, their optimizers (learning rates scaled for
    `effective_batch_size`), and the spike guard's state where `cfg` has
    one."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        disc = DiscriminatorPatchGan(cfg.model.discriminator) if cfg.model.discriminator else None
        lpips = LPIPS().requires_grad_(False)
    disc = disc.to(device) if disc is not None else None
    opt_gen, opt_disc = build_optimizers(model, disc, cfg.optimizer, effective_batch_size, freeze=cfg.freeze)
    state = TrainState(model, disc, lpips.to(device), opt_gen, opt_disc)
    if cfg.optimizer.generator.skip_loss_spike_factor is not None:
        state.gen_loss_ema = torch.zeros((), device=device)
        state.spike_skip_count = torch.zeros((), dtype=torch.int32, device=device)
    return state


class Trainer:
    """`device` None means the card ("cuda"); tests pass "cpu". `mesh`, a
    rank of a data-parallel group, sets the device instead."""

    def __init__(self, cfg, output_dir: Optional[Path] = None, device=None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else single_mesh("cuda" if device is None else device)
        self.device = self.mesh.device
        self.output_dir = Path(output_dir or cfg.output_dir)
        # The generator's weights come from `seed` on the CPU, so every
        # device starts from the same ones.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.model = LatentSplat(cfg.model, tuple(cfg.dataset.background_color)).to(self.device)
        self.losses = {name: LossGroup(name, getattr(cfg.loss, name)) for name in GROUP_NAMES}
        self.step_tracker = StepTracker(cfg.train.step_offset)
        self.logger = get_logger(cfg.wandb, self.output_dir / "local") if self.mesh.is_main else None
        self.benchmarker = Benchmarker()
        self.checkpoint_dir = self.output_dir / "checkpoints"
        self.step = 0   # the port's TrainState has no step: the trainer keeps it

    # -- data -------------------------------------------------------------------
    def _dataset(self, stage: str):
        view_sampler = get_view_sampler(
            self.cfg.dataset.view_sampler, stage, self.cfg.dataset.overfit_to_scene is not None,
            self.cfg.dataset.cameras_are_circular, self.step_tracker,
        )
        dataset = get_dataset(self.cfg.dataset, stage, view_sampler)
        mesh = self.mesh
        if stage == "train" and mesh.world_size > 1:
            if mesh.num_hosts > 1:
                dataset.shard_index, dataset.num_shards = mesh.host, mesh.num_hosts
            b = self.cfg.data_loader.train.batch_size
            dataset.row_shard = RowShard(mesh.local_rank * b, (mesh.local_rank + 1) * b, mesh.local_world_size * b)
        return dataset

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
        load_generator_state(self.model, params_gen)
        return self.model

    # -- state ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """The trainer's generator with a seeded discriminator and LPIPS,
        their optimizers, and the spike guard's state; then the checkpoint
        of `checkpointing.load`, whole (`resume`) or the generator's weights
        only. Sets `self.step`."""
        cfg = self.cfg
        state = init_train_state(
            cfg, self.model, self.device, cfg.data_loader.train.batch_size * self.mesh.world_size, cfg.seed
        )

        self.step = 0
        ckpt = cfg.checkpointing
        if ckpt.load is not None and self.mesh.is_main:
            path = resolve_checkpoint_uri(ckpt.load)
            if ckpt.resume:
                self.step = int(load_checkpoint(path, state, self.device)["step"])
                print(f"resumed full state at step {self.step} from {ckpt.load}")
            else:
                load_generator_weights(path, self.model)
                print(f"loaded generator weights from {ckpt.load}")
        if self.mesh.world_size > 1:
            step = torch.tensor([self.step], device=self.device)
            torch.distributed.broadcast(step, src=0, group=self.mesh.group)
            self.step = int(step)
            replicate_state(state, self.mesh)
        return state

    def _on_main(self, fn, *args) -> None:
        """`fn(*args)` on rank 0 while the other ranks wait."""
        if self.mesh.is_main:
            fn(*args)
        self.mesh.barrier()

    # -- training ---------------------------------------------------------------
    def fit(self, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        max_steps = max_steps if max_steps is not None else cfg.trainer.max_steps
        with _closing(self._loader("train", cfg.data_loader.train.batch_size, repeat=True)) as loader:
            return self._fit(loader, max_steps)

    def _fit(self, loader: Iterator, max_steps: int) -> TrainState:
        cfg = self.cfg
        batch = strip_batch(next(loader))
        state = self.init_state()
        g = cfg.optimizer.generator
        train_step = make_parallel_train_step(self.losses, self.mesh, g.skip_loss_spike_factor,
                                              g.skip_loss_spike_patience)
        seed = cfg.seed + 1
        if self.mesh.world_size > 1:
            seed = int(np.random.SeedSequence([seed, self.mesh.rank]).generate_state(1)[0])
        generator = torch.Generator(self.device).manual_seed(seed)

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

            if self.mesh.is_main and (step % log_every == 0 or step == 1):
                host_logs = {k: float(v) for k, v in logs.items()}
                dt = (time.perf_counter() - t_last) / (log_every if step > 1 else 1)
                t_last = time.perf_counter()
                host_logs["steps_per_sec"] = 1.0 / max(dt, 1e-9)
                self.logger.log_scalars(host_logs, step)
                gen_total = host_logs.get("generator/total", float("nan"))
                print(f"step {step}: generator/total={gen_total:.4f} ({host_logs['steps_per_sec']:.2f} it/s)")

            if cfg.trainer.val_check_interval and step % cfg.trainer.val_check_interval == 0:
                self._on_main(self.validate, state, step)

            if cfg.checkpointing.every_n_train_steps and step % cfg.checkpointing.every_n_train_steps == 0:
                self._on_main(save_checkpoint, state, self.checkpoint_dir, step)

        self._on_main(save_checkpoint, state, self.checkpoint_dir, step)
        return state

    # -- forward passes for evaluation ------------------------------------------
    def _render_full(self, params_gen, batch: dict, generator: torch.Generator, deterministic: bool) -> dict:
        """(VAE encode under `encode_latents`: the posterior's mode when
        deterministic, else a sample) -> encoder -> splat -> VAE decode on a
        device batch (the data shims are applied once, inside
        `render_full`)."""
        return render_full(self._generator(params_gen), batch, deterministic=deterministic, generator=generator)

    def _render_full_timed(
        self, params_gen, batch: dict, generator: torch.Generator, deterministic: bool, benchmarker: Benchmarker,
    ) -> dict:
        """`_render_full` with its stages timed under the tags
        autoencoder_encoder (under `encode_latents`, per context view),
        encoder (per scene), decoder and autoencoder_decoder (per target
        view), each waiting for the device at its ends."""
        calls = {"encoder": 1, "autoencoder_encoder": batch["context"]["image"].shape[1]}
        v = batch["target"]["image"].shape[1]
        on_cuda = self.device.type == "cuda"

        @contextmanager
        def timer(name):
            if on_cuda:
                torch.cuda.synchronize(self.device)
            with benchmarker.time(name, num_calls=calls.get(name, v)):
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
        metrics: Dict[str, list] = {}
        with _closing(self._loader("val", cfg.data_loader.val.batch_size, repeat=False)) as loader:
            batches = [batch for _, batch in zip(range(num_batches), loader)]
        for batch in batches:
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
            with _closing(self._loader("val", 1, repeat=False)) as loader:
                batch = strip_batch(next(loader))
            if cfg.train.video_wobble:
                self.render_video(params_gen, batch, "wobble", step)
            if cfg.train.video_interpolation:
                self.render_video(params_gen, batch, "interpolation", step)
        return out

    def render_video(
        self, params_gen, batch: dict, mode: str, step: int, num_frames: int = 30, loop_reverse: bool = True,
    ) -> None:
        """A video along a camera trajectory from the first to the last
        context view of a stripped numpy batch of size 1: a wobble of a
        quarter of their baseline about the first, or an interpolation
        between the two, with cosine-eased times. The views are rendered
        by the probabilistic `render_full` in one batch; each frame is the
        image over its depth in color, and the frames, looped back with
        `loop_reverse`, go to the logger as video/<mode>."""
        ctx = batch["context"]
        t = np.linspace(0, 1, num_frames, dtype=np.float32)
        t = (np.cos(np.pi * (t + 1)) + 1) / 2
        e0, e1 = ctx["extrinsics"][0, 0], ctx["extrinsics"][0, -1]
        i0, i1 = ctx["intrinsics"][0, 0], ctx["intrinsics"][0, -1]
        if mode == "wobble":
            delta = np.linalg.norm(e0[:3, 3] - e1[:3, 3])
            extrinsics = generate_wobble(e0, np.asarray(delta * 0.25), t)
            intrinsics = np.tile(i0[None], (num_frames, 1, 1))
        elif mode == "interpolation":
            extrinsics = interpolate_extrinsics(e0, e1, t)
            intrinsics = interpolate_intrinsics(i0, i1, t)
        else:
            raise ValueError(f"unknown video mode {mode!r}")
        video_batch = {
            "context": ctx,
            "target": {
                "extrinsics": extrinsics[None],
                "intrinsics": intrinsics[None],
                "image": np.zeros((1, num_frames, *ctx["image"].shape[2:]), np.float32),
                "near": np.tile(ctx["near"][:, :1], (1, num_frames)),
                "far": np.tile(ctx["far"][:, :1], (1, num_frames)),
            },
        }
        generator = torch.Generator(self.device).manual_seed(self.cfg.seed + 4)
        out = self._render_full(params_gen, to_device(video_batch, self.device), generator, False)
        images = out["image"][0].cpu().numpy()
        depths = out["depth"][0].cpu().numpy()
        frames = [vcat(images[v], apply_depth_color_map(depths[v]), gap=2) for v in range(num_frames)]
        if loop_reverse:
            frames = frames + frames[-2:0:-1]
        self.logger.log_video(f"video/{mode}", frames, step)

    # -- test -------------------------------------------------------------------
    def test(self, state_or_params, name: str = "latentsplat_tpu") -> None:
        """Render every test scene, write its target views as
        <test.output_path>/<name>/<scene>/<context indices>/color/NNNNNN.png,
        then benchmark.json and peak_memory.json beside them."""
        cfg = self.cfg
        model = self._generator(state_or_params)
        out_root = Path(cfg.test.output_path) / name
        with _closing(self._loader("test", 1, repeat=False)) as loader:
            for batch in loader:
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
