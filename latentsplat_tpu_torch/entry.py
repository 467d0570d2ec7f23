"""The flagship's entry points (counterpart of the repository's root
__graft_entry__.py):

  * `arc_batch` - a multi-view batch as numpy: cameras on an arc looking at
    one point, noise images;
  * `flagship_model` - the re10k config with overrides and its
    `LatentSplat`, weights drawn from a seed;
  * `entry` - (forward, example_args): the flagship's generator forward
    (encoder -> Gaussian sample -> render at the scaled size -> feature
    posterior sample -> 1/supersampling resize -> VAE decode with the
    [color, latent] skip) on 2 + 2 views at 64x64;
  * `dryrun_multichip` - one whole VAE-GAN step of a tiny flagship over
    n data-parallel ranks (`parallel.spawn`, gloo), each rank one scene.

Everything runs on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Sequence

import numpy as np
import torch

from .config import load_config
from .dataset.synthetic import _look_at
from .loss.losses import LossGroup
from .model.latentsplat import LatentSplat
from .parallel import make_parallel_train_step, replicate_state, shard_batch, spawn
from .parallel.mesh import state_tensors
from .training.step import GROUP_NAMES, make_step_flags
from .training.trainer import init_train_state

ENTRY_SIZE = 64
DRYRUN_SIZE = 32
# The spawned ranks' join limit: the tiny step takes seconds on either device.
DRYRUN_JOIN_S = 600
# The flagship's structure at small width: the narrow model that the tests
# and the CPU rehearsals of chip_smoke.py's phases build.
SMALL_OVERRIDES = [
    "model.encoder.backbone.model=dino_vits8",
    "model.encoder.d_feature=32",
    "model.encoder.epipolar_transformer.num_layers=1",
    "model.encoder.epipolar_transformer.self_attention.num_layers=1",
    "model.autoencoder.block_out_channels=[16,16,16,16]",
]


def resolve(device) -> torch.device:
    """None means the card, which must exist; "cpu" only when asked."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda" if device is None else device)


def arc_cameras(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(extrinsics (n, 4, 4), intrinsics (n, 3, 3)) of n cameras on an arc
    looking at (0, 0, 4), as numpy float32."""
    ext = np.stack([
        _look_at(
            np.array([2.0 * np.sin(a), 0.2 * np.sin(2 * a), -2.0 * np.cos(a) + 2.0], np.float32),
            np.array([0.0, 0.0, 4.0], np.float32),
        )
        for a in np.linspace(-0.3, 0.3, n)
    ])
    intr = np.tile(np.asarray([[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]], np.float32), (n, 1, 1))
    return ext, intr


def arc_batch(b: int, v_ctx: int, v_tgt: int, h: int, w: int, seed: int = 0) -> dict:
    """A geometrically sane batch of `b` scenes as numpy: v_ctx + v_tgt
    cameras on the arc of `arc_cameras`, the context views at its ends and
    the targets after the first, uniform noise images from `seed`."""
    rng = np.random.default_rng(seed)
    n = v_ctx + v_tgt
    ext, intr = arc_cameras(n)

    def views(idx):
        k = len(idx)
        return {
            "extrinsics": np.tile(ext[idx][None], (b, 1, 1, 1)),
            "intrinsics": np.tile(intr[idx][None], (b, 1, 1, 1)),
            "image": rng.uniform(0, 1, (b, k, h, w, 3)).astype(np.float32),
            "near": np.full((b, k), 0.5, np.float32),
            "far": np.full((b, k), 20.0, np.float32),
            "index": np.tile(np.asarray(idx, np.int32)[None], (b, 1)),
        }

    return {"context": views([0, n - 1]), "target": views(list(range(1, 1 + v_tgt)))}


def to_tensors(batch: dict, device) -> dict:
    """A numpy batch -> the same dict of tensors on `device`."""
    return {side: {k: torch.from_numpy(v).to(device) for k, v in views.items()} for side, views in batch.items()}


def flagship_config(overrides: Sequence[str] = ()):
    """The re10k config with `overrides`."""
    return load_config("re10k", list(overrides))


def flagship_model(overrides: Sequence[str] = (), device=None, seed: int = 0) -> tuple:
    """(`flagship_config(overrides)`, its LatentSplat with weights drawn from
    `seed` on the CPU, on `device`)."""
    cfg = flagship_config(overrides)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LatentSplat(cfg.model, tuple(cfg.dataset.background_color))
    return cfg, model.to(resolve(device))


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


@dataclass
class Forward:
    """The flagship's generator forward on `model`: a batch of context and
    target views -> the decoded target images (b, v, h, w, 3). Its three
    draws (the encoder's depth uniforms, the Gaussians' feature normals,
    the latent normals) come from `generator`, or from `noise` =
    {"depth", "gaussians", "latent"} where given. No data shims run, as in
    __graft_entry__.entry()."""

    model: LatentSplat

    def __call__(self, batch: dict, generator: Optional[torch.Generator] = None,
                 noise: Optional[dict] = None) -> torch.Tensor:
        noise = noise or {}
        model = self.model
        gaussians = model.encoder(batch["context"], 0, deterministic=False, generator=generator,
                                  depth_noise=noise.get("depth"))
        target = batch["target"]
        size = model.scaled_size(model.scale_factor, target["image"].shape[-3:-1])
        rendered = model.decoder(
            gaussians.sample(generator, noise.get("gaussians")), target["extrinsics"], target["intrinsics"],
            target["near"], target["far"], size,
        )
        latent = rendered.feature_posterior.sample(generator, noise.get("latent"))
        z = model.rescale(latent, Fraction(1, model.cfg.supersampling_factor))
        skip_z = torch.cat([rendered.color.detach(), latent], dim=-1) if model.autoencoder.expects_skip else None
        return model.autoencoder.decode(z, skip_z)


def entry(device=None) -> tuple:
    """(forward, (batch, generator)): the flagship re10k model at full width
    with weights from seed 0 (`Forward`), and one scene of 2 context and 2
    target views at 64x64 with a generator seeded with 1, on `device`."""
    device = resolve(device)
    cfg, model = flagship_model([f"dataset.image_shape=[{ENTRY_SIZE},{ENTRY_SIZE}]"], device)
    batch = to_tensors(arc_batch(b=1, v_ctx=2, v_tgt=2, h=ENTRY_SIZE, w=ENTRY_SIZE), device)
    return Forward(model.eval()), (batch, torch.Generator(device=device).manual_seed(1))


def dryrun_overrides(h: int, w: int) -> list:
    """The tiny-but-complete flagship of __graft_entry__.dryrun_multichip: a
    2-layer ResNet-18 trunk, a narrow epipolar transformer, the f8 VAE with
    skips at 16 channels, the PatchGAN, variational Gaussians and every
    loss group live from step 0."""
    return [
        f"dataset.image_shape=[{h},{w}]",
        "model.encoder.backbone={name: resnet, model: resnet18, num_layers: 2, use_first_pool: false}",
        "model.encoder.d_backbone=64",
        "model.encoder.d_feature=32",
        "model.encoder.epipolar_transformer.num_samples=8",
        "model.encoder.epipolar_transformer.num_layers=1",
        "model.encoder.epipolar_transformer.d_dot=32",
        "model.encoder.epipolar_transformer.d_mlp=32",
        "model.encoder.epipolar_transformer.self_attention.num_layers=1",
        "model.encoder.epipolar_transformer.self_attention.d_token=32",
        "model.encoder.epipolar_transformer.self_attention.d_dot=32",
        "model.encoder.epipolar_transformer.self_attention.d_mlp=32",
        "model.encoder.num_monocular_samples=8",
        "model.encoder.gaussians_per_pixel=2",
        "model.autoencoder.block_out_channels=[16,16,16,16]",
        "model.autoencoder.layers_per_block=1",
        "model.supersampling_factor=8",
        "loss.target_render_image.nll=[{name: mse, weight: 10}, {name: lpips, weight: 0.5}]",
        "loss.target_combined.nll=[{name: l1}, {name: lpips}]",
        "loss.target_combined.generator={name: generator, weight: 0.5}",
        "loss.target_combined.discriminator={name: discriminator, loss: hinge}",
        "loss.gaussian.nll=[{name: kl, weight: 0.0001}]",
    ]


def dryrun_rank(mesh, overrides: list, batch: dict) -> dict:
    """One rank of `dryrun_multichip`: the seeded state broadcast from rank
    0, one data-parallel step at step 0 on this rank's rows of `batch`;
    returns the step's logs and the state's tensors, on the CPU."""
    n = mesh.world_size
    cfg, model = flagship_model(overrides, mesh.device)
    state = init_train_state(cfg, model, mesh.device, n, seed=0)
    losses = {name: LossGroup(name, getattr(cfg.loss, name)) for name in GROUP_NAMES}
    flags = make_step_flags(losses, 0)
    if not (flags.disc and flags.gen_gan):
        raise RuntimeError("the GAN path must be live in the dry run")
    replicate_state(state, mesh)
    g = cfg.optimizer.generator
    train_step = make_parallel_train_step(losses, mesh, g.skip_loss_spike_factor, g.skip_loss_spike_patience)
    rows = shard_batch(to_tensors(batch, mesh.device), mesh)
    generator = torch.Generator(device=mesh.device).manual_seed(1 + mesh.rank)
    state, logs = train_step(state, rows, 0, generator=generator)
    return {"logs": {k: float(v) for k, v in logs.items()},
            "state": {k: t.detach().cpu() for k, t in state_tensors(state).items()}}


def dryrun_multichip(n: int, device=None) -> dict:
    """One full VAE-GAN train step (generator gradients with the adaptive GAN
    weights, both updates) of the tiny flagship on `n` ranks over gloo, the
    global batch `n` scenes of 2 context + 1 target views at 32x32, one
    scene a rank. The ranks share the card (or run on the CPU with
    device="cpu"). Raises unless every log is finite and the ranks hold
    the same bits afterwards; returns rank 0's logs."""
    device = resolve(device)
    batch = {side: {k: v for k, v in views.items() if k != "index"}
             for side, views in arc_batch(b=n, v_ctx=2, v_tgt=1, h=DRYRUN_SIZE, w=DRYRUN_SIZE).items()}
    ranks = spawn(dryrun_rank, [device] * n, "gloo", (dryrun_overrides(DRYRUN_SIZE, DRYRUN_SIZE), batch),
                  join_timeout=DRYRUN_JOIN_S)
    logs = ranks[0]["logs"]
    bad = sorted(k for r in ranks for k, v in r["logs"].items() if not np.isfinite(v))
    if bad:
        raise RuntimeError(f"dryrun_multichip({n}): non-finite logs {bad}")
    for r, rank in enumerate(ranks[1:], 1):
        differ = [k for k, t in ranks[0]["state"].items() if not torch.equal(t, rank["state"][k])]
        if differ:
            raise RuntimeError(f"dryrun_multichip({n}): rank {r}'s state differs from rank 0's in {differ[:4]}")
    print(f"dryrun_multichip({n}) on {device}: ok, generator/total={logs['generator/total']:.4f}")
    return logs
