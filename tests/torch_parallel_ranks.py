"""What each rank runs in the data-parallel tests (tests/test_torch_parallel.py).

Spawned ranks import this module by name, so it imports neither JAX nor
the JAX package: the tests build their configurations and inputs with
both packages in the parent and pass them here as plain objects.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from functools import partial

import torch

from latentsplat_tpu_torch import main as main_module
from latentsplat_tpu_torch.parallel import mesh as mesh_module
from latentsplat_tpu_torch.training.trainer import Trainer

from latentsplat_tpu_torch.loss.losses import LossGroup
from latentsplat_tpu_torch.loss.lpips import LPIPS
from latentsplat_tpu_torch.model.discriminator.patch_gan import DiscriminatorPatchGan, set_batch_norm_group
from latentsplat_tpu_torch.model.latentsplat import LatentSplat
from latentsplat_tpu_torch.parallel import make_parallel_train_step, replicate_state, shard_batch
from latentsplat_tpu_torch.parallel.mesh import Mesh, RankReduce, assert_replicated, state_tensors
from latentsplat_tpu_torch.training import step as tstep
from latentsplat_tpu_torch.training.optim import build_optimizers


def build_state(model_cfg, opt_cfg, loss_cfgs: dict, device, spike_factor=None):
    """The tiny VAE-GAN state of tests/test_torch_step_quick.py, seeded on
    the CPU, on `device`."""
    torch.manual_seed(0)
    model = LatentSplat(model_cfg).to(device)
    disc = DiscriminatorPatchGan(model_cfg.discriminator).to(device)
    lpips = LPIPS().requires_grad_(False).to(device)
    opt_gen, opt_disc = build_optimizers(model, disc, opt_cfg, effective_batch_size=1)
    state = tstep.TrainState(model, disc, lpips, opt_gen, opt_disc)
    if spike_factor is not None:
        state.gen_loss_ema = torch.zeros((), device=device)
        state.spike_skip_count = torch.zeros((), dtype=torch.int32, device=device)
    losses = {name: LossGroup(name, loss_cfgs.get(name)) for name in tstep.GROUP_NAMES}
    return state, losses


def results(state, logs) -> dict:
    return {
        "params": {n: t.detach().cpu().clone() for n, t in state_tensors(state).items()},
        "logs": {k: float(v) for k, v in logs.items()},
    }


def train_steps(mesh: Mesh, model_cfg, opt_cfg, loss_cfgs: dict, batches: list, noises: list, step: int,
                spike_factor=None, patience: int = 10, ema=None) -> list:
    """Steps on this rank's rows of each global batch and noise; checks that
    every rank holds the same state after each step; returns the state's
    tensors and the logs after each step, on the CPU."""
    state, losses = build_state(model_cfg, opt_cfg, loss_cfgs, mesh.device, spike_factor)
    if ema is not None:
        state.gen_loss_ema.fill_(ema)
    replicate_state(state, mesh)
    train_step = make_parallel_train_step(losses, mesh, spike_factor, patience)
    out = []
    for batch, noise in zip(batches, noises):
        state, logs = train_step(state, shard_batch(batch, mesh), step, noise=shard_batch(noise, mesh))
        assert_replicated(state_tensors(state), mesh, f"the state after step {len(out) + 1}")
        out.append(results(state, logs))
    return out


def discriminate(mesh: Mesh, disc_cfg, weights: dict, images, cotangent) -> dict:
    """The PatchGAN with `weights` on this rank's rows of `images`, its
    BatchNorms over the mesh: logits and the gradients of <logits,
    cotangent> (the global batch's) for the parameters and this rank's
    images, on the CPU."""
    disc = DiscriminatorPatchGan(disc_cfg).to(mesh.device)
    disc.load_state_dict(weights)
    set_batch_norm_group(disc, mesh.group)
    x = shard_batch({"x": images}, mesh)["x"].requires_grad_(True)
    logits = disc(x)
    (logits * shard_batch({"c": cotangent}, mesh)["c"]).sum().backward()
    grads = {n: p.grad.detach().clone() for n, p in disc.named_parameters()}
    for g in grads.values():
        torch.distributed.all_reduce(g, group=mesh.group)
    return {"logits": logits.detach().cpu(), "d_images": x.grad.cpu(),
            "grads": {n: g.cpu() for n, g in grads.items()}}


def small_cases(mesh, disc_cfg, disc_weights, images, cotangent, toy):
    return {"disc": discriminate(mesh, disc_cfg, disc_weights, images, cotangent),
            "toy": toy_sgd(mesh, *toy)}


def toy_sgd(mesh, params, batch):
    """tests/test_parallel.py's toy step on this rank's rows: the local mean
    loss's gradient, averaged over the ranks."""
    p = torch.from_numpy(params).requires_grad_(True)
    rows = shard_batch(batch, mesh)
    loss = torch.mean((rows["x"] @ p - rows["y"]) ** 2)
    (grad,) = torch.autograd.grad(loss, p)
    reduce = RankReduce(mesh)
    grad = reduce.mean_grads({"p": grad})["p"]
    return {"params": (p - 0.1 * grad).detach(), "loss": float(reduce.mean(loss))}


def every_case(mesh, step_args, small_args):
    """One process group for the step and the small cases."""
    return {"steps": train_steps(mesh, *step_args), **small_cases(mesh, *small_args)}


def rank_fails(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    torch.distributed.barrier()


def rank_hangs(mesh):
    if mesh.rank == 1:
        time.sleep(600)
    torch.distributed.barrier()


def torchrun_rank(rank: int, world: int, port: int, argv: list, test_s: float, timeout_s: float) -> None:
    """One process of a torchrun launch of `main` on the CPU (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and the master's address set
    as torchrun sets them), its group's collectives timing out after
    `timeout_s` seconds, and rank 0's test held `test_s` seconds first."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    main_module.make_mesh = partial(mesh_module.make_mesh, timeout=timedelta(seconds=timeout_s))
    test = Trainer.test

    def held_test(self, *args, **kwargs):
        time.sleep(test_s)
        return test(self, *args, **kwargs)

    Trainer.test = held_test
    main_module.main(argv, device="cpu")
