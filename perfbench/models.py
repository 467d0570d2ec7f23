"""The two sides of a cell: the program (latentsplat_tpu_torch, through its
program API) and the reference (perfbench/reference, plain PyTorch), both
built from the configuration file and given the benchmark's weights.

The configuration file holds the configuration as it is run: the preset
and overrides the program loads (`config.load_config` over the presets'
YAML), and the resolved model, loss and optimizer blocks. The program's
resolved blocks must equal the file's; the reference reads the file's.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from . import weights

# Streams of the weight draws.
GENERATOR_STREAM, DISCRIMINATOR_STREAM, LPIPS_STREAM = 0, 1, 2
RESOLVED = ("model", "loss", "optimizer")


def namespace(tree):
    """A JSON tree as attributes (dicts) and lists, for the reference."""
    if isinstance(tree, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in tree.items()})
    if isinstance(tree, list):
        return [namespace(v) for v in tree]
    return tree


def _jsonable(tree):
    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jsonable(v) for v in tree]
    return tree


def program_config(config: dict):
    """The program's config for the file's preset and overrides; raises
    where its resolved blocks differ from the file's."""
    from latentsplat_tpu_torch.config import load_config

    cfg = load_config(config["preset"], list(config["overrides"]))
    for block in RESOLVED:
        got = _jsonable(dataclasses.asdict(getattr(cfg, block)))
        if got != config[block]:
            diff = sorted(k for k in set(got) | set(config[block]) if got.get(k) != config[block].get(k))
            raise ValueError(f"the program's {block} config differs from the configuration file in {diff}")
    return cfg


def program_generator(config: dict, seed: int, device):
    """The program's LatentSplat on `device` with the benchmark's weights."""
    from latentsplat_tpu_torch.model.latentsplat import LatentSplat

    cfg = program_config(config)
    with torch.device(device):
        model = LatentSplat(cfg.model, tuple(config["scene"]["background_color"]))
    weights.load(model, weights.make(weights.shapes_of(model), seed, GENERATOR_STREAM, device))
    return cfg, model.eval()


def program_train_state(config: dict, batch: int, seed: int, device):
    """(cfg, the program's TrainState, its train_step): the generator, the
    PatchGAN and LPIPS with the benchmark's weights, their optimizers
    (learning rates scaled for `batch` scenes a step)."""
    from latentsplat_tpu_torch.loss.losses import LossGroup
    from latentsplat_tpu_torch.training.step import GROUP_NAMES, make_train_step
    from latentsplat_tpu_torch.training.trainer import init_train_state

    cfg, model = program_generator(config, seed, device)
    model.train()
    state = init_train_state(cfg, model, device, batch, seed)
    weights.load(state.discriminator, weights.make(weights.shapes_of(state.discriminator), seed,
                                                   DISCRIMINATOR_STREAM, device))
    weights.load(state.lpips, weights.make(weights.shapes_of(state.lpips), seed, LPIPS_STREAM, device))
    losses = {name: LossGroup(name, getattr(cfg.loss, name)) for name in GROUP_NAMES}
    g = cfg.optimizer.generator
    return cfg, state, make_train_step(losses, g.skip_loss_spike_factor, g.skip_loss_spike_patience)


def reference_generator(config: dict, seed: int, device):
    """The reference's LatentSplat with the same weights."""
    from .reference.model.latentsplat import LatentSplat

    with torch.device(device):
        model = LatentSplat(namespace(config["model"]), tuple(config["scene"]["background_color"]))
    weights.load(model, weights.make(weights.shapes_of(model), seed, GENERATOR_STREAM, device))
    return model.eval()


def reference_train_state(config: dict, batch: int, seed: int, device):
    """(the reference's TrainState, its train_step), as `program_train_state`."""
    from .reference.loss.losses import LossGroup
    from .reference.loss.lpips import LPIPS
    from .reference.model.discriminator.patch_gan import DiscriminatorPatchGan
    from .reference.training.optim import build_optimizers
    from .reference.training.step import GROUP_NAMES, TrainState, make_train_step

    model = reference_generator(config, seed, device).train()
    cfg = namespace({k: config[k] for k in RESOLVED})
    with torch.device(device):
        disc = DiscriminatorPatchGan(cfg.model.discriminator)
        lpips = LPIPS().requires_grad_(False)
    weights.load(disc, weights.make(weights.shapes_of(disc), seed, DISCRIMINATOR_STREAM, device))
    weights.load(lpips, weights.make(weights.shapes_of(lpips), seed, LPIPS_STREAM, device))
    opt_gen, opt_disc = build_optimizers(model, disc, cfg.optimizer, batch)
    state = TrainState(model, disc, lpips, opt_gen, opt_disc)
    losses = {name: LossGroup(name, getattr(cfg.loss, name)) for name in GROUP_NAMES}
    return state, make_train_step(losses, cfg.optimizer.generator.skip_loss_spike_factor)
