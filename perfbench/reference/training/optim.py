"""The generator's and the discriminator's optimizers, written plainly from
the published recipe with PyTorch's own pieces:
  * the generator's parameters in two groups, the autoencoder's and the
    rest (the encoder), each with its own rate and betas; the
    discriminator's in one;
  * each group's gradient clipped by its own global norm
    (`torch.nn.utils.clip_grad_norm_`), then `torch.optim.Adam`
    (eps 1e-8);
  * the generator's rates warmed up linearly from `warm_up_start_factor`
    over `warm_up_steps` steps (`torch.optim.lr_scheduler.LinearLR`), the
    discriminator's constant;
  * rates scaled by the batch where the configuration says so.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t * t).sum() for t in tensors))


class GroupedAdam:
    """One `torch.optim.Adam` a labelled group of named parameters, each
    group's gradient clipped by its own norm. `step(grads, ok)` takes the
    gradients by parameter name and steps only where `ok` is true."""

    def __init__(self, groups: Dict[str, tuple[Dict[str, nn.Parameter], dict]]):
        self.groups = {}
        for label, (params, cfg) in groups.items():
            if not params:
                continue
            adam = torch.optim.Adam(list(params.values()), lr=cfg["lr"], betas=tuple(cfg["betas"]), eps=1e-8)
            schedule = None
            if cfg.get("warm_up_steps", 0) > 0:
                schedule = torch.optim.lr_scheduler.LinearLR(
                    adam, cfg["warm_up_start_factor"], 1.0, total_iters=cfg["warm_up_steps"])
            self.groups[label] = (params, cfg["clip"], adam, schedule)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], ok: torch.Tensor) -> None:
        if not bool(ok):
            return
        for params, clip, adam, schedule in self.groups.values():
            for name, p in params.items():
                p.grad = grads[name].clone()
            torch.nn.utils.clip_grad_norm_(list(params.values()), clip)
            adam.step()
            if schedule is not None:
                schedule.step()
            for p in params.values():
                p.grad = None

    def first_gradients(self) -> Dict[str, torch.Tensor]:
        """After one step: each parameter's clipped gradient, read back from
        Adam's first moment, exp_avg / (1 - beta1)."""
        out = {}
        for params, _, adam, _ in self.groups.values():
            beta1 = adam.param_groups[0]["betas"][0]
            for name, p in params.items():
                out[name] = adam.state[p]["exp_avg"] / (1.0 - beta1)
        return out


def build_optimizers(model, discriminator, opt_cfg, effective_batch_size: int):
    """(the generator's optimizer, the discriminator's or None)."""
    g = opt_cfg.generator
    warm_up = {"warm_up_steps": g.warm_up_steps, "warm_up_start_factor": g.warm_up_start_factor}
    named = dict(model.named_parameters())
    opt_gen = GroupedAdam({
        "rest": ({n: p for n, p in named.items() if not n.startswith("autoencoder.")},
                 {"lr": g.lr * (effective_batch_size if g.scale_lr else 1.0), "betas": g.betas,
                  "clip": g.gradient_clip_val, **warm_up}),
        "autoencoder": ({n: p for n, p in named.items() if n.startswith("autoencoder.")},
                        {"lr": g.autoencoder_lr * (effective_batch_size if g.scale_autoencoder_lr else 1.0),
                         "betas": g.autoencoder_betas, "clip": g.gradient_clip_val, **warm_up}),
    })
    opt_disc: Optional[GroupedAdam] = None
    if opt_cfg.discriminator is not None and discriminator is not None:
        d = opt_cfg.discriminator
        opt_disc = GroupedAdam({"discriminator": (
            dict(discriminator.named_parameters()),
            {"lr": d.lr * (effective_batch_size if d.scale_lr else 1.0), "betas": d.betas,
             "clip": d.gradient_clip_val})})
    return opt_gen, opt_disc
