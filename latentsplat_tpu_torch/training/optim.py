"""The generator's and the discriminator's optimizers (counterpart of
`build_optimizers` in latentsplat_tpu/training/step.py).

The JAX package builds optax chains; this module reproduces them by hand:
  * parameters are split into labelled groups ("rest" = the encoder,
    "autoencoder", or frozen), and each group runs its own chain, so the
    gradient clip by global norm is taken per group;
  * clip_by_global_norm -> scale_by_adam (eps 1e-8, eps_root 0, bias
    correction at count + 1) -> scale by the learning rate, where the
    generator's rate warms up linearly over the group's own update count;
  * a frozen group gets zero updates and has no state, and so does a group
    with no parameters (the autoencoder's, when it is the identity);
  * `step(grads, ok)` with ok false leaves parameters and state, count
    included, exactly as they were. `ok` stays on the device: the update is
    selected with torch.where, so no step waits on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..misc.profiler import host_read


@dataclass
class AdamCfg:
    lr: float
    betas: tuple[float, float]
    clip: float
    warm_up_steps: int = 0             # 0: constant rate, no warm-up
    warm_up_start_factor: float = 1.0
    eps: float = 1e-8


def _learning_rate(cfg: AdamCfg, count: torch.Tensor) -> torch.Tensor:
    """optax.linear_schedule(lr * start_factor -> lr over warm_up_steps)."""
    if cfg.warm_up_steps <= 0:
        with host_read("learning_rate"):
            return torch.tensor(cfg.lr, device=count.device)
    init = cfg.lr * cfg.warm_up_start_factor
    c = count.clamp(0, cfg.warm_up_steps).float()
    frac = 1.0 - c / cfg.warm_up_steps
    return (init - cfg.lr) * frac + cfg.lr


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t * t).sum() for t in tensors))


class ChainedAdam:
    """Per-group clip -> Adam -> learning rate over named parameters.

    `groups` maps a label to (named parameters, AdamCfg or None for frozen).
    `state[label]` = {"count": int32 scalar, "mu": {name: tensor}, "nu": {...}}.
    """

    def __init__(self, groups: Dict[str, tuple[Dict[str, nn.Parameter], Optional[AdamCfg]]]):
        self.groups = groups
        self.state = {}
        for label, (params, cfg) in groups.items():
            if cfg is None or not params:
                continue
            device = next(iter(params.values())).device
            self.state[label] = {
                "count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()},
            }

    def load_state(self, label: str, state: dict) -> None:
        """Replace one group's state (e.g. from weights.adam_state_from_jax)."""
        own = self.state[label]
        own["count"] = state["count"].to(own["count"].device)
        for key in ("mu", "nu"):
            assert set(state[key]) == set(own[key]), f"{label}.{key}: parameter names differ"
            own[key] = {n: state[key][n].to(own[key][n]) for n in own[key]}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], ok: torch.Tensor) -> None:
        """Apply one update from `grads` (by parameter name) where `ok`."""
        for label, state in self.state.items():
            params, cfg = self.groups[label]
            g = [grads[n] for n in params]
            norm = global_norm(g)
            b1, b2 = cfg.betas
            count = state["count"]
            count_inc = count + 1
            one = torch.ones((), device=count.device)
            correction1 = 1.0 - torch.pow(one * b1, count_inc.float())
            correction2 = 1.0 - torch.pow(one * b2, count_inc.float())
            step_size = -_learning_rate(cfg, count)
            for (name, p), grad in zip(params.items(), g):
                grad = torch.where(norm < cfg.clip, grad, grad / norm * cfg.clip)
                mu = (1.0 - b1) * grad + b1 * state["mu"][name]
                nu = (1.0 - b2) * (grad * grad) + b2 * state["nu"][name]
                update = step_size * ((mu / correction1) / (torch.sqrt(nu / correction2) + cfg.eps))
                p.copy_(torch.where(ok, p + update, p))
                state["mu"][name] = torch.where(ok, mu, state["mu"][name])
                state["nu"][name] = torch.where(ok, nu, state["nu"][name])
            state["count"] = torch.where(ok, count_inc, count)


def build_optimizers(model, discriminator, opt_cfg, effective_batch_size: int, freeze=None):
    """(generator optimizer, discriminator optimizer or None), the chains of
    the JAX `build_optimizers`: the encoder and the autoencoder each with
    their rate, betas and warm-up, the discriminator with a constant rate."""
    g = opt_cfg.generator
    generator_lr = g.lr * (effective_batch_size if g.scale_lr else 1.0)
    autoencoder_lr = g.autoencoder_lr * (effective_batch_size if g.scale_autoencoder_lr else 1.0)

    def adam(lr, betas):
        return AdamCfg(lr, tuple(betas), g.gradient_clip_val, g.warm_up_steps, g.warm_up_start_factor)

    named = dict(model.named_parameters())
    rest = {n: p for n, p in named.items() if not n.startswith("autoencoder.")}
    autoencoder = {n: p for n, p in named.items() if n.startswith("autoencoder.")}
    frozen_encoder = freeze is not None and freeze.encoder
    frozen_autoencoder = freeze is not None and freeze.autoencoder
    opt_gen = ChainedAdam({
        "rest": (rest, None if frozen_encoder else adam(generator_lr, g.betas)),
        "autoencoder": (autoencoder, None if frozen_autoencoder else adam(autoencoder_lr, g.autoencoder_betas)),
    })

    opt_disc = None
    if opt_cfg.discriminator is not None and discriminator is not None:
        d = opt_cfg.discriminator
        disc_lr = d.lr * (effective_batch_size if d.scale_lr else 1.0)
        frozen = freeze is not None and freeze.discriminator
        cfg = None if frozen else AdamCfg(disc_lr, tuple(d.betas), d.gradient_clip_val)
        opt_disc = ChainedAdam({"discriminator": (dict(discriminator.named_parameters()), cfg)})
    return opt_gen, opt_disc
