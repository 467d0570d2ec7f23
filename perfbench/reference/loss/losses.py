"""Config-driven losses (counterpart of latentsplat_tpu/loss/losses.py).

Each supervision site is a `LossGroup` of weighted nll losses, an optional
generator loss and an optional discriminator loss. A loss turns on at its
`apply_after_step`: which groups run at all is a host-side decision
(`is_active`), and inside a group each loss is multiplied by a 0/1 step
gate, as in the JAX package. The adaptive GAN weight is
|grad nll| / (|grad g| + 1e-4) with respect to the shared last layer,
clamped to [0, 1] and detached.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..model.types import GroundTruth, Prediction


@dataclass
class LossCfg:
    name: str
    weight: float = 1.0
    apply_after_step: int = 0


@dataclass
class LossDiscriminatorCfg(LossCfg):
    name: str = "discriminator"
    loss: str = "hinge"


@dataclass
class LossGroupCfg:
    nll: Optional[List[LossCfg]] = None
    generator: Optional[LossCfg] = None
    discriminator: Optional[LossDiscriminatorCfg] = None


@dataclass
class LossesCfg:
    gaussian: Optional[LossGroupCfg] = None
    context: Optional[LossGroupCfg] = None
    target_autoencoder: Optional[LossGroupCfg] = None
    target_render_latent: Optional[LossGroupCfg] = None
    target_render_image: Optional[LossGroupCfg] = None
    target_combined: Optional[LossGroupCfg] = None


# -- individual losses -------------------------------------------------------


def loss_mse(prediction: Prediction, gt: GroundTruth, lpips_fn) -> torch.Tensor:
    return ((prediction.image - gt.image) ** 2).mean()


def loss_l1(prediction: Prediction, gt: GroundTruth, lpips_fn) -> torch.Tensor:
    return (prediction.image - gt.image).abs().mean()


def loss_kl(prediction: Prediction, gt: GroundTruth, lpips_fn) -> torch.Tensor:
    return prediction.posterior.kl().mean()


def loss_lpips(prediction: Prediction, gt: GroundTruth, lpips_fn) -> torch.Tensor:
    assert lpips_fn is not None, "lpips loss requires an LPIPS function"
    pred = prediction.image.reshape(-1, *prediction.image.shape[-3:])
    target = gt.image.reshape(-1, *gt.image.shape[-3:])
    return lpips_fn(pred, target).mean()


def loss_depth_smoothness(
    prediction: Prediction, gt: GroundTruth, lpips_fn,
    sigma_image: Optional[float] = None, use_second_derivative: bool = False,
) -> torch.Tensor:
    """Edge-aware depth smoothness on log depth normalized to [near, far]."""
    near = torch.log(gt.near)[..., None, None]
    far = torch.log(gt.far)[..., None, None]
    depth = torch.log(prediction.depth.clamp(min=1e-10))
    depth = torch.minimum(torch.maximum(depth, near), far)
    depth = (depth - near) / (far - near)

    depth_dx = torch.diff(depth, dim=-1)
    depth_dy = torch.diff(depth, dim=-2)
    if use_second_derivative:
        depth_dx = torch.diff(depth_dx, dim=-1)
        depth_dy = torch.diff(depth_dy, dim=-2)

    if sigma_image is not None:
        color = gt.image  # (b, v, h, w, c)
        color_dx = torch.diff(color, dim=-2).amax(dim=-1)
        color_dy = torch.diff(color, dim=-3).amax(dim=-1)
        if use_second_derivative:
            color_dx = torch.maximum(color_dx[..., :, 1:], color_dx[..., :, :-1])
            color_dy = torch.maximum(color_dy[..., 1:, :], color_dy[..., :-1, :])
        depth_dx = depth_dx * torch.exp(-color_dx * sigma_image)
        depth_dy = depth_dy * torch.exp(-color_dy * sigma_image)

    return depth_dx.abs().mean() + depth_dy.abs().mean()


def loss_sh_l2(prediction: Prediction, gt: GroundTruth, lpips_fn) -> torch.Tensor:
    """Mean squared color-SH coefficient (gaussian site)."""
    assert prediction.harmonics is not None
    return (prediction.harmonics**2).mean()


def loss_generator(prediction: Prediction) -> torch.Tensor:
    return -prediction.logits_fake.mean()


def hinge_d_loss(logits: torch.Tensor) -> torch.Tensor:
    return F.relu(1.0 + logits).mean()


def vanilla_d_loss(logits: torch.Tensor) -> torch.Tensor:
    return F.softplus(logits).mean()


_NLL_LOSSES: Dict[str, Callable] = {
    "mse": loss_mse,
    "l1": loss_l1,
    "kl": loss_kl,
    "lpips": loss_lpips,
    "depth": loss_depth_smoothness,
    "sh_l2": loss_sh_l2,
}


def _gate(step: int, apply_after_step: int) -> float:
    return 1.0 if step >= apply_after_step else 0.0


class LossGroup:
    """One supervision site's losses (nll + optional generator/discriminator)."""

    def __init__(self, name: str, cfg: Optional[LossGroupCfg]):
        self.name = name
        self.cfg = cfg or LossGroupCfg()

    def is_active(self, step: int) -> bool:
        active = any(l.apply_after_step <= step for l in (self.cfg.nll or []))
        return active or self.is_generator_active(step) or self.is_discriminator_active(step)

    @property
    def has_generator_loss(self) -> bool:
        return self.cfg.generator is not None

    @property
    def has_discriminator_loss(self) -> bool:
        return self.cfg.discriminator is not None

    def is_generator_active(self, step: int) -> bool:
        return self.cfg.generator is not None and self.cfg.generator.apply_after_step <= step

    def is_discriminator_active(self, step: int) -> bool:
        return (
            self.cfg.discriminator is not None
            and self.cfg.discriminator.apply_after_step <= step
        )

    def nll_total(
        self, prediction: Prediction, gt: Optional[GroundTruth], step: int, lpips_fn=None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Sum of weighted, step-gated nll losses + the gated, unweighted logs."""
        total = 0.0
        logs: Dict[str, torch.Tensor] = {}
        for loss_cfg in self.cfg.nll or []:
            value = _NLL_LOSSES[loss_cfg.name](prediction, gt, lpips_fn)
            gate = _gate(step, loss_cfg.apply_after_step)
            logs[f"{self.name}/{loss_cfg.name}"] = value * gate
            total = total + loss_cfg.weight * gate * value
        return torch.as_tensor(total), logs

    def generator_total(
        self, prediction: Prediction, step: int
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Weighted, gated generator loss (the caller applies the adaptive weight)."""
        assert self.has_generator_loss
        value = loss_generator(prediction)
        gate = _gate(step, self.cfg.generator.apply_after_step)
        return self.cfg.generator.weight * gate * value, {f"{self.name}/generator": value * gate}

    def discriminator_total(
        self, prediction: Prediction, step: int
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Hinge or vanilla loss, half on the fakes and half on the reals."""
        assert self.has_discriminator_loss
        cfg = self.cfg.discriminator
        fn = hinge_d_loss if cfg.loss == "hinge" else vanilla_d_loss
        loss_fake = fn(prediction.logits_fake)
        loss_real = fn(-prediction.logits_real)
        gate = _gate(step, cfg.apply_after_step)
        total = cfg.weight / 2.0 * gate * (loss_fake + loss_real)
        return total, {
            f"{self.name}/discriminator/fake": loss_fake * gate,
            f"{self.name}/discriminator/real": loss_real * gate,
        }


def adaptive_gan_weight(nll_grad_leaf: torch.Tensor, g_grad_leaf: torch.Tensor) -> torch.Tensor:
    """|grad nll| / (|grad g| + 1e-4) with respect to the shared last layer,
    clamped to [0, 1] and detached."""
    weight = torch.linalg.vector_norm(nll_grad_leaf) / (torch.linalg.vector_norm(g_grad_leaf) + 1e-4)
    return weight.clamp(0.0, 1.0).detach()
