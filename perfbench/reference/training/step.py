"""The fused generator + discriminator training step, plain: no remat,
float32, one process (`make_train_step(losses, ...)` returns
`train_step(state, batch, step, generator=None, noise=None) ->
(state, logs)`):
  * the generator forward of every active supervision site: encoder ->
    Gaussian sample -> render -> feature posterior sample -> VAE decode
    with skips -> losses, plus discriminator logits of the generator's
    images where a generator loss is active;
  * per GAN site, two probe backwards to the VAE's last layer for the
    adaptive weight, then one backward of nll + sum(w * g);
  * a NaN guard (the recipe's loss-spike guard is not part of this
    reference: a configuration that sets it is refused);
  * the generator update, then the discriminator's loss on the detached
    fakes and its update, skipped with the generator's.
Randomness comes from `generator` or from `noise` = {"depth", "gaussians",
"latent", "context_latent", "target_latent"}.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..evaluation.metrics import compute_psnr
from ..loss.losses import LossGroup, adaptive_gan_weight
from ..model.latentsplat import LatentSplat, discriminate
from ..model.types import GroundTruth, Prediction
from .optim import GroupedAdam, global_norm

GROUP_NAMES = (
    "gaussian",
    "context",
    "target_autoencoder",
    "target_render_latent",
    "target_render_image",
    "target_combined",
)
GAN_GROUPS = ("context", "target_autoencoder", "target_combined")


@dataclass(frozen=True)
class StepFlags:
    """Which branches of the step run at a given step."""

    gaussian: bool
    context: bool
    target_autoencoder: bool
    target_render_latent: bool
    target_render_image: bool
    target_combined: bool
    gen_gan: Tuple[str, ...]   # groups with an active generator loss
    disc: Tuple[str, ...]      # groups with an active discriminator loss

    def __getitem__(self, name: str) -> bool:
        return getattr(self, name)

    @property
    def needs_render(self) -> bool:
        return (
            self.gaussian or self.target_render_latent or self.target_render_image
            or self.target_combined
        )


def make_step_flags(losses: Dict[str, LossGroup], step: int) -> StepFlags:
    return StepFlags(
        **{name: losses[name].is_active(step) for name in GROUP_NAMES},
        gen_gan=tuple(g for g in GAN_GROUPS if losses[g].is_generator_active(step)),
        disc=tuple(g for g in GAN_GROUPS if losses[g].is_discriminator_active(step)),
    )


@dataclass
class TrainState:
    model: LatentSplat
    discriminator: Optional[nn.Module]
    lpips: nn.Module                   # frozen
    opt_gen: GroupedAdam
    opt_disc: Optional[GroupedAdam]


@dataclass
class Sites:
    """The step's module calls: encode(context, step, depth_noise,
    features), ae_encode(images), ae_decode(z, skip_z), ae_decode_remat
    (the target_combined decode), discriminate(images) and lpips(pred,
    target)."""

    encode: Callable
    ae_encode: Callable
    ae_decode: Callable
    ae_decode_remat: Callable
    discriminate: Optional[Callable]
    lpips: Callable


def make_sites(state: TrainState) -> Sites:
    model = state.model
    ae = model.autoencoder

    def encode(context, step, depth_noise, features):
        return model.encoder(context, step, deterministic=False, depth_noise=depth_noise, features=features)

    disc = (lambda images: discriminate(state.discriminator, images)) if state.discriminator is not None else None
    return Sites(encode, ae.encode, ae.decode, ae.decode, disc, state.lpips)


def _decode_batched(decode: Callable, latents: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One decode of every site's latents, split back by site."""
    flat = [z.reshape(-1, *z.shape[-3:]) for z in latents.values()]
    decoded = decode(torch.cat(flat), None)
    out, offset = {}, 0
    for (name, z), part in zip(latents.items(), flat):
        out[name] = decoded[offset : offset + part.shape[0]].reshape(*z.shape[:-3], *decoded.shape[1:])
        offset += part.shape[0]
    return out


def generator_forward(
    state: TrainState, losses: Dict[str, LossGroup], flags: StepFlags, batch: dict, step: int,
    generator: Optional[torch.Generator] = None, noise: Optional[dict] = None,
) -> tuple:
    """One generator pass: (nll total, per-GAN-site nll list, per-GAN-site
    weighted generator loss list, logs, fakes for the discriminator)."""
    model = state.model
    cfg = model.cfg
    noise = noise or {}
    sites = make_sites(state)
    if (flags.context or flags.target_autoencoder) and model.autoencoder.expects_skip:
        raise ValueError(
            "the context and target_autoencoder loss sites decode latents without a skip tensor, "
            "which a VAE with skip_connections cannot take (as in the JAX package)"
        )

    preds = {name: Prediction() for name in GROUP_NAMES}
    diag_logs: Dict[str, torch.Tensor] = {}
    context = batch["context"]
    target = batch["target"]
    target_image = target["image"]
    size = model.scaled_size(model.scale_factor, target_image.shape[-3:-1])
    gts = {
        "gaussian": None,
        "context": GroundTruth(image=context["image"]),
        "target_autoencoder": GroundTruth(image=target_image),
        "target_render_latent": GroundTruth(near=target["near"], far=target["far"]),
        "target_render_image": GroundTruth(
            image=model.rescale(target_image, model.scale_factor) if flags.target_render_image else None,
            near=target["near"], far=target["far"],
        ),
        "target_combined": GroundTruth(image=target_image, near=target["near"], far=target["far"]),
    }

    to_decode: Dict[str, torch.Tensor] = {}
    context_latents = None
    if flags.context or (cfg.encode_latents and flags.needs_render):
        posterior = sites.ae_encode(context["image"])
        preds["context"].posterior = posterior
        context_latents = posterior.sample(generator, noise.get("context_latent"))
        if flags.context:
            to_decode["context"] = context_latents
    if flags.target_autoencoder or flags.target_render_latent:
        posterior = sites.ae_encode(target_image)
        preds["target_autoencoder"].posterior = posterior
        target_latents = posterior.sample(generator, noise.get("target_latent"))
        if flags.target_autoencoder:
            to_decode["target_autoencoder"] = target_latents
        gts["target_render_latent"].image = target_latents

    if flags.needs_render:
        features = context_latents if cfg.encode_latents else None
        depth_noise = noise.get("depth")
        if depth_noise is None:
            depth_noise = torch.rand(
                model.depth_noise_shape(context, features), generator=generator, device=target_image.device
            )
        gaussians = sites.encode(context, step, depth_noise, features)
        # Divergence diagnostics: max-reductions over the predicted
        # Gaussians, kept on the device (no host read).
        with torch.no_grad():
            diag_logs["diag/max_world_scale"] = torch.sqrt(
                torch.diagonal(gaussians.covariances, dim1=-2, dim2=-1).max()
            )
            diag_logs["diag/max_opacity"] = gaussians.opacities.max()
            if gaussians.color_harmonics is not None:
                diag_logs["diag/max_abs_color_sh"] = gaussians.color_harmonics.abs().max()
            fh = gaussians.feature_harmonics
            if fh is not None:
                diag_logs["diag/max_abs_feature_mean"] = fh.mean.abs().max()
                if fh.logvar is not None:
                    diag_logs["diag/max_feature_logvar"] = fh.logvar.max()
        if flags.gaussian:
            preds["gaussian"] = Prediction(
                posterior=gaussians.feature_harmonics, harmonics=gaussians.color_harmonics
            )
        lowered = (
            gaussians.sample(generator, noise.get("gaussians"))
            if cfg.variational in ("gaussians", "none") else gaussians.flatten()
        )
        rendered = model.decoder(
            lowered, target["extrinsics"], target["intrinsics"], target["near"], target["far"], size,
        )
        preds["target_render_image"] = Prediction(image=rendered.color, depth=rendered.depth)
        posterior = rendered.feature_posterior
        latent_sample = posterior.sample(generator, noise.get("latent"))
        if flags.target_render_latent or flags.target_combined:
            z = model.rescale(latent_sample, Fraction(1, cfg.supersampling_factor))
            preds["target_render_latent"] = Prediction(image=z, posterior=posterior)
        if flags.target_combined:
            skip_z = None
            if model.autoencoder.expects_skip:
                skip_z = (
                    torch.cat([rendered.color.detach(), latent_sample], dim=-1)
                    if model.autoencoder.expects_skip_extra else latent_sample
                )
            preds["target_combined"] = Prediction(image=sites.ae_decode_remat(z, skip_z))

    if to_decode:
        for name, images in _decode_batched(sites.ae_decode, to_decode).items():
            preds[name].image = images

    for name in flags.gen_gan:
        preds[name].logits_fake = sites.discriminate(preds[name].image)

    logs: Dict[str, torch.Tensor] = {}
    for name, log_name in (
        ("context", "context"), ("target_autoencoder", "target_autoencoder"),
        ("target_render_image", "target_render"), ("target_combined", "target_combined"),
    ):
        if preds[name].image is not None and gts[name].image is not None:
            logs[f"train/{log_name}/psnr"] = compute_psnr(gts[name].image, preds[name].image).mean()
    logs.update(diag_logs)

    nll_total = torch.zeros((), device=target_image.device)
    group_nll = {}
    for name in GROUP_NAMES:
        if not flags[name]:
            continue
        total, group_logs = losses[name].nll_total(preds[name], gts[name], step, sites.lpips)
        logs.update(group_logs)
        group_nll[name] = total
        nll_total = nll_total + total

    gan_nll = [group_nll.get(name, torch.zeros(())) for name in flags.gen_gan]
    gan_g = []
    for name in flags.gen_gan:
        g_total, g_logs = losses[name].generator_total(preds[name], step)
        logs.update(g_logs)
        gan_g.append(g_total)
    fakes = {name: preds[name].image for name in flags.disc}
    return nll_total, gan_nll, gan_g, logs, fakes


def _grads(output: torch.Tensor, params: Dict[str, torch.Tensor], retain_graph: bool = False):
    """d output / d params by name, zeros where output does not depend on one."""
    names = list(params)
    if not output.requires_grad:
        return {n: torch.zeros_like(params[n]) for n in names}
    grads = torch.autograd.grad(
        output, [params[n] for n in names], retain_graph=retain_graph, allow_unused=True
    )
    return {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}


def generator_grads(
    state: TrainState, losses: Dict[str, LossGroup], flags: StepFlags, batch: dict, step: int,
    generator: Optional[torch.Generator] = None, noise: Optional[dict] = None, timer=None,
):
    """The generator's forward and backward: (gradients by parameter name,
    generator total, logs, fakes for the discriminator). Per GAN site, two
    probe backwards to the last layer give the adaptive weight w; the
    gradients and the total are of nll + sum(w * g)."""
    def stage(name):
        return timer(name) if timer is not None else nullcontext()

    params = dict(state.model.named_parameters())
    with stage("generator_forward"):
        nll, gan_nll, gan_g, logs, fakes = generator_forward(
            state, losses, flags, batch, step, generator, noise
        )
    with stage("generator_backward"):
        leaf = {"last": state.model.last_layer()}
        weights = []
        for nll_i, g_i in zip(gan_nll, gan_g):
            g_nll = _grads(nll_i, leaf, retain_graph=True)["last"]
            g_g = _grads(g_i, leaf, retain_graph=True)["last"]
            weights.append(adaptive_gan_weight(g_nll, g_g))
        gen_loss = nll + sum(w * g for w, g in zip(weights, gan_g))
        for name, w in zip(flags.gen_gan, weights):
            logs[f"{name}/adaptive_weight"] = w
        grads = _grads(gen_loss, params)
    return grads, gen_loss.detach(), logs, fakes


def discriminator_loss(
    state: TrainState, losses: Dict[str, LossGroup], flags: StepFlags, batch: dict, step: int,
    fakes: Dict[str, torch.Tensor],
) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The discriminator's loss on the detached fakes and the real images."""
    disc = make_sites(state).discriminate
    d_loss = torch.zeros((), device=batch["target"]["image"].device)
    logs: Dict[str, torch.Tensor] = {}
    for name in flags.disc:
        real = batch["context" if name == "context" else "target"]["image"]
        pred = Prediction(logits_fake=disc(fakes[name].detach()), logits_real=disc(real))
        group_total, group_logs = losses[name].discriminator_total(pred, step)
        d_loss = d_loss + group_total
        logs.update(group_logs)
    return d_loss, logs


def make_train_step(losses: Dict[str, LossGroup], skip_loss_spike_factor: Optional[float] = None):
    """Returns train_step(state, batch, step, generator=None, noise=None,
    timer=None) -> (state, logs); `timer(name)`, if given, is a context
    manager around the stages "generator_forward", "generator_backward",
    "generator_update" and "discriminator"."""
    if skip_loss_spike_factor is not None:
        raise ValueError("the reference has no loss-spike guard")

    def train_step(state: TrainState, batch: dict, step: int,
                   generator: Optional[torch.Generator] = None, noise: Optional[dict] = None,
                   timer=None):
        def stage(name):
            return timer(name) if timer is not None else nullcontext()

        flags = make_step_flags(losses, step)
        grads, gen_loss, logs, fakes = generator_grads(
            state, losses, flags, batch, step, generator, noise, timer
        )
        logs["generator/total"] = gen_loss
        # Pre-clip gradient norms, overall and per top-level module.
        logs["grad_norm/generator"] = global_norm(grads.values())
        for group in dict.fromkeys(n.split(".")[0] for n in grads):
            logs[f"grad_norm/{group}"] = global_norm(
                g for n, g in grads.items() if n.split(".")[0] == group
            )

        with stage("generator_update"):
            ok = torch.isfinite(gen_loss)
            state.opt_gen.step(grads, ok)
        del grads

        if flags.disc:
            with stage("discriminator"):
                d_loss, d_logs = discriminator_loss(state, losses, flags, batch, step, fakes)
                d_grads = _grads(d_loss, dict(state.discriminator.named_parameters()))
                d_loss = d_loss.detach()
                logs.update(d_logs)
                logs["discriminator/total"] = d_loss
                # Gated on the generator's ok too: when the generator's step
                # is skipped the discriminator does not train on.
                state.opt_disc.step(d_grads, torch.isfinite(d_loss) & ok)
        return state, {k: torch.as_tensor(v).detach() for k, v in logs.items()}

    return train_step
