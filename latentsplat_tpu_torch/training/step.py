"""The fused generator + discriminator training step (counterpart of
latentsplat_tpu/training/step.py).

`make_train_step(losses, ...)` returns `train_step(state, batch, step,
generator=None, noise=None) -> (state, logs)`:
  * the generator forward of every active supervision site: the VAE
    encoder on the context images (the `context` site, or the encoder's
    input under `encode_latents`) and on the target images (the
    `target_autoencoder` site, and the ground truth of
    `target_render_latent`), one batched VAE decode of those latents;
    encoder -> Gaussian sample (or, with `variational: latents`, the mean
    and logvar packed) -> splatting render -> feature posterior sample ->
    VAE decode with skips -> losses, plus discriminator logits of the
    generator's images where a generator loss is active;
  * per GAN site, two probe backwards to the VAE's last layer for the
    adaptive weight, then one backward of nll + sum(w * g);
  * a NaN guard and the optional bounded loss-spike guard;
  * the generator update, then the discriminator's loss on the detached
    fakes and its update, gated on the generator's `ok`.
The batch is the JAX layout (NHWC images, (b, v, ...) cameras) after the
data shims, as the JAX step takes it. `reduce` makes the step's reductions
over the global batch: the identity (`LocalReduce`) in one process, and
collectives across the ranks of a data-parallel group
(`parallel.mesh.RankReduce`): the probe gradients before the adaptive
weight, the gradients, the losses the guards decide on, and the logs. Randomness comes from `generator` or
from `noise` = {"depth", "gaussians", "latent", "context_latent",
"target_latent"} (see `render_full`); the depth samples are drawn before
the encoder runs, so a recomputation under remat sees the same ones.

`model.remat` checkpoints the encoder, the target_combined VAE decode up to
its last layer (the adaptive weight's anchor, so that the probes never
recompute the decoder and leave no recomputed activation to the final
backward) and LPIPS (`torch.utils.checkpoint`, non-reentrant) under
`model.remat_policy`:
"nothing" (recompute everything), "dots" (keep the outputs of
convolutions, matmuls and attention, recompute the rest) or per site
"encoder:full|dots|off,vae:...,lpips:...". `decoder.remat` checkpoints each
view's render (`ops.rasterize.api.render`). `model.compute_dtype`
"bfloat16", or per site "encoder:bfloat16,vae:bfloat16,lpips:bfloat16,
disc:bfloat16", runs those modules with bfloat16 copies of their
parameters and float inputs (the encoder's cameras stay float32) and
returns float32; an op whose inputs mix the two computes in float32, as
jax.numpy and flax promote. The rasterizer, sampling and the loss
reductions stay float32. The JAX step's `rasterizer/pairs_dropped` log is
left out (the port sizes its pair buffer exactly and drops nothing).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from ..evaluation.metrics import compute_psnr
from ..loss.losses import LossGroup, adaptive_gan_weight
from ..misc.profiler import span
from ..model.latentsplat import LatentSplat, discriminate
from ..model.types import GroundTruth, Prediction
from .optim import ChainedAdam, global_norm

GROUP_NAMES = (
    "gaussian",
    "context",
    "target_autoencoder",
    "target_render_latent",
    "target_render_image",
    "target_combined",
)
GAN_GROUPS = ("context", "target_autoencoder", "target_combined")
REMAT_SITES = ("encoder", "vae", "lpips")
MIXED_SITES = ("encoder", "vae", "lpips", "disc")


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


class LocalReduce:
    """The train step's reductions over the global batch when this process
    holds all of it: each is the identity."""

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's value of a loss or gradient that is a mean
        over this process's rows."""
        return x

    def mean_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return grads

    def logs(self, logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The global batch's logs: means of means, maxima of `diag/max_*`."""
        return logs


@dataclass
class TrainState:
    model: LatentSplat
    discriminator: Optional[nn.Module]
    lpips: nn.Module                   # frozen
    opt_gen: ChainedAdam
    opt_disc: Optional[ChainedAdam]
    # Spike guard (only with skip_loss_spike_factor): EMA of |generator
    # total| and the count of consecutive skips, float and int32 scalars.
    gen_loss_ema: Optional[torch.Tensor] = None
    spike_skip_count: Optional[torch.Tensor] = None


# -- remat ------------------------------------------------------------------------


def _site_modes(policy: str, sites: tuple, switch: str, modes: tuple) -> Dict[str, str]:
    """Parse a comma list "site:mode,..." into {site: mode}, raising on
    anything else."""
    out = {}
    for part in policy.split(","):
        site, sep, mode = part.strip().partition(":")
        if not sep or site not in sites or mode not in modes:
            raise ValueError(
                f"{switch}={policy!r}: expected a global value or a comma list of "
                f"site:mode with sites {sites} and modes {modes}"
            )
        out[site] = mode
    return out


def remat_mode(cfg, site: str) -> str:
    """"full", "dots" or "off" for `site` under cfg.remat_policy (global
    "nothing" | "dots", or per site; an unnamed site recomputes fully)."""
    policy = str(cfg.remat_policy)
    if policy in ("nothing", "dots"):
        return "full" if policy == "nothing" else "dots"
    return _site_modes(policy, REMAT_SITES, "model.remat_policy", ("full", "dots", "off")).get(site, "full")


@functools.cache
def _saveable_ops() -> frozenset:
    """The ops whose outputs the "dots" policy keeps: convolutions, matmuls
    and attention (the JAX policy keeps dot_general and conv outputs)."""
    aten = torch.ops.aten
    names = (
        "convolution", "mm", "addmm", "bmm", "_scaled_dot_product_efficient_attention",
        "_scaled_dot_product_flash_attention", "_scaled_dot_product_cudnn_attention",
        "_scaled_dot_product_flash_attention_for_cpu",
    )
    return frozenset(getattr(aten, n).default for n in names if hasattr(aten, n))


class _KeepDots(TorchDispatchMode):
    """The forward of a "dots" checkpoint: keeps the saveable ops' outputs."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _saveable_ops():
            self.kept.append(tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, out))
        return out


class _ReuseDots(TorchDispatchMode):
    """A recomputation of a "dots" checkpoint: the saveable ops return the
    kept outputs, in order; everything else runs again. Unlike
    torch.utils.checkpoint's selective checkpoint, which gives each kept
    output up after one backward, this serves every backward of the step
    (the adaptive weight's probes and the final one)."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept = kept
        self.index = 0

    def __enter__(self):
        self.index = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _saveable_ops():
            return func(*args, **(kwargs or {}))
        out = self.kept[self.index]
        self.index += 1
        return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, out)


def _dots_contexts():
    kept: list = []
    return _KeepDots(kept), _ReuseDots(kept)


def _remat(fn: Callable, cfg, site: str) -> Callable:
    """`fn` under a non-reentrant checkpoint in the site's mode."""
    mode = remat_mode(cfg, site)
    if mode == "off":
        return fn
    kwargs = {"use_reentrant": False}
    if mode == "dots":
        kwargs["context_fn"] = _dots_contexts

    def wrapped(*args):
        return checkpoint(fn, *args, **kwargs)

    return wrapped


# -- bfloat16 compute -------------------------------------------------------------


def mixed_site(cfg, site: str) -> bool:
    """True when `site` computes in bfloat16 under cfg.compute_dtype (global
    "float32" | "bfloat16", or per site "vae:bfloat16,...")."""
    policy = str(cfg.compute_dtype)
    if policy in ("float32", "bfloat16"):
        return policy == "bfloat16"
    return _site_modes(policy, MIXED_SITES, "model.compute_dtype", ("bfloat16", "float32")).get(site) == "bfloat16"


def check_switches(cfg) -> None:
    """Raise, naming the switch, on a remat_policy or compute_dtype that
    does not parse."""
    remat_mode(cfg, "encoder")
    mixed_site(cfg, "encoder")


def _cast_floats(tree, dtype: torch.dtype):
    """Every float tensor of `tree` (dicts, lists, tuples and dataclasses
    such as DiagonalGaussian) cast to `dtype`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = copy.copy(tree)   # no __post_init__: a posterior's logvar is already clamped
        for f in dataclasses.fields(tree):
            setattr(out, f.name, _cast_floats(getattr(tree, f.name), dtype))
        return out
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    return tree


# The ops that take one float dtype only; under _PromoteFloats they compute
# in their inputs' promoted dtype, as jax.numpy and flax layers do.
_ONE_DTYPE_OPS = frozenset({
    F.linear, F.conv2d, F.conv_transpose2d, F.grid_sample, F.layer_norm, F.group_norm,
    F.batch_norm, F.scaled_dot_product_attention, torch.matmul, torch.Tensor.matmul,
    torch.Tensor.__matmul__, torch.einsum, torch.bmm, torch.baddbmm, torch.addmm,
})


class _PromoteFloats(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _ONE_DTYPE_OPS:
            dtypes = set()
            tree_map(lambda t: dtypes.add(t.dtype) if isinstance(t, torch.Tensor) and t.is_floating_point() else None,
                     (args, kwargs))
            if len(dtypes) > 1:
                dtype = functools.reduce(torch.promote_types, dtypes)
                args, kwargs = _cast_floats((args, kwargs), dtype)
        return func(*args, **kwargs)


class _Method(nn.Module):
    """Calls `module.<name>` as its forward, for torch.func.functional_call."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.module = module
        self.name = name

    def forward(self, *args, **kwargs):
        return getattr(self.module, self.name)(*args, **kwargs)


def _bf16(module: nn.Module, name: str = "forward", cast_args: bool = True) -> Callable:
    """`module.<name>` with bfloat16 copies of the module's parameters (the
    float32 masters get their gradients through the casts), float inputs
    cast when `cast_args`, and float32 outputs."""
    method = _Method(module, name)

    def wrapped(*args, **kwargs):
        params = {f"module.{n}": p.to(torch.bfloat16) for n, p in module.named_parameters()}
        if cast_args:
            args, kwargs = _cast_floats((args, kwargs), torch.bfloat16)
        with _PromoteFloats():
            out = torch.func.functional_call(method, params, args, kwargs)
        return _cast_floats(out, torch.float32)

    return wrapped


@dataclass
class Sites:
    """The step's module calls, each under its remat and compute-dtype
    switches: encode(context, step, depth_noise, features), ae_encode(images),
    ae_decode(z, skip_z), ae_decode_remat (the target_combined decode),
    discriminate(images) and lpips(pred, target)."""

    encode: Callable
    ae_encode: Callable
    ae_decode: Callable
    ae_decode_remat: Callable
    discriminate: Optional[Callable]
    lpips: Callable


def make_sites(state: TrainState) -> Sites:
    model = state.model
    cfg = model.cfg
    check_switches(cfg)
    ae = model.autoencoder

    def encode(context, step, depth_noise, features):
        return model.encoder(context, step, deterministic=False, depth_noise=depth_noise, features=features)

    ae_encode, ae_decode = ae.encode, ae.decode
    ae_hidden, ae_out = ae.decode_hidden, ae.decode_out
    lpips = state.lpips
    disc = functools.partial(discriminate, state.discriminator) if state.discriminator is not None else None
    if mixed_site(cfg, "encoder"):
        # Parameters and image / features only: epipolar sample positions
        # lose ~3 digits in bfloat16, so the cameras stay float32.
        encoder_bf16 = _bf16(model.encoder, cast_args=False)

        def encode(context, step, depth_noise, features):
            context = dict(context, image=context["image"].to(torch.bfloat16))
            if features is not None:
                features = features.to(torch.bfloat16)
            return encoder_bf16(context, step, deterministic=False, depth_noise=depth_noise, features=features)
    if mixed_site(cfg, "vae"):
        ae_encode, ae_decode = _bf16(ae, "encode"), _bf16(ae, "decode")
        ae_hidden, ae_out = _bf16(ae, "decode_hidden"), _bf16(ae, "decode_out")
    if mixed_site(cfg, "lpips"):
        lpips = _bf16(state.lpips)
    if disc is not None and mixed_site(cfg, "disc"):
        disc_bf16 = _bf16(state.discriminator)

        def disc(images):
            return discriminate(disc_bf16, images)
    ae_decode_remat = ae_decode
    if cfg.remat:
        encode = _remat(encode, cfg, "encoder")
        lpips = _remat(lpips, cfg, "lpips")
        if remat_mode(cfg, "vae") != "off":
            # The checkpoint ends before the last layer, the adaptive
            # weight's anchor: the probes' backwards stop at that layer and
            # never recompute the decoder.
            hidden = _remat(ae_hidden, cfg, "vae")

            def ae_decode_remat(z, skip_z):
                return ae_out(hidden(z, skip_z), z.shape[:-3])
    return Sites(encode, ae_encode, ae_decode, ae_decode_remat, disc, lpips)


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
    reduce: Optional[LocalReduce] = None,
):
    """The generator's forward and backward: (gradients by parameter name,
    generator total, logs, fakes for the discriminator). Per GAN site, two
    probe backwards to the last layer give the adaptive weight w (from the
    global batch's probes under `reduce`); the gradients and the total are
    this process's, of nll + sum(w * g); the logs are the global batch's."""
    reduce = reduce or LocalReduce()
    params = dict(state.model.named_parameters())
    with span("generator_forward", timer):
        nll, gan_nll, gan_g, logs, fakes = generator_forward(
            state, losses, flags, batch, step, generator, noise
        )
        logs = reduce.logs(logs)
    with span("generator_backward", timer):
        leaf = {"last": state.model.last_layer()}
        weights = []
        for nll_i, g_i in zip(gan_nll, gan_g):
            g_nll = _grads(nll_i, leaf, retain_graph=True)["last"]
            g_g = _grads(g_i, leaf, retain_graph=True)["last"]
            weights.append(adaptive_gan_weight(reduce.mean(g_nll), reduce.mean(g_g)))
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


def make_train_step(
    losses: Dict[str, LossGroup],
    skip_loss_spike_factor: Optional[float] = None,
    skip_loss_spike_patience: int = 10,
    reduce: Optional[LocalReduce] = None,
):
    """Returns train_step(state, batch, step, generator=None, noise=None,
    timer=None) -> (state, logs), a call the root span `train_step`;
    `timer(name)`, if given, is a context manager around the stages
    "generator_forward", "generator_backward", "generator_update" and
    "discriminator", inside each stage's span. Under `reduce` the gradients
    are averaged over the global batch before the norms and the update, and
    the guards and the discriminator's gate read the global losses, so that
    every rank takes the same branch."""
    reduce = reduce or LocalReduce()

    def train_step(state: TrainState, batch: dict, step: int,
                   generator: Optional[torch.Generator] = None, noise: Optional[dict] = None,
                   timer=None):
        with span("train_step", interval=False):
            return _train_step(state, batch, step, generator, noise, timer)

    def _train_step(state, batch, step, generator, noise, timer):
        flags = make_step_flags(losses, step)
        grads, gen_loss, logs, fakes = generator_grads(
            state, losses, flags, batch, step, generator, noise, timer, reduce
        )
        grads = reduce.mean_grads(grads)
        gen_loss = reduce.mean(gen_loss)
        logs["generator/total"] = gen_loss
        # Pre-clip gradient norms, overall and per top-level module.
        logs["grad_norm/generator"] = global_norm(grads.values())
        for group in dict.fromkeys(n.split(".")[0] for n in grads):
            logs[f"grad_norm/{group}"] = global_norm(
                g for n, g in grads.items() if n.split(".")[0] == group
            )

        with span("generator_update", timer):
            finite = torch.isfinite(gen_loss)
            ok = finite
            if skip_loss_spike_factor is not None:
                if state.gen_loss_ema is None or state.spike_skip_count is None:
                    raise ValueError("skip_loss_spike_factor needs TrainState.gen_loss_ema and .spike_skip_count")
                ema, count = state.gen_loss_ema, state.spike_skip_count
                mag = gen_loss.abs()
                initialized = ema > 0.0
                over = initialized & (mag > skip_loss_spike_factor * ema)
                # The patience-th consecutive over-threshold step is accepted.
                force = over & (count + 1 >= skip_loss_spike_patience)
                spike = over & ~force
                ok = finite & ~spike
                state.spike_skip_count = torch.where(spike, count + 1, torch.zeros_like(count))
                seeded = torch.where(initialized, 0.99 * ema + 0.01 * mag, mag.clamp(min=1e-8))
                state.gen_loss_ema = torch.where(ok, torch.where(force, mag, seeded), ema)
                logs["optimizer/loss_spike_skipped"] = spike.float()
                logs["optimizer/loss_spike_forced"] = force.float()
            state.opt_gen.step(grads, ok)
        del grads

        if flags.disc:
            with span("discriminator", timer):
                d_loss, d_logs = discriminator_loss(state, losses, flags, batch, step, fakes)
                d_grads = reduce.mean_grads(_grads(d_loss, dict(state.discriminator.named_parameters())))
                d_loss = reduce.mean(d_loss.detach())
                logs.update(reduce.logs(d_logs))
                logs["discriminator/total"] = d_loss
                # Gated on the generator's ok too: when the generator's step
                # is skipped the discriminator does not train on.
                state.opt_disc.step(d_grads, torch.isfinite(d_loss) & ok)
        return state, {k: torch.as_tensor(v).detach() for k, v in logs.items()}

    return train_step
