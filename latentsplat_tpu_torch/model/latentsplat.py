"""LatentSplat: the assembled generator, its serving entry point and the
helpers the train step needs (counterpart of
latentsplat_tpu/model/latentsplat.py plus the test-mode render path
`Trainer._render_full` in latentsplat_tpu/training/trainer.py).

`render_full` takes a batch dict in the JAX layout (NHWC images, (b, v, ...)
cameras) and returns {"image", "render", "depth", ...}:
data shims -> (with `encode_latents`, the VAE encoder's latents of the
context images) -> encoder -> Gaussian sample -> splatting decoder ->
feature posterior sample -> 1/supersampling antialiased resize -> VAE
decode with skip connections.
"""

from __future__ import annotations

from contextlib import nullcontext
from fractions import Fraction
from typing import Optional

import torch
from torch import nn

from ..dataset.shims import apply_bounds_shim, apply_patch_shim
from ..misc.fraction_utils import get_integer
from ..ops.resize import resize_antialias
from .autoencoder.identity import AutoencoderId
from .autoencoder.kl import AutoencoderKL
from .decoder.splatting import DecoderSplatting
from .encoder.encoder_epipolar import EncoderEpipolar


class LatentSplat(nn.Module):
    """Generator bundle; `cfg` is a config.ModelCfg. The discriminator and
    LPIPS are separate modules (see `training.step.TrainState`)."""

    def __init__(self, cfg, background_color=(0.0, 0.0, 0.0)):
        super().__init__()
        self.cfg = cfg
        if cfg.autoencoder.name == "kl":
            self.autoencoder = AutoencoderKL(cfg.autoencoder, d_in=3, d_skip_extra=3)
        elif cfg.autoencoder.name == "id":
            self.autoencoder = AutoencoderId(cfg.autoencoder, d_in=3)
        else:
            raise NotImplementedError(f"autoencoder {cfg.autoencoder.name!r} is not ported")
        # Under encode_latents the encoder consumes the VAE's latents, at
        # 1 / downscale of the image grid.
        downscale = self.autoencoder.downscale_factor if cfg.encode_latents else 1
        self.encoder = EncoderEpipolar(
            cfg.encoder,
            d_in=self.autoencoder.d_latent if cfg.encode_latents else 3,
            n_feature_channels=self.autoencoder.d_latent,
            scale_factor=Fraction(cfg.supersampling_factor, 1 if cfg.encode_latents else self.autoencoder.downscale_factor),
            variational=cfg.variational != "none",
            input_downscale=downscale,
        )
        self.decoder = DecoderSplatting(cfg.decoder, background_color, cfg.variational == "latents")
        enc = cfg.encoder
        self.patch_multiple = enc.epipolar_transformer.self_attention.patch_size * (
            enc.epipolar_transformer.downscale
        )

    @property
    def scale_factor(self) -> Fraction:
        return Fraction(self.cfg.supersampling_factor, self.autoencoder.downscale_factor)

    @staticmethod
    def scaled_size(scale: Fraction, size) -> tuple[int, ...]:
        return tuple(get_integer(scale * s) for s in size)

    @staticmethod
    def rescale(x: torch.Tensor, scale: Fraction) -> torch.Tensor:
        """Antialiased NHWC resize by an exact rational factor."""
        return resize_antialias(x, LatentSplat.scaled_size(scale, x.shape[-3:-1]))

    def last_layer(self) -> nn.Parameter:
        """The adaptive GAN weight's anchor: the autoencoder's (the VAE
        decoder's conv_out weight), or the encoder's to_gaussians weight when
        the autoencoder has none."""
        last = self.autoencoder.last_layer()
        return self.encoder.to_gaussians.weight if last is None else last

    def depth_noise_shape(self, context: dict, features: Optional[torch.Tensor] = None) -> tuple[int, ...]:
        """Shape of the encoder's depth-sample uniforms, (b, v, rays,
        surfaces, gaussians per pixel), for images or latents `features`."""
        b, v = context["image"].shape[:2]
        grid = (context["image"] if features is None else features).shape[-3:-1]
        h, w = self.scaled_size(self.encoder.scale_factor, grid)
        enc = self.cfg.encoder
        return (b, v, h * w, enc.num_surfaces, enc.gaussians_per_pixel)

    def data_shim(self, batch: dict) -> dict:
        """Patch + bounds shims (near disparity scaled to pixels)."""
        batch = apply_patch_shim(batch, self.patch_multiple)
        if self.cfg.encoder.apply_bounds_shim:
            h, w = batch["context"]["image"].shape[-3:-1]
            batch = apply_bounds_shim(batch, self.cfg.encoder.near_disparity * min(h, w), 0.5)
        return batch


def discriminate(discriminator: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """(b, v, h, w, c) images -> (b, v, h', w', 1) patch logits."""
    b, v = images.shape[:2]
    logits = discriminator(images.reshape(b * v, *images.shape[2:]))
    return logits.reshape(b, v, *logits.shape[1:])


def render_full(
    model: LatentSplat,
    batch: dict,
    deterministic: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[dict] = None,
    timer=None,
) -> dict:
    """Serve one batch: {"context": views, "target": views} ->
    {"image" (b, v, H, W, 3), "render" (b, v, h, w, 3), "depth" (b, v, h, w),
    "num_pairs", "target_shim" (the target images after the data shims)}.

    In probabilistic mode randomness comes from `generator`, or from
    `noise` = {"depth": uniform (b, v, r, srf, spp), "gaussians": normal like
    the feature-SH mean, "latent": normal (b, v, h, w, c), "context_latent":
    normal like the context latents (`encode_latents`)}. `timer`, if given,
    is a context-manager factory called with the stage name
    ("autoencoder_encoder" under `encode_latents`, "encoder", "decoder",
    "autoencoder_decoder").
    """
    noise = noise or {}

    def stage(name):
        return timer(name) if timer is not None else nullcontext()

    with torch.no_grad():
        batch = model.data_shim(batch)
        target = batch["target"]
        features = None
        if model.cfg.encode_latents:
            with stage("autoencoder_encoder"):
                posterior = model.autoencoder.encode(batch["context"]["image"])
                features = (
                    posterior.mode() if deterministic
                    else posterior.sample(generator, noise.get("context_latent"))
                )
        with stage("encoder"):
            gaussians = model.encoder(
                batch["context"], 0, deterministic=deterministic, generator=generator,
                depth_noise=noise.get("depth"), features=features,
            )
            lowered = (
                gaussians.mode() if deterministic
                else gaussians.sample(generator, noise.get("gaussians"))
            )
        size = tuple(get_integer(model.scale_factor * s) for s in target["image"].shape[-3:-1])
        with stage("decoder"):
            rendered = model.decoder(
                lowered, target["extrinsics"], target["intrinsics"],
                target["near"], target["far"], size,
            )
        with stage("autoencoder_decoder"):
            posterior = rendered.feature_posterior
            latent = (
                posterior.mode() if deterministic
                else posterior.sample(generator, noise.get("latent"))
            )
            z_size = tuple(
                get_integer(Fraction(1, model.cfg.supersampling_factor) * s)
                for s in latent.shape[-3:-1]
            )
            z = resize_antialias(latent, z_size)
            skip_z = None
            if model.autoencoder.expects_skip:
                skip_z = (
                    torch.cat([rendered.color, latent], dim=-1)
                    if model.autoencoder.expects_skip_extra else latent
                )
            image = model.autoencoder.decode(z, skip_z)
    return {
        "image": image,
        "render": rendered.color,
        "depth": rendered.depth,
        "num_pairs": rendered.num_pairs,
        "target_shim": target["image"],
    }

