"""LatentSplat: the assembled generator and its serving entry point
(counterpart of latentsplat_tpu/model/latentsplat.py plus the test-mode
render path `Trainer._render_full` in latentsplat_tpu/training/trainer.py).

`render_full` takes a batch dict in the JAX layout (NHWC images, (b, v, ...)
cameras) and returns {"image", "render", "depth"}:
data shims -> encoder -> Gaussian sample -> splatting decoder -> feature
posterior sample -> 1/supersampling antialiased resize -> VAE decode with
skip connections.
"""

from __future__ import annotations

from contextlib import nullcontext
from fractions import Fraction
from typing import Optional

import torch
from torch import nn

from ..dataset.shims import apply_bounds_shim, apply_patch_shim
from ..ops.resize import resize_antialias
from .autoencoder.kl import AutoencoderKL
from .decoder.splatting import DecoderSplatting
from .encoder.backbone import get_integer
from .encoder.encoder_epipolar import EncoderEpipolar


class LatentSplat(nn.Module):
    """Generator bundle; `cfg` is a config.ModelCfg. Discriminator and LPIPS
    belong to training and are not part of this module."""

    def __init__(self, cfg, background_color=(0.0, 0.0, 0.0)):
        super().__init__()
        if cfg.encode_latents:
            raise NotImplementedError("encode_latents needs the VAE encoder, not ported yet")
        if cfg.autoencoder.name != "kl":
            raise NotImplementedError(f"autoencoder {cfg.autoencoder.name!r} is not ported")
        self.cfg = cfg
        self.autoencoder = AutoencoderKL(cfg.autoencoder, d_in=3, d_skip_extra=3)
        self.encoder = EncoderEpipolar(
            cfg.encoder,
            d_in=3,
            n_feature_channels=self.autoencoder.d_latent,
            scale_factor=self.scale_factor,
            variational=cfg.variational != "none",
        )
        self.decoder = DecoderSplatting(cfg.decoder, background_color, cfg.variational == "latents")
        enc = cfg.encoder
        self.patch_multiple = enc.epipolar_transformer.self_attention.patch_size * (
            enc.epipolar_transformer.downscale
        )

    @property
    def scale_factor(self) -> Fraction:
        return Fraction(self.cfg.supersampling_factor, self.autoencoder.downscale_factor)

    def data_shim(self, batch: dict) -> dict:
        """Patch + bounds shims (near disparity scaled to pixels)."""
        batch = apply_patch_shim(batch, self.patch_multiple)
        if self.cfg.encoder.apply_bounds_shim:
            h, w = batch["context"]["image"].shape[-3:-1]
            batch = apply_bounds_shim(batch, self.cfg.encoder.near_disparity * min(h, w), 0.5)
        return batch


def render_full(
    model: LatentSplat,
    batch: dict,
    deterministic: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[dict] = None,
    timer=None,
) -> dict:
    """Serve one batch: {"context": views, "target": views} ->
    {"image" (b, v, H, W, 3), "render" (b, v, h, w, 3), "depth" (b, v, h, w)}.

    In probabilistic mode randomness comes from `generator`, or from
    `noise` = {"depth": uniform (b, v, r, srf, spp), "gaussians": normal like
    the feature-SH mean, "latent": normal (b, v, h, w, c)}. `timer`, if
    given, is a context-manager factory called with the stage name
    ("encoder", "decoder", "autoencoder_decoder").
    """
    noise = noise or {}

    def stage(name):
        return timer(name) if timer is not None else nullcontext()

    with torch.no_grad():
        batch = model.data_shim(batch)
        target = batch["target"]
        with stage("encoder"):
            gaussians = model.encoder(
                batch["context"], 0, deterministic=deterministic, generator=generator,
                depth_noise=noise.get("depth"),
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
    }

