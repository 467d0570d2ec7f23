"""The train step's components, forward plus backward, each alone at the
`bench_train --full --batch 2` shapes (the port's counterpart of the
repository's root bench_train_stages.py):

    python -m latentsplat_tpu_torch.scripts.bench_train_stages [--component NAME]

The flagship re10k model at 256x256 with model.remat and model.decoder.remat,
its PatchGAN and LPIPS (weights from seed 0), on
`entry.arc_batch(2, 2, 4, 256, 256)`. Each component runs through the
step's own module calls (`training.step.make_sites`: remat and compute
dtypes as the step runs them); "forward plus grad" is
`torch.autograd.grad` of a scalar, whose gradients are summed so that the
whole backward runs; the median of ITERS calls after one warm-up (host
clock between synchronizes):

  encoder_fwd_bwd           the encoder, grad over the generator's parameters
  render_fwd                the splatting decoder over the 2 x 4 target
                            views of the encoder's sampled Gaussians
  render_fwd_bwd            the same, grad over the five Gaussian tensors
  vae_decode_fwd_bwd        the f8 VAE decode with its skip input, grad over
                            the parameters and the latents
  lpips_one_site_fwd_bwd    LPIPS on 8 images, grad over the prediction (the
                            step runs two such sites)
  disc_gen_side_fwd_bwd     the PatchGAN's generator loss, grad over the fakes
  disc_update_side_fwd_bwd  the hinge loss on fakes and reals, grad over the
                            discriminator's parameters

Prints "<component>: <ms> ms" lines after the card's name and power limit,
then ONE JSON line, metric train_stages_256px_b2, also written to
outputs/bench/ (--out-dir) when every component ran. Trailing key=value
arguments override the config (tests pass a narrow model). The command line
runs on the card; `main(argv, device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from ..model.latentsplat import discriminate
from ..model.types import Gaussians
from ..training.step import make_sites
from . import resolve_device
from .measure import OBJECTIVE, RECORD_DIR, device_name, gaussian_sum, grad_sum, timed_ms, train_setup

ITERS = 3
SIZE = 256
BATCH = 2
V_TARGET = 4
COMPONENTS = ("encoder", "render", "vae", "lpips", "disc")


def main(argv=None, device=None) -> dict:
    """Returns {component: ms}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--component", choices=COMPONENTS)
    parser.add_argument("--size", type=int, default=SIZE)
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("--out-dir", type=Path, default=RECORD_DIR)
    parser.add_argument("overrides", nargs="*", help="config overrides key=value")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(device, "bench_train_stages")
    size, only = args.size, args.component
    overrides = [f"dataset.image_shape=[{size},{size}]", "model.remat=true", "model.decoder.remat=true", *OBJECTIVE,
                 *args.overrides]
    _, state, _, _, batch = train_setup(overrides, BATCH, size, device)
    model, sites = state.model, make_sites(state)
    rng = torch.Generator(device=device).manual_seed(1)
    params = [p for p in model.parameters() if p.requires_grad]
    print(f"device: {device_name(device)}")
    out = {}

    def report(name, fn):
        out[name] = timed_ms(fn, args.iters, device)
        print(f"{name}: {out[name]:.1f} ms", flush=True)

    context, target = batch["context"], batch["target"]
    depth_noise = torch.rand(model.depth_noise_shape(context), generator=rng, device=device)

    if only in (None, "encoder"):
        report("encoder_fwd_bwd", lambda _: grad_sum(gaussian_sum(sites.encode(context, 0, depth_noise, None)),
                                                     params))

    if only in (None, "render"):
        with torch.no_grad():
            sampled = sites.encode(context, 0, depth_noise, None).sample(rng)
        leaves = [t.detach().requires_grad_(True) for t in (
            sampled.means, sampled.covariances, sampled.opacities, sampled.color_harmonics,
            sampled.feature_harmonics)]
        render_size = model.scaled_size(model.scale_factor, (size, size))

        def render_sum():
            rendered = model.decoder(Gaussians(*leaves), target["extrinsics"], target["intrinsics"], target["near"],
                                     target["far"], render_size)
            return (rendered.color.sum() + rendered.feature_posterior.mean.sum() + rendered.mask.sum()
                    + rendered.depth.sum())

        def render_fwd(_):
            with torch.no_grad():
                return float(render_sum())

        report("render_fwd", render_fwd)
        report("render_fwd_bwd", lambda _: grad_sum(render_sum(), leaves))

    if only in (None, "vae"):
        ae = model.autoencoder
        hz = size // ae.downscale_factor
        z = torch.randn((BATCH * V_TARGET, hz, hz, ae.d_latent), generator=rng, device=device, requires_grad=True)
        skip = (torch.randn((BATCH * V_TARGET, size, size, 3 + ae.d_latent), generator=rng, device=device)
                if ae.expects_skip_extra else None)
        ae_params = list(ae.parameters())
        report("vae_decode_fwd_bwd", lambda _: grad_sum(sites.ae_decode_remat(z, skip).sum(), [*ae_params, z]))

    if only in (None, "lpips"):
        pred = torch.rand((BATCH * V_TARGET, size, size, 3), generator=rng, device=device, requires_grad=True)
        tgt = torch.rand((BATCH * V_TARGET, size, size, 3), generator=rng, device=device)
        report("lpips_one_site_fwd_bwd", lambda _: grad_sum(sites.lpips(pred, tgt).sum(), [pred]))

    if only in (None, "disc"):
        fakes = torch.rand((BATCH, V_TARGET, size, size, 3), generator=rng, device=device, requires_grad=True)
        reals = torch.rand((BATCH, V_TARGET, size, size, 3), generator=rng, device=device)
        disc = state.discriminator
        report("disc_gen_side_fwd_bwd", lambda _: grad_sum(-sites.discriminate(fakes).mean(), [fakes]))

        def disc_side():
            fake, real = discriminate(disc, fakes.detach()), discriminate(disc, reals)
            return torch.relu(1.0 + fake).mean() + torch.relu(1.0 - real).mean()

        report("disc_update_side_fwd_bwd", lambda _: grad_sum(disc_side(), list(disc.parameters())))

    record = {
        "metric": f"train_stages_{size}px_b{BATCH}",
        "unit": "ms (median forward + grad of each component alone)",
        "components_ms": out,
        "device": device_name(device),
        "note": "the component sum is not the fused step's time: the step adds the adaptive-GAN probes, the "
                "optimizer updates and the loss reductions, and runs LPIPS at two sites",
    }
    print(json.dumps(record))
    if only is None:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        (args.out_dir / f"train_stages_{size}px_b{BATCH}.json").write_text(
            json.dumps({**record, "measured_unix": int(time.time())}, indent=1))
    return out


if __name__ == "__main__":
    main()
