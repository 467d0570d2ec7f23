"""The encoder's stages, forward plus backward, at the flagship train shape
(the port's counterpart of the repository's root bench_enc_stages.py):

    python -m latentsplat_tpu_torch.scripts.bench_enc_stages

The flagship re10k model at 256x256 with model.remat and
model.decoder.remat (weights from seed 0) on
`entry.arc_batch(2, 2, 4, 256, 256)`'s context views. Each stage runs
checkpointed, as under remat, and `torch.autograd.grad` of a scalar (its
output's sum) over its parameters and inputs is summed so that the whole
backward runs; the median of ITERS calls after one warm-up (host clock
between synchronizes):

  backbone_fwd_bwd              the DINO backbone on the 2 x 2 context images
  epipolar_sampler_fwd_bwd      the epipolar sampler on random features at 1/4
                                of the image side
  epipolar_transformer_fwd_bwd  the epipolar transformer (its sampler
                                included) on random backbone-resolution features
  encoder_full_fwd_bwd          the whole encoder (every Gaussian tensor's sum)

Prints "<stage>: <ms> ms" lines after the card's name and power limit.
Trailing key=value arguments override the config (tests pass a narrow
model). The command line runs on the card; `main(argv, device="cpu")` on
the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch
from torch.utils.checkpoint import checkpoint

from ..entry import arc_batch, flagship_model, to_tensors
from ..model.encoder.epipolar_sampler import sample_epipolar_features
from . import resolve_device
from .measure import device_name, gaussian_sum, grad_sum, timed_ms

ITERS = 3
SIZE = 256
BATCH = 2


def main(argv=None, device=None) -> dict:
    """Returns {stage: ms}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=SIZE)
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("overrides", nargs="*", help="config overrides key=value")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(device, "bench_enc_stages")
    size = args.size
    cfg, model = flagship_model(
        [f"dataset.image_shape=[{size},{size}]", "model.remat=true", "model.decoder.remat=true", *args.overrides],
        device,
    )
    model.train()
    ecfg = cfg.model.encoder
    ctx = to_tensors(arc_batch(BATCH, 2, 4, size, size), device)["context"]
    rng = torch.Generator(device=device).manual_seed(1)
    print(f"device: {device_name(device)}")
    encoder = model.encoder
    out = {}

    def report(name, fn):
        out[name] = timed_ms(fn, args.iters, device)
        print(f"{name}: {out[name]:.1f} ms", flush=True)

    backbone = encoder.backbone
    images = ctx["image"].reshape(BATCH * 2, size, size, 3)
    report("backbone_fwd_bwd", lambda _: grad_sum(
        checkpoint(backbone, images, use_reentrant=False).sum(), list(backbone.parameters())))

    def cameras():
        return ctx["extrinsics"], ctx["intrinsics"], ctx["near"], ctx["far"]

    quarter = torch.randn((BATCH, 2, size // 4, size // 4, ecfg.d_feature), generator=rng, device=device,
                          requires_grad=True)
    samples = ecfg.epipolar_transformer.num_samples
    report("epipolar_sampler_fwd_bwd", lambda _: grad_sum(checkpoint(
        lambda f: sample_epipolar_features(f, *cameras(), samples).features, quarter, use_reentrant=False,
    ).sum(), [quarter]))

    # The encoder hands the transformer backbone-resolution features: its own
    # strided convolution does the 4x downscale.
    transformer = encoder.epipolar_transformer
    full = torch.randn((BATCH, 2, size, size, ecfg.d_feature), generator=rng, device=device, requires_grad=True)
    report("epipolar_transformer_fwd_bwd", lambda _: grad_sum(checkpoint(
        lambda f: transformer(f, *cameras())[0], full, use_reentrant=False,
    ).sum(), [*transformer.parameters(), full]))

    # The depth uniforms are drawn before the checkpoint, as the train step
    # draws them, so that its recomputation samples the same depths.
    depth_noise = torch.rand(model.depth_noise_shape(ctx), generator=rng, device=device)

    report("encoder_full_fwd_bwd", lambda _: grad_sum(gaussian_sum(checkpoint(
        lambda c: encoder(c, 0, deterministic=False, depth_noise=depth_noise), ctx, use_reentrant=False,
    )), list(model.parameters())))
    return out


if __name__ == "__main__":
    main()
