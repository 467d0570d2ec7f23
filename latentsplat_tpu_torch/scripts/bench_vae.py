"""Where the VAE decode's time goes: the published kl_f8 decoder with skips
on the video cell's decode (30 views at 256x256, latents at 32x32), timed
and traced:

    python -m latentsplat_tpu_torch.scripts.bench_vae [--views 30] [--iters 10] [--backward]
        [--dtype bfloat16] [--out DIR]

The decode: random weights from the seed, one warm-up call, then --iters
calls each timed with CUDA events (the median ms), the peak of the card's
allocated memory over one more call, then one call under torch.profiler:
the device ms by kernel name (the top 15), the ms of cuDNN's layout
transposes (names holding `nchwToNhwc` or `nhwcToNchw`), the ms of
torch's elementwise kernels (names holding `elementwise_kernel`: bias
adds, sums, copies, casts), the count of torch's `aten::add_` and
`aten::add` calls (a convolution's bias add is an `add_`; the VAE's own
convolutions leave their biases to the group_norm_silu and residual_add
kernels, so post_quant_conv's and conv_out's remain), the launches of the
port's kernels by name and the device events' count. `--backward` times the decode's forward and backward (a
seeded cotangent) instead of the decode alone. `--dtype bfloat16` runs
the model, its inputs and the cotangent in bfloat16, as the
`vae:bfloat16` compute dtype does. cuDNN runs in TF32, as the benchmark runs the program. The group norm
kernel alone is timed by chip_smoke.py's VAE phase.

The imports are absolute, so that the file also runs by its path against
another checkout of the package (PYTHONPATH=<checkout>), which is how two
trees are compared on one card. It then imports that checkout's
`scripts/measure.py`, which must define `cuda_ms` and `device_name`; a
checkout whose `measure.py` does not is timed with its own copy of this
script. Prints the card's name and power limit,
then one JSON line (also written to DIR/bench_vae.json with --out). The
command line runs on the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
from pathlib import Path

import torch

from latentsplat_tpu_torch import cuda_build
from latentsplat_tpu_torch.model.autoencoder.kl import AutoencoderKL, AutoencoderKLCfg
from latentsplat_tpu_torch.scripts.measure import cuda_ms, device_name

TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")
ELEMENTWISE = "elementwise_kernel"
ADD_OPS = ("aten::add_", "aten::add")
# The video decode: latents 4 channels at 1/8 of 256x256, the skip tensor
# the rendered color (3) and latent sample (4) at 256x256.
LATENT, SIDE, D_SKIP_EXTRA = 4, 256, 3


def build(seed: int, device, dtype: torch.dtype = torch.float32) -> AutoencoderKL:
    torch.manual_seed(seed)
    model = AutoencoderKL(AutoencoderKLCfg(skip_connections=True), d_in=3, d_skip_extra=D_SKIP_EXTRA)
    return model.to(device, dtype)


def decode_inputs(views: int, seed: int, device, dtype: torch.dtype = torch.float32
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((1, views, SIDE // 8, SIDE // 8, LATENT), generator=g, device=device)
    skip = torch.randn((1, views, SIDE, SIDE, LATENT + D_SKIP_EXTRA), generator=g, device=device)
    return z.to(dtype), skip.to(dtype)


def decode_call(model, z, skip, backward: bool):
    """The call timed: the decode, or its forward and backward."""
    if not backward:
        def call():
            with torch.no_grad():
                return model.decode(z, skip)
        return call
    cot = torch.randn((*z.shape[:-3], SIDE, SIDE, 3), generator=torch.Generator(device=z.device).manual_seed(7),
                      device=z.device).to(z.dtype)

    def call():
        model.zero_grad(set_to_none=True)
        (model.decode(z, skip) * cot).sum().backward()
    return call


def device_ops(fn) -> tuple[dict, int, dict]:
    """{kernel name: device ms} of one call under torch.profiler, the
    count of device events and {operator: calls} of ADD_OPS."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, events, adds = {}, 0, dict.fromkeys(ADD_OPS, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops[e.name] = ops.get(e.name, 0.0) + e.device_time_total / 1e3
            events += 1
        elif e.name in adds:
            adds[e.name] += 1
    return ops, events, adds


def decode_report(args, device) -> dict:
    dtype = getattr(torch, args.dtype)
    model = build(args.seed, device, dtype)
    z, skip = decode_inputs(args.views, args.seed + 1, device, dtype)
    call = decode_call(model, z, skip, args.backward)
    times = cuda_ms(call, args.iters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    before = collections.Counter(cuda_build.launches)
    ops, events, adds = device_ops(call)
    launches = cuda_build.launches - before
    top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:15])
    return {
        "views": args.views, "backward": args.backward, "dtype": args.dtype,
        "ms": statistics.median(times), "ms_all": times, "peak_bytes": peak,
        "device_ms": sum(ops.values()), "device_events": events,
        "transpose_ms": sum(v for k, v in ops.items() if any(t in k for t in TRANSPOSES)),
        "elementwise_ms": sum(v for k, v in ops.items() if ELEMENTWISE in k), "add_calls": adds,
        "launches": {k: cuda_build.launched(k, counts=launches) for k in cuda_build.KERNELS
                     if cuda_build.launched(k, counts=launches)},
        "shift_launches": cuda_build.launched("group_norm_silu", "shift", counts=launches),
        "top_ms": top,
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--views", type=int, default=30)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backward", action="store_true")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_vae needs a CUDA device")
    device = torch.device("cuda")
    print(device_name(device))
    out = {"card": device_name(device), "torch": torch.__version__, "decode": decode_report(args, device)}
    line = json.dumps(out)
    print(line)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "bench_vae.json").write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
