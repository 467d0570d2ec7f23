"""Weights of a cell, made by the benchmark from the seed on the device.

One uniform draw of every leaf at once (`torch.rand` on the device's own
generator), split by leaf in the order of the reference's parameter names
and scaled by a rule on each leaf's name and shape:
  * matrices and kernels: U(-b, b), b = 1 / sqrt(fan in), PyTorch's default
    for linear and convolution layers;
  * the ViT's class token and position embedding and the VAE's skip
    convolutions: the standard deviation 0.02 (these start at zero or come
    from pretraining in the published model; chip_smoke.like_trained);
  * vectors named `weight` (the norms' scales): 1 + U(-0.1, 0.1);
  * other vectors (biases): U(-0.02, 0.02), so that nothing rides on a zero;
then, as like_trained does, the depth head scaled by DEPTH_HEAD_SCALE so
that each pixel's depth distribution is peaked, as a trained one is. The
program and the reference each get these values by name; neither's own
initialization is kept.
"""

from __future__ import annotations

import math

import torch

DEPTH_HEAD = "encoder.depth_predictor.projection.weight"
DEPTH_HEAD_SCALE = 50.0


def seeded(seed: int, stream: int, device) -> torch.Generator:
    """The device generator of one stream of a run's draws."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))


def _rule(name: str, shape: torch.Size) -> tuple[float, float]:
    """(center, half width) of a leaf's uniform values."""
    if name.endswith(("cls_token", "pos_embed")) or "skip_conv" in name:
        return 0.0, 0.02 * math.sqrt(3.0)
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.02


def make(shapes: dict[str, torch.Size], seed: int, stream: int, device) -> dict[str, torch.Tensor]:
    """{name: values} for leaves of these shapes, from one draw."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=seeded(seed, stream, device), device=device) * 2.0 - 1.0
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        center, half = _rule(name, shape)
        value = flat[offset : offset + n].view(shape) * half + center
        if name == DEPTH_HEAD:
            value = value * DEPTH_HEAD_SCALE
        out[name] = value
        offset += n
    return out


@torch.no_grad()
def load(module: torch.nn.Module, values: dict[str, torch.Tensor]) -> None:
    """Copy `values` into `module`'s parameters by name; every parameter
    must get one, of its shape."""
    params = dict(module.named_parameters())
    if set(params) != set(values):
        missing, extra = sorted(set(params) - set(values)), sorted(set(values) - set(params))
        raise ValueError(f"parameters differ from the reference's: missing {missing[:5]}, extra {extra[:5]}")
    for name, p in params.items():
        if p.shape != values[name].shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)}, the reference's {tuple(values[name].shape)}")
        p.copy_(values[name])


def shapes_of(module: torch.nn.Module) -> dict[str, torch.Size]:
    return {n: p.shape for n, p in module.named_parameters()}
