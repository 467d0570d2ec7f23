"""Weights from the JAX package's flax parameter trees.

Port modules carry the flax module names, so a flax path (a, b, c) is the
torch module path "a.b.c" and the conversion is a walk over the tree with
one layout rule per torch module type:
  Linear           kernel (in, out) -> weight (out, in); the attention
                   DenseGeneral kernels (in, heads, d) / (heads, d, out)
                   are flattened first
  Conv2d           kernel (kh, kw, in, out) -> weight (out, in, kh, kw)
  ConvTranspose2d  kernel (kh, kw, in, out) -> weight (in, out, kh, kw),
                   spatially flipped (flax does not flip the kernel)
  LayerNorm, GroupNorm, BatchNorm2d  scale -> weight
Subtrees of modules the port does not have (`UNPORTED`, now none) are
dropped.
The same walk maps the generator, discriminator, LPIPS and DISTS trees
(DISTS' `alpha` and `beta` are raw parameters of the root module), and any
tree laid out like them, such as optax's Adam moments (`adam_state_from_jax`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

# Subtrees of the JAX trees that the port has no module for: none, since
# the VAE encoder was ported.
UNPORTED: tuple[str, ...] = ()


def _linear(module: nn.Linear, name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "bias":
        return "bias", value.reshape(-1)
    if value.ndim == 3:
        if value.shape[0] == module.in_features:      # (in, heads, d)
            value = value.reshape(value.shape[0], -1)
        else:                                         # (heads, d, out)
            value = value.reshape(-1, value.shape[-1])
    return "weight", value.T


def _convert_leaf(module: nn.Module, name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if isinstance(module, nn.Linear):
        return _linear(module, name, value)
    if isinstance(module, nn.ConvTranspose2d):
        if name == "kernel":
            return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
        return name, value
    if isinstance(module, nn.Conv2d):
        if name == "kernel":
            return "weight", value.transpose(3, 2, 0, 1)
        return name, value
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
        return {"scale": "weight"}.get(name, name), value
    raise TypeError(f"no flax conversion for {type(module).__name__}.{name}")


_LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)


def params_from_jax(params: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves) -> `model.state_dict()`-style dict."""
    state = {}

    def visit(tree: Mapping, prefix: str):
        for key, value in tree.items():
            path = f"{prefix}{key}"
            if path in UNPORTED or (isinstance(value, tuple) and not value):
                continue   # not ported, or an optax MaskedNode (a leaf another label owns)
            if isinstance(value, Mapping):
                visit(value, path + ".")
                continue
            owner_path = prefix[:-1]
            owner = model.get_submodule(owner_path) if owner_path else model
            if isinstance(owner, _LAYERS):
                torch_name, array = _convert_leaf(owner, key, np.asarray(value))
            else:
                torch_name, array = key, value              # raw parameter, e.g. cls_token
            target = f"{owner_path}.{torch_name}" if owner_path else torch_name
            state[target] = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))

    visit(params, "")
    return state


def adam_state_from_jax(mu: Mapping, nu: Mapping, count, model: nn.Module) -> dict:
    """optax ScaleByAdamState (moments laid out like `model`'s flax tree) ->
    the state of one group of `training.optim.ChainedAdam`."""
    return {
        "count": torch.tensor(int(np.asarray(count)), dtype=torch.int32),
        "mu": params_from_jax(mu, model),
        "nu": params_from_jax(nu, model),
    }
