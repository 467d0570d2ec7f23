"""Released reference weights -> the port's modules (counterpart of
latentsplat_tpu/training/pretrained.py).

The reference starts from, and ships, torch state dicts: the finetuned LDM
VAE and discriminator (`kl_f8.pt`), the DINO ViT-B/8 trunk (torch hub
`facebookresearch/dino`), the LPIPS VGG16 (`lpips` package), DISTS
(`DISTS_pytorch`) and whole latentSplat Lightning checkpoints. Their keys
follow the reference's module paths (`encoder.backbone.dino.blocks.0.
attn.qkv.weight`, `autoencoder.model.decoder.up_blocks.0.resnets.1.conv1.
weight`, `discriminator.main.0.weight`, ...); the port's modules carry the
JAX package's flax names. Both sides being torch, a converter renames keys
and leaves layouts as they are, with three exceptions:
  * a 1x1 Conv2d weight that the port holds as a Linear is squeezed;
  * DINO's fused qkv projection is split into the query, key and value
    Linears (a missing qkv bias becomes zeros);
  * DISTS' alpha and beta (1, C, 1, 1) are flattened.
A ConvTranspose2d weight goes over unchanged: the JAX route's two spatial
flips (`conv_transpose_kernel`, then `weights.params_from_jax`) cancel.

Every converter takes a {name: tensor} state dict and returns a flat
{key: tensor} dict whose keys are those of the target module's
`state_dict()`; `merge_params` lays it over the module's own state dict,
checking names and shapes, and the `load_pretrained_*` helpers load the
result with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Mapping

import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


class RecordingStateDict(dict):
    """A state dict that records the full name of every tensor a converter
    reads (`read`), so that a caller can count what was mapped."""

    def __init__(self, items=(), read: set | None = None, prefix: str = ""):
        super().__init__(items)
        self.read = set() if read is None else read
        self.prefix = prefix

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.read.add(self.prefix + key)
        return value

    def get(self, key, default=None):
        return self[key] if key in self else default


def _sub(sd: Mapping, prefix: str) -> Mapping:
    """The entries under `prefix`, with the prefix stripped."""
    items = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if isinstance(sd, RecordingStateDict):
        return RecordingStateDict(items, sd.read, sd.prefix + prefix)
    return items


def _nest(prefix: str, tree: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in tree.items()}


# -- reading files ---------------------------------------------------------------


def load_torch_state_dict(path: Path, trust_pickle: bool = False) -> StateDict:
    """The tensors of a .pt / .ckpt file (under its `state_dict` key where it
    has one), read with `weights_only=True`. A Lightning checkpoint whose
    other entries need arbitrary unpickling is read only with
    `trust_pickle`, which runs the file's pickled code."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as error:
        if not trust_pickle:
            raise ValueError(
                f"{path} needs full unpickling (weights_only=False), which runs code stored in "
                f"the file; pass trust_pickle=True (convert_checkpoint --trust-pickle) only for "
                f"a file from a trusted source. ({str(error).splitlines()[0]})"
            ) from error
        blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


# -- primitive layers ------------------------------------------------------------


def _layer(sd: Mapping, name: str, target: str) -> StateDict:
    """Conv2d / Linear / norm: weight (and bias where there is one) as they are."""
    out = {f"{target}.weight": sd[f"{name}.weight"]}
    if f"{name}.bias" in sd:
        out[f"{target}.bias"] = sd[f"{name}.bias"]
    return out


def _dense_or_1x1(sd: Mapping, name: str, target: str) -> StateDict:
    """A reference Linear or 1x1 Conv2d -> the port's Linear."""
    out = _layer(sd, name, target)
    weight = out[f"{target}.weight"]
    if weight.dim() == 4:
        out[f"{target}.weight"] = weight[:, :, 0, 0]
    return out


# -- VAE (diffusers AutoencoderKL layout -> model.autoencoder.kl) ----------------


def _resnet(sd: Mapping, prefix: str) -> StateDict:
    """Diffusers ResnetBlock2D (or LDM naming of its shortcut) -> ResnetBlock."""
    out = {}
    for name in ("norm1", "conv1", "norm2", "conv2"):
        out.update(_layer(sd, f"{prefix}.{name}", name))
    for shortcut in ("conv_shortcut", "nin_shortcut"):
        if f"{prefix}.{shortcut}.weight" in sd:
            out.update(_layer(sd, f"{prefix}.{shortcut}", "conv_shortcut"))
            break
    return out


def _attn(sd: Mapping, prefix: str) -> StateDict:
    """Diffusers mid-block attention, with the new Linear names (to_q, ...,
    to_out.0) or the legacy 1x1-conv names (query, ..., proj_attn) -> AttnBlock."""
    if f"{prefix}.to_q.weight" in sd:
        names = ("to_q", "to_k", "to_v", "to_out.0")
    else:
        names = ("query", "key", "value", "proj_attn")
    out = _layer(sd, f"{prefix}.group_norm", "group_norm")
    for name, target in zip(names, ("to_q", "to_k", "to_v", "to_out")):
        out.update(_dense_or_1x1(sd, f"{prefix}.{name}", target))
    return out


def convert_autoencoder_kl(sd: Mapping, num_blocks: int = 4, layers_per_block: int = 2) -> StateDict:
    """Diffusers AutoencoderKL -> keys of `AutoencoderKL`. LDM checkpoints
    have no skip convolutions (latentSplat's addition); the target keeps
    its own."""
    out = _layer(sd, "encoder.conv_in", "encoder.conv_in")
    for i in range(num_blocks):
        for j in range(layers_per_block):
            out.update(_nest(f"encoder.down_{i}_resnet_{j}", _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}")))
        if i < num_blocks - 1:
            out.update(_layer(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", f"encoder.down_{i}_downsample.conv"))
    for half in ("encoder", "decoder"):
        out.update(_nest(f"{half}.mid_resnet_0", _resnet(sd, f"{half}.mid_block.resnets.0")))
        out.update(_nest(f"{half}.mid_attn", _attn(sd, f"{half}.mid_block.attentions.0")))
        out.update(_nest(f"{half}.mid_resnet_1", _resnet(sd, f"{half}.mid_block.resnets.1")))
        out.update(_layer(sd, f"{half}.conv_norm_out", f"{half}.conv_norm_out"))
        out.update(_layer(sd, f"{half}.conv_out", f"{half}.conv_out"))
    out.update(_layer(sd, "decoder.conv_in", "decoder.conv_in"))
    for i in range(num_blocks):
        for j in range(layers_per_block + 1):
            out.update(_nest(f"decoder.up_{i}_resnet_{j}", _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}")))
        if i < num_blocks - 1:
            out.update(_layer(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", f"decoder.up_{i}_upsample.conv"))
    out.update(_layer(sd, "quant_conv", "quant_conv"))
    out.update(_layer(sd, "post_quant_conv", "post_quant_conv"))
    return out


# -- PatchGAN discriminator (taming-transformers NLayerDiscriminator) ------------


def convert_discriminator_patch_gan(sd: Mapping) -> StateDict:
    """`main.{index}.*` Sequential -> conv_0 ... conv_out and bn_1 ... of
    `DiscriminatorPatchGan`: the convolutions in order, the last one
    conv_out, and the BatchNorms' affine parameters (running statistics are
    not used: the discriminator normalizes with batch statistics)."""
    prefix = "main."

    def indices(suffix, ndim=None):
        return sorted({
            int(k[len(prefix):].split(".")[0]) for k in sd
            if k.startswith(prefix) and k.endswith(suffix) and (ndim is None or dict.__getitem__(sd, k).dim() == ndim)
        })

    conv_ids = indices(".weight", ndim=4)
    out = {}
    for n, idx in enumerate(conv_ids):
        out.update(_layer(sd, f"main.{idx}", "conv_out" if n == len(conv_ids) - 1 else f"conv_{n}"))
    for n, idx in enumerate(indices(".running_mean")):
        out[f"bn_{n + 1}.weight"] = sd[f"main.{idx}.weight"]
        out[f"bn_{n + 1}.bias"] = sd[f"main.{idx}.bias"]
    return out


# -- LPIPS (lpips package, VGG16) ------------------------------------------------

# torchvision vgg16.features indices of the 13 convolutions.
_VGG16_CONV_IDS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def convert_lpips_vgg(sd: Mapping) -> StateDict:
    """lpips-package state dict -> keys of `loss.lpips.LPIPS`."""

    def find(names):
        for name in names:
            if name in sd:
                return sd[name]
        raise KeyError(names)

    out = {}
    for n, idx in enumerate(_VGG16_CONV_IDS):
        for part in ("weight", "bias"):
            out[f"vgg.conv_{n}.{part}"] = find(
                [f"net.slices.{idx}.{part}", f"net.features.{idx}.{part}", f"features.{idx}.{part}"]
            )
    for i in range(5):
        out[f"lin_{i}.weight"] = find([f"lins.{i}.model.1.weight", f"lin{i}.model.1.weight"])
    return out


# -- DINO ViT (facebookresearch/dino) --------------------------------------------


def convert_dino_vit(sd: Mapping, num_heads: int) -> StateDict:
    """DINO ViT state dict -> keys of the port's `DinoViT` trunk. The heads
    are contiguous slices of the query, key and value projections in both
    layouts, so `num_heads` only checks that the width divides."""
    dim = sd["cls_token"].shape[-1]
    if dim % num_heads:
        raise ValueError(f"DINO width {dim} is not a multiple of {num_heads} heads")
    out = {
        "cls_token": sd["cls_token"].reshape(1, 1, dim),
        "pos_embed": sd["pos_embed"].reshape(1, -1, dim),
        **_layer(sd, "patch_embed.proj", "patch_embed"),
    }
    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    for i in range(depth):
        p, block = f"blocks.{i}", f"block_{i}"
        attn = f"{block}.MultiHeadDotProductAttention_0"
        qkv_w = sd[f"{p}.attn.qkv.weight"]                     # (3 dim, dim)
        qkv_b = sd.get(f"{p}.attn.qkv.bias")
        if qkv_b is None:
            qkv_b = torch.zeros(3 * dim, dtype=qkv_w.dtype)
        for part, name in enumerate(("query", "key", "value")):
            out[f"{attn}.{name}.weight"] = qkv_w[part * dim : (part + 1) * dim]
            out[f"{attn}.{name}.bias"] = qkv_b[part * dim : (part + 1) * dim]
        out.update(_layer(sd, f"{p}.attn.proj", f"{attn}.out"))
        out.update(_layer(sd, f"{p}.norm1", f"{block}.LayerNorm_0"))
        out.update(_layer(sd, f"{p}.norm2", f"{block}.LayerNorm_1"))
        out.update(_layer(sd, f"{p}.mlp.fc1", f"{block}.Dense_0"))
        out.update(_layer(sd, f"{p}.mlp.fc2", f"{block}.Dense_1"))
    out.update(_layer(sd, "norm", "LayerNorm_0"))
    return out


# -- merging ---------------------------------------------------------------------


def merge_params(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor], path: str = "") -> StateDict:
    """`source` laid over `target` (both {key: tensor}), as float32 on each
    target tensor's device. Raises KeyError for a key `target` lacks and
    ValueError for a shape that differs, naming the key under `path`."""
    out = dict(target)
    for key, value in source.items():
        where = f"{path}.{key}" if path else key
        if key not in target:
            raise KeyError(f"converted key {where} not in the target's state dict")
        if tuple(target[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {where}: target {tuple(target[key].shape)}, got {tuple(value.shape)}")
        out[key] = value.to(device=target[key].device, dtype=torch.float32).contiguous()
    return out


def load_into(module: nn.Module, converted: StateDict, path: str = "") -> nn.Module:
    """`converted` over the module's own state dict, loaded strictly."""
    module.load_state_dict(merge_params(module.state_dict(), converted, path), strict=True)
    return module


def load_pretrained_autoencoder(model: nn.Module, path: Path, **kwargs) -> nn.Module:
    """A diffusers / LDM VAE file into `model.autoencoder` (a LatentSplat's)."""
    converted = convert_autoencoder_kl(load_torch_state_dict(path), **kwargs)
    load_into(model.autoencoder, converted, "autoencoder")
    return model


def load_pretrained_discriminator(discriminator: nn.Module, path: Path) -> nn.Module:
    return load_into(discriminator, convert_discriminator_patch_gan(load_torch_state_dict(path)))


def load_pretrained_lpips(lpips: nn.Module, path: Path) -> nn.Module:
    return load_into(lpips, convert_lpips_vgg(load_torch_state_dict(path)))


def load_pretrained_dino(model: nn.Module, path: Path, num_heads: int = 12) -> nn.Module:
    """A DINO ViT file into `model.encoder.backbone.dino` (a LatentSplat's)."""
    trunk = convert_dino_vit(load_torch_state_dict(path), num_heads)
    load_into(model.encoder.backbone.dino, trunk, "encoder.backbone.dino")
    return model


# -- whole latentSplat checkpoints (Lightning .ckpt of the release) --------------


def _srt_transformer(sd: Mapping, prefix: str, num_layers: int, ff: str) -> StateDict:
    """The reference's SRT Transformer: layers.{i}.0 = PreNorm(Attention),
    layers.{i}.1 = PreNorm(feed-forward), the feed-forward an MLP (`ff`
    "mlp": net = Sequential(Linear, GELU, [Dropout], Linear)) or the
    epipolar ConvFeedForward ("conv") -> keys of `model.transformer.Transformer`."""
    out = {}
    for i in range(num_layers):
        attn = f"{prefix}.layers.{i}.0"
        out.update(_layer(sd, f"{attn}.norm", f"norm_attn_{i}"))
        if f"{attn}.fn.to_qkv.weight" in sd:
            out[f"attn_{i}.to_qkv.weight"] = sd[f"{attn}.fn.to_qkv.weight"]
        else:
            out[f"attn_{i}.to_q.weight"] = sd[f"{attn}.fn.to_q.weight"]
            out[f"attn_{i}.to_kv.weight"] = sd[f"{attn}.fn.to_kv.weight"]
        if f"{attn}.fn.to_out.0.weight" in sd:
            out.update(_layer(sd, f"{attn}.fn.to_out.0", f"attn_{i}.to_out"))

        ffp = f"{prefix}.layers.{i}.1"
        out.update(_layer(sd, f"{ffp}.norm", f"norm_ff_{i}"))
        if ff == "mlp":
            ids = sorted(
                int(k[len(ffp) + len(".fn.net."):].split(".")[0])
                for k in sd if k.startswith(f"{ffp}.fn.net.") and k.endswith(".weight")
            )
            out.update(_layer(sd, f"{ffp}.fn.net.{ids[0]}", f"ff_{i}.Dense_0"))
            out.update(_layer(sd, f"{ffp}.fn.net.{ids[1]}", f"ff_{i}.Dense_1"))
        else:
            out.update(_nest(f"ConvFeedForward_{i}", _conv_feed_forward(sd, f"{ffp}.fn")))
    return out


def _image_self_attention(sd: Mapping, prefix: str) -> StateDict:
    """ImageSelfAttention: positional_encoding.1 (Linear), patch_embedder.0,
    the transformer and the resampler (ConvTranspose2d, as it is)."""
    layers = f"{prefix}.transformer.layers."
    num_layers = len({k[len(layers):].split(".")[0] for k in sd if k.startswith(layers)})
    return {
        **_layer(sd, f"{prefix}.positional_encoding.1", "pe_proj"),
        **_layer(sd, f"{prefix}.patch_embedder.0", "patch_embed"),
        **_nest("transformer", _srt_transformer(sd, f"{prefix}.transformer", num_layers, ff="mlp")),
        **_layer(sd, f"{prefix}.resampler", "resampler"),
    }


def _conv_feed_forward(sd: Mapping, prefix: str) -> StateDict:
    """ConvFeedForward: layers = Sequential(Conv7x7, GELU, Dropout, Conv7x7,
    Dropout), so the second convolution is layers.3, plus self_attention."""
    return {
        **_nest("self_attention", _image_self_attention(sd, f"{prefix}.self_attention")),
        **_layer(sd, f"{prefix}.layers.0", "Conv_0"),
        **_layer(sd, f"{prefix}.layers.3", "Conv_1"),
    }


def convert_latentsplat_encoder(sd: Mapping, num_heads: int = 12) -> StateDict:
    """The reference EncoderEpipolar (keys under `encoder.`, stripped) ->
    keys of `EncoderEpipolar`."""
    out = _nest("backbone.dino", convert_dino_vit(_sub(sd, "backbone.dino."), num_heads))
    for target, name in (
        ("Dense_0", "backbone.global_token_mlp.0"), ("Dense_1", "backbone.global_token_mlp.2"),
        ("Dense_2", "backbone.local_token_mlp.0"), ("Dense_3", "backbone.local_token_mlp.2"),
    ):
        out.update(_dense_or_1x1(sd, name, f"backbone.{target}"))
    out.update(_dense_or_1x1(sd, "backbone_projection.1", "backbone_projection"))

    et = "epipolar_transformer"
    if f"{et}.downscaler.weight" in sd:
        out.update(_layer(sd, f"{et}.downscaler", f"{et}.downscaler"))
        out.update(_layer(sd, f"{et}.upscaler", f"{et}.upscaler"))
        out.update(_layer(sd, f"{et}.upscale_refinement.0", f"{et}.refine_0"))
        out.update(_layer(sd, f"{et}.upscale_refinement.2", f"{et}.refine_1"))
    if f"{et}.depth_encoding.1.weight" in sd:
        out.update(_dense_or_1x1(sd, f"{et}.depth_encoding.1", f"{et}.depth_encoding"))
    layers = f"{et}.transformer.layers."
    num_layers = len({k.split(".")[3] for k in sd if k.startswith(layers)})
    out.update(_nest(f"{et}.transformer", _srt_transformer(sd, f"{et}.transformer", num_layers, ff="conv")))

    if "high_resolution_skip.0.weight" in sd:
        out.update(_layer(sd, "high_resolution_skip.0", "high_resolution_skip"))
    out.update(_dense_or_1x1(sd, "depth_predictor.projection.1", "depth_predictor.projection"))
    out.update(_dense_or_1x1(sd, "to_gaussians.1", "to_gaussians"))
    return out


def convert_latentsplat_checkpoint(sd: Mapping, num_heads: int = 12) -> dict:
    """A released latentSplat Lightning state dict -> {"generator": keys of
    `LatentSplat`, and "discriminator": keys of `DiscriminatorPatchGan`
    where the file has one}, to lay over freshly seeded modules."""
    generator: StateDict = {}
    encoder = _sub(sd, "encoder.")
    if encoder:
        generator.update(_nest("encoder", convert_latentsplat_encoder(encoder, num_heads)))
    vae = _sub(sd, "autoencoder.model.")
    if vae:
        generator.update(_nest("autoencoder", convert_autoencoder_kl(vae)))
        # The skip convolutions: skip_convs.{0..3} feed the decoder's up
        # blocks; the reference's fifth is unused.
        for i in range(4):
            if f"autoencoder.skip_convs.{i}.weight" in sd:
                generator.update(_layer(sd, f"autoencoder.skip_convs.{i}", f"autoencoder.decoder.skip_conv_{i}"))
    out = {"generator": generator}
    discriminator = _sub(sd, "discriminator.")
    if any(k.startswith("main.") for k in discriminator):
        out["discriminator"] = convert_discriminator_patch_gan(discriminator)
    return out


# -- DISTS (DISTS_pytorch package) -----------------------------------------------


def convert_dists(sd: Mapping) -> StateDict:
    """DISTS_pytorch state dict -> keys of `evaluation.metrics.DISTSNet`: the
    VGG16 convolutions at their stage1..stage5 Sequential indices (stages
    2-5 start with an L2 pooling), alpha and beta flattened."""
    stage_convs = {1: (0, 2), 2: (1, 3), 3: (1, 3, 5), 4: (1, 3, 5), 5: (1, 3, 5)}
    out, n = {}, 0
    for stage in range(1, 6):
        for idx in stage_convs[stage]:
            out.update(_layer(sd, f"stage{stage}.{idx}", f"conv_{n}"))
            n += 1
    out["alpha"] = sd["alpha"].reshape(-1)
    out["beta"] = sd["beta"].reshape(-1)
    return out
