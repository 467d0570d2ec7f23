"""Data shims (counterpart of latentsplat_tpu/dataset/shims.py): the crop
and augmentation shims on host numpy examples, the patch and bounds shims
on device tensors. Images are NHWC.

The crop shim resizes with the port's C LANCZOS resampler
(`csrc_host/resample.c`, Pillow's arithmetic) on uint8 images, straight
from the JPEG decoder, and returns float32 in [0, 1]. The JAX package
resizes float images through uint8 and back (clip(x * 255) -> uint8 ->
resize -> / 255); for x = k / 255 that round trip gives k back for every
level k, so both yield the same floats.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .. import host_build


def _rescale_image(image: np.ndarray, shape: tuple[int, int],
                   window: tuple[int, int, int, int] | None = None) -> np.ndarray:
    """uint8 (h, w, c) -> uint8 LANCZOS resize to `shape` (h, w); with
    `window` (row, col, h, w), only that part of the resized image."""
    return host_build.resample(image, shape, "lanczos", window)


def rescale_and_crop(images: np.ndarray, intrinsics: np.ndarray, shape: tuple[int, int]):
    """uint8 (v, h, w, 3) + (v, 3, 3) -> float32 images in [0, 1] with the
    shorter side resized to `shape` and the center cropped to it, and the
    intrinsics' focal lengths scaled by the crop."""
    v, h_in, w_in, _ = images.shape
    h_out, w_out = shape
    assert h_out <= h_in and w_out <= w_in
    scale_factor = max(h_out / h_in, w_out / w_in)
    h_scaled = round(h_in * scale_factor)
    w_scaled = round(w_in * scale_factor)
    assert h_scaled == h_out or w_scaled == w_out
    # The center crop is the resize's window: only the kept samples are computed.
    window = ((h_scaled - h_out) // 2, (w_scaled - w_out) // 2, h_out, w_out)
    images = np.stack([_rescale_image(im, (h_scaled, w_scaled), window) for im in images])
    intrinsics = intrinsics.copy()
    intrinsics[..., 0, 0] *= w_scaled / w_out
    intrinsics[..., 1, 1] *= h_scaled / h_out
    return images.astype(np.float32) / 255.0, intrinsics


def apply_crop_shim(example: dict, shape: tuple[int, int]) -> dict:
    out = dict(example)
    for key in ("context", "target"):
        views = dict(example[key])
        views["image"], views["intrinsics"] = rescale_and_crop(views["image"], views["intrinsics"], shape)
        out[key] = views
    return out


def _reflect_views(views: dict) -> dict:
    reflect = np.eye(4, dtype=np.float32)
    reflect[0, 0] = -1.0
    return {
        **views,
        "image": views["image"][..., ::-1, :].copy(),
        "extrinsics": reflect @ views["extrinsics"] @ reflect,
    }


def draw_flip(rng: np.random.Generator) -> bool:
    """The augmentation shim's one draw: whether to flip."""
    return rng.random() >= 0.5


def flip_example(example: dict) -> dict:
    """A horizontal flip, with the extrinsics reflected."""
    return {
        **example,
        "context": _reflect_views(example["context"]),
        "target": _reflect_views(example["target"]),
    }


def shard_rows(candidates: Iterable[Callable[[], Optional[dict]]], row_shard,
               rng: np.random.Generator, augment: bool) -> Iterator[dict]:
    """One pass of a dataset's examples. `candidates` gives, for each row
    of the one-process order, a callable that decodes it (None where it
    cannot); with `augment` the augmentation shim flips each decoded
    example on one draw of `rng`, for half the examples.

    Under a data-parallel `row_shard` (`types.RowShard`) every rank draws
    each row's flip before decoding (a row dropped after decoding would
    otherwise shift the other ranks' draws), decodes only its own rows and
    yields them a period (one global batch) at a time: a pass's last,
    incomplete period is dropped, as the one-process loader drops its
    partial last batch, so every rank starts each pass on a new global
    batch."""
    if row_shard.whole:
        for load in candidates:
            example = load()
            if example is not None:
                yield flip_example(example) if augment and draw_flip(rng) else example
        return
    rows = []
    for position, load in enumerate(candidates):
        flip = augment and draw_flip(rng)
        if row_shard.keeps(position):
            example = load()
            if example is not None:
                rows.append(flip_example(example) if flip else example)
        if position % row_shard.period == row_shard.period - 1:
            yield from rows
            rows = []


def apply_patch_shim(batch: dict, patch_size: int) -> dict:
    """Center-crop images to a multiple of patch_size."""

    def per_views(views):
        h, w = views["image"].shape[-3:-1]
        assert h % 2 == 0 and w % 2 == 0
        h_new = (h // patch_size) * patch_size
        w_new = (w // patch_size) * patch_size
        row = (h - h_new) // 2
        col = (w - w_new) // 2
        image = views["image"][..., row : row + h_new, col : col + w_new, :]
        scale = views["intrinsics"].new_tensor(
            [[w / w_new, 1.0, 1.0], [1.0, h / h_new, 1.0], [1.0, 1.0, 1.0]]
        )
        return {**views, "image": image, "intrinsics": views["intrinsics"] * scale}

    return {**batch, "context": per_views(batch["context"]), "target": per_views(batch["target"])}


def compute_depth_for_disparity(
    extrinsics: torch.Tensor, intrinsics: torch.Tensor, image_shape: tuple[int, int],
    disparity: float, delta_min: float = 1e-6,
) -> torch.Tensor:
    """Depth at which the largest context baseline subtends `disparity` pixels."""
    origins = extrinsics[..., :3, 3]
    deltas = torch.linalg.norm(origins[:, None] - origins[:, :, None], dim=-1)
    baselines = deltas.clamp(min=delta_min).amax(dim=(1, 2))
    h, w = image_shape
    sizes = torch.stack([(1.0 / w) / intrinsics[..., 0, 0], (1.0 / h) / intrinsics[..., 1, 1]], dim=-1)
    return baselines / (disparity * sizes.mean(dim=(1, 2)))


def apply_bounds_shim(batch: dict, near_disparity: float, far_disparity: float) -> dict:
    """Near/far from disparity heuristics over the context baselines."""
    context, target = batch["context"], batch["target"]
    b, cv = context["image"].shape[:2]
    tv = target["image"].shape[1]
    hw = tuple(context["image"].shape[-3:-1])
    near = compute_depth_for_disparity(context["extrinsics"], context["intrinsics"], hw, near_disparity)
    far = compute_depth_for_disparity(context["extrinsics"], context["intrinsics"], hw, far_disparity)
    return {
        **batch,
        "context": {**context, "near": near[:, None].expand(b, cv), "far": far[:, None].expand(b, cv)},
        "target": {**target, "near": near[:, None].expand(b, tv), "far": far[:, None].expand(b, tv)},
    }
