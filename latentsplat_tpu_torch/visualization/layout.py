"""Image composition on the host: overlay, cat, hcat, vcat, add_border
(counterpart of latentsplat_tpu/visualization/layout.py) on numpy HWC
float images in [0, 1]. `resize` is PIL's BILINEAR through the port's C
resampler (`csrc_host/resample.c`), with PIL's bits.
"""

from __future__ import annotations

from typing import Any, Generator, Iterable, Literal, Union

import numpy as np

from .. import host_build

Alignment = Literal["start", "center", "end"]
Axis = Literal["horizontal", "vertical"]
Color = Union[int, float, Iterable[int], Iterable[float], np.ndarray]


def _sanitize_color(color: Color) -> np.ndarray:
    if isinstance(color, (int, float)):
        color = [color]
    return np.asarray(color, dtype=np.float32)


def _sanitize_image(image: np.ndarray) -> np.ndarray:
    """-> float32 (h, w, 3)."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        image = image[..., None]
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    return image


def _intersperse(iterable: Iterable, delimiter: Any) -> Generator[Any, None, None]:
    it = iter(iterable)
    yield next(it)
    for item in it:
        yield delimiter
        yield item


def _get_main_dim(main_axis: Axis) -> int:
    return {"horizontal": 1, "vertical": 0}[main_axis]


def _get_cross_dim(main_axis: Axis) -> int:
    return {"horizontal": 0, "vertical": 1}[main_axis]


def _compute_offset(base: int, overlay_size: int, align: Alignment) -> slice:
    offset = {
        "start": 0,
        "center": (base - overlay_size) // 2,
        "end": base - overlay_size,
    }[align]
    return slice(offset, offset + overlay_size)


def overlay(
    base: np.ndarray,
    over: np.ndarray,
    main_axis: Axis,
    main_axis_alignment: Alignment,
    cross_axis_alignment: Alignment,
) -> np.ndarray:
    base = _sanitize_image(base)
    over = _sanitize_image(over)
    # The overlay must fit inside the base.
    assert base.shape[0] >= over.shape[0] and base.shape[1] >= over.shape[1]
    md = _get_main_dim(main_axis)
    cd = _get_cross_dim(main_axis)
    slices = [slice(None), slice(None)]
    slices[md] = _compute_offset(base.shape[md], over.shape[md], main_axis_alignment)
    slices[cd] = _compute_offset(base.shape[cd], over.shape[cd], cross_axis_alignment)
    result = base.copy()
    result[slices[0], slices[1]] = over
    return result


def cat(
    main_axis: Axis,
    *images: np.ndarray,
    align: Alignment = "center",
    gap: int = 8,
    gap_color: Color = 1.0,
) -> np.ndarray:
    """Arrange images along main_axis, centered (or aligned) on the cross axis."""
    images = [_sanitize_image(im) for im in images]
    gap_color = _sanitize_color(gap_color)
    md = _get_main_dim(main_axis)
    cd = _get_cross_dim(main_axis)

    cross = max(im.shape[cd] for im in images)

    padded = []
    for im in images:
        if im.shape[cd] != cross:
            shape = list(im.shape)
            shape[cd] = cross
            base = np.broadcast_to(gap_color, tuple(shape)).astype(np.float32).copy()
            im = overlay(
                base, im,
                main_axis=main_axis,
                main_axis_alignment="start",
                cross_axis_alignment=align,
            )
        padded.append(im)

    if gap > 0:
        shape = [gap, gap, 3]
        shape[cd] = cross
        shape[md] = gap
        separator = np.broadcast_to(gap_color, (shape[0], shape[1], 3)).astype(np.float32)
        padded = list(_intersperse(padded, separator))
    return np.concatenate(padded, axis=md)


def hcat(*images: np.ndarray, align: Literal["start", "center", "end", "top", "bottom"] = "start",
         gap: int = 8, gap_color: Color = 1.0) -> np.ndarray:
    return cat(
        "horizontal",
        *images,
        align={"start": "start", "top": "start", "center": "center",
               "end": "end", "bottom": "end"}[align],
        gap=gap,
        gap_color=gap_color,
    )


def vcat(*images: np.ndarray, align: Literal["start", "center", "end", "left", "right"] = "start",
         gap: int = 8, gap_color: Color = 1.0) -> np.ndarray:
    return cat(
        "vertical",
        *images,
        align={"start": "start", "left": "start", "center": "center",
               "end": "end", "right": "end"}[align],
        gap=gap,
        gap_color=gap_color,
    )


def add_border(
    image: np.ndarray,
    border: int = 8,
    color: Color = 1.0,
) -> np.ndarray:
    image = _sanitize_image(image)
    color = _sanitize_color(color)
    h, w, c = image.shape
    result = np.broadcast_to(
        color, (h + 2 * border, w + 2 * border, 3)
    ).astype(np.float32).copy()
    result[border : border + h, border : border + w] = image
    return result


def resize(
    image: np.ndarray,
    shape: tuple[int, int] | None = None,
    width: int | None = None,
    height: int | None = None,
) -> np.ndarray:
    """Resize to `shape` (h, w), or to `width` or `height` keeping the aspect
    ratio, as the JAX package does: clip to [0, 1], truncate to uint8, PIL's
    BILINEAR, / 255."""
    image = _sanitize_image(image)
    h, w, c = image.shape
    if (shape is not None) + (width is not None) + (height is not None) != 1:
        raise ValueError("resize takes exactly one of shape, width and height")
    if c != 3:
        raise ValueError(f"resize takes RGB images, not {c} channels")
    if width is not None:
        shape = (int(h * width / w), width)
    elif height is not None:
        shape = (height, int(w * height / h))
    pixels = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    return host_build.resample(pixels, tuple(shape), "bilinear").astype(np.float32) / 255.0
