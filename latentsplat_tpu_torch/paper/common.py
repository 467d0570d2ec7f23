"""Shared figure-composition helpers for the paper generators.

Counterpart of latentsplat_tpu/paper/common.py: raster (PNG) composition
on `visualization.layout`, whose `resize` is PIL's BILINEAR.

Figure convention: each row is one example;
the leftmost column stacks the two context views at half size under a
"Ref." label, followed by one full-size image per method.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..misc.image_io import load_image
from ..visualization.annotation import draw_label
from ..visualization.layout import hcat, resize, vcat

MARGIN = 4  # pixels between panels


def _placeholder(size: int) -> np.ndarray:
    return np.full((size, size, 3), 0.5, dtype=np.float32)


def load_frame(
    method_path: Path, scene: str, ctx_key: str, index: int,
    kind: str = "color",
) -> Optional[np.ndarray]:
    """Read one rendered frame from the method-directory layout
    (<path>/<scene>/<ctx_key>/<kind>/<index:06d>.png); None if missing."""
    p = Path(method_path) / scene / ctx_key / kind / f"{int(index):0>6}.png"
    return load_image(p) if p.exists() else None


def context_panel(
    contexts: Sequence[Optional[np.ndarray]], image_size: int
) -> np.ndarray:
    """Stack the two context views at half size."""
    half = (image_size - MARGIN) // 2
    panels = [
        resize(c, shape=(half, half)) if c is not None else _placeholder(half)
        for c in (list(contexts) + [None, None])[:2]
    ]
    return vcat(*panels, gap=MARGIN)


def plain_grid(
    rows: List[List[Optional[np.ndarray]]],
    method_names: List[str],
    image_size: int = 256,
    font_size: int = 18,
) -> np.ndarray:
    """rows[i] = [image per method] (no context column); -> labeled figure.

    """
    assert all(len(r) == len(method_names) for r in rows)
    columns = []
    for m, name in enumerate(method_names):
        imgs = [
            resize(r[m], shape=(image_size, image_size))
            if r[m] is not None
            else _placeholder(image_size)
            for r in rows
        ]
        columns.append(
            vcat(
                draw_label(name, font_size=font_size),
                vcat(*imgs, gap=MARGIN),
                align="center", gap=2,
            )
        )
    return hcat(*columns, gap=MARGIN)


def comparison_grid(
    rows: List[List[Optional[np.ndarray]]],
    method_names: List[str],
    image_size: int = 256,
    font_size: int = 18,
) -> np.ndarray:
    """rows[i] = [ctx1, ctx2, image per method]; -> labeled figure (h, w, 3).

    Missing images render as gray placeholders.
    """
    assert all(len(r) == 2 + len(method_names) for r in rows)
    columns = []
    # Context column, labeled "Ref.".
    ctx_imgs = [context_panel(r[:2], image_size) for r in rows]
    columns.append(
        vcat(
            draw_label("Ref.", font_size=font_size),
            vcat(*ctx_imgs, gap=MARGIN),
            align="center", gap=2,
        )
    )
    for m, name in enumerate(method_names):
        imgs = [
            resize(r[2 + m], shape=(image_size, image_size))
            if r[2 + m] is not None
            else _placeholder(image_size)
            for r in rows
        ]
        columns.append(
            vcat(
                draw_label(name, font_size=font_size),
                vcat(*imgs, gap=MARGIN),
                align="center", gap=2,
            )
        )
    return hcat(*columns, gap=MARGIN)
