"""Distinct categorical colors (counterpart of
latentsplat_tpu/visualization/colors.py): the sashamaps 20-color palette
and black and white, used to tell rays and cameras apart."""

from __future__ import annotations

# https://sashamaps.net/docs/resources/20-colors/
DISTINCT_COLORS = [
    "#e6194b", "#3cb44b", "#ffe119", "#4363d8", "#f58231", "#911eb4", "#46f0f0", "#f032e6",
    "#bcf60c", "#fabebe", "#008080", "#e6beff", "#9a6324", "#fffac8", "#800000", "#aaffc3",
    "#808000", "#ffd8b1", "#000075", "#808080", "#ffffff", "#000000",
]


def get_distinct_color(index: int) -> tuple[float, float, float]:
    """index -> RGB in [0, 1], cycling through the palette."""
    hex_color = DISTINCT_COLORS[index % len(DISTINCT_COLORS)].lstrip("#")
    return tuple(int(hex_color[i : i + 2], 16) / 255 for i in (0, 2, 4))
