"""Text labels on images (counterpart of
latentsplat_tpu/visualization/annotation.py) without PIL.

Text is drawn with a fixed 5x8 bitmap font for printable ASCII kept in this
module, scaled by a whole factor to about `font_size` pixels. The JAX
package draws with PIL's DejaVu font, so the glyphs, and the label's size,
differ from its labels; the layout around them is the same.
"""

from __future__ import annotations

import numpy as np

from .layout import vcat

# Printable ASCII from " " (32) to "~" (126): five columns per glyph, each
# a byte whose bit r is the pixel in row r (row 0 on top, row 7 for
# descenders).
_GLYPHS = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462" "3649562050"
    "0008070300" "001c224100" "0041221c00" "2a1c7f1c2a" "08083e0808" "0080703000" "0808080808"
    "0000606000" "2010080402" "3e5149453e" "00427f4000" "7249494946" "2141494d33" "1814127f10"
    "2745454539" "3c4a494931" "4121110907" "3649494936" "464949291e" "0000140000" "0040340000"
    "0008142241" "1414141414" "0041221408" "0201590906" "3e415d594e" "7c1211127c" "7f49494936"
    "3e41414122" "7f4141413e" "7f49494941" "7f09090901" "3e41415173" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f021c027f" "7f0408107f" "3e4141413e" "7f09090906"
    "3e4151215e" "7f09192946" "2649494932" "03017f0103" "3f4040403f" "1f2040201f" "3f4038403f"
    "6314081463" "0304780403" "6159494d43" "007f414141" "0204081020" "004141417f" "0402010204"
    "4040404040" "0003070800" "2054547840" "7f28444438" "3844444428" "384444287f" "3854545418"
    "00087e0902" "18a4a49c78" "7f08040478" "00447d4000" "2040403d00" "7f10284400" "00417f4000"
    "7c04780478" "7c08040478" "3844444438" "fc18242418" "18242418fc" "7c08040408" "4854545424"
    "04043f4424" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "4c9090907c" "4464544c44"
    "0008364100" "0000770000" "0041360800" "0201020402"
)
_GLYPH_W, _GLYPH_H = 5, 8


def _glyph(ch: str) -> np.ndarray:
    """(8, 5) bool bitmap of one character; '?' stands in for others."""
    code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
    cols = np.frombuffer(_GLYPHS, np.uint8)[(code - 32) * _GLYPH_W : (code - 31) * _GLYPH_W]
    return ((cols[None, :] >> np.arange(_GLYPH_H)[:, None]) & 1).astype(bool)


def draw_label(
    text: str,
    font_size: int = 19,
    color: tuple[float, float, float] = (0.0, 0.0, 0.0),
    background: float = 1.0,
) -> np.ndarray:
    """Render text -> float (h, w, 3) image with a 1-pixel margin."""
    scale = max(1, round(font_size / _GLYPH_H))
    mask = np.zeros((_GLYPH_H, max(len(text) * (_GLYPH_W + 1) - 1, 1)), bool)
    for i, ch in enumerate(text):
        mask[:, i * (_GLYPH_W + 1) : i * (_GLYPH_W + 1) + _GLYPH_W] = _glyph(ch)
    mask = np.pad(mask.repeat(scale, axis=0).repeat(scale, axis=1), 1)
    image = np.full((*mask.shape, 3), np.clip(background, 0.0, 1.0), np.float32)
    image[mask] = np.clip(np.asarray(color, np.float32), 0.0, 1.0)
    return image


def add_label(image: np.ndarray, label: str, font_size: int = 24, align: str = "left") -> np.ndarray:
    return vcat(draw_label(label, font_size=font_size), image, align=align, gap=4)
