"""Color maps for scalar images such as depth, on the host in numpy
(counterpart of latentsplat_tpu/visualization/color_map.py).

`turbo` is Google's polynomial fit of the colormap, `inferno` a
piecewise-linear interpolation of 9 stops of matplotlib's map, so neither
needs matplotlib.
"""

from __future__ import annotations

import colorsys

import numpy as np

# Google turbo colormap: polynomial fits per channel.
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973])


def _polyval(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    y = np.zeros_like(x)
    for i, c in enumerate(coeffs):
        y = y + c * x**i
    return y


def turbo(x: np.ndarray) -> np.ndarray:
    """x in [0, 1] (any shape) -> (..., 3) turbo RGB."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    rgb = np.stack([_polyval(c, x) for c in (_TURBO_R, _TURBO_G, _TURBO_B)], axis=-1)
    return np.clip(rgb, 0.0, 1.0)


def gray(x: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    return np.repeat(x[..., None], 3, axis=-1)


# matplotlib's inferno sampled at 9 evenly spaced stops.
_INFERNO_STOPS = np.asarray(
    [
        [0.0015, 0.0005, 0.0139],
        [0.1341, 0.0448, 0.3243],
        [0.3415, 0.0622, 0.4291],
        [0.5373, 0.1340, 0.4155],
        [0.7293, 0.2123, 0.3325],
        [0.8817, 0.3403, 0.2217],
        [0.9672, 0.5194, 0.0584],
        [0.9787, 0.7294, 0.2129],
        [0.9884, 0.9984, 0.6449],
    ],
    np.float32,
)


def inferno(x: np.ndarray) -> np.ndarray:
    """x in [0, 1] (any shape) -> (..., 3) inferno RGB (piecewise-linear)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    pos = x * (len(_INFERNO_STOPS) - 1)
    lo = np.floor(pos).astype(np.int32)
    hi = np.minimum(lo + 1, len(_INFERNO_STOPS) - 1)
    t = (pos - lo)[..., None]
    return _INFERNO_STOPS[lo] * (1.0 - t) + _INFERNO_STOPS[hi] * t


_COLOR_MAPS = {"turbo": turbo, "gray": gray, "inferno": inferno}


def apply_color_map(x: np.ndarray, color_map: str = "turbo") -> np.ndarray:
    return _COLOR_MAPS[color_map](x)


def apply_color_map_to_image(image: np.ndarray, color_map: str = "turbo") -> np.ndarray:
    """Scalar (..., h, w) -> (..., h, w, 3)."""
    return apply_color_map(image, color_map)


def apply_color_map_2d(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Two scalar fields -> RGB: x is the hue, y the saturation."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    y = np.clip(np.asarray(y, np.float32), 0.0, 1.0)
    rgb = np.asarray(
        [colorsys.hsv_to_rgb(h, s, 1.0) for h, s in zip(x.reshape(-1), y.reshape(-1))], dtype=np.float32
    )
    return rgb.reshape(*x.shape, 3)


def apply_depth_color_map(
    depth: np.ndarray,
    near: float | None = None,
    far: float | None = None,
    invert: bool = True,
    color_map: str = "turbo",
) -> np.ndarray:
    """Depth -> RGB on a log scale between `near` and `far` (the depth's
    own range by default), near in the map's high end with `invert`."""
    depth = np.asarray(depth, np.float32)
    near = float(depth.min()) if near is None else near
    far = float(depth.max()) if far is None else far
    near = max(near, 1e-10)
    far = max(far, near * (1 + 1e-6))
    x = (np.log(np.clip(depth, near, far)) - np.log(near)) / (np.log(far) - np.log(near))
    if invert:
        x = 1.0 - x
    return apply_color_map(x, color_map)
