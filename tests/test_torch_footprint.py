"""The footprint box by which composite_forward culls pairs per warp
(`kernels.footprint_box_reference`, the box the kernel computes): no pixel
outside it passes the forward's alpha test, so the cull never drops a pair
that composites. Conics, opacities, means and pixel offsets come from
hypothesis; near-degenerate and non-positive-definite conics included."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from latentsplat_tpu_torch.ops.rasterize import kernels
from latentsplat_tpu_torch.ops.rasterize.camera import ALPHA_CLAMP, ALPHA_THRESHOLD
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

# Pixels checked: those within EDGE of the box's edges and the drawn ones,
# all within REACH of the image origin.
EDGE = 4
REACH = 5000


def passes(row: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The forward's alpha test of one pair at float32 pixel centers, with
    composite_forward_reference's operations."""
    x, y, ca, cb, cc, op = row[:6]
    dx = px - x
    dy = py - y
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=ALPHA_CLAMP)
    return (power <= 0.0) & (alpha >= ALPHA_THRESHOLD)


def grid(xs: tuple[float, float], ys: tuple[float, float]) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer pixels in [xs] x [ys], both clipped to REACH of the origin."""
    (xa, xb), (ya, yb) = ((max(math.floor(a), -REACH), min(math.ceil(b), REACH)) for a, b in (xs, ys))
    gy, gx = torch.meshgrid(torch.arange(ya, yb + 1.0), torch.arange(xa, xb + 1.0), indexing="ij")
    return gx.reshape(-1), gy.reshape(-1)


def check_box(row: np.ndarray, offsets: list[tuple[int, int]]) -> None:
    attrs = torch.from_numpy(np.asarray([list(row) + [0.5, 0.25]], np.float32))
    x0, x1, y0, y1 = kernels.footprint_box_reference(attrs)[0].tolist()
    x, y = float(attrs[0, 0]), float(attrs[0, 1])
    if math.isinf(x0) and x0 < 0:
        assert x1 == y1 == math.inf and y0 == -math.inf
        return
    # Pixels drawn around the mean, and every pixel within EDGE of the box's
    # edges (for an empty box, of the mean).
    parts = [grid((x + ox, x + ox), (y + oy, y + oy)) for ox, oy in offsets]
    if x0 <= x1:
        assert y0 <= y1
        wx, wy = (x0 - EDGE, x1 + EDGE), (y0 - EDGE, y1 + EDGE)
        parts += [grid((x0 - EDGE, x0), wy), grid((x1, x1 + EDGE), wy),
                  grid(wx, (y0 - EDGE, y0)), grid(wx, (y1, y1 + EDGE))]
    else:
        parts.append(grid((x - 20, x + 20), (y - 20, y + 20)))
    px = torch.cat([p[0] for p in parts])
    py = torch.cat([p[1] for p in parts])
    outside = (px < x0) | (px > x1) | (py < y0) | (py > y1)
    hit = passes(attrs[0], px, py)
    assert not (hit & outside).any(), (
        f"pixels outside the box pass: {list(zip(px[hit & outside].tolist(), py[hit & outside].tolist()))[:4]}"
    )


offsets = st.lists(st.tuples(st.integers(-300, 300), st.integers(-300, 300)), max_size=8)
means = st.floats(-40.0, 300.0, allow_nan=False)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(
    sx=st.floats(0.3, 70.0), sy=st.floats(0.3, 70.0),
    rho=st.one_of(st.floats(-0.99, 0.99), st.floats(0.999, 0.99999), st.floats(-0.99999, -0.999)),
    opacity=st.one_of(st.floats(0.0, 1.0), st.floats(0.0035, 0.0045)),
    x=means, y=means, offsets=offsets,
)
def test_no_pixel_outside_the_box_passes_covariances(sx, sy, rho, opacity, x, y, offsets):
    # Conics of a 2D covariance (sx, sy, rho): every axis ratio and, with
    # |rho| up to 0.99999, far past the camera's 0.99 clamp.
    det = (sx * sy) ** 2 * (1.0 - rho * rho)
    conic = [sy * sy / det, -rho * sx * sy / det, sx * sx / det]
    check_box(np.array([x, y, *conic, opacity]), offsets)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(
    ca=st.floats(-1.0, 12.0), cb=st.floats(-6.0, 6.0), cc=st.floats(-1.0, 12.0),
    opacity=st.floats(0.0, 1.0), x=means, y=means, offsets=offsets,
)
def test_no_pixel_outside_the_box_passes_raw_conics(ca, cb, cc, opacity, x, y, offsets):
    # Raw (a, b, c): indefinite, negative and degenerate conics among them.
    check_box(np.array([x, y, ca, cb, cc, opacity]), offsets)


@pytest.mark.parametrize(
    "row, kind",
    [
        ([10.5, 20.25, 0.5, 0.1, 0.4, 0.8], "bounded"),
        ([10.5, 20.25, 0.5, 0.1, 0.4, 0.003], "empty"),        # opacity < 1/255
        ([10.5, 20.25, 0.1, 0.2, 0.1, 0.8], "unbounded"),      # b^2 > ac
        ([10.5, 20.25, -0.5, 0.0, 0.4, 0.8], "unbounded"),     # a < 0
        ([10.5, 20.25, 1.0, 0.99999, 1.0, 0.8], "unbounded"),  # det below FOOTPRINT_DET_MIN a c
    ],
)
def test_box_kinds(row, kind):
    box = kernels.footprint_box_reference(torch.tensor([row + [0.0, 0.0]]))[0].tolist()
    if kind == "bounded":
        assert all(math.isfinite(v) for v in box) and box[0] < 10.5 < box[1] and box[2] < 20.25 < box[3]
    elif kind == "empty":
        assert box[0] > box[1] and box[2] > box[3]
    else:
        assert box == [-math.inf, math.inf, -math.inf, math.inf]
    check_box(np.array(row), [(0, 0), (3, -2)])
