"""Tiled rasterization (counterpart of latentsplat_tpu/ops/rasterize/tiled.py),
forward and backward, at each of the JAX package's precisions.

Pipeline per pass (the (scene, view) items of a render call, each with its
own screen Gaussians; the JAX package maps over them inside one program):
per-Gaussian tile rects with the exact ellipse-tile cull (`tile_rects`, a
port of the JAX `_tile_rects`; `tile_cull` kernel) over every item at once,
pair duplication with int64 (tile << 32 | depth bits) keys
(`duplicate_with_keys` kernel, item n's tiles numbered n T + t), one stable
library sort, tile ranges by one searchsorted, and per-tile compositing
(`composite_forward` kernel): one launch of each kernel and one host read a
pass. Each item's values are those of a pass of that item alone: the depth
code keeps the bits that one view's tile count leaves free, the 12-bit
channel scale is the item's own, and the kernels count scan blocks from the
item's first pair. The backward (`_PairComposite`, the counterpart of the
JAX `_pair_composite` custom_vjp) replays each tile back to front
(`composite_backward` kernel), writing each pair's gradient row at its
Gaussian-major position, and sums each Gaussian's contiguous pair rows
(`reduce_pairs` kernel); like the JAX package, the cull and the sort carry
no gradient. At "exact" the channels stay float32 end to end.

`precision` selects the JAX package's fast family by the values it
computes (`Knobs`): "fast" applies every knob, "fast_nocoef" all but the
coefficient layout, and each diagnostic precision exactly one. The TPU
mechanism behind them (payload bit packing, rank sorts, static pair
budgets) is not ported. The per-Gaussian knobs (depth order and value,
bf16 conic and opacity, 12-bit channels) are applied here, inside the
autograd function, so that the gradient passes them straight through as
the JAX custom VJP does; the per-pair ones are the composite kernels'.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...cuda_build import launch
from ...misc.profiler import host_read, span
from . import kernels
from .kernels import (
    TILE,
    block_state,
    composite_backward,
    composite_forward,
    duplicate_with_keys,
    mask_bits,
    reduce_pairs,
)
from .types import ScreenGaussians

DEFAULT_MAX_TILES_PER_GAUSSIAN = 9
# The most rect slots a surviving-slot mask holds (int64); caps up to 32
# keep the main path's int32 mask.
MAX_TILES_PER_GAUSSIAN = mask_bits(torch.int64)
CULL_MARGIN = 1e-3
FAST_CULL_MARGIN = 6e-2
# The JAX package's diagnostic precisions (tiled.py:123-127): "exact" plus
# one knob of "fast" each, and fast_nocoef, "fast" without its coefficient
# layout.
DIAGNOSTIC_PRECISIONS = (
    "exact_wide_cull", "exact_tie_depth", "exact_bf16_mm",
    "exact_q12_channels", "exact_f16_xy", "exact_bf16_conic",
    "exact_depth_val", "exact_bf16_sh", "exact_bf16_grads",
    "fast_nocoef",
)
PRECISIONS = ("exact", "fast", *DIAGNOSTIC_PRECISIONS)
# The fewest depth-code bits a fast-family sort key may keep.
MIN_DEPTH_CODE_BITS = 16


@dataclasses.dataclass(frozen=True)
class Knobs:
    """What a precision does to the values the rasterizer computes."""

    wide_cull: bool = False      # cull margin FAST_CULL_MARGIN
    tie_depth: bool = False      # order by the truncated depth code, ties Gaussian-major
    depth_value: bool = False    # the depth channel reads the code back (midpoint fill)
    f16_xy: bool = False         # each pair's mean in float16, relative to its tile
    bf16_conic: bool = False     # conic and opacity in bfloat16
    q12_channels: bool = False   # channels in 12-bit fixed point, one scale a channel
    bf16_sh: bool = False        # SH tables in bfloat16 (applied by api.render)
    bf16_mm: bool = False        # the compositor's scan, channel and row-sum terms in bfloat16
    coef: bool = False           # serving: alpha from quadratic coefficients
    bf16_grads: bool = False     # each pair's gradient row in bfloat16


_DIAGNOSTIC_KNOBS = {
    "exact_wide_cull": "wide_cull", "exact_tie_depth": "tie_depth", "exact_bf16_mm": "bf16_mm",
    "exact_q12_channels": "q12_channels", "exact_f16_xy": "f16_xy", "exact_bf16_conic": "bf16_conic",
    "exact_depth_val": "depth_value", "exact_bf16_sh": "bf16_sh", "exact_bf16_grads": "bf16_grads",
}


def precision_knobs(precision: str) -> Knobs:
    """The knobs of one of PRECISIONS; raises on any other name."""
    if precision == "exact":
        return Knobs()
    if precision in ("fast", "fast_nocoef"):
        every = {f.name: True for f in dataclasses.fields(Knobs)}
        return Knobs(**{**every, "coef": precision == "fast"})
    if precision in _DIAGNOSTIC_KNOBS:
        return Knobs(**{_DIAGNOSTIC_KNOBS[precision]: True})
    raise ValueError(f"unknown rasterizer precision {precision!r}; expected one of {PRECISIONS}")


def is_fast(precision: str) -> bool:
    return precision in ("fast", "fast_nocoef")


def depth_code_bits(num_tiles: int) -> tuple[int, int]:
    """(code_bits, code_shift): the depth code keeps the top code_bits of a
    positive float32's bits, every bit that the tile field (num_tiles + 1
    values) leaves free in the JAX package's int31 sort key; 22 at 256
    tiles."""
    code_bits = 31 - (num_tiles + 2).bit_length()
    return code_bits, 31 - code_bits


def truncated_depth(depth: torch.Tensor, code_shift: int, midpoint: bool = False) -> torch.Tensor:
    """Depth with the low code_shift bits of its float32 bits cleared (the
    sort order of the depth code) or, with `midpoint`, set to the middle of
    the dropped range (the value the code reads back as)."""
    bits = depth.contiguous().view(torch.int32) & ~((1 << code_shift) - 1)
    if midpoint:
        bits = bits | (1 << (code_shift - 1))
    return bits.view(torch.float32)


def quantize_attributes(attrs: torch.Tensor, knobs: Knobs, code_shift: int, items: int = 1) -> torch.Tensor:
    """The per-Gaussian value knobs applied to a pass's `pack_attributes`
    rows (`items` items of equal length): conic and opacity rounded to
    bfloat16; each channel (not the depth) in 12-bit fixed point over its
    largest magnitude among the item's Gaussians (at least 1e-8); the depth
    read back from its code."""
    if not (knobs.bf16_conic or knobs.q12_channels or knobs.depth_value):
        return attrs
    out = attrs.clone()
    if knobs.bf16_conic:
        out[:, 2:6] = attrs[:, 2:6].to(torch.bfloat16).float()
    if knobs.q12_channels and attrs.shape[0]:
        c = attrs[:, 6:-1].reshape(items, -1, attrs.shape[1] - 7)
        s = torch.clamp(c.abs().amax(dim=1, keepdim=True), min=1e-8)
        q = torch.clamp(torch.round((c / s * 0.5 + 0.5) * 4095.0), 0.0, 4095.0)
        out[:, 6:-1] = ((q / 4095.0 * 2.0 - 1.0) * s).reshape(attrs.shape[0], -1)
    if knobs.depth_value:
        out[:, -1] = truncated_depth(attrs[:, -1], code_shift, midpoint=True)
    return out


def items_of(sg: ScreenGaussians) -> int:
    """The number of items of a pass's screen Gaussians (the leading axes
    before G; one for a single view's)."""
    return math.prod(sg.radius.shape[:-1])


def _rects(sg: ScreenGaussians, tiles_x: int, tiles_y: int):
    """Per-Gaussian tile rect of the threshold-aware extents: (tx0, ty0, nx, ny) int32."""
    mx, my = sg.mean2d[..., 0], sg.mean2d[..., 1]
    ex, ey = sg.extent[..., 0], sg.extent[..., 1]

    def tile_index(v, n):
        return torch.clamp(torch.floor(v / TILE), 0, n - 1).to(torch.int32)

    tx0, tx1 = tile_index(mx - ex, tiles_x), tile_index(mx + ex, tiles_x)
    ty0, ty1 = tile_index(my - ey, tiles_y), tile_index(my + ey, tiles_y)
    return tx0, ty0, tx1 - tx0 + 1, ty1 - ty0 + 1


def dense_extent(sg: ScreenGaussians) -> torch.Tensor:
    """(G, 2) per-axis half-extents beyond which every alpha falls below the
    threshold, not clipped at the 3-sigma radius as `ScreenGaussians.extent`
    is: the footprint the dense compositor draws. The 2D covariance's
    diagonal is read back from the conic."""
    a, b, c = sg.conic.unbind(-1)
    det = torch.clamp(a * c - b * b, min=1e-30)
    two_lo = 2.0 * torch.clamp(torch.log(255.0 * torch.clamp(sg.opacity, min=1e-12)) + 1e-3, min=0.0)
    extent = torch.stack([torch.sqrt(two_lo * c / det), torch.sqrt(two_lo * a / det)], dim=-1) * 1.001 + 0.01
    return torch.where((sg.radius > 0.0)[..., None], extent, 0.0)


def covering_cap(sg: ScreenGaussians, image_shape: tuple[int, int]) -> int:
    """The least cap that keeps every rect slot of every live Gaussian of
    every item of the pass: the largest rect, in tiles (at least 1; one
    host read). Raises above MAX_TILES_PER_GAUSSIAN, which the slot mask
    cannot hold."""
    h, w = image_shape
    _, _, nx, ny = _rects(sg, w // TILE, h // TILE)
    sizes = torch.where(sg.radius > 0.0, nx * ny, torch.zeros_like(nx))
    with host_read("covering_cap"):
        largest = max(int(sizes.max()), 1) if sizes.numel() else 1
    if largest > MAX_TILES_PER_GAUSSIAN:
        raise ValueError(
            f"a Gaussian's tile rect spans {largest} tiles of {image_shape}; the slot mask "
            f"holds {MAX_TILES_PER_GAUSSIAN}"
        )
    return largest


def tile_rects(
    sg: ScreenGaussians, tiles_x: int, tiles_y: int, cap: int = DEFAULT_MAX_TILES_PER_GAUSSIAN,
    cull_margin: float = CULL_MARGIN,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-Gaussian (counts, base, nx, mask) of a pass, flattened to (N G,):
    int32, but for `mask`, which is int32 up to a cap of 32 slots and int64
    above (up to 64). `base` is the pass tile id n T + t of item n's rect
    origin (T = tiles_x tiles_y), and N T for a dead Gaussian.

    The tile rect spans the threshold-aware extents. Its first `cap` slots,
    row-major, are kept, and then a slot survives only if the minimum of the
    quadratic form over the tile's pixel-center box is at most
    log(255 * opacity) + cull_margin (else every alpha there falls below the
    threshold). `mask` has bit s set for each surviving slot s and `counts`
    is its popcount; dead Gaussians get counts 0 and mask 0.

    Given CPU tensors it runs `tile_rects_reference`; given CUDA tensors it
    launches the `tile_cull` kernel (one launch a pass, the same bits) or
    raises.
    """
    assert 1 <= cap <= MAX_TILES_PER_GAUSSIAN
    inputs = (sg.mean2d, sg.extent, sg.conic, sg.opacity, sg.radius)
    if not kernels._on_cuda(*inputs):
        return tile_rects_reference(sg, tiles_x, tiles_y, cap, cull_margin)
    gaussians = sg.radius.shape[-1]
    rows = items_of(sg) * gaussians
    flat = []
    for t, name, width in zip(inputs, ("mean2d", "extent", "conic", "opacity", "radius"), (2, 2, 3, 1, 1)):
        if t.dtype != torch.float32 or t.numel() != rows * width:
            raise ValueError(f"tile_rects: {name} must be float32 with {width} value(s) a row of "
                             f"{tuple(sg.radius.shape)}, got {t.dtype} {tuple(t.shape)}")
        t = t.detach().reshape(-1).contiguous()
        flat.append(t if t.data_ptr() % 8 == 0 else t.clone())   # float2 loads of mean2d and extent
    if rows >= 2**31:
        raise ValueError(f"tile_rects: {rows} rows exceed the kernel's int32 index")
    mask_dtype = torch.int32 if cap <= mask_bits(torch.int32) else torch.int64
    counts, base, nx = (torch.empty(rows, dtype=torch.int32, device=sg.radius.device) for _ in range(3))
    mask = torch.empty(rows, dtype=mask_dtype, device=sg.radius.device)
    launch(
        "tile_cull", rows, gaussians, tiles_x, tiles_y, cap, cull_margin, *(t.data_ptr() for t in flat),
        counts.data_ptr(), base.data_ptr(), nx.data_ptr(), mask.data_ptr(), kernels._stream(), kernel="tile_cull",
    )
    return counts, base, nx, mask


def tile_rects_reference(
    sg: ScreenGaussians, tiles_x: int, tiles_y: int, cap: int = DEFAULT_MAX_TILES_PER_GAUSSIAN,
    cull_margin: float = CULL_MARGIN,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `tile_rects` (the `tile_cull` kernel), on any
    device: the JAX `_tile_rects` in PyTorch, whose float32 operations, in
    this order, the kernel repeats bit for bit."""
    assert 1 <= cap <= MAX_TILES_PER_GAUSSIAN
    mask_dtype = torch.int32 if cap <= mask_bits(torch.int32) else torch.int64
    num_tiles = tiles_x * tiles_y
    items = items_of(sg)
    alive = sg.radius > 0.0
    mx, my = sg.mean2d[..., 0], sg.mean2d[..., 1]
    tx0, ty0, nx, ny = _rects(sg, tiles_x, tiles_y)
    rect_counts = torch.clamp(nx * ny, max=cap)

    ca, cb, cc = sg.conic[..., 0], sg.conic[..., 1], sg.conic[..., 2]
    thresh = torch.log(255.0 * torch.clamp(sg.opacity, min=1e-12)) + cull_margin
    ca_s = torch.clamp(ca, min=1e-12)
    cc_s = torch.clamp(cc, min=1e-12)
    tx0_f, ty0_f, nx_f = tx0.float(), ty0.float(), nx.float()
    mask = torch.zeros_like(nx, dtype=mask_dtype)
    surv = torch.zeros_like(nx)

    def q_at_x(a, dy0, dy1):   # min over dy in [dy0, dy1] of q(a, dy)
        yc = torch.minimum(torch.maximum(-cb * a / cc_s, dy0), dy1)
        return 0.5 * ca * a * a + cb * a * yc + 0.5 * cc * yc * yc

    def q_at_y(b, dx0, dx1):   # min over dx in [dx0, dx1] of q(dx, b)
        xc = torch.minimum(torch.maximum(-cb * b / ca_s, dx0), dx1)
        return 0.5 * ca * xc * xc + cb * xc * b + 0.5 * cc * b * b

    for s in range(cap):
        row_f = torch.floor((s + 0.5) / nx_f)
        col_f = s - row_f * nx_f
        dx0 = (tx0_f + col_f) * TILE - mx
        dx1 = dx0 + (TILE - 1)
        dy0 = (ty0_f + row_f) * TILE - my
        dy1 = dy0 + (TILE - 1)
        inside = (dx0 <= 0.0) & (dx1 >= 0.0) & (dy0 <= 0.0) & (dy1 >= 0.0)
        q_min = torch.minimum(
            torch.minimum(q_at_x(dx0, dy0, dy1), q_at_x(dx1, dy0, dy1)),
            torch.minimum(q_at_y(dy0, dx0, dx1), q_at_y(dy1, dx0, dx1)),
        )
        q_min = torch.where(inside, 0.0, q_min)
        bit = ((s < rect_counts) & (q_min <= thresh)).to(torch.int32)
        mask = mask | (bit.to(mask_dtype) << s)
        surv = surv + bit

    live = alive & (surv > 0)
    zero = torch.zeros_like(surv)
    counts = torch.where(live, surv, zero)
    item_tile = (torch.arange(items, dtype=torch.int32, device=surv.device) * num_tiles).reshape(
        *surv.shape[:-1], 1)
    base = torch.where(live, ty0 * tiles_x + tx0 + item_tile, torch.full_like(surv, items * num_tiles))
    nx_safe = torch.where(live, nx, torch.ones_like(nx))
    mask = torch.where(live, mask, torch.zeros_like(mask))
    return counts.reshape(-1), base.reshape(-1), nx_safe.reshape(-1), mask.reshape(-1)


def sort_pairs(
    gids: torch.Tensor, keys: torch.Tensor, num_tiles: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort by (tile, depth) of a pass's pairs (num_tiles = N T);
    returns sorted gids, (N T + 1,) tile ranges and the sort's order
    (sorted position -> Gaussian-major position)."""
    keys_sorted, order = torch.sort(keys, stable=True)
    tiles = keys_sorted >> 32
    boundaries = torch.arange(num_tiles + 1, device=keys.device, dtype=tiles.dtype)
    ranges = torch.searchsorted(tiles, boundaries).to(torch.int32)
    return gids[order].contiguous(), ranges, order


def pack_attributes(sg: ScreenGaussians) -> torch.Tensor:
    """(N G, 6 + C + 1): x, y, conic a/b/c, opacity, channels, depth, item
    n's rows at n G."""
    rows = torch.cat([sg.mean2d, sg.conic, sg.opacity[..., None], sg.channels, sg.depth[..., None]], dim=-1)
    return rows.reshape(-1, rows.shape[-1]).contiguous()


class _PairComposite(torch.autograd.Function):
    """A pass's per-Gaussian attribute rows -> composited channels
    (N, n_ch, H, W) and final transmittance (N, H, W), over pairs that are
    already duplicated and sorted. The value knobs quantize the rows the
    kernels read; the gradient reaches `attrs` unquantized (straight
    through)."""

    @staticmethod
    def forward(ctx, attrs, gids, tile_ranges, order, counts, tiles_x, image_shape, knobs, code_shift, want_grad):
        items, num_tiles = kernels.pass_items(tile_ranges, image_shape)
        rows = quantize_attributes(attrs, knobs, code_shift, items)
        blocks = block_state(tile_ranges, gids.shape[0], num_tiles) if knobs.bf16_mm and want_grad else None
        out, t_final, last = composite_forward(
            gids, tile_ranges, rows, tiles_x, image_shape, f16_xy=knobs.f16_xy, bf16_mm=knobs.bf16_mm,
            coef=knobs.coef and not want_grad, blocks=blocks,
        )
        ctx.save_for_backward(rows, gids, tile_ranges, order, counts, last, t_final, *(blocks or ()))
        ctx.tiles_x, ctx.image_shape, ctx.knobs = tiles_x, image_shape, knobs
        return out, t_final

    @staticmethod
    def backward(ctx, g_out, g_t):
        rows, gids, tile_ranges, order, counts, last, t_final, *blocks = ctx.saved_tensors
        knobs = ctx.knobs
        d_rows = composite_backward(
            gids, tile_ranges, order, rows, ctx.tiles_x, ctx.image_shape, last, t_final,
            g_out.contiguous(), g_t.contiguous(), f16_xy=knobs.f16_xy, bf16_mm=knobs.bf16_mm,
            bf16_grads=knobs.bf16_grads, blocks=tuple(blocks) or None,
        )
        offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
        d_attrs = reduce_pairs(d_rows, offsets)
        return d_attrs, *([None] * 9)


def tile_pairs(
    sg: ScreenGaussians, image_shape: tuple[int, int], max_tiles_per_gaussian: int = DEFAULT_MAX_TILES_PER_GAUSSIAN,
    precision: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pairs `composite_tiled` composites at `precision` for a pass's
    screen Gaussians, duplicated and sorted (no gradient): (gids, tile
    ranges (N T + 1,), order, counts, each item's pair total (N,) int64 on
    the CPU). The fast family refuses a view whose tile count leaves a
    depth code of fewer than MIN_DEPTH_CODE_BITS bits."""
    h, w = image_shape
    assert h % TILE == 0 and w % TILE == 0, "image dims must be multiples of 16"
    tiles_x, tiles_y = w // TILE, h // TILE
    items = items_of(sg)
    knobs = precision_knobs(precision)
    code_bits, code_shift = depth_code_bits(tiles_x * tiles_y)
    if is_fast(precision) and code_bits < MIN_DEPTH_CODE_BITS:
        raise ValueError(f"{tiles_x * tiles_y} tiles leave a {code_bits}-bit depth code, under the "
                         f"{MIN_DEPTH_CODE_BITS} bits the {precision!r} precision needs")
    cull_margin = FAST_CULL_MARGIN if knobs.wide_cull else CULL_MARGIN
    with torch.no_grad():
        with span("render.cull"):
            counts, base, nx, mask = tile_rects(sg, tiles_x, tiles_y, max_tiles_per_gaussian, cull_margin)
        with span("render.sort"):
            depth = sg.depth.reshape(-1)
            depth = truncated_depth(depth, code_shift) if knobs.tie_depth else depth.contiguous()
            gids, keys, pairs = duplicate_with_keys(
                counts, mask, base, nx, depth, tiles_x, max_tiles_per_gaussian, items)
            gids, tile_ranges, order = sort_pairs(gids, keys, items * tiles_x * tiles_y)
    return gids, tile_ranges, order, counts, pairs


def composite_tiled(
    sg: ScreenGaussians,
    image_shape: tuple[int, int],
    background: torch.Tensor,      # (..., C), one row an item
    max_tiles_per_gaussian: int = DEFAULT_MAX_TILES_PER_GAUSSIAN,
    precision: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composites a pass: screen Gaussians with leading item axes (...)
    before G (none for one view). Returns (channels (..., C, H, W), mask
    (..., H, W), expected depth (..., H, W), each item's number of tile
    pairs (...) int64 on the CPU), the contract of `composite_dense` plus
    the pair counts. Differentiable in sg.mean2d, conic, opacity, channels,
    depth and in `background`. `precision` is one of PRECISIONS; "fast"
    serves (no gradient wanted) through the coefficient layout."""
    lead = sg.radius.shape[:-1]
    gids, tile_ranges, order, counts, pairs = tile_pairs(sg, image_shape, max_tiles_per_gaussian, precision)
    h, w = image_shape
    tiles_x = w // TILE
    with span("render.composite"):
        attrs = pack_attributes(sg)
        want_grad = torch.is_grad_enabled() and attrs.requires_grad
        out, t_final = _PairComposite.apply(
            attrs, gids, tile_ranges, order, counts, tiles_x, image_shape, precision_knobs(precision),
            depth_code_bits(tiles_x * (h // TILE))[1], want_grad,
        )
        c = sg.num_channels
        channels = out[:, :c] + background.reshape(-1, c, 1, 1) * t_final[:, None]
    return (channels.reshape(*lead, c, h, w), (1.0 - t_final).reshape(*lead, h, w),
            out[:, c].reshape(*lead, h, w), pairs.reshape(lead))
