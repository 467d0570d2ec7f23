"""Tiled rasterization (counterpart of the exact-precision path of
latentsplat_tpu/ops/rasterize/tiled.py), forward and backward.

Pipeline per view: per-Gaussian tile rects with the exact ellipse-tile cull
(`tile_rects`, a port of the JAX `_tile_rects`), pair duplication with
int64 (tile << 32 | depth bits) keys (`duplicate_with_keys` kernel), one
stable library sort, tile ranges by searchsorted, and per-tile compositing
(`composite_forward` kernel). The backward (`_PairComposite`, the
counterpart of the JAX `_pair_composite` custom_vjp) replays each tile
back to front (`composite_backward` kernel), writing each pair's gradient
row at its Gaussian-major position, and sums each Gaussian's contiguous
pair rows (`reduce_pairs` kernel); like the JAX package, the cull and the sort
carry no gradient. Channels stay float32 end to end; the JAX package's TPU
workarounds (fast/coef mode, payload packing, rank sorts, static pair
budgets) are not ported.
"""

from __future__ import annotations

import torch

from .kernels import TILE, composite_backward, composite_forward, duplicate_with_keys, mask_bits, reduce_pairs
from .types import ScreenGaussians

DEFAULT_MAX_TILES_PER_GAUSSIAN = 9
# The most rect slots a surviving-slot mask holds (int64); caps up to 32
# keep the main path's int32 mask.
MAX_TILES_PER_GAUSSIAN = mask_bits(torch.int64)
CULL_MARGIN = 1e-3


def _rects(sg: ScreenGaussians, tiles_x: int, tiles_y: int):
    """Per-Gaussian tile rect of the threshold-aware extents: (tx0, ty0, nx, ny) int32."""
    mx, my = sg.mean2d[:, 0], sg.mean2d[:, 1]
    ex, ey = sg.extent[:, 0], sg.extent[:, 1]

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
    return torch.where((sg.radius > 0.0)[:, None], extent, 0.0)


def covering_cap(sg: ScreenGaussians, image_shape: tuple[int, int]) -> int:
    """The least cap that keeps every rect slot of every live Gaussian: the
    largest rect, in tiles (at least 1; one host read). Raises above
    MAX_TILES_PER_GAUSSIAN, which the slot mask cannot hold."""
    h, w = image_shape
    _, _, nx, ny = _rects(sg, w // TILE, h // TILE)
    sizes = torch.where(sg.radius > 0.0, nx * ny, torch.zeros_like(nx))
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
    """Per-Gaussian (counts, base, nx, mask): int32, but for `mask`, which
    is int32 up to a cap of 32 slots and int64 above (up to 64).

    The tile rect spans the threshold-aware extents. Its first `cap` slots,
    row-major, are kept, and then a slot survives only if the minimum of the
    quadratic form over the tile's pixel-center box is at most
    log(255 * opacity) + cull_margin (else every alpha there falls below the
    threshold). `mask` has bit s set for each surviving slot s and `counts`
    is its popcount; dead Gaussians get counts 0 and mask 0.
    """
    assert 1 <= cap <= MAX_TILES_PER_GAUSSIAN
    mask_dtype = torch.int32 if cap <= mask_bits(torch.int32) else torch.int64
    num_tiles = tiles_x * tiles_y
    alive = sg.radius > 0.0
    mx, my = sg.mean2d[:, 0], sg.mean2d[:, 1]
    tx0, ty0, nx, ny = _rects(sg, tiles_x, tiles_y)
    rect_counts = torch.clamp(nx * ny, max=cap)

    ca, cb, cc = sg.conic[:, 0], sg.conic[:, 1], sg.conic[:, 2]
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
    base = torch.where(live, ty0 * tiles_x + tx0, torch.full_like(surv, num_tiles))
    nx_safe = torch.where(live, nx, torch.ones_like(nx))
    mask = torch.where(live, mask, torch.zeros_like(mask))
    return counts, base, nx_safe, mask


def sort_pairs(
    gids: torch.Tensor, keys: torch.Tensor, num_tiles: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort by (tile, depth); returns sorted gids, (T + 1,) tile
    ranges and the sort's order (sorted position -> Gaussian-major position)."""
    keys_sorted, order = torch.sort(keys, stable=True)
    tiles = keys_sorted >> 32
    boundaries = torch.arange(num_tiles + 1, device=keys.device, dtype=tiles.dtype)
    ranges = torch.searchsorted(tiles, boundaries).to(torch.int32)
    return gids[order].contiguous(), ranges, order


def pack_attributes(sg: ScreenGaussians) -> torch.Tensor:
    """(G, 6 + C + 1): x, y, conic a/b/c, opacity, channels, depth."""
    return torch.cat(
        [sg.mean2d, sg.conic, sg.opacity[:, None], sg.channels, sg.depth[:, None]], dim=1
    ).contiguous()


class _PairComposite(torch.autograd.Function):
    """Per-Gaussian attribute rows -> composited channels (n_ch, H, W) and
    final transmittance (H, W), over pairs that are already duplicated and
    sorted."""

    @staticmethod
    def forward(ctx, attrs, gids, tile_ranges, order, counts, tiles_x, image_shape):
        out, t_final, last = composite_forward(gids, tile_ranges, attrs, tiles_x, image_shape)
        ctx.save_for_backward(attrs, gids, tile_ranges, order, counts, last, t_final)
        ctx.tiles_x, ctx.image_shape = tiles_x, image_shape
        return out, t_final

    @staticmethod
    def backward(ctx, g_out, g_t):
        attrs, gids, tile_ranges, order, counts, last, t_final = ctx.saved_tensors
        d_rows = composite_backward(
            gids, tile_ranges, order, attrs, ctx.tiles_x, ctx.image_shape, last, t_final,
            g_out.contiguous(), g_t.contiguous(),
        )
        offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
        d_attrs = reduce_pairs(d_rows, offsets)
        return d_attrs, None, None, None, None, None, None


def composite_tiled(
    sg: ScreenGaussians,
    image_shape: tuple[int, int],
    background: torch.Tensor,      # (C,)
    max_tiles_per_gaussian: int = DEFAULT_MAX_TILES_PER_GAUSSIAN,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Returns (channels (C, H, W), mask (H, W), expected depth (H, W),
    number of tile pairs), the contract of `composite_dense` plus the pair
    count. Differentiable in sg.mean2d, conic, opacity, channels, depth and
    in `background`."""
    h, w = image_shape
    assert h % TILE == 0 and w % TILE == 0, "image dims must be multiples of 16"
    tiles_x, tiles_y = w // TILE, h // TILE
    c = sg.num_channels
    with torch.no_grad():
        counts, base, nx, mask = tile_rects(sg, tiles_x, tiles_y, max_tiles_per_gaussian)
        gids, keys = duplicate_with_keys(
            counts, mask, base, nx, sg.depth.contiguous(), tiles_x, max_tiles_per_gaussian
        )
        gids, tile_ranges, order = sort_pairs(gids, keys, tiles_x * tiles_y)
    out, t_final = _PairComposite.apply(
        pack_attributes(sg), gids, tile_ranges, order, counts, tiles_x, image_shape
    )
    channels = out[:c] + background[:, None, None] * t_final[None]
    return channels, 1.0 - t_final, out[c], gids.shape[0]
