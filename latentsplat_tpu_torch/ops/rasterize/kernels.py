"""The rasterizer's four kernels, each beside its plain PyTorch version.

* `duplicate_with_keys` (csrc/duplicate_with_keys.cu) replaces
  latentsplat_tpu/ops/rasterize/expand.py::expand_by_counts.
* `composite_forward` (csrc/composite_forward.cu) replaces
  latentsplat_tpu/ops/rasterize/pallas_kernels.py::composite_pairs_fwd.
* `composite_backward` (csrc/composite_backward.cu) replaces
  latentsplat_tpu/ops/rasterize/pallas_kernels.py::composite_pairs_bwd.
* `reduce_pairs` (csrc/reduce_pairs.cu) replaces
  latentsplat_tpu/ops/rasterize/expand.py::reduce_by_counts.

A fifth, `tile_cull` (csrc/tile_cull.cu), replaces no TPU kernel: it is
the tile cull of tiled.py::tile_rects, whose wrapper and plain version
live there. Nor does a sixth, `shade_project` (csrc/shade_project.cu): a
pass's SH payload and projection, whose wrapper and plain version live in
shade.py.

Every kernel works on a pass: the (scene, view) items of one render call,
laid out one after another. Item n's Gaussians are rows n G .. n G + G - 1
of the per-Gaussian inputs (pair ids n G + g), its tiles are n T .. n T +
T - 1 of the pass's N T tiles (T = one view's tile count), and its pairs
are one contiguous, tile-sorted segment of the pair array. The composite
kernels split a tile id into (item, local tile), so that pixel coordinates
stay those of the item's own view, and write outputs with a leading item
axis: channels (N, n_ch, H, W), transmittance and `last` (N, H, W). A pass
of one item is the same code with N = 1.

A wrapper given CPU tensors runs the `*_reference` version; given CUDA
tensors it launches the kernel (`cuda_build.launch`, which counts each
launch by kernel, variant and channel count) or raises.

The composite kernels take the per-pair knobs of the JAX package's fast
precision family (latentsplat_tpu/ops/rasterize/tiled.py): `f16_xy`, the
pair's mean rounded to float16 relative to its tile's origin; `bf16_mm`,
the bfloat16 rounding of each term that the TPU kernels fed their scan,
channel and row-sum matmuls (`_mm(fast=True)`, pallas_kernels.py:116),
with float32 accumulation; `coef` (forward only), alpha from the six
quadratic coefficients of the pixel offset built from the rounded row,
with no power > 0 guard; `bf16_grads` (backward only), each pair's
gradient row rounded to bfloat16 when it is written.

Under `bf16_mm` the compositor works in log space, as the TPU kernels did:
a pair's transmittance is exp of the float32 sum of log1p(-alpha) over the
earlier SCAN_BLOCK-blocks (blocks of 128 positions of the tile-sorted pair
array) plus the bfloat16-rounded log1p(-alpha) of the earlier pairs in its
own block. The blocks are counted from each item's first pair, so that an
item's values are those of a pass of that item alone. The forward writes each pixel's (log T at the block's start,
bfloat16 sum within it) for every block where it composited a pair into
`blocks` (`block_state`); the backward reads them back, so that it
recovers the forward's transmittances with the forward's rounding.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...cuda_build import launch, load_library
from ...misc.profiler import host_read
from .camera import ALPHA_CLAMP, ALPHA_THRESHOLD

TILE = 16
PIX = TILE * TILE
TRANSMITTANCE_MIN = 1e-4
# log(TRANSMITTANCE_MIN) in float32: the stop test of the log-space
# (bf16_mm) compositor.
LOG_TRANSMITTANCE_MIN = float(np.float32(math.log(TRANSMITTANCE_MIN)))
# The TPU kernels' prefix-scan block (pallas_kernels.py:58): bf16_mm rounds
# the log1p(-alpha) terms within a block, not across blocks.
SCAN_BLOCK = 128
# composite_forward's warps each own a block of 4 rows x 8 columns of a tile.
WARP_ROWS, WARP_COLS = 4, 8
# A conic with det <= FOOTPRINT_DET_MIN * a * c gets an unbounded footprint
# box: the camera clamps |rho| <= 0.99 (det >= 0.0199 a c), and nearer to
# degenerate the rounding of power could outgrow the box's margins.
FOOTPRINT_DET_MIN = 1e-3

def variant_name(f16_xy: bool = False, bf16_mm: bool = False, coef: bool = False, bf16_grads: bool = False) -> str:
    """A composite kernel's variant: "exact", "fast" (f16_xy and bf16_mm,
    with bf16_grads in the backward), "coef" (fast with coef), or the one
    knob that is set."""
    if coef:
        return "coef"
    if f16_xy and bf16_mm:
        return "fast"
    on = [name for name, v in (("f16_xy", f16_xy), ("bf16_mm", bf16_mm), ("bf16_grads", bf16_grads)) if v]
    return on[0] if on else "exact"


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return False
    if devices != {"cuda"}:
        raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {devices}")
    return True


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# -- duplicate_with_keys ---------------------------------------------------------


def mask_bits(dtype: torch.dtype) -> int:
    """Rect slots a surviving-slot mask of `dtype` holds: int32 on the main
    path, int64 for larger caps."""
    return {torch.int32: 32, torch.int64: 64}[dtype]


def duplicate_with_keys_reference(
    counts: torch.Tensor, mask: torch.Tensor, base: torch.Tensor, nx: torch.Tensor,
    depth: torch.Tensor, tiles_x: int, cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `duplicate_with_keys`: the set bits of every mask,
    Gaussian-major and slot-ascending, as (gids int32, keys int64)."""
    slots = torch.arange(cap, device=mask.device, dtype=torch.int32)
    bits = ((mask[:, None] >> slots[None, :]) & 1).bool()
    gid, slot = bits.nonzero(as_tuple=True)
    assert gid.numel() == int(counts.sum())
    w = nx[gid].long()
    row = slot // w
    tile = base[gid].long() + row * tiles_x + (slot - row * w)
    depth_bits = depth.view(torch.int32).long()[gid]
    return gid.to(torch.int32), (tile << 32) | depth_bits


def duplicate_with_keys(
    counts: torch.Tensor,   # (N G,) int32 pairs per Gaussian (popcount of mask)
    mask: torch.Tensor,     # (N G,) int32 (cap <= 32) or int64 (cap <= 64) surviving rect slots
    base: torch.Tensor,     # (N G,) int32 pass tile id of the rect origin (n T + local tile)
    nx: torch.Tensor,       # (N G,) int32 rect width in tiles
    depth: torch.Tensor,    # (N G,) float32 camera-space depth (> 0 where counts > 0)
    tiles_x: int,
    cap: int,
    items: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (pass Gaussian id, key = tile << 32 | depth bits) pair per
    surviving tile, Gaussian-major, and each of the `items` items' pair
    total ((N,) int64 on the CPU). The pair buffer is sized exactly from
    one host read of the per-item totals."""
    g = counts.shape[0]
    if items < 1 or g % items:
        raise ValueError(f"duplicate_with_keys: {g} Gaussians do not split into {items} items")
    if not _on_cuda(counts, mask, base, nx, depth):
        gids, keys = duplicate_with_keys_reference(counts, mask, base, nx, depth, tiles_x, cap)
        return gids, keys, counts.long().reshape(items, -1).sum(dim=1)
    for t, name in ((counts, "counts"), (base, "base"), (nx, "nx")):
        _check(t, name, torch.int32, 1)
    _check(mask, "mask", torch.int64 if mask.dtype == torch.int64 else torch.int32, 1)
    if cap > mask_bits(mask.dtype):
        raise ValueError(f"duplicate_with_keys: a {mask.dtype} mask holds {mask_bits(mask.dtype)} slots, cap is {cap}")
    _check(depth, "depth", torch.float32, 1)
    if not all(t.shape[0] == g for t in (mask, base, nx, depth)):
        raise ValueError("duplicate_with_keys: per-Gaussian inputs differ in length")
    # torch.sort needs the exact pair count: the pass's one wait on the
    # device, which reads every item's running total at once.
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    with host_read("pair_totals"):
        ends = offsets.reshape(items, -1)[:, -1].cpu() if g else torch.zeros(items, dtype=torch.int64)
    total = int(ends[-1])
    gids = torch.empty((total,), dtype=torch.int32, device=counts.device)
    keys = torch.empty((total,), dtype=torch.int64, device=counts.device)
    _launch_duplicate_with_keys(offsets, mask, base, nx, depth, tiles_x, gids, keys)
    return gids, keys, torch.diff(ends, prepend=ends.new_zeros(1))


def _launch_duplicate_with_keys(
    offsets: torch.Tensor, mask: torch.Tensor, base: torch.Tensor, nx: torch.Tensor,
    depth: torch.Tensor, tiles_x: int, gids: torch.Tensor, keys: torch.Tensor,
) -> None:
    """The kernel launch of `duplicate_with_keys` into buffers sized by the
    caller (offsets int64, inclusive); does not wait on the device. An int64
    `mask` launches the 64-bit instantiation."""
    if gids.data_ptr() % 16 or keys.data_ptr() % 16:
        raise ValueError("duplicate_with_keys: gids and keys must be 16-byte aligned")
    launch(
        "duplicate_with_keys64" if mask.dtype == torch.int64 else "duplicate_with_keys", offsets.shape[0],
        offsets.data_ptr(), mask.data_ptr(), base.data_ptr(), nx.data_ptr(), depth.data_ptr(), tiles_x,
        gids.data_ptr(), keys.data_ptr(), _stream(), kernel="duplicate_with_keys",
    )


# -- composite_forward -----------------------------------------------------------


def _tile_pixels(num_tiles: int, tiles_x: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates (T, PIX) of every tile of one view,
    row-major in the tile."""
    tile = torch.arange(num_tiles, device=device)[:, None]
    p = torch.arange(PIX, device=device)[None, :]
    px = (tile % tiles_x) * TILE + p % TILE
    py = (tile // tiles_x) * TILE + p // TILE
    return px.float(), py.float()


def pass_items(tile_ranges: torch.Tensor, image_shape: tuple[int, int]) -> tuple[int, int]:
    """(items N, tiles T of one view) of a pass's (N T + 1,) tile ranges;
    raises when they do not match the image."""
    h, w = image_shape
    if h % TILE or w % TILE:
        raise ValueError(f"image dims must be multiples of {TILE}, got {image_shape}")
    num_tiles = (h // TILE) * (w // TILE)
    n_tiles = tile_ranges.shape[0] - 1
    if tile_ranges.dim() != 1 or n_tiles < num_tiles or n_tiles % num_tiles:
        raise ValueError(f"{n_tiles} tile ranges are no whole number of {image_shape} views")
    return n_tiles // num_tiles, num_tiles


def item_starts(tile_ranges: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """(N T,) int64: the first pair position of each tile's item (that of
    its item's first tile), from which the scan blocks are counted."""
    first = tile_ranges[:-1:num_tiles].long()
    return first.repeat_interleave(num_tiles)


def untile(x: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(N T, ..., PIX) per-tile values of a pass -> (N, ..., H, W)."""
    rest = x.shape[1:-1]
    x = x.reshape(-1, tiles_y, tiles_x, *rest, TILE, TILE)
    x = x.movedim((1, 2), (-4, -2))          # (N, ..., tiles_y, TILE, tiles_x, TILE)
    return x.reshape(x.shape[0], *rest, tiles_y * TILE, tiles_x * TILE)


def tile(x: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(N, ..., H, W) -> (N T, ..., PIX), the inverse of `untile`."""
    rest = x.shape[1:-2]
    x = x.reshape(x.shape[0], *rest, tiles_y, TILE, tiles_x, TILE)
    x = x.movedim((-4, -2), (1, 2))          # (N, tiles_y, tiles_x, ..., TILE, TILE)
    return x.reshape(-1, *rest, PIX)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bfloat16 (nearest, ties to even) and back to float32."""
    return x.to(torch.bfloat16).float()


def _coef_power(xr, yr, ca, cb, cc, op, pxr, pyr) -> torch.Tensor:
    """power + log(opacity) at tile-relative pixels (pxr, pyr) in the
    coefficient layout: the six coefficients from the tile-relative mean
    and the conic and opacity, in latentsplat_tpu/ops/rasterize/tiled.py's
    order of operations (:496-506), dotted with [px^2, px, py^2, py, px py,
    1] left to right."""
    log_op = torch.log(torch.clamp(op, min=1e-12))
    c = [
        -0.5 * ca,
        ca * xr + cb * yr,
        -0.5 * cc,
        cc * yr + cb * xr,
        -cb,
        log_op - 0.5 * (ca * xr * xr + cc * yr * yr) - cb * xr * yr,
    ]
    basis = (pxr * pxr, pxr, pyr * pyr, pyr, pxr * pyr)
    out = c[0] * basis[0]
    for k in range(1, 5):
        out = out + c[k] * basis[k]
    return out + c[5]


def block_state(tile_ranges: torch.Tensor, num_pairs: int, num_tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16_mm compositor's per-block state buffers for a pass's pairs
    (`num_tiles` tiles a view): (offsets (N T,) int32, state (B, PIX, 2)
    float32). Tile t's scan blocks (the SCAN_BLOCK-aligned blocks of its
    item's pair segment that its pairs meet, in order) are rows
    offsets[t], offsets[t] + 1, ... of `state`; B is num_pairs //
    SCAN_BLOCK + 2 N T, which bounds their number without a host read. The
    forward fills, for each (block, pixel) where the pixel composited a
    pair, the log transmittance at the block's start and the bfloat16 sum
    of its log1p(-alpha) terms in the block; other entries stay unwritten."""
    starts, stops = tile_ranges[:-1].long(), tile_ranges[1:].long()
    first = item_starts(tile_ranges, num_tiles)
    n = torch.where(stops > starts, (stops - 1 - first) // SCAN_BLOCK - (starts - first) // SCAN_BLOCK + 1, 0)
    offsets = (torch.cumsum(n, 0) - n).to(torch.int32)
    capacity = num_pairs // SCAN_BLOCK + 2 * starts.shape[0]
    return offsets, torch.empty((capacity, PIX, 2), dtype=torch.float32, device=tile_ranges.device)


def _block_rows(offsets: torch.Tensor, starts: torch.Tensor, first: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Row of the block state of each tile's block holding position pos;
    `offsets` are the tiles' first rows (`block_state`), `first` their
    items' first pairs."""
    return offsets + (pos - first) // SCAN_BLOCK - (starts - first) // SCAN_BLOCK


def _longest_first(lengths: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
    """The plain versions' tile order, longest first (stable), and for each
    step j the number of tiles with more than j pairs: the prefix of that
    order a step touches. A step masks the tiles it touches by their own
    length too, so that any order and any longer prefix (all tiles every
    step) give the same bits."""
    tile_order = torch.argsort(lengths, descending=True, stable=True)
    ascending = lengths.sort().values
    steps = int(ascending[-1]) if lengths.numel() else 0
    longer = lengths.numel() - torch.searchsorted(ascending, torch.arange(steps, device=lengths.device), right=True)
    return tile_order, longer.tolist()


def _pair_rows(attrs, gids, idx, tile_ids, tiles_x, f16_xy):
    """The attribute rows (T, 6 + n_ch) of each tile's pair at idx, with the
    f16_xy knob's mean (rounded to float16 relative to the tile's origin);
    and the tile-relative mean (rounded when f16_xy)."""
    a = attrs[gids[idx].long()]
    ox, oy = (tile_ids % tiles_x).float() * TILE, (tile_ids // tiles_x).float() * TILE
    xr, yr = a[:, 0] - ox, a[:, 1] - oy
    if f16_xy:
        xr, yr = xr.half().float(), yr.half().float()
        a = torch.cat([(xr + ox)[:, None], (yr + oy)[:, None], a[:, 2:]], dim=1)
    return a, xr[:, None], yr[:, None]


def composite_forward_reference(
    gids: torch.Tensor, tile_ranges: torch.Tensor, attrs: torch.Tensor,
    tiles_x: int, image_shape: tuple[int, int], *, f16_xy: bool = False, bf16_mm: bool = False,
    coef: bool = False, blocks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `composite_forward`: all tiles of the pass advance
    together, one pair position per step, with the kernel's per-pixel rules
    and rounding order. The tiles are stepped longest first, so that a step
    touches only the tiles that still have pairs (a prefix,
    `_longest_first`)."""
    h, w = image_shape
    items, tiles = pass_items(tile_ranges, image_shape)
    num_tiles = items * tiles
    n_ch = attrs.shape[1] - 6
    device = attrs.device
    starts = tile_ranges[:-1].long()
    lengths = tile_ranges[1:].long() - starts
    tile_order, active = _longest_first(lengths)
    starts, lengths, first, px, py, tile_ids = (
        x[tile_order] for x in (starts, lengths, item_starts(tile_ranges, tiles),
                                *(x.repeat(items, 1) for x in _tile_pixels(tiles, tiles_x, device)),
                                torch.arange(num_tiles, device=device) % tiles))
    pxr, pyr = px % TILE, py % TILE
    offsets = blocks[0].long()[tile_order] if blocks is not None else None

    t = torch.ones((num_tiles, PIX), device=device)
    acc = torch.zeros((num_tiles, n_ch, PIX), device=device)
    last = starts[:, None].expand(num_tiles, PIX).clone()
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=device)
    # bf16_mm: log T at the current block's start, the block's float32 and
    # bfloat16 sums of log1p(-alpha) so far, and the block's index.
    lt = torch.zeros((num_tiles, PIX), device=device)
    block32 = torch.zeros_like(lt)
    block16 = torch.zeros_like(lt)
    current = torch.full((num_tiles, PIX), -1, dtype=torch.long, device=device)
    pixel = torch.arange(PIX, device=device)[None, :].expand(num_tiles, PIX)
    for j, k in enumerate(active):
        live = (j < lengths[:k])[:, None]
        pos = starts[:k] + j
        idx = pos.clamp(max=max(gids.shape[0] - 1, 0))
        a, xr, yr = _pair_rows(attrs, gids, idx, tile_ids[:k], tiles_x, f16_xy or coef)
        x, y, ca, cb, cc, op = (a[:, i : i + 1] for i in range(6))
        if coef:
            alpha = torch.clamp(torch.exp(_coef_power(xr, yr, ca, cb, cc, op, pxr[:k], pyr[:k])), max=ALPHA_CLAMP)
            use = live & ~done[:k] & (alpha >= ALPHA_THRESHOLD)
        else:
            dx = px[:k] - x
            dy = py[:k] - y
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = torch.clamp(op * torch.exp(power), max=ALPHA_CLAMP)
            use = live & ~done[:k] & (power <= 0.0) & (alpha >= ALPHA_THRESHOLD)
        alpha = torch.where(use, alpha, 0.0)
        if bf16_mm or coef:
            block = ((pos - first[:k]) // SCAN_BLOCK)[:, None].expand(k, PIX)
            enter = use & (block != current[:k])
            lt[:k] = torch.where(enter, lt[:k] + block32[:k], lt[:k])
            block32[:k] = torch.where(enter, 0.0, block32[:k])
            block16[:k] = torch.where(enter, 0.0, block16[:k])
            current[:k] = torch.where(enter, block, current[:k])
            la = torch.log1p(-alpha)
            weight = _bf16(alpha * torch.exp(lt[:k] + block16[:k]))
            acc[:k] = torch.where(use[:, None], acc[:k] + _bf16(a[:, 6:, None]) * weight[:, None, :], acc[:k])
            block32[:k] = torch.where(use, block32[:k] + la, block32[:k])
            block16[:k] = torch.where(use, block16[:k] + _bf16(la), block16[:k])
            done[:k] |= use & (lt[:k] + block32[:k] < LOG_TRANSMITTANCE_MIN)
            if blocks is not None:
                rows = _block_rows(offsets[:k], starts[:k], first[:k], pos)[:, None].expand(k, PIX)
                blocks[1][rows[use], pixel[:k][use]] = torch.stack([lt[:k][use], block16[:k][use]], dim=1)
        else:
            weight = alpha * t[:k]
            acc[:k] = torch.where(use[:, None], acc[:k] + a[:, 6:, None] * weight[:, None, :], acc[:k])
            t[:k] = torch.where(use, t[:k] * (1.0 - alpha), t[:k])
            done[:k] |= use & (t[:k] < TRANSMITTANCE_MIN)
        last[:k] = torch.where(use, starts[:k, None] + j + 1, last[:k])
    if bf16_mm or coef:
        t = torch.exp(lt + block32)

    tiles_y = h // TILE
    back = torch.argsort(tile_order)
    return (
        untile(acc[back], tiles_x, tiles_y),
        untile(t[back], tiles_x, tiles_y),
        untile(last[back].to(torch.int32), tiles_x, tiles_y),
    )


def footprint_box_reference(attrs: torch.Tensor) -> torch.Tensor:
    """The footprint box by which `composite_forward` culls pairs per warp:
    (N, 4) columns x0, x1, y0, y1 of each row of `attrs` (x, y, conic a/b/c,
    opacity, ...), outside which the forward's alpha test fails at every
    pixel. For a positive-definite conic, -power >= dx^2 det / (2c) and
    >= dy^2 det / (2a), and alpha >= 1/255 needs -power <= log(255 opacity);
    the box is widened by 1e-3 relative and 0.05 px. Empty (x0 = +inf) when
    opacity < 1/255, unbounded when det <= FOOTPRINT_DET_MIN * a * c or the
    conic is not positive definite. The kernel computes the same box."""
    x, y, ca, cb, cc, op = attrs[:, :6].unbind(dim=1)
    det = ca * cc - cb * cb
    tau = torch.log(255.0 * op) * 1.001 + 1e-3
    hx = torch.sqrt(2.0 * tau * cc / det) * 1.001 + 0.05
    hy = torch.sqrt(2.0 * tau * ca / det) * 1.001 + 0.05
    box = torch.stack([x - hx, x + hx, y - hy, y + hy], dim=1)
    inf = torch.inf
    positive = (ca > 0.0) & (cc > 0.0) & (det > FOOTPRINT_DET_MIN * (ca * cc))
    box = torch.where(positive[:, None], box, box.new_tensor([-inf, inf, -inf, inf]))
    return torch.where((op >= ALPHA_THRESHOLD)[:, None], box, box.new_tensor([inf, -inf, inf, -inf]))


@functools.cache
def supported_channel_counts() -> tuple[int, ...]:
    """Channel counts the composite kernels are built for (read once)."""
    lib = load_library()
    out, i = [], 0
    while (n := lib.composite_forward_channels(i)) > 0:
        out.append(n)
        i += 1
    return tuple(out)


@functools.cache
def fast_channel_counts() -> tuple[int, ...]:
    """Channel counts the fast-family variants are built for (read once)."""
    lib = load_library()
    out, i = [], 0
    while (n := lib.composite_fast_channels(i)) > 0:
        out.append(n)
        i += 1
    return tuple(out)


# Knob bits of the fast-family C entry points.
_F16_XY, _BF16_MM, _BF16_GRADS = 1, 2, 4


def _knob_bits(f16_xy: bool, bf16_mm: bool, bf16_grads: bool = False) -> int:
    return _F16_XY * f16_xy | _BF16_MM * bf16_mm | _BF16_GRADS * bf16_grads


def _check_blocks(blocks, tile_ranges: torch.Tensor, num_pairs: int, name: str) -> None:
    offsets, state = blocks
    _check(offsets, f"{name}: block offsets", torch.int32, 1)
    _check(state, f"{name}: block state", torch.float32, 3)
    if offsets.shape[0] != tile_ranges.shape[0] - 1 or state.shape[0] < num_pairs // SCAN_BLOCK + 2 * offsets.shape[0]:
        raise ValueError(f"{name}: the block state does not match the pairs (see block_state)")


def _block_pointers(blocks) -> tuple:
    return (blocks[0].data_ptr(), blocks[1].data_ptr()) if blocks is not None else (None, None)


def _check_channels(name: str, n_ch: int, variant: str) -> None:
    counts = supported_channel_counts() if variant == "exact" else fast_channel_counts()
    if n_ch not in counts:
        raise ValueError(f"{name} ({variant}) is built for {counts} channels, got {n_ch}")


def composite_forward(
    gids: torch.Tensor,          # (P,) int32 pass Gaussian id of each pair, sorted by (tile, depth)
    tile_ranges: torch.Tensor,   # (N T + 1,) int32 start of each tile's pairs
    attrs: torch.Tensor,         # (N G, 6 + n_ch) float32: x, y, conic a/b/c, opacity, channels
    tiles_x: int,
    image_shape: tuple[int, int],
    *,
    f16_xy: bool = False,
    bf16_mm: bool = False,
    coef: bool = False,
    blocks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite every tile of the pass front to back. Returns channels
    (N, n_ch, H, W), final transmittance (N, H, W) and each pixel's
    exclusive end of contributing pairs (N, H, W) int32, a position in the
    pass's pair array. The knobs are the module docstring's; `coef` implies
    f16_xy and bf16_mm. Under bf16_mm, `blocks` (`block_state`) receives
    the per-block state the backward needs."""
    h, w = image_shape
    items, num_tiles = pass_items(tile_ranges, image_shape)
    if tiles_x != w // TILE:
        raise ValueError("composite_forward: tile_ranges do not match the image")
    if coef:
        f16_xy = bf16_mm = True
    if blocks is not None and not bf16_mm:
        raise ValueError("composite_forward: block state is kept only under bf16_mm")
    knobs = {"f16_xy": f16_xy, "bf16_mm": bf16_mm, "coef": coef, "blocks": blocks}
    if not _on_cuda(gids, tile_ranges, attrs, *(blocks or ())):
        return composite_forward_reference(gids, tile_ranges, attrs, tiles_x, image_shape, **knobs)
    _check(gids, "gids", torch.int32, 1)
    _check(tile_ranges, "tile_ranges", torch.int32, 1)
    _check(attrs, "attrs", torch.float32, 2)
    n_ch = attrs.shape[1] - 6
    variant = variant_name(f16_xy, bf16_mm, coef)
    _check_channels("composite_forward", n_ch, variant)
    if blocks is not None:
        _check_blocks(blocks, tile_ranges, gids.shape[0], "composite_forward")
    channels = torch.empty((items, n_ch, h, w), dtype=torch.float32, device=attrs.device)
    transmittance = torch.empty((items, h, w), dtype=torch.float32, device=attrs.device)
    last = torch.empty((items, h, w), dtype=torch.int32, device=attrs.device)
    outputs = (tiles_x, h, w, channels.data_ptr(), transmittance.data_ptr(), last.data_ptr())
    counted = {"kernel": "composite_forward", "variant": variant, "channels": n_ch}
    if variant == "exact":
        launch("composite_forward", n_ch, items, num_tiles, gids.data_ptr(), tile_ranges.data_ptr(),
               attrs.data_ptr(), *outputs, _stream(), **counted)
    else:
        launch("composite_forward_fast", n_ch, int(coef), _knob_bits(f16_xy, bf16_mm), items, num_tiles,
               gids.data_ptr(), tile_ranges.data_ptr(), attrs.data_ptr(), *outputs, *_block_pointers(blocks),
               _stream(), **counted)
    return channels, transmittance, last


# -- composite_backward ----------------------------------------------------------


def composite_backward_reference(
    gids: torch.Tensor, tile_ranges: torch.Tensor, order: torch.Tensor, attrs: torch.Tensor,
    tiles_x: int, image_shape: tuple[int, int], last: torch.Tensor,
    t_final: torch.Tensor, g_channels: torch.Tensor, g_t: torch.Tensor, *, f16_xy: bool = False,
    bf16_mm: bool = False, bf16_grads: bool = False, blocks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Plain version of `composite_backward`: all tiles of the pass step
    together, one pair position per step, back to front, with the kernel's
    per-pixel rules; a step touches only the tiles that still have pairs
    below their largest `last` (`_longest_first`). Only running (N T, PIX)
    state is kept, never a graph of the forward. Rows are written at their
    Gaussian-major positions."""
    h, w = image_shape
    tiles_y = h // TILE
    items, tiles = pass_items(tile_ranges, image_shape)
    num_tiles = items * tiles
    n_ch = attrs.shape[1] - 6
    device = attrs.device
    last_t = tile(last, tiles_x, tiles_y).long()                # (N T, PIX)
    starts = tile_ranges[:-1].long()
    lengths = last_t.max(dim=1).values - starts if num_tiles else starts
    tile_order, active = _longest_first(lengths)
    starts, lengths, first, px, py, tile_ids, last_t = (
        x[tile_order] for x in (starts, lengths, item_starts(tile_ranges, tiles),
                                *(x.repeat(items, 1) for x in _tile_pixels(tiles, tiles_x, device)),
                                torch.arange(num_tiles, device=device) % tiles, last_t))
    t = tile(t_final, tiles_x, tiles_y)[tile_order]
    g = tile(g_channels, tiles_x, tiles_y)[tile_order]          # (N T, n_ch, PIX)
    suffix = tile(g_t, tiles_x, tiles_y)[tile_order] * t
    d_pairs = torch.zeros((gids.shape[0], 6 + n_ch), device=device)
    if bf16_mm:
        offsets = blocks[0].long()[tile_order]
        # The suffix of later blocks (float32), the current block's float32
        # and bfloat16 sums of later contributions, the block's index, its
        # start's log T and the bfloat16 sum of its log1p(-alpha) terms up
        # to the current pair.
        suffix32 = torch.zeros_like(suffix)
        suffix16 = torch.zeros_like(suffix)
        current = torch.full((num_tiles, PIX), -1, dtype=torch.long, device=device)
        lt = torch.zeros_like(suffix)
        prefix16 = torch.zeros_like(suffix)
        g16 = _bf16(g)
    for j in range(len(active) - 1, -1, -1):
        k = active[j]
        pos = starts[:k] + j
        a, _, _ = _pair_rows(attrs, gids, pos.clamp(max=max(gids.shape[0] - 1, 0)), tile_ids[:k], tiles_x, f16_xy)
        x, y, ca, cb, cc, op = (a[:, i : i + 1] for i in range(6))
        dx = px[:k] - x
        dy = py[:k] - y
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        e = torch.exp(torch.clamp(power, max=0.0))   # power > 0 is dropped below
        raw = op * e
        alpha = torch.clamp(raw, max=ALPHA_CLAMP)
        use = (pos[:, None] < last_t[:k]) & (power <= 0.0) & (alpha >= ALPHA_THRESHOLD)
        alpha = torch.where(use, alpha, 0.0)
        one_minus = 1.0 - alpha
        if bf16_mm:
            block = ((pos - first[:k]) // SCAN_BLOCK)[:, None].expand(k, PIX)
            enter = use & (block != current[:k])
            suffix[:k] = torch.where(enter, suffix[:k] + suffix32[:k], suffix[:k])
            suffix32[:k] = torch.where(enter, 0.0, suffix32[:k])
            suffix16[:k] = torch.where(enter, 0.0, suffix16[:k])
            current[:k] = torch.where(enter, block, current[:k])
            state = blocks[1][_block_rows(offsets[:k], starts[:k], first[:k], pos).clamp(0, blocks[1].shape[0] - 1)]
            lt[:k] = torch.where(enter, state[..., 0], lt[:k])
            prefix16[:k] = torch.where(enter, state[..., 1], prefix16[:k])
            prefix16[:k] = torch.where(use, prefix16[:k] - _bf16(torch.log1p(-alpha)), prefix16[:k])
            t_before = torch.exp(lt[:k] + prefix16[:k])
            weight = alpha * t_before
            c16 = _bf16(a[:, 6:])
            cg = c16[:, 0:1] * g16[:k, 0]
            for c in range(1, n_ch):
                cg = cg + c16[:, c : c + 1] * g16[:k, c]
            d_alpha = cg * t_before - (suffix[:k] + suffix16[:k]) / one_minus
        else:
            t_before = t[:k] / one_minus
            weight = alpha * t_before
            cg = (a[:, 6:, None] * g[:k]).sum(dim=1)               # (k, PIX)
            d_alpha = cg * t_before - suffix[:k] / one_minus
        d_alpha = torch.where(use & (raw < ALPHA_CLAMP), d_alpha, 0.0)
        d_pow = d_alpha * alpha
        parts = torch.stack([
            (ca * dx + cb * dy) * d_pow, (cc * dy + cb * dx) * d_pow,
            -0.5 * dx * dx * d_pow, -dx * dy * d_pow, -0.5 * dy * dy * d_pow, d_alpha * e,
        ], dim=1)                                               # (k, 6, PIX)
        if bf16_mm:
            parts = torch.cat([_bf16(parts), _bf16(weight)[:, None, :] * g16[:k]], dim=1)
        else:
            parts = torch.cat([parts, weight[:, None, :] * g[:k]], dim=1)
        live = j < lengths[:k]
        d_pairs[pos[live]] = parts.sum(dim=-1)[live]
        if bf16_mm:
            contribution = weight * cg
            suffix32[:k] = torch.where(use, suffix32[:k] + contribution, suffix32[:k])
            suffix16[:k] = torch.where(use, suffix16[:k] + _bf16(contribution), suffix16[:k])
        else:
            suffix[:k] = torch.where(use, suffix[:k] + weight * cg, suffix[:k])
            t[:k] = torch.where(use, t_before, t[:k])
    if bf16_grads:
        d_pairs = _bf16(d_pairs)
    d_rows = torch.empty_like(d_pairs)
    d_rows[order] = d_pairs
    return d_rows


def composite_backward(
    gids: torch.Tensor,          # (P,) int32, as given to composite_forward
    tile_ranges: torch.Tensor,   # (N T + 1,) int32
    order: torch.Tensor,         # (P,) int64 sorted position -> Gaussian-major position
    attrs: torch.Tensor,         # (N G, 6 + n_ch) float32
    tiles_x: int,
    image_shape: tuple[int, int],
    last: torch.Tensor,          # (N, H, W) int32 from composite_forward
    t_final: torch.Tensor,       # (N, H, W) float32 from composite_forward
    g_channels: torch.Tensor,    # (N, n_ch, H, W) float32 cotangent of the channels
    g_t: torch.Tensor,           # (N, H, W) float32 cotangent of T_final
    *,
    f16_xy: bool = False,
    bf16_mm: bool = False,
    bf16_grads: bool = False,
    blocks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Gradients of the composited channels and final transmittance with
    respect to each pair's attributes: (P, 6 + n_ch), rows x, y, conic
    a/b/c, opacity, channels, in Gaussian-major order (the sorted pair at
    position i lands in row order[i]). The knobs must be the forward's;
    bf16_mm needs the `blocks` that the forward filled, and splits the walk
    at the scan blocks: two CUDA launches (each scan block's suffix sums
    into a (B, PIX) float32 scratch, then one block per scan block), which
    count as one launch of this wrapper. Without bf16_mm, one launch walks
    each tile serially."""
    h, w = image_shape
    items, num_tiles = pass_items(tile_ranges, image_shape)
    n_ch = attrs.shape[1] - 6
    if tiles_x != w // TILE:
        raise ValueError("composite_backward: tile_ranges do not match the image")
    if g_channels.shape != (items, n_ch, h, w) or g_t.shape != (items, h, w):
        raise ValueError("composite_backward: cotangents do not match the image")
    if last.shape != (items, h, w) or t_final.shape != (items, h, w):
        raise ValueError("composite_backward: the forward's outputs do not match the image")
    if order.shape != gids.shape:
        raise ValueError("composite_backward: order and gids differ in length")
    if bf16_mm != (blocks is not None):
        raise ValueError("composite_backward: bf16_mm needs the forward's block state, and only it")
    knobs = {"f16_xy": f16_xy, "bf16_mm": bf16_mm, "bf16_grads": bf16_grads, "blocks": blocks}
    if not _on_cuda(gids, tile_ranges, order, attrs, last, t_final, g_channels, g_t, *(blocks or ())):
        return composite_backward_reference(
            gids, tile_ranges, order, attrs, tiles_x, image_shape, last, t_final, g_channels, g_t, **knobs
        )
    _check(gids, "gids", torch.int32, 1)
    _check(tile_ranges, "tile_ranges", torch.int32, 1)
    _check(order, "order", torch.int64, 1)
    _check(attrs, "attrs", torch.float32, 2)
    _check(last, "last", torch.int32, 3)
    _check(t_final, "t_final", torch.float32, 3)
    _check(g_channels, "g_channels", torch.float32, 4)
    _check(g_t, "g_t", torch.float32, 3)
    variant = variant_name(f16_xy, bf16_mm, bf16_grads=bf16_grads)
    _check_channels("composite_backward", n_ch, variant)
    if blocks is not None:
        _check_blocks(blocks, tile_ranges, gids.shape[0], "composite_backward")
    # The kernel writes every row, those of pairs no pixel used as zeros.
    d_rows = torch.empty((gids.shape[0], 6 + n_ch), dtype=torch.float32, device=attrs.device)
    args = (items, num_tiles, gids.data_ptr(), tile_ranges.data_ptr(), order.data_ptr(), attrs.data_ptr(), tiles_x,
            h, w, last.data_ptr(), t_final.data_ptr(), g_channels.data_ptr(), g_t.data_ptr())
    counted = {"kernel": "composite_backward", "variant": variant, "channels": n_ch}
    if variant == "exact":
        launch("composite_backward", n_ch, *args, d_rows.data_ptr(), _stream(), **counted)
    else:
        capacity, scratch = 0, None
        if blocks is not None:
            capacity = blocks[1].shape[0]
            scratch = torch.empty((capacity, PIX), dtype=torch.float32, device=attrs.device)
        launch("composite_backward_fast", n_ch, _knob_bits(f16_xy, bf16_mm, bf16_grads), *args,
               *_block_pointers(blocks), capacity, scratch.data_ptr() if scratch is not None else None,
               d_rows.data_ptr(), _stream(), **counted)
    return d_rows


# -- reduce_pairs ----------------------------------------------------------------


def reduce_pairs_reference(d_rows: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of `reduce_pairs`: index_add_ of each Gaussian's rows,
    in slot order, into its row."""
    counts = torch.diff(offsets, prepend=offsets.new_zeros(1))
    gid = torch.repeat_interleave(torch.arange(offsets.shape[0], device=offsets.device), counts)
    out = torch.zeros((offsets.shape[0], d_rows.shape[1]), dtype=d_rows.dtype, device=d_rows.device)
    return out.index_add_(0, gid, d_rows)


def reduce_pairs(
    d_rows: torch.Tensor,    # (P, R) float32 per-pair rows, Gaussian-major
    offsets: torch.Tensor,   # (G,) int64 inclusive prefix sum of pair counts, ending at P
) -> torch.Tensor:
    """Sum each Gaussian's contiguous segment of pair rows: (G, R)."""
    if not _on_cuda(d_rows, offsets):
        return reduce_pairs_reference(d_rows, offsets)
    _check(d_rows, "d_rows", torch.float32, 2)
    _check(offsets, "offsets", torch.int64, 1)
    row = d_rows.shape[1]
    if row - 6 not in supported_channel_counts():
        raise ValueError(f"reduce_pairs is built for rows of 6 + {supported_channel_counts()}, got {row}")
    if d_rows.data_ptr() % 8:
        raise ValueError("reduce_pairs: d_rows must be 8-byte aligned")
    out = torch.empty((offsets.shape[0], row), dtype=torch.float32, device=d_rows.device)
    launch("reduce_pairs", offsets.shape[0], row, d_rows.data_ptr(), offsets.data_ptr(), out.data_ptr(), _stream(),
           kernel="reduce_pairs", channels=row - 6)
    return out
