"""The rasterizer's four kernels, each beside its plain PyTorch version.

* `duplicate_with_keys` (csrc/duplicate_with_keys.cu) replaces
  latentsplat_tpu/ops/rasterize/expand.py::expand_by_counts.
* `composite_forward` (csrc/composite_forward.cu) replaces
  latentsplat_tpu/ops/rasterize/pallas_kernels.py::composite_pairs_fwd.
* `composite_backward` (csrc/composite_backward.cu) replaces
  latentsplat_tpu/ops/rasterize/pallas_kernels.py::composite_pairs_bwd.
* `reduce_pairs` (csrc/reduce_pairs.cu) replaces
  latentsplat_tpu/ops/rasterize/expand.py::reduce_by_counts.

A wrapper given CPU tensors runs the `*_reference` version; given CUDA
tensors it launches the kernel or raises. `launch_counts` counts kernel
launches (not reference calls); `composite_forward_launches` splits the
forward compositor's by channel count.
"""

from __future__ import annotations

import functools

import torch

from ...cuda_build import check, load_library
from .camera import ALPHA_CLAMP, ALPHA_THRESHOLD

TILE = 16
PIX = TILE * TILE
TRANSMITTANCE_MIN = 1e-4
# composite_forward's warps each own a block of 4 rows x 8 columns of a tile.
WARP_ROWS, WARP_COLS = 4, 8
# A conic with det <= FOOTPRINT_DET_MIN * a * c gets an unbounded footprint
# box: the camera clamps |rho| <= 0.99 (det >= 0.0199 a c), and nearer to
# degenerate the rounding of power could outgrow the box's margins.
FOOTPRINT_DET_MIN = 1e-3

launch_counts = {
    "duplicate_with_keys": 0, "composite_forward": 0, "composite_backward": 0, "reduce_pairs": 0,
}
composite_forward_launches: dict[int, int] = {}


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
    counts: torch.Tensor,   # (G,) int32 pairs per Gaussian (popcount of mask)
    mask: torch.Tensor,     # (G,) int32 (cap <= 32) or int64 (cap <= 64) surviving rect slots
    base: torch.Tensor,     # (G,) int32 tile id of the rect origin
    nx: torch.Tensor,       # (G,) int32 rect width in tiles
    depth: torch.Tensor,    # (G,) float32 camera-space depth (> 0 where counts > 0)
    tiles_x: int,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One (Gaussian id, key = tile << 32 | depth bits) pair per surviving
    tile, Gaussian-major. The pair buffer is sized exactly (one host read)."""
    if not _on_cuda(counts, mask, base, nx, depth):
        return duplicate_with_keys_reference(counts, mask, base, nx, depth, tiles_x, cap)
    for t, name in ((counts, "counts"), (base, "base"), (nx, "nx")):
        _check(t, name, torch.int32, 1)
    _check(mask, "mask", torch.int64 if mask.dtype == torch.int64 else torch.int32, 1)
    if cap > mask_bits(mask.dtype):
        raise ValueError(f"duplicate_with_keys: a {mask.dtype} mask holds {mask_bits(mask.dtype)} slots, cap is {cap}")
    _check(depth, "depth", torch.float32, 1)
    g = counts.shape[0]
    if not all(t.shape[0] == g for t in (mask, base, nx, depth)):
        raise ValueError("duplicate_with_keys: per-Gaussian inputs differ in length")
    # torch.sort needs the exact pair count: the one wait on the device.
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    total = int(offsets[-1]) if g else 0
    gids = torch.empty((total,), dtype=torch.int32, device=counts.device)
    keys = torch.empty((total,), dtype=torch.int64, device=counts.device)
    _launch_duplicate_with_keys(offsets, mask, base, nx, depth, tiles_x, gids, keys)
    return gids, keys


def _launch_duplicate_with_keys(
    offsets: torch.Tensor, mask: torch.Tensor, base: torch.Tensor, nx: torch.Tensor,
    depth: torch.Tensor, tiles_x: int, gids: torch.Tensor, keys: torch.Tensor,
) -> None:
    """The kernel launch of `duplicate_with_keys` into buffers sized by the
    caller (offsets int64, inclusive); does not wait on the device. An int64
    `mask` launches the 64-bit instantiation."""
    if gids.data_ptr() % 16 or keys.data_ptr() % 16:
        raise ValueError("duplicate_with_keys: gids and keys must be 16-byte aligned")
    lib = load_library()
    launch = lib.duplicate_with_keys64 if mask.dtype == torch.int64 else lib.duplicate_with_keys
    rc = launch(
        offsets.shape[0], offsets.data_ptr(), mask.data_ptr(), base.data_ptr(), nx.data_ptr(),
        depth.data_ptr(), tiles_x, gids.data_ptr(), keys.data_ptr(), _stream(),
    )
    check(rc, "duplicate_with_keys")
    launch_counts["duplicate_with_keys"] += 1


# -- composite_forward -----------------------------------------------------------


def _tile_pixels(num_tiles: int, tiles_x: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates (T, PIX) of every tile, row-major in the tile."""
    tile = torch.arange(num_tiles, device=device)[:, None]
    p = torch.arange(PIX, device=device)[None, :]
    px = (tile % tiles_x) * TILE + p % TILE
    py = (tile // tiles_x) * TILE + p // TILE
    return px.float(), py.float()


def untile(x: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(T, ..., PIX) per-tile values -> (..., H, W)."""
    rest = x.shape[1:-1]
    x = x.reshape(tiles_y, tiles_x, *rest, TILE, TILE)
    x = x.movedim((0, 1), (-4, -2))          # (..., tiles_y, TILE, tiles_x, TILE)
    return x.reshape(*rest, tiles_y * TILE, tiles_x * TILE)


def tile(x: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(..., H, W) -> (T, ..., PIX), the inverse of `untile`."""
    rest = x.shape[:-2]
    x = x.reshape(*rest, tiles_y, TILE, tiles_x, TILE)
    x = x.movedim((-4, -2), (0, 1))          # (tiles_y, tiles_x, ..., TILE, TILE)
    return x.reshape(tiles_y * tiles_x, *rest, PIX)


def composite_forward_reference(
    gids: torch.Tensor, tile_ranges: torch.Tensor, attrs: torch.Tensor,
    tiles_x: int, image_shape: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `composite_forward`: all tiles advance together, one
    pair position per step, with the kernel's per-pixel rules and rounding
    order."""
    h, w = image_shape
    num_tiles = tile_ranges.shape[0] - 1
    n_ch = attrs.shape[1] - 6
    device = attrs.device
    starts = tile_ranges[:-1].long()
    lengths = tile_ranges[1:].long() - starts
    px, py = _tile_pixels(num_tiles, tiles_x, device)

    t = torch.ones((num_tiles, PIX), device=device)
    acc = torch.zeros((num_tiles, n_ch, PIX), device=device)
    last = starts[:, None].expand(num_tiles, PIX).clone()
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=device)
    n_steps = int(lengths.max()) if num_tiles else 0
    for j in range(n_steps):
        live = (j < lengths)[:, None]
        idx = (starts + j).clamp(max=max(gids.shape[0] - 1, 0))
        a = attrs[gids[idx].long()]                   # (T, 6 + n_ch)
        x, y, ca, cb, cc, op = (a[:, i : i + 1] for i in range(6))
        dx = px - x
        dy = py - y
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_CLAMP)
        use = live & ~done & (power <= 0.0) & (alpha >= ALPHA_THRESHOLD)
        alpha = torch.where(use, alpha, 0.0)
        weight = alpha * t
        acc = torch.where(use[:, None], acc + a[:, 6:, None] * weight[:, None, :], acc)
        t = torch.where(use, t * (1.0 - alpha), t)
        last = torch.where(use, starts[:, None] + j + 1, last)
        done = done | (use & (t < TRANSMITTANCE_MIN))

    tiles_y = h // TILE
    return (
        untile(acc, tiles_x, tiles_y),
        untile(t, tiles_x, tiles_y),
        untile(last.to(torch.int32), tiles_x, tiles_y),
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


def composite_forward(
    gids: torch.Tensor,          # (P,) int32 Gaussian id of each pair, sorted by (tile, depth)
    tile_ranges: torch.Tensor,   # (T + 1,) int32 start of each tile's pairs
    attrs: torch.Tensor,         # (G, 6 + n_ch) float32: x, y, conic a/b/c, opacity, channels
    tiles_x: int,
    image_shape: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite every tile front to back. Returns channels (n_ch, H, W),
    final transmittance (H, W) and each pixel's exclusive end of
    contributing pairs (H, W) int32."""
    h, w = image_shape
    if h % TILE or w % TILE:
        raise ValueError(f"image dims must be multiples of {TILE}, got {image_shape}")
    num_tiles = (h // TILE) * (w // TILE)
    if tile_ranges.shape != (num_tiles + 1,) or tiles_x != w // TILE:
        raise ValueError("composite_forward: tile_ranges do not match the image")
    if not _on_cuda(gids, tile_ranges, attrs):
        return composite_forward_reference(gids, tile_ranges, attrs, tiles_x, image_shape)
    _check(gids, "gids", torch.int32, 1)
    _check(tile_ranges, "tile_ranges", torch.int32, 1)
    _check(attrs, "attrs", torch.float32, 2)
    n_ch = attrs.shape[1] - 6
    if n_ch not in supported_channel_counts():
        raise ValueError(
            f"composite_forward is built for {supported_channel_counts()} channels, got {n_ch}"
        )
    channels = torch.empty((n_ch, h, w), dtype=torch.float32, device=attrs.device)
    transmittance = torch.empty((h, w), dtype=torch.float32, device=attrs.device)
    last = torch.empty((h, w), dtype=torch.int32, device=attrs.device)
    rc = load_library().composite_forward(
        n_ch, num_tiles, gids.data_ptr(), tile_ranges.data_ptr(), attrs.data_ptr(),
        tiles_x, h, w, channels.data_ptr(), transmittance.data_ptr(), last.data_ptr(),
        _stream(),
    )
    check(rc, "composite_forward")
    launch_counts["composite_forward"] += 1
    composite_forward_launches[n_ch] = composite_forward_launches.get(n_ch, 0) + 1
    return channels, transmittance, last


# -- composite_backward ----------------------------------------------------------


def composite_backward_reference(
    gids: torch.Tensor, tile_ranges: torch.Tensor, order: torch.Tensor, attrs: torch.Tensor,
    tiles_x: int, image_shape: tuple[int, int], last: torch.Tensor,
    t_final: torch.Tensor, g_channels: torch.Tensor, g_t: torch.Tensor,
) -> torch.Tensor:
    """Plain version of `composite_backward`: all tiles step together, one
    pair position per step, back to front, with the kernel's per-pixel
    rules. Only running (T, PIX) state is kept, never a graph of the
    forward. Rows are written at their Gaussian-major positions."""
    h, w = image_shape
    tiles_y = h // TILE
    num_tiles = tile_ranges.shape[0] - 1
    n_ch = attrs.shape[1] - 6
    device = attrs.device
    starts = tile_ranges[:-1].long()
    px, py = _tile_pixels(num_tiles, tiles_x, device)
    last_t = tile(last, tiles_x, tiles_y).long()                # (T, PIX)
    t = tile(t_final, tiles_x, tiles_y).clone()
    g = tile(g_channels, tiles_x, tiles_y)                      # (T, n_ch, PIX)
    suffix = tile(g_t, tiles_x, tiles_y) * t
    d_pairs = torch.zeros((gids.shape[0], 6 + n_ch), device=device)
    lengths = last_t.max(dim=1).values - starts if num_tiles else starts
    n_steps = int(lengths.max()) if num_tiles else 0
    for j in range(n_steps - 1, -1, -1):
        live = j < lengths
        pos = starts + j
        a = attrs[gids[pos.clamp(max=max(gids.shape[0] - 1, 0))].long()]   # (T, 6 + n_ch)
        x, y, ca, cb, cc, op = (a[:, i : i + 1] for i in range(6))
        dx = px - x
        dy = py - y
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        e = torch.exp(torch.clamp(power, max=0.0))   # power > 0 is dropped below
        raw = op * e
        alpha = torch.clamp(raw, max=ALPHA_CLAMP)
        use = live[:, None] & (pos[:, None] < last_t) & (power <= 0.0) & (alpha >= ALPHA_THRESHOLD)
        alpha = torch.where(use, alpha, 0.0)
        one_minus = 1.0 - alpha
        t_before = t / one_minus
        weight = alpha * t_before
        cg = (a[:, 6:, None] * g).sum(dim=1)                    # (T, PIX)
        d_alpha = cg * t_before - suffix / one_minus
        d_alpha = torch.where(use & (raw < ALPHA_CLAMP), d_alpha, 0.0)
        d_pow = d_alpha * alpha
        parts = torch.stack([
            (ca * dx + cb * dy) * d_pow, (cc * dy + cb * dx) * d_pow,
            -0.5 * dx * dx * d_pow, -dx * dy * d_pow, -0.5 * dy * dy * d_pow, d_alpha * e,
        ], dim=1)                                               # (T, 6, PIX)
        rows = torch.cat([parts, weight[:, None, :] * g], dim=1).sum(dim=-1)
        d_pairs[pos[live]] = rows[live]
        suffix = torch.where(use, suffix + weight * cg, suffix)
        t = torch.where(use, t_before, t)
    d_rows = torch.empty_like(d_pairs)
    d_rows[order] = d_pairs
    return d_rows


def composite_backward(
    gids: torch.Tensor,          # (P,) int32, as given to composite_forward
    tile_ranges: torch.Tensor,   # (T + 1,) int32
    order: torch.Tensor,         # (P,) int64 sorted position -> Gaussian-major position
    attrs: torch.Tensor,         # (G, 6 + n_ch) float32
    tiles_x: int,
    image_shape: tuple[int, int],
    last: torch.Tensor,          # (H, W) int32 from composite_forward
    t_final: torch.Tensor,       # (H, W) float32 from composite_forward
    g_channels: torch.Tensor,    # (n_ch, H, W) float32 cotangent of the channels
    g_t: torch.Tensor,           # (H, W) float32 cotangent of T_final
) -> torch.Tensor:
    """Gradients of the composited channels and final transmittance with
    respect to each pair's attributes: (P, 6 + n_ch), rows x, y, conic
    a/b/c, opacity, channels, in Gaussian-major order (the sorted pair at
    position i lands in row order[i])."""
    h, w = image_shape
    num_tiles = (h // TILE) * (w // TILE)
    n_ch = attrs.shape[1] - 6
    if tile_ranges.shape != (num_tiles + 1,) or tiles_x != w // TILE:
        raise ValueError("composite_backward: tile_ranges do not match the image")
    if g_channels.shape != (n_ch, h, w) or g_t.shape != (h, w):
        raise ValueError("composite_backward: cotangents do not match the image")
    if order.shape != gids.shape:
        raise ValueError("composite_backward: order and gids differ in length")
    if not _on_cuda(gids, tile_ranges, order, attrs, last, t_final, g_channels, g_t):
        return composite_backward_reference(
            gids, tile_ranges, order, attrs, tiles_x, image_shape, last, t_final, g_channels, g_t
        )
    _check(gids, "gids", torch.int32, 1)
    _check(tile_ranges, "tile_ranges", torch.int32, 1)
    _check(order, "order", torch.int64, 1)
    _check(attrs, "attrs", torch.float32, 2)
    _check(last, "last", torch.int32, 2)
    _check(t_final, "t_final", torch.float32, 2)
    _check(g_channels, "g_channels", torch.float32, 3)
    _check(g_t, "g_t", torch.float32, 2)
    if n_ch not in supported_channel_counts():
        raise ValueError(
            f"composite_backward is built for {supported_channel_counts()} channels, got {n_ch}"
        )
    # The kernel writes every row, those of pairs no pixel used as zeros.
    d_rows = torch.empty((gids.shape[0], 6 + n_ch), dtype=torch.float32, device=attrs.device)
    rc = load_library().composite_backward(
        n_ch, num_tiles, gids.data_ptr(), tile_ranges.data_ptr(), order.data_ptr(),
        attrs.data_ptr(), tiles_x, h, w, last.data_ptr(), t_final.data_ptr(),
        g_channels.data_ptr(), g_t.data_ptr(), d_rows.data_ptr(), _stream(),
    )
    check(rc, "composite_backward")
    launch_counts["composite_backward"] += 1
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
    rc = load_library().reduce_pairs(
        offsets.shape[0], row, d_rows.data_ptr(), offsets.data_ptr(), out.data_ptr(), _stream(),
    )
    check(rc, "reduce_pairs")
    launch_counts["reduce_pairs"] += 1
    return out
