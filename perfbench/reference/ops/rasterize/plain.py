"""Plain tile compositor: what the port's tiled rasterizer computes, in
elementwise PyTorch, for one view's screen Gaussians.

The semantics are those of the JAX package's tiled rasterizer, which the
port's kernels implement:
  * each live Gaussian (radius > 0) covers the 16x16 tiles of its
    threshold-aware extent rect (clamped to the image), of which only the
    first `cap` slots, row-major, are kept;
  * each tile's Gaussians are taken in order of depth, ties by Gaussian
    index;
  * at each pixel (pixel i's center at i) a Gaussian's alpha is
    min(0.99, opacity * exp(power)), skipped where power > 0 or alpha is
    under 1/255; the pixel composites front to back and stops after the
    Gaussian that takes its transmittance under 1e-4.
The tiled rasterizer's exact ellipse-tile cull drops only (Gaussian, tile)
pairs whose alpha is under the threshold at every pixel of the tile, so it
changes no value and is left out.

Each tile's pairs are padded to the longest tile's and composited at once:
the transmittance in front of a pair is a cumulative product over the pair
axis. Under autograd each block of tiles is checkpointed, so the backward
recomputes a block instead of keeping its (tiles, pairs, pixels) tensors.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .camera import ALPHA_CLAMP, ALPHA_THRESHOLD
from .types import ScreenGaussians

TILE = 16
TRANSMITTANCE_MIN = 1e-4
# The most (tile, pair, pixel) elements one block of tiles holds.
BLOCK_ELEMENTS = 1 << 26

# The (pair, pixel) work of the renders since the caller last zeroed it,
# counted where no gradient is taken: `evaluations` (each pixel's pairs up
# to its stop), `composited` (those it composited), `pairs` and
# `channels` (the composited payload with the depth, of the last view).
work = {"evaluations": 0, "composited": 0, "pairs": 0, "channels": 0}


def tile_pairs(sg: ScreenGaussians, tiles_x: int, tiles_y: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Gaussian index, tile index) of every kept pair, sorted by tile, then
    depth, then Gaussian index."""
    mx, my = sg.mean2d[:, 0], sg.mean2d[:, 1]
    ex, ey = sg.extent[:, 0], sg.extent[:, 1]

    def tile_index(v, n):
        return torch.clamp(torch.floor(v / TILE), 0, n - 1).long()

    tx0, tx1 = tile_index(mx - ex, tiles_x), tile_index(mx + ex, tiles_x)
    ty0, ty1 = tile_index(my - ey, tiles_y), tile_index(my + ey, tiles_y)
    nx = tx1 - tx0 + 1
    count = torch.where(sg.radius > 0.0, torch.clamp(nx * (ty1 - ty0 + 1), max=cap), 0)
    gid = torch.repeat_interleave(torch.arange(count.shape[0], device=count.device), count)
    slot = torch.arange(gid.shape[0], device=count.device) - torch.repeat_interleave(
        torch.cumsum(count, 0) - count, count)
    tile = (ty0[gid] + slot // nx[gid]) * tiles_x + tx0[gid] + slot % nx[gid]
    by_depth = torch.argsort(sg.depth.detach()[gid], stable=True)
    order = by_depth[torch.argsort(tile[by_depth], stable=True)]
    return gid[order], tile[order]


def _composite_block(rows, px, py, valid):
    """rows (n, L, 6 + K) of n tiles' pairs, pixel centers (n, 1, 256),
    valid (n, L) -> (channels (n, K, 256), final transmittance (n, 256))."""
    x, y, ca, cb, cc, op = (rows[..., i : i + 1] for i in range(6))
    dx, dy = px - x, py - y
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=ALPHA_CLAMP)
    use = valid[..., None] & (power <= 0.0) & (alpha >= ALPHA_THRESHOLD)
    alpha = torch.where(use, alpha, 0.0)
    t_after = torch.cumprod(1.0 - alpha, dim=1)
    t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], dim=1)
    live = t_before >= TRANSMITTANCE_MIN
    weight = torch.where(live, alpha * t_before, 0.0)
    channels = torch.einsum("nlk,nlp->nkp", rows[..., 6:], weight)
    t_final = torch.where(live, 1.0 - alpha, 1.0).prod(dim=1)
    if not torch.is_grad_enabled():
        work["evaluations"] += int((valid[..., None] & live).sum())
        work["composited"] += int((use & live).sum())
    return channels, t_final


def composite(sg: ScreenGaussians, image_shape: tuple[int, int], background: torch.Tensor,
              cap: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One view: (channels (C, H, W) over `background` (C,), mask (H, W),
    composited depth (H, W), the number of kept pairs)."""
    h, w = image_shape
    tiles_x, tiles_y = w // TILE, h // TILE
    num_tiles = tiles_x * tiles_y
    device = sg.mean2d.device
    gid, tile = tile_pairs(sg, tiles_x, tiles_y, cap)
    rows = torch.cat([sg.mean2d, sg.conic, sg.opacity[:, None], sg.channels, sg.depth[:, None]], dim=-1)
    counts = torch.bincount(tile, minlength=num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    longest = max(int(counts.max()), 1)
    pixel = torch.arange(TILE * TILE, device=device)
    t = torch.arange(num_tiles, device=device)
    px = ((t % tiles_x)[:, None] * TILE + pixel % TILE).float()[:, None, :]
    py = ((t // tiles_x)[:, None] * TILE + pixel // TILE).float()[:, None, :]
    outs, finals = [], []
    step = max(1, BLOCK_ELEMENTS // (longest * TILE * TILE))
    for a in range(0, num_tiles, step):
        b = min(a + step, num_tiles)
        j = torch.arange(longest, device=device)
        valid = j[None] < counts[a:b, None]
        pos = torch.clamp(starts[a:b, None] + j[None], max=max(gid.shape[0] - 1, 0))
        block_rows = rows[gid[pos]] if gid.shape[0] else rows.new_zeros((b - a, longest, rows.shape[1]))
        if torch.is_grad_enabled() and rows.requires_grad:
            c, tf = checkpoint(_composite_block, block_rows, px[a:b], py[a:b], valid, use_reentrant=False)
        else:
            c, tf = _composite_block(block_rows, px[a:b], py[a:b], valid)
        outs.append(c)
        finals.append(tf)
    out = torch.cat(outs)
    t_final = torch.cat(finals)

    def untile(x):   # (T, K, 256) -> (K, H, W)
        x = x.reshape(tiles_y, tiles_x, x.shape[1], TILE, TILE).permute(2, 0, 3, 1, 4)
        return x.reshape(x.shape[0], h, w)

    t_final = untile(t_final[:, None])[0]
    channels = untile(out[:, :-1]) + background[:, None, None] * t_final
    work["pairs"] += int(gid.shape[0])
    work["channels"] = rows.shape[1] - 6
    return channels, 1.0 - t_final, untile(out[:, -1:])[0], int(gid.shape[0])
