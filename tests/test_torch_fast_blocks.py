"""The fast family's compositor across scan blocks, on the CPU.

Under bf16_mm (precisions "fast", "fast_nocoef", "exact_bf16_mm") the
compositor keeps log T per SCAN_BLOCK-block of pairs, and
composite_backward.cu walks each tile's scan blocks apart: a first launch
sums each block's contributions to the suffix per pixel (suffix32), and the
second replays each block from g_T T_final plus the later blocks' sums,
added from the last block down. On a scene whose tiles span 8 scan blocks
and whose pixels stop mid-block in several of them:

* `split_backward`, that split walk stepped in PyTorch, against the plain
  backward (`composite_backward_reference`, the serial walk): the same
  bits, at each knob set that takes it;
* the port's forward at "fast" and "exact_bf16_mm" against the JAX
  package's composite_tiled (its Pallas kernels in interpret mode) on that
  scene, where JAX's 512-pair chunks and the scan blocks cross.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from latentsplat_tpu.ops.rasterize import tiled as j_tiled
from latentsplat_tpu_torch.ops.rasterize import kernels
from latentsplat_tpu_torch.ops.rasterize.camera import ALPHA_CLAMP, ALPHA_THRESHOLD
from latentsplat_tpu_torch.ops.rasterize.tiled import (
    composite_tiled,
    depth_code_bits,
    pack_attributes,
    precision_knobs,
    quantize_attributes,
    tile_pairs,
)

from tests.test_torch_rasterize import H, make_scene, project_both
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TILES = H // kernels.TILE
BLOCK = kernels.SCAN_BLOCK


def deep_scene():
    """tests/test_torch_rasterize.py's scene of 2,000 Gaussians with twice
    the extent and opacities in [0.05, 0.3]: 922-939 pairs a tile at
    "fast" (8 scan blocks), and every pixel stops in its tile's 4th to 7th
    block."""
    means, covs, _, channels = make_scene(31, 2000)
    opacities = np.random.default_rng(1).uniform(0.05, 0.3, 2000).astype(np.float32)
    return means, (covs * 4).astype(np.float32), opacities, channels


@pytest.fixture(scope="module")
def scene():
    return project_both(deep_scene())


@pytest.fixture(scope="module")
def pairs(scene):
    """The pairs, their Gaussian-major order and the attribute rows that
    composite_tiled composites at "fast"."""
    _, t_sg = scene
    gids, ranges, order, _, _ = tile_pairs(t_sg, (H, H), 9, "fast")
    attrs = quantize_attributes(pack_attributes(t_sg), precision_knobs("fast"), depth_code_bits(TILES * TILES)[1])
    return gids, ranges, order, attrs


def split_backward(gids, ranges, order, attrs, last, t_final, g_channels, g_t, *, f16_xy, bf16_grads, blocks):
    """composite_backward's bf16_mm path as the split walk takes it, all
    tiles' k-th scan blocks at once: suffix_kernel's per-block float32
    sums, then each block's replay (the plain version's arithmetic) from
    g_T T_final + 0.0 plus the later blocks' sums, from the last down."""
    num_tiles = ranges.shape[0] - 1
    n_ch = attrs.shape[1] - 6
    starts = ranges[:-1].long()
    px, py = kernels._tile_pixels(num_tiles, TILES, attrs.device)
    tile_ids = torch.arange(num_tiles)
    last_t = kernels.tile(last, TILES, TILES).long()
    g16 = kernels._bf16(kernels.tile(g_channels, TILES, TILES))
    entering = kernels.tile(g_t, TILES, TILES) * kernels.tile(t_final, TILES, TILES)
    end = last_t.max(dim=1).values
    first = starts // BLOCK
    walked = torch.where(end > starts, (end - 1) // BLOCK - first + 1, 0)
    n_blocks = int(walked.max())

    def steps(k):
        """Per position of each tile's k-th scan block, back to front: the
        replay's terms and which pixels composited it."""
        for s in range(BLOCK - 1, -1, -1):
            pos = (first + k) * BLOCK + s
            live = (pos >= starts) & (pos < end)
            if not live.any():
                continue
            a, _, _ = kernels._pair_rows(attrs, gids, pos.clamp(max=gids.shape[0] - 1), tile_ids, TILES, f16_xy)
            x, y, ca, cb, cc, op = (a[:, i : i + 1] for i in range(6))
            dx, dy = px - x, py - y
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            e = torch.exp(torch.clamp(power, max=0.0))
            raw = op * e
            alpha = torch.clamp(raw, max=ALPHA_CLAMP)
            use = live[:, None] & (pos[:, None] < last_t) & (power <= 0.0) & (alpha >= ALPHA_THRESHOLD)
            alpha = torch.where(use, alpha, 0.0)
            c16 = kernels._bf16(a[:, 6:])
            cg = c16[:, 0:1] * g16[:, 0]
            for c in range(1, n_ch):
                cg = cg + c16[:, c : c + 1] * g16[:, c]
            yield pos, live, use, alpha, raw, e, dx, dy, a, cg

    def replay(k):
        """A stepper of each pixel's T before the pair in the k-th block:
        (lt, bf16 sum) from the block state at the pixel's first composited
        pair of the block, then each pair's bf16 term off the sum."""
        state = blocks[1][(blocks[0].long() + k).clamp(max=blocks[1].shape[0] - 1)]
        lt = torch.zeros_like(entering)
        prefix16 = torch.zeros_like(entering)
        entered = torch.zeros_like(entering, dtype=torch.bool)

        def step(use, alpha):
            nonlocal lt, prefix16, entered
            enter = use & ~entered
            lt = torch.where(enter, state[..., 0], lt)
            prefix16 = torch.where(enter, state[..., 1], prefix16)
            entered = entered | use
            prefix16 = torch.where(use, prefix16 - kernels._bf16(torch.log1p(-alpha)), prefix16)
            return torch.exp(lt + prefix16)

        return step

    suffix32 = [None]   # a tile's first block: no earlier block reads its sums
    for k in range(1, n_blocks):
        step, total = replay(k), torch.zeros_like(entering)
        for _, _, use, alpha, _, _, _, _, _, cg in steps(k):
            t_before = step(use, alpha)
            total = torch.where(use, total + alpha * t_before * cg, total)
        suffix32.append(total)

    d_pairs = torch.zeros((gids.shape[0], 6 + n_ch))
    for k in range(n_blocks):
        suffix = entering + 0.0
        for j in range(n_blocks - 1, k, -1):
            suffix = torch.where((j < walked)[:, None], suffix + suffix32[j], suffix)
        step, suffix16 = replay(k), torch.zeros_like(entering)
        for pos, live, use, alpha, raw, e, dx, dy, a, cg in steps(k):
            t_before = step(use, alpha)
            weight = alpha * t_before
            d_alpha = cg * t_before - (suffix + suffix16) / (1.0 - alpha)
            d_alpha = torch.where(use & (raw < ALPHA_CLAMP), d_alpha, 0.0)
            d_pow = d_alpha * alpha
            ca, cb, cc = a[:, 2:3], a[:, 3:4], a[:, 4:5]
            parts = torch.stack([
                (ca * dx + cb * dy) * d_pow, (cc * dy + cb * dx) * d_pow,
                -0.5 * dx * dx * d_pow, -dx * dy * d_pow, -0.5 * dy * dy * d_pow, d_alpha * e,
            ], dim=1)
            parts = torch.cat([kernels._bf16(parts), kernels._bf16(weight)[:, None, :] * g16], dim=1)
            d_pairs[pos[live]] = parts.sum(dim=-1)[live]
            suffix16 = torch.where(use, suffix16 + kernels._bf16(weight * cg), suffix16)
    if bf16_grads:
        d_pairs = kernels._bf16(d_pairs)
    d_rows = torch.empty_like(d_pairs)
    d_rows[order] = d_pairs
    return d_rows


def fast_forward(pairs, f16_xy=True):
    """The forward's `last`, T and block state at bf16_mm (with f16_xy or
    without), and seeded cotangents."""
    gids, ranges, _, attrs = pairs
    blocks = kernels.block_state(ranges, gids.shape[0], TILES * TILES)
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, TILES, (H, H), f16_xy=f16_xy, bf16_mm=True,
                                                   blocks=blocks)
    rng = np.random.default_rng(4)
    g_out = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    g_t = torch.from_numpy(rng.standard_normal(t_final.shape).astype(np.float32))
    return last, t_final, g_out, g_t, blocks


def test_scene_spans_scan_blocks(pairs):
    # Tiles of 6 scan blocks and more, and pixels that stop mid-block in
    # three or more of them: the split walk enters blocks with suffixes
    # carried from several later blocks, and walks blocks where some
    # pixels composite nothing.
    _, ranges, _, _ = pairs
    starts, stops = ranges[:-1].long(), ranges[1:].long()
    assert int(((stops - 1) // BLOCK - starts // BLOCK + 1).max()) >= 6
    last, t_final, *_ = fast_forward(pairs)
    last = kernels.tile(last, TILES, TILES).long()
    stopped = kernels.tile(t_final, TILES, TILES) < kernels.TRANSMITTANCE_MIN
    block = (last - 1) // BLOCK - (starts // BLOCK)[:, None]
    offset = (last - 1) % BLOCK
    mid = stopped & (offset > 0) & (offset < BLOCK - 1)
    assert len(torch.unique(block[mid])) >= 3 and stopped.float().mean() > 0.5


@pytest.mark.parametrize("knobs", [{"f16_xy": True, "bf16_grads": True}, {"f16_xy": False, "bf16_grads": False}],
                         ids=["fast", "exact_bf16_mm"])
def test_split_backward_matches_the_serial_walk(pairs, knobs):
    # The per-block suffix sums, added from the last block down after a
    # first +0.0, give each block the suffix the serial walk enters it
    # with, so every row keeps its bits.
    gids, ranges, order, attrs = pairs
    last, t_final, g_out, g_t, blocks = fast_forward(pairs, knobs["f16_xy"])
    args = (gids, ranges, order, attrs, TILES, (H, H), last, t_final, g_out, g_t)
    ref = kernels.composite_backward_reference(*args, bf16_mm=True, blocks=blocks, **knobs)
    ours = split_backward(gids, ranges, order, attrs, last, t_final, g_out, g_t, blocks=blocks, **knobs)
    assert (ref != 0).any(dim=1).float().mean() > 0.5
    assert torch.equal(ours, ref)


@pytest.mark.parametrize("precision", ["fast", "exact_bf16_mm"])
def test_deep_forward_matches_jax(scene, precision):
    # The tolerance of tests/test_rasterize.py's tiled-vs-dense test: the
    # port stops each pixel at T < 1e-4 where the JAX kernel stops a tile
    # after a 512-pair chunk in which every pixel did, so that saturated
    # pixels differ by up to ~1e-4 of their value.
    j_sg, t_sg = scene
    bg = np.zeros(4, np.float32)
    theirs = j_tiled.composite_tiled(j_sg, (H, H), jnp.asarray(bg), pack_channels=False, precision=precision)
    ours = composite_tiled(t_sg, (H, H), torch.from_numpy(bg), precision=precision)[:3]
    for a, b, atol in zip(ours, theirs, (2e-4, 2e-4, 2e-3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0)
