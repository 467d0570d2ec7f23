"""Parity of the PyTorch rasterizer (latentsplat_tpu_torch.ops.rasterize)
with the JAX package's.

The plain versions of the two kernels are held against the Pallas kernels
they replace, run in interpret mode; the whole tiled forward against the
dense oracle and the JAX tiled forward. The CUDA kernels themselves are held
against the plain versions on the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.ops.rasterize import composite_dense as j_composite_dense
from latentsplat_tpu.ops.rasterize import project_gaussians_to_screen as j_project
from latentsplat_tpu.ops.rasterize.expand import GW, OUT_BLOCK, expand_by_counts, start_offsets
from latentsplat_tpu.ops.rasterize.pallas_kernels import CHUNK, composite_pairs_fwd, pad_attr_rows
from latentsplat_tpu.ops.rasterize.tiled import _tile_rects as j_tile_rects
from latentsplat_tpu.ops.rasterize.tiled import composite_tiled as j_composite_tiled
from latentsplat_tpu_torch.ops.gaussians import build_covariance
from latentsplat_tpu_torch.ops.rasterize import kernels
from latentsplat_tpu_torch.ops.rasterize.camera import project_gaussians_to_screen
from latentsplat_tpu_torch.ops.rasterize.dense import composite_dense
from latentsplat_tpu_torch.ops.rasterize.kernels import (
    composite_forward_reference,
    duplicate_with_keys_reference,
)
from latentsplat_tpu_torch.ops.rasterize.tiled import (
    composite_tiled,
    pack_attributes,
    sort_pairs,
    tile_rects,
)
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

H = W = 32
TILES_X = TILES_Y = 2
CAP = 9
INTRINSICS = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32)
EXTRINSICS = np.eye(4, dtype=np.float32)


def make_scene(seed, n, n_channels=4, n_dead=0, n_wide=0):
    """Numpy Gaussians in front of a camera at the origin looking down +z.
    `n_dead` sit behind the camera; `n_wide` are large enough that their
    tile rects exceed the 9-slot cap."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 6.0, n)
    xy = rng.uniform(-0.6, 0.6, (n, 2)) * z[:, None]
    means = np.concatenate([xy, z[:, None]], axis=1)
    scales = rng.uniform(0.05, 0.25, (n, 3))
    if n_wide:
        scales[:n_wide] = rng.uniform(1.5, 3.0, (n_wide, 3))
        means[:n_wide, :2] *= 0.2
    if n_dead:
        means[n - n_dead :, 2] *= -1.0
    quats = rng.standard_normal((n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    covs = build_covariance(torch.from_numpy(scales), torch.from_numpy(quats)).numpy()
    opacities = rng.uniform(0.3, 0.95, n)
    channels = rng.uniform(0.0, 1.0, (n, n_channels))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(means), f32(covs), f32(opacities), f32(channels)


def project_both(scene, size=H):
    j_sg = j_project(*map(jnp.asarray, scene), jnp.asarray(EXTRINSICS), jnp.asarray(INTRINSICS), (size, size))
    t_sg = project_gaussians_to_screen(
        *map(torch.from_numpy, scene), torch.from_numpy(EXTRINSICS),
        torch.from_numpy(INTRINSICS), (size, size),
    )
    return j_sg, t_sg


# Bookkeeping tests run at 64x64 (4x4 tiles), where a wide splat's tile rect
# (up to 16 tiles) exceeds the 9-slot cap.
BIG = 64
BIG_TILES = BIG // 16


class TestProjection:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_jax(self, seed):
        # Elementwise f32 formulas in the same order: agreement to a few ulp
        # (the conic is an inverse of a near-singular matrix for thin splats).
        j_sg, t_sg = project_both(make_scene(seed, 200, n_dead=10, n_wide=5))
        for name in ("mean2d", "depth", "radius", "opacity", "extent"):
            np.testing.assert_allclose(
                getattr(t_sg, name).numpy(), np.asarray(getattr(j_sg, name)), rtol=1e-5, atol=1e-5
            )
        np.testing.assert_allclose(t_sg.conic.numpy(), np.asarray(j_sg.conic), rtol=1e-4, atol=1e-5)


class TestTileRects:
    def test_matches_jax(self):
        # Integer bookkeeping: exact. JAX gives empty Gaussians one invalid
        # pair; the port gives them none.
        j_sg, t_sg = project_both(make_scene(3, 300, n_dead=20, n_wide=10), BIG)
        j_counts, j_base, j_nx, j_mask = map(np.asarray, j_tile_rects(j_sg, BIG_TILES, BIG_TILES, CAP))
        counts, base, nx, mask = (x.numpy() for x in tile_rects(t_sg, BIG_TILES, BIG_TILES, CAP))
        live = j_base < BIG_TILES**2
        assert live.sum() > 0 and (~live).sum() >= 20
        assert (j_nx[:10] == BIG_TILES).all()     # wide splats span more than CAP tiles
        np.testing.assert_array_equal(counts[live], j_counts[live])
        np.testing.assert_array_equal(base[live], j_base[live])
        np.testing.assert_array_equal(nx[live], j_nx[live])
        np.testing.assert_array_equal(mask[live], j_mask[live])
        assert (counts[~live] == 0).all() and (mask[~live] == 0).all()


def jax_pairs(j_sg, tiles):
    """(gaussian, tile) of every valid pair of the JAX expansion, decoded
    as latentsplat_tpu/ops/rasterize/tiled.py does."""
    counts, base, nx, mask = j_tile_rects(j_sg, tiles, tiles, CAP)
    g = counts.shape[0]
    g_pad = -(-g // GW) * GW
    pad = lambda x: jnp.pad(x, (0, g_pad - g))  # noqa: E731
    counts_p = pad(counts)
    starts, _ = start_offsets(counts_p)
    rows = [pad(jnp.arange(g, dtype=jnp.float32)), pad(base.astype(jnp.float32)),
            pad(nx.astype(jnp.float32)), pad(mask.astype(jnp.float32)), starts,
            counts_p.astype(jnp.float32)]
    stack = jnp.zeros((8, g_pad), jnp.float32).at[:6].set(jnp.stack(rows))
    budget = -(-int(counts.sum()) // OUT_BLOCK) * OUT_BLOCK
    out = np.asarray(expand_by_counts(stack, counts_p, budget, 4, 5, interpret=True))
    gid, base_e, nx_e, mask_e, start_e = (out[i].astype(np.int64) for i in range(5))
    slot = np.arange(budget) - start_e
    pos = np.zeros_like(slot)
    cum = np.zeros_like(slot)
    for b in range(CAP):
        bit = (mask_e >> b) & 1
        pos = np.where((cum == slot) & (bit == 1), b, pos)
        cum = cum + bit
    nx_e = np.maximum(nx_e, 1)
    tile = base_e + (pos % nx_e) + (pos // nx_e) * tiles
    valid = (np.arange(budget) < int(counts.sum())) & (tile < tiles * tiles)
    return sorted(zip(gid[valid].tolist(), tile[valid].tolist()))


class TestDuplicateWithKeys:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_reference_matches_expand_by_counts(self, seed):
        # Integer pair maps: exact, including dead Gaussians and splats
        # wider than the cap.
        j_sg, t_sg = project_both(make_scene(seed, 180, n_dead=15, n_wide=8), BIG)
        counts, base, nx, mask = tile_rects(t_sg, BIG_TILES, BIG_TILES, CAP)
        gids, keys = duplicate_with_keys_reference(counts, mask, base, nx, t_sg.depth, BIG_TILES, CAP)
        ours = sorted(zip(gids.tolist(), (keys >> 32).tolist()))
        assert ours == jax_pairs(j_sg, BIG_TILES)
        # Keys carry the depth bits; pairs are Gaussian-major.
        np.testing.assert_array_equal((keys & 0xFFFFFFFF).numpy(), t_sg.depth[gids.long()].view(torch.int32).numpy())
        assert (np.diff(gids.numpy()) >= 0).all()

    def test_sort_orders_tiles_then_depth(self):
        _, t_sg = project_both(make_scene(4, 120))
        counts, base, nx, mask = tile_rects(t_sg, TILES_X, TILES_Y, CAP)
        gids, keys = duplicate_with_keys_reference(counts, mask, base, nx, t_sg.depth, TILES_X, CAP)
        sorted_gids, ranges, _ = sort_pairs(gids, keys, TILES_X * TILES_Y)
        assert ranges[0] == 0 and ranges[-1] == gids.shape[0]
        for t in range(TILES_X * TILES_Y):
            seg = sorted_gids[ranges[t] : ranges[t + 1]].long()
            assert (np.diff(t_sg.depth[seg].numpy()) >= 0).all()


def hand_built_buffer(seed, n_ch=5):
    """A tile-sorted pair buffer over 4 tiles and two 512-pair chunks: tile 0
    holds enough opaque pairs that its pixels saturate, tile 2 none."""
    rng = np.random.default_rng(seed)
    seg = [420, 300, 0, 150]
    p = sum(seg)
    tile_of = np.repeat(np.arange(4), seg)
    cx = (tile_of % TILES_X) * 16 + 7.5
    cy = (tile_of // TILES_X) * 16 + 7.5
    x = cx + rng.uniform(-10, 10, p)
    y = cy + rng.uniform(-10, 10, p)
    sx, sy = rng.uniform(1.5, 6.0, p), rng.uniform(1.5, 6.0, p)
    rho = rng.uniform(-0.8, 0.8, p)
    det = (sx * sy) ** 2 * (1 - rho**2)
    ca, cb, cc = sy**2 / det, -rho * sx * sy / det, sx**2 / det
    op = np.where(tile_of == 0, rng.uniform(0.6, 0.95, p), rng.uniform(0.05, 0.6, p))
    ch = rng.uniform(0, 1, (p, n_ch))
    attrs = np.concatenate([np.stack([x, y, ca, cb, cc, op], 1), ch], 1).astype(np.float32)
    ranges = np.concatenate([[0], np.cumsum(seg)]).astype(np.int32)
    return attrs, ranges


class TestCompositeForward:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_reference_matches_composite_pairs_fwd(self, seed):
        attrs, ranges = hand_built_buffer(seed)
        n_ch = attrs.shape[1] - 6
        p_pad = -(-attrs.shape[0] // CHUNK) * CHUNK
        buf = np.zeros((pad_attr_rows(attrs.shape[1]), p_pad), np.float32)
        buf[: attrs.shape[1], : attrs.shape[0]] = attrs.T
        j_tiles, _ = composite_pairs_fwd(
            jnp.asarray(buf), jnp.asarray(ranges), n_ch=n_ch, tiles_x=TILES_X,
            tiles_y=TILES_Y, interpret=True,
        )
        j_tiles = np.asarray(j_tiles)
        j_channels = kernels.untile(torch.from_numpy(j_tiles[:, :n_ch]), TILES_X, TILES_Y)[0].numpy()
        j_t = kernels.untile(torch.from_numpy(j_tiles[:, n_ch]), TILES_X, TILES_Y)[0].numpy()

        channels, t, last = (x[0] for x in composite_forward_reference(
            torch.arange(attrs.shape[0], dtype=torch.int32), torch.from_numpy(ranges),
            torch.from_numpy(attrs), TILES_X, (H, W),
        ))
        channels, t = channels.numpy(), t.numpy()
        stopped = t < kernels.TRANSMITTANCE_MIN
        assert stopped.any() and (~stopped).any()
        # Pixels that never saturate: the same front-to-back sum, computed in
        # log space on the JAX side; 2e-5 covers its exp/log1p rounding.
        np.testing.assert_allclose(channels[:, ~stopped], j_channels[:, ~stopped], atol=2e-5)
        np.testing.assert_allclose(t[~stopped], j_t[~stopped], atol=2e-5)
        # Saturated pixels: the port stops each pixel once T < 1e-4, the TPU
        # kernel a whole tile after a 512-pair chunk, so what the TPU adds
        # later is at most 1e-4 * max channel (channels lie in [0, 1]).
        np.testing.assert_allclose(channels[:, stopped], j_channels[:, stopped], atol=1.2e-4)
        np.testing.assert_allclose(t[stopped], j_t[stopped], atol=1.2e-4)
        # Tile 2 is empty: transmittance 1, nothing accumulated, last = start.
        empty = np.s_[16:32, 0:16]
        np.testing.assert_array_equal(t[empty], 1.0)
        assert (last.numpy()[empty] == ranges[2]).all()


class TestTiledForward:
    @pytest.mark.parametrize("n", [1, 7, 64, 300])
    def test_matches_dense_oracle(self, n):
        # Tolerances of tests/test_rasterize.py's tiled-vs-dense test; depth is
        # a sum of z-weighted terms (z up to 6), hence the wider atol.
        scene = make_scene(n, n)
        j_sg, t_sg = project_both(scene)
        bg = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
        d_img, d_mask, d_depth = map(np.asarray, j_composite_dense(j_sg, (H, W), jnp.asarray(bg), tile_size=16))
        img, mask, depth, _ = composite_tiled(t_sg, (H, W), torch.from_numpy(bg))
        np.testing.assert_allclose(img.numpy(), d_img, atol=2e-4)
        np.testing.assert_allclose(mask.numpy(), d_mask, atol=2e-4)
        np.testing.assert_allclose(depth.numpy(), d_depth, atol=2e-3)

    def test_matches_jax_tiled_f32(self):
        scene = make_scene(11, 150, n_dead=5, n_wide=4)
        j_sg, t_sg = project_both(scene)
        bg = np.array([0.3, 0.1, 0.0, 0.2], np.float32)
        j_img, j_mask, j_depth = map(
            np.asarray, j_composite_tiled(j_sg, (H, W), jnp.asarray(bg), pack_channels=False)
        )
        img, mask, depth, _ = composite_tiled(t_sg, (H, W), torch.from_numpy(bg))
        np.testing.assert_allclose(img.numpy(), j_img, atol=2e-4)
        np.testing.assert_allclose(mask.numpy(), j_mask, atol=2e-4)
        np.testing.assert_allclose(depth.numpy(), j_depth, atol=2e-3)

    def test_port_dense_matches_jax_dense(self):
        j_sg, t_sg = project_both(make_scene(5, 100))
        bg = np.array([0.5, 0.1, 0.0, 0.2], np.float32)
        for ours, theirs in zip(
            composite_dense(t_sg, (H, W), torch.from_numpy(bg), tile_size=16),
            j_composite_dense(j_sg, (H, W), jnp.asarray(bg), tile_size=16),
        ):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5)

