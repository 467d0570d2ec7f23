"""The rasterizer's backward in the port against the JAX package's.

The plain versions of the two backward kernels are held against the Pallas
kernels they replace, run in interpret mode; the tiled render's autograd
gradients (plain kernel versions on the CPU) against `jax.grad` through the
JAX dense render, and against finite differences. The CUDA kernels are held
against the plain versions on the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.ops.rasterize import render as j_render
from latentsplat_tpu.ops.rasterize.expand import CHUNK as REDUCE_CHUNK
from latentsplat_tpu.ops.rasterize.expand import GW, reduce_by_counts
from latentsplat_tpu.ops.rasterize.pallas_kernels import (
    CHUNK,
    composite_pairs_bwd,
    composite_pairs_fwd,
    pad_attr_rows,
)
from latentsplat_tpu_torch.ops.gaussians import build_covariance
from latentsplat_tpu_torch.ops.rasterize import kernels
from latentsplat_tpu_torch.ops.rasterize.api import render
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

H = W = 32
TILES = 2
CAP = 9


def unsaturated_buffer(seed, n_ch=5):
    """A tile-sorted pair buffer over 4 tiles, one 512-pair chunk in all,
    with opacities low enough that no pixel reaches T < 1e-4 (so the JAX
    per-chunk early stop and the port's per-pixel one agree)."""
    rng = np.random.default_rng(seed)
    seg = [150, 120, 0, 90]
    p = sum(seg)
    tile_of = np.repeat(np.arange(4), seg)
    cx = (tile_of % TILES) * 16 + 7.5
    cy = (tile_of // TILES) * 16 + 7.5
    x = cx + rng.uniform(-10, 10, p)
    y = cy + rng.uniform(-10, 10, p)
    sx, sy = rng.uniform(1.5, 6.0, p), rng.uniform(1.5, 6.0, p)
    rho = rng.uniform(-0.8, 0.8, p)
    det = (sx * sy) ** 2 * (1 - rho**2)
    ca, cb, cc = sy**2 / det, -rho * sx * sy / det, sx**2 / det
    op = rng.uniform(0.02, 0.2, p)
    op[:3] = 0.995                       # clamped alphas at their centres
    ch = rng.uniform(0, 1, (p, n_ch))
    attrs = np.concatenate([np.stack([x, y, ca, cb, cc, op], 1), ch], 1).astype(np.float32)
    ranges = np.concatenate([[0], np.cumsum(seg)]).astype(np.int32)
    return attrs, ranges


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_backward_reference_matches_composite_pairs_bwd(seed):
    attrs, ranges = unsaturated_buffer(seed)
    n_ch = attrs.shape[1] - 6
    p = attrs.shape[0]
    buf = np.zeros((pad_attr_rows(attrs.shape[1]), CHUNK), np.float32)
    buf[: attrs.shape[1], :p] = attrs.T
    j_tiles, done = composite_pairs_fwd(
        jnp.asarray(buf), jnp.asarray(ranges), n_ch=n_ch, tiles_x=TILES, tiles_y=TILES, interpret=True,
    )
    rng = np.random.default_rng(seed + 10)
    g_tiles = rng.standard_normal((TILES * TILES, n_ch + 1, 256)).astype(np.float32)
    j_d = composite_pairs_bwd(
        jnp.asarray(buf), jnp.asarray(ranges), done, jnp.asarray(g_tiles), j_tiles[:, n_ch : n_ch + 1],
        n_ch=n_ch, tiles_x=TILES, tiles_y=TILES, interpret=True,
    )
    theirs = np.asarray(j_d)[: attrs.shape[1], :p].T

    gids = torch.arange(p, dtype=torch.int32)
    order = torch.from_numpy(rng.permutation(p))          # sorted -> Gaussian-major position
    t_ranges, t_attrs = torch.from_numpy(ranges), torch.from_numpy(attrs)
    _, t_final, last = kernels.composite_forward_reference(gids, t_ranges, t_attrs, TILES, (H, W))
    assert t_final.min() > kernels.TRANSMITTANCE_MIN
    g = torch.from_numpy(g_tiles)
    d_rows = kernels.composite_backward_reference(
        gids, t_ranges, order, t_attrs, TILES, (H, W), last, t_final,
        kernels.untile(g[:, :n_ch], TILES, TILES), kernels.untile(g[:, n_ch], TILES, TILES),
    )
    ours = d_rows[order].numpy()                          # back to sorted order
    # JAX recovers T in log space from chunk-wide prefix sums, the port by
    # dividing by (1 - alpha) pair by pair: float32 rounding of up to 150
    # factors, 1e-4 of each gradient column's largest value.
    scale = np.abs(theirs).max(axis=0)
    assert (scale > 0).all()
    np.testing.assert_allclose(ours / scale, theirs / scale, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_reduce_pairs_reference_matches_reduce_by_counts(seed):
    rng = np.random.default_rng(seed)
    g = 300
    counts = rng.integers(0, CAP + 1, g).astype(np.int32)
    counts[:20] = 0                      # dead Gaussians
    counts[20:30] = CAP                  # at the cap
    p = int(counts.sum())
    row = 14
    d_gm = rng.standard_normal((p, row)).astype(np.float32)

    g_pad = -(-g // GW) * GW
    p_pad = -(-p // REDUCE_CHUNK) * REDUCE_CHUNK
    stack = np.zeros((pad_attr_rows(row), p_pad), np.float32)
    stack[:row, :p] = d_gm.T
    counts_p = np.pad(counts, (0, g_pad - g))
    theirs = np.asarray(reduce_by_counts(jnp.asarray(stack), jnp.asarray(counts_p), CAP, interpret=True))
    theirs = theirs[:row, :g].T

    # The same Gaussian-major rows, the JAX kernel's own expanded layout.
    offsets = torch.cumsum(torch.from_numpy(counts), dim=0, dtype=torch.int64)
    ours = kernels.reduce_pairs(torch.from_numpy(d_gm), offsets).numpy()
    # Sums of <= 9 standard-normal terms in another order.
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    assert (ours[:20] == 0).all()


def opaque_buffer(n_ch=5):
    """Tile 0: two wide, opaque pairs (alpha 0.99) that saturate every
    pixel, then six pairs past every pixel's `last`; tile 2: two faint pairs; tiles 1 and 3
    empty."""
    wide = [8.0, 8.0, 1e-6, 0.0, 1e-6, 0.999]
    late = [8.0, 8.0, 0.05, 0.0, 0.05, 0.5]
    faint = [8.0, 24.0, 0.05, 0.01, 0.05, 0.3]
    rows = [wide] * 2 + [late] * 6 + [faint] * 2
    ch = np.linspace(0.1, 0.9, len(rows) * n_ch).reshape(len(rows), n_ch)
    attrs = np.concatenate([np.asarray(rows), ch], 1).astype(np.float32)
    ranges = np.array([0, 8, 8, 10, 10], np.int32)
    return attrs, ranges


@pytest.mark.parametrize("case", ["pairs_past_last", "no_pairs"])
def test_composite_backward_reference_writes_zero_rows(case):
    # Pairs that no pixel composited get zero rows at their Gaussian-major
    # positions; an image without pairs gives no rows.
    attrs, ranges = opaque_buffer()
    if case == "no_pairs":
        attrs, ranges = attrs[:0], np.zeros(5, np.int32)
    p = attrs.shape[0]
    gids = torch.arange(p, dtype=torch.int32)
    order = torch.from_numpy(np.random.default_rng(3).permutation(p))
    t_ranges, t_attrs = torch.from_numpy(ranges), torch.from_numpy(attrs)
    _, t_final, last = kernels.composite_forward_reference(gids, t_ranges, t_attrs, TILES, (H, W))
    rng = np.random.default_rng(4)
    g_out = torch.from_numpy(rng.standard_normal((1, attrs.shape[1] - 6, H, W)).astype(np.float32))
    g_t = torch.from_numpy(rng.standard_normal((1, H, W)).astype(np.float32))
    d_rows = kernels.composite_backward_reference(
        gids, t_ranges, order, t_attrs, TILES, (H, W), last, t_final, g_out, g_t
    )
    assert d_rows.shape == (p, attrs.shape[1])
    if case == "no_pairs":
        return
    assert int(last[0, :16, :16].max()) == 2              # tile 0 saturates after 2 pairs
    sorted_rows = d_rows[order]
    assert (sorted_rows[2:8] == 0).all()
    assert (sorted_rows[:2].abs().sum(dim=1) > 0).all() and (sorted_rows[8:].abs().sum(dim=1) > 0).all()


def make_sh_scene(seed, n, d_color=4, c_feat=4, d_feat=4):
    """Numpy Gaussians with colour and feature SH, in front of a camera at
    the origin looking down +z."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 6.0, n)
    xy = rng.uniform(-0.6, 0.6, (n, 2)) * z[:, None]
    means = np.concatenate([xy, z[:, None]], axis=1)
    scales = rng.uniform(0.05, 0.25, (n, 3))
    quats = rng.standard_normal((n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    covs = build_covariance(torch.from_numpy(scales), torch.from_numpy(quats)).numpy()
    opacities = rng.uniform(0.3, 0.95, n)
    color_sh = 0.3 * rng.standard_normal((n, 3, d_color))
    feature_sh = 0.3 * rng.standard_normal((n, c_feat, d_feat))
    leaves = (means[None], covs[None], opacities[None], color_sh[None], feature_sh[None])
    return [np.asarray(x, np.float32) for x in leaves]


def cameras(seed):
    rng = np.random.default_rng(seed)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    ext[0, 1, :3, 3] = rng.uniform(-0.2, 0.2, 3)
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32), (1, 2, 1, 1))
    near = np.full((1, 2), 1.0, np.float32)
    far = np.full((1, 2), 100.0, np.float32)
    bg = np.array([[0.5, 0.1, 0.2]], np.float32)
    return ext, intr, near, far, bg


def test_tiled_gradients_match_jax_dense():
    leaves = make_sh_scene(7, 40)
    cams = cameras(8)
    rng = np.random.default_rng(9)
    target = rng.uniform(0, 1, (1, 2, 7, H, W)).astype(np.float32)

    def j_loss(leaves):
        out = j_render(*map(jnp.asarray, cams[:4]), (H, W), jnp.asarray(cams[4]), *leaves, backend="dense")
        image = jnp.concatenate([out.color, out.feature], axis=2)
        return ((image - target) ** 2).mean() + out.mask.mean() + 1e-3 * out.depth.mean()

    theirs = jax.grad(j_loss)([jnp.asarray(x) for x in leaves])

    t_leaves = [torch.from_numpy(x).requires_grad_() for x in leaves]
    out = render(*map(torch.from_numpy, cams[:4]), (H, W), torch.from_numpy(cams[4]), *t_leaves, backend="tiled")
    image = torch.cat([out.color, out.feature], dim=2)
    loss = ((image - torch.from_numpy(target)) ** 2).mean() + out.mask.mean() + 1e-3 * out.depth.mean()
    ours = torch.autograd.grad(loss, t_leaves)
    # Tolerance of tests/test_rasterize.py's tiled-vs-dense gradient test:
    # normalised by each leaf's largest gradient, atol 5e-3.
    for name, o, t in zip(("means", "covariances", "opacities", "color_sh", "feature_sh"), ours, theirs):
        t = np.asarray(t)
        scale = np.abs(t).max() + 1e-8
        np.testing.assert_allclose(o.numpy() / scale, t / scale, atol=5e-3, err_msg=name)


def test_tiled_opacity_gradient_matches_finite_differences():
    # As tests/test_rasterize.py does for the JAX tiled path: central
    # differences in float64 of the float32 render, 5% relative.
    leaves = [torch.from_numpy(x) for x in make_sh_scene(9, 6)]
    cams = [torch.from_numpy(x) for x in cameras(10)]
    cams[4] = torch.zeros_like(cams[4])

    def loss(opacities):
        out = render(*cams[:4], (H, W), cams[4], leaves[0], leaves[1], opacities, leaves[3], None)
        return (out.color**2).mean() + out.mask.mean()

    ops = leaves[2].clone().requires_grad_()
    (grad,) = torch.autograd.grad(loss(ops), ops)
    eps = 1e-3
    for i in range(ops.shape[1]):
        delta = torch.zeros_like(ops)
        delta[0, i] = eps
        fd = (float(loss(leaves[2] + delta)) - float(loss(leaves[2] - delta))) / (2 * eps)
        assert float(grad[0, i]) == pytest.approx(fd, rel=0.05, abs=1e-5)
