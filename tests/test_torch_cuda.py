"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
only torch and the port, so it also runs where JAX is not installed (the
shared tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from latentsplat_tpu_torch.ops.gaussians import build_covariance
from latentsplat_tpu_torch.ops.rasterize import kernels
from latentsplat_tpu_torch.ops.rasterize.camera import project_gaussians_to_screen
from latentsplat_tpu_torch.ops.rasterize.dense import composite_dense
from latentsplat_tpu_torch.ops.rasterize.tiled import (
    composite_tiled,
    depth_code_bits,
    pack_attributes,
    precision_knobs,
    quantize_attributes,
    sort_pairs,
    tile_pairs,
    tile_rects,
)

pytestmark = pytest.mark.cuda

CAP = 9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def screen_gaussians(seed, n, size, device, n_channels=4, n_wide=0, n_dead=0):
    """Projected random Gaussians in front of a camera at the origin."""
    g = torch.Generator().manual_seed(seed)
    z = torch.rand(n, generator=g) * 4 + 2
    xy = (torch.rand(n, 2, generator=g) * 1.2 - 0.6) * z[:, None]
    means = torch.cat([xy, z[:, None]], dim=1)
    scales = torch.rand(n, 3, generator=g) * 0.2 + 0.05
    scales[:n_wide] *= 12.0
    means[n - n_dead :, 2] *= -1.0
    quats = torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)
    covs = build_covariance(scales, quats)
    opacities = torch.rand(n, generator=g) * 0.65 + 0.3
    channels = torch.rand(n, n_channels, generator=g)
    intrinsics = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]])
    sg = project_gaussians_to_screen(
        means, covs, opacities, channels, torch.eye(4), intrinsics, (size, size)
    )
    return type(sg)(**{k: v.to(device) for k, v in vars(sg).items()})


@pytest.mark.parametrize("size", [32, 64, 256])
def test_duplicate_with_keys_matches_reference(cuda, size):
    tiles = size // 16
    sg = screen_gaussians(size, 20000, size, cuda, n_wide=200, n_dead=500)
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    before = kernels.launch_counts["duplicate_with_keys"]
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, sg.depth, tiles, CAP)
    torch.cuda.synchronize()
    assert kernels.launch_counts["duplicate_with_keys"] == before + 1
    assert torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)


@pytest.mark.parametrize("n", [1, 255, 5000])
def test_duplicate_with_keys_full_masks(cuda, n):
    # Masks of up to 32 slots: a block's pairs overflow its shared staging
    # and are written in rounds; ragged ends at every 16-byte alignment.
    rng = np.random.default_rng(n)
    bits = rng.random((n, 32)) < rng.choice([0.05, 0.5, 1.0], (n, 1))
    bits[: n // 3] = True
    mask = torch.from_numpy((bits * (1 << np.arange(32, dtype=np.uint64))).sum(1).astype(np.uint32).view(np.int32))
    counts = torch.from_numpy(bits.sum(1).astype(np.int32))
    nx = torch.from_numpy(rng.integers(1, 9, n).astype(np.int32))
    base = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32))
    depth = torch.from_numpy(rng.uniform(0.1, 100.0, n).astype(np.float32))
    args = [x.to(cuda) for x in (counts, mask, base, nx, depth)]
    gids, keys, _ = kernels.duplicate_with_keys(*args, 64, 32)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(*args, 64, 32)
    torch.cuda.synchronize()
    assert torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)


@pytest.mark.parametrize("cap", [40, 64])
def test_duplicate_with_keys_64_bit_masks(cuda, cap):
    # The int64-mask instantiation, at caps above what an int32 mask holds:
    # on the rects of wide splats (tile_rects at that cap), and on random
    # masks with the top slots set, written in rounds.
    sg = screen_gaussians(cap, 20000, 256, cuda, n_wide=2000, n_dead=500)
    counts, base, nx, mask = tile_rects(sg, 16, 16, cap)
    assert mask.dtype == torch.int64 and int(counts.max()) > 32
    before = kernels.launch_counts["duplicate_with_keys"]
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, 16, cap)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, sg.depth, 16, cap)
    torch.cuda.synchronize()
    assert kernels.launch_counts["duplicate_with_keys"] == before + 1
    assert torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)

    n = 5000
    rng = np.random.default_rng(cap)
    bits = rng.random((n, cap)) < rng.choice([0.05, 0.5, 1.0], (n, 1))
    bits[: n // 3] = True
    weights = np.zeros(64, np.uint64)
    weights[:cap] = 1 << np.arange(cap, dtype=np.uint64)
    mask = torch.from_numpy((np.pad(bits, ((0, 0), (0, 64 - cap))) * weights).sum(1, dtype=np.uint64).view(np.int64))
    counts = torch.from_numpy(bits.sum(1).astype(np.int32))
    nx = torch.from_numpy(rng.integers(1, 9, n).astype(np.int32))
    base = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32))
    depth = torch.from_numpy(rng.uniform(0.1, 100.0, n).astype(np.float32))
    args = [x.to(cuda) for x in (counts, mask, base, nx, depth)]
    gids, keys, _ = kernels.duplicate_with_keys(*args, 64, cap)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(*args, 64, cap)
    torch.cuda.synchronize()
    assert torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)


def test_duplicate_with_keys_refuses_a_cap_beyond_the_mask(cuda):
    sg = screen_gaussians(3, 100, 64, cuda)
    counts, base, nx, mask = tile_rects(sg, 4, 4, CAP)
    with pytest.raises(ValueError, match="holds 32 slots, cap is 40"):
        kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, 4, 40)


@pytest.mark.parametrize("size", [32, 256])
def test_composite_forward_matches_reference(cuda, size):
    # Same operations in the same rounding order on the same device.
    tiles = size // 16
    sg = screen_gaussians(size + 1, 20000, size, cuda)
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    gids, ranges, _ = sort_pairs(gids, keys, tiles * tiles)
    attrs = pack_attributes(sg)
    before = kernels.launch_counts["composite_forward"]
    out = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size))
    ref = kernels.composite_forward_reference(gids, ranges, attrs, tiles, (size, size))
    torch.cuda.synchronize()
    assert kernels.launch_counts["composite_forward"] == before + 1
    assert (ref[1] < kernels.TRANSMITTANCE_MIN).any(), "scene never saturates"
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[1], ref[1], atol=1e-5, rtol=0)
    assert torch.equal(out[2], ref[2])


def test_composite_forward_four_channels_matches_reference(cuda):
    # render_depth's payload: 3 equal depth channels + the expected depth,
    # values up to ~6 (camera-space z).
    size, tiles = 64, 4
    sg = screen_gaussians(size + 3, 20000, size, cuda, n_channels=3)
    sg.channels = sg.depth[:, None].expand(-1, 3).contiguous()
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    gids, ranges, _ = sort_pairs(gids, keys, tiles * tiles)
    attrs = pack_attributes(sg)
    assert attrs.shape[1] == 6 + 4
    before = kernels.launches_by_channels["composite_forward"].get(4, 0)
    out = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size))
    ref = kernels.composite_forward_reference(gids, ranges, attrs, tiles, (size, size))
    torch.cuda.synchronize()
    assert kernels.launches_by_channels["composite_forward"][4] == before + 1
    scale = ref[0].abs().amax(dim=(2, 3), keepdim=True)
    assert ((out[0] - ref[0]).abs() / scale).max().item() <= 1e-5
    torch.testing.assert_close(out[1], ref[1], atol=1e-5, rtol=0)
    assert torch.equal(out[2], ref[2])


@pytest.mark.parametrize("mode", ["depth", "disparity", "relative_disparity", "log"])
def test_render_depth_tiled_matches_dense(cuda, mode):
    # The depth tolerance of tests/test_rasterize.py, relative to the
    # largest value; the tiled path launches the 4-channel compositor.
    from latentsplat_tpu_torch.ops.rasterize.api import render_depth

    g = torch.Generator().manual_seed(9)
    n = 3000
    z = torch.rand(n, generator=g) * 4 + 2
    means = torch.cat([(torch.rand(n, 2, generator=g) * 1.2 - 0.6) * z[:, None], z[:, None]], dim=1)
    covs = build_covariance(torch.rand(n, 3, generator=g) * 0.1 + 0.02,
                            torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1))
    opacities = torch.rand(n, generator=g) * 0.65 + 0.3
    ext = torch.eye(4).expand(1, 2, 4, 4).clone()
    ext[0, 1, :3, 3] = torch.tensor([0.2, -0.1, 0.3])
    intr = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).expand(1, 2, 3, 3)
    args = [x.to(cuda) for x in (ext, intr, torch.ones(1, 2), torch.full((1, 2), 100.0))]
    gaussians = [x[None].to(cuda) for x in (means, covs, opacities)]
    before = kernels.launches_by_channels["composite_forward"].get(4, 0)
    tiled = render_depth(*args, (64, 64), *gaussians, mode=mode)
    assert kernels.launches_by_channels["composite_forward"][4] == before + 1     # both views in one pass
    dense = render_depth(*args, (64, 64), *gaussians, mode=mode, backend="dense")
    assert torch.isfinite(tiled).all()
    assert ((tiled - dense).abs().max() / dense.abs().max()).item() <= 2e-3


def conic_rows(rng, n, sigma=(0.5, 6.0), opacity=(0.3, 0.99), lo=-4.0, hi=36.0):
    """(n, 11) attribute rows (x, y, conic a/b/c, opacity, 5 channels, the
    last a depth of up to 30) of random Gaussians over a 32x32 image."""
    sx, sy = rng.uniform(*sigma, n), rng.uniform(*sigma, n)
    rho = rng.uniform(-0.9, 0.9, n)
    det = (sx * sy) ** 2 * (1 - rho**2)
    rows = np.column_stack([
        rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
        sy * sy / det, -rho * sx * sy / det, sx * sx / det, rng.uniform(*opacity, n),
        rng.uniform(0, 1, (n, 4)), rng.uniform(1, 30, n),
    ])
    return rows.astype(np.float32)


def forward_case(case):
    """Attribute rows and the tiles left without pairs, for one edge case of
    composite_forward on a 32x32 image (2x2 tiles)."""
    rng = np.random.default_rng(len(case))
    if case == "empty_tiles":
        return conic_rows(rng, 300), {1, 2}
    if case == "never_saturates":
        return conic_rows(rng, 40, opacity=(0.02, 0.08)), set()
    if case == "low_opacity":      # every other pair below 1/255: an empty box
        rows = conic_rows(rng, 200)
        rows[::2, 5] = rng.uniform(0.0, 0.0039, 100)
        return rows, set()
    if case == "non_pd_conic":     # indefinite and negative conics: no cull
        rows = conic_rows(rng, 120, opacity=(0.05, 0.3))
        rows[::3, 2:5] = rng.uniform(-0.05, 0.05, (40, 3))
        rows[::3, 3] = 0.2
        return rows, set()
    if case == "one_block":        # each footprint meets one 4x8 warp block
        rows = conic_rows(rng, 2048, opacity=(0.3, 0.99))
        block = rng.integers(0, 32, 2048)         # 4 x 8 blocks of 4x8 pixels
        rows[:, 0] = (block % 4) * 8 + 3.5 + rng.uniform(-0.4, 0.4, 2048)
        rows[:, 1] = (block // 4) * 4 + 1.5 + rng.uniform(-0.2, 0.2, 2048)
        rows[:, 2:5] = [8.0, 0.0, 8.0]
        return rows, set()
    raise ValueError(case)


@pytest.mark.parametrize("case", ["empty_tiles", "never_saturates", "low_opacity", "non_pd_conic", "one_block"])
def test_composite_forward_edge_cases(cuda, case):
    # Every tile gets every pair, in row order, except the empty ones. The
    # warps' footprint cull must leave the plain version's result: last
    # exactly, channels and T to float rounding of the same operations.
    rows, empty = forward_case(case)
    g = rows.shape[0]
    per_tile = [0 if t in empty else g for t in range(4)]
    ranges = torch.tensor(np.concatenate([[0], np.cumsum(per_tile)]), dtype=torch.int32, device=cuda)
    gids = torch.cat([torch.arange(n, dtype=torch.int32) for n in per_tile]).to(cuda)
    attrs = torch.from_numpy(rows).to(cuda)
    args = (gids, ranges, attrs, 2, (32, 32))
    out = kernels.composite_forward(*args)
    ref = kernels.composite_forward_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[1], ref[1], atol=1e-5, rtol=0)
    assert torch.equal(out[2], ref[2])
    t_tiles = kernels.tile(out[1], 2, 2)
    if case == "empty_tiles":
        for t in empty:
            assert (t_tiles[t] == 1.0).all() and (kernels.tile(out[2], 2, 2)[t] == ranges[t]).all()
        assert (t_tiles[0] < kernels.TRANSMITTANCE_MIN).any()
    elif case == "never_saturates":
        assert (out[1] >= kernels.TRANSMITTANCE_MIN).all() and (out[1] < 0.9).any()
    elif case == "low_opacity":
        # The faint pairs never contribute: the same image without them.
        keep = torch.arange(1, g, 2, device=cuda)
        kept_ids = torch.cat([keep.to(torch.int32) for _ in range(4)])
        kept_ranges = torch.arange(0, 4 * keep.numel() + 1, keep.numel(), dtype=torch.int32, device=cuda)
        alone = kernels.composite_forward(kept_ids, kept_ranges, attrs, 2, (32, 32))
        torch.testing.assert_close(alone[0], out[0], atol=0, rtol=0)
    elif case == "non_pd_conic":
        # The non-positive-definite pairs do composite somewhere.
        boxes = kernels.footprint_box_reference(attrs)
        assert torch.isinf(boxes[::3]).all()
        faded = attrs.clone()
        faded[::3, 5] = 0.0
        assert not torch.equal(kernels.composite_forward(gids, ranges, faded, 2, (32, 32))[0], out[0])
    elif case == "one_block":
        box = kernels.footprint_box_reference(attrs)
        bx, by = (attrs[:, 0] // 8) * 8, (attrs[:, 1] // 4) * 4
        assert ((box[:, 0] > bx - 1) & (box[:, 1] < bx + 8) & (box[:, 2] > by - 1) & (box[:, 3] < by + 4)).all()
        assert (out[1] < kernels.TRANSMITTANCE_MIN).any() and (out[1] == 1.0).any()


def test_tiled_forward_matches_dense_oracle(cuda):
    # Tolerances of tests/test_rasterize.py's tiled-vs-dense test.
    sg = screen_gaussians(5, 300, 32, cuda)
    bg = torch.tensor([0.1, 0.2, 0.3, 0.4], device=cuda)
    d_img, d_mask, d_depth = composite_dense(sg, (32, 32), bg, tile_size=16)
    img, mask, depth, _ = composite_tiled(sg, (32, 32), bg)
    torch.testing.assert_close(img, d_img, atol=2e-4, rtol=0)
    torch.testing.assert_close(mask, d_mask, atol=2e-4, rtol=0)
    torch.testing.assert_close(depth, d_depth, atol=2e-3, rtol=0)


def backward_inputs(seed, size, device, n=20000, n_channels=4):
    """Sorted pairs, the forward kernel's outputs and seeded cotangents."""
    tiles = size // 16
    sg = screen_gaussians(seed, n, size, device, n_channels=n_channels)
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    gids, ranges, order = sort_pairs(gids, keys, tiles * tiles)
    attrs = pack_attributes(sg)
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size))
    g = torch.Generator(device=device).manual_seed(seed)
    g_out = torch.randn(out.shape, generator=g, device=device)
    g_t = torch.randn(t_final.shape, generator=g, device=device)
    return tiles, counts, gids, ranges, order, attrs, last, t_final, g_out, g_t


@pytest.mark.parametrize("n_channels", [4, 7, 3, 11])   # + depth: the 5-, 8-, 4- and 12-channel instantiations
@pytest.mark.parametrize("size", [32, 64, 256])
def test_composite_backward_matches_reference(cuda, size, n_channels):
    # The kernel sums each pair's partials over the tile in its exchange
    # order, the plain version in torch.sum's order, and takes one
    # reciprocal where the plain version divides twice: agreement to
    # float32 rounding, 1e-4 of each gradient column's largest value.
    tiles, _, gids, ranges, order, attrs, last, t_final, g_out, g_t = backward_inputs(
        size + 2, size, cuda, n_channels=n_channels
    )
    args = (gids, ranges, order, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    before = kernels.launch_counts["composite_backward"]
    d = kernels.composite_backward(*args)
    ref = kernels.composite_backward_reference(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["composite_backward"] == before + 1
    assert d.shape == (gids.shape[0], 7 + n_channels)
    scale = ref.abs().amax(dim=0).clamp(min=1e-12)
    assert ((d - ref).abs() / scale).max().item() <= 1e-4
    # Rows of pairs that no pixel composited are zero in both.
    assert torch.equal(d[ref.abs().sum(dim=1) == 0], ref[ref.abs().sum(dim=1) == 0])
    # Same kernel, same inputs: the same bits (no atomics).
    assert torch.equal(d, kernels.composite_backward(*args))


def test_composite_backward_zero_rows_and_empty_tiles(cuda):
    # Only the first 4 of 16 tiles keep their pairs, and opaque splats leave
    # pairs past every pixel's `last`: torch.empty's contents must survive
    # in no row.
    size = 64
    tiles, _, gids, ranges, order, attrs, _, _, g_out, g_t = backward_inputs(11, size, cuda, n=3000)
    kept = int(ranges[4])
    ranges = torch.clamp(ranges, max=kept)
    gids = gids[:kept].contiguous()
    order = torch.argsort(torch.argsort(order[:kept]))    # a permutation of the kept pairs
    attrs = attrs.clone()
    attrs[:, 5] = 0.999
    _, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size))
    args = (gids, ranges, order, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    ref = kernels.composite_backward_reference(*args)
    zero = ref.abs().sum(dim=1) == 0
    assert zero.any()
    scale = ref.abs().amax(dim=0).clamp(min=1e-12)
    for _ in range(2):
        d = kernels.composite_backward(*args)
        assert torch.isfinite(d).all() and (d[zero] == 0).all()
        assert ((d - ref).abs() / scale).max().item() <= 1e-4


@pytest.mark.parametrize("row", [11, 14, 10, 18])
def test_reduce_pairs_matches_reference_synthetic(cuda, row):
    # Dead Gaussians and Gaussians at the cap, rows straight from a seed.
    # The kernel adds each segment in slot order, as index_add_ on the CPU
    # does: the same bits.
    rng = np.random.default_rng(row)
    counts = rng.integers(0, CAP + 1, 5000).astype(np.int32)
    counts[:50] = 0
    counts[50:100] = CAP
    counts[-1] = 0
    offsets = torch.cumsum(torch.from_numpy(counts).long(), dim=0)
    d_rows = torch.from_numpy(rng.standard_normal((int(counts.sum()), row)).astype(np.float32))
    out = kernels.reduce_pairs(d_rows.to(cuda), offsets.to(cuda))
    ref = kernels.reduce_pairs_reference(d_rows, offsets)
    assert torch.equal(out.cpu(), ref)
    assert (out[:50] == 0).all() and (out[-1] == 0).all()


def test_reduce_pairs_matches_reference(cuda):
    # On the rows composite_backward writes at flagship-like density.
    tiles, counts, gids, ranges, order, attrs, last, t_final, g_out, g_t = backward_inputs(7, 256, cuda)
    d = kernels.composite_backward(gids, ranges, order, attrs, tiles, (256, 256), last, t_final, g_out, g_t)
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    before = kernels.launch_counts["reduce_pairs"]
    out = kernels.reduce_pairs(d, offsets)
    ref = kernels.reduce_pairs_reference(d.cpu(), offsets.cpu())
    torch.cuda.synchronize()
    assert kernels.launch_counts["reduce_pairs"] == before + 1
    assert (counts == 0).any() and (counts == CAP).any() and torch.equal(out.cpu(), ref)
    assert torch.equal(out, kernels.reduce_pairs(d, offsets))


def test_tiled_gradients_match_dense_oracle(cuda):
    # Tolerance of tests/test_rasterize.py's gradient test: normalised by
    # each leaf's largest gradient, atol 5e-3.
    g = torch.Generator().manual_seed(3)
    n = 40
    z = torch.rand(n, generator=g) * 4 + 2
    xy = (torch.rand(n, 2, generator=g) * 1.2 - 0.6) * z[:, None]
    leaves = [
        torch.cat([xy, z[:, None]], dim=1),
        build_covariance(torch.rand(n, 3, generator=g) * 0.2 + 0.05,
                         torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)),
        torch.rand(n, generator=g) * 0.65 + 0.3,
        torch.rand(n, 4, generator=g),
    ]
    leaves = [x.to(cuda).requires_grad_() for x in leaves]
    target = torch.rand(4, 32, 32, generator=g).to(cuda)
    bg = torch.tensor([0.5, 0.1, 0.0, 0.2], device=cuda)
    intrinsics = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], device=cuda)

    def grads(backend):
        sg = project_gaussians_to_screen(*leaves, torch.eye(4, device=cuda), intrinsics, (32, 32))
        if backend == "dense":
            img, mask, depth = composite_dense(sg, (32, 32), bg, tile_size=16)
        else:
            img, mask, depth, _ = composite_tiled(sg, (32, 32), bg)
        loss = ((img - target) ** 2).mean() + mask.mean() + 1e-3 * depth.mean()
        return torch.autograd.grad(loss, leaves)

    before = dict(kernels.launch_counts)
    tiled = grads("tiled")
    assert all(kernels.launch_counts[k] > before[k] for k in before)
    for gt, gd in zip(tiled, grads("dense")):
        scale = gd.abs().max() + 1e-8
        torch.testing.assert_close(gt / scale, gd / scale, atol=5e-3, rtol=0)


def test_wrappers_check_inputs(cuda):
    sg = screen_gaussians(6, 100, 32, cuda)
    counts, base, nx, mask = tile_rects(sg, 2, 2, CAP)
    with pytest.raises(ValueError):
        kernels.duplicate_with_keys(counts.long(), mask, base, nx, sg.depth, 2, CAP)
    with pytest.raises(ValueError):
        kernels.duplicate_with_keys(counts, mask.cpu(), base, nx, sg.depth, 2, CAP)
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, 2, CAP)
    gids, ranges, _ = sort_pairs(gids, keys, 4)
    attrs = pack_attributes(sg)
    with pytest.raises(ValueError):   # 3 channels: no instantiation
        kernels.composite_forward(gids, ranges, attrs[:, :9].contiguous(), 2, (32, 32))
    with pytest.raises(ValueError):
        kernels.composite_forward(gids, ranges, attrs.t(), 2, (32, 32))
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, 2, (32, 32))
    assert np.isfinite(out.cpu().numpy()).all()
    order = torch.arange(gids.shape[0], device=cuda)
    with pytest.raises(ValueError):   # cotangent of the wrong shape
        kernels.composite_backward(gids, ranges, order, attrs, 2, (32, 32), last, t_final, out[:, :1], t_final)
    with pytest.raises(ValueError):   # a CPU tensor among CUDA ones
        kernels.composite_backward(gids, ranges, order, attrs, 2, (32, 32), last, t_final.cpu(), out, t_final)
    with pytest.raises(ValueError):   # order of the wrong length
        kernels.composite_backward(gids, ranges, order[1:], attrs, 2, (32, 32), last, t_final, out, t_final)
    with pytest.raises(ValueError):   # order on the CPU
        kernels.composite_backward(gids, ranges, order.cpu(), attrs, 2, (32, 32), last, t_final, out, t_final)
    with pytest.raises(ValueError):   # int32 order
        kernels.composite_backward(gids, ranges, gids, attrs, 2, (32, 32), last, t_final, out, t_final)
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    d = torch.zeros((gids.shape[0], attrs.shape[1]), device=cuda)
    with pytest.raises(ValueError):   # int32 offsets
        kernels.reduce_pairs(d, offsets.int())
    with pytest.raises(ValueError):   # offsets on the CPU
        kernels.reduce_pairs(d, offsets.cpu())
    with pytest.raises(ValueError):   # a row length with no instantiation
        kernels.reduce_pairs(d[:, :9].contiguous(), offsets)


# -- the fast family (model.decoder.precision "fast", "fast_nocoef" and the
# diagnostic precisions with a per-pair knob) --------------------------------

FORWARD_VARIANTS = {"coef": {"coef": True}, "fast": {"f16_xy": True, "bf16_mm": True},
                    "f16_xy": {"f16_xy": True}, "bf16_mm": {"bf16_mm": True}}
BACKWARD_VARIANTS = {"fast": {"f16_xy": True, "bf16_mm": True, "bf16_grads": True}, "f16_xy": {"f16_xy": True},
                     "bf16_mm": {"bf16_mm": True}, "bf16_grads": {"bf16_grads": True}}


def fast_inputs(seed, size, device, n_channels):
    """Pairs and attribute rows as composite_tiled prepares them at "fast";
    some tile spans 6 scan blocks or more, so that the backward's split
    walk (bf16_mm) runs several blocks a tile."""
    tiles = size // 16
    sg = screen_gaussians(seed, 20000, size, device, n_channels=n_channels)
    gids, ranges, order, _, _ = tile_pairs(sg, (size, size), CAP, "fast")
    attrs = quantize_attributes(pack_attributes(sg), precision_knobs("fast"), depth_code_bits(tiles * tiles)[1])
    starts, stops = ranges[:-1].long(), ranges[1:].long()
    assert int(((stops - 1) // kernels.SCAN_BLOCK - starts // kernels.SCAN_BLOCK + 1).max()) >= 6
    return tiles, gids, ranges, order, attrs


def variant_launches(name, variant, n_ch):
    return kernels.launches_by_variant[name].get(variant, {}).get(n_ch, 0)


@pytest.mark.parametrize("n_channels", [4, 7, 11])   # + depth: the 5-, 8- and 12-channel instantiations
@pytest.mark.parametrize("variant", list(FORWARD_VARIANTS))
def test_composite_forward_fast_variants_match_reference(cuda, variant, n_channels):
    # Explicitly rounded in the plain version's order: `last` and the block
    # state exactly, T and channels to 1e-5 (of each channel's largest value).
    size = 64
    tiles, gids, ranges, _, attrs = fast_inputs(size + 5, size, cuda, n_channels)
    knobs = FORWARD_VARIANTS[variant]
    blocks = ref_blocks = None
    if knobs.get("bf16_mm"):
        blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles)
        blocks[1].zero_()
        ref_blocks = (blocks[0], torch.zeros_like(blocks[1]))
    before = variant_launches("composite_forward", variant, n_channels + 1)
    out = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size), **knobs, blocks=blocks)
    ref = kernels.composite_forward_reference(gids, ranges, attrs, tiles, (size, size), **knobs, blocks=ref_blocks)
    torch.cuda.synchronize()
    assert variant_launches("composite_forward", variant, n_channels + 1) == before + 1
    assert (ref[1] < kernels.TRANSMITTANCE_MIN).any(), "scene never saturates"
    scale = ref[0].abs().amax(dim=(2, 3), keepdim=True)
    assert ((out[0] - ref[0]).abs() / scale).max().item() <= 1e-5
    torch.testing.assert_close(out[1], ref[1], atol=1e-5, rtol=0)
    assert torch.equal(out[2], ref[2])
    if blocks is not None:
        assert (blocks[1][..., 1] != 0).any() and torch.equal(blocks[1], ref_blocks[1])


@pytest.mark.parametrize("n_channels", [4, 7, 11])
@pytest.mark.parametrize("variant", list(BACKWARD_VARIANTS))
def test_composite_backward_fast_variants_match_reference(cuda, variant, n_channels):
    # 1e-4 of each column's largest value as the exact kernel; a row rounded
    # to bfloat16 may round the other way where the two float32 sums
    # differ, so with bf16_grads also one bfloat16 step (at most 2^-7 of
    # the value).
    size = 64
    tiles, gids, ranges, order, attrs = fast_inputs(size + 6, size, cuda, n_channels)
    knobs = BACKWARD_VARIANTS[variant]
    mm = knobs.get("bf16_mm", False)
    blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles) if mm else None
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size),
                                                   f16_xy=knobs.get("f16_xy", False), bf16_mm=mm, blocks=blocks)
    g = torch.Generator(device=cuda).manual_seed(size)
    g_out = torch.randn(out.shape, generator=g, device=cuda)
    g_t = torch.randn(t_final.shape, generator=g, device=cuda)
    args = (gids, ranges, order, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    before = variant_launches("composite_backward", variant, n_channels + 1)
    d = kernels.composite_backward(*args, **knobs, blocks=blocks)
    ref = kernels.composite_backward_reference(*args, **knobs, blocks=blocks)
    torch.cuda.synchronize()
    assert variant_launches("composite_backward", variant, n_channels + 1) == before + 1
    bound = 1e-4 * ref.abs().amax(dim=0).clamp(min=1e-12)
    if knobs.get("bf16_grads"):
        bound = bound + 2.0**-7 * ref.abs()
    assert ((d - ref).abs() <= bound).all()
    assert torch.equal(d, kernels.composite_backward(*args, **knobs, blocks=blocks))


def test_split_walk_takes_bf16_mm_only(cuda):
    # The backward's C entry point needs the block state and the split
    # walk's suffix scratch under bf16_mm, and refuses a call without them;
    # without bf16_mm it walks each tile serially and needs neither. The
    # wrapper counts one launch per call either way.
    size = 64
    tiles, gids, ranges, order, attrs = fast_inputs(size + 7, size, cuda, 7)
    blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles)
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size), f16_xy=True,
                                                   bf16_mm=True, blocks=blocks)
    g = torch.Generator(device=cuda).manual_seed(3)
    g_out = torch.randn(out.shape, generator=g, device=cuda)
    g_t = torch.randn(t_final.shape, generator=g, device=cuda)
    args = (gids, ranges, order, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    lib = kernels.load_library()
    d_rows = torch.empty((gids.shape[0], attrs.shape[1]), device=cuda)
    pointers = (1, tiles * tiles, gids.data_ptr(), ranges.data_ptr(), order.data_ptr(), attrs.data_ptr(), tiles, size,
                size, last.data_ptr(), t_final.data_ptr(), g_out.data_ptr(), g_t.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    serial = kernels._knob_bits(True, False, True)
    assert lib.composite_backward_fast(8, serial, *pointers, None, None, 0, None, d_rows.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(d_rows, kernels.composite_backward(*args, f16_xy=True, bf16_grads=True))
    split = kernels._knob_bits(True, True, True)
    assert lib.composite_backward_fast(8, split, *pointers, blocks[0].data_ptr(), blocks[1].data_ptr(), 0, None,
                                       d_rows.data_ptr(), stream) != 0
    before = variant_launches("composite_backward", "fast", 8)
    kernels.composite_backward(*args, f16_xy=True, bf16_mm=True, bf16_grads=True, blocks=blocks)
    assert variant_launches("composite_backward", "fast", 8) == before + 1


def test_fast_render_runs_the_fast_variants(cuda):
    # Serving at "fast" takes the coefficient layout; a differentiated
    # render the fast forward and backward; nothing falls back to the exact
    # kernels, and a channel count without a fast instantiation raises.
    size = 64
    sg = screen_gaussians(11, 5000, size, cuda, n_channels=7)
    bg = torch.rand(7, generator=torch.Generator().manual_seed(0)).to(cuda)
    exact_before = (variant_launches("composite_forward", "exact", 8), variant_launches("composite_backward", "exact", 8))
    before = variant_launches("composite_forward", "coef", 8)
    with torch.no_grad():
        served = composite_tiled(sg, (size, size), bg, precision="fast")
    assert variant_launches("composite_forward", "coef", 8) == before + 1
    cpu = type(sg)(**{k: v.cpu() for k, v in vars(sg).items()})
    with torch.no_grad():
        plain = composite_tiled(cpu, (size, size), bg.cpu(), precision="fast")
    for a, b in zip(served[:3], plain[:3]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    opacity = sg.opacity.clone().requires_grad_(True)
    trained = type(sg)(**{**vars(sg), "opacity": opacity})
    before = (variant_launches("composite_forward", "fast", 8), variant_launches("composite_backward", "fast", 8))
    img, mask, _, _ = composite_tiled(trained, (size, size), bg, precision="fast")
    (img.square().sum() + mask.sum()).backward()
    assert (variant_launches("composite_forward", "fast", 8), variant_launches("composite_backward", "fast", 8)) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(opacity.grad).all()
    assert (variant_launches("composite_forward", "exact", 8), variant_launches("composite_backward", "exact", 8)) == exact_before
    four = screen_gaussians(12, 500, size, cuda, n_channels=3)
    with pytest.raises(ValueError, match="built for"), torch.no_grad():
        composite_tiled(four, (size, size), torch.zeros(3, device=cuda), precision="fast")


# -- passes: the (scene, view) items of a render call in one launch ----------------


PASS_GAUSSIANS = 20000


def pass_inputs(seed, size, device, n_channels, precision="exact", n_items=4):
    """A pass of `n_items` views of one scene from cameras that differ (each
    view its own pair count), prepared as composite_tiled prepares them at
    `precision`: the screen Gaussians (items first), the sorted pairs, the
    quantized attribute rows."""
    g = torch.Generator().manual_seed(seed)
    n = PASS_GAUSSIANS
    z = torch.rand(n, generator=g) * 4 + 2
    means = torch.cat([(torch.rand(n, 2, generator=g) * 1.2 - 0.6) * z[:, None], z[:, None]], dim=1)
    covs = build_covariance(torch.rand(n, 3, generator=g) * 0.2 + 0.05,
                            torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1))
    ext = torch.eye(4).repeat(n_items, 1, 1)
    ext[:, 0, 3] = torch.linspace(-0.6, 0.6, n_items)
    ext[:, 2, 3] = torch.linspace(0.0, 1.0, n_items)
    intr = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).expand(n_items, 3, 3)
    sg = project_gaussians_to_screen(means.expand(n_items, n, 3), covs.expand(n_items, n, 3, 3),
                                     (torch.rand(n, generator=g) * 0.65 + 0.3).expand(n_items, n),
                                     torch.rand(n_items, n, n_channels, generator=g), ext, intr, (size, size))
    sg = type(sg)(**{k: v.to(device) for k, v in vars(sg).items()})
    tiles = size // 16
    gids, ranges, order, counts, pairs = tile_pairs(sg, (size, size), CAP, precision)
    attrs = quantize_attributes(pack_attributes(sg), precision_knobs(precision), depth_code_bits(tiles * tiles)[1],
                                n_items)
    assert len(set(pairs.tolist())) == n_items, pairs
    return sg, tiles, gids, ranges, order, counts, attrs


@pytest.mark.parametrize("variant", ["exact", "coef", "fast"])
def test_pass_of_views_matches_reference(cuda, variant):
    # A pass of 4 views: every kernel and variant against its plain version
    # on the pass, under the bounds of the one-view tests above.
    size = 64
    precision = "exact" if variant == "exact" else "fast"
    sg, tiles, gids, ranges, order, counts, attrs = pass_inputs(size + 8, size, cuda, 7, precision)
    knobs = {"exact": {}, "coef": {"coef": True}, "fast": {"f16_xy": True, "bf16_mm": True}}[variant]
    blocks = ref_blocks = None
    if variant == "fast":
        blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles)
        blocks[1].zero_()
        ref_blocks = (blocks[0], torch.zeros_like(blocks[1]))
    args = (gids, ranges, attrs, tiles, (size, size))
    out = kernels.composite_forward(*args, **knobs, blocks=blocks)
    ref = kernels.composite_forward_reference(*args, **knobs, blocks=ref_blocks)
    torch.cuda.synchronize()
    assert out[0].shape == (4, 8, size, size) and out[2].shape == (4, size, size)
    scale = ref[0].abs().amax(dim=(2, 3), keepdim=True)
    assert ((out[0] - ref[0]).abs() / scale).max().item() <= 1e-5
    torch.testing.assert_close(out[1], ref[1], atol=1e-5, rtol=0)
    assert torch.equal(out[2], ref[2])
    if blocks is not None:
        assert (blocks[1][..., 1] != 0).any() and torch.equal(blocks[1], ref_blocks[1])
    if variant == "coef":
        return
    g = torch.Generator(device=cuda).manual_seed(size)
    g_out = torch.randn(out[0].shape, generator=g, device=cuda)
    g_t = torch.randn(out[1].shape, generator=g, device=cuda)
    bwd = {"exact": {}, "fast": {"f16_xy": True, "bf16_mm": True, "bf16_grads": True}}[variant]
    bargs = (gids, ranges, order, attrs, tiles, (size, size), out[2], out[1], g_out, g_t)
    d = kernels.composite_backward(*bargs, **bwd, blocks=blocks)
    d_ref = kernels.composite_backward_reference(*bargs, **bwd, blocks=blocks)
    torch.cuda.synchronize()
    bound = 1e-4 * d_ref.abs().amax(dim=0).clamp(min=1e-12)
    if variant == "fast":
        bound = bound + 2.0**-7 * d_ref.abs()
    assert ((d - d_ref).abs() <= bound).all()
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    assert torch.equal(kernels.reduce_pairs(d, offsets).cpu(), kernels.reduce_pairs_reference(d.cpu(), offsets.cpu()))


@pytest.mark.parametrize("variant", ["exact", "coef", "fast"])
def test_pass_of_views_equals_one_view_launches(cuda, variant):
    # Each item of a pass gets the bits of a launch over that item alone:
    # the forward's outputs (`last` less the item's first pair), the block
    # state's entries and the backward's rows.
    size = 64
    precision = "exact" if variant == "exact" else "fast"
    sg, tiles, gids, ranges, order, counts, attrs = pass_inputs(size + 9, size, cuda, 7, precision)
    knobs = {"exact": {}, "coef": {"coef": True}, "fast": {"f16_xy": True, "bf16_mm": True}}[variant]
    mm = variant == "fast"
    blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles) if mm else None
    out = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size), **knobs, blocks=blocks)
    g = torch.Generator(device=cuda).manual_seed(1)
    g_out = torch.randn(out[0].shape, generator=g, device=cuda)
    g_t = torch.randn(out[1].shape, generator=g, device=cuda)
    bwd = {"exact": {}, "coef": None, "fast": {"f16_xy": True, "bf16_mm": True, "bf16_grads": True}}[variant]
    if bwd is not None:
        rows = kernels.composite_backward(gids, ranges, order, attrs, tiles, (size, size), out[2], out[1], g_out, g_t,
                                          **bwd, blocks=blocks)
        sorted_rows = rows[order]
    per_item = attrs.shape[0] // 4
    for n in range(4):
        item = type(sg)(**{k: v[n] for k, v in vars(sg).items()})
        i_gids, i_ranges, i_order, _, _ = tile_pairs(item, (size, size), CAP, precision)
        lo, hi = int(ranges[n * tiles * tiles]), int(ranges[(n + 1) * tiles * tiles])
        assert torch.equal(i_gids, gids[lo:hi] - n * per_item)
        assert torch.equal(i_ranges, ranges[n * tiles * tiles : (n + 1) * tiles * tiles + 1] - lo)
        i_attrs = attrs[n * per_item : (n + 1) * per_item]
        i_blocks = kernels.block_state(i_ranges, i_gids.shape[0], tiles * tiles) if mm else None
        i_out = kernels.composite_forward(i_gids, i_ranges, i_attrs, tiles, (size, size), **knobs, blocks=i_blocks)
        assert torch.equal(i_out[0][0], out[0][n]) and torch.equal(i_out[1][0], out[1][n])
        assert torch.equal(i_out[2][0], out[2][n] - lo)
        if bwd is not None:
            i_rows = kernels.composite_backward(i_gids, i_ranges, i_order, i_attrs, tiles, (size, size), i_out[2],
                                                i_out[1], g_out[n : n + 1].contiguous(), g_t[n : n + 1].contiguous(),
                                                **bwd, blocks=i_blocks)
            assert torch.equal(i_rows[i_order], sorted_rows[lo:hi])
