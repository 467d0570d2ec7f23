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
    pack_attributes,
    sort_pairs,
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
    gids, keys = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, sg.depth, tiles, CAP)
    torch.cuda.synchronize()
    assert kernels.launch_counts["duplicate_with_keys"] == before + 1
    assert torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)


@pytest.mark.parametrize("size", [32, 256])
def test_composite_forward_matches_reference(cuda, size):
    # Same operations in the same rounding order on the same device.
    tiles = size // 16
    sg = screen_gaussians(size + 1, 20000, size, cuda)
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    gids, keys = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
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


def test_tiled_forward_matches_dense_oracle(cuda):
    # Tolerances of tests/test_rasterize.py's tiled-vs-dense test.
    sg = screen_gaussians(5, 300, 32, cuda)
    bg = torch.tensor([0.1, 0.2, 0.3, 0.4], device=cuda)
    d_img, d_mask, d_depth = composite_dense(sg, (32, 32), bg, tile_size=16)
    img, mask, depth, _ = composite_tiled(sg, (32, 32), bg)
    torch.testing.assert_close(img, d_img, atol=2e-4, rtol=0)
    torch.testing.assert_close(mask, d_mask, atol=2e-4, rtol=0)
    torch.testing.assert_close(depth, d_depth, atol=2e-3, rtol=0)


def backward_inputs(seed, size, device, n=20000):
    """Sorted pairs, the forward kernel's outputs and seeded cotangents."""
    tiles = size // 16
    sg = screen_gaussians(seed, n, size, device)
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    gids, keys = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    gids, ranges, order = sort_pairs(gids, keys, tiles * tiles)
    attrs = pack_attributes(sg)
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size))
    g = torch.Generator(device=device).manual_seed(seed)
    g_out = torch.randn(out.shape, generator=g, device=device)
    g_t = torch.randn(t_final.shape, generator=g, device=device)
    return tiles, counts, gids, ranges, order, attrs, last, t_final, g_out, g_t


@pytest.mark.parametrize("size", [32, 256])
def test_composite_backward_matches_reference(cuda, size):
    # The kernel sums each pair's partials over the tile in warp order, the
    # plain version in torch.sum's order: agreement to float32 rounding of
    # ~256-term sums, 1e-4 of each gradient column's largest value.
    tiles, _, gids, ranges, _, attrs, last, t_final, g_out, g_t = backward_inputs(size + 2, size, cuda)
    before = kernels.launch_counts["composite_backward"]
    d = kernels.composite_backward(gids, ranges, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    ref = kernels.composite_backward_reference(gids, ranges, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    torch.cuda.synchronize()
    assert kernels.launch_counts["composite_backward"] == before + 1
    scale = ref.abs().amax(dim=0).clamp(min=1e-12)
    assert ((d - ref).abs() / scale).max().item() <= 1e-4
    # Same kernel, same inputs: the same bits (no atomics).
    again = kernels.composite_backward(gids, ranges, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    assert torch.equal(d, again)


def test_reduce_pairs_matches_reference(cuda):
    # Both add each Gaussian's rows in tile order (the plain version on the
    # CPU, where index_add_ runs in index order): the same bits.
    tiles, counts, gids, ranges, order, attrs, last, t_final, g_out, g_t = backward_inputs(7, 256, cuda)
    d = kernels.composite_backward(gids, ranges, attrs, tiles, (256, 256), last, t_final, g_out, g_t)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=cuda)
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    before = kernels.launch_counts["reduce_pairs"]
    out = kernels.reduce_pairs(d, gids, inverse, offsets)
    ref = kernels.reduce_pairs_reference(d.cpu(), gids.cpu(), counts.shape[0])
    torch.cuda.synchronize()
    assert kernels.launch_counts["reduce_pairs"] == before + 1
    assert (counts == 0).any() and torch.equal(out.cpu(), ref)


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
    gids, keys = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, 2, CAP)
    gids, ranges, _ = sort_pairs(gids, keys, 4)
    attrs = pack_attributes(sg)
    with pytest.raises(ValueError):   # 3 channels: no instantiation
        kernels.composite_forward(gids, ranges, attrs[:, :9].contiguous(), 2, (32, 32))
    with pytest.raises(ValueError):
        kernels.composite_forward(gids, ranges, attrs.t(), 2, (32, 32))
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, 2, (32, 32))
    assert np.isfinite(out.cpu().numpy()).all()
    with pytest.raises(ValueError):   # cotangent of the wrong shape
        kernels.composite_backward(gids, ranges, attrs, 2, (32, 32), last, t_final, out[:1], t_final)
    with pytest.raises(ValueError):   # a CPU tensor among CUDA ones
        kernels.composite_backward(gids, ranges, attrs, 2, (32, 32), last, t_final.cpu(), out, t_final)
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    d = torch.zeros((gids.shape[0], attrs.shape[1]), device=cuda)
    with pytest.raises(ValueError):   # int32 inverse
        kernels.reduce_pairs(d, gids, gids, offsets)
