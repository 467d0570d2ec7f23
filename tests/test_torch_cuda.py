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
    gids, ranges = sort_pairs(gids, keys, tiles * tiles)
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


def test_wrappers_check_inputs(cuda):
    sg = screen_gaussians(6, 100, 32, cuda)
    counts, base, nx, mask = tile_rects(sg, 2, 2, CAP)
    with pytest.raises(ValueError):
        kernels.duplicate_with_keys(counts.long(), mask, base, nx, sg.depth, 2, CAP)
    with pytest.raises(ValueError):
        kernels.duplicate_with_keys(counts, mask.cpu(), base, nx, sg.depth, 2, CAP)
    gids, keys = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, 2, CAP)
    gids, ranges = sort_pairs(gids, keys, 4)
    attrs = pack_attributes(sg)
    with pytest.raises(ValueError):   # 3 channels: no instantiation
        kernels.composite_forward(gids, ranges, attrs[:, :9].contiguous(), 2, (32, 32))
    with pytest.raises(ValueError):
        kernels.composite_forward(gids, ranges, attrs.t(), 2, (32, 32))
    assert np.isfinite(kernels.composite_forward(gids, ranges, attrs, 2, (32, 32))[0].cpu().numpy()).all()
