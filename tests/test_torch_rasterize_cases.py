"""The rasterizer's NaN-safe and edge cases of tests/test_rasterize.py
(TestNonPdConicGradients, TestEmptyScenes, TestScaleEnvelope) on the port:
its tiled path (the plain kernel versions on the CPU) and its dense oracle,
on the JAX tests' own scenes, against the JAX package's composites."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.ops.rasterize import composite_dense as j_composite_dense
from latentsplat_tpu.ops.rasterize import project_gaussians_to_screen as j_project
from latentsplat_tpu.ops.rasterize.tiled import composite_tiled as j_composite_tiled
from latentsplat_tpu.ops.rasterize.types import ScreenGaussians as JScreenGaussians
from latentsplat_tpu_torch.ops.rasterize.camera import project_gaussians_to_screen
from latentsplat_tpu_torch.ops.rasterize.dense import composite_dense
from latentsplat_tpu_torch.ops.rasterize.tiled import composite_tiled, tile_rects
from latentsplat_tpu_torch.ops.rasterize.types import ScreenGaussians

from tests.test_rasterize import EXTRINSICS, INTRINSICS, make_gaussians
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def both(arrays, shape):
    """The same numpy Gaussians projected by the JAX package and the port."""
    means, covs, ops, channels = (np.array(a, np.float32) for a in arrays)
    j_sg = j_project(*map(jnp.asarray, (means, covs, ops, channels)), EXTRINSICS, INTRINSICS, shape)
    sg = project_gaussians_to_screen(*map(torch.from_numpy, (means, covs, ops, channels)),
                                     torch.from_numpy(np.asarray(EXTRINSICS)),
                                     torch.from_numpy(np.asarray(INTRINSICS)), shape)
    return j_sg, sg


def replace(sg: ScreenGaussians, **fields) -> ScreenGaussians:
    return ScreenGaussians(**{**sg.__dict__, **fields})


# -- TestNonPdConicGradients ----------------------------------------------------------


def non_pd_scene():
    """Two splats in opposite corners of a 128 px image, the first with a
    slightly non-positive-definite conic: at the other splat's pixels its
    exponent is large and positive (exp overflows float32)."""
    arrays = dict(
        mean2d=[[8.0, 8.0], [120.0, 120.0]], conic=[[2.0, -2.008, 2.0], [0.5, 0.0, 0.5]], depth=[3.0, 4.0],
        radius=[4.0, 4.0], opacity=[0.9, 0.8], channels=[[1.0, 0.3], [0.2, 0.7]], extent=[[4.0, 4.0], [4.0, 4.0]],
    )
    sg = ScreenGaussians(**{k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()})
    j_sg = JScreenGaussians(**{k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()})
    return j_sg, sg


@pytest.mark.parametrize("backend", ["tiled", "dense"])
def test_non_pd_conic_gradients_finite(backend):
    j_sg, sg = non_pd_scene()
    bg = torch.zeros(2)
    opacity = sg.opacity.clone().requires_grad_(True)
    if backend == "tiled":
        img, mask, _, _ = composite_tiled(replace(sg, opacity=opacity), (128, 128), bg)
    else:
        img, mask, _ = composite_dense(replace(sg, opacity=opacity), (128, 128), bg)
    (img.square().sum() + mask.sum()).backward()
    assert torch.isfinite(opacity.grad).all(), opacity.grad
    # The tiled path draws the non-PD splat only inside its tile rect, the
    # dense one wherever its exponent is not positive: each is held against
    # the JAX package's composite of its own kind (its tiled one in
    # interpret mode, without the bf16 channel packing).
    if backend == "tiled":
        j_img, j_mask, _ = j_composite_tiled(j_sg, (128, 128), jnp.zeros(2), pack_channels=False)
    else:
        j_img, j_mask, _ = j_composite_dense(j_sg, (128, 128), jnp.zeros(2))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(j_img), atol=2e-4)
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(j_mask), atol=2e-4)


# -- TestEmptyScenes ------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["tiled", "dense"])
def test_all_culled_scene_is_background_with_zero_gradients(backend):
    means, covs, ops, channels = make_gaussians(jax.random.PRNGKey(13), 32)
    means = means.at[:, 2].set(-5.0)   # all behind the camera
    _, sg = both((means, covs, ops, channels), (32, 32))
    bg = torch.full((sg.num_channels,), 0.25)
    opacity = sg.opacity.clone().requires_grad_(True)
    if backend == "tiled":
        img, mask, depth, n_pairs = composite_tiled(replace(sg, opacity=opacity), (32, 32), bg)
        assert n_pairs == 0
    else:
        img, mask, depth = composite_dense(replace(sg, opacity=opacity), (32, 32), bg)
    img.sum().backward()
    np.testing.assert_allclose(img.detach().numpy(), 0.25, rtol=1e-6)
    np.testing.assert_allclose(mask.detach().numpy(), 0.0, atol=1e-7)
    assert torch.isfinite(depth).all()
    np.testing.assert_allclose(opacity.grad.numpy(), 0.0, atol=1e-7)


# -- TestScaleEnvelope ----------------------------------------------------------------


def test_512px_matches_dense():
    h = w = 512   # 32 x 32 = 1024 tiles
    means, covs, ops, channels = make_gaussians(jax.random.PRNGKey(40), 64, n_channels=2)
    j_sg, sg = both((means, covs * 1e-2, ops, channels), (h, w))
    bg = torch.tensor([0.1, 0.3])
    img, mask, depth, _ = composite_tiled(sg, (h, w), bg)
    d_img, d_mask, d_depth = composite_dense(sg, (h, w), bg)
    j_img, j_mask, j_depth = j_composite_dense(j_sg, (h, w), jnp.asarray(bg.numpy()))
    for ours, dense, theirs, atol in ((img, d_img, j_img, 2e-4), (mask, d_mask, j_mask, 2e-4),
                                      (depth, d_depth, j_depth, 2e-3)):
        np.testing.assert_allclose(ours.numpy(), dense.numpy(), atol=atol)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=atol)


def test_huge_splat_cap_widening_matches_dense():
    """A near, wide Gaussian whose tile rect exceeds the default 9-slot cap:
    the default cap truncates its rect (finite, not equal), a cap of 24
    recovers the dense composite."""
    h = w = 128
    means = np.asarray([[0.0, 0.0, 2.5], [0.3, -0.2, 4.0]])
    covs = np.stack([np.eye(3) * 0.03, np.eye(3) * 0.005])
    j_sg, sg = both((means, covs, [0.9, 0.8], [[1.0, 0.2], [0.1, 0.9]]), (h, w))
    counts, *_ = tile_rects(sg, w // 16, h // 16, 24)
    assert int(counts[0]) > 9, "fixture no longer exceeds the cap"
    bg = torch.zeros(2)
    img, mask, _, _ = composite_tiled(sg, (h, w), bg, max_tiles_per_gaussian=24)
    j_img, j_mask, _ = j_composite_dense(j_sg, (h, w), jnp.zeros(2))
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=2e-4)
    np.testing.assert_allclose(mask.numpy(), np.asarray(j_mask), atol=2e-4)
    capped, _, _, _ = composite_tiled(sg, (h, w), bg)
    assert torch.isfinite(capped).all() and not torch.allclose(capped, img, atol=2e-4)
