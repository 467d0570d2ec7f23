"""Small ops of the port against their JAX counterparts on the same numpy
inputs: SH, distributions, resize, shims, positional encoding and the
epipolar projection. All are elementwise float32 formulas evaluated in the
same order, so tolerances are a few float32 ulps of the values' scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.dataset import shims as jax_shims
from latentsplat_tpu.geometry import project_rays as jax_project_rays
from latentsplat_tpu.model.encodings import positional_encoding as jax_pe
from latentsplat_tpu.ops import distributions as jax_dist
from latentsplat_tpu.ops import sh as jax_sh
from latentsplat_tpu.ops.resize import resize_antialias as jax_resize
from latentsplat_tpu_torch.dataset import shims
from latentsplat_tpu_torch.geometry import project_rays
from latentsplat_tpu_torch.model.encodings import positional_encoding
from latentsplat_tpu_torch.ops import distributions, sh
from latentsplat_tpu_torch.ops.resize import resize_antialias
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def unit(rng, shape):
    d = rng.standard_normal((*shape, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def rotations(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh(degree):
    rng = np.random.default_rng(degree)
    coeffs = rng.standard_normal((64, 3, 25)).astype(np.float32)
    dirs = unit(rng, (64,))
    ours = sh.eval_sh(degree, torch.from_numpy(coeffs), torch.from_numpy(dirs))
    theirs = jax_sh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(dirs))
    assert ours.shape == (64, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


@pytest.mark.parametrize("n_coeffs", [1, 4, 9, 16, 25])
def test_rotate_sh(n_coeffs):
    rng = np.random.default_rng(n_coeffs)
    coeffs = rng.standard_normal((50, 3, n_coeffs)).astype(np.float32)
    rot = rotations(rng, 50)
    ours = sh.rotate_sh(torch.from_numpy(coeffs), torch.from_numpy(rot)[:, None])
    theirs = jax_sh.rotate_sh(jnp.asarray(coeffs), jnp.asarray(rot)[:, None])
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)
    # Equivariance: eval(rotate(c, R), R d) == eval(c, d).
    if n_coeffs > 1:
        degree = int(np.sqrt(n_coeffs)) - 1
        dirs = unit(rng, (50,))
        turned = np.einsum("nij,nj->ni", rot, dirs)
        a = sh.eval_sh(degree, ours, torch.from_numpy(turned))
        b = sh.eval_sh(degree, torch.from_numpy(coeffs), torch.from_numpy(dirs))
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_logvar_clamp_forward_values():
    # Exact: the straight-through clamp's forward values and the plain clip
    # taken by infinite inputs (the decoder's log1p(-1) = -inf).
    raw = np.array([-np.inf, -50.0, -30.0, -1.0, 0.0, 3.5, 20.0, 25.0, np.inf], np.float32)
    ours = distributions.DiagonalGaussian(torch.zeros(9), torch.from_numpy(raw)).logvar
    theirs = jax_dist.DiagonalGaussian(jnp.zeros(9), jnp.asarray(raw)).logvar
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # The straight-through gradient: 1 everywhere finite, 0 at +-inf.
    x = torch.from_numpy(raw).requires_grad_()
    distributions.clamp_logvar(x, -30.0, 20.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.isfinite(raw).astype(np.float32))


def test_sample_discrete_distribution_with_noise(monkeypatch):
    # Integer bucket choices are exact given the same uniform samples.
    rng = np.random.default_rng(0)
    pdf = rng.uniform(0, 1, (4, 50, 32)).astype(np.float32)
    noise = rng.uniform(0, 1, (4, 50, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    j_index, j_density = jax_dist.sample_discrete_distribution(None, jnp.asarray(pdf), 3)
    index, density = distributions.sample_discrete_distribution(torch.from_numpy(pdf), 3, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(index.numpy(), np.asarray(j_index))
    np.testing.assert_allclose(density.numpy(), np.asarray(j_density), rtol=1e-6)
    # A generator draws with the same shape and range.
    index_g, _ = distributions.sample_discrete_distribution(
        torch.from_numpy(pdf), 3, generator=torch.Generator().manual_seed(0)
    )
    assert index_g.shape == (4, 50, 3) and int(index_g.max()) < 32


def test_gather_discrete_topk():
    rng = np.random.default_rng(1)
    pdf = rng.uniform(0, 1, (100, 32)).astype(np.float32)
    index, density = distributions.gather_discrete_topk(torch.from_numpy(pdf), 2)
    j_index, j_density = jax_dist.gather_discrete_topk(jnp.asarray(pdf), 2)
    np.testing.assert_array_equal(index.numpy(), np.asarray(j_index))
    np.testing.assert_allclose(density.numpy(), np.asarray(j_density), rtol=1e-6)


def test_normal_sample_with_noise():
    rng = np.random.default_rng(2)
    mean, logvar, noise = (rng.standard_normal((5, 4, 9)).astype(np.float32) for _ in range(3))
    ours = distributions.DiagonalGaussian(torch.from_numpy(mean), torch.from_numpy(logvar)).sample(
        noise=torch.from_numpy(noise)
    )
    np.testing.assert_allclose(ours.numpy(), mean + np.exp(0.5 * logvar) * noise, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,out", [((256, 256), (32, 32)), ((64, 48), (8, 6)), ((16, 16), (32, 32))])
def test_resize_antialias(size, out):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, *size, 4)).astype(np.float32)
    ours = resize_antialias(torch.from_numpy(x), out)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_resize(jnp.asarray(x), out)), atol=1e-5)


def test_positional_encoding():
    x = np.random.default_rng(4).uniform(0, 1, (100, 2)).astype(np.float32)
    np.testing.assert_allclose(
        positional_encoding(torch.from_numpy(x), 10).numpy(), np.asarray(jax_pe(jnp.asarray(x), 10)), atol=1e-4
    )


def make_views(rng, n, size):
    ext = np.tile(np.eye(4, dtype=np.float32), (1, n, 1, 1))
    ext[0, :, :3, 3] = rng.uniform(-0.5, 0.5, (n, 3))
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 0.8, 0.5], [0, 0, 1]], np.float32), (1, n, 1, 1))
    image = rng.uniform(0, 1, (1, n, size, size + 6, 3)).astype(np.float32)
    return {"image": image, "extrinsics": ext, "intrinsics": intr,
            "near": np.ones((1, n), np.float32), "far": np.full((1, n), 10.0, np.float32)}


def test_patch_and_bounds_shims():
    rng = np.random.default_rng(5)
    batch = {"context": make_views(rng, 2, 36), "target": make_views(rng, 3, 36)}
    ours = shims.apply_bounds_shim(
        shims.apply_patch_shim({k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in batch.items()}, 16),
        96.0, 0.5,
    )
    theirs = jax_shims.apply_bounds_shim(
        jax_shims.apply_patch_shim({k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in batch.items()}, 16),
        96.0, 0.5,
    )
    for views in ("context", "target"):
        for key in ("image", "intrinsics", "near", "far"):
            np.testing.assert_allclose(ours[views][key].numpy(), np.asarray(theirs[views][key]), rtol=1e-6)
    assert ours["context"]["image"].shape[-3:-1] == (32, 32)


def test_project_rays():
    # Every branch of the segment clipping: rays starting in front of,
    # behind and beside the other camera, with and without near/far.
    rng = np.random.default_rng(6)
    origins = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    directions = unit(rng, (400,))
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [0.3, -0.1, -0.5]
    intr = np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32)
    for near, far in ((None, None), (np.float32(0.5), np.float32(5.0))):
        kw_t = {} if near is None else {"near": torch.tensor(near), "far": torch.tensor(far)}
        kw_j = {} if near is None else {"near": jnp.asarray(near), "far": jnp.asarray(far)}
        ours = project_rays(torch.from_numpy(origins), torch.from_numpy(directions),
                            torch.from_numpy(ext), torch.from_numpy(intr), **kw_t)
        theirs = jax_project_rays(jnp.asarray(origins), jnp.asarray(directions),
                                  jnp.asarray(ext), jnp.asarray(intr), **kw_j)
        valid = np.asarray(theirs["overlaps_image"])
        np.testing.assert_array_equal(ours["overlaps_image"].numpy(), valid)
        assert 0 < valid.sum() < valid.size
        for key in ("xy_min", "xy_max"):
            np.testing.assert_allclose(ours[key].numpy()[valid], np.asarray(theirs[key])[valid], atol=1e-5)
