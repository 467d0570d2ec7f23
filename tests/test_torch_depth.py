"""`render_depth`, the `render` options it needs (`use_sh`,
`scale_invariant`) and `DecoderSplatting(depth_mode=...)` of the port
against the JAX package's, on a small scene. The JAX side renders with its
dense backend; the port with its dense oracle and with the tiled path (the
plain versions of the kernels on the CPU). Tolerances are those of
tests/test_rasterize.py's tiled-vs-dense test, relative to the largest
value: render 2e-4, depth 2e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.model.decoder.splatting import DecoderSplatting as JaxDecoderSplatting
from latentsplat_tpu.model.decoder.splatting import DecoderSplattingCfg as JaxDecoderSplattingCfg
from latentsplat_tpu.model.types import Gaussians as JaxGaussians
from latentsplat_tpu.ops.rasterize.api import render as jax_render
from latentsplat_tpu.ops.rasterize.api import render_depth as jax_render_depth
from latentsplat_tpu_torch.model.decoder.splatting import DecoderSplatting, DecoderSplattingCfg
from latentsplat_tpu_torch.model.types import Gaussians
from latentsplat_tpu_torch.ops.rasterize.api import render, render_depth

from tests.test_torch_rasterize import make_scene
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

MODES = ["depth", "disparity", "relative_disparity", "log"]
SIZE = 32
RENDER_RTOL = 2e-4
DEPTH_RTOL = 2e-3


def cameras(b=1, v=3):
    """Cameras near the origin looking down +z at make_scene's Gaussians,
    with per-view near and far planes."""
    rng = np.random.default_rng(7)
    ext = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    ext[..., :3, 3] = rng.uniform(-0.3, 0.3, (b, v, 3))
    ext[..., 2, 3] -= 0.5
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32), (b, v, 1, 1))
    near = rng.uniform(0.5, 1.5, (b, v)).astype(np.float32)
    far = rng.uniform(50.0, 100.0, (b, v)).astype(np.float32)
    return ext, intr, near, far


def scene(seed, b=1, n=150, n_feature=4):
    """Means, covariances, opacities, color SH (degree 1) and feature SH
    (degree 0) of `b` scenes."""
    parts = [make_scene(seed + i, n) for i in range(b)]
    means, covs, ops = (np.stack([p[k] for p in parts]) for k in range(3))
    rng = np.random.default_rng(seed)
    color_sh = rng.normal(0.0, 0.3, (b, n, 3, 4)).astype(np.float32)
    feature_sh = rng.normal(0.0, 0.5, (b, n, n_feature, 1)).astype(np.float32)
    return means, covs, ops, color_sh, feature_sh


def assert_close_relative(ours, theirs, rtol):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    scale = np.abs(theirs).max()
    assert scale > 0
    err = np.abs(ours - theirs).max() / scale
    assert err <= rtol, f"max error {err:.3e} of the largest value {scale:.3e}"


def to_torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def to_jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("backend", ["dense", "tiled"])
@pytest.mark.parametrize("mode", MODES)
def test_render_depth_matches_jax(mode, backend):
    cams = cameras(b=2, v=2)
    means, covs, ops, _, _ = scene(1, b=2)
    ours = render_depth(*to_torch(cams), (SIZE, SIZE), *to_torch((means, covs, ops)), mode=mode, backend=backend)
    theirs = jax_render_depth(*to_jax(cams), (SIZE, SIZE), *to_jax((means, covs, ops)), mode=mode, backend="dense")
    assert ours.shape == (2, 2, SIZE, SIZE)
    assert np.isfinite(ours.numpy()).all()
    assert_close_relative(ours.numpy(), theirs, RENDER_RTOL if backend == "dense" else DEPTH_RTOL)


@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("use_sh", [True, False])
def test_render_options_match_jax(use_sh, scale_invariant):
    cams = cameras()
    means, covs, ops, color_sh, feature_sh = scene(2)
    if not use_sh:
        color_sh = color_sh[..., :1]
    bg = np.array([[0.2, 0.4, 0.6]], np.float32)
    kwargs = dict(scale_invariant=scale_invariant, use_sh=use_sh)
    ours = render(*to_torch(cams), (SIZE, SIZE), torch.from_numpy(bg),
                  *to_torch((means, covs, ops, color_sh, feature_sh)), **kwargs)
    theirs = jax_render(*to_jax(cams), (SIZE, SIZE), jnp.asarray(bg),
                        *to_jax((means, covs, ops, color_sh, feature_sh)), backend="dense", **kwargs)
    for name, rtol in (("color", RENDER_RTOL), ("feature", RENDER_RTOL), ("mask", RENDER_RTOL),
                       ("depth", DEPTH_RTOL)):
        assert_close_relative(getattr(ours, name).numpy(), getattr(theirs, name), rtol)


@pytest.mark.parametrize("depth_mode", [None] + MODES)
def test_decoder_depth_modes_match_jax(depth_mode):
    cams = cameras()
    arrays = scene(3)
    ours = DecoderSplatting(DecoderSplattingCfg(backend="tiled"), (0.1, 0.2, 0.3))(
        Gaussians(*to_torch(arrays)), *to_torch(cams), (SIZE, SIZE), depth_mode=depth_mode,
    )
    theirs = JaxDecoderSplatting(JaxDecoderSplattingCfg(backend="dense"), (0.1, 0.2, 0.3))(
        JaxGaussians(*to_jax(arrays)), *to_jax(cams), (SIZE, SIZE), depth_mode=depth_mode,
    )
    assert_close_relative(ours.color.numpy(), theirs.color, RENDER_RTOL)
    assert_close_relative(ours.feature_posterior.mean.numpy(), theirs.feature_posterior.mean, RENDER_RTOL)
    assert_close_relative(ours.mask.numpy(), theirs.mask, RENDER_RTOL)
    assert_close_relative(ours.depth.numpy(), theirs.depth, DEPTH_RTOL)


@pytest.mark.parametrize("return_colors, return_features", [(True, False), (False, True)])
def test_decoder_returns_what_is_asked(return_colors, return_features):
    cams = cameras(v=1)
    arrays = scene(4)
    ours = DecoderSplatting(DecoderSplattingCfg())(
        Gaussians(*to_torch(arrays)), *to_torch(cams), (SIZE, SIZE),
        return_colors=return_colors, return_features=return_features,
    )
    theirs = JaxDecoderSplatting(JaxDecoderSplattingCfg(backend="dense"))(
        JaxGaussians(*to_jax(arrays)), *to_jax(cams), (SIZE, SIZE),
        return_colors=return_colors, return_features=return_features,
    )
    assert (ours.color is None) == (theirs.color is None) == (not return_colors)
    assert (ours.feature_posterior is None) == (theirs.feature_posterior is None) == (not return_features)
    assert_close_relative(ours.mask.numpy(), theirs.mask, RENDER_RTOL)


def test_depth_times_disparity_bounds_the_mask():
    # sum(w z) * sum(w / z) >= (sum w)^2 (Cauchy-Schwarz), with the weights
    # w of the same composite whose sum is the mask.
    cams = cameras(v=2)
    means, covs, ops, color_sh, feature_sh = scene(5)
    args = (*to_torch(cams), (SIZE, SIZE), *to_torch((means, covs, ops)))
    depth = render_depth(*args, mode="depth")
    disparity = render_depth(*args, mode="disparity")
    mask = render(*to_torch(cams), (SIZE, SIZE), torch.zeros(1, 3),
                  *to_torch((means, covs, ops, color_sh, feature_sh))).mask
    assert (mask > 0.5).any()
    assert (depth * disparity >= mask**2 * (1 - 1e-4)).all()
