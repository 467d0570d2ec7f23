"""The port's remaining modules against the JAX package's: the profiler
(the trace of tests/test_tools.py), `misc/fraction_utils.py`, the
autoencoder interface (`model/autoencoder/base.py`) and the alternative
depth heads (`model/encoder/alt_depth.py`) with the same weights and
noise."""

import json
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latentsplat_tpu.misc import fraction_utils as j_fraction_utils
from latentsplat_tpu.model.autoencoder.base import Autoencoder as JAutoencoder
from latentsplat_tpu.model.encoder.alt_depth import AttentionDistribution as JAttentionDistribution
from latentsplat_tpu.model.encoder.alt_depth import DistributionDepthPredictor as JDistributionDepthPredictor
from latentsplat_tpu_torch.misc import fraction_utils
from latentsplat_tpu_torch.misc.profiler import annotate, device_memory_profile, trace
from latentsplat_tpu_torch.model.autoencoder.base import Autoencoder
from latentsplat_tpu_torch.model.autoencoder.identity import AutoencoderId, AutoencoderIdCfg
from latentsplat_tpu_torch.model.autoencoder.kl import AutoencoderKL, AutoencoderKLCfg
from latentsplat_tpu_torch.model.encoder.alt_depth import AttentionDistribution, DistributionDepthPredictor
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_torch_training import random_leaves
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def test_profiler_trace_holds_the_annotated_span(tmp_path):
    with trace(tmp_path / "trace") as prof:
        with annotate("tiny_matmul"):
            out = torch.ones((8, 8)) @ torch.ones((8, 8))
    assert float(out[0, 0]) == 8.0
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "tiny_matmul" for e in events)
    assert any(e.key == "tiny_matmul" for e in prof.key_averages())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the message given where there is no CUDA device")
def test_device_memory_profile_needs_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        device_memory_profile(tmp_path / "memory.pickle")


@pytest.mark.parametrize("value", [3, Fraction(8, 2), Fraction(1, 4) * 256, "12/3", 2.0])
def test_fraction_utils_match_jax(value):
    assert fraction_utils.to_fraction(value) == j_fraction_utils.to_fraction(value)
    fraction = fraction_utils.to_fraction(value)
    assert fraction_utils.get_integer(fraction) == j_fraction_utils.get_integer(fraction)
    with pytest.raises(ValueError, match="is not an integer"):
        fraction_utils.get_integer(fraction + Fraction(1, 3))


def test_autoencoder_interface_matches_jax():
    names = ("downscale_factor", "d_latent", "expects_skip", "expects_skip_extra")
    assert all(isinstance(getattr(JAutoencoder, n), property) for n in names)
    assert all(isinstance(getattr(Autoencoder, n), property) for n in names)
    base = Autoencoder()
    for name in names:
        with pytest.raises(NotImplementedError):
            getattr(base, name)
    assert base.last_layer() is None

    kl = AutoencoderKL(AutoencoderKLCfg(block_out_channels=[8, 16], layers_per_block=1, latent_channels=2))
    ident = AutoencoderId(AutoencoderIdCfg())
    assert isinstance(kl, Autoencoder) and isinstance(ident, Autoencoder)
    assert (kl.downscale_factor, kl.d_latent, kl.expects_skip) == (2, 2, kl.cfg.skip_connections)
    assert (ident.downscale_factor, ident.d_latent, ident.expects_skip, ident.expects_skip_extra) == (1, 3, False, False)
    # The adaptive GAN weight's anchor: the JAX package's ("decoder", "conv_out", "kernel").
    assert kl.last_layer() is kl.decoder.conv_out.weight and ident.last_layer() is None


def alt_depth_inputs(seed, b=2, q=5, k=7, d_q=6, d_k=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, q, d_q)).astype(np.float32), rng.standard_normal((b, k, d_k)).astype(np.float32),
            rng.uniform(1.0, 10.0, (b, q, k)).astype(np.float32))


def test_attention_distribution_matches_jax():
    queries, keys, _ = alt_depth_inputs(0)
    jmodel = JAttentionDistribution(dim_inner=8)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(queries), jnp.asarray(keys)))
    params = random_leaves(shapes["params"], np.random.default_rng(1))
    model = AttentionDistribution(6, 4, dim_inner=8)
    model.load_state_dict(params_from_jax(params, model), strict=True)
    force = np.array([True, False])
    for force_last in (None, force):
        theirs = jmodel.apply({"params": params}, jnp.asarray(queries), jnp.asarray(keys),
                              None if force_last is None else jnp.asarray(force_last))
        ours = model(torch.from_numpy(queries), torch.from_numpy(keys),
                     None if force_last is None else torch.from_numpy(force_last))
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("deterministic", [True, False])
def test_distribution_depth_predictor_matches_jax(deterministic):
    queries, keys, depths = alt_depth_inputs(2)
    jmodel = JDistributionDepthPredictor(dim_inner=8)
    args = (jnp.asarray(queries), jnp.asarray(keys), jnp.asarray(depths))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args, deterministic=True))
    params = random_leaves(shapes["params"], np.random.default_rng(3))
    model = DistributionDepthPredictor(6, 4, dim_inner=8)
    model.load_state_dict(params_from_jax(params, model), strict=True)
    key = jax.random.PRNGKey(4)
    j_depth, j_density = jmodel.apply({"params": params}, *args, deterministic=deterministic,
                                      rng=None if deterministic else key)
    # The JAX sampler's uniforms, drawn from the same key, passed to the port.
    noise = None if deterministic else torch.from_numpy(np.array(jax.random.uniform(key, (2 * 5, 1))))
    depth, density = model(*map(torch.from_numpy, (queries, keys, depths)), deterministic=deterministic, noise=noise)
    np.testing.assert_array_equal(depth.detach().numpy(), np.asarray(j_depth))
    np.testing.assert_allclose(density.detach().numpy(), np.asarray(j_density), rtol=1e-5, atol=1e-7)
    if not deterministic:
        generator = torch.Generator().manual_seed(0)
        depth, _ = model(*map(torch.from_numpy, (queries, keys, depths)), generator=generator)
        assert depth.shape == (2, 5) and torch.isin(depth, torch.from_numpy(depths)).all()
