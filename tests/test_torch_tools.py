"""The port's remaining modules against the JAX package's: the profiler
(the trace of tests/test_tools.py), `misc/fraction_utils.py`, the
autoencoder interface (`model/autoencoder/base.py`) and the alternative
depth heads (`model/encoder/alt_depth.py`) with the same weights and
noise. Also the kernel launch helper (`cuda_build.launch`) on a stub
library, and the group norm's imports."""

import collections
import json
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latentsplat_tpu.misc import fraction_utils as j_fraction_utils
from latentsplat_tpu.model.autoencoder.base import Autoencoder as JAutoencoder
from latentsplat_tpu.model.encoder.alt_depth import AttentionDistribution as JAttentionDistribution
from latentsplat_tpu.model.encoder.alt_depth import DistributionDepthPredictor as JDistributionDepthPredictor
from latentsplat_tpu_torch import cuda_build
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


class StubLibrary:
    """A kernel library whose every entry point records its arguments and
    returns `rc`."""

    def __init__(self, rc: int):
        self.rc, self.calls = rc, []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or self.rc


@pytest.fixture
def stub_launches(monkeypatch):
    """A fresh launch counter and a stub library that returns 0."""
    library = StubLibrary(0)
    monkeypatch.setattr(cuda_build, "load_library", lambda: library)
    monkeypatch.setattr(cuda_build, "launches", collections.Counter())
    return library


def test_launch_counts_one_launch_under_its_key(stub_launches):
    cuda_build.launch("composite_forward_fast", 8, 1, 2, kernel="composite_forward", variant="coef", channels=8)
    cuda_build.launch("duplicate_with_keys64", 5, kernel="duplicate_with_keys")
    assert stub_launches.calls == [("composite_forward_fast", (8, 1, 2)), ("duplicate_with_keys64", (5,))]
    assert cuda_build.launches == {("composite_forward", "coef", 8): 1, ("duplicate_with_keys", "exact", 0): 1}


def test_launch_raises_on_a_cuda_error_and_counts_nothing(stub_launches):
    stub_launches.rc = 719
    with pytest.raises(RuntimeError, match=r"^composite_backward \(fast\): CUDA error 719 at launch$"):
        cuda_build.launch("composite_backward_fast", 8, kernel="composite_backward", variant="fast", channels=8)
    with pytest.raises(RuntimeError, match=r"^shade_project: CUDA error 719 at launch$"):
        cuda_build.launch("shade_project", kernel="shade_project")
    assert not cuda_build.launches and cuda_build.launched("composite_backward") == 0


def test_launched_sums_over_variant_and_channels(stub_launches):
    for variant, channels, n in (("exact", 8, 3), ("fast", 8, 2), ("exact", 12, 1), ("coef", 5, 4)):
        for _ in range(n):
            cuda_build.launch("composite_forward", kernel="composite_forward", variant=variant, channels=channels)
    cuda_build.launch("reduce_pairs", kernel="reduce_pairs", channels=8)
    assert cuda_build.launched("composite_forward") == 10
    assert cuda_build.launched("composite_forward", variant="exact") == 4
    assert cuda_build.launched("composite_forward", channels=8) == 5
    assert cuda_build.launched("composite_forward", "fast", 8) == 2
    assert cuda_build.launched("composite_forward", "fast", 12) == 0
    assert cuda_build.launched("reduce_pairs") == cuda_build.launched("reduce_pairs", "exact", 8) == 1
    assert cuda_build.launched("tile_cull") == 0
    assert {k for k, _, _ in cuda_build.launches} <= set(cuda_build.KERNELS)
    # A copy of the counter is read the same way, and later launches leave it.
    copy = collections.Counter(cuda_build.launches)
    cuda_build.launch("composite_forward", kernel="composite_forward", variant="fast", channels=8)
    assert cuda_build.launched("composite_forward", "fast", 8, copy) == 2
    assert cuda_build.launched("composite_forward", "fast", 8) == 3


def test_group_norm_imports_no_rasterizer():
    # The VAE's norm launches and counts through cuda_build alone.
    code = (
        "import sys\n"
        "import latentsplat_tpu_torch.ops.group_norm\n"
        "loaded = sorted(m for m in sys.modules if m.startswith('latentsplat_tpu_torch.ops.rasterize'))\n"
        "assert not loaded, loaded\n"
    )
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
