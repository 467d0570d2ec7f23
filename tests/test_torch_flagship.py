"""The port's `entry()` (latentsplat_tpu_torch.entry) against
`__graft_entry__.entry()` on the CPU.

The model is the re10k preset at full width (DINO ViT-B/8, d_feature 128,
2 + 2 epipolar layers, the 512-wide f8 VAE with skips; 184,619,843
generator parameters) at 64x64, one scene of 2 context and 2 target views,
as both `entry()`s build it (the port's example batch equals the JAX
one). The parameters start from `model.init_params(PRNGKey(0), batch)`,
as `entry()` does; every leaf is then redrawn from a numpy generator
(tests/test_torch_slice.py's `random_leaves`), so that no zero-initialised
skip conv hides a mismatch, and crosses over with `params_from_jax` into
the model of the port's `entry()`.

`entry()`'s forward draws three times: the depth uniforms, the Gaussian
feature normals and the latent normals. The same numpy draws go to both
packages (patched jax.random.uniform / normal on the JAX side, `noise` on
the port's), each depth uniform moved to the middle of its bucket's CDF
interval under the port's depth pdf: the epipolar triangulation turns
1-ulp differences into bucket flips otherwise.

The port's `entry()` forward runs (no data shims, as in entry(); the
tiled rasterizer's plain versions on the CPU; its Gaussians and render
read by a hook on the encoder and a wrapper around the decoder), with the
sample depths that the JAX side's epipolar transformer triangulates
replayed into it: near-parallel rays turn 1-ulp differences into ~1e-2
relative depth differences (without the replay the image differs from the
dense one by up to 5.7e-4, with it by 3.8e-5). It is held against (a) the
same model with `model.decoder.backend=dense`, layer by layer, and (b)
`entry()`'s own forward (given the same depths), the tiled exact path
with its Pallas kernels in interpret mode, which sends the channels
through the sort as bfloat16 (`latentsplat_tpu/ops/rasterize/tiled.py:840`,
`:864-867`).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
import latentsplat_tpu.model.encoder.epipolar_transformer as j_epipolar
import latentsplat_tpu_torch.model.encoder.epipolar_transformer as t_epipolar
from latentsplat_tpu_torch.entry import entry
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_torch_slice import OUTPUT_ATOL, random_leaves
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SIZE = 64
OVERRIDE = f"dataset.image_shape=[{SIZE},{SIZE}]"
N_PARAMS = 184_619_843


def torch_batch(batch):
    return {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in batch.items()}


def untied_depth_noise(model, context, uniform):
    """Each uniform sample moved to the middle of its bucket's CDF interval
    under the port's depth pdf (tests/test_torch_slice.py)."""
    captured = {}
    hook = model.encoder.depth_predictor.register_forward_pre_hook(
        lambda module, args: captured.update(features=args[0]))
    with torch.no_grad():
        model.encoder(context, 0, deterministic=True)
        hook.remove()
        head = model.encoder.depth_predictor
        y = head.projection(torch.relu(captured["features"]))
        y = y.reshape(*y.shape[:-1], head.num_samples, head.num_surfaces, 2)
        pdf = y[..., 0].movedim(-2, -1).softmax(dim=-1).double().numpy()
    cdf = np.cumsum(pdf / pdf.sum(-1, keepdims=True), axis=-1)
    lower = np.concatenate([np.zeros_like(cdf[..., :1]), cdf[..., :-1]], axis=-1)
    bucket = np.minimum((cdf[..., None, :] <= uniform[..., :, None]).sum(-1), cdf.shape[-1] - 1)
    return (0.5 * (np.take_along_axis(lower, bucket, -1) + np.take_along_axis(cdf, bucket, -1))).astype(np.float32)


def patched_draws(noise):
    """jax.random.uniform and .normal that return `noise`'s arrays in the
    order entry()'s forward draws them."""
    queue = {"uniform": [noise["depth"]], "normal": [noise["gaussians"], noise["latent"]]}

    def fake(kind):
        def draw(key, shape=(), dtype=jnp.float32, *args, **kwargs):
            value = queue[kind].pop(0)
            assert value.shape == tuple(shape), (kind, value.shape, shape)
            return jnp.asarray(value, dtype)
        return draw

    return queue, fake("uniform"), fake("normal")


def dense_forward(model, cfg):
    """entry()'s forward on `model`, returning its intermediate outputs and
    the sample depths its epipolar transformer triangulates."""

    def forward(gen_params, batch, rng):
        depths = []
        get_depth = j_epipolar.get_depth

        def record(*args):
            depths.append(get_depth(*args))
            return depths[-1]

        k_enc, k_gauss, k_latent = jax.random.split(rng, 3)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_epipolar, "get_depth", record)
            gaussians = model.apply_encoder(gen_params, batch["context"], 0, k_enc, deterministic=False)
        target = batch["target"]
        size = model.scaled_size(model.scale_factor, target["image"].shape[-3:-1])
        rendered = model.decoder(
            gaussians.sample(k_gauss), target["extrinsics"], target["intrinsics"], target["near"], target["far"], size,
        )
        latent = rendered.feature_posterior.sample(k_latent)
        z = model.rescale(latent, Fraction(1, cfg.model.supersampling_factor))
        skip_z = jnp.concatenate([jax.lax.stop_gradient(rendered.color), latent], axis=-1)
        return {
            "means": gaussians.means, "covariances": gaussians.covariances, "opacities": gaussians.opacities,
            "color_harmonics": gaussians.color_harmonics, "feature_mean": gaussians.feature_harmonics.mean,
            "render": rendered.color, "depth": rendered.depth,
            "image": model.ae_decode(gen_params, z, skip_z), "sample_depths": depths[0],
        }

    return forward


@torch.no_grad()
def port_forward(forward, batch, noise):
    """dense_forward's counterpart in the port: the port's entry() forward
    with the draws taken from `noise`, its Gaussians and render read on the
    way."""
    model, seen = forward.model, {}
    decoder = model.decoder

    def render(*args):
        seen["rendered"] = decoder(*args)
        return seen["rendered"]

    hook = model.encoder.register_forward_hook(lambda module, args, out: seen.update(gaussians=out))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(model, "decoder", render)
            image = forward(batch, noise=noise)
    finally:
        hook.remove()
    gaussians, rendered = seen["gaussians"], seen["rendered"]
    return {
        "means": gaussians.means, "covariances": gaussians.covariances, "opacities": gaussians.opacities,
        "color_harmonics": gaussians.color_harmonics, "feature_mean": gaussians.feature_harmonics.mean,
        "render": rendered.color, "depth": rendered.depth, "image": image,
    }


@pytest.fixture(scope="module")
def flagship():
    fn, (params, batch, rng_key) = graft.entry()
    params = random_leaves(params, np.random.default_rng(2024))
    port_entry, (tbatch, _) = entry(device="cpu")
    model = port_entry.model
    state = params_from_jax(params, model)
    model.load_state_dict(state, strict=True)
    n_mapped = len(state)
    del state

    for side, views in torch_batch(batch).items():   # the port's example batch is entry()'s
        assert views.keys() == tbatch[side].keys()
        assert all(torch.equal(views[k], tbatch[side][k]) for k in views), side
    context = tbatch["context"]
    rng = np.random.default_rng(7)
    ae = model.autoencoder
    d_sh = (model.cfg.encoder.gaussian_adapter.feature_sh_degree + 1) ** 2
    depth_shape = model.depth_noise_shape(context)
    b, v, r, _, gpp = depth_shape
    render_size = model.scaled_size(model.scale_factor, (SIZE, SIZE))
    noise = {
        "depth": untied_depth_noise(model, context, rng.uniform(0, 1, depth_shape)),
        "gaussians": rng.standard_normal((b, v * r * gpp, ae.d_latent, d_sh)).astype(np.float32),
        "latent": rng.standard_normal((b, 2, *render_size, ae.d_latent)).astype(np.float32),
    }

    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    outputs = {}
    jcfg, jmodel = graft._flagship_model([OVERRIDE, "model.decoder.backend=dense"])
    for name, forward in (("dense", dense_forward(jmodel, jcfg)), ("entry", fn)):
        queue, uniform, normal = patched_draws(noise)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", uniform)
            mp.setattr(jax.random, "normal", normal)
            if name == "entry":   # the dense run's triangulation, replayed
                mp.setattr(j_epipolar, "get_depth", lambda *args: jnp.asarray(depths))
            outputs[name] = jax.tree_util.tree_map(np.asarray, jax.jit(forward)(params, jbatch, rng_key))
        assert queue == {"uniform": [], "normal": []}
        depths = outputs["dense"]["sample_depths"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_epipolar, "get_depth", lambda *args: torch.from_numpy(depths))
        port = port_forward(port_entry, tbatch, {k: torch.from_numpy(a) for k, a in noise.items()})
    return {"model": model, "n_leaves": len(jax.tree_util.tree_leaves(params)), "n_mapped": n_mapped,
            "port": {k: v.numpy() for k, v in port.items()}, **outputs}


def test_flagship_is_the_full_width_model(flagship):
    # The full re10k width, every parameter from one flax leaf.
    model = flagship["model"]
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS
    assert flagship["n_leaves"] == flagship["n_mapped"] == len(model.state_dict())
    assert model.encoder.backbone.dino.cls_token.shape[-1] == 768
    assert hasattr(model.encoder.backbone.dino, "block_11") and not hasattr(model.encoder.backbone.dino, "block_12")
    assert model.cfg.encoder.d_feature == 128 and model.cfg.encoder.epipolar_transformer.num_layers == 2
    assert max(model.cfg.autoencoder.block_out_channels) == 512
    assert model.autoencoder.decoder.skip_conv_0.weight.abs().sum() > 0


def test_flagship_gaussians_match_dense(flagship):
    # With the JAX side's triangulated depths replayed, every Gaussian
    # tensor agrees to float32 rounding through 12 ViT-B blocks and the
    # epipolar transformer: all within 1e-4 of each tensor's scale (the
    # slice tests' geometry tolerance, here held for the harmonics too).
    # Measured, of the scale: means 1.4e-6, covariances 9.6e-7, opacities
    # 8.4e-8, color harmonics 2.5e-6, feature means 1.3e-6.
    port, dense = flagship["port"], flagship["dense"]
    for key in ("means", "covariances", "opacities", "color_harmonics", "feature_mean"):
        scale = max(1.0, float(np.abs(dense[key]).max()))
        np.testing.assert_allclose(port[key], dense[key], atol=1e-4 * scale, rtol=0, err_msg=key)


def test_flagship_render_matches_dense(flagship):
    # The splatted color and depth, tiled (the port's plain kernel versions)
    # against the JAX dense backend, every element at the slice tests'
    # tolerances (OUTPUT_ATOL). Measured: render 2.6e-5, depth 2.9e-6.
    port, dense = flagship["port"], flagship["dense"]
    for key in ("render", "depth"):
        np.testing.assert_allclose(port[key], dense[key], atol=OUTPUT_ATOL[key], rtol=0, err_msg=key)


def test_flagship_image_matches_dense(flagship):
    # (a) The final RGB (1, 2, 64, 64, 3) against the same model with the
    # dense backend: every element within 1e-4, tighter than the slice
    # tests' 5e-4. Measured: 3.8e-5.
    image, dense = flagship["port"]["image"], flagship["dense"]["image"]
    assert image.shape == dense.shape == (1, 2, SIZE, SIZE, 3)
    np.testing.assert_allclose(image, dense, atol=1e-4, rtol=0)


def test_flagship_image_matches_entry(flagship):
    # (b) The final RGB against entry()'s own forward, the tiled exact path,
    # which rounds each composited channel to bfloat16 in the sort's
    # payload (a relative error of up to 2^-9) before the VAE decodes the
    # render's color and the 4 latent channels. Tolerance 2e-3 (2^-9 of a
    # unit value); measured 3.0e-4, and 3.0e-4 between the JAX dense image
    # and entry()'s, while the port is within 3.8e-5 of the dense one.
    image, entry = flagship["port"]["image"], flagship["entry"]
    assert entry.shape == (1, 2, SIZE, SIZE, 3)
    np.testing.assert_allclose(image, entry, atol=2e-3, rtol=0)
