"""The port's serving path, `render_full`, against the JAX package's
`Trainer._render_full` on the re10k structure at small width.

Every parameter leaf, zero-initialized ones included, is drawn from a numpy
generator and mapped with `params_from_jax`. The JAX side runs with the
dense rasterizer backend, the port with its tiled one (plain kernel
versions on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latentsplat_tpu.config import load_config as jax_load_config
from latentsplat_tpu.model.latentsplat import LatentSplat as JaxLatentSplat
from latentsplat_tpu.training.trainer import Trainer
from latentsplat_tpu_torch.config import load_config
from latentsplat_tpu_torch.model.latentsplat import LatentSplat, render_full
from latentsplat_tpu_torch.weights import params_from_jax
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SMALL = [
    "model.encoder.backbone.model=dino_vits8",
    "model.encoder.d_feature=32",
    "model.encoder.epipolar_transformer.num_layers=1",
    "model.encoder.epipolar_transformer.self_attention.num_layers=1",
    "model.autoencoder.block_out_channels=[16,16,16,16]",
    "model.discriminator=null",
]
SIZE = 32
N_CONTEXT, N_TARGET = 2, 2


def make_views(rng, n):
    ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = rng.uniform(-0.15, 0.15)
        ext[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        ext[i, :3, 3] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1)]
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (n, 1, 1))
    return {
        "image": rng.uniform(0, 1, (1, n, SIZE, SIZE, 3)).astype(np.float32),
        "extrinsics": ext[None], "intrinsics": intr[None],
        "near": np.ones((1, n), np.float32), "far": np.full((1, n), 100.0, np.float32),
    }


def random_leaves(params, rng):
    """Replace every leaf: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1^2),
    everything else (biases, cls_token, pos_embed, zero-init skip convs) ~ N(0, 0.1^2)."""

    def leaf(path, x):
        keys = [p.key for p in path]
        shape = np.shape(x)
        if keys[-1] == "kernel":
            fan_in = shape[0] * shape[1] if keys[-2] == "out" else int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if keys[-1] == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1234)
    batch = {"context": make_views(rng, N_CONTEXT), "target": make_views(rng, N_TARGET)}
    jax_cfg = jax_load_config("re10k", SMALL + ["model.decoder.backend=dense"])
    jax_model = JaxLatentSplat(jax_cfg.model, (0.0, 0.0, 0.0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), jbatch)["generator"])
    params = random_leaves(shapes, rng)

    model = LatentSplat(load_config("re10k", SMALL).model).eval()
    state = params_from_jax(params, model)
    model.load_state_dict(state, strict=True)

    trainer = object.__new__(Trainer)      # only what _render_full reads
    trainer.model = jax_model
    enc = jax_cfg.model.encoder
    trainer._patch_multiple = enc.epipolar_transformer.self_attention.patch_size * enc.epipolar_transformer.downscale
    trainer._apply_bounds = enc.apply_bounds_shim
    trainer._near_disparity = enc.near_disparity
    return {"batch": batch, "params": params, "model": model, "state": state, "trainer": trainer, "rng": rng}


def assert_close_on_most(ours, theirs, atol, bound, fraction):
    """All but `fraction` of the elements within `atol`, every element within `bound`.

    Some elements of this model amplify float32 rounding far beyond it: the
    epipolar transformer encodes each sample's triangulated depth with
    sin(2 pi 2^9 disparity), and triangulating near-parallel rays turns
    1-ulp differences in ray directions into ~1e-3 relative depth error at
    a few samples (test_triangulated_depths_match_jax), which the 512-cycle
    encoding turns into ~1e-2 changes of those pixels' features. With the
    JAX depths fed in, the transformer agrees to 1e-5
    (test_epipolar_transformer_matches_jax_given_depths).
    """
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    err = np.abs(ours - theirs)
    assert (err > atol).mean() <= fraction, ((err > atol).mean(), err.max())
    assert err.max() <= bound, err.max()


# render_full outputs: float32 rounding through the encoder, the rasterizer
# (tiled vs dense within 2e-4, tests/test_torch_rasterize.py) and the VAE.
OUTPUT_ATOL = {"render": 1e-4, "depth": 2e-3, "image": 5e-4}


def torch_batch(batch):
    return {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in batch.items()}


def test_params_from_jax_maps_every_leaf(setup):
    # Every port parameter comes from exactly one flax leaf, moved but not
    # changed: same element count and the same sum of values.
    model, params, state = setup["model"], setup["params"], setup["state"]
    assert set(state) == set(model.state_dict())
    flat = {
        ".".join(p.key for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(params)
    }
    assert len(flat) == len(state)
    sums = sorted(round(float(v.astype(np.float64).sum()), 3) for v in flat.values())
    ours = sorted(round(float(v.double().sum()), 3) for v in state.values())
    assert sums == ours
    # The zero-initialized leaves carry the random values.
    assert state["encoder.backbone.dino.cls_token"].abs().sum() > 0
    assert state["autoencoder.decoder.skip_conv_0.weight"].abs().sum() > 0


def test_encoder_matches_jax(setup):
    # Geometry (means, covariances, opacities): float32 reassociation through
    # 12 ViT blocks and the epipolar transformer, 1e-4 of each tensor's
    # scale. Harmonics come straight from the per-pixel features and carry
    # the depth-encoding sensitivity (see assert_close_on_most and
    # test_epipolar_transformer_matches_jax_given_depths): 95% within 1e-4
    # of the scale, all within 1e-2.
    jbatch = jax.tree_util.tree_map(jnp.asarray, setup["batch"])
    trainer, model = setup["trainer"], setup["model"]
    j = jax.jit(lambda p, c: trainer.model.apply_encoder(p, c, 0, None, deterministic=True))(
        setup["params"], trainer.data_shim(jbatch)["context"]
    )
    with torch.no_grad():
        t = model.encoder(model.data_shim(torch_batch(setup["batch"]))["context"], 0, deterministic=True)
    for ours, theirs in ((t.means, j.means), (t.covariances, j.covariances), (t.opacities, j.opacities)):
        scale = max(1.0, float(np.abs(np.asarray(theirs)).max()))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4 * scale)
    harmonics = (
        (t.color_harmonics, j.color_harmonics), (t.feature_harmonics.mean, j.feature_harmonics.mean),
        (t.feature_harmonics.logvar, j.feature_harmonics.logvar),
    )
    for ours, theirs in harmonics:
        scale = max(1.0, float(np.abs(np.asarray(theirs)).max()))
        assert_close_on_most(ours, theirs, atol=1e-4 * scale, bound=1e-2 * scale, fraction=0.05)


def epipolar_inputs(setup):
    rng = np.random.default_rng(5)
    features = rng.standard_normal((1, N_CONTEXT, SIZE, SIZE, 32)).astype(np.float32)
    jctx = setup["trainer"].data_shim(jax.tree_util.tree_map(jnp.asarray, setup["batch"]))["context"]
    tctx = setup["model"].data_shim(torch_batch(setup["batch"]))["context"]
    return features, jctx, tctx


def test_epipolar_transformer_matches_jax_given_depths(setup, monkeypatch):
    # With the triangulated sample depths taken from the JAX side, the
    # epipolar transformer (sampling, depth encoding, cross attention, conv
    # feed-forward with image self-attention, conv-transpose up-scaling)
    # agrees to float32 rounding: 1e-5 of the output scale.
    import latentsplat_tpu.model.encoder.epipolar_transformer as jax_et
    import latentsplat_tpu_torch.model.encoder.epipolar_transformer as port_et

    features, jctx, tctx = epipolar_inputs(setup)
    cfg = setup["trainer"].model.cfg.encoder
    captured = {}
    jax_get_depth = jax_et.get_depth

    def capture(*args):
        captured["depth"] = jax_get_depth(*args)
        return captured["depth"]

    monkeypatch.setattr(jax_et, "get_depth", capture)
    module = jax_et.EpipolarTransformer(cfg.epipolar_transformer, cfg.d_feature)

    @jax.jit
    def run(params, features, extrinsics, intrinsics, near, far):
        out, _ = module.apply({"params": params}, features, extrinsics, intrinsics, near, far)
        return out, captured["depth"]

    theirs, depth = run(
        setup["params"]["encoder"]["epipolar_transformer"], jnp.asarray(features),
        jctx["extrinsics"], jctx["intrinsics"], jctx["near"], jctx["far"],
    )
    depth = torch.from_numpy(np.array(depth))
    monkeypatch.setattr(port_et, "get_depth", lambda *args: depth)
    with torch.no_grad():
        ours, _ = setup["model"].encoder.epipolar_transformer(
            torch.from_numpy(features), tctx["extrinsics"], tctx["intrinsics"], tctx["near"], tctx["far"]
        )
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5 * np.abs(theirs).max())


def test_triangulated_depths_match_jax(setup):
    # Least-squares intersection of near-parallel rays is ill-conditioned:
    # 1-ulp differences in the ray directions move far depths by up to
    # ~1e-3 relative. Everything else agrees to float32 rounding.
    from latentsplat_tpu.geometry import get_depth as jax_get_depth
    from latentsplat_tpu.model.encoder.epipolar_sampler import sample_epipolar_features as jax_sample
    from latentsplat_tpu_torch.geometry import get_depth
    from latentsplat_tpu_torch.model.encoder.epipolar_sampler import sample_epipolar_features

    features, jctx, tctx = epipolar_inputs(setup)
    other = np.array([[1], [0]])
    args = [jctx[k] for k in ("extrinsics", "intrinsics", "near", "far")]
    js = jax.jit(lambda *a: jax_sample(*a, 32))(jnp.asarray(features), *args)
    ts = sample_epipolar_features(torch.from_numpy(features), *[tctx[k] for k in ("extrinsics", "intrinsics", "near", "far")], 32)
    # Sample positions agree to ~1e-6 of the image; times the gradient of
    # unit-variance features that moves a sample by up to ~1e-4.
    np.testing.assert_allclose(ts.features.numpy(), np.asarray(js.features), atol=1e-4)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_allclose(ts.xy_sample.numpy(), np.asarray(js.xy_sample), atol=1e-6)
    theirs = np.asarray(jax_get_depth(
        js.origins[:, :, None, :, None], js.directions[:, :, None, :, None], js.xy_sample,
        jctx["extrinsics"][:, other][:, :, :, None, None], jctx["intrinsics"][:, other][:, :, :, None, None],
    ))
    other_t = torch.from_numpy(other)
    ours = get_depth(
        ts.origins[:, :, None, :, None], ts.directions[:, :, None, :, None], ts.xy_sample,
        tctx["extrinsics"][:, other_t][:, :, :, None, None], tctx["intrinsics"][:, other_t][:, :, :, None, None],
    ).numpy()
    rel = np.abs(ours - theirs) / np.maximum(np.abs(theirs), 1e-6)
    assert np.median(rel) < 1e-6 and rel.max() < 5e-3, (np.median(rel), rel.max())


def test_render_full_deterministic(setup):
    # Same weights and inputs, no sampling. Tolerances: float32 rounding
    # through the encoder, the rasterizer (tiled vs dense, within 2e-4 by
    # the rasterizer tests) and the VAE decoder on 99% of the pixels; the
    # bounds of assert_close_on_most on the rest.
    out = render_full(setup["model"], torch_batch(setup["batch"]), deterministic=True)
    ref = Trainer._render_full(
        setup["trainer"], setup["params"], jax.tree_util.tree_map(jnp.asarray, setup["batch"]),
        jax.random.PRNGKey(0), True,
    )
    assert out["image"].shape == (1, N_TARGET, SIZE, SIZE, 3)
    for key, atol in OUTPUT_ATOL.items():
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=atol)


def untied_depth_noise(setup, uniform):
    """Move each uniform sample to the middle of its bucket's CDF interval
    under the port's depth pdf."""
    model = setup["model"]
    captured = {}
    hook = model.encoder.depth_predictor.register_forward_pre_hook(
        lambda module, args: captured.update(features=args[0])
    )
    with torch.no_grad():
        model.encoder(model.data_shim(torch_batch(setup["batch"]))["context"], 0, deterministic=True)
        hook.remove()
        head = model.encoder.depth_predictor
        y = head.projection(torch.relu(captured["features"]))
        y = y.reshape(*y.shape[:-1], head.num_samples, head.num_surfaces, 2)
        pdf = y[..., 0].movedim(-2, -1).softmax(dim=-1).double().numpy()   # (b, v, r, srf, dpt)
    cdf = np.cumsum(pdf / pdf.sum(-1, keepdims=True), axis=-1)
    lower = np.concatenate([np.zeros_like(cdf[..., :1]), cdf[..., :-1]], axis=-1)
    bucket = np.minimum((cdf[..., None, :] <= uniform[..., :, None]).sum(-1), cdf.shape[-1] - 1)
    middle = 0.5 * (np.take_along_axis(lower, bucket, -1) + np.take_along_axis(cdf, bucket, -1))
    return middle.astype(np.float32)


def test_render_full_injected_noise(setup, monkeypatch):
    """Probabilistic mode with the same numpy noise on both sides.

    The JAX path draws, in order, the depth samples (uniform), the
    Gaussian feature sample and the latent sample (normal); they are fed
    through patched jax.random.uniform / jax.random.normal.

    Depth buckets are drawn by inverse CDF, a step function of the uniform
    sample. Uniform samples within ~1e-4 of a bucket boundary pick
    different buckets on the two sides (the pdfs differ at float32
    rounding, see test_encoder_matches_jax), which moves a Gaussian by a
    whole bucket. So each uniform sample is moved to the middle of the
    CDF interval of the bucket it falls in; that keeps the draw and removes
    the ties.
    """
    rng = np.random.default_rng(99)
    r = SIZE * SIZE
    gpp = 3
    noise = {
        "depth": untied_depth_noise(setup, rng.uniform(0, 1, (1, N_CONTEXT, r, 1, gpp))),
        "gaussians": rng.standard_normal((1, N_CONTEXT * r * gpp, 4, 9)).astype(np.float32),
        "latent": rng.standard_normal((1, N_TARGET, SIZE, SIZE, 4)).astype(np.float32),
    }
    queue = {"uniform": [noise["depth"]], "normal": [noise["gaussians"], noise["latent"]]}

    def fake(kind):
        def draw(key, shape=(), dtype=jnp.float32, *args, **kwargs):
            value = queue[kind].pop(0)
            assert value.shape == tuple(shape)
            return jnp.asarray(value, dtype)
        return draw

    monkeypatch.setattr(jax.random, "uniform", fake("uniform"))
    monkeypatch.setattr(jax.random, "normal", fake("normal"))
    ref = Trainer._render_full(
        setup["trainer"], setup["params"], jax.tree_util.tree_map(jnp.asarray, setup["batch"]),
        jax.random.PRNGKey(0), False,
    )
    assert queue == {"uniform": [], "normal": []}
    out = render_full(
        setup["model"], torch_batch(setup["batch"]), deterministic=False,
        noise={k: torch.from_numpy(v) for k, v in noise.items()},
    )
    # Here a Gaussian's depth also follows its sampled bucket offset, which
    # carries the feature sensitivity of assert_close_on_most into the
    # Gaussian's position: measured, one pixel in 2048 moves by ~6% of the
    # depth range. So 99.5% of the elements to the deterministic tolerance,
    # all within 10% of each output's range.
    for key, atol in OUTPUT_ATOL.items():
        theirs = np.asarray(ref[key])
        assert_close_on_most(out[key], theirs, atol=atol, bound=0.1 * np.abs(theirs).max(), fraction=0.005)
