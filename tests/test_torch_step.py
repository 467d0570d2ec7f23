"""One whole VAE-GAN train step of the port against the JAX package's, at
step 125000 where every branch of the re10k losses is live.

The model is the tiny one of tests/test_train_step_quick.py::_full_cfgs
(ResNet backbone, dense rasterizer, PatchGAN, VAE with skip connections),
in two cases: the loss groups of re10k.yaml (MSE + LPIPS on the render;
L1 + LPIPS + generator + hinge on the combined image) and _full_cfgs' own
groups (whose gaussian site adds kl and sh_l2). Every parameter leaf comes
from a numpy generator and crosses over with params_from_jax; the same
numpy noise goes to both sides, through patched jax.random.uniform and
jax.random.normal, and the port's epipolar transformer takes the sample
depths that the JAX side triangulated (a least-squares intersection of
near-parallel rays turns 1-ulp differences into ~1e-2 relative depth
differences, see tests/test_torch_slice.py; no parameter's gradient flows
through those depths). The JAX side runs eagerly (jax.disable_jit): its
gradients come from generator_forward under jax.vjp, its updated parameters
from make_train_step. Eager JAX still compiles each primitive once, about
six minutes for each case here, so the module is `slow`; the port-only
mechanics of the step are tier-1 tests in tests/test_torch_step_quick.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.config import DiscriminatorOptimizerCfg as JDiscOptCfg
from latentsplat_tpu.config import GeneratorOptimizerCfg as JGenOptCfg
from latentsplat_tpu.config import OptimizerCfg as JOptimizerCfg
from latentsplat_tpu.loss.losses import LossCfg, LossDiscriminatorCfg, LossGroupCfg, adaptive_gan_weight
from latentsplat_tpu.model.encoder import epipolar_transformer as j_epipolar
from latentsplat_tpu.model.latentsplat import LatentSplat as JLatentSplat
from latentsplat_tpu.training import step as jstep
from latentsplat_tpu_torch import config as tconfig
from latentsplat_tpu_torch.loss.losses import LossesCfg, LossGroup
from latentsplat_tpu_torch.loss.lpips import LPIPS
from latentsplat_tpu_torch.model.discriminator.patch_gan import DiscriminatorPatchGan
from latentsplat_tpu_torch.model.encoder import epipolar_transformer as t_epipolar
from latentsplat_tpu_torch.model.latentsplat import LatentSplat
from latentsplat_tpu_torch.training import step as tstep
from latentsplat_tpu_torch.training.optim import build_optimizers
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_train_step import make_losses
from tests.test_train_step_quick import _full_cfgs

pytestmark = pytest.mark.slow

STEP = 125000
SIZE = 32
N_CONTEXT = N_TARGET = 2

RE10K_LOSSES = {
    "target_render_image": LossGroupCfg(nll=[
        LossCfg(name="mse", weight=10.0), LossCfg(name="lpips", weight=0.5, apply_after_step=50000),
    ]),
    "target_combined": LossGroupCfg(
        nll=[LossCfg(name="l1", apply_after_step=100000), LossCfg(name="lpips", apply_after_step=100000)],
        generator=LossCfg(name="generator", weight=0.5, apply_after_step=125000),
        discriminator=LossDiscriminatorCfg(loss="hinge", apply_after_step=125000),
    ),
}


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
        "near": np.full((1, n), 0.5, np.float32), "far": np.full((1, n), 100.0, np.float32),
    }


def random_leaves(params, rng):
    """Kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1^2), everything
    else (biases, zero-initialized skip convs) ~ N(0, 0.1^2)."""

    def leaf(path, x):
        keys = [p.key for p in path]
        shape = np.shape(x)
        if keys[-1] == "kernel" and len(shape) > 1:
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if keys[-1] == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def opt_cfgs(module):
    # A start factor of 1: the first step's rate is the full rate, so the
    # update is visible in float32 (warm-up has its own test).
    gen = dataclasses.replace(module.GeneratorOptimizerCfg(), warm_up_start_factor=1.0)
    return module.OptimizerCfg(generator=gen, discriminator=module.DiscriminatorOptimizerCfg())


def build(loss_cfgs):
    rng = np.random.default_rng(2024)
    batch = {"context": make_views(rng, N_CONTEXT), "target": make_views(rng, N_TARGET)}
    model_cfg, _ = _full_cfgs()
    jmodel = JLatentSplat(model_cfg, (0.0, 0.0, 0.0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params = random_leaves(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jbatch)), rng)

    model = LatentSplat(tconfig.from_dict(tconfig.ModelCfg, dataclasses.asdict(model_cfg)))
    model.load_state_dict(params_from_jax(params["generator"], model), strict=True)
    disc = DiscriminatorPatchGan(model.cfg.discriminator)
    disc.load_state_dict(params_from_jax(params["discriminator"], disc), strict=True)
    lpips = LPIPS().requires_grad_(False)
    lpips.load_state_dict(params_from_jax(params["lpips"], lpips), strict=True)
    opt_gen, opt_disc = build_optimizers(model, disc, opt_cfgs(tconfig), effective_batch_size=1)
    state = tstep.TrainState(model, disc, lpips, opt_gen, opt_disc)
    t_losses_cfg = tconfig.from_dict(LossesCfg, {k: dataclasses.asdict(v) for k, v in loss_cfgs.items()})
    t_losses = {name: LossGroup(name, getattr(t_losses_cfg, name)) for name in tstep.GROUP_NAMES}

    j_opt_gen, j_opt_disc = jstep.build_optimizers(jmodel, opt_cfgs(_JaxCfgs), effective_batch_size=1)
    j_state = jstep.TrainState(
        params_gen=params["generator"], params_disc=params["discriminator"], lpips_params=params["lpips"],
        opt_gen=j_opt_gen.init(params["generator"]), opt_disc=j_opt_disc.init(params["discriminator"]),
        step=jnp.asarray(STEP, jnp.int32),
    )
    return {
        "batch": batch, "params": params, "jmodel": jmodel, "j_losses": make_losses(loss_cfgs),
        "j_opt": (j_opt_gen, j_opt_disc), "j_state": j_state, "state": state, "t_losses": t_losses,
        "noise": make_noise(model, batch, np.random.default_rng(7)),
    }


class _JaxCfgs:
    GeneratorOptimizerCfg = JGenOptCfg
    DiscriminatorOptimizerCfg = JDiscOptCfg
    OptimizerCfg = JOptimizerCfg


def torch_batch(batch):
    return {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in batch.items()}


def make_noise(model, batch, rng):
    """Depth uniforms moved to the middle of their bucket's CDF interval
    under the port's depth pdf (see tests/test_torch_slice.py), Gaussian
    feature and latent normals."""
    captured = {}
    hook = model.encoder.depth_predictor.register_forward_pre_hook(
        lambda module, args: captured.update(features=args[0])
    )
    with torch.no_grad():
        model.encoder(torch_batch(batch)["context"], STEP, deterministic=True)
        hook.remove()
        head = model.encoder.depth_predictor
        y = head.projection(torch.relu(captured["features"]))
        y = y.reshape(*y.shape[:-1], head.num_samples, head.num_surfaces, 2)
        pdf = y[..., 0].movedim(-2, -1).softmax(dim=-1).double().numpy()   # (b, v, r, srf, dpt)
    gpp = model.cfg.encoder.gaussians_per_pixel
    uniform = rng.uniform(0, 1, (*pdf.shape[:-1], gpp))
    cdf = np.cumsum(pdf / pdf.sum(-1, keepdims=True), axis=-1)
    lower = np.concatenate([np.zeros_like(cdf[..., :1]), cdf[..., :-1]], axis=-1)
    bucket = np.minimum((cdf[..., None, :] <= uniform[..., :, None]).sum(-1), cdf.shape[-1] - 1)
    depth = 0.5 * (np.take_along_axis(lower, bucket, -1) + np.take_along_axis(cdf, bucket, -1))
    n_gaussians = N_CONTEXT * SIZE * SIZE * gpp
    d_sh = (model.cfg.encoder.gaussian_adapter.feature_sh_degree + 1) ** 2
    c = model.cfg.autoencoder.latent_channels
    return {
        "depth": depth.astype(np.float32),
        "gaussians": rng.standard_normal((1, n_gaussians, c, d_sh)).astype(np.float32),
        "latent": rng.standard_normal((1, N_TARGET, SIZE, SIZE, c)).astype(np.float32),
    }


def patch_noise(monkeypatch, noise, depths):
    """Feed `noise` to the JAX side's draws and record the sample depths
    its epipolar transformer triangulates into `depths`."""
    queue = {"uniform": [noise["depth"]], "normal": [noise["gaussians"], noise["latent"]]}
    get_depth = j_epipolar.get_depth

    def record(*args):
        depths.append(np.array(get_depth(*args)))
        return depths[-1]

    def fake(kind):
        def draw(key, shape=(), dtype=jnp.float32, *args, **kwargs):
            value = queue[kind].pop(0)
            assert value.shape == tuple(shape), (value.shape, shape)
            return jnp.asarray(value, dtype)
        return draw

    monkeypatch.setattr(jax.random, "uniform", fake("uniform"))
    monkeypatch.setattr(jax.random, "normal", fake("normal"))
    monkeypatch.setattr(j_epipolar, "get_depth", record)
    return queue


def jax_grads(case, monkeypatch):
    """The JAX step's generator gradients and adaptive weights."""
    jmodel, losses, j_state = case["jmodel"], case["j_losses"], case["j_state"]
    flags = jstep.make_step_flags(losses, STEP)
    queue = patch_noise(monkeypatch, case["noise"], case["depths"])
    batch = jax.tree_util.tree_map(jnp.asarray, case["batch"])

    def fwd(params_gen):
        return jstep.generator_forward(
            jmodel, losses, flags, params_gen, j_state.params_disc, j_state.lpips_params,
            batch, j_state.step, jax.random.PRNGKey(0),
        )

    (nll, gan_nll, gan_g, aux), vjp_fn = jax.vjp(fwd, j_state.params_gen)
    assert queue == {"uniform": [], "normal": []}
    zero_aux = jax.tree_util.tree_map(jnp.zeros_like, aux)
    n = len(flags.gen_gan)
    zero = jnp.zeros((n,))
    leaf = jmodel.last_layer_path()
    weights = []
    for i in range(n):
        e_i = zero.at[i].set(1.0)
        g_nll = vjp_fn((jnp.asarray(0.0), e_i, zero, zero_aux))[0]
        g_g = vjp_fn((jnp.asarray(0.0), zero, e_i, zero_aux))[0]
        for key in leaf:
            g_nll, g_g = g_nll[key], g_g[key]
        weights.append(adaptive_gan_weight(g_nll, g_g))
    w = jnp.stack(weights)
    grads = vjp_fn((jnp.asarray(1.0), zero, w, zero_aux))[0]
    return grads, w


def jax_step(case, monkeypatch):
    j_opt_gen, j_opt_disc = case["j_opt"]
    flags = jstep.make_step_flags(case["j_losses"], STEP)
    patch_noise(monkeypatch, case["noise"], case["depths"])
    train_step = jstep.make_train_step(case["jmodel"], case["j_losses"], j_opt_gen, j_opt_disc)
    return train_step(case["j_state"], jax.tree_util.tree_map(jnp.asarray, case["batch"]), jax.random.PRNGKey(0), flags)


@pytest.fixture(scope="module", params=["re10k", "full_cfgs"])
def case(request):
    loss_cfgs = RE10K_LOSSES if request.param == "re10k" else _full_cfgs()[1]
    with jax.disable_jit():
        c = build(loss_cfgs)
        c["depths"] = []
        mp = pytest.MonkeyPatch()
        try:
            c["j_grads"], c["j_weights"] = jax_grads(c, mp)
            mp.undo()
            c["j_new_state"], c["j_logs"] = jax_step(c, mp)
        finally:
            mp.undo()
    assert len(c["depths"]) == 2 and np.array_equal(*c["depths"])
    state, losses = c["state"], c["t_losses"]
    flags = tstep.make_step_flags(losses, STEP)
    noise = {k: torch.from_numpy(v) for k, v in c["noise"].items()}
    batch = torch_batch(c["batch"])
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_epipolar, "get_depth", lambda *args: torch.from_numpy(c["depths"][0]))
        grads, _, _, fakes = tstep.generator_grads(state, losses, flags, batch, STEP, noise=noise)
        d_loss, _ = tstep.discriminator_loss(state, losses, flags, batch, STEP, fakes)
        disc_params = dict(state.discriminator.named_parameters())
        c["disc_grads"] = dict(zip(disc_params, torch.autograd.grad(d_loss, list(disc_params.values()))))
        c["grads"] = grads
        c["new_state"], c["logs"] = tstep.make_train_step(losses)(state, batch, STEP, noise=noise)
    finally:
        mp.undo()
    c["name"] = request.param
    return c


def test_flags_and_logs(case):
    flags = tstep.make_step_flags(case["t_losses"], STEP)
    assert flags.gen_gan == flags.disc == ("target_combined",)
    assert flags.gaussian == (case["name"] == "full_cfgs")
    j_logs, logs = case["j_logs"], case["logs"]
    missing = set(j_logs) - set(logs)
    assert missing <= {k for k in j_logs if k.startswith("rasterizer/")}, missing
    assert {k for k in logs if k.startswith("diag/")} == {k for k in j_logs if k.startswith("diag/")}
    # Losses through the encoder, the dense rasterizer, the VAE, LPIPS and
    # the discriminator in float32: 1e-4 relative. The gradient norms
    # follow the gradients below.
    for key in sorted(set(j_logs) & set(logs)):
        np.testing.assert_allclose(float(logs[key]), float(j_logs[key]), rtol=1e-4, atol=1e-6, err_msg=key)
    assert 0.0 <= float(logs["target_combined/adaptive_weight"]) <= 1.0
    np.testing.assert_allclose(float(logs["target_combined/adaptive_weight"]), float(case["j_weights"][0]), rtol=1e-4)


def test_generator_gradients(case):
    # Each leaf to 2e-4 of its norm: float32 rounding through the whole
    # generator, its probes and the backward passes (measured up to ~2e-4
    # on 4-element leaves). Leaves whose gradient is zero but for rounding
    # (a conv bias right before a per-channel GroupNorm) are held to 1e-6
    # of the largest leaf norm instead.
    state = case["state"]
    ours = {n: g.numpy() for n, g in case["grads"].items()}
    theirs = {n: t.numpy() for n, t in params_from_jax(case["j_grads"], state.model).items()}
    assert set(ours) == set(theirs)
    floor = 1e-6 * max(np.linalg.norm(t) for t in theirs.values())
    errors = {n: np.abs(ours[n] - theirs[n]).max() / (np.linalg.norm(theirs[n]) + 1e-30) for n in ours}
    for name in ours:
        norm = np.linalg.norm(theirs[name])
        np.testing.assert_allclose(ours[name], theirs[name], atol=2e-4 * norm + floor, err_msg=name)
    assert np.median(list(errors.values())) < 1e-4, sorted(errors.values())[-5:]


def assert_updated_params_match(module, j_old, j_new, grads, clip=0.5):
    """Adam's first step moves each element by -lr * c / (|c| + 1e-8), where
    c is the gradient after its group's clip by global norm (the generator
    clips "autoencoder" and the rest apart). Where |c| > 1e-5 that is
    -lr * sign(c) to within 5e-4 of lr even if the two packages' gradients
    differ by a factor of two, so those elements are compared to 1e-3 of
    their group's rate plus 1e-6 relative (a few ulp of the parameter).
    Where |c| is smaller, eps and rounding decide the size of the move, and
    every element of both packages moves by at most its group's rate. An
    element whose JAX gradient is exactly zero stays to within 1e-3 of the
    rate."""
    theirs = params_from_jax(j_new, module)
    old = params_from_jax(j_old, module)

    def group(name):
        return name.startswith("autoencoder.")

    sq, rate = {}, {}
    for name, g in grads.items():
        sq[group(name)] = sq.get(group(name), 0.0) + float(np.sum(np.square(g, dtype=np.float64)))
        moved = (theirs[name] - old[name]).abs().max().item()
        rate[group(name)] = max(rate.get(group(name), 0.0), moved)
    clip_scale = {k: min(1.0, clip / np.sqrt(v)) for k, v in sq.items()}
    compared = total = 0
    for name, p in module.named_parameters():
        p, t, o = p.detach().numpy(), theirs[name].numpy(), old[name].numpy()
        c = np.abs(grads[name]) * clip_scale[group(name)]
        lr = rate[group(name)]
        assert np.abs(p - o).max() <= lr * (1 + 1e-3) + 1e-6 * np.abs(o).max(), name
        sure = (c > 1e-5) | (c == 0)
        np.testing.assert_allclose(p[sure], t[sure], rtol=1e-6, atol=1e-3 * lr, err_msg=name)
        compared, total = compared + sure.sum(), total + sure.size
    assert compared > 0.5 * total, (compared, total)


def test_updated_generator(case):
    grads = {n: t.numpy() for n, t in params_from_jax(case["j_grads"], case["state"].model).items()}
    assert_updated_params_match(
        case["new_state"].model, case["j_state"].params_gen, case["j_new_state"].params_gen, grads
    )


def test_updated_discriminator(case):
    # The port's discriminator gradients, taken before its update, pick the
    # elements whose update is sure (they agree with JAX's as the losses do).
    grads = {n: g.numpy() for n, g in case["disc_grads"].items()}
    assert_updated_params_match(
        case["new_state"].discriminator, case["j_state"].params_disc, case["j_new_state"].params_disc, grads
    )
    assert int(case["new_state"].opt_disc.state["discriminator"]["count"]) == 1
