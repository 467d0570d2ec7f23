"""The port's training modules against the JAX package's: LPIPS, the
PatchGAN discriminator, every loss, the adaptive GAN weight, PSNR, the
optimizer chains, the weight bridge for the discriminator and LPIPS trees,
and the gradients of the distribution helpers.

Inputs and every parameter leaf come from numpy generators; weights cross
over with `params_from_jax`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latentsplat_tpu.evaluation.metrics import compute_psnr as j_compute_psnr
from latentsplat_tpu.loss import losses as jl
from latentsplat_tpu.loss.lpips import LPIPS as JLPIPS
from latentsplat_tpu.model import types as jtypes
from latentsplat_tpu.model.discriminator.patch_gan import DiscriminatorPatchGan as JPatchGan
from latentsplat_tpu.model.discriminator.patch_gan import DiscriminatorPatchGanCfg as JPatchGanCfg
from latentsplat_tpu.ops import distributions as jd
from latentsplat_tpu.training.step import build_optimizers as j_build_optimizers
from latentsplat_tpu_torch.config import DiscriminatorPatchGanCfg
from latentsplat_tpu_torch.evaluation.metrics import compute_psnr
from latentsplat_tpu_torch.loss import losses as tl
from latentsplat_tpu_torch.loss.lpips import LPIPS
from latentsplat_tpu_torch.model import types as ttypes
from latentsplat_tpu_torch.model.discriminator.patch_gan import DiscriminatorPatchGan
from latentsplat_tpu_torch.ops import distributions as td
from latentsplat_tpu_torch.training.optim import build_optimizers
from latentsplat_tpu_torch.weights import adam_state_from_jax, params_from_jax
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def random_leaves(shapes, rng):
    """Kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1^2), the rest
    (biases, lin heads) ~ N(0, 0.1^2) -- zero-initialized leaves included."""

    def leaf(path, x):
        key = path[-1].key
        shape = np.shape(x)
        if key == "kernel" and len(shape) == 4 and shape[0] > 1:
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_module(module, params):
    state = params_from_jax(params, module)
    module.load_state_dict(state, strict=True)
    return module, state


def assert_every_leaf_mapped(params, state):
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(state)
    assert sorted(round(float(np.sum(l, dtype=np.float64)), 3) for l in leaves) == sorted(
        round(float(v.double().sum()), 3) for v in state.values()
    )


@pytest.fixture(scope="module")
def lpips_pair():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: JLPIPS().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3))))
    params = random_leaves(shapes["params"], rng)
    model, state = port_module(LPIPS(), params)
    return params, model, state


def test_lpips_matches_jax(lpips_pair):
    params, model, state = lpips_pair
    assert_every_leaf_mapped(params, state)
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32) for _ in range(2))
    theirs = np.asarray(JLPIPS().apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    ours = model(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy()
    # float32 rounding through 13 convolutions, 1e-5 of the distance.
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5 * np.abs(theirs).max())


@pytest.mark.parametrize("n_layers", [2, 3])
def test_patch_gan_matches_jax(n_layers):
    rng = np.random.default_rng(n_layers)
    jcfg = JPatchGanCfg(base_dim=8, n_layers=n_layers, pretrained=False)
    jmodel = JPatchGan(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params = random_leaves(shapes["params"], rng)
    model, state = port_module(DiscriminatorPatchGan(DiscriminatorPatchGanCfg(**dataclasses.asdict(jcfg))), params)
    assert_every_leaf_mapped(params, state)
    x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    theirs = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    ours = model(torch.from_numpy(x)).detach().numpy()
    assert ours.shape == theirs.shape
    # Batch statistics and float32 rounding: 1e-5 of the logits' scale.
    np.testing.assert_allclose(ours, theirs, atol=1e-5 * np.abs(theirs).max())


def loss_inputs(rng):
    b, v, h, w = 2, 2, 16, 16
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = {
        "image": rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32),
        "gt_image": rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32),
        "depth": rng.uniform(1.0, 20.0, (b, v, h, w)).astype(np.float32),
        "near": np.full((b, v), 1.0, np.float32), "far": np.full((b, v), 100.0, np.float32),
        "mean": f(b, 50, 4, 4), "logvar": 3 * f(b, 50, 4, 4), "harmonics": f(b, 50, 3, 4),
        "logits_fake": f(b, v, 3, 3, 1), "logits_real": f(b, v, 3, 3, 1),
    }
    return arrays


def as_predictions(arrays, tensor, types, gaussian):
    a = {k: tensor(v) for k, v in arrays.items()}
    pred = types.Prediction(
        image=a["image"], posterior=gaussian(a["mean"], a["logvar"]), depth=a["depth"],
        logits_fake=a["logits_fake"], logits_real=a["logits_real"], harmonics=a["harmonics"],
    )
    gt = types.GroundTruth(image=a["gt_image"], near=a["near"], far=a["far"])
    return pred, gt


def lpips_fns(lpips_pair):
    params, model, _ = lpips_pair
    return (lambda p, t: JLPIPS().apply({"params": params}, p, t)), model


@pytest.mark.parametrize("step", [0, 125000])
def test_losses_match_jax(lpips_pair, step):
    arrays = loss_inputs(np.random.default_rng(3))
    j_pred, j_gt = as_predictions(arrays, jnp.asarray, jtypes, jd.DiagonalGaussian)
    t_pred, t_gt = as_predictions(arrays, torch.from_numpy, ttypes, td.DiagonalGaussian)
    j_lpips, t_lpips = lpips_fns(lpips_pair)
    nll = [jl.LossCfg(name=n, weight=w, apply_after_step=a) for n, w, a in (
        ("mse", 10.0, 0), ("l1", 1.0, 100000), ("kl", 1e-4, 0), ("lpips", 0.5, 50000),
        ("depth", 0.3, 0), ("sh_l2", 0.05, 0),
    )]
    j_cfg = jl.LossGroupCfg(
        nll=nll, generator=jl.LossCfg(name="generator", weight=0.5, apply_after_step=125000),
        discriminator=jl.LossDiscriminatorCfg(loss="hinge", apply_after_step=125000),
    )
    t_cfg = tl.LossGroupCfg(
        nll=[tl.LossCfg(**dataclasses.asdict(c)) for c in nll],
        generator=tl.LossCfg(name="generator", weight=0.5, apply_after_step=125000),
        discriminator=tl.LossDiscriminatorCfg(loss="hinge", apply_after_step=125000),
    )
    j_group, t_group = jl.LossGroup("site", j_cfg), tl.LossGroup("site", t_cfg)
    assert t_group.is_active(step) == j_group.is_active(step)
    assert t_group.is_generator_active(step) == j_group.is_generator_active(step)
    assert t_group.is_discriminator_active(step) == j_group.is_discriminator_active(step)

    results = [
        (j_group.nll_total(j_pred, j_gt, step, j_lpips), t_group.nll_total(t_pred, t_gt, step, t_lpips)),
        (j_group.generator_total(j_pred, step), t_group.generator_total(t_pred, step)),
        (j_group.discriminator_total(j_pred, step), t_group.discriminator_total(t_pred, step)),
    ]
    for (j_total, j_logs), (t_total, t_logs) in results:
        assert set(j_logs) == set(t_logs)
        # float32 means over a few hundred elements (LPIPS: 13 convolutions).
        np.testing.assert_allclose(float(t_total.detach()), float(j_total), rtol=1e-5, atol=1e-7)
        for key in j_logs:
            np.testing.assert_allclose(float(t_logs[key]), float(j_logs[key]), rtol=1e-5, atol=1e-7, err_msg=key)
    # The remaining loss functions, ungated.
    for name in ("vanilla_d_loss", "hinge_d_loss"):
        np.testing.assert_allclose(
            float(getattr(tl, name)(t_pred.logits_fake)), float(getattr(jl, name)(j_pred.logits_fake)), rtol=1e-6
        )
    for sigma, second in ((2.0, False), (2.0, True), (None, True)):
        theirs = jl.loss_depth_smoothness(j_pred, j_gt, None, sigma, second)
        ours = tl.loss_depth_smoothness(t_pred, t_gt, None, sigma, second)
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-5)


def test_adaptive_gan_weight_and_psnr_match_jax():
    rng = np.random.default_rng(4)
    for scale in (0.1, 1.0, 30.0):          # inside [0, 1] and clamped at 1
        a = rng.standard_normal((3, 16, 3, 3)).astype(np.float32)
        b = (scale * rng.standard_normal((3, 16, 3, 3))).astype(np.float32)
        theirs = float(jl.adaptive_gan_weight(jnp.asarray(b), jnp.asarray(a)))
        ours = tl.adaptive_gan_weight(torch.from_numpy(b), torch.from_numpy(a))
        assert not ours.requires_grad
        np.testing.assert_allclose(float(ours), theirs, rtol=1e-6)
    gt = rng.uniform(-0.1, 1.1, (2, 3, 8, 8, 3)).astype(np.float32)
    pred = rng.uniform(-0.1, 1.1, (2, 3, 8, 8, 3)).astype(np.float32)
    pred[0, 0] = np.clip(gt[0, 0], 0, 1)     # a perfect image: the 1e-12 floor
    np.testing.assert_allclose(
        compute_psnr(torch.from_numpy(gt), torch.from_numpy(pred)).numpy(),
        np.asarray(j_compute_psnr(jnp.asarray(gt), jnp.asarray(pred))), rtol=1e-5,
    )


def test_distribution_gradients_match_jax():
    # The straight-through logvar clamp (gradient 1 outside the bounds, the
    # plain clip at +-inf) and the top-k gather's density gradient.
    rng = np.random.default_rng(5)
    raw = rng.uniform(-40, 30, (64,)).astype(np.float32)
    raw[:2] = [np.inf, -np.inf]
    mean = rng.standard_normal(64).astype(np.float32)
    cot = rng.standard_normal(64).astype(np.float32)

    def j_fn(mean, raw):
        d = jd.DiagonalGaussian(mean, raw)
        return jnp.sum(jnp.where(jnp.isfinite(d.logvar), d.logvar, 0.0) * cot) + jnp.sum(d.kl()[2:])

    j_g = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(mean), jnp.asarray(raw))
    t_mean, t_raw = torch.from_numpy(mean).requires_grad_(), torch.from_numpy(raw).requires_grad_()
    d = td.DiagonalGaussian(t_mean, t_raw)
    out = (torch.where(torch.isfinite(d.logvar), d.logvar, 0.0) * torch.from_numpy(cot)).sum() + d.kl()[2:].sum()
    t_g = torch.autograd.grad(out, [t_mean, t_raw])
    for ours, theirs in zip(t_g, j_g):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)

    pdf = rng.uniform(0.01, 1.0, (6, 32)).astype(np.float32)
    cot = rng.standard_normal((6, 3)).astype(np.float32)
    j_g = jax.grad(lambda p: jnp.sum(jd.gather_discrete_topk(p, 3)[1] * cot))(jnp.asarray(pdf))
    t_pdf = torch.from_numpy(pdf).requires_grad_()
    index, density = td.gather_discrete_topk(t_pdf, 3)
    np.testing.assert_array_equal(index.numpy(), np.asarray(jd.gather_discrete_topk(jnp.asarray(pdf), 3)[0]))
    (t_g,) = torch.autograd.grad((density * torch.from_numpy(cot)).sum(), t_pdf)
    np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=1e-5, atol=1e-7)


# -- the optimizer chains ------------------------------------------------------


class TinyGenerator(torch.nn.Module):
    """Two top-level groups named like the generator's (encoder and
    autoencoder), so the optimizer labels them the same way."""

    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.Linear(5, 4)
        self.autoencoder = torch.nn.Conv2d(3, 2, 3)


def jax_tree(module):
    """The flax-layout tree of `module`'s parameters (numpy)."""
    return {
        "encoder": {"kernel": module.encoder.weight.detach().numpy().T.copy(),
                    "bias": module.encoder.bias.detach().numpy().copy()},
        "autoencoder": {"kernel": module.autoencoder.weight.detach().numpy().transpose(2, 3, 1, 0).copy(),
                        "bias": module.autoencoder.bias.detach().numpy().copy()},
    }


@pytest.mark.parametrize("freeze_encoder", [False, True])
def test_optimizer_matches_optax(freeze_encoder):
    """Three updates of the port's chains and of optax's on the same
    gradients, from the same non-fresh Adam state: the autoencoder group's
    gradient is over its clip norm, the rates warm up over 4 updates, one
    group may be frozen, and the second update is skipped (not ok)."""
    rng = np.random.default_rng(6)
    model = TinyGenerator()
    params = random_leaves(jax_tree(model), rng)
    model.load_state_dict(params_from_jax(params, model))
    disc = torch.nn.Linear(3, 2)
    disc_params = random_leaves({"kernel": np.zeros((3, 2)), "bias": np.zeros(2)}, rng)
    disc.load_state_dict(params_from_jax(disc_params, disc))

    def cfgs(module):
        return (
            module.OptimizerCfg(
                generator=dataclasses.replace(
                    module.OptimizerCfg().generator, warm_up_steps=4, warm_up_start_factor=0.1,
                    lr=1e-2, autoencoder_lr=3e-3, gradient_clip_val=0.5,
                ),
                discriminator=module.DiscriminatorOptimizerCfg(lr=2e-3, gradient_clip_val=0.3),
            ),
            module.FreezeCfg(encoder=freeze_encoder),
        )

    import latentsplat_tpu.config as jc
    import latentsplat_tpu_torch.config as tc

    j_opt_cfg, j_freeze = cfgs(jc)
    t_opt_cfg, t_freeze = cfgs(tc)

    class Bundle:   # what build_optimizers reads from the JAX model
        discriminator = object()

    j_gen, j_disc = j_build_optimizers(Bundle(), j_opt_cfg, effective_batch_size=2, freeze=j_freeze)
    t_gen, t_disc = build_optimizers(model, disc, t_opt_cfg, effective_batch_size=2, freeze=t_freeze)

    # Start both from the same non-fresh Adam state (count 2).
    j_gen_state, j_disc_state = j_gen.init(params), j_disc.init(disc_params)
    moments = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(0.01 * rng.standard_normal(np.shape(x)), jnp.float32), tree)  # noqa: E731
    second = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(1e-4 * rng.uniform(0, 1, np.shape(x)), jnp.float32), tree)  # noqa: E731
    inner = dict(j_gen_state.inner_states)
    for label, module_name in (("rest", "encoder"), ("autoencoder", "autoencoder")):
        if label not in inner or freeze_encoder and label == "rest":
            continue
        masked = inner[label]
        clip, adam, sched = masked.inner_state
        mu = {k: (moments(v) if k == module_name else jax.tree_util.tree_map(lambda _: optax.MaskedNode(), v)) for k, v in params.items()}
        nu = {k: (second(v) if k == module_name else jax.tree_util.tree_map(lambda _: optax.MaskedNode(), v)) for k, v in params.items()}
        count = jnp.asarray(2, jnp.int32)
        inner[label] = masked._replace(inner_state=(clip, adam._replace(count=count, mu=mu, nu=nu), sched._replace(count=count)))
        t_gen.load_state(label, adam_state_from_jax(mu, nu, count, model))
    j_gen_state = j_gen_state._replace(inner_states=inner)
    clip, adam, scale = j_disc_state      # a constant rate: no schedule count
    d_mu, d_nu, count = moments(disc_params), second(disc_params), jnp.asarray(2, jnp.int32)
    j_disc_state = (clip, adam._replace(count=count, mu=d_mu, nu=d_nu), scale)
    t_disc.load_state("discriminator", adam_state_from_jax(d_mu, d_nu, count, disc))

    j_params, j_dparams = params, disc_params
    for i, ok in enumerate((True, False, True)):
        grads = jax.tree_util.tree_map(lambda x: (rng.standard_normal(np.shape(x))).astype(np.float32), j_params)
        grads["encoder"] = jax.tree_util.tree_map(lambda x: 0.01 * x, grads["encoder"])   # under its clip
        d_grads = jax.tree_util.tree_map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), j_dparams)
        if ok:
            updates, j_gen_state = j_gen.update(grads, j_gen_state, j_params)
            j_params = optax.apply_updates(j_params, updates)
            d_updates, j_disc_state = j_disc.update(d_grads, j_disc_state, j_dparams)
            j_dparams = optax.apply_updates(j_dparams, d_updates)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        t_gen.step(params_from_jax(grads, model), torch.tensor(ok))
        t_disc.step(params_from_jax(d_grads, disc), torch.tensor(ok))
        if not ok:
            assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
        # Elementwise float32 Adam arithmetic in the same order.
        for ours, theirs in ((model, j_params), (disc, j_dparams)):
            for name, value in params_from_jax(theirs, ours).items():
                np.testing.assert_allclose(
                    ours.state_dict()[name].numpy(), value.numpy(), rtol=1e-6, atol=1e-7, err_msg=f"{i} {name}"
                )
    for label in t_gen.state:
        assert int(t_gen.state[label]["count"]) == 4
    if freeze_encoder:
        assert "rest" not in t_gen.state
        assert torch.equal(model.encoder.weight, torch.from_numpy(params["encoder"]["kernel"].T))
