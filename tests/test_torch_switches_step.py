"""The train step's switches against the JAX step on the CPU: the context,
target_autoencoder and target_render_latent loss sites with the two new GAN
groups, in float32 and under `compute_dtype: bfloat16`; and remat (model and
decoder) against the plain step under each policy.

The model is tests/test_train_step_quick.py::_full_cfgs' tiny one with the
VAE's skip connections off (the two autoencoder sites decode without a skip
tensor) and the epipolar transformer off (its triangulated depths amplify
rounding, see tests/test_torch_step.py). Every JAX leaf is drawn from a
numpy generator and crosses over with params_from_jax; the same numpy noise
goes to both sides (patched jax.random.uniform / normal on the JAX side,
the `noise` dict on the port's). The JAX generator forward, its adaptive-
weight probes and its backward run under one jax.jit.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from latentsplat_tpu.loss.losses import LossCfg, LossDiscriminatorCfg, LossGroupCfg, adaptive_gan_weight
from latentsplat_tpu.model.latentsplat import LatentSplat as JLatentSplat
from latentsplat_tpu.model.types import Prediction as JPrediction
from latentsplat_tpu.training import step as jstep
from latentsplat_tpu_torch import config as tconfig
from latentsplat_tpu_torch.loss.losses import LossesCfg, LossGroup
from latentsplat_tpu_torch.loss.lpips import LPIPS
from latentsplat_tpu_torch.model.discriminator.patch_gan import DiscriminatorPatchGan
from latentsplat_tpu_torch.model.latentsplat import LatentSplat
from latentsplat_tpu_torch.ops.rasterize import tiled
from latentsplat_tpu_torch.training import step as tstep
from latentsplat_tpu_torch.training.optim import build_optimizers
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_encoder import tiny_cfg
from tests.test_torch_step import make_views, random_leaves
from tests.test_train_step import make_losses
from tests.test_train_step_quick import _full_cfgs
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

STEP = 0
SIZE = 32
GAN = dict(generator=LossCfg(name="generator", weight=0.5), discriminator=LossDiscriminatorCfg(loss="hinge"))
SITE_LOSSES = {
    "context": LossGroupCfg(nll=[LossCfg(name="l1"), LossCfg(name="lpips")], **GAN),
    "target_autoencoder": LossGroupCfg(nll=[LossCfg(name="l1"), LossCfg(name="lpips", weight=0.5)], **GAN),
    "target_render_latent": LossGroupCfg(nll=[LossCfg(name="mse")]),
    "target_render_image": LossGroupCfg(nll=[LossCfg(name="mse", weight=10.0)]),
    "target_combined": LossGroupCfg(nll=[LossCfg(name="l1")], **GAN),
}


def model_cfg(**changes):
    cfg, _ = _full_cfgs()
    cfg = dataclasses.replace(
        cfg, autoencoder=dataclasses.replace(cfg.autoencoder, skip_connections=False),
        encoder=tiny_cfg(use_epipolar_transformer=False),
    )
    return dataclasses.replace(cfg, **changes)


def build(jcfg, loss_cfgs, seed=2024):
    """Both packages' models with the same random weights, the port's train
    state and both loss groups, a batch, and numpy noise for every draw."""
    rng = np.random.default_rng(seed)
    batch = {"context": make_views(rng, 2), "target": make_views(rng, 2)}
    jmodel = JLatentSplat(jcfg, (0.0, 0.0, 0.0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params = random_leaves(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jbatch)), rng)
    model = LatentSplat(tconfig.from_dict(tconfig.ModelCfg, dataclasses.asdict(jcfg)))
    model.load_state_dict(params_from_jax(params["generator"], model), strict=True)
    disc = DiscriminatorPatchGan(model.cfg.discriminator)
    disc.load_state_dict(params_from_jax(params["discriminator"], disc), strict=True)
    lpips = LPIPS().requires_grad_(False)
    lpips.load_state_dict(params_from_jax(params["lpips"], lpips), strict=True)
    opt_gen, opt_disc = build_optimizers(
        model, disc, tconfig.OptimizerCfg(discriminator=tconfig.DiscriminatorOptimizerCfg()), 1
    )
    state = tstep.TrainState(model, disc, lpips, opt_gen, opt_disc)
    t_losses_cfg = tconfig.from_dict(LossesCfg, {k: dataclasses.asdict(v) for k, v in loss_cfgs.items()})
    t_losses = {name: LossGroup(name, getattr(t_losses_cfg, name)) for name in tstep.GROUP_NAMES}
    case = {"batch": batch, "params": params, "jmodel": jmodel, "j_losses": make_losses(loss_cfgs),
            "state": state, "t_losses": t_losses}
    case["noise"] = make_noise(case, np.random.default_rng(seed + 1))
    return case


def torch_batch(batch):
    return {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in batch.items()}


def make_noise(case, rng):
    """Normals for every sample; the depth uniforms moved to the middle of
    their bucket's CDF interval under the port's depth pdf, so that float32
    rounding cannot move a sample across a bucket edge."""
    model, flags = case["state"].model, tstep.make_step_flags(case["t_losses"], STEP)
    cfg = model.cfg
    batch = torch_batch(case["batch"])
    ae = model.autoencoder
    c, ds = ae.d_latent, ae.downscale_factor
    latent = (1, 2, SIZE // ds, SIZE // ds, c)
    noise = {"context_latent": rng.standard_normal(latent), "target_latent": rng.standard_normal(latent)}
    features = None
    with torch.no_grad():
        if cfg.encode_latents:
            posterior = ae.encode(batch["context"]["image"])
            features = posterior.sample(noise=torch.from_numpy(noise["context_latent"].astype(np.float32)))
        captured = {}
        hook = model.encoder.depth_predictor.register_forward_pre_hook(
            lambda module, args: captured.update(features=args[0]))
        model.encoder(batch["context"], STEP, deterministic=True, features=features)
        hook.remove()
        head = model.encoder.depth_predictor
        y = head.projection(torch.relu(captured["features"]))
        y = y.reshape(*y.shape[:-1], head.num_samples, head.num_surfaces, 2)
        pdf = y[..., 0].movedim(-2, -1).softmax(dim=-1).double().numpy()
    gpp = cfg.encoder.gaussians_per_pixel
    uniform = rng.uniform(0, 1, (*pdf.shape[:-1], gpp))
    cdf = np.cumsum(pdf / pdf.sum(-1, keepdims=True), axis=-1)
    lower = np.concatenate([np.zeros_like(cdf[..., :1]), cdf[..., :-1]], axis=-1)
    bucket = np.minimum((cdf[..., None, :] <= uniform[..., :, None]).sum(-1), cdf.shape[-1] - 1)
    noise["depth"] = 0.5 * (np.take_along_axis(lower, bucket, -1) + np.take_along_axis(cdf, bucket, -1))
    rays = pdf.shape[2]
    d_sh = (cfg.encoder.gaussian_adapter.feature_sh_degree + 1) ** 2
    render = model.scaled_size(model.scale_factor, (SIZE, SIZE))
    noise["gaussians"] = rng.standard_normal((1, 2 * rays * gpp, c, d_sh))
    noise["latent"] = rng.standard_normal((1, 2, *render, c))
    # The JAX step's draws, in its order.
    order = {"uniform": ["depth"], "normal": ["gaussians", "latent"]}
    if flags.context or cfg.encode_latents:
        order["normal"].insert(0, "context_latent")
    if flags.target_autoencoder or flags.target_render_latent:
        order["normal"].insert(1 if (flags.context or cfg.encode_latents) else 0, "target_latent")
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    case["jax_draws"] = {kind: [noise[k] for k in keys] for kind, keys in order.items()}
    return noise


def jax_step(case, monkeypatch):
    """The JAX generator forward, probes and backward under one jit: (total,
    adaptive weights, logs, gradients, fakes), then its discriminator loss."""
    jmodel, losses, params = case["jmodel"], case["j_losses"], case["params"]
    flags = jstep.make_step_flags(losses, STEP)
    queue = {kind: list(values) for kind, values in case["jax_draws"].items()}

    def fake(kind):
        def draw(key, shape=(), dtype=jnp.float32, *args, **kwargs):
            value = queue[kind].pop(0)
            assert value.shape == tuple(shape), (kind, value.shape, shape)
            return jnp.asarray(value, dtype)
        return draw

    monkeypatch.setattr(jax.random, "uniform", fake("uniform"))
    monkeypatch.setattr(jax.random, "normal", fake("normal"))
    batch = jax.tree_util.tree_map(jnp.asarray, case["batch"])
    leaf_path = jmodel.last_layer_path()

    def fwd(params_gen):
        return jstep.generator_forward(
            jmodel, losses, flags, params_gen, params["discriminator"], params["lpips"], batch, STEP,
            jax.random.PRNGKey(0),
        )

    @jax.jit
    def run(params_gen):
        (nll, gan_nll, gan_g, aux), vjp_fn = jax.vjp(fwd, params_gen)
        zero_aux = jax.tree_util.tree_map(jnp.zeros_like, aux)
        n = len(flags.gen_gan)
        zero = jnp.zeros((n,))
        weights = []
        for i in range(n):
            e_i = zero.at[i].set(1.0)
            g_nll = vjp_fn((jnp.asarray(0.0), e_i, zero, zero_aux))[0]
            g_g = vjp_fn((jnp.asarray(0.0), zero, e_i, zero_aux))[0]
            for key in leaf_path:
                g_nll, g_g = g_nll[key], g_g[key]
            weights.append(adaptive_gan_weight(g_nll, g_g))
        w = jnp.stack(weights) if weights else zero
        grads = vjp_fn((jnp.asarray(1.0), zero, w, zero_aux))[0]
        return nll + jnp.sum(w * gan_g), w, aux["logs"], grads, aux["fakes"]

    total, w, logs, grads, fakes = run(params["generator"])
    assert queue == {"uniform": [], "normal": []}
    discriminate = jstep._mixed(jmodel.discriminate, jmodel.cfg, site="disc")
    d_total, d_logs = 0.0, {}
    for name in flags.disc:
        real = batch["context" if name == "context" else "target"]["image"]
        pred = JPrediction(logits_fake=discriminate(params["discriminator"], fakes[name]),
                           logits_real=discriminate(params["discriminator"], real))
        group_total, group_logs = losses[name].discriminator_total(pred, STEP)
        d_total = d_total + group_total
        d_logs.update(group_logs)
    return {"total": float(total), "weights": np.asarray(w), "logs": {k: float(v) for k, v in logs.items()},
            "grads": grads, "d_total": float(d_total), "d_logs": {k: float(v) for k, v in d_logs.items()}}


def port_step(case):
    state, losses = case["state"], case["t_losses"]
    flags = tstep.make_step_flags(losses, STEP)
    batch = torch_batch(case["batch"])
    noise = {k: torch.from_numpy(v) for k, v in case["noise"].items()}
    grads, total, logs, fakes = tstep.generator_grads(state, losses, flags, batch, STEP, noise=noise)
    with torch.no_grad():
        d_total, d_logs = tstep.discriminator_loss(state, losses, flags, batch, STEP, fakes)
    return {"total": float(total), "logs": {k: float(v.detach()) for k, v in logs.items()}, "grads": grads,
            "d_total": float(d_total), "d_logs": {k: float(v) for k, v in d_logs.items()}, "flags": flags}


DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def cases():
    out = {}
    for dtype in DTYPES:
        case = build(model_cfg(compute_dtype=dtype), SITE_LOSSES)
        with pytest.MonkeyPatch.context() as mp:
            case["jax"] = jax_step(case, mp)
        case["port"] = port_step(case)
        case["dtype"] = dtype
        out[dtype] = case
    return out


@pytest.fixture(params=DTYPES)
def sites(request, cases):
    return cases[request.param]


# (rtol, atol). float32 through the VAE, LPIPS, the encoder, the dense
# rasterizer and the PatchGAN: 1e-4 relative (tests/test_torch_step.py). In
# bfloat16 each package rounds its activations to 8 bits of mantissa (4e-3
# of a value near 1) after its own order of operations, and XLA and PyTorch
# order a convolution's sums differently: the losses agree to 2e-2
# relative, and those that are means of values near 1 that cancel (a
# generator loss, -mean of the logits) to 5e-3 absolute.
LOG_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (2e-2, 5e-3)}
# The adaptive weight is a ratio of two gradient norms at the VAE's last
# layer, each taken through a backward pass of bfloat16 activations whose
# rounding accumulates across the decoder: 1e-1 relative in bfloat16.
WEIGHT_RTOL = {"float32": 1e-4, "bfloat16": 1e-1}


def test_flags_and_logs(sites):
    port, theirs = sites["port"], sites["jax"]
    flags = port["flags"]
    assert flags.gen_gan == flags.disc == ("context", "target_autoencoder", "target_combined")
    assert flags.context and flags.target_autoencoder and flags.target_render_latent
    missing = set(theirs["logs"]) - set(port["logs"])
    assert missing <= {k for k in theirs["logs"] if k.startswith("rasterizer/")}, missing
    for key in ("train/context/psnr", "train/target_autoencoder/psnr", "target_render_latent/mse",
                "context/generator", "target_autoencoder/generator", "context/adaptive_weight",
                "target_autoencoder/adaptive_weight"):
        assert key in port["logs"], key
    rtol, atol = LOG_TOL[sites["dtype"]]
    for key in sorted(set(theirs["logs"]) & set(port["logs"])):
        if not key.endswith("adaptive_weight"):
            np.testing.assert_allclose(port["logs"][key], theirs["logs"][key], rtol=rtol, atol=atol, err_msg=key)
    weights = [port["logs"][f"{name}/adaptive_weight"] for name in flags.gen_gan]
    np.testing.assert_allclose(weights, theirs["weights"], rtol=WEIGHT_RTOL[sites["dtype"]])


def test_generator_total(sites, cases):
    # And each package's bfloat16 total within 5% of its own float32 total,
    # the JAX package's own tolerance (tests/test_train_step.py:418-434).
    port, theirs = sites["port"], sites["jax"]
    np.testing.assert_allclose(port["total"], theirs["total"], rtol=LOG_TOL[sites["dtype"]][0])
    f32 = cases["float32"]
    for side in ("jax", "port"):
        assert abs(sites[side]["total"] - f32[side]["total"]) <= 0.05 * abs(f32[side]["total"])


def test_discriminator_loss(sites):
    # The context and target_autoencoder groups judge their own reals.
    port, theirs = sites["port"], sites["jax"]
    for name in ("context", "target_autoencoder", "target_combined"):
        assert f"{name}/discriminator/fake" in port["d_logs"]
    rtol, atol = LOG_TOL[sites["dtype"]]
    np.testing.assert_allclose(port["d_total"], theirs["d_total"], rtol=rtol, atol=atol)
    for key, value in theirs["d_logs"].items():
        np.testing.assert_allclose(port["d_logs"][key], value, rtol=rtol, atol=atol, err_msg=key)


def test_generator_gradients(sites):
    # float32: each leaf to 2e-4 of its norm (tests/test_torch_step.py),
    # leaves whose gradient is zero but for rounding held to 1e-6 of the
    # largest leaf norm. The VAE encoder's leaves are among them and are
    # not zero: the context and target latents reach the losses. In
    # bfloat16 the gradients carry the activations' rounding: their
    # cosine with the JAX gradients is above 0.99 for the whole vector.
    state = sites["state"]
    ours = {n: g.float().numpy() for n, g in sites["port"]["grads"].items()}
    theirs = {n: t.numpy() for n, t in params_from_jax(sites["jax"]["grads"], state.model).items()}
    assert set(ours) == set(theirs)
    assert np.abs(ours["autoencoder.encoder.conv_in.weight"]).max() > 0
    if sites["dtype"] == "bfloat16":
        a = np.concatenate([ours[n].ravel() for n in sorted(ours)])
        b = np.concatenate([theirs[n].ravel() for n in sorted(ours)])
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99
        return
    floor = 1e-6 * max(np.linalg.norm(t) for t in theirs.values())
    for name in ours:
        np.testing.assert_allclose(ours[name], theirs[name], atol=2e-4 * np.linalg.norm(theirs[name]) + floor,
                                   err_msg=name)


def test_bfloat16_keeps_float32_masters(sites):
    state = sites["state"]
    grads = sites["port"]["grads"]
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert {g.dtype for g in grads.values()} == {torch.float32}


# -- remat ------------------------------------------------------------------------------------


def remat_state():
    torch.manual_seed(0)
    cfg = dataclasses.asdict(model_cfg())
    cfg["decoder"]["backend"] = "tiled"
    model = LatentSplat(tconfig.from_dict(tconfig.ModelCfg, cfg))
    disc = DiscriminatorPatchGan(model.cfg.discriminator)
    lpips = LPIPS().requires_grad_(False)
    opt_gen, opt_disc = build_optimizers(
        model, disc, tconfig.OptimizerCfg(discriminator=tconfig.DiscriminatorOptimizerCfg()), 1
    )
    losses_cfg = tconfig.from_dict(LossesCfg, {k: dataclasses.asdict(v) for k, v in SITE_LOSSES.items()})
    losses = {name: LossGroup(name, getattr(losses_cfg, name)) for name in tstep.GROUP_NAMES}
    return tstep.TrainState(model, disc, lpips, opt_gen, opt_disc), losses


@pytest.fixture(scope="module")
def plain_step():
    state, losses = remat_state()
    batch = torch_batch({"context": make_views(np.random.default_rng(1), 2),
                         "target": make_views(np.random.default_rng(2), 2)})
    return state, losses, batch, run_counted(state, losses, batch)


def run_counted(state, losses, batch):
    """generator_grads with randomness from a seeded generator (no noise
    tensors: the encoder's depth samples must be drawn outside its
    checkpoint), counting the forward compositor's calls."""
    calls = []
    forward = tiled.composite_forward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tiled, "composite_forward", lambda *args, **kwargs: calls.append(1) or forward(*args, **kwargs))
        flags = tstep.make_step_flags(losses, STEP)
        grads, total, logs, _ = tstep.generator_grads(
            state, losses, flags, batch, STEP, generator=torch.Generator().manual_seed(7))
    return grads, float(total), len(calls)


@pytest.mark.parametrize("policy", ["nothing", "dots", "vae:off,lpips:off", "encoder:dots,vae:full,lpips:off"])
def test_remat_matches_the_plain_step(plain_step, policy):
    # model.remat (encoder, VAE decode, LPIPS) and decoder.remat (each
    # render pass) change what the backward recomputes, never the values:
    # the same generator/total and gradients within 1e-6 of each leaf's
    # largest value (leaves that are zero but for rounding against 1e-4 of
    # the largest gradient). The 2 target views are one pass, composited
    # again in the backward.
    state, losses, batch, (plain, plain_total, plain_calls) = plain_step
    cfg = state.model.cfg
    cfg.remat, cfg.remat_policy, state.model.decoder.cfg.remat = True, policy, True
    try:
        grads, total, calls = run_counted(state, losses, batch)
    finally:
        cfg.remat, cfg.remat_policy, state.model.decoder.cfg.remat = False, "nothing", False
    assert plain_calls == 1 and calls == 2
    assert total == plain_total
    floor = 1e-4 * max(g.abs().max() for g in plain.values())
    for name, g in plain.items():
        scale = torch.clamp(g.abs().max(), min=floor)
        torch.testing.assert_close(grads[name] / scale, g / scale, atol=1e-6, rtol=0, msg=name)


def test_dots_policy_serves_every_backward():
    # The adaptive weight's probes and the final backward all pass through
    # a checkpointed site: the kept convolution outputs must serve each of
    # them (torch's own selective checkpoint gives them up after one).
    conv = torch.nn.Conv2d(3, 4, 3, padding=1)
    x = torch.randn(1, 3, 8, 8, requires_grad=True)

    class Cfg:
        remat_policy = "dots"

    def fn(y):
        return torch.nn.functional.silu(conv(torch.nn.functional.silu(conv.weight.sum() * y))).sum()

    wrapped = tstep._remat(fn, Cfg, "vae")
    assert wrapped is not fn
    out, ref = wrapped(x), fn(x)
    assert torch.equal(out, ref)
    for _ in range(3):
        ours = torch.autograd.grad(out, [x, conv.weight], retain_graph=True)
        theirs = torch.autograd.grad(ref, [x, conv.weight], retain_graph=True)
        for a, b in zip(ours, theirs):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def recomputed_bytes(frames: list) -> int:
    """Bytes of the tensors that live checkpoint frames hold from their
    recomputations, over every backward (each storage counted once)."""
    storages = {}
    for ref in frames:
        frame = ref()
        for tensors in [] if frame is None else frame.recomputed.values():
            for t in tensors.values():
                storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(storages.values())


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_probes_leave_nothing_to_the_final_backward(policy):
    # Between the adaptive weight's last probe and the final backward, the
    # checkpointed sites (encoder, VAE decode, LPIPS) hold no tensor they
    # recomputed for a probe: every byte they hold then is what the final
    # backward recomputes for itself. The final backward recomputes each site.
    state, losses = remat_state()
    batch = torch_batch({"context": make_views(np.random.default_rng(1), 2),
                         "target": make_views(np.random.default_rng(2), 2)})
    frames, phase, held, recomputed = [], ["forward"], {}, {}
    frame_init = torch.utils.checkpoint._CheckpointFrame.__init__
    check = torch.utils.checkpoint._CheckpointFrame.check_recomputed_tensors_match
    grads = tstep._grads

    def init(self, *args, **kwargs):
        frame_init(self, *args, **kwargs)
        frames.append(weakref.ref(self))

    def checked(self, gid):
        check(self, gid)
        recomputed[phase[0]] = recomputed.get(phase[0], 0) + sum(
            t.untyped_storage().nbytes() for t in self.recomputed[gid].values())

    def counted_grads(output, params, retain_graph=False):
        phase[0] = "probe" if retain_graph else "final"
        if not retain_graph:
            held["before_final"] = recomputed_bytes(frames)
        return grads(output, params, retain_graph)

    cfg = state.model.cfg
    cfg.remat, cfg.remat_policy, state.model.decoder.cfg.remat = True, policy, True
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.utils.checkpoint._CheckpointFrame, "__init__", init)
        mp.setattr(torch.utils.checkpoint._CheckpointFrame, "check_recomputed_tensors_match", checked)
        mp.setattr(tstep, "_grads", counted_grads)
        flags = tstep.make_step_flags(losses, STEP)
        assert len(flags.gen_gan) == 3
        tstep.generator_grads(state, losses, flags, batch, STEP, generator=torch.Generator().manual_seed(7))
    assert recomputed["probe"] > 0 and recomputed["final"] > 0
    assert held["before_final"] == 0, (
        f"{held['before_final']} bytes recomputed for the probes survive into the final backward "
        f"({recomputed['probe']} recomputed by the probes, {recomputed['final']} by the final backward)")
