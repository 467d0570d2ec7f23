"""Port-only mechanics of the train step, on the CPU in seconds: one step
updates both nets and logs what the JAX step logs; a NaN loss skips both
updates and leaves every optimizer state as it was; the loss-spike guard
skips, then force-accepts at patience - 1 skips; and the step's gradients
through the tiled rasterizer (the plain kernel versions here) agree with
those through the dense oracle. The step's numbers against the JAX step
are in tests/test_torch_step.py (slow).

The model is the tiny one of tests/test_train_step_quick.py::_full_cfgs with
the re10k loss groups at step 125000, where every branch is live.
"""

import dataclasses

import numpy as np
import pytest
import torch

from latentsplat_tpu_torch import config as tconfig
from latentsplat_tpu_torch import cuda_build
from latentsplat_tpu_torch.loss.losses import LossCfg, LossDiscriminatorCfg, LossGroup, LossGroupCfg
from latentsplat_tpu_torch.loss.lpips import LPIPS
from latentsplat_tpu_torch.model.discriminator.patch_gan import DiscriminatorPatchGan
from latentsplat_tpu_torch.model.latentsplat import LatentSplat
from latentsplat_tpu_torch.training import step as tstep
from latentsplat_tpu_torch.training.optim import build_optimizers

from tests.test_train_step_quick import _full_cfgs
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

STEP = 125000
SIZE = 32
LOSSES = {
    "target_render_image": LossGroupCfg(nll=[
        LossCfg(name="mse", weight=10.0), LossCfg(name="lpips", weight=0.5, apply_after_step=50000),
    ]),
    "target_combined": LossGroupCfg(
        nll=[LossCfg(name="l1", apply_after_step=100000), LossCfg(name="lpips", apply_after_step=100000)],
        generator=LossCfg(name="generator", weight=0.5, apply_after_step=125000),
        discriminator=LossDiscriminatorCfg(loss="hinge", apply_after_step=125000),
    ),
}


def make_batch(rng):
    def views(n):
        ext = np.tile(np.eye(4, dtype=np.float32), (1, n, 1, 1))
        ext[0, :, 0, 3] = np.linspace(-0.3, 0.3, n)
        intr = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (1, n, 1, 1))
        arrays = {
            "image": rng.uniform(0, 1, (1, n, SIZE, SIZE, 3)).astype(np.float32),
            "extrinsics": ext, "intrinsics": intr,
            "near": np.full((1, n), 0.5, np.float32), "far": np.full((1, n), 100.0, np.float32),
        }
        return {k: torch.from_numpy(v) for k, v in arrays.items()}

    return {"context": views(2), "target": views(2)}


def build(skip_loss_spike_factor=None, patience=10):
    torch.manual_seed(0)
    model = LatentSplat(tconfig.from_dict(tconfig.ModelCfg, dataclasses.asdict(_full_cfgs()[0])))
    disc = DiscriminatorPatchGan(model.cfg.discriminator)
    lpips = LPIPS().requires_grad_(False)
    opt_cfg = tconfig.OptimizerCfg(discriminator=tconfig.DiscriminatorOptimizerCfg())
    opt_gen, opt_disc = build_optimizers(model, disc, opt_cfg, effective_batch_size=1)
    state = tstep.TrainState(model, disc, lpips, opt_gen, opt_disc)
    if skip_loss_spike_factor is not None:
        state.gen_loss_ema = torch.zeros(())
        state.spike_skip_count = torch.zeros((), dtype=torch.int32)
    losses = {name: LossGroup(name, LOSSES.get(name)) for name in tstep.GROUP_NAMES}
    return state, losses, tstep.make_train_step(losses, skip_loss_spike_factor, patience)


def snapshot(state):
    nets = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    nets.update({f"disc.{n}": p.detach().clone() for n, p in state.discriminator.named_parameters()})
    opts = [
        {k: (v.clone() if torch.is_tensor(v) else {n: t.clone() for n, t in v.items()}) for k, v in group.items()}
        for opt in (state.opt_gen, state.opt_disc) for group in opt.state.values()
    ]
    return nets, opts


def assert_same(a, b):
    for name in a[0]:
        assert torch.equal(a[0][name], b[0][name]), name
    for ga, gb in zip(a[1], b[1]):
        assert torch.equal(ga["count"], gb["count"])
        for key in ("mu", "nu"):
            assert all(torch.equal(ga[key][n], gb[key][n]) for n in ga[key])


def test_step_updates_both_nets_and_logs():
    state, _, train_step = build()
    before = snapshot(state)
    state, logs = train_step(state, make_batch(np.random.default_rng(0)), STEP, generator=torch.Generator().manual_seed(1))
    for key in (
        "generator/total", "discriminator/total", "grad_norm/generator", "grad_norm/encoder",
        "grad_norm/autoencoder", "target_combined/adaptive_weight", "train/target_render/psnr",
        "train/target_combined/psnr", "target_render_image/mse", "target_render_image/lpips",
        "target_combined/l1", "target_combined/lpips", "target_combined/generator",
        "target_combined/discriminator/fake", "target_combined/discriminator/real",
        "diag/max_world_scale", "diag/max_opacity", "diag/max_abs_color_sh",
        "diag/max_abs_feature_mean", "diag/max_feature_logvar",
    ):
        assert torch.isfinite(logs[key]), key
    assert 0.0 <= float(logs["target_combined/adaptive_weight"]) <= 1.0
    after = snapshot(state)
    changed = [n for n in before[0] if not torch.equal(before[0][n], after[0][n])]
    assert any(n.startswith("disc.") for n in changed) and any(n.startswith("encoder.") for n in changed)
    assert any(n.startswith("autoencoder.") for n in changed)
    assert all(int(g["count"]) == 1 for g in after[1])


def test_nan_loss_skips_both_updates():
    state, _, train_step = build()
    batch = make_batch(np.random.default_rng(0))
    batch["target"]["image"][0, 0, 0, 0, 0] = float("nan")
    before = snapshot(state)
    state, logs = train_step(state, batch, STEP, generator=torch.Generator().manual_seed(1))
    assert not torch.isfinite(logs["generator/total"])
    assert_same(before, snapshot(state))


def test_spike_guard_skips_then_force_accepts():
    # Every loss is a spike against an EMA of 1e-6. With patience 2 the
    # first is skipped (nothing moves, the skip count grows) and the second
    # is force-accepted (patience - 1 skips, as the JAX step does), which
    # re-seeds the EMA at its magnitude.
    state, _, train_step = build(skip_loss_spike_factor=2.0, patience=2)
    state.gen_loss_ema = torch.tensor(1e-6)
    batch = make_batch(np.random.default_rng(0))
    for i in range(2):
        before = snapshot(state)
        state, logs = train_step(state, batch, STEP, generator=torch.Generator().manual_seed(1))
        if i < 1:
            assert float(logs["optimizer/loss_spike_skipped"]) == 1.0
            assert int(state.spike_skip_count) == i + 1
            assert float(state.gen_loss_ema) == pytest.approx(1e-6)
            assert_same(before, snapshot(state))
    assert float(logs["optimizer/loss_spike_forced"]) == 1.0
    assert int(state.spike_skip_count) == 0
    assert float(state.gen_loss_ema) == pytest.approx(abs(float(logs["generator/total"])), rel=1e-6)
    assert all(int(g["count"]) == 1 for g in snapshot(state)[1])


def test_tiled_gradients_match_dense():
    # The same step's generator gradients with the tiled rasterizer (plain
    # kernel versions on the CPU) and with the dense oracle, same weights
    # and noise: normalised by each leaf's largest gradient, atol 5e-3, the
    # JAX package's tiled-vs-dense gradient tolerance. A leaf whose gradient
    # is zero but for rounding (a conv bias that a GroupNorm or a softmax
    # cancels, ~1e-9 here) is normalised by 1e-4 of the largest gradient.
    state, losses, _ = build()
    batch = make_batch(np.random.default_rng(0))
    rng = np.random.default_rng(3)
    cfg = state.model.cfg
    gpp = cfg.encoder.gaussians_per_pixel
    d_sh = (cfg.encoder.gaussian_adapter.feature_sh_degree + 1) ** 2
    c = cfg.autoencoder.latent_channels
    noise = {
        "depth": rng.uniform(0, 1, (1, 2, SIZE * SIZE, 1, gpp)),
        "gaussians": rng.standard_normal((1, 2 * SIZE * SIZE * gpp, c, d_sh)),
        "latent": rng.standard_normal((1, 2, SIZE, SIZE, c)),
    }
    noise = {k: torch.from_numpy(v.astype(np.float32)) for k, v in noise.items()}
    flags = tstep.make_step_flags(losses, STEP)
    grads = {}
    for backend in ("dense", "tiled"):
        state.model.decoder.cfg.backend = backend
        grads[backend], _, _, _ = tstep.generator_grads(state, losses, flags, batch, STEP, noise=noise)
    floor = 1e-4 * max(g.abs().max() for g in grads["dense"].values())
    for name, gd in grads["dense"].items():
        scale = torch.clamp(gd.abs().max(), min=floor)
        torch.testing.assert_close(grads["tiled"][name] / scale, gd / scale, atol=5e-3, rtol=0, msg=name)
    assert cuda_build.launched("composite_backward") == 0     # the CPU never launches
