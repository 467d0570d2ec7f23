"""`encode_latents` against the JAX package on the CPU: the encoder fed the
VAE's latents of the context images instead of the images, in one train
step (as tests/test_train_step.py::TestEncodeLatents builds it: the tiny
ResNet model, a KL autoencoder with 2 latent channels, 32x32 images) and
in the deterministic serving path; under remat; and `Trainer.test`, which
times the VAE encoder under the autoencoder_encoder tag.

The epipolar transformer is off for the step comparison, as in
tests/test_torch_switches_step.py, whose helpers build both sides.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.loss.losses import LossCfg, LossGroupCfg
from latentsplat_tpu.training.trainer import Trainer as JaxTrainer
from latentsplat_tpu_torch import config as tconfig
from latentsplat_tpu_torch.model.latentsplat import render_full
from latentsplat_tpu_torch.training import step as tstep
from latentsplat_tpu_torch.training.trainer import Trainer
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_torch_switches_step import STEP, build, jax_step, model_cfg, port_step, torch_batch
from tests.test_torch_trainer import GAN
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

LOSSES = {
    "target_render_image": LossGroupCfg(nll=[LossCfg(name="mse", weight=1.0)]),
    "target_combined": LossGroupCfg(nll=[LossCfg(name="l1")]),
}


def latents_cfg():
    cfg = model_cfg(encode_latents=True, supersampling_factor=1)
    return dataclasses.replace(cfg, autoencoder=dataclasses.replace(cfg.autoencoder, latent_channels=2))


@pytest.fixture(scope="module")
def case():
    case = build(latents_cfg(), LOSSES)
    with pytest.MonkeyPatch.context() as mp:
        case["jax"] = jax_step(case, mp)
    case["port"] = port_step(case)
    return case


def test_encoder_takes_the_latents(case):
    # encode_latents wires the encoder's input width to the latent count and
    # its scale to supersampling / 1; no high-resolution skip (the feature
    # grid is the latent grid).
    model = case["state"].model
    assert model.encoder.backbone.Conv_0.in_channels == 2
    assert model.encoder.scale_factor == 1 and not hasattr(model.encoder, "high_resolution_skip")
    assert model.depth_noise_shape(torch_batch(case["batch"])["context"], torch.zeros(1, 2, 16, 16, 2)) == (
        1, 2, 256, 1, 2)


def test_step_matches_jax(case):
    # 1e-4 relative on the logs and the total, each gradient leaf to 2e-4
    # of its norm (leaves zero but for rounding to 1e-6 of the largest
    # norm): float32 rounding, as tests/test_torch_step.py.
    port, theirs = case["port"], case["jax"]
    np.testing.assert_allclose(port["total"], theirs["total"], rtol=1e-4)
    for key in sorted(set(theirs["logs"]) & set(port["logs"])):
        np.testing.assert_allclose(port["logs"][key], theirs["logs"][key], rtol=1e-4, atol=1e-6, err_msg=key)
    ours = {n: g.numpy() for n, g in port["grads"].items()}
    j = {n: t.numpy() for n, t in params_from_jax(theirs["grads"], case["state"].model).items()}
    # The render's losses reach the VAE encoder through the context latents.
    assert np.abs(ours["autoencoder.encoder.conv_in.weight"]).max() > 0
    floor = 1e-6 * max(np.linalg.norm(t) for t in j.values())
    for name in ours:
        np.testing.assert_allclose(ours[name], j[name], atol=2e-4 * np.linalg.norm(j[name]) + floor, err_msg=name)


def test_remat_with_latent_input_matches_plain(case):
    # The latents ride into the checkpointed encoder as an input; the
    # recomputation takes the same depth samples.
    state, losses = case["state"], case["t_losses"]
    flags = tstep.make_step_flags(losses, STEP)
    batch = torch_batch(case["batch"])
    noise = {k: torch.from_numpy(v) for k, v in case["noise"].items()}
    cfg = state.model.cfg
    cfg.remat = True
    try:
        grads, total, _, _ = tstep.generator_grads(state, losses, flags, batch, STEP, noise=noise)
    finally:
        cfg.remat = False
    assert float(total) == case["port"]["total"]
    for name, g in case["port"]["grads"].items():
        torch.testing.assert_close(grads[name], g, atol=1e-6 * float(g.abs().max()) + 1e-12, rtol=0, msg=name)


def test_deterministic_serving_matches_jax(case):
    # render_full with the posterior's mode as the encoder's input, against
    # the JAX Trainer._render_full: 1e-4 of each output's largest value.
    trainer = object.__new__(JaxTrainer)      # only what _render_full reads
    trainer.model = case["jmodel"]
    trainer._patch_multiple = 4
    trainer._apply_bounds = False
    trainer._near_disparity = 3.0
    jbatch = jax.tree_util.tree_map(jnp.asarray, case["batch"])
    theirs = trainer._render_full(case["params"]["generator"], jbatch, jax.random.PRNGKey(0), True)
    model = case["state"].model
    ours = render_full(model, torch_batch(case["batch"]), deterministic=True)
    for key in ("image", "render", "depth"):
        scale = float(np.abs(np.asarray(theirs[key])).max())
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), atol=1e-4 * scale, err_msg=key)


def test_trainer_test_times_the_vae_encoder(tmp_path):
    # One autoencoder_encoder entry per context view of each scene, as the
    # JAX trainer times it (one call per context view).
    cfg = tconfig.load_config(None, GAN + [
        "model.encode_latents=true", f"output_dir={tmp_path}", f"test.output_path={tmp_path}/test"])
    trainer = Trainer(cfg, tmp_path, device="cpu")
    trainer.test(trainer.model, name="latents")
    root = Path(cfg.test.output_path) / "latents"
    bench = json.loads((root / "benchmark.json").read_text())
    assert set(bench) == {"autoencoder_encoder", "encoder", "decoder", "autoencoder_decoder"}
    assert len(bench["encoder"]) == 6 and len(bench["autoencoder_encoder"]) == 6 * 2
    assert len(sorted(root.rglob("color/*.png"))) == len(bench["decoder"]) == 6 * 9
