"""The port's entry point on the CPU: PNG output and layouts against the JAX
package's, checkpoints round-tripped bit for bit, a tiny fit -> resume ->
validate -> test run of the `Trainer`, `main` end to end, and the
deterministic validation image against the JAX `Trainer._render_full` with
the same weights."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from latentsplat_tpu.config import load_config as jax_load_config
from latentsplat_tpu.misc.image_io import save_image as jax_save_image
from latentsplat_tpu.training.trainer import Trainer as JaxTrainer
from latentsplat_tpu.training.trainer import strip_batch as jax_strip_batch
from latentsplat_tpu.visualization import layout as jax_layout
from latentsplat_tpu_torch.config import load_config
from latentsplat_tpu_torch.main import main, num_ranks
from latentsplat_tpu_torch.misc.benchmarker import Benchmarker
from latentsplat_tpu_torch.misc.image_io import decode_png, load_image, prep_image, save_image
from latentsplat_tpu_torch.training.checkpointing import (
    latest_checkpoint,
    load_checkpoint,
    load_generator_weights,
    resolve_checkpoint_uri,
    save_checkpoint,
)
from latentsplat_tpu_torch.training.trainer import Trainer, strip_batch, to_device
from latentsplat_tpu_torch.visualization import layout
from latentsplat_tpu_torch.visualization.annotation import add_label, draw_label
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_torch_data import TINY
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# The tiny trainer with a small KL autoencoder, a PatchGAN and the spike
# guard, so that a checkpoint holds every kind of state.
GAN = TINY + [
    "model.autoencoder={name: kl, block_out_channels: [8, 16], layers_per_block: 1, latent_channels: 2, "
    "skip_connections: true, pretrained: false}",
    "model.supersampling_factor=2",
    "model.discriminator={name: patch_gan, base_dim: 8, n_layers: 2, pretrained: false}",
    "optimizer.discriminator={name: Adam, lr: 9.0e-6}",
    "optimizer.generator.skip_loss_spike_factor=10.0",
]


def tiny_cfg(tmp_path, extra=()):
    return load_config(None, TINY + [f"output_dir={tmp_path}", f"test.output_path={tmp_path}/test", *extra])


# -- image output and layout -------------------------------------------------------


@pytest.mark.parametrize("shape", [(17, 23, 3), (8, 5), (6, 9, 1), (4, 4, 4)])
def test_png_pixels_match_jax(tmp_path, shape):
    image = np.random.default_rng(0).uniform(-0.2, 1.2, shape).astype(np.float32)
    save_image(image, tmp_path / "port.png")
    jax_save_image(image, tmp_path / "jax.png")
    with Image.open(tmp_path / "port.png") as ours, Image.open(tmp_path / "jax.png") as theirs:
        assert ours.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs.convert("RGB")))
    np.testing.assert_array_equal(load_image(tmp_path / "port.png"), prep_image(image) / np.float32(255.0))


def test_png_reader_refuses_other_forms(tmp_path):
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(tmp_path / "gray.png")
    with pytest.raises(ValueError, match="8-bit RGB"):
        decode_png((tmp_path / "gray.png").read_bytes())
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


@pytest.mark.parametrize("align", ["start", "center", "end"])
@pytest.mark.parametrize("gap", [0, 3])
def test_hcat_vcat_match_jax(align, gap):
    rng = np.random.default_rng(1)
    images = [rng.uniform(0, 1, s).astype(np.float32) for s in ((5, 7, 3), (9, 4), (3, 6, 1))]
    for ours, theirs in ((layout.hcat, jax_layout.hcat), (layout.vcat, jax_layout.vcat)):
        np.testing.assert_array_equal(
            ours(*images, align=align, gap=gap, gap_color=0.25),
            theirs(*images, align=align, gap=gap, gap_color=0.25),
        )


@pytest.mark.parametrize("color", [1.0, (0.1, 0.5, 0.9)])
def test_add_border_matches_jax(color):
    image = np.random.default_rng(2).uniform(0, 1, (6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(layout.add_border(image, 3, color), jax_layout.add_border(image, 3, color))


def test_label_sits_above_the_image():
    image = np.full((10, 300, 3), 0.5, np.float32)
    label = draw_label("Ground Truth", font_size=24)
    labelled = add_label(image, "Ground Truth")
    assert labelled.shape == (label.shape[0] + 4 + 10, 300, 3)
    np.testing.assert_array_equal(labelled[-10:], image)
    assert (label == 0.0).any() and (label == 1.0).any()   # black glyphs on white


def test_benchmarker_tags_and_memory(tmp_path):
    bench = Benchmarker()
    out = bench.time_fn("decoder", lambda x: x + 1, torch.ones(3), num_calls=4)
    assert torch.equal(out, torch.full((3,), 2.0))
    assert len(bench.execution_times["decoder"]) == 4
    bench.dump(tmp_path / "benchmark.json")
    bench.dump_memory(tmp_path / "peak_memory.json")
    assert set(json.loads((tmp_path / "benchmark.json").read_text())) == {"decoder"}
    assert json.loads((tmp_path / "peak_memory.json").read_text()) == {}   # no CUDA device here


# -- checkpoints ----------------------------------------------------------------------


def randomize(state, seed):
    """Fill every tensor a checkpoint holds with seeded random values."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in (state.model, state.discriminator, state.lpips):
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        for opt in (state.opt_gen, state.opt_disc):
            for group in opt.state.values():
                group["count"] = torch.randint(0, 10**6, (), generator=gen, dtype=torch.int32)
                for key in ("mu", "nu"):
                    group[key] = {n: torch.randn(t.shape, generator=gen) for n, t in group[key].items()}
    state.gen_loss_ema = torch.rand((), generator=gen)
    state.spike_skip_count = torch.tensor(3, dtype=torch.int32)


def flat(state):
    out = {f"generator.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"discriminator.{k}": v for k, v in state.discriminator.state_dict().items()})
    out.update({f"lpips.{k}": v for k, v in state.lpips.state_dict().items()})
    for label, opt in (("opt_gen", state.opt_gen), ("opt_disc", state.opt_disc)):
        for group, values in opt.state.items():
            out[f"{label}.{group}.count"] = values["count"]
            for key in ("mu", "nu"):
                out.update({f"{label}.{group}.{key}.{n}": t for n, t in values[key].items()})
    out["gen_loss_ema"], out["spike_skip_count"] = state.gen_loss_ema, state.spike_skip_count
    return out


def test_checkpoint_round_trip_is_exact(tmp_path):
    cfg = load_config(None, GAN + [f"output_dir={tmp_path}"])
    state = Trainer(cfg, tmp_path / "a", device="cpu").init_state()
    assert set(state.opt_gen.state) == {"rest", "autoencoder"} and set(state.opt_disc.state) == {"discriminator"}
    randomize(state, 0)
    path = save_checkpoint(state, tmp_path / "ckpt", 1234)
    assert path.name == "step_00001234" and latest_checkpoint(tmp_path / "ckpt") == path
    assert (tmp_path / "ckpt" / "latest").read_text() == "step_00001234"

    resumed = Trainer(
        load_config(None, GAN + [f"checkpointing.load={path}", "checkpointing.resume=true"]), tmp_path / "b",
        device="cpu",
    )
    restored = resumed.init_state()
    assert resumed.step == 1234
    ours, theirs = flat(restored), flat(state)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype and torch.equal(ours[key], value), key


def test_load_generator_weights_keeps_fresh_values_for_missing_keys(tmp_path):
    cfg = load_config(None, GAN + [f"output_dir={tmp_path}"])
    state = Trainer(cfg, tmp_path / "a", device="cpu").init_state()
    randomize(state, 1)
    path = save_checkpoint(state, tmp_path / "ckpt", 7)
    saved = torch.load(path, weights_only=True)
    missing = "encoder.to_gaussians.bias"
    del saved["generator"][missing]
    torch.save(saved, path)

    fresh = Trainer(cfg, tmp_path / "b", device="cpu")
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    load_generator_weights(path, fresh.model)
    after = fresh.model.state_dict()
    assert torch.equal(after[missing], before[missing])
    for key, value in saved["generator"].items():
        assert torch.equal(after[key], value), key
    assert resolve_checkpoint_uri(str(path)) == path
    with pytest.raises(NotImplementedError):
        resolve_checkpoint_uri("wandb://run:v1")


# -- a tiny run of the Trainer --------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    cfg = tiny_cfg(out)
    trainer = Trainer(cfg, out, device="cpu")
    state = trainer.fit()
    return cfg, trainer, state, out


def test_fit_produces_finite_losses(tiny_run):
    _, trainer, _, out = tiny_run
    records = [json.loads(line) for line in (out / "local" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["generator/total"]) and r["steps_per_sec"] > 0 for r in records)
    assert trainer.step == 3


def test_checkpoints_written(tiny_run):
    _, _, _, out = tiny_run
    names = sorted(p.name for p in (out / "checkpoints").glob("step_*"))
    assert names == ["step_00000002", "step_00000003"]
    assert latest_checkpoint(out / "checkpoints").name == "step_00000003"
    assert load_checkpoint(out / "checkpoints" / "step_00000002")["step"] == 2


def test_resume_from_checkpoint(tiny_run, tmp_path):
    cfg, _, state, out = tiny_run
    ckpt = out / "checkpoints" / "step_00000003"
    trainer = Trainer(
        tiny_cfg(tmp_path, [f"checkpointing.load={ckpt}", "checkpointing.resume=true", "trainer.max_steps=4"]),
        tmp_path, device="cpu",
    )
    resumed = trainer.fit()
    assert trainer.step == 4
    assert (tmp_path / "checkpoints" / "step_00000004").exists()
    records = [json.loads(line) for line in (tmp_path / "local" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [4] and np.isfinite(records[0]["generator/total"])
    assert int(resumed.opt_gen.state["rest"]["count"]) == 4


def test_validate(tiny_run):
    _, trainer, state, out = tiny_run
    metrics = trainer.validate(state, step=3)
    assert set(metrics) == {"val/psnr_probabilistic", "val/psnr_deterministic"}
    assert all(np.isfinite(v) for v in metrics.values())
    grid = load_image(out / "local" / "comparison" / "000003.png")
    assert grid.shape[1] > 32 and grid.shape[0] > 3 * 32


def test_test_renders_and_benchmark(tiny_run):
    cfg, trainer, state, _ = tiny_run
    trainer.test(state, name="tiny")
    root = Path(cfg.test.output_path) / "tiny"
    pngs = sorted(root.rglob("color/*.png"))
    # 6 scenes; the bounded sampler's test stage takes every frame from 0
    # to the right context view (6) plus the target gap (2).
    assert len(pngs) == 6 * 9
    assert load_image(pngs[0]).shape == (32, 32, 3)
    assert all(p.parent.parent.name == "0_6" for p in pngs)
    bench = json.loads((root / "benchmark.json").read_text())
    assert set(bench) == {"encoder", "decoder", "autoencoder_decoder"}
    assert len(bench["encoder"]) == 6 and len(bench["decoder"]) == len(bench["autoencoder_decoder"]) == 6 * 9
    assert (root / "peak_memory.json").exists()


def test_main_end_to_end(tmp_path):
    base = [f"output_dir={tmp_path}", f"test.output_path={tmp_path}/test", "trainer.max_steps=1"]
    run = main(TINY + base, device="cpu")
    assert (tmp_path / "latest-run").resolve() == run.resolve()
    ckpt = run / "checkpoints" / "step_00000001"
    assert ckpt.exists() and list((tmp_path / "test" / "latentsplat_tpu").rglob("*.png"))

    index = tmp_path / "index.json"
    index.write_text(json.dumps({"synthetic_0001": {"context": [2, 9], "target": [3, 5, 8]}}))
    evaluation = f"dataset.view_sampler={{name: evaluation, index_path: {index}}}"
    main(TINY + base + ["mode=test", f"checkpointing.load={ckpt}", "wandb.name=eval", evaluation], device="cpu")
    pngs = sorted(p.name for p in (tmp_path / "test" / "eval" / "synthetic_0001" / "2_9" / "color").glob("*.png"))
    assert pngs == ["000003.png", "000005.png", "000008.png"]
    assert set(json.loads((tmp_path / "test" / "eval" / "benchmark.json").read_text())) == {
        "encoder", "decoder", "autoencoder_decoder"}

    run = main(TINY + base + ["mode=val", f"checkpointing.load={ckpt}"], device="cpu")
    record = json.loads((run / "local" / "metrics.jsonl").read_text().splitlines()[-1])
    assert np.isfinite(record["val/psnr_deterministic"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the message given where there is no CUDA device")
def test_command_line_without_cuda_exits_with_a_message():
    result = subprocess.run(
        [sys.executable, "-m", "latentsplat_tpu_torch.main", "+experiment=re10k", "mode=train"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert result.returncode != 0
    assert "no CUDA device" in result.stderr


def test_unported_options_name_their_roadmap_item(tmp_path):
    # trainer.num_devices > 1 trains data-parallel now (tests/test_torch_parallel.py);
    # asking for more cards than are visible raises, naming both counts.
    cfg = tiny_cfg(tmp_path, ["trainer.num_devices=9"])
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"num_devices=9 asks for more cards than the {visible} visible"):
        num_ranks(cfg, None)
    assert num_ranks(cfg, "cpu") == 9
    assert num_ranks(tiny_cfg(tmp_path, ["trainer.num_devices=null"]), "cpu") == 1



# -- the deterministic validation image against JAX -----------------------------------


def test_validation_image_matches_jax(tmp_path):
    # The tiny trainer's val batch and the JAX trainer's generator weights
    # (mapped with params_from_jax); no sampling. The JAX side renders with
    # the dense backend, the port with its tiled one (plain kernel versions
    # on the CPU); 2e-3 is the render tolerance of tests/test_torch_slice.py.
    cfg = tiny_cfg(tmp_path)
    ours = Trainer(cfg, tmp_path / "port", device="cpu")
    theirs = JaxTrainer(jax_load_config(None, TINY + ["model.decoder.backend=dense"]), tmp_path / "jax")
    raw = next(ours._loader("val", 1, repeat=False))
    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_strip_batch(raw))
    params = theirs.model.init_params(jax.random.PRNGKey(cfg.seed), theirs.data_shim(jbatch))["generator"]
    ours.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.array, params), ours.model), strict=True)

    out = ours._render_full(ours.model, to_device(strip_batch(raw), CPU), None, True)
    ref = theirs._render_full(params, jbatch, jax.random.PRNGKey(cfg.seed + 2), True)
    assert out["image"].shape == (1, 1, 32, 32, 3)
    np.testing.assert_allclose(out["target_shim"].numpy(), np.asarray(ref["target_shim"]), rtol=0, atol=0)
    err = np.abs(out["image"].numpy() - np.asarray(ref["image"])).max()
    print(f"max abs error of the validation image: {err:.3e}")
    np.testing.assert_allclose(out["image"].numpy(), np.asarray(ref["image"]), rtol=0, atol=2e-3)
