"""The port's bench scripts (latentsplat_tpu_torch.scripts.bench_*) against
the repository's root bench*.py on the CPU: bench_render's scene against
bench.make_scene for the same draws, a shrunk scene's render against the
JAX dense render, and the scripts run narrow through their `main`
(bench_render at both precisions, bench_train --fast,
bench_precision_knobs over every mode, the three stage benches).
tests/test_torch_bench_step.py holds bench_train's names and its narrow
step (the two files split one for the test workers)."""

import json
import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as jax_bench
from latentsplat_tpu.ops.rasterize import render as j_render
from latentsplat_tpu_torch.scripts import (
    bench_enc_stages,
    bench_precision_knobs,
    bench_render,
    bench_render_stages,
    bench_train,
    bench_train_stages,
)

from tests.test_torch_bench_step import DENSE, NARROW, ROOT
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

def test_make_scene_is_bench_make_scene(monkeypatch):
    # Full size (393,216 Gaussians), 4 views. The JAX draws are the port's
    # numpy draws, in bench.make_scene's order.
    n_views = 4
    monkeypatch.setattr(jax_bench, "N_VIEWS", n_views)
    draws = bench_render.scene_draws(np.random.default_rng(0), bench_render.GAUSSIANS_PER_PIXEL * 2 * 256 * 256)
    queue = {"normal": [draws["jitter"], draws["color_sh"], draws["feature_sh"]],
             "uniform": [draws["scale"], draws["opacity"]]}

    def fake(kind):
        def draw(key, shape=(), dtype=jnp.float32, *args, **kwargs):
            value = queue[kind].pop(0)
            assert value.shape == tuple(shape), (kind, value.shape, shape)
            return jnp.asarray(value)
        return draw

    monkeypatch.setattr(jax.random, "normal", fake("normal"))
    monkeypatch.setattr(jax.random, "uniform", fake("uniform"))
    theirs = {k: np.asarray(v) for k, v in jax_bench.make_scene(jax.random.PRNGKey(0)).items()}
    assert queue == {"normal": [], "uniform": []}
    ours = {k: v.numpy() for k, v in bench_render.make_scene(0, n_views=n_views).items()}
    assert ours.keys() == theirs.keys()
    assert ours["gaussian_means"].shape == (1, jax_bench.N_GAUSSIANS, 3)
    for key, value in theirs.items():
        assert ours[key].shape == value.shape and ours[key].dtype == value.dtype, key
        if key == "gaussian_means":
            # sin and cos round differently in the two libraries.
            np.testing.assert_allclose(ours[key], value, rtol=0, atol=1e-6 * np.abs(value).max())
        else:
            np.testing.assert_array_equal(ours[key], value, err_msg=key)


def test_shrunk_scene_renders_as_jax_dense():
    # 6,144 Gaussians (a 32x32 surface grid), 4 views at 64x64: the port's
    # tiled render (its kernels' plain versions on the CPU) against the JAX
    # dense render, at tests/test_rasterize.py's tiled-vs-dense tolerances.
    size = 64
    scene = bench_render.make_scene(0, side=32, n_views=4)
    ours = bench_render.render_scene(scene, size)
    j = {k: jnp.asarray(v.numpy()) for k, v in scene.items()}
    theirs = j_render(j["extrinsics"], j["intrinsics"], j["near"], j["far"], (size, size), j["background_color"],
                      j["gaussian_means"], j["gaussian_covariances"], j["gaussian_opacities"],
                      j["gaussian_color_sh"], j["gaussian_feature_sh"], backend="dense")
    assert int(ours.num_pairs.min()) > 1000
    for key, atol in (("color", 2e-4), ("feature", 2e-4), ("mask", 2e-4), ("depth", 2e-3)):
        a, b = getattr(ours, key).numpy(), np.asarray(getattr(theirs, key))
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=key)


def test_bench_render_runs_on_the_cpu(tmp_path, capsys):
    for name, unix, value in (("train_step_256px_b2.json", 100, 0.5), ("train_step_256px_b2_bf16.json", 200, 0.7)):
        (tmp_path / name).write_text(json.dumps({"metric": name[:-5], "value": value, "measured_unix": unix,
                                                 "train_mfu": 0.1, "device": "cpu"}))
    result = bench_render.main(["--side", "16", "--views", "2", "--size", "32", "--iters", "2", "--records",
                                str(tmp_path)], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "device: cpu" and json.loads(lines[-1]) == json.loads(json.dumps(result))
    assert result["metric"] == "render_256px_393k_gaussians_fwd" and result["unit"] == "views/sec/chip"
    # bench.py's keys: the headline is the fast render.
    assert result["value"] == result["value_fast"] > 0 and result["precision"] == "fast"
    assert result["value_exact"] > 0 and 30.0 < result["fast_vs_exact_psnr_db"] < 120.0
    assert result["views"] == 2 and result["gaussians"] == 6 * 16 * 16 and len(result["call_seconds"]) == 2
    assert len(result["call_seconds_exact"]) == 2 and result["pairs_per_view_mean_exact"] > 0
    assert result["pairs_per_view_mean"] > 0 and result["render_mfu"] is None
    assert result["render_flops_per_view"] > 0 and math.isfinite(result["render_flops_per_view"])
    assert result["train_step_steps_per_sec"] == 0.7 and result["train_step_config"] == "train_step_256px_b2_bf16"


def test_a_dropped_pair_fails_the_render_bench():
    scene = bench_render.make_scene(0, side=8, n_views=2)
    pairs = [bench_render.counted_pairs(scene, 32, i) for i in range(2)]
    bench_render.check_pairs(scene, 32, pairs)
    pairs[1][1] -= 1
    with pytest.raises(AssertionError, match="call 1"):
        bench_render.check_pairs(scene, 32, pairs)


def test_counted_operations():
    # 2 m n k for a product, one per element of a pointwise op, one per
    # input element of a reduction.
    a, b = torch.ones(4, 5), torch.ones(5, 3)
    assert bench_render.count_operations(lambda: (a @ b).exp().sum()) == 2 * 4 * 5 * 3 + 12 + 12


def test_bench_train_fast_runs_a_step_on_the_cpu(tmp_path, capsys):
    # --fast trains at model.decoder.precision=fast (the dense render here
    # takes its bf16 SH tables; tests/test_torch_fast.py holds the tiled
    # fast step against JAX).
    result = bench_train.main(["--fast", "--size", "32", "--iters", "1", "--out-dir", str(tmp_path), *DENSE],
                              device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metric"] == "train_step_32px_batch1_vae_gan_fast"
    assert result["precision"] == "fast" and "model.decoder.precision=fast" in result["overrides"]
    assert result["steps_run"] == 3 and all(math.isfinite(t) for t in result["generator_total"])
    assert json.loads((tmp_path / "train_step_32px_b1_fast.json").read_text())["precision"] == "fast"


def test_bench_precision_knobs_reports_every_mode(tmp_path, capsys):
    result = bench_precision_knobs.main(["--views", "2", "--side", "16", "--size", "32", "--out-dir", str(tmp_path)],
                                        device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "device: cpu" and json.loads(lines[-1]) == json.loads(json.dumps(result))
    assert list(result["knobs"]) == list(bench_precision_knobs.MODES)
    assert result["value"] == result["knobs"]["fast"]["color_psnr_db"]
    knobs = result["knobs"]
    # Knobs that change no value the colors show are exact; the others cost
    # some PSNR, fast (all of them) the most.
    for mode in ("exact_wide_cull", "exact_tie_depth", "exact_depth_val"):
        assert knobs[mode]["color_psnr_db"] == 120.0, mode
    assert knobs["exact_depth_val"]["depth_rel_err_max"] > 0
    for mode in ("exact_bf16_mm", "exact_q12_channels", "exact_f16_xy", "exact_bf16_conic", "exact_bf16_sh"):
        assert knobs["fast"]["color_psnr_db"] < knobs[mode]["color_psnr_db"] < 120.0, mode
    assert json.loads((tmp_path / "precision_knobs_psnr.json").read_text())["knobs"] == json.loads(json.dumps(knobs))


def printed_names(text: str) -> list:
    return re.findall(r"^(\w+_\w+)[ :]", text, flags=re.M)


def jax_stage_names(script: str, pattern: str) -> list:
    return re.findall(pattern, (ROOT / script).read_text())


@pytest.mark.parametrize("module, script, pattern, extra", [
    (bench_render_stages, "bench_render_stages.py", r'print\(f"(\w+_\w+)[ :]', []),
    (bench_enc_stages, "bench_enc_stages.py", r'print\(f"(\w+_\w+)[ :]', []),
    (bench_train_stages, "bench_train_stages.py", r'report\("(\w+)"', ["--out-dir"]),
], ids=["render", "enc", "train"])
def test_stage_benches_print_the_jax_scripts_stages(module, script, pattern, extra, tmp_path, capsys):
    argv = ["--size", "32", "--iters", "1", *([extra[0], str(tmp_path)] if extra else []),
            *(DENSE if module is bench_train_stages else NARROW)]
    out = module.main(argv, device="cpu")
    names = printed_names(capsys.readouterr().out)
    assert names == jax_stage_names(script, pattern)
    assert all(math.isfinite(ms) and ms > 0 for ms in out.values())
    if module is bench_train_stages:
        record = json.loads((tmp_path / "train_stages_32px_b2.json").read_text())
        assert list(record["components_ms"]) == names and record["device"] == "cpu"
