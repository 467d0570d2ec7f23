"""The port's convergence script (latentsplat_tpu_torch.scripts.convergence)
on the CPU: its overfit batch against bench_convergence.overfit_batch bit
for bit, and a 3-step run of a narrow model through its `main`."""

import json
import math

import numpy as np
import pytest

from bench_convergence import overfit_batch as jax_overfit_batch
from latentsplat_tpu_torch.entry import SMALL_OVERRIDES
from latentsplat_tpu_torch.scripts import convergence
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("size", [32, 128])
def test_overfit_batch_is_bench_convergence_s(size):
    ours, theirs = convergence.overfit_batch(size), jax_overfit_batch(size)
    assert ours.keys() == theirs.keys()
    for side in theirs:
        assert ours[side].keys() == theirs[side].keys()
        for key, value in theirs[side].items():
            assert ours[side][key].dtype == value.dtype and ours[side][key].shape == value.shape, (side, key)
            np.testing.assert_array_equal(ours[side][key], value, err_msg=f"{side}/{key}")


def test_objective_follows_bench_convergence():
    cfg = convergence.load_config("re10k", convergence.objective_overrides(128, 3, 0.01))
    assert [(c.name, c.weight) for c in cfg.loss.gaussian.nll] == [("kl", 0.0001), ("sh_l2", 0.01)]
    assert [(c.name, c.weight) for c in cfg.loss.target_render_image.nll] == [("mse", 10), ("lpips", 0.5)]
    assert [c.name for c in cfg.loss.target_combined.nll] == ["l1", "lpips"]
    assert cfg.loss.target_combined.generator.weight == 0.5
    assert cfg.loss.target_combined.discriminator.loss == "hinge"
    assert not cfg.model.remat and not cfg.model.decoder.remat and cfg.model.decoder.precision == "exact"
    assert cfg.seed == 3 and cfg.dataset.image_shape == [128, 128]
    assert cfg.optimizer.generator.warm_up_steps == 50 and cfg.optimizer.generator.warm_up_start_factor == 0.1
    without = convergence.load_config("re10k", convergence.objective_overrides(256, 0, 0.0))
    assert [c.name for c in without.loss.gaussian.nll] == ["kl"] and without.model.remat


def test_convergence_runs_on_the_cpu(tmp_path):
    out = convergence.main(["--size", "32", "--steps", "3", "--seed", "1", "--sh-l2", "0.01",
                            "--out", str(tmp_path / "run" / "seed1.json"), *SMALL_OVERRIDES], device="cpu")
    record = json.loads(out.read_text())
    assert record["device"] == "cpu" and record["steps"] == 3 and record["sh_l2_weight"] == 0.01
    assert record["overrides"] == SMALL_OVERRIDES
    for key in ("initial_render_psnr", "final_render_psnr", "initial_combined_psnr", "final_combined_psnr",
                "max_abs_color_sh_largest", "max_abs_color_sh_final", "seconds_per_step_median",
                "seconds_per_step_mean", "first_step_seconds"):
        assert math.isfinite(record[key]), key
    assert record["nan_steps"] == [] and set(record["tf32"]) == {"cudnn", "matmul"}
    assert record["max_abs_color_sh_largest"] >= record["max_abs_color_sh_final"] > 0
    curves = record["curves"]
    assert curves["step"] == [0, 1, 2]
    for key in ("generator/total", "discriminator/total", "train/target_render/psnr", "train/target_combined/psnr",
                "target_render_image/mse", "target_render_image/lpips", "target_combined/l1",
                "target_combined/lpips", "gaussian/kl", "gaussian/sh_l2", "target_combined/adaptive_weight",
                "diag/max_abs_color_sh", "diag/max_world_scale", "diag/max_opacity", "diag/max_abs_feature_mean",
                "grad_norm/generator"):
        assert len(curves[key]) == 3 and all(math.isfinite(v) for v in curves[key]), key
    assert record["initial_render_psnr"] == curves["train/target_render/psnr"][0]
    assert record["final_render_psnr"] == curves["train/target_render/psnr"][-1]
