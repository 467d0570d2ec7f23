"""A tiny model for the harness's CPU tests: the flagship presets with the
dry run's narrow modules (a 2-layer ResNet trunk, a narrow epipolar
transformer, the f8 VAE at 16 channels) at 32x32, every loss of the preset
kept as it is."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

SIZE = 32
SEED = 2**31 + 12345


def tiny_config(bench: dict, cell: str) -> dict:
    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.entry import dryrun_overrides

    from perfbench import models, run

    name = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    config = run.load_json(run.ROOT / f"perfbench/configs/{name}.json")
    config["overrides"] = [o for o in dryrun_overrides(SIZE, SIZE) if not o.startswith("loss.")]
    cfg = load_config(config["preset"], config["overrides"])
    for block in models.RESOLVED:
        config[block] = models._jsonable(dataclasses.asdict(getattr(cfg, block)))
    config["model_input"] = {"image_shape": [SIZE, SIZE]}
    return config


@pytest.fixture
def run_tiny():
    """run_tiny(cell, trace=False) -> the result line of a 1-second run of
    `cell` at the tiny size on the CPU."""
    from perfbench import run

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)

    def go(cell: str, trace: bool = False) -> dict:
        return run.execute(bench, cell, SEED, 1.0, trace, torch.device("cpu"), tiny_config(bench, cell),
                           time.perf_counter())

    yield go
    torch.set_num_threads(threads)

