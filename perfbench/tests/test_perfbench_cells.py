"""Each cell's path end to end on the CPU at the tiny size, through the
harness's internals (run.execute, which skips only the look for a card):
a well-formed result line, the reference agreeing with the program, and
`correct` false under each fault the cell can have."""

from __future__ import annotations

import json

import pytest

from perfbench.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVE = [c for c in CELLS if "serve" in c]
# At the tiny size on the CPU both sides compute in float32 alike. A
# leaf's change over the first steps is a few float32 spacings of its
# values (Adam's first updates are near the warm-up's rate, 7.5e-8, for
# values near 1), so one rounding more or less moves its norm by ~1e-3.
AGREE = {"change_gap": 1e-2}
AGREE_DEFAULT = 1e-4


def is_line(line: dict) -> bool:
    """The contract's keys in order, `compared` last, and JSON throughout."""
    json.dumps(line)
    return list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "compared"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_the_reference_agrees(run_tiny, cell):
    line = run_tiny(cell)
    assert is_line(line)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    wanted = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == wanted
    assert line["compared"]
    assert all(c["value"] <= AGREE.get(name, AGREE_DEFAULT) for name, c in line["compared"].items())


def test_traced_run_reports_its_window(run_tiny):
    line = run_tiny(SERVE[0], trace=True)
    assert is_line(line) and line["correct"]
    assert line["device"]["window_s"] > 0 and set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _every_pixel(image):
    image += 0.05


def _the_last_view(image):
    image[:, -1] += 0.05


@pytest.mark.parametrize("alter", [_every_pixel, _the_last_view], ids=["every_pixel", "the_last_view"])
@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_answer_is_not_correct(run_tiny, monkeypatch, cell, alter):
    from latentsplat_tpu_torch.model import latentsplat

    render_full = latentsplat.render_full

    def altered(*args, **kwargs):
        out = render_full(*args, **kwargs)
        alter(out["image"])
        return out

    monkeypatch.setattr(latentsplat, "render_full", altered)
    line = run_tiny(cell)
    assert not line["correct"]
    assert line["compared"]["image_q90"]["value"] > line["compared"]["image_q90"]["limit"]


def test_a_generator_whose_render_is_altered_is_not_correct(run_tiny, monkeypatch):
    from perfbench import models

    build = models.program_train_state

    def altered(*args):
        cfg, state, step = build(*args)
        decoder = state.model.autoencoder.decoder
        skip = getattr(decoder, f"skip_conv_{len(decoder.cfg.block_out_channels) - 1}")

        def shift(module, inputs):
            render = inputs[0].clone()
            render[-1] += 0.1
            return (render, *inputs[1:])

        skip.register_forward_pre_hook(shift)
        return cfg, state, step

    monkeypatch.setattr(models, "program_train_state", altered)
    line = run_tiny("re10k.train")
    assert not line["correct"]
    assert line["compared"]["render_q90"]["value"] > line["compared"]["render_q90"]["limit"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(run_tiny, monkeypatch):
    from latentsplat_tpu_torch.training import optim

    monkeypatch.setattr(optim.ChainedAdam, "step", lambda self, grads, ok: None)
    line = run_tiny("re10k.train")
    assert not line["correct"] and line["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(run_tiny, monkeypatch):
    from perfbench import control, models

    build = models.program_train_state

    def halved(*args):
        cfg, state, step = build(*args)
        return cfg, state, control._half_batch(step)

    monkeypatch.setattr(models, "program_train_state", halved)
    line = run_tiny("re10k.train")
    assert not line["correct"]
    assert line["compared"]["render_q90"]["value"] > line["compared"]["render_q90"]["limit"]


def test_the_host_keeps_only_the_sample():
    from perfbench.serve import Sample

    sample = Sample(2**31 + 7, 3)
    for index in range(200):
        sample.offer(index, {"image": index})
    least = sorted(range(200), key=sample.priority.__getitem__)[:3]
    assert sorted(sample.outputs) == sorted(least)
