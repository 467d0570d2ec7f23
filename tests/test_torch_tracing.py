"""The program's spans (latentsplat_tpu_torch/misc/profiler.py) on the CPU:
off outside a torch.profiler session (one shared no-op, no record); on
inside one, the span tree of a tiny `render_full`, train step and
`Trainer.test` (names, parents, one root a call), each stage name once a
call in the Chrome trace with and without `timer=record_function`, a
caller's timer given the stage names only, a timer that fails on entry
leaving no span open, a span on another thread adopting the open one as
its parent, the ring's bound, and the device interval equal to the host's
on the CPU where a span keeps one."""

from __future__ import annotations

import json
import threading
from collections import Counter, deque
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from latentsplat_tpu_torch.config import load_config
from latentsplat_tpu_torch.entry import arc_batch, dryrun_overrides, flagship_model, to_tensors
from latentsplat_tpu_torch.loss.losses import LossGroup
from latentsplat_tpu_torch.misc import profiler
from latentsplat_tpu_torch.model.latentsplat import render_full
from latentsplat_tpu_torch.training.step import GROUP_NAMES, make_train_step
from latentsplat_tpu_torch.training.trainer import Trainer, init_train_state

from tests.test_torch_data import TINY
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SIZE = 32
SERVE_STAGES = ("encoder", "decoder", "autoencoder_decoder")
TRAIN_STAGES = ("generator_forward", "generator_backward", "generator_update", "discriminator")
RENDER = ("render.shade", "render.cull", "render.sort", "render.composite")
ENCODER = ("encoder.backbone", "encoder.epipolar", "encoder.gaussians")


@pytest.fixture(scope="module")
def tiny():
    """(cfg, the tiny flagship generator, a batch of 2 context and 2 target
    views at 32x32) on the CPU."""
    cfg, model = flagship_model(dryrun_overrides(SIZE, SIZE), "cpu")
    return cfg, model.eval(), to_tensors(arc_batch(1, 2, 2, SIZE, SIZE), "cpu")


def serve(tiny, timer=None):
    _, model, batch = tiny
    return render_full(model, batch, generator=torch.Generator().manual_seed(0), timer=timer)


def traced(fn, tmp_path: Path | None = None):
    """(fn's records, the user annotations of its Chrome trace) under a CPU
    torch.profiler session."""
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = []
    if tmp_path is not None:
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    return profiler.records(), names


def tree(records) -> dict:
    """{name: parent's name} of one call's records but its host reads (each
    name once; every host read inside a span of the call)."""
    by_id = {s.id: s for s in records}
    reads = [s for s in records if s.name.startswith("host_read.")]
    assert reads and all(s.parent in by_id for s in reads)
    named = [s for s in records if s not in reads]
    assert len({s.name for s in named}) == len(named)
    return {s.name: by_id[s.parent].name if s.parent is not None else None for s in named}


def test_off_a_span_is_the_shared_no_op_and_keeps_nothing(tiny):
    profiler.clear()
    assert profiler.span("x") is profiler.span("y") is profiler.span("z", record_function)
    assert profiler.host_read("x") is profiler.span("x", interval=False) is profiler.span("x")
    assert profiler.annotate("x") is profiler.span("x")
    serve(tiny)
    serve(tiny, timer=record_function)
    assert profiler.records() == []


def test_the_span_tree_of_a_served_call(tiny):
    records, _ = traced(lambda: serve(tiny))
    assert tree(records) == {
        "render_full": None, **{s: "render_full" for s in SERVE_STAGES}, **{s: "encoder" for s in ENCODER},
        **{s: "decoder" for s in RENDER},
    }
    assert {s.root for s in records} == {records[0].id} and records[0].name == "render_full"
    assert all(s.end_ns >= s.start_ns for s in records)


def test_the_span_tree_of_a_train_step():
    cfg, model = flagship_model(dryrun_overrides(SIZE, SIZE), "cpu")
    state = init_train_state(cfg, model.train(), torch.device("cpu"), 1, seed=0)
    losses = {name: LossGroup(name, getattr(cfg.loss, name)) for name in GROUP_NAMES}
    train_step = make_train_step(losses)
    batch = to_tensors(arc_batch(1, 2, 2, SIZE, SIZE), "cpu")
    generator = torch.Generator().manual_seed(0)
    records, _ = traced(lambda: [train_step(state, batch, step, generator=generator) for step in range(2)])
    roots = [s for s in records if s.parent is None]
    assert [s.name for s in roots] == ["train_step", "train_step"]
    for root in roots:
        call = [s for s in records if s.root == root.id]
        parents = tree(call)
        assert parents == {
            "train_step": None, **{s: "train_step" for s in TRAIN_STAGES},
            **{s: "generator_forward" for s in ENCODER}, **{s: "generator_forward" for s in RENDER},
        }


@pytest.mark.parametrize("timer", [None, record_function], ids=["no_timer", "record_function"])
def test_each_stage_is_one_annotation_a_call(tiny, tmp_path, timer):
    records, names = traced(lambda: [serve(tiny, timer) for _ in range(2)], tmp_path)
    counts = Counter(names)
    for name in ("render_full", *SERVE_STAGES, *ENCODER, *RENDER):
        assert counts[name] == 2, name
    assert Counter(s.name for s in records) == {k: counts[k] for k in {s.name for s in records}}


def test_a_callers_timer_gets_the_stage_names_only(tiny):
    for on in (False, True):
        got = []

        def timer(name):
            got.append(name)
            return torch.autograd.profiler.record_function(f"timed {name}")

        if on:
            traced(lambda: serve(tiny, timer))
        else:
            serve(tiny, timer)
        assert got == list(SERVE_STAGES)


def test_a_span_on_another_thread_adopts_the_open_one():
    def work():
        with profiler.span("on_another_thread"):
            pass

    def fn():
        with profiler.span("caller"):
            thread = threading.Thread(target=work)
            thread.start()
            thread.join(timeout=30)
            assert not thread.is_alive()

    records, _ = traced(fn)
    caller, other = sorted(records, key=lambda s: s.start_ns)
    assert (caller.name, other.name) == ("caller", "on_another_thread")
    assert other.parent == caller.id and other.root == caller.id and other.thread != caller.thread


def test_each_thread_keeps_the_newest_ring_of_spans(monkeypatch):
    monkeypatch.setattr(profiler, "_ring", deque(maxlen=8))

    def work():
        for i in range(20):
            with profiler.span(f"span_{i}"):
                pass

    def fn():
        thread = threading.Thread(target=work)
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()

    records, _ = traced(fn)
    assert [s.name for s in records] == [f"span_{i}" for i in range(12, 20)]


def test_on_the_cpu_the_device_interval_is_the_host_interval(tiny):
    records, _ = traced(lambda: serve(tiny))
    without = [s for s in records if s.name == "render_full" or s.name.startswith("host_read.")]
    assert without and all(s.device_ms is None for s in without)
    kept = [s for s in records if s not in without]
    assert {s.name for s in kept} == {*SERVE_STAGES, *ENCODER, *RENDER}
    assert all(s.device_ms == s.host_ms > 0 for s in kept)


def test_a_timer_that_fails_on_entry_leaves_no_span_open():
    def failing(name):
        raise RuntimeError(f"no timer for {name}")

    def fn():
        with pytest.raises(RuntimeError, match="no timer for stage"):
            with profiler.span("stage", failing):
                pass
        with profiler.span("next"):
            pass

    records, _ = traced(fn)
    stage, after = records
    assert (stage.name, after.name) == ("stage", "next")
    assert stage.end_ns is not None and after.parent is None and after.root == after.id


def test_a_test_request_holds_render_full_and_the_writes(tmp_path):
    cfg = load_config(None, TINY + [f"output_dir={tmp_path}", f"test.output_path={tmp_path}/test"])
    trainer = Trainer(cfg, tmp_path, device="cpu")
    records, _ = traced(lambda: trainer.test(trainer.model, name="tiny"))
    requests = [s for s in records if s.name == "test_request"]
    scenes = [p for p in (tmp_path / "test" / "tiny").iterdir() if p.is_dir()]
    assert len(requests) == len(scenes) > 0
    for request in requests:
        parents = tree([s for s in records if s.root == request.id])
        assert parents["test_request"] is None
        assert parents["render_full"] == parents["test_request.write"] == "test_request"
