"""The port's bench_train (latentsplat_tpu_torch.scripts.bench_train) against
the repository's root bench_train.py on the CPU: its overrides and metric
names against bench_train.py's, and one narrow step through its `main`;
the trace's self times. tests/test_torch_bench_scripts.py holds the other
bench scripts (the two files split one for the test workers)."""

import ast
import json
import math
from pathlib import Path

import pytest

from latentsplat_tpu_torch.entry import SMALL_OVERRIDES as SMALL
from latentsplat_tpu_torch.scripts import bench_train, bench_trace_step

from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
# SMALL with one Gaussian a pixel: the plain compositor on the CPU walks
# each tile's pairs one by one. The runs through a whole step also render
# with the dense backend (the tiled path is held above and in
# tests/test_torch_step*.py).
NARROW = [*SMALL, "model.encoder.gaussians_per_pixel=1"]
DENSE = [*NARROW, "model.decoder.backend=dense"]


def jax_bench_train_names():
    """bench_train.py's `overrides` list, `variant` and result "metric" as
    expressions of its flags, read with ast from its main()."""
    fn = next(n for n in ast.parse((ROOT / "bench_train.py").read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    assigns = {n.targets[0].id: n.value for n in ast.walk(fn)
               if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)}
    metric = next(v for k, v in zip(assigns["result"].keys, assigns["result"].values) if k.value == "metric")
    return {name: compile(ast.Expression(node), "bench_train.py", "eval")
            for name, node in (("overrides", assigns["overrides"]), ("variant", assigns["variant"]),
                               ("metric", metric))}


FLAGS = [[], ["--bf16"], ["--fast"], ["--fast", "--full", "--bf16"], ["--full", "--batch", "2"],
         ["--full", "--batch", "2", "--bf16"],
         ["--full", "--batch", "2", "--bf16", "--remat-policy", "dots"],
         ["--compute", "encoder:bfloat16,vae:bfloat16"],
         ["--full", "--no-decoder-remat", "--remat-policy", "vae:off,lpips:off"]]


@pytest.mark.parametrize("argv", FLAGS, ids=lambda a: " ".join(a) or "default")
def test_bench_train_names_and_overrides_are_bench_train_s(argv):
    args = bench_train.parse_args(argv)
    flags = {"full": args.full, "size": args.size, "batch": args.batch, "fast": args.fast, "bf16": args.bf16,
             "compute": args.compute, "remat_policy": args.remat_policy, "no_dec_remat": args.no_decoder_remat}
    jax_exprs = jax_bench_train_names()
    flags["variant"] = eval(jax_exprs["variant"], {}, dict(flags))
    assert bench_train.metric_name(args) == eval(jax_exprs["metric"], {}, flags)
    assert bench_train.train_overrides(args) == eval(jax_exprs["overrides"], {}, flags)
    if argv == FLAGS[6]:
        assert bench_train.metric_name(args) == "train_step_256px_batch2_vae_gan_bf16_dots"


def test_bench_train_runs_one_step_on_the_cpu(tmp_path, capsys):
    result = bench_train.main(["--size", "32", "--iters", "1", "--out-dir", str(tmp_path), *DENSE], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "device: cpu" and json.loads(lines[-1])["metric"] == "train_step_32px_batch1_vae_gan"
    assert math.isfinite(result["value"]) and result["value"] > 0 and result["unit"] == "steps/sec/chip"
    assert result["train_flops_per_step"] > 0 and result["train_mfu"] is None and result["peak_gib"] is None
    assert result["steps_run"] == 3 and all(math.isfinite(t) for t in result["generator_total"])
    written = json.loads((tmp_path / "train_step_32px_b1.json").read_text())
    assert written["metric"] == result["metric"] and written["measured_unix"] > 0


def test_trace_step_self_times_fit_in_the_wall_time(capsys):
    result = bench_trace_step.main(["--size", "32", "--top", "5", *DENSE], device="cpu")
    printed = capsys.readouterr().out
    assert 0 < result["self_ms"] <= result["wall_ms"] and result["events"] > 0
    assert len(result["top"]) == 5 and all(ms > 0 for _, ms, _ in result["top"])
    assert result["top"] == sorted(result["top"], key=lambda row: -row[1])
    assert f"x{result['top'][0][2]:<5d} {result['top'][0][0][:100]}" in printed


def test_self_times_subtract_children():
    def event(name, ts, dur, tid=1, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}

    trace = {"traceEvents": [event("outer", 0, 10), event("inner.1", 2, 3), event("inner.2", 6, 2),
                             event("other", 0, 4, tid=2), event("host", 0, 50, cat="cpu_op")]}
    assert bench_trace_step.self_times(trace) == {"outer": [5.0, 1], "inner": [5.0, 2], "other": [4.0, 1]}
