"""The port's entry points (latentsplat_tpu_torch.entry) against the root
__graft_entry__.py on the CPU: arc_batch bit for bit, flagship_model's
config field by field, the dry run's overrides and one dry run on two CPU
ranks. entry()'s forward is held against __graft_entry__.entry() in
tests/test_torch_flagship.py."""

import ast
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from latentsplat_tpu_torch import entry
from latentsplat_tpu_torch.entry import SMALL_OVERRIDES as SMALL
from latentsplat_tpu_torch.scripts import bench_train

from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("args", [(1, 2, 2, 64, 64, 0), (2, 2, 1, 32, 32, 3), (3, 1, 4, 16, 24, 7),
                                  (2, 2, 4, 256, 256, 0)])
def test_arc_batch_is_graft_entry_s(args):
    ours, theirs = entry.arc_batch(*args), graft._arc_batch(*args)
    assert ours.keys() == theirs.keys()
    for side in theirs:
        assert ours[side].keys() == theirs[side].keys()
        for key, value in theirs[side].items():
            assert ours[side][key].dtype == value.dtype, (side, key)
            np.testing.assert_array_equal(ours[side][key], value, err_msg=f"{side}/{key}")


def bench_train_lists():
    """bench_train's override lists for the flag combinations the chip run
    measures, and two more."""
    argvs = [[], ["--full", "--batch", "2"], ["--full", "--batch", "2", "--bf16"],
             ["--full", "--remat-policy", "dots", "--no-decoder-remat"], ["--compute", "encoder:bfloat16"]]
    return [bench_train.train_overrides(bench_train.parse_args(a)) for a in argvs]


@pytest.mark.parametrize("overrides", [[], *bench_train_lists()], ids=["none", "default", "full_b2", "full_b2_bf16",
                                                                       "dots_keepres", "compute"])
def test_flagship_model_config_is_graft_entry_s(overrides):
    ours = entry.flagship_config(overrides)
    theirs, _ = graft._flagship_model(list(overrides))
    for section in ("model", "dataset", "loss", "optimizer", "train"):
        assert dataclasses.asdict(getattr(ours, section)) == dataclasses.asdict(getattr(theirs, section)), section


def test_flagship_model_draws_its_weights_from_the_seed():
    (_, a), (_, b), (_, c) = (entry.flagship_model(SMALL, "cpu", seed=s) for s in (0, 0, 1))
    assert a.training and next(a.parameters()).device.type == "cpu"
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)


def graft_dryrun_overrides(h, w):
    """The literal list of __graft_entry__.dryrun_multichip (local to the
    function), evaluated at (h, w)."""
    source = Path(graft.__file__).read_text()
    fn = next(n for n in ast.parse(source).body if isinstance(n, ast.FunctionDef) and n.name == "dryrun_multichip")
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "overrides")
    return eval(compile(ast.Expression(node.value), "__graft_entry__.py", "eval"), {"h": h, "w": w})


def test_dryrun_overrides_are_graft_entry_s():
    assert entry.dryrun_overrides(32, 32) == graft_dryrun_overrides(32, 32)
    assert entry.dryrun_overrides(16, 48) == graft_dryrun_overrides(16, 48)


def test_dryrun_multichip_on_two_cpu_ranks(monkeypatch):
    # The ranks share the test worker's cores; more threads only contend.
    # dryrun_multichip raises unless every log is finite and the two ranks
    # hold the same bits after the step; its spawn has a join limit.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert entry.DRYRUN_JOIN_S <= 600
    logs = entry.dryrun_multichip(2, device="cpu")
    assert math.isfinite(logs["generator/total"]) and math.isfinite(logs["discriminator/total"])
    assert 0.0 <= logs["target_combined/adaptive_weight"] <= 1.0


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)
    with pytest.raises(SystemExit, match="device='cpu'"):
        bench_train.main(["--iters", "1"])
