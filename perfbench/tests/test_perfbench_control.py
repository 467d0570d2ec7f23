"""The comparison's control on the card, at each cell's own size: the
reference one precision lower (bfloat16 autocast) in the program's place
fails at least one of the cell's limits, and the program passes them all.

Needs a CUDA card; run there with

    python -m pytest -p no:cacheprovider perfbench/tests/test_perfbench_control.py
"""

from __future__ import annotations

import json

import pytest
import torch

from perfbench.run import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**32 + 17


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_and_the_program_passes(card, cell):
    from perfbench import control

    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    readings = control.readings(cell, SEED)
    assert all(readings["program"][n] <= v["limit"] for n, v in limits.items()), readings
    assert any(readings["control"][n] > v["limit"] for n, v in limits.items()), readings
