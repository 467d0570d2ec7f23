"""The readers of the program's own spans (perfbench/spans.py): a traced
run of each cell at the tiny size on the CPU reports each of its span
metrics as a finite number, and the helper finds a window's units by their
root spans and reads nothing where the program keeps no records, or a
span no stream interval."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest

from perfbench import spans
from perfbench.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def span_metrics(cell: str) -> list:
    """The cell's per-layer metrics whose reader reads the program's spans."""
    return [m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]
            and "spans.per_unit" in (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").read_text()]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_each_span_metric(run_tiny, cell):
    wanted = span_metrics(cell)
    assert wanted
    line = run_tiny(cell, trace=True)
    assert line["correct"]
    for name in wanted:
        assert math.isfinite(line["metrics"][name]["value"]), name


def _span(name, id, parent, start, host_ms):
    return SimpleNamespace(name=name, id=id, parent=parent, start_ns=start, host_ms=host_ms, device_ms=2 * host_ms)


def test_the_units_are_the_newest_roots_with_their_subtrees(monkeypatch):
    records = [
        _span("render_full", 1, None, 0, 9.0),          # before the window
        _span("host_read.pair_totals", 2, 1, 1, 5.0),
        _span("render_full", 3, None, 10, 9.0),
        _span("host_read.pair_totals", 4, 3, 11, 1.0),
        _span("render_full", 5, None, 20, 9.0),
        _span("decoder", 6, 5, 21, 4.0),
        _span("host_read.pair_totals", 7, 6, 22, 2.0),
        _span("host_read.covering_cap", 8, 6, 23, 3.0),
    ]
    monkeypatch.setattr(spans, "_records", lambda: records)
    summary = {"units": 2}
    assert [[s.id for s in tree] for tree in spans.units(summary, "render_full")] == [[3, 4], [5, 6, 8, 7]]
    assert spans.per_unit(summary, "render_full", "host_read.*", "count") == 1.5
    assert spans.per_unit(summary, "render_full", "host_read.*", "host_ms") == 3.0
    assert spans.per_unit(summary, "render_full", "decoder", "device_ms") == 4.0
    assert spans.per_unit(summary, "render_full", "encoder", "device_ms") == 0.0
    assert spans.per_unit({"units": 4}, "render_full", "decoder", "host_ms") is None
    records[6].device_ms = None
    assert spans.per_unit(summary, "render_full", "host_read.*", "device_ms") is None
    assert spans.per_unit({}, "render_full", "decoder", "host_ms") is None
    with pytest.raises(ValueError, match="value must be one of"):
        spans.per_unit(summary, "render_full", "decoder", "seconds")


def test_a_program_without_records_reads_none(monkeypatch):
    from latentsplat_tpu_torch.misc import profiler

    monkeypatch.delattr(profiler, "records")
    assert spans.per_unit({"units": 1}, "render_full", "decoder", "device_ms") is None
