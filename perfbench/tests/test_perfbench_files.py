"""BENCHMARK.json and the files it names: every configuration, traffic mix,
limit and per-layer metric loads, and every name and unit keeps to the
allowed characters."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all("/" not in w or w.startswith("perfbench") for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_to_the_contract(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= KEYS[section], (e["name"], set(e) - KEYS[section])
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_a_cell_names_loads():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert config["name"] == w["config"] and config["reduced"] == configs[w["config"]]["reduced"] == []
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert traffic["kind"] in ("serve", "train")
        limits = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
        assert all(v["limit"] > 0 for v in limits.values())
        assert json.loads((HERE / "flops" / f"{w['name']}.json").read_text())["flops"] > 0


def test_each_configuration_is_used_and_the_program_loads_it():
    from perfbench import models

    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        models.program_config(json.loads((ROOT / c["file"]).read_text()))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader_and_its_cells_report_what_it_moves(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    spec = importlib.util.spec_from_file_location("reader", HERE / "metrics" / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.read({}) is None
    moves = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry["workloads"]) <= cells
    assert set(entry["workloads"]) <= set(moves.get("workloads", cells))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
