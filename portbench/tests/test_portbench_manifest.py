"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from conftest import ROOT
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert MANIFEST["command"][1].startswith("portbench/")
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in MANIFEST["configs"]]
                         + [w[k] for w in MANIFEST["workloads"]
                            for k in ("config", "traffic")])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moved = {m["name"]: m for m in MANIFEST["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved["workloads"])
        assert "\n" not in metric["layer"] and metric["layer"]
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    spec = harness.Spec.load(cell)
    e2e, layers = spec.metrics(False), spec.metrics(True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    assert spec.cell["chips"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.Spec.load(cell)
    entry = importlib.import_module(f"portbench.entries.{spec.work['entry']}")
    for fn in ("prepare", "call", "judge", "control"):
        assert callable(getattr(entry, fn))
    for name in spec.metrics(False) + spec.metrics(True):
        assert callable(harness.load_metric(name).read)
    assert spec.config["reduced"] == []
    assert sum(e["count"] for e in spec.config["images"]) > 0


def test_config_files_under_paths():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/configs/") and (ROOT / f).is_file()
