"""Cells, configurations, traffic, metrics and kernels are found by name
from their files, and BENCHMARK.json agrees with them. Nothing here names a
cell, a metric or a kernel: a later one is a file added, and these checks
take it in as it comes."""

import importlib
import json
import re
import sys
from pathlib import Path

import gpubench.metrics
from gpubench import harness, workmodel

ROOT = Path(__file__).resolve().parents[2]
KEYS = ("config", "traffic", "chips", "why")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_file_is_a_listed_cell():
    assert set(harness.names("workloads")) == {w["name"] for w in bench()["workloads"]}


def test_listed_cells_resolve_to_their_files():
    for w in bench()["workloads"]:
        cell = harness.cell(w["name"])
        assert {k: cell[k] for k in KEYS} == {k: w[k] for k in KEYS}
        driver = harness.traffic(cell["traffic"])["driver"]
        assert callable(importlib.import_module(f"gpubench.drivers.{driver}").run)
        harness.config(cell["config"])


def test_listed_configs_resolve_to_their_files():
    for c in bench()["configs"]:
        spec = harness.config(c["name"])
        assert spec["source"] == c["source"] and spec["reduced"] == c["reduced"]
        assert (ROOT / c["file"]).resolve() == harness.HERE / "configs" / f"{c['name']}.json"


def test_listed_metrics_resolve_to_their_readers():
    readers = harness.metric_readers()
    end_to_end = {e["name"]: e for e in bench()["end_to_end"]}
    for m in bench()["per_layer"]:
        reader = readers[m["name"]]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            reader.UNIT, reader.BETTER, reader.SOURCE, reader.LAYER, reader.MOVES)
        moves = end_to_end[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", m["workloads"]))


def test_every_kernel_file_names_counted_work():
    counted = set(workmodel.extractor_quantities(harness.config("orb2000-720p"),
                                                 level_yx=[[]] * 8))
    for name, spec in workmodel.kernel_files().items():
        re.compile(spec["pattern"])
        assert spec["bytes"] and set(spec["bytes"]) | set(spec.get("operations", {})) <= counted


def test_a_new_cell_is_a_new_file(tmp_path, monkeypatch):
    for folder in ("workloads", "configs", "traffic"):
        (tmp_path / folder).mkdir()
    (tmp_path / "workloads" / "throwaway.json").write_text(json.dumps(
        {"config": "c", "traffic": "t", "chips": 1, "why": "a cell added as a file"}))
    (tmp_path / "configs" / "c.json").write_text("{}")
    (tmp_path / "traffic" / "t.json").write_text(json.dumps({"driver": "pilotnet"}))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    assert harness.names("workloads") == ["throwaway"]
    cell = harness.cell("throwaway")
    assert cell["name"] == "throwaway" and harness.traffic(cell["traffic"])["driver"]


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "throwaway_ms.py").write_text(
        'LAYER = "Somewhere"\nSOURCE = "program_span"\nUNIT = "ms"\nBETTER = "lower"\n'
        'MOVES = "setup_s"\n\n\ndef read(layer):\n    return layer.get("throwaway")\n')
    monkeypatch.setattr(harness, "HERE", tmp_path)
    monkeypatch.setattr(gpubench.metrics, "__path__", [str(tmp_path / "metrics")])
    importlib.invalidate_caches()
    try:
        assert list(harness.metric_readers()) == ["throwaway_ms"]
        outcome = harness.Outcome(0, 0, {}, {"throwaway": 2.5}, [], 0)
        assert harness.layer_metrics(outcome) == {"throwaway_ms": {"value": 2.5, "unit": "ms"}}
    finally:
        sys.modules.pop("gpubench.metrics.throwaway_ms", None)


def test_a_new_kernel_is_a_new_file(tmp_path, monkeypatch):
    (tmp_path / "throwaway.json").write_text(json.dumps(
        {"pattern": "throwaway_kernel", "bytes": {"pyramid_pixels": 2}}))
    monkeypatch.setattr(workmodel, "KERNELS_DIR", tmp_path)
    spec = workmodel.kernel_files()["throwaway"]
    assert workmodel.matches(spec, "void throwaway_kernel<float>()")
    assert workmodel.kernel_bound_s(spec, {"pyramid_pixels": 3.35e12}) == 2.0
