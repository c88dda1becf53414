"""The manifest and every file it names, found by name; the manifest's
limits on names, units and counts."""

import json
import re
from pathlib import Path

import pytest

from benchmark import spec as spec_mod
from benchmark.loops import Base

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    spec = spec_mod.Spec(ROOT)
    cfg = spec.config(cell["config"])
    mix = spec.mix(cell["traffic"])
    assert issubclass(spec.loop(mix["loop"]), Base)
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    names = {m["name"] for m in spec.end_to_end(cell["name"])}
    assert "setup_s" in names and len(names) >= 2
    per = spec.per_layer(cell["name"])
    assert per, "every cell reports a per-layer metric"
    for m in per:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in names
    limits = spec.limits(cell["name"])
    compared = [v for v in limits.values() if v is not None]
    assert compared and all(v >= 0 for v in compared)
    assert cfg["name"] == cell["config"]


def test_configs():
    for c in DOC["configs"]:
        f = ROOT / c["file"]
        cfg = json.loads(f.read_text())
        assert c["file"].startswith("benchmark/configs/")
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert all(k in cfg for k in c["reduced"])
        used = [w for w in DOC["workloads"] if w["config"] == c["name"]]
        assert used


def test_names_and_units():
    metrics = DOC["end_to_end"] + DOC["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in
                                            DOC["workloads"]]
    names += [c["name"] for c in DOC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    setup = [m for m in DOC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_per_layer_cells_report_what_they_move():
    spec = spec_mod.Spec(ROOT)
    cells = {w["name"] for w in DOC["workloads"]}
    for m in DOC["per_layer"]:
        for w in m.get("workloads", []):
            assert w in cells
            assert m["moves"] in {e["name"] for e in spec.end_to_end(w)}
