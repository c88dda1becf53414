"""Shared settings of the benchmark's tests: small sizes a CPU run holds."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

#: rows of every configuration at test size
SIZES = dict(train_rows=8000)
#: traffic at test size: short chunks, few rounds, the window's first
#: chunks or window judged
MIX = dict(chunk=5, trace_steps=2, windows=2, rounds=8, sample_among=1,
           ref_trees=3, judged_chunks=2)


def cells():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in doc["workloads"]]


@pytest.fixture
def cpu_run(tmp_path):
    """``cpu_run(workload, **kw)``: one run of the harness on the CPU at
    test size, its result object."""
    from benchmark import run

    def go(workload, trace=False, **kw):
        run.set_env()
        kw.setdefault("sizes", SIZES)
        kw.setdefault("mix_overrides", MIX)
        return run.run(workload, 20261018123456, 0.5, trace,
                       device_name="cpu", out_root=tmp_path / "out", **kw)
    return go
