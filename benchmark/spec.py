"""The manifest: ``BENCHMARK.json`` and the files it names, found by
name.

* a configuration ``<c>`` is ``benchmark/configs/<c>.json``; its
  ``data`` names a generator ``benchmark/data/<data>.py`` and its
  objective a reference ``benchmark/reference/objectives/<objective>.py``;
* a traffic mix ``<m>`` is ``benchmark/traffic/<m>.json``, whose
  ``loop`` is a module of ``benchmark/loops``;
* a cell ``<w>`` has its limits in ``benchmark/limits/<w>.json``;
* a per-layer metric ``<name>`` is read by ``benchmark/metrics/<name>.py``.

A later change adds a configuration, a generator, an objective, a mix, a
cell or a metric by adding such files and entries; no file here names
one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional


def load_file(path: Path):
    """The module in the file ``path``, loaded by its path."""
    path = Path(path)
    if not path.is_file():
        raise KeyError(f"no file {path}")
    name = "benchmark._by_path." + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        with open(self.root / "BENCHMARK.json") as f:
            self.doc = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str, sizes: Optional[Dict[str, int]] = None
               ) -> dict:
        with open(self.bench / "configs" / f"{name}.json") as f:
            cfg = json.load(f)
        cfg.update(sizes or {})
        return cfg

    def mix(self, name: str) -> dict:
        with open(self.bench / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, workload: str) -> Dict[str, float]:
        with open(self.bench / "limits" / f"{workload}.json") as f:
            return {k: v["limit"] for k, v in json.load(f).items()}

    def loop(self, name: str):
        return importlib.import_module(f"benchmark.loops.{name}").Loop

    def generator(self, kind: str):
        """``make(n, seed, stream, device, **kw)`` of the generator
        ``kind`` (a configuration's ``data``)."""
        return load_file(self.bench / "data" / f"{kind}.py").make

    def objective(self, name: str):
        """The plain reference of the objective ``name`` (the
        configuration's ``params.objective``)."""
        return load_file(self.bench / "reference" / "objectives"
                         / f"{name}.py")

    def metric(self, name: str):
        """``read(facts)`` of the per-layer metric ``name``."""
        return load_file(self.bench / "metrics" / f"{name}.py").read

    def _applies(self, m: dict, workload: str) -> bool:
        return "workloads" not in m or workload in m["workloads"]

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.doc["end_to_end"]
                if self._applies(m, workload)]

    def per_layer(self, workload: str) -> List[dict]:
        # a metric without ``workloads`` belongs to every cell that
        # reports the end-to-end metric it moves
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.doc["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]
