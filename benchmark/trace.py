"""The device trace of a traced run and its reductions: ``torch.profiler``
over CPU and CUDA activities around a steady stretch, exported as a
Chrome trace into the run's directory, read back and deleted.

* ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the stretch (the benchmark's own ``bench.window`` annotation);
  ``window_s`` its length;
* kernel time and launch count by name;
* the breakdown: the device operations that took most time, and the
  longest idle gaps, each named by the innermost host annotation or
  operator running when it began.
"""

from __future__ import annotations

import bisect
import json
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted ``(start, end)`` intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


class Trace:
    """The reduced trace of one stretch.  Times in seconds."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") in ("user_annotation", "cpu_op")]
        if not win:
            raise ValueError("the trace has no bench.window span")
        w = max(win, key=lambda e: e.get("dur", 0.0))
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and "dur" in e]
        self.host = [e for e in events
                     if e.get("cat") in ("user_annotation", "cpu_op")
                     and "dur" in e and e.get("name") != WINDOW]
        spans = union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in self.device])
        self.busy_iv = clip(spans, self.t0, self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_iv) * 1e-6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self, pattern: Optional[str] = None) -> List[dict]:
        """Kernel events inside the stretch whose name matches
        ``pattern`` (a regular expression; all kernels when None)."""
        rx = re.compile(pattern) if pattern else None
        return [e for e in self.device if e.get("cat") == "kernel"
                and self.t0 <= float(e["ts"]) < self.t1
                and (rx is None or rx.search(e.get("name", "")))]

    def kernel_s(self, pattern: str) -> float:
        return sum(float(e["dur"]) for e in self.kernels(pattern)) * 1e-6

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for e in self.device:
            if self.t0 <= float(e["ts"]) < self.t1:
                n = e.get("name", "?")
                by_name[n] = by_name.get(n, 0.0) + float(e["dur"]) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        prev = self.t0
        for s, e in self.busy_iv + [(self.t1, self.t1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda e: float(e["ts"]))
        starts = [float(e["ts"]) for e in host]
        named = []
        for s, e in gaps:
            name = "host"
            i = bisect.bisect_right(starts, s)
            best = None
            for h in host[max(0, i - 2000):i]:
                if float(h["ts"]) + float(h["dur"]) >= s and (
                        best is None or float(h["ts"]) >= float(best["ts"])):
                    best = h
            if best is not None:
                name = best["name"]
            named.append([name, (e - s) * 1e-6])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def read(path: Path) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events)


class Profiler:
    """``with Profiler(dir) as p:`` traces the body; ``p.trace`` is the
    reduced trace once the body has ended.  The body marks its stretch
    with ``torch.profiler.record_function(WINDOW)``."""

    def __init__(self, out_dir: Path):
        self.path = Path(out_dir) / "trace.json"
        self.trace: Optional[Trace] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(str(self.path))
            try:
                self.trace = read(self.path)
            finally:
                os.remove(self.path)
        return False
