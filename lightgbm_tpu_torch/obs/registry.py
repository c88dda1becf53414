"""Metrics registry: counters, gauges, timing histograms.

Counterpart of ``lightgbm_tpu/obs/registry.py``.  The registry is the
canonical store behind every number the telemetry subsystem emits:
monotonically increasing **counters** (graph captures, retrain windows,
dispatches), last/peak **gauges** (device memory,
profile results) and **timings** — per-name duration accumulators that
keep total/count plus a bounded reservoir of samples so snapshots can
report p50/p95/max without unbounded memory.

Everything is thread-safe behind one lock per registry: callbacks, the
process-global ``TRAIN_TIMER`` sink and the C-API embed path may all
record from different threads (the pipeline's prep thread, the
server's micro-batching worker).  The reservoir uses a deterministic
seeded RNG so repeated runs produce identical percentile estimates.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

#: samples kept per timing name; beyond this, reservoir sampling keeps an
#: unbiased subset (percentiles become estimates, exact below the cap)
RESERVOIR_SIZE = 2048


class TimingStat:
    """Total/count/max plus a bounded sample reservoir for percentiles."""

    __slots__ = ("count", "total", "max", "samples", "_rng")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.samples: List[float] = []
        self._rng = random.Random(0)

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds
        if len(self.samples) < RESERVOIR_SIZE:
            self.samples.append(seconds)
        else:
            j = self._rng.randrange(self.count)
            if j < RESERVOIR_SIZE:
                self.samples[j] = seconds

    def _percentile(self, ordered: List[float], q: float) -> float:
        if not ordered:
            return 0.0
        idx = min(int(q * len(ordered)), len(ordered) - 1)
        return ordered[idx]

    def to_dict(self) -> Dict[str, float]:
        ordered = sorted(self.samples)
        mean = self.total / self.count if self.count else 0.0
        return {
            "count": self.count,
            "total_s": round(self.total, 6),
            "mean_s": round(mean, 6),
            "p50_s": round(self._percentile(ordered, 0.50), 6),
            "p95_s": round(self._percentile(ordered, 0.95), 6),
            "max_s": round(self.max, 6),
        }


class MetricsRegistry:
    """Thread-safe counters / gauges / timing histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._timings: Dict[str, TimingStat] = {}
        # CUDA-graph capture attribution: name -> {"captures": n,
        # "signatures": {sig: count}} (fed by obs.capture_track)
        self._captures: Dict[str, Dict] = {}
        self.created_unix = time.time()

    # -- counters ---------------------------------------------------------
    def inc(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # -- gauges -----------------------------------------------------------
    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def max_gauge(self, name: str, value: float) -> None:
        """Keep the maximum ever observed (peak memory style)."""
        with self._lock:
            cur = self._gauges.get(name)
            if cur is None or value > cur:
                self._gauges[name] = value

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    # -- timings ----------------------------------------------------------
    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            stat = self._timings.get(name)
            if stat is None:
                stat = self._timings[name] = TimingStat()
            stat.observe(seconds)

    def timing(self, name: str) -> Optional[TimingStat]:
        with self._lock:
            return self._timings.get(name)

    # -- capture attribution ----------------------------------------------
    def record_capture(self, name: str, signature: str) -> None:
        with self._lock:
            ent = self._captures.setdefault(name,
                                            {"captures": 0, "signatures": {}})
            ent["captures"] += 1
            sigs = ent["signatures"]
            sigs[signature] = sigs.get(signature, 0) + 1

    def captures(self, name: str) -> int:
        with self._lock:
            ent = self._captures.get(name)
            return ent["captures"] if ent else 0

    # -- snapshot ---------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": {k: v for k, v in self._gauges.items()},
                "timings": {k: s.to_dict()
                            for k, s in self._timings.items()},
                "captures": {k: {"captures": v["captures"],
                                 "signatures": dict(v["signatures"])}
                             for k, v in self._captures.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timings.clear()
            self._captures.clear()
            self.created_unix = time.time()
