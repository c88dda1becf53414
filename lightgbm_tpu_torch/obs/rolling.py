"""Rolling-window aggregation: live rates and percentiles, not lifetime.

Counterpart of ``lightgbm_tpu/obs/rolling.py``, the same code: pure
Python over the host clock, so a replayed (timestamp, value) sequence
gives the JAX package's snapshot byte for byte.  The cumulative :class:`~.registry.MetricsRegistry` answers "what did
this process do since it started" — the right question for a run
digest, the wrong one for a live SLO: a p95 reservoir that mixes
window 0's cold compiles with window 40's steady state cannot express
"p95 latency over the last 60 seconds".  :class:`RollingRegistry`
keeps the same three metric kinds time-bucketed into a fixed ring:

* **counters** — one integer cell per time bucket; a window query sums
  the in-window cells into a delta and a per-second rate;
* **gauges** — a bounded list of (timestamp, value) *transitions*, so a
  window query can reconstruct the time-weighted mean (the fraction of
  the window a 0/1 gauge like ``serve.degraded`` spent at 1 — breaker
  dark time — falls out of this);
* **timings** — per-bucket histograms over **fixed log-spaced bounds**
  (:data:`HIST_BOUNDS`), so p50/p95/p99 over "the last N seconds" are
  computed by merging in-window bucket counts.  Reported percentiles
  are always one of the fixed bound values (clamped to the window max),
  which makes them deterministic under replayed timestamps: the same
  (timestamp, value) sequence always yields the same snapshot.

Everything is wall-clock driven (``clock`` injectable for tests),
thread-safe behind one lock, and bounded: memory is
O(names x num_buckets x len(HIST_BOUNDS)) regardless of run length.
The registry records nothing by itself — ``lightgbm_tpu_torch.obs`` mirrors
its ``inc``/``set_gauge``/``observe`` calls here while telemetry is
enabled, so the disabled hot path stays a single flag check.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional

#: fixed log-spaced timing-histogram bounds (seconds): 1 µs .. ~80 s at
#: ratio 10^(1/12) ≈ 1.21 per bucket, so a percentile estimate is at
#: most ~21% above the true value.  Observations past the last bound
#: land in an overflow cell and report as the window max.
HIST_BOUNDS: tuple = tuple(1e-6 * 10 ** (i / 12) for i in range(96))

#: transitions kept per gauge; beyond this the oldest are discarded
#: (older than any realistic window anyway)
MAX_GAUGE_TRANSITIONS = 512


class _Cells:
    """A ring of per-bucket cells addressed by absolute bucket epoch."""

    __slots__ = ("epochs",)

    def __init__(self, n: int):
        self.epochs = [-1] * n

    def slot(self, epoch: int) -> Optional[int]:
        """(ring index) for ``epoch``; None when ``epoch`` is older
        than the slot's current tenant (a late out-of-order record —
        dropped, never double-counted into a newer bucket).  Callers
        compare ``epochs[i] != epoch`` to detect a stale slot, reset
        its payload, then stamp ``epochs[i] = epoch``."""
        i = epoch % len(self.epochs)
        if self.epochs[i] > epoch:
            return None
        return i


class _RollCounter(_Cells):
    __slots__ = ("values",)

    def __init__(self, n: int):
        super().__init__(n)
        self.values = [0] * n

    def add(self, epoch: int, value: int) -> None:
        i = self.slot(epoch)
        if i is None:
            return
        if self.epochs[i] != epoch:
            self.values[i] = 0
            self.epochs[i] = epoch
        self.values[i] += value


class _RollTiming(_Cells):
    __slots__ = ("counts", "totals", "maxes", "hists")

    def __init__(self, n: int):
        super().__init__(n)
        self.counts = [0] * n
        self.totals = [0.0] * n
        self.maxes = [0.0] * n
        self.hists: List[Optional[List[int]]] = [None] * n

    def add(self, epoch: int, seconds: float) -> None:
        i = self.slot(epoch)
        if i is None:
            return
        if self.epochs[i] != epoch or self.hists[i] is None:
            self.hists[i] = [0] * (len(HIST_BOUNDS) + 1)
            self.counts[i] = 0
            self.totals[i] = 0.0
            self.maxes[i] = 0.0
            self.epochs[i] = epoch
        self.counts[i] += 1
        self.totals[i] += seconds
        if seconds > self.maxes[i]:
            self.maxes[i] = seconds
        self.hists[i][_bound_index(seconds)] += 1


def _bound_index(seconds: float) -> int:
    """Index of the smallest bound >= seconds (len(HIST_BOUNDS) =
    overflow).  Closed-form from the log spacing, then nudged for
    float edge cases so the invariant holds exactly."""
    if seconds <= HIST_BOUNDS[0]:
        return 0
    k = int(math.ceil(12.0 * math.log10(seconds / 1e-6)))
    k = max(0, min(k, len(HIST_BOUNDS)))
    while k > 0 and HIST_BOUNDS[k - 1] >= seconds:
        k -= 1
    while k < len(HIST_BOUNDS) and HIST_BOUNDS[k] < seconds:
        k += 1
    return k


def _merged_percentile(merged: List[int], total: int, q: float,
                       wmax: float) -> float:
    """q-quantile of a merged histogram: the fixed upper bound of the
    bucket where the cumulative count crosses q, clamped to the window
    max (overflow bucket reports the max)."""
    rank = max(1, int(math.ceil(q * total)))
    cum = 0
    for j, c in enumerate(merged):
        cum += c
        if cum >= rank:
            bound = HIST_BOUNDS[j] if j < len(HIST_BOUNDS) else wmax
            return min(bound, wmax)
    return wmax


class RollingRegistry:
    """Time-bucketed counters / gauges / timing histograms (see module
    docstring).  ``bucket_seconds`` x ``num_buckets`` is the maximum
    queryable window (default 1 s x 120 = 2 minutes); queries may ask
    for any smaller ``window_s``."""

    def __init__(self, bucket_seconds: float = 1.0,
                 num_buckets: int = 120,
                 clock: Callable[[], float] = time.time):
        if bucket_seconds <= 0 or num_buckets < 2:
            raise ValueError("bucket_seconds must be > 0 and "
                             "num_buckets >= 2")
        self.bucket_seconds = float(bucket_seconds)
        self.num_buckets = int(num_buckets)
        self._clock = clock
        self._lock = threading.Lock()
        self._counters: Dict[str, _RollCounter] = {}
        self._gauges: Dict[str, List] = {}     # name -> [(t, value), ...]
        self._timings: Dict[str, _RollTiming] = {}

    # -- recording --------------------------------------------------------
    def _epoch(self, now: Optional[float]) -> int:
        return int((self._clock() if now is None else now)
                   // self.bucket_seconds)

    def inc(self, name: str, value: int = 1,
            now: Optional[float] = None) -> None:
        e = self._epoch(now)
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = _RollCounter(self.num_buckets)
            c.add(e, value)

    def set_gauge(self, name: str, value: float,
                  now: Optional[float] = None) -> None:
        with self._lock:
            # clock read INSIDE the lock: concurrent writers must not
            # interleave into a non-monotone transition list
            t = self._clock() if now is None else now
            trans = self._gauges.get(name)
            if trans is None:
                trans = self._gauges[name] = []
            if trans and t < trans[-1][0]:
                # late out-of-order write: dropped, matching the
                # counter/timing ring contract — gauge_last stays the
                # newest value and gauge_mean never integrates a
                # negative segment
                return
            # only CHANGES are transitions; a re-set of the same value
            # costs nothing, so per-request gauge writes stay bounded
            if not trans or trans[-1][1] != value:
                trans.append((t, value))
                if len(trans) > MAX_GAUGE_TRANSITIONS:
                    del trans[:len(trans) - MAX_GAUGE_TRANSITIONS]

    def observe(self, name: str, seconds: float,
                now: Optional[float] = None) -> None:
        e = self._epoch(now)
        with self._lock:
            t = self._timings.get(name)
            if t is None:
                t = self._timings[name] = _RollTiming(self.num_buckets)
            t.add(e, seconds)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timings.clear()

    # -- window queries ---------------------------------------------------
    def _window_epochs(self, window_s: Optional[float],
                       now: Optional[float]):
        now = self._clock() if now is None else now
        w = (self.bucket_seconds * self.num_buckets
             if window_s is None else float(window_s))
        nb = min(self.num_buckets,
                 max(1, int(math.ceil(w / self.bucket_seconds))))
        e_hi = int(now // self.bucket_seconds)
        return now, nb * self.bucket_seconds, e_hi - nb + 1, e_hi

    def counter_delta(self, name: str, window_s: Optional[float] = None,
                      now: Optional[float] = None) -> int:
        _, _, lo, hi = self._window_epochs(window_s, now)
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                return 0
            return sum(v for e, v in zip(c.epochs, c.values)
                       if lo <= e <= hi)

    def gauge_last(self, name: str) -> Optional[float]:
        with self._lock:
            trans = self._gauges.get(name)
            return trans[-1][1] if trans else None

    def gauge_mean(self, name: str, window_s: Optional[float] = None,
                   now: Optional[float] = None) -> Optional[float]:
        """Time-weighted mean over the window.  The value holds from
        each transition until the next; before the first known
        transition the value is unknown, so integration starts there
        (None when the gauge has no transition at or before ``now``)."""
        now, w, _, _ = self._window_epochs(window_s, now)
        ws = now - w
        with self._lock:
            trans = list(self._gauges.get(name) or ())
        if not trans or trans[0][0] > now:
            return None
        # value at window start = last transition at or before ws
        start_t, start_v = ws, None
        segs = []
        for t, v in trans:
            if t > now:
                break
            if t <= ws:
                start_v = v
            else:
                segs.append((t, v))
        t0 = ws if start_v is not None else segs[0][0]
        cur = start_v if start_v is not None else None
        total = 0.0
        weighted = 0.0
        prev_t = t0
        for t, v in segs:
            if cur is not None:
                weighted += cur * (t - prev_t)
                total += t - prev_t
            cur = v
            prev_t = t
        if cur is None:
            return None
        weighted += cur * (now - prev_t)
        total += now - prev_t
        if total <= 0:
            return float(cur)
        return weighted / total

    def percentile(self, name: str, q: float,
                   window_s: Optional[float] = None,
                   now: Optional[float] = None) -> Optional[float]:
        """q-quantile (0 < q <= 1) of the merged in-window histogram:
        the fixed upper bound of the bucket where the cumulative count
        crosses q, clamped to the window max.  None with no samples."""
        _, _, lo, hi = self._window_epochs(window_s, now)
        with self._lock:
            t = self._timings.get(name)
            if t is None:
                return None
            merged = [0] * (len(HIST_BOUNDS) + 1)
            total = 0
            wmax = 0.0
            for i, e in enumerate(t.epochs):
                if lo <= e <= hi and t.counts[i]:
                    total += t.counts[i]
                    if t.maxes[i] > wmax:
                        wmax = t.maxes[i]
                    h = t.hists[i]
                    for j, c in enumerate(h):
                        merged[j] += c
        if total == 0:
            return None
        return _merged_percentile(merged, total, q, wmax)

    def timing_stats(self, name: str, window_s: Optional[float] = None,
                     now: Optional[float] = None) -> Optional[Dict]:
        # one locked pass merges the in-window histogram; all three
        # quantiles read from the merged counts (same resolved clock,
        # so count/max/percentiles always describe ONE window)
        _, w, lo, hi = self._window_epochs(window_s, now)
        with self._lock:
            t = self._timings.get(name)
            if t is None:
                return None
            count = 0
            total = 0.0
            wmax = 0.0
            merged = [0] * (len(HIST_BOUNDS) + 1)
            for i, e in enumerate(t.epochs):
                if lo <= e <= hi and t.counts[i]:
                    count += t.counts[i]
                    total += t.totals[i]
                    if t.maxes[i] > wmax:
                        wmax = t.maxes[i]
                    for j, c in enumerate(t.hists[i]):
                        merged[j] += c
        if count == 0:
            return None
        out = {"count": count, "total_s": round(total, 6),
               "mean_s": round(total / count, 6), "max_s": round(wmax, 6)}
        for tag, q in (("p50_s", 0.50), ("p95_s", 0.95), ("p99_s", 0.99)):
            out[tag] = round(_merged_percentile(merged, count, q, wmax), 6)
        return out

    def window(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> Dict:
        """Full rolling snapshot over the window: counter deltas+rates,
        gauge last/time-weighted mean, timing count/percentiles.  Only
        names with in-window activity appear (gauges: any transition at
        or before now)."""
        now, w, lo, hi = self._window_epochs(window_s, now)
        with self._lock:
            counter_names = list(self._counters)
            gauge_names = list(self._gauges)
            timing_names = list(self._timings)
        counters = {}
        for name in counter_names:
            delta = self.counter_delta(name, window_s, now)
            if delta:
                counters[name] = {"delta": delta,
                                  "rate_per_s": round(delta / w, 6)}
        gauges = {}
        for name in gauge_names:
            mean = self.gauge_mean(name, window_s, now)
            last = self.gauge_last(name)
            if last is not None:
                gauges[name] = {
                    "last": last,
                    "mean": None if mean is None else round(mean, 6)}
        timings = {}
        for name in timing_names:
            stat = self.timing_stats(name, window_s, now)
            if stat is not None:
                timings[name] = stat
        return {"bucket_s": self.bucket_seconds,
                "window_s": round(w, 3),
                "now_unix": round(now, 3),
                "counters": counters, "gauges": gauges,
                "timings": timings}
