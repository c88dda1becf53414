"""Declarative SLOs evaluated from the rolling telemetry windows.

Counterpart of ``lightgbm_tpu/obs/slo.py``: the same grammar, the same
arithmetic and the same 1e-12 boundary tolerance, so one rolling state
gives both packages equal reports.  A production serving stack is judged on *objectives over a live
window* — "availability >= 99.9% through retrains", "p95 latency under
50 ms over the last minute" — not on process-lifetime averages.  This
module turns a compact spec string into those objectives and evaluates
them against :class:`~.rolling.RollingRegistry` state into a
:class:`SloReport` that CI gates and the soak harness
(``lightgbm_tpu_torch/soak``) can assert on.

Spec grammar — comma/semicolon-separated ``key<op>value`` tokens::

    availability>=0.999,p95_ms<=50,burn<=14,freshness_s<=30
    source=serve.fleet;window_s=60;p99_ms<=200
    metric=serve.request_latency,p95_ms<=5

* ``availability>=T`` — request availability over the window.  Valid
  requests are successes + degraded-to-host fallbacks + hard failures
  (client **input errors are excluded** — a malformed query is not the
  service's unavailability).  Breaker dark time counts against it:
  ``availability = answered/valid x (1 - dark_fraction)``, where
  ``dark_fraction`` is the time-weighted mean of the ``<source>.degraded``
  gauge over the window (or ``degraded_replicas / replicas`` for the
  fleet), so a service answering 100% of requests from the host
  fallback while the device is dead still fails a 99.9% target.
* ``p50_ms<=B`` / ``p95_ms<=B`` / ``p99_ms<=B`` — rolling latency
  percentile bound (milliseconds) on ``metric=`` (default
  ``<source>.predict``).
* ``burn<=B`` — error-budget burn rate: ``(1 - availability) /
  (1 - availability_target)``; requires an ``availability`` objective.
* ``freshness_s<=D`` — model freshness: seconds since the last
  completed retrain swap (``pipeline.last_swap_unix`` gauge, written by
  ``RetrainPipeline._swap``), i.e. the per-window retrain deadline.
* ``window_p95_s<=B`` — end-to-end retrain window (prep||train+swap)
  p95 bound from the ``pipeline.window`` span timings.
* ``source=PFX`` (default ``serve``), ``window_s=N`` (default 60),
  ``metric=NAME`` — evaluation knobs, not objectives.

Comparisons carry a 1e-12 tolerance so an objective met exactly at its
boundary passes deterministically.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .state import STATE

_EPS = 1e-12

#: objective keys -> (kind, payload) parsed below
_LAT_KEYS = {"p50_ms": 0.50, "p95_ms": 0.95, "p99_ms": 0.99}


class SloSpecError(ValueError):
    """Malformed SLO spec string."""


@dataclass
class SloResult:
    """One evaluated objective."""

    name: str
    comparator: str          # ">=" | "<="
    target: float
    observed: Optional[float]
    ok: bool
    detail: str = ""

    def to_json(self) -> Dict:
        out = {"name": self.name, "comparator": self.comparator,
               "target": self.target,
               "observed": (None if self.observed is None
                            else round(self.observed, 6)),
               "ok": self.ok}
        if self.detail:
            out["detail"] = self.detail
        return out


@dataclass
class SloReport:
    """Evaluation of one spec at one instant over one rolling window."""

    spec: str
    source: str
    window_s: float
    evaluated_unix: float
    objectives: List[SloResult] = field(default_factory=list)
    counts: Dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(o.ok for o in self.objectives)

    def objective(self, name: str) -> Optional[SloResult]:
        for o in self.objectives:
            if o.name == name:
                return o
        return None

    def to_json(self) -> Dict:
        return {"spec": self.spec, "source": self.source,
                "window_s": self.window_s,
                "evaluated_unix": round(self.evaluated_unix, 3),
                "ok": self.ok,
                "objectives": [o.to_json() for o in self.objectives],
                "counts": dict(self.counts)}

    def digest(self) -> Dict:
        """Compact form for ``obs.summary()`` and stream lines."""
        return {"ok": self.ok, "window_s": self.window_s,
                "objectives": {
                    o.name: {"target": o.target,
                             "observed": (None if o.observed is None
                                          else round(o.observed, 6)),
                             "ok": o.ok}
                    for o in self.objectives},
                "counts": dict(self.counts)}


class SloSpec:
    """Parsed spec: evaluation knobs plus the ordered objectives."""

    def __init__(self, *, availability: Optional[float] = None,
                 latency: Optional[List] = None,
                 burn_rate: Optional[float] = None,
                 freshness_s: Optional[float] = None,
                 window_p95_s: Optional[float] = None,
                 window_s: float = 60.0, source: str = "serve",
                 latency_metric: Optional[str] = None,
                 text: str = ""):
        self.availability = availability
        self.latency = list(latency or ())    # [(q, bound_seconds), ...]
        self.burn_rate = burn_rate
        self.freshness_s = freshness_s
        self.window_p95_s = window_p95_s
        self.window_s = float(window_s)
        self.source = source
        self.latency_metric = latency_metric
        self.text = text or self._render()
        if self.burn_rate is not None and self.availability is None:
            raise SloSpecError(
                "burn<= needs an availability>= objective (the burn "
                "rate is relative to that error budget)")
        if not (self.latency or self.availability is not None
                or self.freshness_s is not None
                or self.window_p95_s is not None):
            raise SloSpecError("spec has no objectives")

    def _render(self) -> str:
        parts = []
        if self.availability is not None:
            parts.append(f"availability>={self.availability:g}")
        for q, b in self.latency:
            parts.append(f"p{int(q * 100)}_ms<={b * 1e3:g}")
        if self.burn_rate is not None:
            parts.append(f"burn<={self.burn_rate:g}")
        if self.freshness_s is not None:
            parts.append(f"freshness_s<={self.freshness_s:g}")
        if self.window_p95_s is not None:
            parts.append(f"window_p95_s<={self.window_p95_s:g}")
        return ",".join(parts)

    @classmethod
    def parse(cls, text: str) -> "SloSpec":
        kw = {"latency": [], "text": text.strip()}
        for raw in text.replace(";", ",").split(","):
            tok = raw.strip()
            if not tok:
                continue
            for op in (">=", "<=", "="):
                if op in tok:
                    key, _, val = tok.partition(op)
                    break
            else:
                raise SloSpecError(f"cannot parse SLO token {tok!r} "
                                   f"(expected key>=v, key<=v or key=v)")
            key = key.strip().lower()
            val = val.strip()
            if key == "source":
                kw["source"] = val
                continue
            if key == "metric":
                kw["latency_metric"] = val
                continue
            try:
                num = float(val)
            except ValueError:
                raise SloSpecError(
                    f"SLO token {tok!r}: {val!r} is not a number") \
                    from None
            if key == "availability":
                if op != ">=":
                    raise SloSpecError("availability takes >=")
                if not 0.0 < num <= 1.0:
                    raise SloSpecError(
                        f"availability target {num} not in (0, 1]")
                kw["availability"] = num
            elif key in _LAT_KEYS:
                if op != "<=":
                    raise SloSpecError(f"{key} takes <=")
                kw["latency"].append((_LAT_KEYS[key], num / 1e3))
            elif key == "burn":
                if op != "<=":
                    raise SloSpecError("burn takes <=")
                kw["burn_rate"] = num
            elif key == "freshness_s":
                if op != "<=":
                    raise SloSpecError("freshness_s takes <=")
                kw["freshness_s"] = num
            elif key == "window_p95_s":
                if op != "<=":
                    raise SloSpecError("window_p95_s takes <=")
                kw["window_p95_s"] = num
            elif key == "window_s":
                if num <= 0:
                    raise SloSpecError("window_s must be > 0")
                kw["window_s"] = num
            else:
                raise SloSpecError(f"unknown SLO key {key!r}")
        return cls(**kw)

    # -- evaluation ---------------------------------------------------
    def _dark_fraction(self, rolling, registry, now) -> float:
        dark = rolling.gauge_mean(f"{self.source}.degraded",
                                  self.window_s, now)
        if dark is None:
            # fleet shape: degraded replica count over replica count
            dr = rolling.gauge_mean(f"{self.source}.degraded_replicas",
                                    self.window_s, now)
            reps = rolling.gauge_last(f"{self.source}.replicas")
            if reps is None and registry is not None:
                reps = registry.gauge(f"{self.source}.replicas")
            dark = (dr / reps) if (dr is not None and reps) else 0.0
        return min(max(float(dark), 0.0), 1.0)

    def evaluate(self, rolling=None, registry=None,
                 now: Optional[float] = None) -> SloReport:
        rolling = rolling if rolling is not None else STATE.rolling
        if rolling is None:
            raise SloSpecError(
                "no rolling telemetry to evaluate against; enable "
                "telemetry first (obs.configure(enabled=True))")
        capacity = rolling.bucket_seconds * rolling.num_buckets
        if self.window_s > capacity + _EPS:
            # the ring would silently clamp the window and a failure
            # older than the ring would produce a FALSE PASS — a gate
            # must error loudly instead
            raise SloSpecError(
                f"window_s={self.window_s:g} exceeds the rolling "
                f"registry's capacity ({capacity:g} s = bucket_seconds "
                f"x num_buckets); evaluate a smaller window or build "
                f"the registry with a larger ring")
        registry = registry if registry is not None else STATE.registry
        now = time.time() if now is None else now
        w = self.window_s
        src = self.source

        def delta(suffix):
            return rolling.counter_delta(f"{src}.{suffix}", w, now)

        n_ok = delta("ok")
        n_fb = delta("fallback_requests")
        n_fail = delta("failed")
        n_input = delta("input_errors")
        answered = n_ok + n_fb
        valid = answered + n_fail
        request_avail = (answered / valid) if valid else 1.0
        dark = self._dark_fraction(rolling, registry, now)
        availability = request_avail * (1.0 - dark)

        report = SloReport(
            spec=self.text, source=src, window_s=w, evaluated_unix=now,
            counts={"ok": n_ok, "fallback": n_fb, "failed": n_fail,
                    "input_errors": n_input,
                    "dark_fraction": round(dark, 6),
                    "availability": round(availability, 6)})
        res = report.objectives.append

        if self.availability is not None:
            res(SloResult(
                "availability", ">=", self.availability, availability,
                availability >= self.availability - _EPS,
                detail="" if valid or dark else "no requests in window"))
        metric = self.latency_metric or f"{src}.predict"
        for q, bound in self.latency:
            p = rolling.percentile(metric, q, w, now)
            res(SloResult(
                f"p{int(q * 100)}_ms", "<=", bound * 1e3,
                None if p is None else p * 1e3,
                p is not None and p <= bound + _EPS,
                detail="" if p is not None
                else f"no {metric} samples in window"))
        if self.burn_rate is not None:
            budget = 1.0 - self.availability
            burn = ((1.0 - availability) / budget) if budget > 0 \
                else (0.0 if availability >= 1.0 - _EPS else float("inf"))
            res(SloResult("burn", "<=", self.burn_rate, burn,
                          burn <= self.burn_rate + _EPS))
        if self.freshness_s is not None:
            last = rolling.gauge_last("pipeline.last_swap_unix")
            if last is None and registry is not None:
                last = registry.gauge("pipeline.last_swap_unix")
            age = None if last is None else max(now - float(last), 0.0)
            res(SloResult(
                "freshness_s", "<=", self.freshness_s, age,
                age is not None and age <= self.freshness_s + _EPS,
                detail="" if age is not None else "no retrain swap "
                "recorded (pipeline.last_swap_unix unset)"))
        if self.window_p95_s is not None:
            p = rolling.percentile("pipeline.window", 0.95, w, now)
            res(SloResult(
                "window_p95_s", "<=", self.window_p95_s, p,
                p is not None and p <= self.window_p95_s + _EPS,
                detail="" if p is not None
                else "no pipeline.window spans in window"))
        return report


def evaluate(spec, rolling=None, registry=None,
             now: Optional[float] = None, record: bool = True
             ) -> SloReport:
    """Parse-if-needed and evaluate ``spec``.  With ``record`` (the
    default) the report is remembered on the obs state so
    ``obs.summary()`` embeds its digest and the stream exporter tags
    subsequent snapshot lines."""
    if isinstance(spec, str):
        spec = SloSpec.parse(spec)
    report = spec.evaluate(rolling=rolling, registry=registry, now=now)
    if record:
        STATE.last_slo = report
    return report
