"""Bounded retries with capped exponential backoff, plus a circuit
breaker for repeatedly-failing dependencies.

Counterpart of ``lightgbm_tpu/robust/retry.py``.  :func:`with_retries` is
the shared policy wrapper a transient-failure path routes through (in the
port: the grower's dispatch, ``boosting/gbdt.py::_dispatch_guard``), so
attempt counts, backoff shape and telemetry are defined in one place.

Backoff is capped exponential with hash-derived jitter (no live RNG):
the fraction is keyed on ``(process, site, attempt)``, so sleeps are
deterministic within a process — the property tests rely on — while
co-failing worker PROCESSES decorrelate instead of retrying in
lockstep.

Telemetry: ``retry.attempts`` (total), ``retry.<site>`` (per site) and
the ``retry.backoff`` timing histogram — see docs/Observability.md.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from .. import obs
from ..utils.log import LightGBMError
from .faults import InjectedFault, _hash_uniform

#: per-process jitter key: co-failing WORKERS must not retry in
#: lockstep, so the jitter hash includes the pid — while within one
#: process the sleeps stay fully deterministic and replayable
_PROCESS_KEY = os.getpid()


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to try and how long to wait between tries.

    ``max_attempts`` counts the FIRST try too (3 = one try + two
    retries).  ``retry_on`` is the exception tuple worth retrying —
    anything else propagates immediately (a shape error does not become
    less wrong on attempt two).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25           # fraction of the delay shaved off
    retry_on: Tuple = (Exception,)


class RetryError(LightGBMError):
    """All attempts failed; ``__cause__`` is the last exception."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(
            f"{site or 'operation'} failed after {attempts} attempt"
            f"{'s' if attempts != 1 else ''}: {last!r}")
        self.site = site
        self.attempts = attempts
        self.__cause__ = last


def backoff_delay(policy: RetryPolicy, attempt: int,
                  site: str = "") -> float:
    """Delay before retry number ``attempt`` (0-based): capped
    exponential, shaved by a (process, site, attempt)-keyed jitter —
    deterministic WITHIN a process (a failing run replays its own
    sleeps) while co-failing worker PROCESSES land on different delays
    instead of retrying in lockstep."""
    raw = min(policy.base_delay_s * (2.0 ** attempt), policy.max_delay_s)
    if policy.jitter <= 0.0:
        return raw
    return raw * (1.0 - policy.jitter * _hash_uniform(
        "retry", _PROCESS_KEY, site, attempt))


def with_retries(fn: Callable, policy: Optional[RetryPolicy] = None,
                 site: str = "", sleep: Callable = time.sleep):
    """Call ``fn()`` under ``policy``; returns its value or raises
    :class:`RetryError` once attempts are exhausted.  ``sleep`` is
    injectable for tests."""
    policy = policy or RetryPolicy()
    attempts = max(int(policy.max_attempts), 1)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except policy.retry_on as e:   # noqa: PERF203 — the point
            last = e
            obs.inc("retry.attempts")
            if site:
                obs.inc(f"retry.{site}")
            if attempt + 1 >= attempts:
                break
            delay = backoff_delay(policy, attempt, site)
            obs.observe("retry.backoff", delay)
            sleep(delay)
    raise RetryError(site, attempts, last)


def transient_dispatch_errors() -> Tuple:
    """Exception types a device dispatch is retried on: the injected
    flavors (so chaos runs exercise the retry path), ``OSError`` and
    ``TimeoutError``.  Unlike the JAX package, which also retries its
    runtime's ``JaxRuntimeError``, a CUDA error is never retried here: in
    PyTorch it is usually sticky and poisons the context, so a retry would
    only hide the fault.  It raises at once."""
    return (InjectedFault, OSError, TimeoutError)


class CircuitBreaker:
    """Consecutive-failure circuit breaker with timed re-probe: the
    servers' degrade-to-host path sits behind one (``PredictionServer``'s
    own, one a replica in ``FleetServer``), and their device failures
    trip it.

    States: **closed** (normal — every call may attempt the guarded
    operation), **open** (``failure_threshold`` consecutive failures
    seen — :meth:`allow` answers False so callers go straight to their
    fallback, except once per ``reprobe_interval_s`` when it answers
    True so ONE caller probes whether the dependency recovered).  A
    recorded success closes the breaker; a failure while open re-arms
    the re-probe timer.

    Thread-safe; ``clock`` is injectable for tests.
    """

    def __init__(self, failure_threshold: int = 3,
                 reprobe_interval_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.reprobe_interval_s = float(reprobe_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None    # degraded duration
        self._next_probe_at = 0.0                  # probe scheduling
        self._dark_total = 0.0                     # closed dark periods

    @property
    def state(self) -> str:
        with self._lock:
            return "open" if self._opened_at is not None else "closed"

    def dark_seconds(self) -> float:
        """Total seconds this breaker has spent open, INCLUDING the
        current still-open period.  ``record_success`` reports a dark
        period only at recovery; live availability accounting cannot
        wait for one."""
        with self._lock:
            total = self._dark_total
            if self._opened_at is not None:
                total += self._clock() - self._opened_at
            return total

    def allow(self) -> bool:
        """May the caller attempt the guarded operation right now?
        Closed: always.  Open: exactly ONE caller per re-probe window —
        granting a probe immediately pushes the window out, so
        concurrent requests during the degraded period do not all pay
        the device-failure latency (failure re-arms the window too;
        success closes the breaker)."""
        with self._lock:
            if self._opened_at is None:
                return True
            now = self._clock()
            if now >= self._next_probe_at:
                self._next_probe_at = now + self.reprobe_interval_s
                return True
            return False

    def record_success(self) -> Optional[float]:
        """Note a successful guarded call.  Returns the TOTAL seconds
        the breaker spent open when this success RECOVERS it, else
        None."""
        with self._lock:
            self._failures = 0
            if self._opened_at is None:
                return None
            dark = self._clock() - self._opened_at
            self._dark_total += dark
            self._opened_at = None
            return dark

    def record_failure(self) -> bool:
        """Note a failed guarded call.  Returns True exactly when this
        failure TRIPS the breaker closed -> open."""
        with self._lock:
            self._failures += 1
            now = self._clock()
            if self._opened_at is not None:
                # failed re-probe: stay open, push the next probe out
                self._next_probe_at = now + self.reprobe_interval_s
                return False
            if self._failures >= self.failure_threshold:
                self._opened_at = now
                self._next_probe_at = now + self.reprobe_interval_s
                return True
            return False
