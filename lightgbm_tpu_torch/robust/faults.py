"""Deterministic, seed-keyed fault injection for the hot paths.

Counterpart of ``lightgbm_tpu/robust/faults.py``, with the same spec
grammar and the same seed-keyed draws (:func:`_hash_uniform`), so one
``fault_spec`` fires at the same invocations in both packages.  Production
code calls :func:`check` at a handful of **named sites**, and a fault spec
(the ``LGBM_TPU_FAULTS`` env var, the ``fault_spec`` param, or a direct
:func:`configure` call) decides deterministically which invocation of
which site raises.  Disarmed (the default), ``check`` is one attribute
read.

Named sites wired in the port::

    grow.dispatch    a tree or a fused chunk on the grower (GBDT)
    serve.dispatch   the forest kernel's launch in PredictionServer
    serve.fleet.dispatch  a replica's forest kernel launch in FleetServer
    pipeline.prep    RetrainPipeline host prep (runs on the prep thread)
    pipeline.train   RetrainPipeline device-training stage
    io.write         atomic checkpoint writes (robust/checkpoint.py)
    obs.export       telemetry snapshot/write path (obs/export.py)
    soak.kill        kill-and-resume at a scheduled soak retrain window
    soak.load        the soak's query-load feed (a dead ingest peer)
    soak.clock       the soak's SLO clock stamps (clock skew)

The JAX package's network, streaming-loader and pod-checkpoint sites
belong to modules the port does not have yet; a spec naming one is armed
with a warning, as any custom site is.

Spec grammar — comma-separated entries, each ``site[:key=value|flag]*``::

    serve.dispatch:persist            every call fails until clear()
    pipeline.prep:at=2                exactly invocation #2 (0-based)
    grow.dispatch:n=2                 the first 2 invocations
    net.send:after=3:n=1              invocation #3 only
    io.read:p=0.1:seed=7              each call fails w.p. 0.1, keyed by
                                      hash(site, index, seed) — the SAME
                                      seed reproduces the SAME failures
    net.connect:n=2:error=oserror     raise an OSError flavor
    serve.dispatch:at=0:persist       trip at #0, stay failed afterwards

Error flavors: ``fault`` (default, :class:`InjectedFault`),
``oserror`` (:class:`InjectedOSError`, an ``OSError`` subclass so
socket/file retry paths treat it like the real thing), ``timeout``
(:class:`InjectedTimeout`, a ``TimeoutError`` subclass).

Injections are counted in obs (``fault.injected`` total plus
``fault.<site>`` per site) so chaos runs can assert the fault actually
fired.  See docs/Robustness.md.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from .. import obs
from ..utils.log import LightGBMError, log_warning

ENV_VAR = "LGBM_TPU_FAULTS"

#: sites the port's code is instrumented with (typo guard at configure)
KNOWN_SITES = ("grow.dispatch", "serve.dispatch", "serve.fleet.dispatch",
               "pipeline.prep", "pipeline.train", "io.write", "obs.export",
               "soak.kill", "soak.load", "soak.clock", "io.read",
               "stream.parse", "net.connect", "net.send", "net.recv",
               "net.broadcast", "ckpt.ack")


def known_sites() -> tuple:
    """The instrumented fault sites, for error messages and tooling."""
    return KNOWN_SITES


class InjectedFault(RuntimeError):
    """A fault raised by the injection registry (never by real code)."""

    def __init__(self, site: str, index: int):
        super().__init__(f"injected fault at site {site!r} "
                         f"(invocation {index})")
        self.site = site
        self.index = index


class InjectedOSError(InjectedFault, OSError):
    """OSError flavor: retry paths guarding sockets/files see it as a
    real transport error."""


class InjectedTimeout(InjectedFault, TimeoutError):
    """TimeoutError flavor for deadline paths."""


_ERROR_KINDS = {
    "fault": InjectedFault,
    "oserror": InjectedOSError,
    "timeout": InjectedTimeout,
}


def _hash_uniform(*key) -> float:
    """Deterministic uniform in [0, 1) from a tuple of hashables —
    stable across processes (unlike ``hash``)."""
    blob = "\x1f".join(str(k) for k in key).encode()
    digest = hashlib.sha256(blob).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


@dataclass
class FaultRule:
    """One site's parsed injection rule (see module docstring)."""

    site: str
    count: int = 1              # n=: how many eligible calls fail
    after: int = 0              # after=: first eligible invocation index
    at: Optional[int] = None    # at=: exactly this invocation
    prob: float = 0.0           # p=: per-call failure probability
    seed: int = 0               # seed= for the p= mode
    persist: bool = False       # once tripped, fail every later call
    error: str = "fault"        # fault | oserror | timeout
    tripped: bool = False

    def should_fail(self, index: int) -> bool:
        if self.persist and self.tripped:
            return True
        if self.at is not None:
            hit = index == self.at
        elif self.prob > 0.0:
            hit = (index >= self.after
                   and _hash_uniform(self.site, index, self.seed)
                   < self.prob)
        else:
            hit = self.after <= index < self.after + self.count
        if hit:
            self.tripped = True
        return hit

    def make_error(self, index: int) -> InjectedFault:
        return _ERROR_KINDS[self.error](self.site, index)


def parse_fault_spec(spec: str) -> Dict[str, FaultRule]:
    """Parse the spec grammar into per-site rules (last entry wins)."""
    rules: Dict[str, FaultRule] = {}
    for entry in str(spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        site = parts[0].strip()
        if not site:
            raise LightGBMError(f"fault spec entry {entry!r} has no site")
        rule = FaultRule(site=site)
        for tok in parts[1:]:
            tok = tok.strip()
            if tok == "persist":
                rule.persist = True
                continue
            if "=" not in tok:
                raise LightGBMError(
                    f"bad fault spec token {tok!r} in {entry!r} "
                    f"(expected key=value or 'persist')")
            k, v = tok.split("=", 1)
            k = k.strip()
            v = v.strip()
            if k == "n":
                rule.count = int(v)
            elif k == "at":
                rule.at = int(v)
            elif k == "after":
                rule.after = int(v)
            elif k == "p":
                rule.prob = float(v)
            elif k == "seed":
                rule.seed = int(v)
            elif k == "error":
                if v not in _ERROR_KINDS:
                    raise LightGBMError(
                        f"unknown fault error kind {v!r} (expected one "
                        f"of {sorted(_ERROR_KINDS)})")
                rule.error = v
            else:
                raise LightGBMError(
                    f"unknown fault spec key {k!r} in {entry!r}")
        if site not in known_sites():
            log_warning(f"fault spec names unknown site {site!r} "
                        f"(known: {', '.join(known_sites())}); armed "
                        f"anyway for custom check() sites")
        rules[site] = rule
    return rules


class _FaultRegistry:
    """Process-global armed-rule store.  ``active`` is a plain bool read
    on the disarmed fast path; all mutation happens under the lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._rules: Dict[str, FaultRule] = {}
        self._calls: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self.spec: Optional[str] = None
        self.active = False

    def configure(self, spec: Optional[str]) -> None:
        rules = parse_fault_spec(spec) if spec else {}
        with self._lock:
            self._rules = rules
            self._calls = {}
            self._injected = {}
            self.spec = spec or None
            self.active = bool(rules)

    def clear(self) -> None:
        self.configure(None)

    def check(self, site: str) -> None:
        if not self.active:
            return
        with self._lock:
            rule = self._rules.get(site)
            if rule is None:
                return
            index = self._calls.get(site, 0)
            self._calls[site] = index + 1
            if not rule.should_fail(index):
                return
            self._injected[site] = self._injected.get(site, 0) + 1
        obs.inc("fault.injected")
        obs.inc(f"fault.{site}")
        raise rule.make_error(index)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._injected)

    def calls(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._calls)


_REGISTRY = _FaultRegistry()


def configure(spec: Optional[str]) -> None:
    """Arm the registry from a spec string (``None``/empty disarms)."""
    _REGISTRY.configure(spec)


def configure_from_env() -> None:
    """Arm from ``LGBM_TPU_FAULTS`` if set (no-op otherwise, so library
    import never disturbs an explicitly configured registry)."""
    spec = os.environ.get(ENV_VAR, "")
    if spec:
        _REGISTRY.configure(spec)


def configure_from_config(cfg) -> None:
    """Arm from a Config's ``fault_spec`` param if set.  Idempotent for
    an unchanged spec: re-reading the same config (every retrain
    window's ``init_train`` does) must NOT reset invocation counters —
    an ``at=``/``n=`` rule's progress would restart forever."""
    spec = str(getattr(cfg, "fault_spec", "") or "")
    if spec and spec != _REGISTRY.spec:
        _REGISTRY.configure(spec)


def clear() -> None:
    """Disarm every site and reset call/injection counters."""
    _REGISTRY.clear()


def active() -> bool:
    return _REGISTRY.active


def check(site: str) -> None:
    """The injection point: raises the armed error when ``site``'s rule
    says this invocation fails; near-free when disarmed."""
    _REGISTRY.check(site)


def counts() -> Dict[str, int]:
    """Per-site injected-fault counts since the last configure/clear."""
    return _REGISTRY.counts()


def calls() -> Dict[str, int]:
    """Per-site invocation counts since the last configure/clear."""
    return _REGISTRY.calls()


# arm from the environment at import (like obs): a chaos run drives
# unmodified entry points with LGBM_TPU_FAULTS exported
configure_from_env()

