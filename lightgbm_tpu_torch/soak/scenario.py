"""Declarative chaos-soak scenarios.

Counterpart of ``lightgbm_tpu/soak/scenario.py``: the same fields,
validation, JSON round trip and ``LGBM_TPU_SOAK`` / ``soak_*``
resolution, and the same timeline, fault spec, digest and window payloads
byte for byte.  A :class:`SoakScenario` describes an M-node learned-CDN fleet — one
``FleetServer`` tenant per cache node, each retrained on its own
cadence through ``RetrainPipeline(server=fleet, tenant_id=m)`` — plus
the chaos to inject while it runs.  The scenario compiles to a
**deterministic seed-keyed fault timeline**: every kill / device-death
burst / poisoned micro-batch / dead ingest peer / clock skew is placed
by a sha256 hash of ``(seed, kind, ...)`` (the same derivation idiom
as ``robust/faults._hash_uniform``), so the same seed replays the same
chaos byte-for-byte.  The timeline lowers to one combined
``LGBM_TPU_FAULTS`` spec string (armed ONCE, up front — arming resets
invocation counters) plus process-level event records the driver
executes at their scheduled points.

Workload: each tenant's windows replay the paper's cache-admission
shape — a Zipf/lognormal request trace per (seed, tenant, window),
relaxed-Belady (OPT) admission labels, gap-feature CSR rows — through the
port's own copy of ``examples/cache_admission.py``'s derivation
(:mod:`.workload`).  Rows per
window are trimmed to exactly ``sample_rows`` so every retrain window
is shape-stable (the zero-retrace swap gate depends on it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.log import LightGBMError
from . import workload as ca

ENV_SCENARIO = "LGBM_TPU_SOAK"

# the cache-admission feature layout: 50 gap features + size/cacheAvail/
# cost
NUM_FEATURES = ca.HISTFEATURES + 3

# the fork's own result log: TrainNewModel 125.4 s per 20M-request window
# (its ``model`` log, quoted in examples/cache_admission.py) -> 6.27 s per
# 1M sampled rows; a figure of the fork's CPU runs, not of this port
REFERENCE_S_PER_1M_ROWS = 125.4 / 20.0

DEFAULT_SLO = ("availability>=0.999,p95_ms<=250,burn<=14;"
               "source=serve.fleet;window_s=600")

def _hu(*parts) -> float:
    """Deterministic uniform in [0, 1) keyed on ``parts`` (the
    ``robust/faults._hash_uniform`` sha256 idiom)."""
    h = hashlib.sha256(
        "\x1f".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


def _hseed(*parts) -> int:
    """Deterministic 31-bit RNG seed keyed on ``parts``."""
    h = hashlib.sha256(
        "\x1f".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:4], "big") & 0x7FFFFFFF


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled chaos event.

    ``kind`` ∈ {kill, device_death, poison, dead_peer, clock_skew}.
    ``tenant``/``window`` locate pipeline-side events (kill,
    dead_peer); ``tick`` locates load-thread events (poison,
    dead_peer's armed budget index); ``at`` is the armed rule's
    invocation index where one applies.
    """

    kind: str
    tenant: int = -1
    window: int = -1
    tick: int = -1
    at: int = -1
    site: str = ""

    def to_json(self) -> dict:
        out = {"kind": self.kind}
        for k in ("tenant", "window", "tick", "at"):
            v = getattr(self, k)
            if v >= 0:
                out[k] = v
        if self.site:
            out["site"] = self.site
        return out


@dataclass
class SoakScenario:
    """Everything one soak run needs, JSON-serializable.

    Chaos knobs count EVENTS, not probabilities: ``kills`` schedules
    that many kill-and-resume points across tenants' retrain windows
    (window >= 1, so there is always a checkpoint to resume from);
    ``device_deaths`` schedules transient dispatch-fault bursts on the
    serving path (``device_death_persist`` makes the device stay dead —
    the forced-fail flavor: host fallback keeps answering but the SLO
    availability gate must then FIRE, by design of obs/slo.py);
    ``poison_batches`` schedules malformed query micro-batches;
    ``dead_peers`` schedules ingest-feed timeouts on the load
    generator's upstream; ``clock_skews`` schedules clock faults at SLO
    evaluation points.
    """

    tenants: int = 2
    windows: int = 3
    requests_per_window: int = 4096
    objects: int = 512
    cache_size: int = 1 << 22
    sample_rows: int = 1024
    query_rows: int = 256
    replicas: int = 1
    seed: int = 7
    # per-tenant retrain cadence: tenant m retrains every cadence[m]
    # windows (empty -> every window for every tenant)
    cadence: Tuple[int, ...] = ()
    kills: int = 1
    device_deaths: int = 0
    device_death_burst: int = 2
    device_death_persist: bool = False
    poison_batches: int = 1
    dead_peers: int = 1
    clock_skews: int = 1
    num_iterations: int = 8
    num_leaves: int = 15
    max_bin: int = 63
    load_batch_rows: int = 64
    load_interval_s: float = 0.01
    slo: str = DEFAULT_SLO
    slo_window_s: float = 600.0
    checkpoint_dir: str = ""
    out: str = ""

    # -- validation -----------------------------------------------------
    def validate(self) -> "SoakScenario":
        if self.tenants < 1:
            raise LightGBMError("soak: tenants must be >= 1")
        if self.windows < 1:
            raise LightGBMError("soak: windows must be >= 1")
        if self.kills and self.windows < 2:
            raise LightGBMError(
                "soak: kills need windows >= 2 (a kill targets window "
                ">= 1 so a checkpoint exists to resume from)")
        if self.sample_rows < 64:
            raise LightGBMError("soak: sample_rows must be >= 64")
        if self.requests_per_window < 2 * self.sample_rows:
            raise LightGBMError(
                "soak: requests_per_window must be >= 2*sample_rows "
                "(labelable rows are trimmed to exactly sample_rows)")
        if self.cadence and len(self.cadence) != self.tenants:
            raise LightGBMError(
                "soak: cadence must be empty or one entry per tenant")
        if any(c < 1 for c in self.cadence):
            raise LightGBMError("soak: cadence entries must be >= 1")
        if self.kills and not any(
                len(self.schedule(m)) >= 2 for m in range(self.tenants)):
            raise LightGBMError(
                "soak: kills need at least one tenant with >= 2 "
                "scheduled retrain windows")
        return self

    # -- (de)serialization ----------------------------------------------
    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["cadence"] = list(self.cadence)
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "SoakScenario":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(doc) - known)
        if unknown:
            raise LightGBMError(
                f"soak scenario: unknown keys {unknown}")
        kw = dict(doc)
        if "cadence" in kw:
            kw["cadence"] = tuple(int(c) for c in kw["cadence"])
        return cls(**kw).validate()

    @classmethod
    def from_file(cls, path: str) -> "SoakScenario":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    @classmethod
    def from_config(cls, cfg) -> "SoakScenario":
        """Scenario from a Config's soak_* params; the LGBM_TPU_SOAK
        env var (a path or inline JSON object) overrides everything."""
        env = os.environ.get(ENV_SCENARIO, "").strip()
        if env:
            if env.startswith("{"):
                return cls.from_json(json.loads(env))
            return cls.from_file(env)
        path = str(getattr(cfg, "soak_scenario", "") or "")
        if path:
            return cls.from_file(path)
        kw = {}
        for name, attr in (
                ("tenants", "soak_tenants"),
                ("windows", "soak_windows"),
                ("requests_per_window", "soak_requests_per_window"),
                ("sample_rows", "soak_sample_rows"),
                ("replicas", "soak_replicas"),
                ("seed", "soak_seed"),
                ("kills", "soak_kills"),
                ("device_deaths", "soak_device_deaths"),
                ("poison_batches", "soak_poison_batches"),
                ("dead_peers", "soak_dead_peers"),
                ("clock_skews", "soak_clock_skews")):
            v = getattr(cfg, attr, None)
            if v is not None:
                kw[name] = int(v)
        slo = str(getattr(cfg, "soak_slo", "") or "")
        if slo:
            kw["slo"] = slo
        out = str(getattr(cfg, "soak_out", "") or "")
        if out:
            kw["out"] = out
        ckpt = str(getattr(cfg, "soak_checkpoint_dir", "") or "")
        if ckpt:
            kw["checkpoint_dir"] = ckpt
        return cls(**kw).validate()

    # -- retrain schedule ----------------------------------------------
    def tenant_cadence(self, m: int) -> int:
        return int(self.cadence[m]) if self.cadence else 1

    def schedule(self, m: int) -> List[int]:
        """The window indices tenant ``m`` retrains on (its cadence
        subsamples the global window sequence)."""
        cad = self.tenant_cadence(m)
        return [w for w in range(self.windows) if w % cad == 0]

    # -- workload -------------------------------------------------------
    def window_payload(self, tenant: int, window: int):
        """``PreppedWindow`` for (tenant, window): synth trace -> OPT
        labels -> gap-feature CSR, trimmed to exactly ``sample_rows``
        rows (shape-stable retrains).  Pure in (seed, tenant, window).
        ``window=-1`` is the bootstrap generation the fleet serves
        before window 0's retrain lands."""
        from ..pipeline.core import PreppedWindow
        seed = _hseed(self.seed, "trace", tenant, window)
        ids, sizes, costs = ca.synth_trace(
            self.requests_per_window, self.objects, seed=seed)
        to_cache, opt_ratio = ca.calculate_opt(
            ids, sizes, self.cache_size, self.requests_per_window)
        rng = np.random.default_rng(_hseed(self.seed, "sample",
                                           tenant, window))
        labels, indptr, indices, data = ca.derive_features(
            ids, sizes, costs, to_cache, self.cache_size,
            len(ids), 0, rng)
        n = len(labels)
        if n < self.sample_rows:
            raise LightGBMError(
                f"soak: window ({tenant},{window}) derived only {n} "
                f"labelable rows < sample_rows={self.sample_rows}; "
                "raise requests_per_window")
        keep = np.arange(n) >= (n - self.sample_rows)
        indptr, indices, data = ca.csr_row_subset(
            indptr, indices, data, keep)
        labels = labels[keep]
        return PreppedWindow(
            label=labels,
            csr=(indptr, indices, data, NUM_FEATURES),
            meta={"tenant": tenant, "window": window,
                  "opt_admit_ratio": round(float(opt_ratio), 4)})

    def query_block(self, tenant: int) -> np.ndarray:
        """Dense (query_rows, 53) f64 block the load thread replays for
        this tenant — densified rows of its bootstrap window."""
        from ..pipeline.core import densify_csr_rows
        pw = self.window_payload(tenant, -1)
        rows = min(int(self.query_rows), pw.num_rows)
        return densify_csr_rows(pw.csr, 0, rows)

    def train_params(self) -> dict:
        return {
            "boosting": "gbdt", "objective": "binary",
            "num_leaves": int(self.num_leaves),
            "max_bin": int(self.max_bin),
            "num_iterations": int(self.num_iterations),
            "learning_rate": 0.1, "min_data_in_leaf": 20,
            "verbosity": -1,
            # the byte-identical-resume contract: no bagging, no rebinning,
            # fresh boosters every window
            "pipeline_rebin": False, "window_policy": "fresh",
        }


# -- timeline ----------------------------------------------------------

def compile_timeline(sc: SoakScenario) -> List[FaultEvent]:
    """The scenario's chaos, placed deterministically.

    Pure in the scenario (sha256 of seed + kind + ordinals — no wall
    clock, no process RNG): the same scenario object always compiles
    to the same event list, which is what makes same-seed replay
    byte-identical.  Events sort by (kind, tenant, window, tick) so
    the listing itself is canonical.
    """
    ev: List[FaultEvent] = []
    # kills: distinct (tenant, window) points, window >= 1 within the
    # tenant's own retrain schedule, ranked by hash
    candidates = [(m, w) for m in range(sc.tenants)
                  for w in sc.schedule(m)[1:]]
    ranked = sorted(candidates,
                    key=lambda c: (_hu(sc.seed, "kill", c[0], c[1]), c))
    for i, (m, w) in enumerate(ranked[:sc.kills]):
        ev.append(FaultEvent(kind="kill", tenant=m, window=w, at=i,
                             site="soak.kill"))
    # transient (or persistent) device-death burst on the serving
    # dispatch path
    if sc.device_deaths > 0:
        after = 8 + int(_hu(sc.seed, "death") * 24)
        ev.append(FaultEvent(
            kind="device_death", tick=after,
            at=(-1 if sc.device_death_persist
                else sc.device_deaths * sc.device_death_burst),
            site="serve.fleet.dispatch"))
    # poisoned micro-batches: load-thread tick indices, ranked by hash
    ticks = sorted(range(4, 64),
                   key=lambda t: (_hu(sc.seed, "poison", t), t))
    for i, t in enumerate(sorted(ticks[:sc.poison_batches])):
        ev.append(FaultEvent(kind="poison", tick=t, at=i))
    # dead ingest peer: the load generator's upstream feed times out
    # for a contiguous run of ticks starting at a hash-placed tick
    if sc.dead_peers > 0:
        start = 2 + int(_hu(sc.seed, "peer") * 6)
        ev.append(FaultEvent(kind="dead_peer", tick=start,
                             at=sc.dead_peers, site="soak.load"))
    # clock skew at SLO evaluation points: index 0 = the run-start
    # stamp, index 1 = the verdict stamp
    for i in range(min(sc.clock_skews, 2)):
        ev.append(FaultEvent(kind="clock_skew", at=1 - i,
                             site="soak.clock"))
    ev.sort(key=lambda e: (e.kind, e.tenant, e.window, e.tick, e.at))
    return ev


def fault_spec(sc: SoakScenario,
               events: Optional[List[FaultEvent]] = None) -> str:
    """The single combined ``LGBM_TPU_FAULTS`` spec the driver arms
    ONCE up front (``faults.configure`` resets rules AND invocation
    counters, so the whole timeline must be one arming call)."""
    if events is None:
        events = compile_timeline(sc)
    parts: List[str] = []
    kills = [e for e in events if e.kind == "kill"]
    if kills:
        parts.append(f"soak.kill:n={len(kills)}")
    death = next((e for e in events if e.kind == "device_death"), None)
    if death is not None:
        if death.at < 0:
            parts.append(
                f"serve.fleet.dispatch:after={death.tick}:persist")
        else:
            parts.append(
                f"serve.fleet.dispatch:after={death.tick}:n={death.at}")
    peer = next((e for e in events if e.kind == "dead_peer"), None)
    if peer is not None:
        parts.append(f"soak.load:after={peer.tick}:n={peer.at}"
                     f":error=timeout")
    clocks = [e for e in events if e.kind == "clock_skew"]
    if clocks:
        lo = min(e.at for e in clocks)
        parts.append(f"soak.clock:after={lo}:n={len(clocks)}")
    return ",".join(parts)


def timeline_digest(sc: SoakScenario,
                    events: Optional[List[FaultEvent]] = None) -> str:
    """sha256 over the canonical timeline + armed spec — the replay
    identity two same-seed runs must agree on byte-for-byte."""
    if events is None:
        events = compile_timeline(sc)
    doc = {"spec": fault_spec(sc, events),
           "events": [e.to_json() for e in events]}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def kill_points(events: List[FaultEvent]) -> Dict[int, List[int]]:
    """tenant -> sorted kill windows (driver-side lookup)."""
    out: Dict[int, List[int]] = {}
    for e in events:
        if e.kind == "kill":
            out.setdefault(e.tenant, []).append(e.window)
    return {m: sorted(ws) for m, ws in out.items()}


def poison_ticks(events: List[FaultEvent]) -> frozenset:
    return frozenset(e.tick for e in events if e.kind == "poison")
