"""The soak conductor.

Counterpart of ``lightgbm_tpu/soak/driver.py``, on the card unless the
caller passes ``device="cpu"``: every window trains with kernel 1
(``csrc/wave_hist.cu``, one composed CUDA graph a tree) and every request
is served by the forest kernel (``csrc/forest_predict.cu``) through the
fleet's tenant route.  Brings up the scenario's fleet (one bootstrap
booster per tenant), then overlaps three things until every tenant's
retrain schedule completes:

* per-tenant ``RetrainPipeline(server=fleet, tenant_id=m)`` threads
  hot-swapping each window's model into the shared ``FleetServer``,
  checkpointing every window (atomic writes) and executing the
  timeline's scheduled kills — an ``InjectedFault`` raised from prep
  surfaces as ``PipelineError``, the driver resumes from the
  checkpoint, and after the run asserts the resumed tenant's final
  model is BYTE-identical to an uninterrupted reference run;
* a mixed-tenant query-load thread replaying each tenant's
  cache-admission feature rows through ``FleetServer.submit``,
  executing the timeline's poisoned micro-batches (malformed feature
  rows -> per-request isolation) and dead-ingest-peer timeouts
  (``soak.load``);
* the armed fault registry: device-death bursts fire inside the
  fleet's own ``serve.fleet.dispatch`` site (host fallback + breaker
  recovery), clock skews fire at the driver's two SLO clock stamps
  (``soak.clock``).

Every request outcome lands in the existing ``serve.fleet.*``
counters and the rolling mirror, which is what the verdict
(soak/report.py) evaluates the scenario's SLO spec against.

Thread discipline: every worker takes the parent ``SpanContext`` as its
``ctx`` parameter and re-installs it first thing; no unbounded blocking
primitives; every worker probes a registered fault site.  The tenants
train at once on one card: their growers are distinct (the grower cache
hands out idle growers only, and a killed tenant's last booster releases
its grower before the tenant resumes), and their graph builds take turns
(``ops/graphs.py::BUILD_LOCK``).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import obs
from ..obs import tracing
from ..obs.rolling import RollingRegistry
from ..pipeline.core import PipelineError, RetrainPipeline
from ..robust import faults
from ..robust.checkpoint import load_pipeline_checkpoint
from ..robust.retry import CircuitBreaker
from ..serve.fleet import FleetServer
from ..utils.log import LightGBMError
from .scenario import (NUM_FEATURES, SoakScenario, compile_timeline,
                       fault_spec, kill_points, poison_ticks,
                       timeline_digest)


class SoakDriver:
    """One scenario run -> an outcome dict for soak/report.py.  Trains and
    serves on ``device`` (the card by default).  The exporter writes
    ``<workdir>/stream.jsonl``; ``prom_path`` and ``http_port`` (0: a free
    port) add the exposition file and the scrape endpoint."""

    def __init__(self, scenario: SoakScenario,
                 workdir: Optional[str] = None, *, device="cuda",
                 prom_path: Optional[str] = None,
                 http_port: Optional[int] = None):
        self.sc = scenario.validate()
        self.device = str(device)
        self.prom_path = prom_path
        self.http_port = http_port
        self.workdir = (workdir or scenario.checkpoint_dir
                        or tempfile.mkdtemp(prefix="lgbm_soak_"))
        self.events = compile_timeline(self.sc)
        self.spec = fault_spec(self.sc, self.events)
        self.digest = timeline_digest(self.sc, self.events)
        self._kill_points = kill_points(self.events)
        self._poison_ticks = poison_ticks(self.events)
        self.fleet: Optional[FleetServer] = None
        self._lock = threading.Lock()
        self._stop_load = threading.Event()
        self._killed: set = set()          # (tenant, window) fired
        self._kill_records: List[dict] = []
        self._tenant_errors: Dict[int, str] = {}
        self._window_log: Dict[int, List[dict]] = {}
        self._final_models: Dict[int, str] = {}
        self._futures: List = []
        self._load_stats = {"submitted": 0, "answered": 0,
                            "rejected": 0, "poison_sent": 0,
                            "dead_peer_timeouts": 0}
        self._clock_fired = 0
        self._t0 = time.perf_counter()
        #: (tenant, window, start s, end s) of every prep_fn call, from the
        #: run's start: what overlapped a window's training on the host
        self.prep_spans: List[tuple] = []

    # -- clock (soak.clock fault site) ---------------------------------
    def _clock(self) -> float:
        """Wall stamp for SLO bookkeeping; the timeline's clock-skew
        events fire here (main thread only, so the invocation index is
        deterministic: 0 = run start, 1 = verdict)."""
        try:
            faults.check("soak.clock")
        except faults.InjectedFault:
            with self._lock:
                self._clock_fired += 1
            obs.inc("soak.clock_skews")
        return time.time()

    def _params(self) -> dict:
        return {**self.sc.train_params(), "device": self.device}

    # -- bring-up -------------------------------------------------------
    def _bootstrap(self) -> List:
        """Train each tenant's generation-0 booster (the model serving
        before window 0's retrain lands) on its bootstrap window."""
        boosters = []
        for m in range(self.sc.tenants):
            pipe = RetrainPipeline(self._params(), warmup_rows=[])
            pipe.run([(m, -1)],
                     lambda key: self.sc.window_payload(*key))
            boosters.append(pipe.final_booster())
        return boosters

    def _build_fleet(self, boosters) -> FleetServer:
        sc = self.sc
        # fast re-probe so a transient device-death burst's dark time
        # stays small against the SLO window
        fleet = FleetServer(
            boosters, replicas=sc.replicas,
            num_features=NUM_FEATURES, device=self.device,
            breaker_factory=lambda _replica: CircuitBreaker(
                failure_threshold=2, reprobe_interval_s=0.05))
        fleet.start()
        fleet.warmup(sorted({sc.load_batch_rows, sc.query_rows}))
        return fleet

    # -- tenant retrain thread -----------------------------------------
    def _prep(self, key):
        """Window ingestion + feature derivation for one (tenant,
        window).  Scheduled kills fire here: a timeline point probes
        ``soak.kill`` exactly once (driver bookkeeping, so the armed
        n= budget maps 1:1 onto scheduled points no matter how tenant
        threads interleave); the pipeline surfaces the injected fault
        as ``PipelineError`` and the driver resumes from the
        checkpoint."""
        m, w = key
        with self._lock:
            scheduled = (w in self._kill_points.get(m, ())
                         and (m, w) not in self._killed)
        if scheduled:
            faults.check("soak.kill")
        t0 = time.perf_counter() - self._t0
        pw = self.sc.window_payload(m, w)
        with self._lock:
            self.prep_spans.append((m, w, t0,
                                    time.perf_counter() - self._t0))
        return pw

    def _on_window(self, res) -> None:
        m = int(res.meta.get("tenant", -1))
        rec = res.to_json()
        # the training's wall span from the run's start, to tell what ran
        # beside it (the other tenants' training and preps)
        rec["train_span"] = [round(t - self._t0, 3) for t in res.train_span]
        with self._lock:
            self._window_log.setdefault(m, []).append(rec)

    def _tenant_worker(self, m: int, ctx) -> None:
        tracing.set_current(ctx)
        sc = self.sc
        keys = [(m, w) for w in sc.schedule(m)]
        ckpt = os.path.join(self.workdir, f"tenant_{m}")
        params = self._params()
        pipe = RetrainPipeline(params, server=self.fleet, tenant_id=m,
                               checkpoint_dir=ckpt, warmup_rows=[],
                               keep_boosters=False)
        for _attempt in range(2 * len(keys) + 2):
            try:
                pipe.run(keys, self._prep, on_window=self._on_window)
                break
            except PipelineError as e:
                pos = int(e.window)
                window = keys[pos][1] if pos < len(keys) else -1
                obs.inc("soak.kills")
                with self._lock:
                    self._killed.add((m, window))
                # the killed pipeline's last booster hands its grower back
                # to the cache, idle, before the tenant resumes from disk
                last = pipe.final_booster()
                if last is not None:
                    last.release_grower()
                cp = load_pipeline_checkpoint(ckpt)
                rec = {"tenant": m, "window": window,
                       "payload_index": pos,
                       "checkpoint_window": (None if cp is None
                                             else int(cp.window)),
                       "resumed": False}
                try:
                    pipe = RetrainPipeline.resume(
                        ckpt, params, server=self.fleet, tenant_id=m,
                        warmup_rows=[], keep_boosters=False)
                    rec["resumed"] = True
                    obs.inc("soak.resumes")
                except LightGBMError as re_exc:
                    rec["resume_error"] = str(re_exc)
                    with self._lock:
                        self._kill_records.append(rec)
                    return
                with self._lock:
                    self._kill_records.append(rec)
            except LightGBMError as exc:
                with self._lock:
                    self._tenant_errors[m] = str(exc)
                return
        final = pipe.final_booster()
        if final is not None:
            with self._lock:
                self._final_models[m] = final.model_to_string()

    # -- query load thread ---------------------------------------------
    def _drain(self, keep: int) -> None:
        """Resolve finished futures, blocking (bounded) only when more
        than ``keep`` are still pending; a request the fleet failed —
        poison rows — counts as rejected."""
        with self._lock:
            pending = self._futures
            self._futures = []
        still = []
        for i, fut in enumerate(pending):
            if not fut.done() and (len(pending) - i) > keep:
                try:
                    fut.result(timeout=5.0)
                except Exception:
                    pass
            if fut.done():
                try:
                    fut.result()
                    ok = True
                except Exception:
                    ok = False
                with self._lock:
                    self._load_stats["answered" if ok
                                     else "rejected"] += 1
            else:
                still.append(fut)
        with self._lock:
            self._futures.extend(still)

    def _load_worker(self, ctx) -> None:
        tracing.set_current(ctx)
        sc = self.sc
        queries = [sc.query_block(m) for m in range(sc.tenants)]
        tick = 0
        while not self._stop_load.is_set():
            try:
                # the load generator's upstream feed: the timeline's
                # dead-ingest-peer run times out a contiguous span of
                # ticks (only this thread probes the site, so the
                # armed after=/n= indices ARE tick numbers)
                faults.check("soak.load")
            except (faults.InjectedFault, TimeoutError, OSError):
                with self._lock:
                    self._load_stats["dead_peer_timeouts"] += 1
                obs.inc("soak.dead_peer_timeouts")
                tick += 1
                self._stop_load.wait(sc.load_interval_s)
                continue
            m = tick % sc.tenants
            q = queries[m]
            rows = min(sc.load_batch_rows, q.shape[0])
            lo = (tick * rows) % max(1, q.shape[0] - rows + 1)
            batch = q[lo:lo + rows]
            if tick in self._poison_ticks:
                # malformed micro-batch: truncated feature rows, which
                # the fleet must isolate per-request (input_errors /
                # poisoned_batches), never poisoning neighbors
                batch = np.ascontiguousarray(
                    batch[:, :max(1, NUM_FEATURES // 8)])
                with self._lock:
                    self._load_stats["poison_sent"] += 1
                obs.inc("soak.poison_sent")
            fut = self.fleet.submit(m, batch)
            with self._lock:
                self._load_stats["submitted"] += 1
                self._futures.append(fut)
            self._drain(keep=64)
            tick += 1
            self._stop_load.wait(sc.load_interval_s)
        self._drain(keep=0)

    # -- byte-identity reference ---------------------------------------
    def _verify_kills(self) -> List[dict]:
        """For every tenant that took a kill: an uninterrupted
        reference pipeline (same params/payloads, no serving, faults
        disarmed by the caller) must produce a byte-identical final
        model — the check_faults.py contract at fleet scale."""
        out = []
        for m in sorted({r["tenant"] for r in self._kill_records}):
            keys = [(m, w) for w in self.sc.schedule(m)]
            ref = RetrainPipeline(self._params(), warmup_rows=[])
            ref.run(keys, lambda key: self.sc.window_payload(*key))
            ref_str = ref.final_booster().model_to_string()
            got = self._final_models.get(m)
            out.append({
                "tenant": m,
                "kills": sorted(r["window"] for r in
                                self._kill_records
                                if r["tenant"] == m),
                "resumed": all(r["resumed"] for r in
                               self._kill_records
                               if r["tenant"] == m),
                "byte_identical": got is not None and got == ref_str,
            })
        return out

    # -- run ------------------------------------------------------------
    def run(self) -> dict:
        sc = self.sc
        os.makedirs(self.workdir, exist_ok=True)
        stream_path = os.path.join(self.workdir, "stream.jsonl")
        # the SLO window must fit in the rolling ring
        # (slo.evaluate raises SloSpecError past capacity)
        buckets = max(128, int(sc.slo_window_s) + 60)
        obs.configure(enabled=True,
                      rolling=RollingRegistry(bucket_seconds=1.0,
                                              num_buckets=buckets),
                      stream_path=stream_path, prom_path=self.prom_path,
                      http_port=self.http_port,
                      export_interval_s=0.5)
        faults.configure(self.spec)
        started_unix = self._clock()
        t0 = self._t0 = time.perf_counter()
        outcome: dict = {
            "scenario": sc.to_json(),
            "device": self.device,
            "stream_path": stream_path,
            "fault_spec": self.spec,
            "timeline": [e.to_json() for e in self.events],
            "timeline_digest": self.digest,
            "workdir": self.workdir,
            "started_unix": round(started_unix, 3),
        }
        try:
            boosters = self._bootstrap()
            self.fleet = self._build_fleet(boosters)
            # the fleet holds their packs: the bootstrap boosters train no
            # more, so their growers go back to the cache, idle, for the
            # tenants' first windows to adopt
            for b in boosters:
                b.release_grower()
            del boosters
            root = (tracing.SpanContext(tracing.new_id())
                    if tracing.enabled() else None)
            load = threading.Thread(target=self._load_worker,
                                    args=(root,), name="lgbm-soak-load",
                                    daemon=True)
            load.start()
            workers = []
            for m in range(sc.tenants):
                t = threading.Thread(target=self._tenant_worker,
                                     args=(m, root),
                                     name=f"lgbm-soak-tenant-{m}",
                                     daemon=True)
                t.start()
                workers.append(t)
            for t in workers:
                t.join(timeout=600.0)
            alive = [t.name for t in workers if t.is_alive()]
            if alive:
                self._tenant_errors[-1] = \
                    f"tenant threads still alive: {alive}"
            self._stop_load.set()
            load.join(timeout=60.0)
            # evaluate the SLO on live state (before reference runs
            # pollute counters), then snapshot everything
            from ..obs import slo as slo_mod
            evaluated_unix = self._clock()
            slo_report = slo_mod.evaluate(sc.slo, now=evaluated_unix)
            obs.flush()
            export = (obs.summary().get("export") or {})
            snap = obs.registry().snapshot()
            counters = {k: v for k, v in snap["counters"].items()
                        if k.split(".")[0] in ("serve", "fault",
                                               "soak", "pipeline")}
            fault_counts = dict(faults.counts())
        finally:
            if self.fleet is not None:
                self.fleet.stop()
            faults.clear()
        byte_identity = self._verify_kills()
        with self._lock:
            outcome.update({
                "elapsed_s": round(time.perf_counter() - t0, 3),
                "evaluated_unix": round(evaluated_unix, 3),
                "slo": slo_report,
                "windows": {str(m): v for m, v in
                            sorted(self._window_log.items())},
                "kills": list(self._kill_records),
                "byte_identity": byte_identity,
                "tenant_errors": {str(m): v for m, v in
                                  self._tenant_errors.items()},
                "load": dict(self._load_stats),
                "clock_faults_fired": self._clock_fired,
                "counters": counters,
                "export": export,
                "fault_counts": fault_counts,
            })
        return outcome


def run_scenario(sc: SoakScenario, workdir: Optional[str] = None,
                 **kwargs) -> dict:
    """Convenience: drive one scenario and return its outcome
    (``kwargs``: :class:`SoakDriver`'s ``device``, ``prom_path``,
    ``http_port``)."""
    return SoakDriver(sc, workdir=workdir, **kwargs).run()
