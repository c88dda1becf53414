"""Structured telemetry: metrics registry, trace events, CUDA-graph capture
and device-memory tracking.

Counterpart of ``lightgbm_tpu/obs/__init__.py``.  One process-global
:class:`~.state.ObsState` backs the whole subsystem.  Everything is **off
by default** and every instrumentation site reduces to a single flag check
when disabled, so the hot path pays nothing: :func:`span` returns a shared
null span and allocates nothing.

Enable it three ways (any one suffices):

* config params: ``metrics_enabled=true`` and/or any output path —
  ``metrics_path`` / ``trace_path`` / ``events_path`` / the streaming
  exporter's ``stream_path`` / ``prom_path`` / ``obs_http_port`` (picked
  up by ``GBDT.init_train`` and ``RetrainPipeline.run``);
* env vars: ``LGBM_TPU_METRICS=<path|1>`` / ``LGBM_TPU_TRACE=<path>`` /
  ``LGBM_TPU_EVENTS=<path.jsonl>`` / ``LGBM_TPU_STREAM`` /
  ``LGBM_TPU_PROM`` / ``LGBM_TPU_OBS_HTTP`` / ``LGBM_TPU_TRACE_CTX=1``,
  the JAX package's names; snapshot files are written at process exit
  (the stream and exposition files refresh live);
* programmatically: ``obs.configure(enabled=True, ...)``.

While telemetry is on, every ``inc`` / ``set_gauge`` / ``observe`` (and
every span) is mirrored into the rolling-window registry
(``obs/rolling.py``) that the SLO engine (``obs/slo.py``) and the
streaming exporter (``obs/export.py``) read; the host learner's phase
timer (``utils/log.py::TRAIN_TIMER``) lands as ``phase.<tag>`` timings.
``profile_attribution`` attaches counted costs (``obs/profile.py``) to the
grower's probes.

A span never synchronizes with the card unless sync profiling is on
(``configure(sync=True)`` / ``LGBM_TPU_OBS_SYNC=1``); then a span whose
``sync_value`` is set waits once for that tensor's device work, where the
JAX span blocks on its device value.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

from . import capture_track  # noqa: F401  (re-export)
from . import profile  # noqa: F401  (re-export)
from . import tracing  # noqa: F401  (re-export)
from .registry import MetricsRegistry  # noqa: F401  (re-export)
from .rolling import RollingRegistry
from .state import STATE

SCHEMA_NAME = "lightgbm-tpu-torch-metrics"
SCHEMA_VERSION = 1

__all__ = [
    "enabled", "configure", "configure_from_config", "reset", "registry",
    "rolling", "rolling_snapshot", "tracing", "profile", "capture_track",
    "inc", "set_gauge", "max_gauge", "observe",
    "span", "span_event", "instant", "counter_sample",
    "sample_device_memory", "device_memory_stats", "snapshot", "summary",
    "dump_metrics", "dump_trace", "dump_events_jsonl", "flush",
    "iteration_hooks",
]


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def enabled() -> bool:
    return STATE.enabled


def registry() -> MetricsRegistry:
    return STATE.registry


def rolling() -> Optional[RollingRegistry]:
    """The rolling-window mirror (None while telemetry is disabled)."""
    return STATE.rolling


def configure(enabled: Optional[bool] = None,
              metrics_path: Optional[str] = None,
              trace_path: Optional[str] = None,
              events_path: Optional[str] = None,
              sync: Optional[bool] = None,
              rolling=None,
              stream_path: Optional[str] = None,
              prom_path: Optional[str] = None,
              export_interval_s: Optional[float] = None,
              http_port: Optional[int] = None,
              slo_spec=None,
              trace_context: Optional[bool] = None,
              profile_attribution: Optional[bool] = None) -> None:
    """Update the global observability state.

    Additive: ``None`` leaves a setting untouched, and enabling twice
    keeps the accumulated registry/trace (windowed retraining wants
    cross-window totals).  Use :func:`reset` for a clean slate.

    Enabling also installs the rolling-window mirror (``rolling=False``
    opts out, and the opt-out sticks; a
    :class:`~.rolling.RollingRegistry` replaces it).  ``stream_path``
    (JSONL time series), ``prom_path`` (Prometheus exposition file) and
    ``http_port`` (a ``127.0.0.1`` scrape endpoint; 0 picks a free port)
    start the background :class:`~.export.StreamExporter`, flushing every
    ``export_interval_s`` seconds (default 5); ``slo_spec`` makes each
    flush carry a fresh SLO evaluation.  ``trace_context`` turns causal
    span propagation on/off (obs/tracing.py); ``profile_attribution``
    attaches counted costs to the grower's probes (obs/profile.py)."""
    if metrics_path:
        STATE.metrics_path = metrics_path
    if trace_path:
        STATE.trace_path = trace_path
    if events_path:
        STATE.events_path = events_path
    if sync is not None:
        STATE.sync = bool(sync)
    if trace_context is not None:
        STATE.trace_context = bool(trace_context)
    if profile_attribution is not None:
        STATE.profile_attribution = bool(profile_attribution)
    if enabled is not None:
        was = STATE.enabled
        STATE.enabled = bool(enabled)
        if STATE.enabled and not was:
            _install_timer_sink()
        elif was and not STATE.enabled:
            _remove_timer_sink()
    if rolling is False:
        # sticky: the per-window configure_from_config calls pass
        # rolling=None and must not undo an explicit opt-out
        STATE.rolling = None
        STATE.rolling_opt_out = True
    elif isinstance(rolling, RollingRegistry):
        STATE.rolling = rolling
        STATE.rolling_opt_out = False
    elif rolling is True:
        STATE.rolling_opt_out = False
    if (STATE.enabled and STATE.rolling is None
            and not STATE.rolling_opt_out):
        STATE.rolling = RollingRegistry()
    if slo_spec is not None:
        # parsed here, so a typo raises at configure time even without an
        # exporter; an exporter started later (or running) adopts it
        from .slo import SloSpec
        if isinstance(slo_spec, str):
            slo_spec = SloSpec.parse(slo_spec)
        STATE.pending_slo_spec = slo_spec
        if STATE.exporter is not None and not (
                stream_path or prom_path or http_port is not None):
            STATE.exporter.set_slo_spec(slo_spec)
    if stream_path or prom_path or http_port is not None:
        _ensure_exporter(stream_path, prom_path, export_interval_s,
                         http_port, slo_spec)
    if STATE.enabled and (STATE.metrics_path or STATE.trace_path
                          or STATE.events_path
                          or STATE.exporter is not None):
        _register_atexit()


def _ensure_exporter(stream_path, prom_path, export_interval_s,
                     http_port, slo_spec) -> None:
    """Start (or retarget) the background exporter.  Idempotent for the
    per-window ``configure_from_config`` call: matching targets only
    update the interval and the spec, the threads keep running.  Additive
    like the rest of configure(): a target not given keeps the running
    exporter's (an env-started stream and a param-added prom file
    coexist)."""
    from .export import StreamExporter
    if slo_spec is None:
        slo_spec = STATE.pending_slo_spec
    exp = STATE.exporter
    if exp is not None:
        stream_path = stream_path or exp.stream_path
        prom_path = prom_path or exp.prom_path
        if http_port is None:
            http_port = exp._http_port_requested
        if exp.matches(stream_path, prom_path, http_port):
            if export_interval_s:
                exp.interval_s = max(float(export_interval_s), 0.05)
            if slo_spec is not None:
                exp.set_slo_spec(slo_spec)
            return
        exp.stop()
    STATE.exporter = StreamExporter(
        stream_path=stream_path, prom_path=prom_path,
        interval_s=export_interval_s or 5.0,
        http_port=http_port, slo_spec=slo_spec).start()


def configure_from_config(cfg) -> None:
    """Pick up ``metrics_enabled`` / the telemetry paths / the exporter's
    targets from a Config.

    Called on every ``GBDT.init_train`` — once per retrain window — so it
    is cheap and never *disables* telemetry another component turned
    on."""
    want = bool(getattr(cfg, "metrics_enabled", False))
    trace_path = str(getattr(cfg, "trace_path", "") or "")
    metrics_path = str(getattr(cfg, "metrics_path", "") or "")
    events_path = str(getattr(cfg, "events_path", "") or "")
    stream_path = str(getattr(cfg, "stream_path", "") or "")
    prom_path = str(getattr(cfg, "prom_path", "") or "")
    http_port = int(getattr(cfg, "obs_http_port", 0) or 0)
    trace_ctx = bool(getattr(cfg, "trace_context_enabled", False))
    profile_attr = bool(getattr(cfg, "profile_attribution", False))
    if not (want or trace_path or metrics_path or events_path
            or stream_path or prom_path or http_port or trace_ctx
            or profile_attr):
        return
    configure(enabled=True, metrics_path=metrics_path or None,
              trace_path=trace_path or None,
              events_path=events_path or None,
              stream_path=stream_path or None,
              prom_path=prom_path or None,
              export_interval_s=float(getattr(
                  cfg, "obs_export_interval", 0) or 0) or None,
              http_port=http_port if http_port > 0 else None,
              # additive: a later window's config without the flag does
              # not turn propagation off
              trace_context=True if trace_ctx else None,
              profile_attribution=True if profile_attr else None)


def reset() -> None:
    """Clear all accumulated metrics and events (keeps enabled/paths)."""
    STATE.registry.reset()
    STATE.trace.reset()
    if STATE.rolling is not None:
        STATE.rolling.reset()
    STATE.last_slo = None
    STATE._mem_unavailable = False
    STATE._trace_flushed = None


# ---------------------------------------------------------------------------
# recording primitives
# ---------------------------------------------------------------------------

def inc(name: str, value: int = 1) -> None:
    if STATE.enabled:
        STATE.registry.inc(name, value)
        r = STATE.rolling
        if r is not None:
            r.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    if STATE.enabled:
        STATE.registry.set_gauge(name, value)
        r = STATE.rolling
        if r is not None:
            r.set_gauge(name, value)


def max_gauge(name: str, value: float) -> None:
    if STATE.enabled:
        STATE.registry.max_gauge(name, value)


def observe(name: str, seconds: float) -> None:
    if STATE.enabled:
        STATE.registry.observe(name, seconds)
        r = STATE.rolling
        if r is not None:
            r.observe(name, seconds)


class _NullSpan:
    """Shared no-op context manager: the disabled fast path allocates
    nothing.  ``sync_value`` accepts and discards writes, so the
    ``sp.sync_value = tensor`` pattern is safe whether or not telemetry is
    on, without the shared singleton keeping a device tensor alive."""

    __slots__ = ()

    @property
    def sync_value(self):
        return None

    @sync_value.setter
    def sync_value(self, value):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass


_NULL_SPAN = _NullSpan()


def _wait_for(value) -> None:
    """Wait for the device work that produces ``value`` (a tensor on the
    card): one device sync.  Host values need no wait."""
    device = getattr(value, "device", None)
    if device is not None and device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


class _Span:
    __slots__ = ("name", "cat", "args", "t0", "sync_value",
                 "trace_id", "span_id", "parent_id", "_ctx_token")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args
        self.sync_value = None
        if STATE.trace_context:
            # the current context for everything opened inside this span
            # on this thread; a cross-thread parent arrives through
            # tracing.set_current before the span
            parent = tracing._CURRENT.get()
            self.trace_id = (parent.trace_id if parent is not None
                             else tracing.new_id())
            self.span_id = tracing.new_id()
            self.parent_id = (parent.span_id if parent is not None
                              else None)
            self._ctx_token = tracing._CURRENT.set(
                tracing.SpanContext(self.trace_id, self.span_id))
        else:
            self.trace_id = self.span_id = self.parent_id = None
            self._ctx_token = None
        self.t0 = time.perf_counter()

    def set(self, **args):
        """Attach attributes after the span opened."""
        self.args.update(args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._ctx_token is not None:
            tracing._CURRENT.reset(self._ctx_token)
            self._ctx_token = None
        if STATE.sync and self.sync_value is not None:
            _wait_for(self.sync_value)
        dur = time.perf_counter() - self.t0
        STATE.registry.observe(self.name, dur)
        r = STATE.rolling
        if r is not None:
            r.observe(self.name, dur)
        if self.span_id is not None:
            self.args["trace_id"] = self.trace_id
            self.args["span_id"] = self.span_id
            if self.parent_id is not None:
                self.args["parent_id"] = self.parent_id
        STATE.trace.add(self.name, cat=self.cat, t0=self.t0, dur=dur,
                        args=self.args or None)
        return False


def span(name: str, cat: str = "train", **args):
    """Timed span: ``with obs.span("grow_tree", iter=k): ...``.

    Records a timing observation under ``name`` and a trace event.  Set
    ``span.sync_value = tensor`` inside the block to make the exit wait for
    the card when sync profiling is on (honest device attribution; never
    in production runs)."""
    if not STATE.enabled:
        return _NULL_SPAN
    return _Span(name, cat, dict(args) if args else {})


def span_event(name: str, t0: float, dur: float, cat: str = "serve",
               **args) -> None:
    """Record a completed span from explicit timestamps (work whose start
    and end were observed on different threads)."""
    if STATE.enabled:
        STATE.trace.add(name, cat=cat, t0=t0, dur=dur, args=args or None)


def instant(name: str, cat: str = "train", **args) -> None:
    """Zero-duration marker event."""
    if STATE.enabled:
        STATE.trace.add(name, cat=cat, kind="instant", args=args or None)


def counter_sample(name: str, cat: str = "mem", **values) -> None:
    """Chrome-trace counter track sample (renders as a stacked area)."""
    if STATE.enabled:
        STATE.trace.add(name, cat=cat, kind="counter", args=values)


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

def device_memory_stats() -> Optional[Dict[str, int]]:
    """``bytes_in_use`` / ``peak_bytes_in_use`` of the current card from
    the caching allocator's counters (``torch.cuda.memory_stats``: host
    bookkeeping, no device sync), or None without an initialized card."""
    if STATE._mem_unavailable:
        return None
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    stats = torch.cuda.memory_stats()
    if not stats:
        STATE._mem_unavailable = True
        return None
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0))}


def sample_device_memory() -> None:
    """Record bytes-in-use / peak gauges and a trace counter sample."""
    if not STATE.enabled or STATE._mem_unavailable:
        return
    stats = device_memory_stats()
    if stats is None:
        return
    STATE.registry.set_gauge("device.bytes_in_use", stats["bytes_in_use"])
    counter_sample("device_memory", bytes_in_use=stats["bytes_in_use"])
    STATE.registry.max_gauge("device.peak_bytes_in_use",
                             stats["peak_bytes_in_use"])


# ---------------------------------------------------------------------------
# snapshot / export
# ---------------------------------------------------------------------------

def snapshot() -> Dict:
    """Full schema-versioned metrics document."""
    doc = {
        "schema": SCHEMA_NAME,
        "schema_version": SCHEMA_VERSION,
        "created_unix": round(STATE.registry.created_unix, 3),
        "snapshot_unix": round(time.time(), 3),
        "enabled": STATE.enabled,
    }
    doc.update(STATE.registry.snapshot())
    doc["device_memory"] = device_memory_stats()
    doc["events"] = {"recorded": len(STATE.trace),
                     "dropped": STATE.trace.dropped}
    doc["rolling"] = (STATE.rolling.window()
                      if STATE.rolling is not None else None)
    doc["slo"] = (STATE.last_slo.digest()
                  if STATE.last_slo is not None else None)
    return doc


def rolling_snapshot(window_s: Optional[float] = None) -> Optional[Dict]:
    """The rolling-window document alone (None while disabled)."""
    if STATE.rolling is None:
        return None
    return STATE.rolling.window(window_s)


def summary() -> Dict:
    """Compact digest: captures per name, iteration p50/p95, peak device
    memory, and the serving, fleet, robustness, soak, SLO, exporter and
    pipeline digests when those ran."""
    snap = STATE.registry.snapshot()
    iter_stat = snap["timings"].get("train.iter")
    out = {
        "captures": {k: v["captures"] for k, v in snap["captures"].items()},
        "captures_total": sum(v["captures"]
                              for v in snap["captures"].values()),
        "iter_p95_ms": round(iter_stat["p95_s"] * 1e3, 2)
        if iter_stat else None,
        "iter_p50_ms": round(iter_stat["p50_s"] * 1e3, 2)
        if iter_stat else None,
        "peak_device_bytes": STATE.registry.gauge(
            "device.peak_bytes_in_use"),
        "events_recorded": len(STATE.trace),
    }
    serve_stat = snap["timings"].get("serve.predict")
    if serve_stat:
        out["serve"] = {
            "predicts": serve_stat["count"],
            "predict_p50_ms": round(serve_stat["p50_s"] * 1e3, 3),
            "predict_p95_ms": round(serve_stat["p95_s"] * 1e3, 3),
            "swaps": snap["counters"].get("serve.swaps", 0),
            "rows": snap["counters"].get("serve.rows", 0),
        }
    fleet_stat = snap["timings"].get("serve.fleet.predict")
    if fleet_stat:
        out["fleet"] = {
            "predicts": fleet_stat["count"],
            "predict_p50_ms": round(fleet_stat["p50_s"] * 1e3, 3),
            "predict_p95_ms": round(fleet_stat["p95_s"] * 1e3, 3),
            "tenants": snap["gauges"].get("serve.fleet.tenants"),
            "replicas": snap["gauges"].get("serve.fleet.replicas"),
            "swaps": snap["counters"].get("serve.fleet.swaps", 0),
            "swap_shape_changes": snap["counters"].get(
                "serve.fleet.swap_shape_changes", 0),
            "rows": snap["counters"].get("serve.fleet.rows", 0),
            "fallback_requests": snap["counters"].get(
                "serve.fleet.fallback_requests", 0),
            "degraded_replicas": snap["gauges"].get(
                "serve.fleet.degraded_replicas"),
        }
    injected = sum(v for k, v in snap["counters"].items()
                   if k.startswith("fault."))
    retries = snap["counters"].get("retry.attempts", 0)
    fallback = snap["counters"].get("serve.fallback_requests", 0)
    if injected or retries or fallback:
        degraded = snap["timings"].get("serve.degraded_time")
        out["robust"] = {
            "faults_injected": injected,
            "retry_attempts": retries,
            "fallback_requests": fallback,
            "device_failures": snap["counters"].get(
                "serve.device_failures", 0),
            "degraded": snap["gauges"].get("serve.degraded"),
            "degraded_time_s": round(degraded["total_s"], 3)
            if degraded else 0.0,
            "checkpoints": snap["counters"].get("pipeline.checkpoints", 0),
            "snapshots": snap["counters"].get("train.snapshots", 0),
        }
    if any(k.startswith("soak.") for k in snap["counters"]):
        # a chaos soak ran (soak/): its injected chaos beside the serving
        # digest
        out["soak"] = {
            "kills": snap["counters"].get("soak.kills", 0),
            "resumes": snap["counters"].get("soak.resumes", 0),
            "poison_sent": snap["counters"].get("soak.poison_sent", 0),
            "dead_peer_timeouts": snap["counters"].get(
                "soak.dead_peer_timeouts", 0),
            "clock_skews": snap["counters"].get("soak.clock_skews", 0),
        }
    if STATE.last_slo is not None:
        out["slo"] = STATE.last_slo.digest()
    exp = STATE.exporter
    if exp is not None:
        out["export"] = {"flushes": exp.flushes, "dropped": exp.dropped,
                         "write_errors": exp.write_errors}
    windows = snap["counters"].get("pipeline.windows", 0)
    if windows:
        prep = snap["timings"].get("pipeline.prep")
        train = snap["timings"].get("pipeline.train")
        stall = snap["timings"].get("pipeline.stall")
        out["pipeline"] = {
            "windows": windows,
            "rebinds": snap["counters"].get("pipeline.rebinds", 0),
            "overlap_fraction": STATE.registry.gauge(
                "pipeline.overlap_fraction"),
            "prep_p50_s": round(prep["p50_s"], 3) if prep else None,
            "train_p50_s": round(train["p50_s"], 3) if train else None,
            "stall_total_s": round(stall["total_s"], 3) if stall
            else 0.0,
        }
    return out


def dump_metrics(path: Optional[str] = None) -> Optional[str]:
    """Write the snapshot to ``path`` atomically: a reader, or a write
    that fails midway (at process exit), never leaves a partial file."""
    path = path or STATE.metrics_path
    if not path:
        return None
    doc = json.dumps(snapshot(), indent=1)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        fh.write(doc)
    os.replace(tmp, path)
    return path


def dump_trace(path: Optional[str] = None) -> Optional[str]:
    path = path or STATE.trace_path
    if not path:
        return None
    # the buffer is cumulative and each write serializes all of it, so a
    # per-window flush loop skips writes when nothing new was recorded
    key = (path, len(STATE.trace), STATE.trace.dropped)
    if STATE._trace_flushed == key and os.path.exists(path):
        return path
    STATE.trace.to_chrome(path)
    STATE._trace_flushed = key
    return path


def dump_events_jsonl(path: Optional[str] = None) -> Optional[str]:
    path = path or STATE.events_path
    if not path:
        return None
    STATE.trace.to_jsonl(path)
    return path


def flush() -> None:
    """Write every configured output file (idempotent; cheap when no
    paths are configured)."""
    if not STATE.enabled:
        return
    dump_metrics()
    dump_trace()
    dump_events_jsonl()
    if STATE.exporter is not None:
        STATE.exporter.flush_now()


def _atexit_flush() -> None:
    # stop() writes the exporter's final line itself, so only the
    # snapshot files are written here (no duplicated last stream line)
    exp = STATE.exporter
    if exp is not None:
        exp.stop()
    if STATE.enabled:
        dump_metrics()
        dump_trace()
        dump_events_jsonl()


def _register_atexit() -> None:
    if STATE._atexit_registered:
        return
    import atexit
    atexit.register(_atexit_flush)
    STATE._atexit_registered = True


# ---------------------------------------------------------------------------
# TRAIN_TIMER bridge
# ---------------------------------------------------------------------------

def _timer_sink(tag: str, seconds: float) -> None:
    STATE.registry.observe(f"phase.{tag}", seconds)
    r = STATE.rolling
    if r is not None:
        r.observe(f"phase.{tag}", seconds)


def _install_timer_sink() -> None:
    from ..utils import log
    log.set_timer_sink(_timer_sink)


def _remove_timer_sink() -> None:
    from ..utils import log
    log.set_timer_sink(None)


# ---------------------------------------------------------------------------
# engine callback hook (CallbackEnv-compatible)
# ---------------------------------------------------------------------------

def iteration_hooks() -> Tuple:
    """(before, after) callbacks for ``engine.train``'s callback list.

    The pair times each boosting iteration end to end (update + eval +
    other callbacks), samples device memory, and emits eval results as
    instant events.  Both carry ``obs_hook``: the fused driver may call
    the pair once per chunk instead of once per iteration."""
    state = {}

    def _before(env):
        if STATE.enabled:
            state["t0"] = time.perf_counter()
    _before.before_iteration = True
    _before.order = -1000
    _before.obs_hook = True

    def _after(env):
        t0 = state.pop("t0", None)
        if t0 is None or not STATE.enabled:
            return
        dur = time.perf_counter() - t0
        STATE.registry.observe("engine.iter", dur)
        r = STATE.rolling
        if r is not None:
            r.observe("engine.iter", dur)
        STATE.trace.add("engine_iter", cat="engine", t0=t0, dur=dur,
                        args={"iteration": env.iteration})
        for rec in (env.evaluation_result_list or []):
            instant(f"eval:{rec[0]}:{rec[1]}", cat="eval",
                    iteration=env.iteration, value=float(rec[2]))
        sample_device_memory()
    _after.order = 1000
    _after.obs_hook = True

    return _before, _after


# ---------------------------------------------------------------------------
# env-var activation (no code change needed in embedding hosts)
# ---------------------------------------------------------------------------

def _configure_from_env() -> None:
    metrics = os.environ.get("LGBM_TPU_METRICS", "")
    trace = os.environ.get("LGBM_TPU_TRACE", "")
    events = os.environ.get("LGBM_TPU_EVENTS", "")
    stream = os.environ.get("LGBM_TPU_STREAM", "")
    prom = os.environ.get("LGBM_TPU_PROM", "")
    try:
        http_port = int(os.environ.get("LGBM_TPU_OBS_HTTP", "") or 0)
    except ValueError:
        http_port = 0
    trace_ctx = os.environ.get("LGBM_TPU_TRACE_CTX", "").lower() \
        in ("1", "true", "yes")
    if metrics.lower() in ("0", "false", "no"):
        metrics = ""
    if not (metrics or trace or events or stream or prom or http_port
            or trace_ctx):
        return
    configure(
        enabled=True,
        metrics_path=metrics if metrics.lower() not in ("1", "true", "yes")
        else None,
        trace_path=trace or None,
        events_path=events or None,
        stream_path=stream or None,
        prom_path=prom or None,
        http_port=http_port if http_port > 0 else None,
        sync=os.environ.get("LGBM_TPU_OBS_SYNC", "") in ("1", "true"),
        trace_context=True if trace_ctx else None,
    )


_configure_from_env()
