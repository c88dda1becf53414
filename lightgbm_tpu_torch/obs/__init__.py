"""Structured telemetry: metrics registry, trace events, CUDA-graph capture
and device-memory tracking.

Counterpart of ``lightgbm_tpu/obs/__init__.py``.  One process-global
:class:`~.state.ObsState` backs the whole subsystem.  Everything is **off
by default** and every instrumentation site reduces to a single flag check
when disabled, so the hot path pays nothing: :func:`span` returns a shared
null span and allocates nothing.

Enable it three ways (any one suffices):

* config params: ``metrics_enabled=true`` and/or any output path —
  ``metrics_path`` / ``trace_path`` / ``events_path`` (picked up by
  ``GBDT.init_train`` and ``RetrainPipeline.run``);
* env vars: ``LGBM_TPU_METRICS=<path|1>`` / ``LGBM_TPU_TRACE=<path>`` /
  ``LGBM_TPU_EVENTS=<path.jsonl>`` / ``LGBM_TPU_TRACE_CTX=1``, the JAX
  package's names; snapshot files are written at process exit;
* programmatically: ``obs.configure(enabled=True, ...)``.

Not ported (refused by name where a parameter selects them): the
streaming exporter (``stream_path``, ``prom_path``, ``obs_http_port``,
``obs_export_interval``), the rolling windows, the SLO engine and the XLA
cost attribution (``profile_attribution``).

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
from . import tracing  # noqa: F401  (re-export)
from .registry import MetricsRegistry  # noqa: F401  (re-export)
from .state import STATE

SCHEMA_NAME = "lightgbm-tpu-torch-metrics"
SCHEMA_VERSION = 1

__all__ = [
    "enabled", "configure", "configure_from_config", "reset", "registry",
    "tracing", "capture_track", "inc", "set_gauge", "max_gauge", "observe",
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


def configure(enabled: Optional[bool] = None,
              metrics_path: Optional[str] = None,
              trace_path: Optional[str] = None,
              events_path: Optional[str] = None,
              sync: Optional[bool] = None,
              trace_context: Optional[bool] = None) -> None:
    """Update the global observability state.

    Additive: ``None`` leaves a setting untouched, and enabling twice
    keeps the accumulated registry/trace (windowed retraining wants
    cross-window totals).  Use :func:`reset` for a clean slate."""
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
    if enabled is not None:
        STATE.enabled = bool(enabled)
    if STATE.enabled and (STATE.metrics_path or STATE.trace_path
                          or STATE.events_path):
        _register_atexit()


def configure_from_config(cfg) -> None:
    """Pick up ``metrics_enabled`` / the telemetry paths from a Config.

    Called on every ``GBDT.init_train`` — once per retrain window — so it
    is cheap and never *disables* telemetry another component turned on.
    The options of the unported exporter are refused by
    ``ops/grow.py::check_config_options`` before training starts."""
    want = bool(getattr(cfg, "metrics_enabled", False))
    trace_path = str(getattr(cfg, "trace_path", "") or "")
    metrics_path = str(getattr(cfg, "metrics_path", "") or "")
    events_path = str(getattr(cfg, "events_path", "") or "")
    trace_ctx = bool(getattr(cfg, "trace_context_enabled", False))
    if not (want or trace_path or metrics_path or events_path
            or trace_ctx):
        return
    configure(enabled=True, metrics_path=metrics_path or None,
              trace_path=trace_path or None,
              events_path=events_path or None,
              trace_context=True if trace_ctx else None)


def reset() -> None:
    """Clear all accumulated metrics and events (keeps enabled/paths)."""
    STATE.registry.reset()
    STATE.trace.reset()
    STATE._mem_unavailable = False
    STATE._trace_flushed = None


# ---------------------------------------------------------------------------
# recording primitives
# ---------------------------------------------------------------------------

def inc(name: str, value: int = 1) -> None:
    if STATE.enabled:
        STATE.registry.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    if STATE.enabled:
        STATE.registry.set_gauge(name, value)


def max_gauge(name: str, value: float) -> None:
    if STATE.enabled:
        STATE.registry.max_gauge(name, value)


def observe(name: str, seconds: float) -> None:
    if STATE.enabled:
        STATE.registry.observe(name, seconds)


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
    return doc


def summary() -> Dict:
    """Compact digest: captures per name, iteration p50/p95, peak device
    memory, and the serving and pipeline digests when those ran."""
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
    injected = sum(v for k, v in snap["counters"].items()
                   if k.startswith("fault."))
    retries = snap["counters"].get("retry.attempts", 0)
    if injected or retries:
        out["robust"] = {
            "faults_injected": injected,
            "retry_attempts": retries,
            "checkpoints": snap["counters"].get("pipeline.checkpoints", 0),
            "snapshots": snap["counters"].get("train.snapshots", 0),
        }
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


def _register_atexit() -> None:
    if STATE._atexit_registered:
        return
    import atexit
    atexit.register(flush)
    STATE._atexit_registered = True


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
    trace_ctx = os.environ.get("LGBM_TPU_TRACE_CTX", "").lower() \
        in ("1", "true", "yes")
    if metrics.lower() in ("0", "false", "no"):
        metrics = ""
    if not (metrics or trace or events or trace_ctx):
        return
    configure(
        enabled=True,
        metrics_path=metrics if metrics.lower() not in ("1", "true", "yes")
        else None,
        trace_path=trace or None,
        events_path=events or None,
        sync=os.environ.get("LGBM_TPU_OBS_SYNC", "") in ("1", "true"),
        trace_context=True if trace_ctx else None,
    )


_configure_from_env()
