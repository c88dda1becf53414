"""Process-global observability state.

One module-level singleton keeps the enabled flag, the registry and the
trace buffer, so every instrumentation site shares the same fast-path
check: ``if not STATE.enabled: return`` (counterpart of
``lightgbm_tpu/obs/state.py``).
"""

from __future__ import annotations

from typing import Optional

from .events import TraceBuffer
from .registry import MetricsRegistry


class ObsState:
    __slots__ = ("enabled", "sync", "trace_context",
                 "profile_attribution", "registry", "trace", "rolling",
                 "rolling_opt_out", "exporter", "last_slo",
                 "pending_slo_spec",
                 "metrics_path", "trace_path", "events_path",
                 "_atexit_registered", "_mem_unavailable", "_trace_flushed")

    def __init__(self):
        self.enabled = False
        # when True, a span with a ``sync_value`` waits for the card before
        # stopping its clock (one device sync a span: honest attribution,
        # serialises the host against the card; off for production runs)
        self.sync = False
        # causal trace-context propagation (obs/tracing.py): spans gain
        # trace_id/span_id/parent_id; off = zero context objects
        self.trace_context = False
        # attach counted FLOPs / bytes to the profile probes
        # (obs/profile.py::cost_of)
        self.profile_attribution = False
        self.registry = MetricsRegistry()
        self.trace = TraceBuffer()
        # rolling-window mirror of the registry (obs/rolling.py): made when
        # telemetry is enabled, None while disabled so the hot path stays a
        # single flag check; rolling_opt_out keeps an explicit
        # configure(rolling=False) across the per-window
        # configure_from_config calls
        self.rolling = None
        self.rolling_opt_out = False
        # background StreamExporter (obs/export.py), None until a stream or
        # prom path or a scrape port is configured
        self.exporter = None
        # the latest SloReport (obs/slo.py), in summary() and stream lines
        self.last_slo = None
        # a parsed SloSpec configured before any exporter exists, adopted
        # by the next exporter
        self.pending_slo_spec = None
        self.metrics_path: Optional[str] = None
        self.trace_path: Optional[str] = None
        self.events_path: Optional[str] = None
        self._atexit_registered = False
        self._mem_unavailable = False
        # (path, event_count, dropped) of the last trace write, so
        # repeated flushes skip re-serializing an unchanged buffer
        self._trace_flushed = None


STATE = ObsState()
