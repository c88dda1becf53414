"""Live telemetry export: JSONL time series, Prometheus exposition,
optional localhost scrape endpoint.

Counterpart of ``lightgbm_tpu/obs/export.py``, the same code: the
stream lines carry the JAX package's schema (``lightgbm-tpu-stream``
v1), so one validator reads both packages' series.

The cumulative registry dumps once at process exit; a soak run needs
the numbers *while it runs*.  :class:`StreamExporter` is a background
flusher that, every ``interval_s``:

* appends one schema-versioned JSON line (the rolling-window snapshot
  plus compact cumulative counters and the latest SLO digest) to
  ``stream_path`` — a time series ``jq``/pandas can plot live;
* atomically rewrites ``prom_path`` in the Prometheus text-exposition
  format (counters as ``_total``, gauges, timings as summaries whose
  quantiles come from the ROLLING window — the sliding-window
  semantics Prometheus client summaries have natively);
* serves the same exposition text at ``http://127.0.0.1:<port>/metrics``
  when a port is configured (opt-in; never binds by default).

**The export path can never stall training or serving.**  The hot path
does not know the exporter exists: snapshots are *pulled* by the ticker
thread, handed to the writer thread through a bounded queue with
``put_nowait`` — a jammed writer (dead disk, wedged NFS) drops the
snapshot and counts it (``export.dropped``), it never blocks.  Write
failures are counted (``export.write_errors``) and never raise into
the ticker.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from .state import STATE

STREAM_SCHEMA_NAME = "lightgbm-tpu-stream"
STREAM_SCHEMA_VERSION = 1

PROM_PREFIX = "lgbm_"
_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_SUB = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Legal Prometheus metric name for a dotted registry name."""
    out = PROM_PREFIX + _NAME_SUB.sub("_", name)
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def prometheus_text(cumulative: Dict,
                    rolling: Optional[Dict] = None) -> Tuple[str, int]:
    """Render a cumulative registry snapshot (plus optional rolling
    window) as Prometheus text exposition.  Returns ``(text,
    collisions)`` — collisions are raw names whose sanitized form was
    already emitted (skipped, so the exposition never carries duplicate
    samples)."""
    lines: List[str] = []
    seen = set()
    collisions = 0

    def fmt(v) -> str:
        return f"{float(v):.9g}"

    def emit(family: str, kind: str, samples) -> None:
        nonlocal collisions
        if family in seen:
            collisions += 1
            return
        seen.add(family)
        lines.append(f"# TYPE {family} {kind}")
        for suffix, labels, value in samples:
            lines.append(f"{family}{suffix}{labels} {fmt(value)}")

    roll_t = (rolling or {}).get("timings", {})
    for name, v in sorted(cumulative.get("counters", {}).items()):
        emit(sanitize_metric_name(name) + "_total", "counter",
             [("", "", v)])
    for name, v in sorted(cumulative.get("gauges", {}).items()):
        emit(sanitize_metric_name(name), "gauge", [("", "", v)])
    for name, stat in sorted(cumulative.get("timings", {}).items()):
        family = sanitize_metric_name(name) + "_seconds"
        roll = roll_t.get(name)
        # quantiles over the rolling window when it has samples (the
        # live SLO view); the process-lifetime reservoir otherwise
        src = roll if roll else stat
        samples = [("", '{quantile="0.5"}', src["p50_s"]),
                   ("", '{quantile="0.95"}', src["p95_s"])]
        if "p99_s" in src:
            samples.append(("", '{quantile="0.99"}', src["p99_s"]))
        samples += [("_sum", "", stat["total_s"]),
                    ("_count", "", stat["count"])]
        emit(family, "summary", samples)
    return "\n".join(lines) + "\n", collisions


def _inc(name: str, value: int = 1) -> None:
    """Counter bump through the same enabled gate as ``obs.inc`` (local
    to avoid an import cycle with ``obs/__init__``)."""
    if STATE.enabled:
        STATE.registry.inc(name, value)
        r = STATE.rolling
        if r is not None:
            r.inc(name, value)


class StreamExporter:
    """Background flusher (see module docstring).  ``slo_spec`` (a
    string or parsed :class:`~.slo.SloSpec`) makes every snapshot line
    carry a fresh SLO evaluation; without it, lines carry the last
    report something else evaluated (a CI gate, the soak's verdict)."""

    def __init__(self, *, stream_path: Optional[str] = None,
                 prom_path: Optional[str] = None,
                 interval_s: float = 5.0, queue_max: int = 8,
                 http_port: Optional[int] = None,
                 slo_spec=None, window_s: Optional[float] = None):
        self.stream_path = stream_path or None
        self.prom_path = prom_path or None
        self.interval_s = max(float(interval_s), 0.05)
        # 0 is meaningful (bind an ephemeral port, resolved on start);
        # the REQUESTED port is kept for matches() so re-configuring
        # with port 0 after resolution stays idempotent
        self.http_port = None if http_port is None else int(http_port)
        self._http_port_requested = self.http_port
        self.window_s = window_s
        self._slo_spec = None
        if slo_spec is not None:
            self.set_slo_spec(slo_spec)
        self._lock = threading.Lock()
        # serializes _write(): flush_now() runs on the CALLER's thread
        # and may race the writer thread on the same tmp/stream files
        self._write_lock = threading.Lock()
        self._queue: _queue.Queue = _queue.Queue(maxsize=max(queue_max, 1))
        self._stop = threading.Event()
        self._ticker: Optional[threading.Thread] = None
        self._writer: Optional[threading.Thread] = None
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        self._latest_prom = "# no snapshot yet\n"
        self._dropped = 0
        self._write_errors = 0
        self._flushes = 0
        self._slo_error_logged = False

    # -- introspection (lock-guarded: ticker/writer/callers race) -------
    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    @property
    def write_errors(self) -> int:
        with self._lock:
            return self._write_errors

    @property
    def flushes(self) -> int:
        with self._lock:
            return self._flushes

    def latest_prom_text(self) -> str:
        with self._lock:
            return self._latest_prom

    def matches(self, stream_path, prom_path, http_port) -> bool:
        return (self.stream_path == (stream_path or None)
                and self.prom_path == (prom_path or None)
                and self._http_port_requested
                == (None if http_port is None else int(http_port)))

    def set_slo_spec(self, spec) -> None:
        """Install the per-flush SLO spec.  A string is parsed HERE so
        a typo raises at configure time instead of being silently
        swallowed on every tick."""
        from .slo import SloSpec
        if isinstance(spec, str):
            spec = SloSpec.parse(spec)
        self._slo_spec = spec

    # -- snapshot assembly ----------------------------------------------
    def collect(self, now: Optional[float] = None) -> Dict:
        """One stream line: rolling window + compact cumulative tallies
        + the latest SLO digest.  Pure read — safe from any thread."""
        from . import slo as _slo
        now = time.time() if now is None else now
        rolling = STATE.rolling
        doc = {
            "schema": STREAM_SCHEMA_NAME,
            "schema_version": STREAM_SCHEMA_VERSION,
            "t_unix": round(now, 3),
        }
        if rolling is not None:
            doc.update(rolling.window(self.window_s, now))
        else:
            doc.update({"window_s": None, "counters": {},
                        "gauges": {}, "timings": {}})
        if self._slo_spec is not None:
            try:
                # the spec was parsed at set_slo_spec time; only the
                # evaluation itself is guarded (e.g. rolling opted out,
                # or window_s beyond the ring capacity)
                STATE.last_slo = self._slo_spec.evaluate(
                    rolling=rolling, now=now)
            except _slo.SloSpecError as e:
                # never silent: a spec that can NEVER evaluate would
                # otherwise just produce slo-less stream lines forever
                _inc("export.slo_errors")
                # and never stale: re-stamping the last successful
                # digest onto fresh lines would show a frozen "ok"
                # while the evaluation is failing
                STATE.last_slo = None
                with self._lock:
                    first = not self._slo_error_logged
                    self._slo_error_logged = True
                if first:
                    from ..utils.log import log_warning
                    log_warning(f"obs export: SLO spec cannot be "
                                f"evaluated ({e}); stream lines will "
                                f"carry no slo digest")
        if STATE.last_slo is not None:
            doc["slo"] = STATE.last_slo.digest()
        return doc

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "StreamExporter":
        with self._lock:
            if self._writer is not None and self._writer.is_alive():
                return self
            self._stop.clear()
            self._writer = threading.Thread(
                target=self._write_loop, name="lgbm-obs-writer",
                daemon=True)
            self._writer.start()
            self._ticker = threading.Thread(
                target=self._tick_loop, name="lgbm-obs-ticker",
                daemon=True)
            self._ticker.start()
        if self.http_port is not None:
            self._start_http()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop the threads; a final snapshot is written synchronously
        so the files always end on the freshest state."""
        self._stop.set()
        with self._lock:
            ticker, self._ticker = self._ticker, None
            writer, self._writer = self._writer, None
            httpd, self._httpd = self._httpd, None
            ht, self._http_thread = self._http_thread, None
        for t in (ticker, writer):
            if t is not None:
                t.join(timeout=timeout_s)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            if ht is not None:
                ht.join(timeout=timeout_s)
        self.flush_now()

    def __enter__(self) -> "StreamExporter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- hot-path-safe handoff -------------------------------------------
    def emit(self, now: Optional[float] = None) -> bool:
        """Snapshot and offer to the writer queue — NON-BLOCKING.  A
        full queue drops the snapshot (counted), it never waits.
        Chaos-armed at ``obs.export``: an injected fault here behaves
        exactly like a full queue (dropped + counted, never raised)."""
        from ..robust import faults
        try:
            faults.check("obs.export")
            doc = self.collect(now)
            self._queue.put_nowait(doc)
            return True
        except (_queue.Full, faults.InjectedFault):
            with self._lock:
                self._dropped += 1
            _inc("export.dropped")
            return False

    def flush_now(self, now: Optional[float] = None) -> Dict:
        """Synchronous snapshot + write on the CALLER's thread (used by
        ``obs.flush()`` and at exit; bypasses the queue so it cannot be
        dropped)."""
        doc = self.collect(now)
        self._write(doc)
        return doc

    # -- threads -----------------------------------------------------------
    def _tick_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.emit()

    def _write_loop(self) -> None:
        while True:
            try:
                doc = self._queue.get(timeout=0.2)
            except _queue.Empty:
                if self._stop.is_set():
                    return
                continue
            self._write(doc)

    def _write(self, doc: Dict) -> None:
        with self._write_lock:
            self._write_locked(doc)

    def _write_locked(self, doc: Dict) -> None:
        from ..robust import faults
        try:
            # chaos-armed: an injected fault on the writer thread takes
            # the same path as a real disk failure (counted, not raised)
            faults.check("obs.export")
            if self.stream_path:
                with open(self.stream_path, "a") as fh:
                    fh.write(json.dumps(doc) + "\n")
            if self.prom_path or self.http_port is not None:
                text, collisions = prometheus_text(
                    STATE.registry.snapshot(),
                    {"timings": doc.get("timings", {})})
                if collisions:
                    _inc("export.name_collisions", collisions)
                with self._lock:
                    self._latest_prom = text
                if self.prom_path:
                    tmp = f"{self.prom_path}.tmp.{os.getpid()}"
                    with open(tmp, "w") as fh:
                        fh.write(text)
                    os.replace(tmp, self.prom_path)
            with self._lock:
                self._flushes += 1
            _inc("export.flushes")
        except Exception:   # noqa: BLE001 — export never raises upward
            with self._lock:
                self._write_errors += 1
            _inc("export.write_errors")

    # -- scrape endpoint ---------------------------------------------------
    def _start_http(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 — stdlib API name
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = exporter.latest_prom_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # silence per-scrape stderr
                pass

        httpd = ThreadingHTTPServer(("127.0.0.1", int(self.http_port)),
                                    Handler)
        self.http_port = httpd.server_address[1]    # resolve port 0
        thread = threading.Thread(target=httpd.serve_forever,
                                  name="lgbm-obs-http", daemon=True)
        with self._lock:
            self._httpd = httpd
            self._http_thread = thread
        thread.start()
