"""Structured trace events: spans, instants, counter samples.

Counterpart of ``lightgbm_tpu/obs/events.py``, with the same two export
formats and event schema.

Events accumulate in a bounded in-memory buffer and export in two
formats:

* **JSONL** — one JSON object per line, schema-stable, for ad-hoc
  ``jq``/pandas analysis of a run;
* **Chrome trace** (the ``chrome://tracing`` / Perfetto JSON array
  format) — complete ``"ph": "X"`` events with microsecond timestamps
  relative to the buffer's epoch, so a whole training run or a
  windowed-retrain session renders as a timeline.

The buffer is capped (no unbounded growth inside a long retrain loop);
overflow drops the newest events and the drop count is reported in the
metrics snapshot — a truncated trace is never silently complete.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

#: hard cap on buffered events; beyond it events are dropped and counted
MAX_EVENTS = 200_000


class Event:
    __slots__ = ("name", "cat", "kind", "t0", "dur", "tid", "args")

    def __init__(self, name, cat, kind, t0, dur, tid, args):
        self.name = name
        self.cat = cat
        self.kind = kind          # "span" | "instant" | "counter"
        self.t0 = t0              # perf_counter seconds
        self.dur = dur            # seconds (spans only)
        self.tid = tid
        self.args = args


class TraceBuffer:
    """Bounded, thread-safe event buffer with two exporters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Event] = []
        self.dropped = 0
        # tid -> thread name at first sight, so exports can label the
        # prep/serve/fleet worker lanes (Perfetto reads thread_name
        # metadata; raw tids interleave unreadably)
        self._thread_names: Dict[int, str] = {}
        # perf_counter origin and the wall-clock it corresponds to, so
        # JSONL lines carry absolute times while chrome ts stay relative
        self.epoch_perf = time.perf_counter()
        self.epoch_unix = time.time()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def add(self, name: str, *, cat: str = "train", kind: str = "span",
            t0: Optional[float] = None, dur: float = 0.0,
            args: Optional[Dict] = None) -> None:
        tid = threading.get_ident()
        ev = Event(name, cat, kind,
                   time.perf_counter() if t0 is None else t0,
                   dur, tid, args or {})
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            if len(self._events) >= MAX_EVENTS:
                self.dropped += 1
                return
            self._events.append(ev)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._thread_names.clear()
            self.epoch_perf = time.perf_counter()
            self.epoch_unix = time.time()

    def thread_names(self) -> Dict[int, str]:
        """tid -> thread name for every thread that recorded an event."""
        with self._lock:
            return dict(self._thread_names)

    def _copy(self) -> List[Event]:
        with self._lock:
            return list(self._events)

    # -- exporters --------------------------------------------------------
    def to_jsonl(self, path: str) -> int:
        """One JSON object per line; returns the number written."""
        events = self._copy()
        names = self.thread_names()
        with open(path, "w") as fh:
            for ev in events:
                rec = {
                    "t_unix": round(self.epoch_unix
                                    + (ev.t0 - self.epoch_perf), 6),
                    "name": ev.name,
                    "cat": ev.cat,
                    "kind": ev.kind,
                    "tid": ev.tid,
                    "thread": names.get(ev.tid, ""),
                }
                if ev.kind == "span":
                    rec["dur_s"] = round(ev.dur, 6)
                if ev.args:
                    rec["args"] = ev.args
                fh.write(json.dumps(rec) + "\n")
        return len(events)

    def to_chrome(self, path: str) -> int:
        """Chrome-trace JSON object; loads in Perfetto / chrome://tracing.

        Spans become complete events (``ph: "X"``), instants ``ph: "i"``
        (thread-scoped), counter samples ``ph: "C"``.  Timestamps are
        microseconds since the buffer epoch.
        """
        events = self._copy()
        out = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "lightgbm_tpu_torch"},
        }]
        # one thread_name metadata event per recording thread: Perfetto
        # labels the lanes (prep / serve / fleet workers) instead of
        # showing raw interleaved tids
        for tid, tname in sorted(self.thread_names().items()):
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"name": tname}})
        for ev in events:
            ts = (ev.t0 - self.epoch_perf) * 1e6
            base = {"name": ev.name, "cat": ev.cat, "pid": 0,
                    "tid": ev.tid, "ts": round(ts, 3)}
            if ev.kind == "span":
                base["ph"] = "X"
                base["dur"] = round(ev.dur * 1e6, 3)
                if ev.args:
                    base["args"] = ev.args
            elif ev.kind == "counter":
                base["ph"] = "C"
                base["args"] = ev.args
            else:
                base["ph"] = "i"
                base["s"] = "t"
                if ev.args:
                    base["args"] = ev.args
            out.append(base)
        with open(path, "w") as fh:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, fh)
        return len(events)
