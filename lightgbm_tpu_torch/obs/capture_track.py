"""CUDA-graph capture tracking: count and attribute captures per signature.

Counterpart of ``lightgbm_tpu/obs/jit_track.py``.  The JAX package
compiles an XLA program per shape signature, and in the
retrain-every-window pattern a fresh grower re-traces.  The port compiles
nothing per shape: what it re-does per grower is the CUDA-graph capture of
a tree's pieces and the instantiation of the composed graph
(``ops/grow.py::DeviceGrower._graph``, ``ops/graphs.py``).  Every fresh
``DeviceGrower`` captures anew, so each retrain window pays its captures;
:func:`record` counts them by name and signature and times them, the way
``track_jit`` counts traces, and the pipeline reports captures per window.
The first load of each kernel library in a process (its ``nvcc`` build,
or the library found built) is recorded too, as ``build.<name>``
(``ops/build.py::load_library``): the counterpart of the kernel compiles
inside the JAX package's tracked XLA compiles.

When observability is disabled :func:`record` only adds to
:data:`COUNTS`, the process's always-on capture count (the warm-up report
reads it).
"""

from __future__ import annotations

import threading
from typing import Iterable

from .state import STATE

#: captures of this process, counted whether telemetry is on or off (under
#: :data:`_COUNTS_LOCK`: several threads may build growers at once)
COUNTS = {"captures": 0}
_COUNTS_LOCK = threading.Lock()


def signature_of(parts: Iterable) -> str:
    """``(a, b, ...)`` of the parts' reprs: the shapes and variant a
    capture keys on."""
    return "(" + ", ".join(str(p) for p in parts) + ")"


def record(name: str, signature: str, t0: float, seconds: float) -> None:
    """Count one capture of ``name`` at ``signature`` that started at
    ``t0`` (``time.perf_counter``) and took ``seconds`` of host time (the
    eager warm-up, the captures and the instantiation): a
    ``capture.<name>`` timing, the ``capture.total`` counter, the
    per-signature count and a ``capture:<name>`` trace span."""
    with _COUNTS_LOCK:
        COUNTS["captures"] += 1
    st = STATE
    if not st.enabled:
        return
    st.registry.record_capture(name, signature)
    st.registry.inc("capture.total")
    st.registry.observe(f"capture.{name}", seconds)
    st.trace.add(f"capture:{name}", cat="capture", t0=t0, dur=seconds,
                 args={"signature": signature})


def total() -> int:
    """Captures recorded since the last reset (all names)."""
    return STATE.registry.counter("capture.total")


def seconds() -> float:
    """Host seconds of the captures recorded since the last reset."""
    snap = STATE.registry.snapshot()["timings"]
    return sum(v["total_s"] for k, v in snap.items()
               if k.startswith("capture."))
