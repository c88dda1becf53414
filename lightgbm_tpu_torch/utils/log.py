"""Errors and log messages of the port.

Counterpart of ``lightgbm_tpu/utils/log.py``, on the standard ``logging``
module (logger ``lightgbm_tpu_torch``): a caller sets levels and handlers
there instead of through package state.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger("lightgbm_tpu_torch")


class LightGBMError(RuntimeError):
    """Error raised by the framework (reference: Log::Fatal throw)."""


def log_info(msg: str) -> None:
    logger.info(msg)


def log_warning(msg: str) -> None:
    logger.warning(msg)


#: optional observer called as ``sink(tag, seconds)`` on every
#: ``Timer.stop``; telemetry installs one while it is on, so phase timings
#: also land in its registries (``phase.<tag>`` timings)
_TIMER_SINK: Optional[Callable[[str, float], None]] = None
_state_lock = threading.Lock()


def set_timer_sink(sink: Optional[Callable[[str, float], None]]) -> None:
    global _TIMER_SINK
    with _state_lock:
        _TIMER_SINK = sink


class Timer:
    """Accumulating per-phase wall-clock timer (``lightgbm_tpu/utils/
    log.py::Timer``): ``start(tag)`` / ``stop(tag)`` accumulate totals and
    call counts.  Thread-safe.  With ``sync`` on, :meth:`stop_sync` waits
    for the card before stopping the clock, so a phase's time holds the
    device work it queued (one device sync a phase; off in production)."""

    def __init__(self):
        self.acc: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._t0: Dict[str, float] = {}
        self.sync = False
        self._lock = threading.Lock()

    def start(self, tag: str) -> None:
        with self._lock:
            self._t0[tag] = time.perf_counter()

    def stop(self, tag: str) -> None:
        with self._lock:
            t0 = self._t0.pop(tag, None)
            if t0 is None:
                return
            dt = time.perf_counter() - t0
            self.acc[tag] = self.acc.get(tag, 0.0) + dt
            self.counts[tag] = self.counts.get(tag, 0) + 1
        sink = _TIMER_SINK
        if sink is not None:
            sink(tag, dt)

    def stop_sync(self, tag: str, value=None):
        """Stop after waiting for ``value``'s device work when ``sync`` is
        on; returns ``value``."""
        device = getattr(value, "device", None)
        if self.sync and device is not None and device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
        self.stop(tag)
        return value

    def reset(self) -> None:
        with self._lock:
            self.acc.clear()
            self.counts.clear()
            self._t0.clear()


#: the process-wide timer of the host learner's phases
TRAIN_TIMER = Timer()
