"""Readers of what the program records itself:

* the device clock its trees carry (``tree.device_clock``: ``start``,
  ``waves_start``, ``waves_end``, ``end`` and ``hist_ns``, nanoseconds
  of the card's ``%globaltimer``), stamped inside the trees' graphs;
* its spans in the traced stretch's profiler trace (``record_function``
  ranges, ``user_annotation`` events on the kernels' clock).

Each returns None when the program records nothing of the kind (a
program without the clock or the span)."""

from __future__ import annotations

from typing import List, Optional


def clocks(facts: dict) -> Optional[List]:
    """The device clocks of the traced trees, or None unless every one
    of them carries one."""
    trees = facts.get("trees") or []
    out = [getattr(t, "device_clock", None) for t in trees]
    if not out or any(c is None for c in out):
        return None
    return out


def tree_ns(cl) -> int:
    """Nanoseconds from each tree's first stamp to its last, summed."""
    return sum(c.end - c.start for c in cl)


def share_pct(part: float, whole: float) -> Optional[float]:
    """100 x ``part`` / ``whole``, not clamped; None without a whole."""
    if whole <= 0:
        return None
    return 100.0 * part / whole


def busy_pct(facts: dict) -> Optional[float]:
    """The traced trees' summed device time (first to last stamp) as a
    share of the stretch's host-clock seconds."""
    cl = clocks(facts)
    if cl is None:
        return None
    return share_pct(tree_ns(cl) * 1e-9, facts["wall_s"])


def span_s(facts: dict, name: str) -> Optional[float]:
    """Seconds of the program's spans ``name`` inside the stretch
    (``bench.window``), or None when the trace holds none."""
    tr = facts.get("trace")
    if tr is None:
        return None
    events = [e for e in tr.host if e.get("name") == name]
    if not events:
        return None
    us = 0.0
    for e in events:
        s = float(e["ts"])
        us += max(0.0, min(s + float(e["dur"]), tr.t1) - max(s, tr.t0))
    return us * 1e-6
