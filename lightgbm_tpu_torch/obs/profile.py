"""Device-time attribution: counted costs, profiler traces, and the
phase-attribution report.

Counterpart of ``lightgbm_tpu/obs/profile.py``.  Three layers, each
failure-tolerant (a missing profiler degrades to ``False``, never to an
exception):

* :func:`cost_of` is the counterpart of XLA's cost analysis: the
  ``{flops, bytes_accessed, transcendentals}`` of one probe phase,
  counted by hand from the phase's shapes.  Each input byte is read once
  and each output byte written once (the byte formulas behind the Bound
  column of PERF.md's kernel table), so ``bytes_accessed`` over a
  measured time is the phase's achieved bandwidth and its share of the
  card's.  ``torch.utils.flop_counter`` is not a counterpart: it does not
  see a hand-written kernel;
* :func:`device_trace` wraps ``torch.profiler`` (CPU and CUDA activities)
  as a context manager that exports a Chrome trace to ``path`` at exit,
  and yields False when the profiler cannot trace here;
* :func:`attribution_report` folds measured wall time and per-phase
  estimates into the report the JAX package's ``bench.py --explain``
  emits: named phases, their share of the measured training time, and the
  coverage fraction.  Pure arithmetic, the JAX package's code.

The per-phase *measurements* live with the probes themselves
(``DeviceGrower.profile_stage_plan`` / ``profile_phases`` in
``ops/grow.py``); with ``profile_attribution`` on they attach
:func:`cost_of` counts to each probe.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

from .state import STATE

__all__ = ["enabled", "cost_of", "device_trace", "attribution_report",
           "PHASES", "FIND_OPS_PER_SLOT"]

#: the probe phases :func:`cost_of` counts
PHASES = ("wave_hist", "find_best", "split_apply", "score_update")

#: f32 operations of the split scan per (leaf, histogram slot): both scan
#: directions, each 3 running sums, the two children's gains
#: ``g^2 / (h + lambda)`` (3 operations each) and one compare
FIND_OPS_PER_SLOT = 2 * (3 + 2 * 3 + 1)


def enabled() -> bool:
    """True when probes should attach counted costs."""
    return STATE.enabled and STATE.profile_attribution


def _wave_hist(rows, groups, bins, k, w, rows_in_wave, stat_bytes):
    # kernel 1 (csrc/wave_hist.cu): every row's codes and leaf id, the
    # stats of the rows in the wave, the (G*NB, K, W) histogram out; one
    # add a (row in the wave, group, stat)
    return (rows * (groups + 4) + rows_in_wave * stat_bytes * k
            + groups * bins * k * w * 4,
            rows_in_wave * groups * k)


def _find_best(leaves, slots, hist_bytes=4, record_words=13):
    # the batched scan over a stack of leaves (a wave scans both siblings
    # of its W splits, 2W): (B, S, 3) histograms and (B, 3) totals in,
    # (B, 13) f32 records out
    return (leaves * (slots * 3 * hist_bytes + 3 * hist_bytes
                      + record_words * 4),
            leaves * slots * FIND_OPS_PER_SLOT)


def _split_apply(rows, w):
    # each row: one code of its split's group, its leaf id read and
    # written; the W splits' (feature, threshold, child) words in; a
    # bin decode and three compares a row
    return rows * (1 + 4 + 4) + w * 3 * 4, rows * 4


def _score_update(rows, leaves):
    # each row: its score read and written, its leaf id read; the leaf
    # values in; the hi and lo bf16 parts added
    return rows * (4 + 4 + 4) + leaves * 4, rows * 2


_COUNTERS = {"wave_hist": _wave_hist, "find_best": _find_best,
             "split_apply": _split_apply, "score_update": _score_update}


def cost_of(phase: str, **shapes) -> Dict[str, float]:
    """``{"flops", "bytes_accessed", "transcendentals"}`` of one launch of
    ``phase`` at ``shapes``:

    * ``wave_hist``: ``rows, groups, bins, k, w, rows_in_wave,
      stat_bytes`` (2 for bf16 stats, 1 for int8);
    * ``find_best``: ``leaves, slots`` (``hist_bytes``,
      ``record_words``);
    * ``split_apply``: ``rows, w``;
    * ``score_update``: ``rows, leaves``.

    ``flops`` counts the phase's arithmetic (adds, compares) whatever its
    type; no phase computes a transcendental."""
    fn = _COUNTERS.get(phase)
    if fn is None:
        raise ValueError(f"no cost model for phase {phase!r}; expected one "
                         f"of {PHASES}")
    nbytes, ops = fn(**{k: int(v) for k, v in shapes.items()})
    return {"flops": float(ops), "bytes_accessed": float(nbytes),
            "transcendentals": 0.0}


@contextlib.contextmanager
def device_trace(path: Optional[str]):
    """``torch.profiler`` over CPU and CUDA activities as a tolerant
    context manager: exports a Chrome trace to ``path`` at exit when the
    profiler works here, yields False and does nothing when ``path`` is
    falsy or the profiler cannot start."""
    if not path:
        yield False
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:   # noqa: BLE001 -- profiler optional by design
        yield False
        return
    try:
        yield True
    finally:
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(str(path))
        except Exception:   # noqa: BLE001
            pass


def attribution_report(measured_ms: float, phases_ms: Dict[str, float],
                       costs: Optional[Dict[str, Optional[Dict]]] = None,
                       ) -> Dict:
    """Fold per-phase estimates into the attribution report.

    ``measured_ms`` is the ground truth (the timed training region);
    ``phases_ms`` maps phase name -> estimated ms over that same
    region.  The report carries each phase's ms and share, the
    unattributed residual, and ``coverage`` = attributed/measured
    (clamped to 1.0 — probes measured hotter than the run overshoot,
    which is misattribution of a different kind and is reported
    verbatim in ``attributed_ratio``).  ``costs`` optionally maps phase
    name -> :func:`cost_of` dict; phases with both a time and a FLOPs
    estimate gain an achieved-GFLOP/s figure."""
    measured_ms = float(measured_ms)
    total = sum(float(v) for v in phases_ms.values())
    phases = {}
    for name in sorted(phases_ms, key=lambda k: -float(phases_ms[k])):
        ms = float(phases_ms[name])
        entry = {
            "ms": round(ms, 3),
            "share": round(ms / measured_ms, 4) if measured_ms > 0
            else None,
        }
        cost = (costs or {}).get(name)
        if cost:
            entry["cost"] = {k: v for k, v in cost.items()
                             if v is not None}
            flops = cost.get("flops")
            if flops and ms > 0:
                entry["achieved_gflops"] = round(flops / (ms * 1e6), 2)
        phases[name] = entry
    ratio = total / measured_ms if measured_ms > 0 else 0.0
    return {
        "measured_ms": round(measured_ms, 3),
        "attributed_ms": round(total, 3),
        "attributed_ratio": round(ratio, 4),
        "coverage": round(min(ratio, 1.0), 4),
        "unattributed_ms": round(max(measured_ms - total, 0.0), 3),
        "phases": phases,
    }
