"""Wave-stage planning for the device grower (counterpart of
``lightgbm_tpu/ops/stage_plan.py``).

The grower splits a tree's growth into *stages*: each stage runs waves of
a fixed width (the body of one WHILE node of the composed tree graph,
``ops/grow.py``) until the leaf count reaches the stage's cap, then the
next, wider stage takes over.  A wave's cost is modeled as ``fixed +
col_ms * width * hist_cols``: a part every wave pays whatever its width
and a part per stat column of the pending leaves.  This module keeps the
legacy doubling plan as the byte-stable default (growth order near the
``num_leaves`` budget depends on the plan) and adds

* a cost model and simulator (``plan_cost``) over the leaf-growth
  trajectory (a wave splits at most ``min(width, frontier, budget)``
  leaves);
* ``derive_stage_plan``: the cheapest plan of the doubling-ladder family
  for measured costs;
* a process cache keyed on the grower's (shape, config) signature, filled
  by ``DeviceGrower.profile_stage_plan`` (which times kernel 1 at each
  candidate width), and its store beside the compile cache the booster's
  config names (``<compile_cache_dir>/stage_plans``), so a later process
  adopts a plan without measuring.

Given the same inputs every function returns what the JAX package's
does; three things differ.  The fallback costs of :func:`fit_wave_costs`
were measured on the card (the JAX package's are a TPU's); under
``wave_plan=auto`` a derived plan must beat the ladder by the 2% bar at
the probes' worst case (:func:`plan_beats_spread`); and the JAX
package's fused-versus-two-pass find-best verdict has no counterpart:
the port has one wave layout (``find_best_fusion`` is ignored), so the
pricing of a second find-best pass and its store are not here.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# the fit chip_smoke.py's api phase measured for kernel 1 on the card
# (2,000,000 x 28 HIGGS-shaped codes padded to 2,097,152 rows, NB=256,
# K=3, every row pending, widths 4-128; NVIDIA H100 80GB HBM3, 700.00 W):
# a wave's fixed ms and ms per stat column.  Both terms read every row, so
# fit_wave_costs scales them by rows / REF_ROWS when it falls back for
# another shape.
DEFAULT_FIXED_MS = 0.4467
DEFAULT_COL_MS = 0.00104
REF_ROWS = 2_097_152

Plan = List[Tuple[int, Optional[int]]]

_PLAN_CACHE: Dict[tuple, Plan] = {}
_PLAN_CACHE_LOCK = threading.Lock()

#: wave_plan=auto profiles on first use only from this many training rows
#: (below it a tree takes milliseconds and the measurement would dominate)
AUTO_PROFILE_MIN_ROWS = 1 << 19

#: a candidate plan must be this much cheaper than the incumbent to
#: replace it: below it the modeled saving is measurement noise, and fewer
#: stages (fewer WHILE nodes, fewer captured wave pieces) win
MIN_IMPROVEMENT = 0.02


def legacy_stage_plan(num_leaves: int, wave_width: int,
                      hist_cols: int) -> Plan:
    """The doubling plan: [(width, leaf cap), ..., (wave_width, None)]."""
    scale = 3.0 / hist_cols
    return [
        (ws, cap) for ws, cap in
        ((4, 8), (16, 32), (max(int(32 * scale), 4), 64),
         (max(int(64 * scale), 4), 128))
        if ws < wave_width and cap < num_leaves
    ] + [(wave_width, None)]


def plan_digest(plan: Sequence) -> str:
    """A short stable digest of a stage plan."""
    canon = repr([(int(w), None if c is None else int(c))
                  for w, c in plan])
    return hashlib.sha1(canon.encode()).hexdigest()[:10]


def plan_cost_fn(plan: Sequence, num_leaves: int,
                 wave_ms) -> Tuple[float, int]:
    """(modeled ms a tree, waves) of a growth to ``num_leaves`` under a
    per-width wave cost function.  A wave splits at most ``min(width,
    frontier, budget)`` leaves: only existing leaves can split, so a wide
    early wave pays its whole cost for few splits."""
    nl, cost, waves = 1, 0.0, 0
    L = num_leaves
    for ws, cap in plan:
        limit = L if cap is None else min(cap, L)
        while nl < limit:
            s = min(ws, nl, L - nl)
            if s <= 0:
                break
            nl += s
            cost += wave_ms(ws)
            waves += 1
    return cost, waves


def plan_cost(plan: Sequence, num_leaves: int, hist_cols: int,
              fixed_ms: float, col_ms: float) -> Tuple[float, int]:
    """:func:`plan_cost_fn` under the linear fixed + col * width * k
    model."""
    return plan_cost_fn(plan, num_leaves,
                        lambda w: fixed_ms + col_ms * w * hist_cols)


def plan_dispatches(plan: Sequence, num_leaves: int) -> int:
    """Waves a tree under the plan: each wave is one pass of its stage's
    loop body (the JAX package's fused-layout count)."""
    _, waves = plan_cost_fn(plan, num_leaves, lambda w: 0.0)
    return waves


def _ladder(wave_width: int) -> List[int]:
    out, w = [], 4
    while w < wave_width:
        out.append(w)
        w *= 2
    return out


def wave_cost_fn(hist_cols: int, fixed_ms: float, col_ms: float,
                 measured_ms: Optional[Dict[int, float]] = None):
    """A wave's cost (ms) by width: the measured probe time where there is
    one, else the linear model.  ``derive_stage_plan`` and ``plan_beats``
    share it, so both price plans alike."""
    def wave_ms(w):
        if measured_ms and w in measured_ms:
            return float(measured_ms[w])
        return fixed_ms + col_ms * w * hist_cols
    return wave_ms


def plan_beats(candidate: Sequence, incumbent: Sequence, num_leaves: int,
               hist_cols: int, fixed_ms: float, col_ms: float,
               measured_ms: Optional[Dict[int, float]] = None) -> bool:
    """Whether ``candidate``'s modeled cost a tree is below
    ``incumbent``'s by :data:`MIN_IMPROVEMENT`: the bar ``wave_plan=auto``
    sets before a measured plan replaces the legacy ladder."""
    wave_ms = wave_cost_fn(hist_cols, fixed_ms, col_ms, measured_ms)
    c_cand, _ = plan_cost_fn(candidate, num_leaves, wave_ms)
    c_inc, _ = plan_cost_fn(incumbent, num_leaves, wave_ms)
    return c_cand < c_inc * (1.0 - MIN_IMPROVEMENT)


def plan_beats_spread(candidate: Sequence, incumbent: Sequence,
                      num_leaves: int, lo_ms: Dict[int, float],
                      hi_ms: Dict[int, float]) -> bool:
    """:func:`plan_beats` at the probes' worst case for the candidate:
    every candidate wave costs its slowest probe (``hi_ms``), every
    incumbent wave its fastest (``lo_ms``), and the candidate must still
    be :data:`MIN_IMPROVEMENT` cheaper.  ``wave_plan=auto`` asks this
    where the JAX package asks :func:`plan_beats` at one time a width, so
    that a gain within the probes' own spread never decides which plan
    grows the trees."""
    c_cand, _ = plan_cost_fn(candidate, num_leaves, hi_ms.__getitem__)
    c_inc, _ = plan_cost_fn(incumbent, num_leaves, lo_ms.__getitem__)
    return c_cand < c_inc * (1.0 - MIN_IMPROVEMENT)


def derive_stage_plan(num_leaves: int, wave_width: int, hist_cols: int,
                      fixed_ms: float, col_ms: float,
                      measured_ms: Optional[Dict[int, float]] = None,
                      frontier_packing: bool = True) -> Plan:
    """The cheapest plan of the doubling-ladder family: every subset of
    the widths {4, 8, 16, ...} below ``wave_width`` (stage (w, 2w) runs
    width w until the leaf count outgrows it), closed by the full-width
    stage.  Measured per-width costs are used where given, the linear
    model elsewhere.  Candidates are scanned fewest stages first, and a
    longer plan must be :data:`MIN_IMPROVEMENT` cheaper to win.  Without
    ``frontier_packing`` the answer is the full ladder, every wave at most
    its frontier's width."""
    wave_ms = wave_cost_fn(hist_cols, fixed_ms, col_ms, measured_ms)
    rungs = _ladder(wave_width)
    full: Plan = [(w, 2 * w) for w in rungs
                  if 2 * w < num_leaves] + [(wave_width, None)]
    if not frontier_packing:
        return full
    candidates: List[Plan] = [[(wave_width, None)]]
    for mask in range(1, 1 << len(rungs)):
        subset = [rungs[i] for i in range(len(rungs)) if mask >> i & 1]
        candidates.append([(w, 2 * w) for w in subset
                           if 2 * w < num_leaves] + [(wave_width, None)])
    candidates.sort(key=len)
    best_plan = candidates[0]
    best_cost, _ = plan_cost_fn(best_plan, num_leaves, wave_ms)
    for plan in candidates[1:]:
        cost, _ = plan_cost_fn(plan, num_leaves, wave_ms)
        if cost < best_cost * (1.0 - MIN_IMPROVEMENT):
            best_cost, best_plan = cost, plan
    return best_plan


def fit_wave_costs(widths: Sequence[int], ms: Sequence[float],
                   hist_cols: int,
                   num_data: Optional[int] = None) -> Tuple[float, float]:
    """Least-squares (fixed_ms, col_ms) of per-width probe times.  A
    degenerate fit (a negative slope or intercept) falls back to
    :data:`DEFAULT_FIXED_MS` / :data:`DEFAULT_COL_MS`, scaled to
    ``num_data`` rows when given."""
    import numpy as np
    x = np.asarray([w * hist_cols for w in widths], np.float64)
    y = np.asarray(ms, np.float64)
    if len(x) >= 2 and float(x.max() - x.min()) > 0:
        col, fixed = np.polyfit(x, y, 1)
    else:
        col, fixed = -1.0, -1.0
    if col <= 0 or fixed < 0:
        scale = num_data / REF_ROWS if num_data else 1.0
        return DEFAULT_FIXED_MS * scale, DEFAULT_COL_MS * scale
    return float(fixed), float(col)


def cached_plan(signature: tuple) -> Optional[Plan]:
    with _PLAN_CACHE_LOCK:
        plan = _PLAN_CACHE.get(signature)
        return list(plan) if plan is not None else None


def cache_plan(signature: tuple, plan: Sequence,
               store: Optional[str] = None) -> None:
    """Keep ``plan`` for ``signature`` in the process cache and, with a
    ``store`` (:func:`store_dir`), write it there too."""
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE[signature] = [(int(w), None if c is None else int(c))
                                  for w, c in plan]
    if store is not None:
        save_plan(signature, plan, store)


# ---------------------------------------------------------------------------
# the store: a plan a file beside the kernel libraries of the compile
# cache, named by a sha1 of the signature's repr (the same in every
# process, whatever PYTHONHASHSEED) and checked on load: the signature text
# must match and the digest must be the plan's, or the legacy plan is used
# ---------------------------------------------------------------------------

def store_dir(config) -> Optional[str]:
    """``<compile_cache_dir>/stage_plans`` of ``config`` (or of
    ``LGBM_TPU_COMPILE_CACHE``), or None when it names no compile cache
    directory (plans then live for the process only)."""
    from .. import compile_cache
    return compile_cache.artifact_dir("stage_plans", config)


def _plan_path(signature: tuple, store: Optional[str]) -> Optional[str]:
    if store is None:
        return None
    key = hashlib.sha1(repr(tuple(signature)).encode()).hexdigest()[:20]
    return os.path.join(store, f"plan_{key}.json")


def save_plan(signature: tuple, plan: Sequence,
              store: Optional[str]) -> Optional[str]:
    """Write ``plan`` atomically into ``store``; its path, or None without
    a store or when the write fails (a read-only directory keeps the plan
    in the process)."""
    path = _plan_path(signature, store)
    if path is None:
        return None
    canon = [[int(w), None if c is None else int(c)] for w, c in plan]
    payload = {"signature": repr(tuple(signature)), "plan": canon,
               "digest": plan_digest(canon)}
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
    except OSError as e:
        from ..utils.log import log_warning
        log_warning(f"cannot persist the profiled stage plan to {path}: "
                    f"{e}; the plan stays in this process")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path


def load_plan(signature: tuple, store: Optional[str]) -> Optional[Plan]:
    """The plan of ``signature`` stored in ``store``; None when absent,
    unreadable, of another signature or of a wrong digest."""
    path = _plan_path(signature, store)
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return None
    if payload.get("signature") != repr(tuple(signature)):
        return None
    try:
        plan = [(int(w), None if c is None else int(c))
                for w, c in payload.get("plan")]
    except (TypeError, ValueError):
        return None
    if not plan or plan_digest(plan) != payload.get("digest"):
        return None
    return plan


def forget_plan(signature: tuple, store: Optional[str] = None) -> None:
    """Drop ``signature``'s plan from the process cache and, with a
    ``store``, from it."""
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE.pop(signature, None)
    path = _plan_path(signature, store)
    if path is not None:
        try:
            os.remove(path)
        except OSError:
            pass
