"""Arithmetic shared by the metric readers: the counted work of the
traced trees (``benchmark/cost.py``) and a share of the least time."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from benchmark import cost
from benchmark.loops import tree_counts


def tree_phases(facts: dict) -> Dict[str, Tuple[float, float]]:
    """(bytes, flops) by phase summed over the traced trees."""
    tot: Dict[str, list] = {}
    trees = facts["trees"]
    waves_each = facts["waves"] / max(len(trees), 1)
    for t in trees:
        bag, leaves, smaller = tree_counts(t)
        work = cost.tree_work(facts["rows"], bag, facts["groups"],
                              facts["features"], facts["k"], waves_each,
                              leaves, smaller)
        for ph, (b, f) in work.items():
            acc = tot.setdefault(ph, [0.0, 0.0])
            acc[0] += b
            acc[1] += f
    return {k: (v[0], v[1]) for k, v in tot.items()}


def least_s(phases: Dict[str, Tuple[float, float]]) -> float:
    return sum(cost.least_seconds(b, f) for b, f in phases.values())


def roofline_pct(least: float, measured: float) -> Optional[float]:
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured
