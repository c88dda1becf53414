"""Wave-stage plan of the device grower (counterpart of
``lightgbm_tpu/ops/stage_plan.py``; the port has the fixed plan only).

The grower splits a tree's growth into stages: each stage runs waves of a
fixed width until the leaf count reaches the stage's cap, then the next,
wider stage takes over.  Growth order near the ``num_leaves`` budget
depends on the plan, so it is copied exactly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

Plan = List[Tuple[int, Optional[int]]]


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
