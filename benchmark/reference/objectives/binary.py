"""The binary log loss, LightGBM's ``binary`` objective with ``sigmoid``
1 and labels 0/1 (``binary_objective.hpp``).

* ``init_score``: the log-odds of the mean label (BoostFromScore);
* ``gradients``: of each row's float32 score, in float32: with
  ``s = 2y - 1``, ``r = -s / (1 + exp(s * score))``, the gradient ``r``
  and the hessian ``|r| (1 - |r|)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def init_score(y: torch.Tensor) -> float:
    p = float(y.double().mean())
    p = min(max(p, 1e-15), 1.0 - 1e-15)
    return math.log(p / (1.0 - p))


def gradients(score: torch.Tensor, y: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    s = y.float() * 2.0 - 1.0
    r = -s / (1.0 + torch.exp(s * score.float()))
    a = r.abs()
    return r, a * (1.0 - a)
