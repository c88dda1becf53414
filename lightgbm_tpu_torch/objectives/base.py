"""Objective base class (reference ``include/LightGBM/objective_function.h``).

Counterpart of ``lightgbm_tpu/objectives/base.py``.  Scores are device
tensors of shape (num_model, N); ``get_gradients`` returns (grad, hess) as
float32 tensors on the scores' device.  Host-side statistics
(``boost_from_score``) stay numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class ObjectiveFunction:
    name = "none"
    is_constant_hessian = False
    #: leaf outputs are renewed from the residuals after growth (the
    #: percentile objectives); the device grower does not renew them
    is_renew_tree_output = False
    #: whether ``device_grad`` is row-local (row i's gradients depend only
    #: on row i).  The JAX package gates row bucketing of its fused path
    #: on it; the port's sample piece always hands the objective the
    #: (num_data,) score, so nothing here reads it
    device_grad_rowwise = True

    def __init__(self, config):
        self.config = config

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def init(self, metadata, num_data: int, device: torch.device):
        self.num_data = num_data
        self.device = device
        self.label = np.asarray(metadata.label, np.float32) \
            if metadata.label is not None else np.zeros(num_data, np.float32)
        self.weights = (np.asarray(metadata.weights, np.float32)
                        if metadata.weights is not None else None)
        self.weights_d = (torch.as_tensor(self.weights, device=device)
                          if self.weights is not None else None)

    def get_gradients(self, scores) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def device_grad(self):
        """``(fn, args)`` with ``fn(score, args) -> (grad, hess)`` a pure
        tensor function of the (N,) f32 score, which a captured CUDA graph
        can replay (``lightgbm_tpu/objectives/base.py:87``), or None: an
        objective without one is not eligible for fused training."""
        return None

    def boost_from_score(self, class_id: int) -> float:
        """Initial score (BoostFromScore)."""
        return 0.0

    def class_need_train(self, class_id: int) -> bool:
        return True

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        """Raw score -> user-facing prediction (ConvertOutput)."""
        return raw

    def renew_tree_output(self, leaf_pred: float, residuals,
                          weights) -> float:
        """Per-leaf output renewal of the percentile objectives."""
        raise NotImplementedError

    def to_string(self) -> str:
        return self.name


def percentile(data: np.ndarray, alpha: float) -> float:
    """Reference PercentileFun (regression_objective.hpp:11-36): descending
    order, float position (1-alpha)*cnt, linear interpolation
    (``lightgbm_tpu/objectives/base.py:123``)."""
    data = np.asarray(data, np.float64)
    cnt = len(data)
    if cnt == 0:
        return 0.0
    d = np.sort(data)[::-1]
    float_pos = (1.0 - alpha) * cnt
    pos = int(float_pos)
    if pos < 1:
        return float(d[0])
    if pos >= cnt:
        return float(d[-1])
    bias = float_pos - pos
    return float(d[pos - 1] - (d[pos - 1] - d[pos]) * bias)


def weighted_percentile(data: np.ndarray, weights: np.ndarray,
                        alpha: float) -> float:
    """Reference WeightedPercentileFun (regression_objective.hpp:39-59) with
    a bounds-safe interpolation: the reference indexes one past the cdf
    when the threshold lands in the final interval
    (``lightgbm_tpu/objectives/base.py:141``)."""
    data = np.asarray(data, np.float64)
    cnt = len(data)
    if cnt == 0:
        return 0.0
    order = np.argsort(data, kind="stable")
    cdf = np.cumsum(np.asarray(weights, np.float64)[order])
    thr = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, thr, side="right"))
    if pos == 0:
        return float(data[order[0]])
    if pos >= cnt:
        return float(data[order[-1]])
    v1, v2 = data[order[pos - 1]], data[order[pos]]
    denom = cdf[pos] - cdf[pos - 1]
    frac = (thr - cdf[pos - 1]) / denom if denom > 0 else 0.0
    return float(v1 + frac * (v2 - v1))
