"""Evaluation metrics on the host (numpy): binary logloss and AUC.

Counterpart of ``lightgbm_tpu/metrics/__init__.py`` for the binary slice;
the JAX package's other metrics come with their objectives and are refused
by name here.  Scores arrive as (num_model, N) float64 raw scores.  A
metric is initialized on the metadata (labels, weights) of the set it
evaluates: the training set's, or each validation set's.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import LightGBMError


class Metric:
    name = "metric"
    bigger_is_better = False

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data):
        self.num_data = num_data
        self.label = np.asarray(metadata.label, np.float64) \
            if metadata.label is not None else np.zeros(num_data)
        self.weights = (np.asarray(metadata.weights, np.float64)
                        if metadata.weights is not None else None)
        self.sum_weights = (float(self.weights.sum())
                            if self.weights is not None else float(num_data))

    def eval(self, score, objective):
        """score: (num_model, N) raw; returns [(name, value)]."""
        raise NotImplementedError


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective):
        prob = objective.convert_output(score[0]) if objective is not None \
            else score[0]
        p = np.clip(prob, 1e-15, 1 - 1e-15)
        loss = np.where(self.label > 0, -np.log(p), -np.log(1 - p))
        if self.weights is None:
            value = float(np.mean(loss))
        else:
            value = float(np.sum(loss * self.weights) / self.sum_weights)
        return [(self.name, value)]


class AUCMetric(Metric):
    """Weighted AUC by rank sum over sorted predictions, ties counted half
    (binary_metric.hpp:157-266).  Vectorized: one sort, then per-tie-group
    sums, in place of the JAX package's row loop."""

    name = "auc"
    bigger_is_better = True

    def eval(self, score, objective):
        pred = np.asarray(score[0], np.float64)
        y = self.label > 0
        w = self.weights if self.weights is not None else np.ones_like(pred)
        order = np.argsort(pred, kind="mergesort")
        ps, ys, ws = pred[order], y[order], w[order]
        starts = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
        tie_pos = np.add.reduceat(np.where(ys, ws, 0.0), starts)
        tie_neg = np.add.reduceat(np.where(ys, 0.0, ws), starts)
        cum_neg = np.cumsum(tie_neg) - tie_neg
        auc = float(np.sum(tie_pos * (cum_neg + 0.5 * tie_neg)))
        denom = float(tie_pos.sum()) * float(tie_neg.sum())
        return [(self.name, auc / denom if denom > 0 else 1.0)]


_REGISTRY = {"binary_logloss": BinaryLoglossMetric, "auc": AUCMetric}


def create_metrics(config):
    out = []
    for name in config.metric:
        cls = _REGISTRY.get(name)
        if cls is None:
            raise LightGBMError(f"metric {name!r} is not ported to "
                                f"lightgbm_tpu_torch yet (have: "
                                f"{', '.join(sorted(_REGISTRY))})")
        out.append(cls(config))
    return out
