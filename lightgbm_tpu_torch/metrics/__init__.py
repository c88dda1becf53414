"""Evaluation metrics on the host (numpy).

Counterpart of ``lightgbm_tpu/metrics/__init__.py`` (the reference's
``src/metric/``): every metric of the JAX package but ``multi_logloss`` and
``multi_error``, which wait for multiclass and are refused by name.  Scores
arrive as (num_model, N) float64 raw scores; the objective converts them
where the reference does (sigmoid, exp).  A metric is initialized on the
metadata (labels, weights, queries) of the set it evaluates: the training
set's, or each validation set's.
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

    def _avg(self, losses):
        if self.weights is None:
            return float(np.mean(losses))
        return float(np.sum(losses * self.weights) / self.sum_weights)


def _convert(score, objective):
    if objective is not None:
        return objective.convert_output(score)
    return score


# regression metrics (regression_metric.hpp:108-300)

class _PointwiseMetric(Metric):
    def eval(self, score, objective):
        return [(self.name, self._point(_convert(score[0], objective)))]

    def _point(self, pred):
        raise NotImplementedError


class L2Metric(_PointwiseMetric):
    name = "l2"

    def _point(self, pred):
        return self._avg((pred - self.label) ** 2)


class RMSEMetric(_PointwiseMetric):
    name = "rmse"

    def _point(self, pred):
        return float(np.sqrt(self._avg((pred - self.label) ** 2)))


class L1Metric(_PointwiseMetric):
    name = "l1"

    def _point(self, pred):
        return self._avg(np.abs(pred - self.label))


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def _point(self, pred):
        a = float(self.config.alpha)
        d = self.label - pred
        return self._avg(np.where(d >= 0, a * d, (a - 1) * d))


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def _point(self, pred):
        a = float(self.config.alpha)
        d = np.abs(pred - self.label)
        return self._avg(np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a)))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def _point(self, pred):
        c = float(self.config.fair_c)
        x = np.abs(pred - self.label)
        return self._avg(c * c * (x / c - np.log1p(x / c)))


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def _point(self, pred):
        p = np.maximum(pred, 1e-10)
        return self._avg(p - self.label * np.log(p))


class MapeMetric(_PointwiseMetric):
    name = "mape"

    def _point(self, pred):
        return self._avg(np.abs((self.label - pred)
                                / np.maximum(1.0, np.abs(self.label))))


class GammaMetric(_PointwiseMetric):
    """Gamma NLL with unit shape: label/score + log(score)."""

    name = "gamma"

    def _point(self, pred):
        x = np.maximum(pred, 1e-10)
        return self._avg(self.label / x + np.log(x))


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"

    def _point(self, pred):
        ratio = self.label / (pred + 1e-9)
        return self._avg(ratio - np.log(np.maximum(ratio, 1e-300)) - 1.0)


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def _point(self, pred):
        rho = float(self.config.tweedie_variance_power)
        p = np.maximum(pred, 1e-10)
        a = self.label * np.power(p, 1.0 - rho) / (1.0 - rho)
        b = np.power(p, 2.0 - rho) / (2.0 - rho)
        return self._avg(-a + b)


# binary metrics (binary_metric.hpp)

class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def _point(self, prob):
        p = np.clip(prob, 1e-15, 1 - 1e-15)
        return self._avg(np.where(self.label > 0, -np.log(p),
                                  -np.log(1 - p)))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def _point(self, prob):
        return self._avg(((prob > 0.5) != (self.label > 0))
                         .astype(np.float64))


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


# cross-entropy metrics (xentropy_metric.hpp)

class CrossEntropyMetric(_PointwiseMetric):
    name = "cross_entropy"

    def _point(self, prob):
        p = np.clip(prob, 1e-15, 1 - 1e-15)
        y = self.label
        return self._avg(-(y * np.log(p) + (1 - y) * np.log(1 - p)))


class CrossEntropyLambdaMetric(Metric):
    """The loss at hhat = log1p(exp(f)); the weights enter the intensity,
    and the mean is unweighted (xentropy_metric.hpp)."""

    name = "cross_entropy_lambda"

    def eval(self, score, objective):
        hhat = np.log1p(np.exp(score[0]))
        y = self.label
        w = self.weights if self.weights is not None else 1.0
        z = np.clip(1.0 - np.exp(-w * hhat), 1e-15, 1 - 1e-15)
        loss = -(y * np.log(z) + (1 - y) * np.log(1 - z))
        return [(self.name, float(np.mean(loss)))]


class KLDivMetric(_PointwiseMetric):
    name = "kullback_leibler"

    def _point(self, prob):
        eps = 1e-15
        p = np.clip(prob, eps, 1 - eps)
        y = np.clip(self.label, eps, 1 - eps)
        return self._avg(y * np.log(y / p)
                         + (1 - y) * np.log((1 - y) / (1 - p)))


# ranking metrics (rank_metric.hpp, map_metric.hpp, dcg_calculator.cpp)

class _QueryMetric(Metric):
    """A metric at each of ``eval_at`` per query, averaged over the queries
    (weighted by the query weights when the set has them)."""

    bigger_is_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise LightGBMError(f"The {self.name.upper()} metric requires "
                                f"query information")
        self.qb = metadata.query_boundaries
        self.eval_at = [int(k) for k in
                        (self.config.eval_at or [1, 2, 3, 4, 5])]
        self.query_weights = metadata.query_weights

    def eval(self, score, objective):
        pred = score[0]
        nq = len(self.qb) - 1
        res = np.zeros((len(self.eval_at), nq))
        for q in range(nq):
            lo, hi = self.qb[q], self.qb[q + 1]
            order = np.argsort(-pred[lo:hi], kind="stable")
            res[:, q] = self._query(self.label[lo:hi], order, hi - lo)
        if self.query_weights is not None:
            qw = np.asarray(self.query_weights, np.float64)
            vals = (res * qw).sum(axis=1) / qw.sum()
        else:
            vals = res.mean(axis=1)
        return [(f"{self.name}@{k}", float(v))
                for k, v in zip(self.eval_at, vals)]

    def _query(self, label, order, n):
        """The metric of one query at each of ``eval_at``."""
        raise NotImplementedError


class NDCGMetric(_QueryMetric):
    name = "ndcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        gains = list(self.config.label_gain or [])
        if not gains:
            gains = [float((1 << i) - 1) for i in range(31)]
        self.gains = np.asarray(gains, np.float64)

    def _query(self, label, order, n):
        labels = label.astype(np.int64)
        sorted_gain = self.gains[labels[order]]
        ideal_gain = np.sort(self.gains[labels])[::-1]
        disc = 1.0 / np.log2(np.arange(2, 2 + n))
        out = []
        for k in self.eval_at:
            kk = min(k, n)
            maxdcg = float((ideal_gain[:kk] * disc[:kk]).sum())
            if maxdcg <= 0.0:
                out.append(1.0)
            else:
                out.append(float((sorted_gain[:kk] * disc[:kk]).sum())
                           / maxdcg)
        return out


class MapMetric(_QueryMetric):
    name = "map"

    def _query(self, label, order, n):
        rel = label > 0
        rel_sorted = rel[order]
        prec = np.cumsum(rel_sorted) / np.arange(1, n + 1)
        out = []
        for k in self.eval_at:
            kk = min(k, n)
            nrel = int(rel_sorted[:kk].sum())
            if nrel == 0:
                out.append(1.0 if rel.sum() == 0 else 0.0)
            else:
                out.append(float((prec[:kk] * rel_sorted[:kk]).sum()
                                 / nrel))
        return out


_REGISTRY = {
    "l1": L1Metric,
    "l2": L2Metric,
    "rmse": RMSEMetric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MapeMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivMetric,
    # the config resolves every alias of kullback_leibler to "kldiv"
    # (params.py METRIC_ALIASES); the JAX package's registry lacks that
    # name, so there the metric cannot be asked for through params
    "kldiv": KLDivMetric,
    "ndcg": NDCGMetric,
    "map": MapMetric,
}
#: the JAX package's metrics that are not ported yet, and why
NOT_PORTED = {"multi_logloss": "multiclass", "multi_error": "multiclass"}


def create_metrics(config):
    out = []
    for name in config.metric:
        cls = _REGISTRY.get(name)
        if cls is None:
            why = f" (waits for {NOT_PORTED[name]})" \
                if name in NOT_PORTED else ""
            raise LightGBMError(f"metric {name!r} is not ported to "
                                f"lightgbm_tpu_torch yet{why} (have: "
                                f"{', '.join(sorted(_REGISTRY))})")
        out.append(cls(config))
    return out
