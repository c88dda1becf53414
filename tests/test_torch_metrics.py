"""The port's metrics against the JAX package's
(``lightgbm_tpu/metrics/__init__.py``), on the same float64 raw scores:
every ported metric within 1e-12 relative, unweighted and weighted, with
the output conversion of its objective; ``ndcg`` and ``map`` also with
query weights and ``eval_at`` past a query's length; every JAX metric
name ported or refused by name (none is refused since multiclass;
``multi_logloss`` and ``multi_error`` are held in
tests/test_torch_multiclass.py).
"""

import numpy as np
import pytest

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu.metrics import _REGISTRY as J_METRICS
from lightgbm_tpu.metrics import create_metric as jmetric
from lightgbm_tpu.objectives import create_objective as jobjective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metrics import _REGISTRY as T_METRICS
from lightgbm_tpu_torch.metrics import NOT_PORTED, create_metrics
from lightgbm_tpu_torch.objectives import create_objective as tobjective
from lightgbm_tpu_torch.utils.log import LightGBMError

N = 2000
PARAMS = {"alpha": 0.8, "fair_c": 1.7, "tweedie_variance_power": 1.3}
#: metric -> (the objective whose conversion it evaluates, label kind)
POINTWISE = {
    "l1": ("regression", "real"), "l2": ("regression", "real"),
    "rmse": ("regression", "real"), "quantile": ("quantile", "real"),
    "huber": ("huber", "real"), "fair": ("fair", "real"),
    "poisson": ("poisson", "count"), "mape": ("mape", "real"),
    "gamma": ("gamma", "positive"),
    "gamma_deviance": ("gamma", "positive"),
    "tweedie": ("tweedie", "count"),
    "binary_logloss": ("binary", "binary"),
    "binary_error": ("binary", "binary"), "auc": ("binary", "binary"),
    "cross_entropy": ("cross_entropy", "prob"),
    "cross_entropy_lambda": ("cross_entropy_lambda", "prob"),
    "kullback_leibler": ("cross_entropy", "prob"),
}


def _label(kind, rng, n):
    return {"real": lambda: rng.standard_normal(n) * 3,
            "count": lambda: rng.poisson(2.0, n).astype(np.float64),
            "positive": lambda: rng.gamma(2.0, 1.0, n),
            "binary": lambda: (rng.random(n) < 0.4).astype(np.float64),
            "prob": lambda: rng.random(n)}[kind]()


def _metadata(label, weights=None, group=None):
    out = []
    for cls in (JMetadata, TMetadata):
        md = cls(len(label))
        md.set_label(label)
        md.set_weights(weights)
        md.set_query(group)
        out.append(md)
    return out


def _eval(name, params, label, score, weights=None, group=None,
          objective=None):
    jmd, tmd = _metadata(label, weights, group)
    jm = jmetric(name, JConfig({**PARAMS, **params}))
    jm.init(jmd, len(label))
    tm, = create_metrics(TConfig({**PARAMS, **params, "metric": name}))
    tm.init(tmd, len(label))
    jo = to = None
    if objective is not None:
        jo = jobjective(JConfig({**PARAMS, "objective": objective}))
        to = tobjective(TConfig({**PARAMS, "objective": objective}))
    assert tm.bigger_is_better is jm.bigger_is_better
    return jm.eval(score, jo), tm.eval(score, to)


def _assert_close(jres, tres):
    assert [n for n, _ in tres] == [n for n, _ in jres]
    for (_, t), (_, j) in zip(tres, jres):
        assert abs(t - j) <= 1e-12 * max(abs(j), 1e-300), (t, j)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(POINTWISE))
def test_pointwise_metric_matches_jax(name, weighted):
    objective, kind = POINTWISE[name]
    rng = np.random.default_rng(31)
    label = _label(kind, rng, N)
    score = rng.standard_normal((1, N)) * 1.2
    score[0, :5] = score[0, 5]                # ties (auc)
    weights = rng.uniform(0.1, 2.0, N) if weighted else None
    jres, tres = _eval(name, {}, label, score, weights,
                       objective=objective)
    _assert_close(jres, tres)
    # without an objective the raw score is evaluated
    if kind in ("real", "prob"):
        _assert_close(*_eval(name, {}, label, score, weights))


QUERY_CASES = {
    "plain": dict(eval_at=[1, 3, 5], weighted=False),
    "query_weights": dict(eval_at=[1, 3, 5], weighted=True),
    "past_the_query": dict(eval_at=[2, 10, 40], weighted=True),
    "default_eval_at": dict(eval_at=None, weighted=False),
}


@pytest.mark.parametrize("case", list(QUERY_CASES))
@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_query_metric_matches_jax(name, case):
    """Queries of 1-30 documents (``eval_at`` 40 is past every one),
    queries with no relevant document, label_gain defaulted, ties."""
    c = QUERY_CASES[case]
    rng = np.random.default_rng(32)
    sizes = rng.integers(1, 31, 70)
    n = int(sizes.sum())
    label = rng.integers(0, 5, n).astype(np.float64)
    label[:sizes[0] + sizes[1]] = 0.0         # two queries, nothing relevant
    score = np.round(rng.standard_normal((1, n)), 1)
    weights = rng.uniform(0.1, 2.0, n) if c["weighted"] else None
    params = {} if c["eval_at"] is None else {"eval_at": c["eval_at"]}
    jres, tres = _eval(name, params, label, score, weights, sizes)
    _assert_close(jres, tres)
    want = c["eval_at"] or [1, 2, 3, 4, 5]
    assert [r[0] for r in tres] == [f"{name}@{k}" for k in want]


def test_ndcg_label_gain():
    rng = np.random.default_rng(33)
    sizes = rng.integers(2, 20, 30)
    n = int(sizes.sum())
    label = rng.integers(0, 3, n).astype(np.float64)
    score = rng.standard_normal((1, n))
    jres, tres = _eval("ndcg", {"label_gain": [0, 2, 7]}, label, score,
                       group=sizes)
    _assert_close(jres, tres)


def test_query_metrics_need_queries():
    _, tmd = _metadata(np.zeros(10))
    for name in ("ndcg", "map"):
        m, = create_metrics(TConfig({"metric": name}))
        with pytest.raises(LightGBMError, match="query information"):
            m.init(tmd, 10)


def test_every_jax_metric_is_ported_or_refused_by_name():
    for name in J_METRICS:
        if name in NOT_PORTED:
            with pytest.raises(LightGBMError, match=name):
                create_metrics(TConfig({"metric": name}))
        else:
            m, = create_metrics(TConfig({"metric": name}))
            assert type(m).__name__ == J_METRICS[name].__name__
            assert m.name == name
    # "kldiv": the name the config gives kullback_leibler, which the JAX
    # registry lacks (its create_metric raises for metric=kullback_leibler)
    assert set(T_METRICS) | set(NOT_PORTED) == set(J_METRICS) | {"kldiv"}
    m, = create_metrics(TConfig({"metric": "kullback_leibler"}))
    assert m.name == "kullback_leibler"
