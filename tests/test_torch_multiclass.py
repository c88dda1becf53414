"""The port's multiclass slice against the JAX package, on the CPU.

* softmax and one-vs-all gradients of the same (K, N) scores and
  weights: within 2 ulp plus twice the JAX package's own float32 error
  against the float64 formula (``exp``'s last bit differs between XLA's
  CPU backend and torch);
* ``boost_from_score``, ``class_need_train`` with a class absent from the
  labels, the output transforms, and the label range check;
* ``multi_logloss`` and ``multi_error`` on the same scores within 1e-12
  (argmax ties to the lower class);
* ``engine.train`` on 3,000 rows with two categorical columns, 5 rounds,
  K=3 softmax, K=4 with an absent class, and K=3 one-vs-all: the same
  trees (structure, counts, bitsets; leaf values within 1e-5),
  ``Booster.predict`` (N, K) within 1e-6 by the host walk and by the
  packed forest, the valid set's ``multi_logloss`` within 1e-6 every
  round and the same ``best_iteration`` under early stopping;
* multiclass runs per-iteration whatever ``fused_chunk`` says, one
  ``tree_stats`` entry an iteration with its K trees and one host sync.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu.metrics import create_metrics as jmetrics
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metrics import create_metrics as tmetrics
from lightgbm_tpu_torch.objectives import create_objective as tcreate
from lightgbm_tpu_torch.utils.log import LightGBMError

N = 3000
ROUNDS = 5
NAMES = ["multiclass", "multiclassova"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread: with several test
    workers on one machine, each op's OpenMP team of one thread a core
    oversubscribes the cores, and the port's test files ran 10-60x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, label, weights, k):
    """(jax objective, port objective) on the same metadata."""
    params = {"objective": name, "num_class": k, "sigmoid": 1.3}
    n = len(label)
    jmd, tmd = JMetadata(n), TMetadata(n)
    for md in (jmd, tmd):
        md.set_label(label)
        md.set_weights(weights)
    jo = jcreate(JConfig(params))
    jo.init(jmd, n)
    to = tcreate(TConfig(params))
    to.init(tmd, n, torch.device("cpu"))
    return jo, to


def _softmax_f64(score, label, weights):
    s = score.astype(np.float64)
    e = np.exp(s - s.max(axis=0, keepdims=True))
    p = e / e.sum(axis=0, keepdims=True)
    onehot = np.arange(len(s))[:, None] == label[None, :].astype(np.int64)
    g, h = p - onehot, 2.0 * p * (1.0 - p)
    w = 1.0 if weights is None else weights.astype(np.float64)[None, :]
    return g * w, h * w


def _ova_f64(score, label, weights, sigmoid):
    s = score.astype(np.float64)
    y = np.arange(len(s))[:, None] == label[None, :].astype(np.int64)
    sign = np.where(y, 1.0, -1.0)
    r = -sign * sigmoid / (1.0 + np.exp(sign * sigmoid * s))
    g, h = r, np.abs(r) * (sigmoid - np.abs(r))
    w = 1.0 if weights is None else weights.astype(np.float64)[None, :]
    return g * w, h * w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name, weighted):
    """Each (K, N) gradient differs from the JAX package's by at most 2
    ulp plus twice the JAX package's own float32 error against the
    float64 formula (PR 8's bar for the formulas with ``exp``)."""
    import jax.numpy as jnp
    k, n = 5, 4000
    rng = np.random.default_rng(21)
    label = rng.integers(0, k, n).astype(np.float32)
    weights = rng.uniform(0.2, 2.0, n).astype(np.float32) if weighted \
        else None
    score = (rng.standard_normal((k, n)) * 2).astype(np.float32)
    score[:, :3] = 0.0                        # equal scores: p = 1/K
    jo, to = _pair(name, label, weights, k)
    jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    tg, th = (a.numpy() for a in to.get_gradients(torch.from_numpy(score)))
    assert tg.shape == th.shape == (k, n)
    assert tg.dtype == th.dtype == np.float32
    exact = _softmax_f64(score, label, weights) if name == "multiclass" \
        else _ova_f64(score, label, weights, 1.3)
    for t, j, e in zip((tg, th), (jg, jh), exact):
        j = j.astype(np.float64)
        ulp = np.spacing(np.abs(e).astype(np.float32)).astype(np.float64)
        bound = 2 * ulp + 2 * np.abs(j - e).max()
        assert (np.abs(t - j) <= bound).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_priors_and_absent_class_match_jax(name, weighted):
    """``boost_from_score`` and ``class_need_train`` of every class, one
    of them absent from the labels; the output transform and the model
    text's objective line."""
    k = 4
    rng = np.random.default_rng(22)
    label = rng.choice([0, 1, 3], 700).astype(np.float32)
    weights = rng.uniform(0.0, 2.0, 700).astype(np.float32) if weighted \
        else None
    jo, to = _pair(name, label, weights, k)
    assert to.num_model_per_iteration == jo.num_model_per_iteration == k
    need = [to.class_need_train(c) for c in range(k)]
    assert need == [jo.class_need_train(c) for c in range(k)]
    assert need == [True, True, False, True]
    for c in range(k):
        assert to.boost_from_score(c) == jo.boost_from_score(c)
    raw = rng.standard_normal((k, 9)) * 3
    np.testing.assert_array_equal(to.convert_output(raw),
                                  jo.convert_output(raw))
    assert to.to_string() == jo.to_string()


@pytest.mark.parametrize("name", NAMES)
def test_labels_outside_the_classes_are_refused(name):
    tmd = TMetadata(4)
    tmd.set_label(np.array([0, 1, 3, 2], np.float32))
    obj = tcreate(TConfig({"objective": name, "num_class": 3}))
    with pytest.raises(LightGBMError, match=r"\[0, num_class\)"):
        obj.init(tmd, 4, torch.device("cpu"))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_metrics_match_jax(name, weighted):
    """multi_logloss and multi_error within 1e-12 on the same raw
    scores, some rows with tied top classes (the lower class wins)."""
    k, n = 4, 900
    rng = np.random.default_rng(23)
    label = rng.integers(0, k, n).astype(np.float32)
    weights = rng.uniform(0.2, 2.0, n).astype(np.float32) if weighted \
        else None
    score = rng.standard_normal((k, n)) * 2
    score[:, :20] = 0.5                       # every class tied
    score[1:3, 20:40] = 9.0                   # classes 1 and 2 tied
    jo, to = _pair(name, label, weights, k)
    params = {"objective": name, "num_class": k,
              "metric": "multi_logloss,multi_error"}
    jmd, tmd = JMetadata(n), TMetadata(n)
    for md in (jmd, tmd):
        md.set_label(label)
        md.set_weights(weights)
    got, want = [], []
    for m in tmetrics(TConfig(params)):
        m.init(tmd, n)
        got += m.eval(score, to)
    for m in jmetrics(JConfig(params)):
        m.init(jmd, n)
        want += m.eval(score, jo)
    assert [g[0] for g in got] == [w[0] for w in want] \
        == ["multi_logloss", "multi_error"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# training: both packages on their device growers
def _data(n, k, seed, absent=None):
    """(x, y): two categorical columns and two numerical ones
    (``parity_data.make_categorical_features``'s layout) and a class
    drawn from a softmax of per-category preferences and a numerical
    effect, so every region holds several classes."""
    rng = np.random.default_rng(seed)
    x = pd.make_categorical_features(n) if seed == 0 else np.stack([
        rng.integers(0, 30, n), rng.integers(0, 8, n),
        rng.standard_normal(n), rng.random(n)], axis=1).astype(np.float64)
    pref = np.random.default_rng(99).standard_normal((2, 30, k)) * 1.5
    logit = (pref[0][x[:, 0].astype(np.int64)]
             + pref[1][x[:, 1].astype(np.int64) % 30]
             + np.outer(x[:, 2], np.linspace(-1.0, 1.0, k)))
    if absent is not None:
        logit[:, absent] = -np.inf
    p = np.exp(logit - logit.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    u = rng.random(n)[:, None]
    y = (u > np.cumsum(p, axis=1)).sum(axis=1)
    return x, np.minimum(y, k - 1).astype(np.float64)


CASES = {
    "softmax3": ("multiclass", 3, None),
    "absent_class": ("multiclass", 4, 2),
    "ova3": ("multiclassova", 3, None),
}


def _params(case):
    name, k, _ = CASES[case]
    return {"objective": name, "num_class": k, "num_leaves": 15,
            "max_bin": 63, "learning_rate": 0.2, "min_data_in_leaf": 20,
            "min_data_per_group": 20, "cat_smooth": 5.0, "verbose": -1,
            "metric": "multi_logloss,multi_error"}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    """Both packages' ``engine.train`` on the same data: 5 rounds with a
    valid set and early stopping (the port with ``fused_chunk``, which
    multiclass does not use)."""
    case = request.param
    _, k, absent = CASES[case]
    x, y = _data(N, k, 0, absent)
    xv, yv = _data(1000, k, 5, absent)
    params = _params(case)
    cats = [0, 1]
    jtrain = jlgb.Dataset(x, y, categorical_feature=cats)
    jev, tev = {}, {}
    jb = jlgb.train({**params, "device_growth": "on"}, jtrain, ROUNDS,
                    valid_sets=[jtrain.create_valid(xv, yv)],
                    early_stopping_rounds=2, evals_result=jev,
                    verbose_eval=False)
    ttrain = tlgb.Dataset(x, y, categorical_feature=cats)
    tb = tlgb.train({**params, "device": "cpu", "fused_chunk": 4}, ttrain,
                    ROUNDS, valid_sets=[ttrain.create_valid(xv, yv)],
                    early_stopping_rounds=2, evals_result=tev,
                    verbose_eval=False)
    return case, jb, tb, (x, y, xv, yv), (jev, tev)


def _trees(booster):
    booster._gbdt._flush_pending()
    return booster._gbdt.models


def test_multiclass_trees_equal_jax(runs):
    """Every tree of every class: the same splits (features, bin
    thresholds, children, decision types, category bitsets) and counts,
    leaf values within 1e-5 relative."""
    case, jb, tb, _, _ = runs
    jt, tt = _trees(jb), _trees(tb)
    k = CASES[case][1]
    assert len(tt) == len(jt) == ROUNDS * k
    assert tb._gbdt.num_model == k
    n_cat = 0
    for a, b in zip(jt, tt):
        n = a.num_leaves
        assert b.num_leaves == n
        for name in ("split_feature", "threshold_in_bin", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n - 1],
                                          getattr(a, name)[:n - 1], name)
        np.testing.assert_array_equal(b.leaf_count[:n], a.leaf_count[:n])
        assert b.cat_threshold == a.cat_threshold
        assert b.cat_threshold_inner == a.cat_threshold_inner
        np.testing.assert_allclose(b.leaf_value[:n], a.leaf_value[:n],
                                   rtol=1e-5, atol=1e-9)
        n_cat += b.num_cat
    assert n_cat > 0
    if CASES[case][2] is not None:
        # the absent class: a stump carrying its prior, then zeros
        absent = CASES[case][2]
        assert tt[absent].num_leaves == 1
        assert tt[absent].leaf_value[0] == jt[absent].leaf_value[0] < -30
        assert tt[k + absent].leaf_value[0] == 0.0


def test_multiclass_predictions_match_jax(runs):
    """(N, K) probabilities and raw scores within 1e-6 of the JAX
    package's, by the host walk and through the packed forest."""
    case, jb, tb, (x, y, xv, yv), _ = runs
    k = CASES[case][1]
    cfg = tb._gbdt.config
    for raw in (False, True):
        want = jb.predict(xv, raw_score=raw)
        host = tb.predict(xv, raw_score=raw)
        cfg.device_predict = "force"
        try:
            packed = tb.predict(xv, raw_score=raw)
        finally:
            cfg.device_predict = "auto"
        assert host.shape == packed.shape == want.shape == (len(xv), k)
        np.testing.assert_allclose(host, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(packed, host, rtol=0, atol=1e-6)
    prob = tb.predict(xv)
    np.testing.assert_allclose(prob.sum(axis=1) if case != "ova3" else 1.0,
                               1.0, atol=1e-9)


def test_multiclass_valid_metrics_and_early_stopping_match_jax(runs):
    case, jb, tb, _, (jev, tev) = runs
    assert tb.best_iteration == jb.best_iteration
    for name in ("multi_logloss", "multi_error"):
        got, want = tev["valid_0"][name], jev["valid_0"][name]
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    loss = tev["valid_0"]["multi_logloss"]
    assert loss[-1] < loss[0] < np.log(CASES[case][1])


def test_multiclass_runs_per_iteration_with_one_sync(runs):
    """``fused_chunk`` does not fuse multiclass (the fused path is for
    one model an iteration, as in the JAX package): one ``tree_stats``
    entry an iteration holding its trained classes' trees and waves, and
    one host sync."""
    case, _, tb, _, _ = runs
    gb = tb._gbdt
    assert not gb.fused_eligible()
    k, absent = CASES[case][1:]
    stats = gb.tree_stats
    assert len(stats) == gb.num_iterations()
    assert {s[1] for s in stats} == {k - (absent is not None)}
    assert {s[3] for s in stats} == {1}
    assert all(s[2] >= s[1] for s in stats)


def test_multiclass_model_text_loads_into_jax(runs):
    case, jb, tb, (x, y, xv, yv), _ = runs
    text = tb.model_to_string()
    loaded = jlgb.Booster(model_str=text)
    np.testing.assert_allclose(loaded.predict(xv), tb.predict(xv),
                               rtol=0, atol=1e-12)
    back = tlgb.Booster(model_str=text)
    np.testing.assert_allclose(back.predict(xv), tb.predict(xv),
                               rtol=0, atol=1e-12)
