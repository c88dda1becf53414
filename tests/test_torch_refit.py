"""Leaf refit in the port (``GBDT.refit_leaves``, ``Booster.refit``)
against the JAX package, and the cases of ``tests/test_refit.py``
re-pointed at the port.

* On the parity features, one model (trained by the JAX package's device
  grower, ``device_growth: on``) loaded into both packages and refit on
  new rows and labels, binary and regression, at decay 0.9 and 0: every
  leaf value within 1e-6 of max|leaf value| of the JAX package's, and a
  leaf that no new row reaches unchanged bit for bit;
* the pipeline's route — leaf ids given, raw scores summed from the leaf
  values — gives the same values as the raw-feature route;
* ``Booster.refit`` returns a copy and leaves its booster as it was;
* structure and decay semantics, the leaf formula against the
  reference's math, multi-window quality, multiclass and a loaded
  objective's extras.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 5, "verbosity": -1, "metric": "none",
          "device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parity():
    x = pd.make_features()
    y_bin, y_reg, _ = pd.make_labels(x)
    return x, {"binary": y_bin, "regression": y_reg}


def _binary_window(seed, n=4000, nf=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nf))
    y = (x[:, 0] + 0.5 * x[:, 1]
         + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    return x, y


def _train(x, y, params, iters=15):
    ds = tlgb.Dataset(x, label=y, params=params)
    bst = tlgb.Booster(params=params, train_set=ds)
    bst.update_chunked(iters, chunk=5)
    return bst


def _assert_same_structure(a, b):
    assert len(a.models) == len(b.models)
    for ta, tb in zip(a.models, b.models):
        assert ta.num_leaves == tb.num_leaves
        n = ta.num_leaves - 1
        np.testing.assert_array_equal(ta.split_feature[:n],
                                      tb.split_feature[:n])
        np.testing.assert_allclose(ta.threshold[:n], tb.threshold[:n],
                                   rtol=1e-12, atol=1e-30)


def _auc(y, p):
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    pos = y > 0
    return (ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) \
        / (pos.sum() * (~pos).sum())


# ----------------------------------------------------------------------
# against the JAX package

@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("decay", [0.9, 0.0])
def test_refit_leaves_match_jax(parity, objective, decay):
    x, labels = parity
    y = labels[objective]
    params = {"objective": objective, "num_leaves": 15, "max_bin": 63,
              "min_data_in_leaf": 20, "verbose": -1}
    jb = jlgb.train({**params, "device_growth": "on"},
                    jlgb.Dataset(x[:1000], y[:1000]), num_boost_round=6,
                    verbose_eval=False)
    text = jb.model_to_string()
    # 40 new rows (few enough that some leaves get none) and new
    # labels, shuffled in part
    x_new = x[1000:1040]
    rng = np.random.default_rng(7)
    y_new = y[1000:1040].copy()
    flip = rng.random(len(y_new)) < 0.2
    y_new[flip] = rng.permutation(y_new[flip])
    j_ref = jlgb.Booster(model_str=text, params={})
    t_ref = tlgb.Booster(model_str=text, params={"device": "cpu"})
    j_ref._gbdt.refit_leaves(x_new, y_new, decay_rate=decay)
    t_ref._gbdt.refit_leaves(x_new, y_new, decay_rate=decay)
    j_old = jlgb.Booster(model_str=text, params={})._gbdt.models
    jt_models, tt_models = j_ref._gbdt.models, t_ref._gbdt.models
    scale = max(np.abs(t.leaf_value[:t.num_leaves]).max()
                for t in jt_models)
    empty_leaves = 0
    for jt, tt, old in zip(jt_models, tt_models, j_old):
        n = jt.num_leaves
        np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                                   rtol=0, atol=1e-6 * scale)
        if n > 1:
            reached = np.bincount(old.predict_leaf(x_new), minlength=n)
            empty = reached[:n] == 0
            empty_leaves += int(empty.sum())
            np.testing.assert_array_equal(tt.leaf_value[:n][empty],
                                          old.leaf_value[:n][empty])
    # some tree has a leaf the new rows miss
    assert empty_leaves > 0


def test_refit_from_leaf_ids_equals_refit_from_rows(parity):
    """The pipeline's route: leaf ids given (here the host walk's), raw
    scores summed from the leaf values; the values equal the raw-feature
    route's (both sum in float64 on the host below
    ``device_predict_min_rows``)."""
    x, labels = parity
    y = labels["binary"]
    bst = _train(x[:1000], y[:1000], PARAMS, iters=6)
    a = tlgb.Booster(model_str=bst.model_to_string(), params=PARAMS)
    b = tlgb.Booster(model_str=bst.model_to_string(), params=PARAMS)
    x_new, y_new = x[1000:], y[1000:]
    a._gbdt.refit_leaves(x_new, y_new, decay_rate=0.5)
    ids = [t.predict_leaf(x_new) if t.num_leaves > 1 else None
           for t in b._gbdt.models]
    b._gbdt.refit_leaves(None, y_new, decay_rate=0.5, leaf_ids=ids)
    for ta, tb in zip(a._gbdt.models, b._gbdt.models):
        np.testing.assert_array_equal(tb.leaf_value[:tb.num_leaves],
                                      ta.leaf_value[:ta.num_leaves])


def test_booster_refit_returns_a_copy_and_invalidates_the_pack():
    x, y = _binary_window(20, n=2000)
    bst = _train(x, y, PARAMS, iters=5)
    before = bst.model_to_string()
    pred_before = bst.predict(x, raw_score=True)
    x2, y2 = _binary_window(21, n=2000)
    rb = bst.refit(x2, 1.0 - y2, decay_rate=0.0)
    assert rb is not bst and rb._gbdt is not bst._gbdt
    assert bst.model_to_string() == before
    np.testing.assert_array_equal(bst.predict(x, raw_score=True),
                                  pred_before)
    # the packed forest of a refit booster holds the refit values
    g = rb._gbdt
    raw_host = g.predict_raw(x)
    g.config.device_predict = "force"
    np.testing.assert_allclose(g.predict_raw(x), raw_host, rtol=1e-5,
                               atol=1e-5)
    g.refit_leaves(x2, y2, decay_rate=0.0)
    g.config.device_predict = "off"
    raw_host2 = g.predict_raw(x)
    g.config.device_predict = "force"
    np.testing.assert_allclose(g.predict_raw(x), raw_host2, rtol=1e-5,
                               atol=1e-5)
    assert np.abs(raw_host2 - raw_host).max() > 1e-3


# ----------------------------------------------------------------------
# tests/test_refit.py, re-pointed at the port

def test_refit_preserves_structure_and_decay_semantics():
    x, y = _binary_window(0)
    bst = _train(x, y, PARAMS)
    x2, y2 = _binary_window(1)

    same = bst.refit(x2, y2, decay_rate=1.0)
    for t0, t1 in zip(bst._gbdt.models, same._gbdt.models):
        np.testing.assert_allclose(t0.leaf_value[:t0.num_leaves],
                                   t1.leaf_value[:t1.num_leaves])

    rb = bst.refit(x2, y2, decay_rate=0.5)
    _assert_same_structure(rb._gbdt, bst._gbdt)
    moved = any(
        not np.allclose(t0.leaf_value[:t0.num_leaves],
                        t1.leaf_value[:t1.num_leaves])
        for t0, t1 in zip(bst._gbdt.models, rb._gbdt.models))
    assert moved
    again = bst.refit(x2, y2, decay_rate=0.5)
    for t0, t1 in zip(rb._gbdt.models, again._gbdt.models):
        np.testing.assert_allclose(t0.leaf_value[:t0.num_leaves],
                                   t1.leaf_value[:t1.num_leaves])


def test_refit_leaf_formula_matches_reference_math():
    params = {"objective": "regression", "num_leaves": 8, "max_bin": 63,
              "min_data_in_leaf": 5, "verbosity": -1, "metric": "none",
              "lambda_l1": 0.0, "lambda_l2": 0.0, "learning_rate": 0.1,
              "device": "cpu"}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3000, 6))
    y = x[:, 0] * 2.0 + rng.standard_normal(3000) * 0.1
    bst = _train(x, y, params, iters=5)
    x2 = rng.standard_normal((2000, 6))
    y2 = x2[:, 0] * 2.0 + rng.standard_normal(2000) * 0.1

    rb = bst.refit(x2, y2, decay_rate=0.0)
    pred = bst.predict(x2)
    for t_old, t_new in zip(bst._gbdt.models, rb._gbdt.models):
        leaves = t_old.predict_leaf(x2)
        for leaf in range(t_old.num_leaves):
            rows = leaves == leaf
            if not rows.any():
                np.testing.assert_allclose(t_new.leaf_value[leaf],
                                           t_old.leaf_value[leaf])
                continue
            expect = 0.1 * float(np.mean(y2[rows] - pred[rows]))
            np.testing.assert_allclose(t_new.leaf_value[leaf], expect,
                                       rtol=1e-5, atol=1e-7)


def test_refit_multiwindow_quality_no_worse_than_fresh():
    windows = [_binary_window(10 + w, n=5000) for w in range(4)]
    fresh_aucs, refit_aucs = [], []
    refit_bst = None
    for w in range(3):
        x, y = windows[w]
        xn, yn = windows[w + 1]
        fresh = _train(x, y, PARAMS)
        fresh_aucs.append(_auc(yn, fresh.predict(xn)))
        refit_bst = fresh if refit_bst is None \
            else refit_bst.refit(x, y, decay_rate=0.9)
        refit_aucs.append(_auc(yn, refit_bst.predict(xn)))
    assert min(refit_aucs) > 0.85, (refit_aucs, fresh_aucs)
    assert np.mean(refit_aucs) >= np.mean(fresh_aucs) - 0.02, \
        (refit_aucs, fresh_aucs)


def test_refit_multiclass_and_loaded_objective_extras():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2000, 6))
    y = (x[:, 0] > 0).astype(np.float64) + (x[:, 1] > 0)
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 8,
              "min_data_in_leaf": 5, "verbosity": -1, "metric": "none",
              "device": "cpu"}
    bst = _train(x, y, params, iters=4)
    rb = bst.refit(x, y, decay_rate=0.3)
    assert rb._gbdt.num_model == 3
    _assert_same_structure(rb._gbdt, bst._gbdt)

    x2, y2 = _binary_window(4, n=1500)
    b2 = _train(x2, y2, {**PARAMS, "sigmoid": 2.0})
    loaded = tlgb.Booster(model_str=b2.model_to_string(),
                          params={"device": "cpu"})
    obj = loaded._gbdt._refit_objective()
    assert obj.sigmoid == pytest.approx(2.0)


def test_refit_runs_on_the_card_by_default(monkeypatch):
    """Without ``device``, refit gradients go to cuda: without a card
    that raises (the port never falls back to the CPU silently)."""
    x, y = _binary_window(30, n=1000)
    bst = _train(x, y, PARAMS, iters=2)
    loaded = tlgb.Booster(model_str=bst.model_to_string(), params={})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tlgb.LightGBMError, match="cuda"):
        loaded.refit(x, y)
