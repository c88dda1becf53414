"""The port's whole slice against the JAX package: 10 rounds of binary
GBDT on the parity features, both on their device growers.

* the first 3 trees are structurally equal (features, bin thresholds,
  children, leaf counts) with leaf values within 1e-5 relative;
* raw predictions agree within 1e-3 and AUC within 2e-3 (from tree 2 on,
  f32 summation-order noise in the histograms may move a near-tie split);
* each package's model text loads into the other with identical
  predictions, and convert.booster_from_arrays rebuilds a JAX booster."""

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu_torch.convert import TREE_FIELDS, booster_from_arrays
from lightgbm_tpu_torch.metrics import AUCMetric

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}
ROUNDS = 10


@pytest.fixture(scope="module")
def data():
    x = pd.make_features()
    y, _, _ = pd.make_labels(x)
    return x, y


@pytest.fixture(scope="module")
def boosters(data):
    x, y = data
    jb = jlgb.train({**PARAMS, "device_growth": "on"}, jlgb.Dataset(x, y),
                    num_boost_round=ROUNDS, verbose_eval=False)
    tb = tlgb.train({**PARAMS, "device": "cpu"}, tlgb.Dataset(x, y),
                    num_boost_round=ROUNDS)
    return jb, tb


def _trees(booster):
    booster._gbdt._flush_pending()
    return booster._gbdt.models


def _auc(y, score):
    class _Md:
        label, weights = y, None
    m = AUCMetric(None)
    m.init(_Md, len(y))
    return m.eval(score[None, :], None)[0][1]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_first_trees_structurally_equal(boosters, i):
    jt, tt = _trees(boosters[0])[i], _trees(boosters[1])[i]
    assert jt.num_leaves == tt.num_leaves > 2
    n = jt.num_leaves
    for name in ("split_feature", "threshold_in_bin", "threshold",
                 "decision_type", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:n - 1],
                                      getattr(jt, name)[:n - 1], name)
    np.testing.assert_array_equal(tt.leaf_count[:n], jt.leaf_count[:n])
    np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                               rtol=1e-5, atol=1e-7)


def test_predictions_and_auc_agree(boosters, data):
    x, y = data
    jb, tb = boosters
    assert tb.num_trees() == len(_trees(jb)) == ROUNDS
    jp = jb.predict(x, raw_score=True)
    tp = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    assert abs(_auc(y, tp) - _auc(y, jp)) < 2e-3
    assert _auc(y, tp) > 0.9


def test_training_logloss_agrees(boosters):
    (name_j, j), = [(r[1], r[2]) for r in boosters[0].eval_train()]
    (name_t, t), = [(r[1], r[2]) for r in boosters[1].eval_train()]
    assert name_j == name_t == "binary_logloss"
    assert abs(t - j) < 1e-4


def test_host_predict_matches_device_score(boosters, data):
    x, _ = data
    tb = boosters[1]
    score = tb._gbdt.train_score[0].double().numpy()
    np.testing.assert_allclose(tb.predict(x, raw_score=True), score,
                               atol=1e-5)


def test_model_text_round_trips_both_ways(boosters, data):
    """A model text predicts identically in both packages.  (The v2 text
    writes 17 digits after the point, so a reloaded model matches the
    trained one to ~1e-16, in either package.)"""
    x, _ = data
    for booster in boosters:
        text = booster.model_to_string()
        in_j = jlgb.Booster(model_str=text).predict(x)
        in_t = tlgb.Booster(model_str=text).predict(x)
        np.testing.assert_array_equal(in_t, in_j)
        np.testing.assert_allclose(in_t, booster.predict(x), rtol=1e-12)
    t_text = boosters[1].model_to_string()
    again = tlgb.Booster(model_str=t_text).model_to_string()
    assert again.split("parameters:")[0] == t_text.split("parameters:")[0]


def test_booster_from_jax_arrays(boosters, data):
    x, _ = data
    jb = boosters[0]
    trees = []
    for t in _trees(jb):
        arrays = {name: getattr(t, name) for name in TREE_FIELDS}
        arrays.update(num_leaves=t.num_leaves, shrinkage=t.shrinkage)
        trees.append(arrays)
    gb = jb._gbdt
    port = booster_from_arrays(trees, max_feature_idx=gb.max_feature_idx,
                               feature_names=gb.feature_names,
                               objective=gb.objective.to_string())
    np.testing.assert_array_equal(port.predict(x), jb.predict(x))
