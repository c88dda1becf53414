"""The port's whole slice against the JAX package: 10 rounds of binary
GBDT on the parity features, both on their device growers.

* the first 3 trees are structurally equal (features, bin thresholds,
  children, leaf counts) with leaf values within 1e-5 relative;
* raw predictions agree within 1e-3 and AUC within 2e-3 (from tree 2 on,
  f32 summation-order noise in the histograms may move a near-tie split);
* each package's model text loads into the other with identical
  predictions, and convert.booster_from_arrays rebuilds a JAX booster.

Two sampled configurations go through the same checks (first 3 trees
structurally equal, AUC within 2e-3):

* the fork harness's config (31 leaves, max_bin 255, feature_fraction
  0.8, bagging every 5 rounds at 0.8) with both Datasets built from a
  scipy CSR matrix: the bagging and feature masks are the JAX package's
  Threefry draws;
* grad_quant_bits=8.  The model text is not byte-equal to the jitted JAX
  package's: its programs run on XLA's CPU backend, which contracts a*b+c
  into fused multiply-adds, so split gains and leaf values differ in the
  last bits; the first trees are structurally equal with leaf values
  within 1e-6.  Against the JAX package run op by op (jax.disable_jit)
  the first tree's model text is byte-equal."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

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


@pytest.mark.parametrize("route", ["off", "force"])
def test_predict_matches_device_score_on_both_routes(boosters, data, route):
    """The host walk (off) and the packed-forest path (force, its plain
    version here) predict the training score the grower kept."""
    x, _ = data
    g = boosters[1]._gbdt
    score = g.train_score[0].double().numpy()
    mode = g.config.device_predict
    g.config.device_predict = route
    try:
        raw = boosters[1].predict(x, raw_score=True)
    finally:
        g.config.device_predict = mode
    np.testing.assert_allclose(raw, score, atol=1e-5)


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


HARNESS = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
           "learning_rate": 0.1, "feature_fraction": 0.8,
           "bagging_freq": 5, "bagging_fraction": 0.8, "verbose": -1}
SAMPLED = {
    "harness_csr": (HARNESS, True, 1e-5),
    "int8": ({**PARAMS, "grad_quant_bits": 8}, False, 1e-6),
}


@pytest.fixture(scope="module", params=sorted(SAMPLED))
def sampled(request, data):
    """(config name, JAX booster, port booster, leaf-value rtol)."""
    x, y = data
    params, csr, rtol = SAMPLED[request.param]
    feats = sp.csr_matrix(x) if csr else x
    jb = jlgb.train({**params, "device_growth": "on"},
                    jlgb.Dataset(feats, y), num_boost_round=ROUNDS,
                    verbose_eval=False)
    tb = tlgb.train({**params, "device": "cpu"}, tlgb.Dataset(feats, y),
                    num_boost_round=ROUNDS)
    return request.param, jb, tb, rtol


@pytest.mark.parametrize("i", [0, 1, 2])
def test_sampled_first_trees_structurally_equal(sampled, i):
    _, jb, tb, rtol = sampled
    jt, tt = _trees(jb)[i], _trees(tb)[i]
    assert jt.num_leaves == tt.num_leaves > 2
    n = jt.num_leaves
    for name in ("split_feature", "threshold_in_bin", "threshold",
                 "decision_type", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:n - 1],
                                      getattr(jt, name)[:n - 1], name)
    np.testing.assert_array_equal(tt.leaf_count[:n], jt.leaf_count[:n])
    np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                               rtol=rtol, atol=1e-7)


def test_sampled_auc_agrees(sampled, data):
    """AUC after all rounds within 2e-3; host predict equals the device
    training score (out-of-bag rows included)."""
    x, y = data
    name, jb, tb, _ = sampled
    assert tb.num_trees() == len(_trees(jb)) == ROUNDS
    jp = jb.predict(x, raw_score=True)
    tp = tb.predict(x, raw_score=True)
    assert abs(_auc(y, tp) - _auc(y, jp)) < 2e-3, name
    assert _auc(y, tp) > 0.9
    score = tb._gbdt.train_score[0].double().numpy()
    np.testing.assert_allclose(tp, score, atol=1e-5)


def test_harness_masks_are_drawn_per_tree_and_round(sampled):
    """Bagging redraws every bagging_freq rounds; feature_fraction masks
    differ from tree to tree."""
    name, _, tb, _ = sampled
    gb = tb._gbdt
    if name != "harness_csr":
        assert gb.row_mask is None and not gb.need_bagging
        return
    masks = [gb._grower.feature_mask_for(t) for t in range(ROUNDS)]
    assert all(int(m.sum()) == gb._grower._ff_k for m in masks)
    assert len({tuple(m.tolist()) for m in masks}) > 1
    last = gb.row_mask.clone()
    gb.bagging(ROUNDS)                    # a new round: a new bag
    assert not torch.equal(last, gb.row_mask)
    bag = gb.row_mask
    gb.bagging(ROUNDS + 1)                # inside the round: unchanged
    assert gb.row_mask is bag


def test_int8_first_tree_text_byte_equal_to_jax_op_by_op(data):
    """grad_quant_bits=8, one round: the model text (up to the parameters)
    equals the JAX package's evaluated op by op byte for byte: the same
    gradients, Threefry noise, int8 columns, int32 scan and refit."""
    x, y = data
    params = {**PARAMS, "grad_quant_bits": 8}
    with jax.disable_jit():
        jb = jlgb.train({**params, "device_growth": "on",
                         "hist_kernel": "einsum"}, jlgb.Dataset(x, y),
                        num_boost_round=1, verbose_eval=False)
    tb = tlgb.train({**params, "device": "cpu"}, tlgb.Dataset(x, y),
                    num_boost_round=1)
    want = jb.model_to_string().split("parameters:")[0]
    got = tb.model_to_string().split("parameters:")[0]
    assert "Tree=0" in got and "Tree=1" not in got
    assert got == want


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
