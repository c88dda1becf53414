"""The host tree learner (``tree/learner.py``, ``ops/partition.py``, the
window histogram of ``ops/histogram.py``) against the JAX package's
(``device_growth: off``), on the parity features (``tests/parity_data.py``)
and seeded data; the JAX suite's ``tests/test_tree_learner.py`` and
``test_honesty.py::test_forced_splits`` re-pointed here, never at
external example files.

* the window histogram's plain version against the JAX ``build_histogram``
  over the same window of a permuted buffer (f32 sums in another order:
  rtol 1e-5 of each bin's |stat| sum; counts exact), and the partition
  against ``_partition_kernel`` (the same row order) for every missing
  type and a categorical set;
* single trees: the JAX package's structure, leaf counts and values
  (within 1e-5 of the tree's largest leaf value; a threshold may differ
  only on a gain tie that puts the same rows on each side);
  ``min_data_in_leaf``, a categorical split, monotone constraints
  (predictions monotone along a sweep), the score update equal to the
  trees' predictions;
* ``engine.train`` on the host learner: L1, quantile and mape (leaf
  renewal), ``fobj``, bagging with feature_fraction, GOSS, DART, RF,
  monotone constraints, forced splits and multiclass: the same trees and
  predictions within 1e-5 of the JAX package's;
* the route: ``device_growth=off`` and every configuration the device
  grower does not take train on the host learner and log why; 2 *
  COUNT_SPLIT_ROWS rows and more (the bound lowered to force it) too.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.ops.grow as jgrow
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.ops.grow as tgrow
import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
from lightgbm_tpu.ops.histogram import build_histogram as jbuild
from lightgbm_tpu.ops.partition import _partition_kernel
from lightgbm_tpu.tree.learner import SerialTreeLearner as JLearner
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.ops.histogram import build_histogram, stat_columns
from lightgbm_tpu_torch.ops.partition import partition_leaf
from lightgbm_tpu_torch.tree.learner import SerialTreeLearner as TLearner

CPU = torch.device("cpu")
BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 20,
        "verbose": -1}
ROUNDS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    x = pd.make_features()
    y_bin, y_reg, y_mc = pd.make_labels(x)
    return x, y_bin, y_reg, y_mc


def _datasets(x, params, categorical=()):
    jc, tc = JConfig(params), TConfig({**params, "device": "cpu"})
    return (jc, JDataset.construct_from_matrix(x, jc, categorical),
            tc, TDataset.construct_from_matrix(x, tc, categorical))


def _assert_tree_equal(jt, tt, x=None, rtol=1e-5):
    """Equal structure, counts and values (rtol).  A threshold may differ
    only on a gain tie that puts the same training rows on each side
    (ROADMAP §3): then both trees send every row of ``x`` to the same
    leaf."""
    n = jt.num_leaves
    assert tt.num_leaves == n
    for name in ("split_feature", "decision_type", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:n - 1],
                                      getattr(jt, name)[:n - 1], name)
    if not np.array_equal(tt.threshold_in_bin[:n - 1],
                          jt.threshold_in_bin[:n - 1]):
        assert x is not None, "thresholds differ"
        np.testing.assert_array_equal(tt.predict_leaf(x),
                                      jt.predict_leaf(x))
    np.testing.assert_array_equal(tt.leaf_count[:n], jt.leaf_count[:n])
    # f32 histogram sums in another order: 1e-5 of the tree's largest
    # leaf value (a small leaf's value cancels)
    np.testing.assert_allclose(
        tt.leaf_value[:n], jt.leaf_value[:n], rtol=rtol,
        atol=rtol * np.abs(jt.leaf_value[:n]).max())


# ----------------------------------------------------------------------
# the window histogram and the partition

def test_window_histogram_matches_jax(data):
    x = data[0]
    jc, jd, tc, td = _datasets(x, BASE)
    rng = np.random.default_rng(1)
    n = len(x)
    g = rng.standard_normal(n).astype(np.float32)
    h = (0.1 + rng.random(n)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    begin, count = 337, 1203
    m = 2048                                     # the JAX window's pad
    win = np.zeros(m, np.int32)
    win[:count] = perm[begin:begin + count]
    jh = np.asarray(jbuild(jnp.asarray(jd.binned), jnp.asarray(g),
                           jnp.asarray(h), jnp.asarray(win), count))
    learner = TLearner(tc, td, CPU)
    ghk = stat_columns(torch.from_numpy(g), torch.from_numpy(h))
    th = build_histogram(learner.binned_t, ghk,
                         torch.from_numpy(perm[begin:begin + count]),
                         learner.nb, ghk.abs().amax(dim=0)).numpy().reshape(td.num_groups,
                                                     learner.nb, 3)
    nb = min(learner.nb, 256)
    jh = jh[:, :nb]
    mag = np.asarray(jbuild(jnp.asarray(jd.binned), jnp.abs(jnp.asarray(g)),
                            jnp.asarray(h), jnp.asarray(win),
                            count))[:, :nb]
    assert (np.abs(th[..., :2] - jh[..., :2])
            <= 1e-5 * mag[..., :2] + 1e-7).all()
    np.testing.assert_array_equal(th[..., 2], jh[..., 2])


@pytest.mark.parametrize("case", ["plain", "nan_default_left", "zero",
                                  "categorical"])
def test_partition_matches_jax_row_order(data, case):
    x = data[0]
    cat = (2,) if case == "categorical" else ()
    _, jd, tc, td = _datasets(x, BASE, cat)
    f = {"plain": 0, "nan_default_left": 3, "zero": 8,
         "categorical": 2}[case]
    fi = jd.used_features.index(f)
    nb = int(jd.f_num_bin[fi])
    db = int(jd.f_default_bin[fi])
    member = np.zeros(256, bool)
    if case == "categorical":
        member[[1, 3]] = True
    split = dict(group=int(jd.f_group[fi]), offset=int(jd.f_offset[fi]),
                 width=nb - (db == 0), default_bin=db, num_bin=nb,
                 missing=int(jd.f_missing_type[fi]), threshold=nb // 2,
                 default_left=case == "nan_default_left",
                 is_cat=case == "categorical")
    rng = np.random.default_rng(2)
    perm = rng.permutation(len(x)).astype(np.int32)
    begin, count = 100, 1500
    jrows, jleft = _partition_kernel(
        jnp.asarray(jd.binned), jnp.asarray(perm[begin:begin + count]),
        0, count, *(jnp.asarray(split[k], jnp.int32) for k in
                    ("group", "offset", "width", "default_bin", "num_bin",
                     "missing", "threshold")),
        jnp.asarray(split["default_left"]), jnp.asarray(split["is_cat"]),
        jnp.asarray(member))
    learner = TLearner(tc, td, CPU)
    trows, tleft = partition_leaf(
        learner.binned_t, torch.from_numpy(perm[begin:begin + count]),
        cat_member=torch.from_numpy(member), **split)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    assert tleft == int(jleft)
    assert 0 < tleft < count


# ----------------------------------------------------------------------
# single trees (the JAX suite's tests/test_tree_learner.py re-pointed)

def _one_tree(x, params, grad, hess, categorical=()):
    jc, jd, tc, td = _datasets(x, params, categorical)
    jt = JLearner(jc, jd).train(jnp.asarray(grad), jnp.asarray(hess))
    tl = TLearner(tc, td, CPU)
    tt = tl.train(torch.from_numpy(grad), torch.from_numpy(hess))
    return jt, tt, tl


@pytest.mark.parametrize("params", [
    {"num_leaves": 31, "min_data_in_leaf": 20},
    {"num_leaves": 15, "min_data_in_leaf": 150},
    {"num_leaves": 31, "min_data_in_leaf": 5, "lambda_l1": 0.5,
     "lambda_l2": 1.0, "max_depth": 4},
], ids=["leaves31", "min_data150", "l1_l2_depth"])
def test_single_tree_matches_jax(data, params):
    x, _, y_reg, _ = data
    grad = (0.0 - y_reg).astype(np.float32)
    hess = np.ones(len(x), np.float32)
    p = {**BASE, **params}
    jt, tt, tl = _one_tree(x, p, grad, hess)
    _assert_tree_equal(jt, tt, x)
    counts = tt.leaf_count[:tt.num_leaves]
    assert counts.sum() == len(x)
    assert (counts >= p["min_data_in_leaf"]).all()
    # the score update through the partition equals the tree's prediction
    score = torch.zeros(len(x))
    tl.update_score(score, tt)
    np.testing.assert_allclose(score.numpy(), tt.predict(x), rtol=1e-6,
                               atol=1e-6)


def test_categorical_split_matches_jax():
    rng = np.random.RandomState(7)
    n = 3000
    cat = rng.randint(0, 8, n)
    y = np.where(np.isin(cat, [1, 3, 5]), 2.0, -1.0) + 0.05 * rng.randn(n)
    x = np.column_stack([cat.astype(np.float64), rng.randn(n, 2)])
    params = {"num_leaves": 8, "min_data_in_leaf": 20,
              "max_cat_to_onehot": 4, "verbose": -1}
    jt, tt, _ = _one_tree(x, params, (-y).astype(np.float32),
                          np.ones(n, np.float32), categorical=[0])
    _assert_tree_equal(jt, tt)
    assert tt.num_cat > 0
    assert np.mean((y - tt.predict(x)) ** 2) < 0.1 * np.mean(y ** 2)


def test_monotone_constraints_match_jax():
    rng = np.random.RandomState(11)
    n = 4000
    x = rng.uniform(-2, 2, (n, 2))
    y = 1.5 * x[:, 0] + np.sin(2 * x[:, 1]) + 0.1 * rng.randn(n)
    params = {"num_leaves": 31, "min_data_in_leaf": 20,
              "monotone_constraints": [1, 0], "verbose": -1}
    jt, tt, _ = _one_tree(x, params, (-y).astype(np.float32),
                          np.ones(n, np.float32))
    _assert_tree_equal(jt, tt)
    probe = np.tile(np.median(x, axis=0), (200, 1))
    probe[:, 0] = np.linspace(-2, 2, 200)
    assert (np.diff(tt.predict(probe)) >= -1e-10).all()


# ----------------------------------------------------------------------
# training on the host learner

def _pair(params, x, y, rounds=ROUNDS, **kw):
    jb = jlgb.train({**BASE, **params, "device_growth": "off"},
                    jlgb.Dataset(x, y), num_boost_round=rounds,
                    verbose_eval=False, **kw)
    tb = tlgb.train({**BASE, **params, "device": "cpu",
                     "device_growth": "off"}, tlgb.Dataset(x, y),
                    num_boost_round=rounds, verbose_eval=False, **kw)
    assert tb._gbdt.learner is not None and tb._gbdt._grower is None
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        _assert_tree_equal(a, b, x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    return jb, tb


@pytest.mark.parametrize("params,label", [
    ({"objective": "binary", "bagging_fraction": 0.7, "bagging_freq": 2,
      "feature_fraction": 0.8}, "bin"),
    ({"objective": "binary", "boosting": "goss", "learning_rate": 0.3},
     "bin"),
    ({"objective": "binary", "boosting": "dart", "drop_rate": 0.5,
      "skip_drop": 0.0}, "bin"),
    ({"objective": "binary", "boosting": "rf", "bagging_fraction": 0.7,
      "bagging_freq": 1}, "bin"),
    ({"objective": "binary",
      "monotone_constraints": "1,0,-1,0,0,0,0,0,0,0"}, "bin"),
    ({"objective": "multiclass", "num_class": 3}, "mc"),
    ({"objective": "regression", "gpu_use_dp": True}, "reg"),
], ids=["bagging_ff", "goss", "dart", "rf", "monotone", "multiclass",
        "gpu_use_dp"])
def test_host_learner_training_matches_jax(data, params, label):
    x, y_bin, y_reg, y_mc = data
    y = {"bin": y_bin, "reg": y_reg, "mc": y_mc}[label]
    rounds = 6 if params.get("boosting") == "goss" else ROUNDS
    _pair(params, x, y, rounds)


@pytest.mark.parametrize("objective,extra", [
    ("regression_l1", {}), ("quantile", {"alpha": 0.9}), ("mape", {}),
    ("quantile", {"alpha": 0.3, "bagging_fraction": 0.7,
                  "bagging_freq": 1}),
], ids=["l1", "quantile", "mape", "quantile_bagged"])
def test_renewing_objectives_match_jax(data, objective, extra):
    """The leaf renewal (each leaf's percentile of its rows' residuals):
    the JAX host learner's trees, leaf values and predictions."""
    x, _, y_reg, _ = data
    _, tb = _pair({"objective": objective, **extra}, x, y_reg)
    assert len(tb._gbdt.models) == ROUNDS


def test_fobj_matches_jax(data):
    """Custom gradients: objective none, no fusing, the host learner."""
    x, y = data[0], data[1]

    def fobj(preds, _ds):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - y, p * (1.0 - p)
    _, tb = _pair({"fused_chunk": 4}, x, y, fobj=fobj)
    assert tb._gbdt.objective is None
    assert not tb._gbdt.fused_eligible()


def test_forced_splits_match_jax(data, tmp_path):
    """The JAX suite's test_forced_splits on the parity features: node 0
    splits the forced feature near its threshold, its left child the
    second forced feature, and the trees equal the JAX package's."""
    x, _, y_reg, _ = data
    forced = {"feature": 7, "threshold": 0.0,
              "left": {"feature": 9, "threshold": 0.5}}
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(forced))
    _, tb = _pair({"objective": "regression",
                   "forcedsplits_filename": str(path)}, x, y_reg)
    for tree in tb._gbdt.models:
        assert int(tree.split_feature[0]) == 7
        assert abs(float(tree.threshold[0])) < 5.0
        left = int(tree.left_child[0])
        assert left >= 0 and int(tree.split_feature[left]) == 9
        assert abs(float(tree.threshold[left]) - 0.5) < 0.05
    loaded = tlgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(loaded.predict(x[:100], raw_score=True),
                               tb.predict(x[:100], raw_score=True),
                               atol=1e-6)


@pytest.mark.parametrize("params,why", [
    ({"device_growth": "off"}, "device_growth=off"),
    ({"monotone_constraints": "1,0,0,0,0,0,0,0,0,0"},
     "monotone constraints"),
    ({"objective": "quantile"}, "renews its leaf outputs"),
    ({"device_growth": "on", "objective": "regression_l1"},
     "renews its leaf outputs"),
], ids=["off", "monotone", "renewing", "on_ineligible"])
def test_route_logs_why_the_host_learner_trains(data, caplog, params, why):
    x, y = data[0], data[2]
    with caplog.at_level(logging.INFO, logger="lightgbm_tpu_torch"):
        tb = tlgb.train({**BASE, "objective": "regression", **params,
                         "device": "cpu", "verbose": 1},
                        tlgb.Dataset(x, y), 2, verbose_eval=False)
    assert tb._gbdt.learner is not None and tb._gbdt._grower is None
    assert "Using the host tree learner: " in caplog.text
    assert why in caplog.text
    if params.get("device_growth") == "on":
        assert "falling back to the host learner" in caplog.text


def test_eligible_config_stays_on_the_device_grower(data):
    x, y = data[0], data[1]
    for mode in ("auto", "on"):
        tb = tlgb.train({**BASE, "objective": "binary", "device": "cpu",
                         "device_growth": mode}, tlgb.Dataset(x, y), 2,
                        verbose_eval=False)
        assert tb._gbdt._grower is not None and tb._gbdt.learner is None


def test_rows_past_the_device_bound_train_on_the_host_learner(data, caplog):
    """2 * COUNT_SPLIT_ROWS rows or more (the bound lowered in both
    packages to 900, so the parity features' 2,000 rows pass it): both
    packages leave their device growers, and the trees agree."""
    x, y = data[0], data[1]
    old = tgrow.COUNT_SPLIT_ROWS, jgrow.COUNT_SPLIT_ROWS
    try:
        tgrow.COUNT_SPLIT_ROWS = jgrow.COUNT_SPLIT_ROWS = 900
        with caplog.at_level(logging.INFO, logger="lightgbm_tpu_torch"):
            tb = tlgb.train({**BASE, "objective": "binary", "device": "cpu",
                             "verbose": 1}, tlgb.Dataset(x, y), 3,
                            verbose_eval=False)
        jb = jlgb.train({**BASE, "objective": "binary",
                         "device_growth": "on"}, jlgb.Dataset(x, y), 3,
                        verbose_eval=False)
    finally:
        tgrow.COUNT_SPLIT_ROWS, jgrow.COUNT_SPLIT_ROWS = old
    assert "2000 rows >= 2 * COUNT_SPLIT_ROWS (1800)" in caplog.text
    assert tb._gbdt._grower is None and jb._gbdt._grower is None
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        _assert_tree_equal(a, b, x)


def test_custom_gradients_on_a_device_grown_booster(data):
    """Booster.update(fobj=...) on a booster the device grower trains: the
    iteration runs on the host learner, as the JAX package's does."""
    x, y = data[0], data[1]

    def fobj(preds, _ds):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - y, p * (1.0 - p)
    params = {**BASE, "objective": "binary"}
    tparams = {**params, "device": "cpu"}
    # a Booster bins a Dataset with the Dataset's own params
    tb = tlgb.Booster(params=tparams,
                      train_set=tlgb.Dataset(x, y, params=tparams))
    jparams = {**params, "device_growth": "on"}
    jb = jlgb.Booster(params=jparams,
                      train_set=jlgb.Dataset(x, y, params=jparams))
    for b in (tb, jb):
        b.update()
        b.update(fobj=fobj)
    assert tb._gbdt._grower is not None and tb._gbdt.learner is not None
    # the learner reads the grower's codes, no second copy
    assert (tb._gbdt.learner.binned_t.data_ptr()
            == tb._gbdt._grower.binned_t.data_ptr())
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("policy", ["refit", "warm"])
def test_pipeline_policies_on_the_host_learner(policy):
    """RetrainPipeline's refit and warm windows over a host-learned
    ensemble (monotone constraints): the leaf ids come from the host
    learner's codes and equal the host walk's; the warm window's training
    scores equal predict's."""
    from lightgbm_tpu_torch.pipeline import PreppedWindow, RetrainPipeline

    def prep(w):
        rng = np.random.default_rng(300 + w)
        x = rng.standard_normal((3000, 4))
        y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)
        return PreppedWindow(label=y, dense=x)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
              "min_data_in_leaf": 5, "verbosity": -1, "metric": "none",
              "num_iterations": 4, "device": "cpu",
              "monotone_constraints": "1,0,0,0"}
    pipe = RetrainPipeline(params, window_policy=policy,
                           rebin_on_drift=False, serve=False)
    res = pipe.run(range(2), prep)
    assert [r.policy for r in res] == ["fresh", policy]
    gb = res[1].booster
    assert gb.learner is not None and gb._grower is None
    x = prep(1).dense
    for tree, ids in zip(gb.models, pipe.last_leaf_ids):
        if ids is not None:
            np.testing.assert_array_equal(ids, tree.predict_leaf(x))
    if policy == "warm":
        np.testing.assert_allclose(
            gb.train_score[0].double().numpy(),
            gb.predict(x, raw_score=True), rtol=1e-5, atol=1e-5)


def test_host_learner_checkpoint_resume_is_byte_identical(data, tmp_path):
    """A host-learned run (bagging, feature_fraction's numpy stream)
    snapshotted at iteration 3 and resumed equals the uninterrupted run
    byte for byte; the sidecar carries the stream's state in the JAX
    package's format."""
    from lightgbm_tpu.robust import checkpoint as jcheckpoint
    x, y = data[0], data[1]
    params = {**BASE, "objective": "binary", "device": "cpu",
              "device_growth": "off", "bagging_fraction": 0.7,
              "bagging_freq": 2, "feature_fraction": 0.7}
    full = tlgb.Booster(params=params, train_set=tlgb.Dataset(x, y))
    for _ in range(6):
        full.update()
    part = tlgb.Booster(params=params, train_set=tlgb.Dataset(x, y))
    for _ in range(3):
        part.update()
    path = str(tmp_path / "snap.txt")
    part._gbdt.save_checkpoint(path)
    score, it, rng_state = jcheckpoint.load_train_state(path + ".state.npz")
    assert it == 3 and rng_state is not None
    resumed = tlgb.Booster(params=params, train_set=tlgb.Dataset(x, y))
    resumed._gbdt.resume_from_checkpoint(path)
    for _ in range(3):
        resumed.update()
    assert resumed.model_to_string() == full.model_to_string()
