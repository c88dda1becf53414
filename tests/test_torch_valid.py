"""Validation while training, the port against the JAX package on the
parity data:

* the binned-matrix traversal (``ops/traverse.py``) on trees the JAX
  package trained, converted with ``convert.tree_from_arrays``: leaves
  byte-equal to the JAX ``traverse`` and to the host walk of the raw rows,
  scores within 1e-6 of the JAX ``add_tree_score``; trees with every
  missing type and with categorical splits;
* ``engine.train`` with a weighted validation set, the training set among
  the valid sets, ``feval`` and early stopping, in both packages: the same
  ``best_iteration``, each iteration's ``evals_result`` within 1e-4 over
  the first 3 iterations (structurally equal trees) and 2e-3 after, and
  ``print_evaluation``'s lines in the JAX package's format;
* ``GBDT.add_valid``'s checks, its lazy scoring (a set added late takes
  only later trees; a stump adds its constant) and the options refused by
  name.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu import callback as jcallback
from lightgbm_tpu.ops import traverse as jtraverse
from lightgbm_tpu_torch import callback as tcallback
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import TREE_FIELDS, tree_from_arrays
from lightgbm_tpu_torch.data.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.ops import traverse as ttraverse
from lightgbm_tpu_torch.utils.log import LightGBMError

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1}

#: traversal cases: data, extra params, categorical columns, and the
#: missing types (decision_type bits 2-3) their trees must contain
TRAVERSE_CASES = {
    "nan_missing": ("nan", {}, [], {0, 2}),
    "zero_missing": ("numeric", {"zero_as_missing": True}, [], {1}),
    "no_missing": ("numeric", {"use_missing": False}, [], {0}),
    "categorical": ("categorical", {}, [0, 1], {0}),
}


def _data(kind):
    if kind == "numeric":
        x = pd.make_features()
        return x, pd.make_labels(x)[0]
    if kind == "nan":
        # labels that read the NaN-heavy column 3, NaN as a value of its own
        x = pd.make_features()
        y = (np.nan_to_num(x[:, 3], nan=2.0) > 0.3) ^ (x[:, 0] > 1.0)
        return x, y.astype(np.float64)
    x = pd.make_categorical_features()
    return x, pd.make_categorical_labels(x)


def _port_tree(t):
    """The port's Tree of a JAX-trained one, inner fields included."""
    arrays = {name: getattr(t, name) for name in TREE_FIELDS}
    arrays.update(num_leaves=t.num_leaves, num_cat=t.num_cat,
                  cat_boundaries=t.cat_boundaries,
                  cat_threshold=t.cat_threshold,
                  cat_boundaries_inner=t.cat_boundaries_inner,
                  cat_threshold_inner=t.cat_threshold_inner)
    return tree_from_arrays(arrays)


@pytest.mark.parametrize("case", sorted(TRAVERSE_CASES))
def test_traversal_matches_jax_and_host_walk(case):
    kind, extra, cats, missing_types = TRAVERSE_CASES[case]
    x, y = _data(kind)
    params = {**BASE, **extra}
    jb = jlgb.train(params, jlgb.Dataset(x, y, categorical_feature=cats),
                    num_boost_round=3, verbose_eval=False)
    jg = jb._gbdt
    jg._flush_pending()
    jds = jg.train_set
    tds = TDataset.construct_from_matrix(x, TConfig(params),
                                         categorical=cats)
    np.testing.assert_array_equal(tds.binned, jds.binned)
    jbinned, tbinned = jnp.asarray(jds.binned), torch.from_numpy(tds.binned)
    rng = np.random.default_rng(pd.SEED + 20)
    score0 = rng.standard_normal(len(x)).astype(np.float32)
    seen = set()
    for t in jg.models:
        assert t.num_leaves > 2
        n = t.num_leaves - 1
        seen |= set(((t.decision_type[:n].astype(np.int32) >> 2) & 3)
                    .tolist())
        if cats:
            assert (t.decision_type[:n] & 1).any()
        jdt = jtraverse.device_tree(t, jds, params["num_leaves"])
        tt = _port_tree(t)
        tdt = ttraverse.device_tree(tt, tds, params["num_leaves"], "cpu")
        leaves = ttraverse.traverse(tbinned, tdt).numpy()
        np.testing.assert_array_equal(
            leaves, np.asarray(jtraverse.traverse(jbinned, jdt)))
        np.testing.assert_array_equal(leaves, tt.predict_leaf(x))
        got = ttraverse.add_tree_score(torch.from_numpy(score0), tbinned,
                                       tdt, 1.0).numpy()
        want = np.asarray(jtraverse.add_tree_score(jnp.asarray(score0),
                                                   jbinned, jdt, 1.0))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert missing_types <= seen


def test_stump_and_depth():
    """A stump takes one step to leaf 0; a tree's depth is its longest
    path, whatever the order its nodes were numbered in."""
    x, y = _data("numeric")
    tds = TDataset.construct_from_matrix(x, TConfig(BASE))
    stump = tree_from_arrays({"num_leaves": 1, "leaf_value": [0.25]})
    dt = ttraverse.device_tree(stump, tds, 15, "cpu")
    assert dt.depth == 1
    leaves = ttraverse.traverse(torch.from_numpy(tds.binned), dt)
    assert (leaves == 0).all()
    # root -> node 2 (right) -> node 1 (left): depth 3 in 4 leaves
    chain = tree_from_arrays({
        "num_leaves": 4, "split_feature": [0, 1, 2],
        "left_child": [-1, -3, 1], "right_child": [2, -4, -2],
        "leaf_value": [1.0, 2.0, 3.0, 4.0]})
    assert ttraverse.tree_depth(chain) == 3


@pytest.fixture(scope="module")
def engine_runs():
    """Both packages' engine.train with early stopping on a split of the
    parity data (a weighted validation set, the training set among the
    valid sets, a feval), with their log lines."""
    x = pd.make_features()
    y, _, _ = pd.make_labels(x)
    w = np.random.default_rng(pd.SEED + 21).uniform(0.5, 2.0, 600)
    params = {**BASE, "num_leaves": 31, "learning_rate": 0.5,
              "min_data_in_leaf": 5, "metric": ["binary_logloss", "auc"]}

    def feval(preds, data):
        label = np.asarray(data.label if data.label is not None
                           else data.get_label(), np.float64)
        return "mean_abs_err", float(np.mean(np.abs(preds - label))), False

    out = {}
    for name, lgb, cb_mod, extra in (
            ("jax", jlgb, jcallback, {"device_growth": "on"}),
            ("torch", tlgb, tcallback, {"device": "cpu"})):
        lines = []
        real = cb_mod.log_info
        cb_mod.log_info = lines.append
        try:
            train = lgb.Dataset(x[:1400], y[:1400])
            valid = train.create_valid(x[1400:], y[1400:], weight=w)
            evals = {}
            booster = lgb.train({**params, **extra}, train, 50,
                                valid_sets=[train, valid],
                                valid_names=["train", "valid"],
                                feval=feval, early_stopping_rounds=5,
                                evals_result=evals, verbose_eval=True)
        finally:
            cb_mod.log_info = real
        out[name] = dict(booster=booster, evals=evals, lines=lines)
    return out


def test_early_stopping_picks_the_same_iteration(engine_runs):
    j, t = engine_runs["jax"], engine_runs["torch"]
    assert t["booster"].best_iteration == j["booster"].best_iteration
    best = t["booster"].best_iteration
    assert 3 < best < 40
    # stopped early: 5 iterations past the best one were evaluated
    assert len(t["evals"]["valid"]["auc"]) == best + 5
    assert {k: dict(v) for k, v in t["booster"].best_score.items()}.keys() \
        == {"train", "valid"}
    for data in ("train", "valid"):
        for metric, value in j["booster"].best_score[data].items():
            assert abs(t["booster"].best_score[data][metric] - value) < 2e-3


def test_evals_result_matches_jax(engine_runs):
    j, t = engine_runs["jax"]["evals"], engine_runs["torch"]["evals"]
    assert list(t) == list(j) == ["train", "valid"]
    for data in t:
        assert list(t[data]) == list(j[data]) == [
            "binary_logloss", "auc", "mean_abs_err"]
        for metric in t[data]:
            a, b = np.asarray(t[data][metric]), np.asarray(j[data][metric])
            assert a.shape == b.shape
            np.testing.assert_allclose(a[:3], b[:3], rtol=0, atol=1e-4)
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


def test_log_lines_in_the_jax_format(engine_runs):
    """print_evaluation and early stopping log the same lines: the
    first 3 iterations' digit for digit, the rest with the same words."""
    j, t = engine_runs["jax"]["lines"], engine_runs["torch"]["lines"]
    assert len(t) == len(j) > 5
    assert t[0].startswith("[1]\ttrain's binary_logloss: ")
    assert t[1] == ("Training until validation scores don't improve for 5 "
                    "rounds.")
    assert t[:4] == j[:4]
    number = re.compile(r"[-+0-9.e]+")
    assert [number.sub("#", s) for s in t] == [number.sub("#", s) for s in j]
    assert t[-1].startswith("Early stopping, best iteration is:\n")


def test_valid_scores_follow_predict():
    """A valid set's device scores equal Booster.predict's raw scores of
    its rows plus its init_score; a set added after two iterations takes
    only the later trees; its metrics read its own labels and weights."""
    x = pd.make_features()
    y, _, _ = pd.make_labels(x)
    params = {**BASE, "device": "cpu"}
    train = tlgb.Dataset(x[:1500], y[:1500])
    init = np.linspace(-0.5, 0.5, 500)
    valid = train.create_valid(x[1500:], y[1500:], init_score=init)
    booster = tlgb.Booster(params, train)
    booster.add_valid(valid, "v")
    for _ in range(2):
        booster.update()
    late = train.create_valid(x[1500:], y[1500:])
    booster.add_valid(late, "late")
    for _ in range(3):
        booster.update()
    records = booster.eval_valid()
    assert [(r[0], r[1]) for r in records] == [("v", "binary_logloss"),
                                              ("late", "binary_logloss")]
    vs = booster._gbdt.valid_sets
    raw = booster.predict(x[1500:], raw_score=True)
    np.testing.assert_allclose(vs[0].score[0].double().numpy(), raw + init,
                               atol=1e-5)
    raw_late = raw - booster.predict(x[1500:], raw_score=True,
                                     num_iteration=2)
    np.testing.assert_allclose(vs[1].score[0].double().numpy(), raw_late,
                               atol=1e-5)
    assert booster.current_iteration() == 5


def test_add_valid_checks_and_stump_constant():
    x = pd.make_features()
    y, _, _ = pd.make_labels(x)
    params = {**BASE, "device": "cpu"}
    train = tlgb.Dataset(x[:1500], y[:1500])
    booster = tlgb.Booster(params, train)
    # bins of its own (another max_bin): not aligned with the training set
    alien = tlgb.Dataset(x[1500:], y[1500:], params={"max_bin": 15})
    with pytest.raises(LightGBMError, match="different bin mappers"):
        booster.add_valid(alien, "alien")
    short = train.create_valid(x[1500:], y[1500:], init_score=np.zeros(3))
    with pytest.raises(LightGBMError,
                       match="Initial score size doesn't match"):
        booster.add_valid(short, "short")
    # one-class labels: the model is one stump, its constant on the set
    ones = tlgb.Dataset(x[:1500], np.ones(1500))
    b1 = tlgb.Booster(params, ones)
    b1.add_valid(ones.create_valid(x[1500:], np.ones(500)), "v")
    assert b1.update()
    b1.eval_valid()
    score = b1._gbdt.valid_sets[0].score[0]
    assert b1.num_trees() == 1 and b1._gbdt.models[0].num_leaves == 1
    assert torch.equal(score, torch.full_like(
        score, b1._gbdt.models[0].leaf_value[0]))


def test_refused_by_name():
    x = pd.make_features()[:300]
    y, _, _ = pd.make_labels(pd.make_features())
    train = tlgb.Dataset(x, y[:300])
    params = {**BASE, "device": "cpu"}
    for kw in ({"init_model": "m.txt"}, {"learning_rates": [0.1] * 3}):
        name = next(iter(kw))
        with pytest.raises(LightGBMError, match=f"train\\({name}="):
            tlgb.train(params, train, 3, **kw)
    with pytest.raises(LightGBMError, match="cv is not ported"):
        tlgb.cv(params, train)
    with pytest.raises(LightGBMError, match="reset_parameter"):
        tcallback.reset_parameter(learning_rate=[0.1] * 3)
    with pytest.raises(ValueError, match="at least one dataset"):
        tlgb.train(params, train, 3, early_stopping_rounds=2,
                   verbose_eval=False)


def _scripted_envs(cb_mod, metric_freq, rounds=12):
    """CallbackEnvs of a run whose first metric stops improving after
    iteration 4 and second after 7, evaluated every ``metric_freq``
    iterations and on the last."""
    for i in range(rounds):
        evaluated = (i + 1) % metric_freq == 0 or i == rounds - 1
        results = [("valid_0", "binary_logloss", 0.5 - 0.01 * min(i, 4),
                    False),
                   ("valid_0", "auc", 0.7 + 0.01 * min(i, 7), True)]
        yield cb_mod.CallbackEnv(
            model=None, params={"metric_freq": metric_freq}, iteration=i,
            begin_iteration=0, end_iteration=rounds,
            evaluation_result_list=results if evaluated else [])


@pytest.mark.parametrize("first_metric_only", [False, True])
@pytest.mark.parametrize("metric_freq", [1, 2])
def test_callbacks_match_jax_on_a_scripted_run(first_metric_only,
                                               metric_freq):
    """early_stopping (first_metric_only, the metric_freq deferral),
    record_evaluation and print_evaluation act as the JAX package's on
    the same sequence of evaluations."""
    out = {}
    for name, cb_mod in (("jax", jcallback), ("torch", tcallback)):
        lines, evals = [], {}
        real = cb_mod.log_info
        cb_mod.log_info = lines.append
        stop = None
        try:
            cbs = [cb_mod.print_evaluation(2),
                   cb_mod.record_evaluation(evals),
                   cb_mod.early_stopping(3, first_metric_only)]
            for env in _scripted_envs(cb_mod, metric_freq):
                try:
                    for cb in cbs:
                        cb(env)
                except cb_mod.EarlyStopException as es:
                    stop = (env.iteration, es.best_iteration,
                            es.best_score)
                    break
        finally:
            cb_mod.log_info = real
        out[name] = (lines, evals, stop)
    assert out["torch"] == out["jax"]
    assert out["torch"][2] is not None


def test_user_callbacks_run_once_in_order():
    """A callback given twice runs once an iteration; callbacks run by
    their ``order``, equal orders in the order given."""
    x = pd.make_features()[:400]
    y = pd.make_labels(pd.make_features())[0][:400]
    calls = []

    def make(tag, order):
        def cb(env):
            calls.append((env.iteration, tag))
        cb.order = order
        return cb
    late, first, second = make("late", 50), make("a", 5), make("b", 5)
    tlgb.train({**BASE, "device": "cpu"}, tlgb.Dataset(x, y), 2,
               callbacks=[late, first, late, second], verbose_eval=False)
    assert calls == [(0, "a"), (0, "b"), (0, "late"),
                     (1, "a"), (1, "b"), (1, "late")]


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
