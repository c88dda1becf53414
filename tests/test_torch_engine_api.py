"""The rest of the training API in the port against the JAX package, on the
parity data (``tests/parity_data.py``), the JAX package on its device
grower (``device_growth: on``) except where a case names the host learner:

* ``tests/test_api.py``'s cases re-pointed at the port: a learning-rate
  schedule seen by a callback, continued training from a model file, ``cv``
  with stratified folds, a Dataset's subset;
* continued training (``init_model``) from a model file the JAX package
  wrote and one the port wrote, and from a ``Booster``: the same trees as
  the JAX package's continued run, the loaded trees first, ``iter`` from 0;
* a learning-rate schedule (``learning_rates``) on both learners: the same
  trees, each tree's shrinkage its scheduled rate;
* ``cv``'s folds byte-equal to the JAX package's (seeded, group-aware,
  the user's), its means and stdv within 1e-6 of the JAX package's;
* ``Booster.reset_parameter``: the learning rate taken on both learners,
  split parameters taken by the host learner with the JAX host learner's
  trees, and refused by name on the device grower (the JAX device grower
  keeps their old values without a word); a grower whose booster was
  refused goes back to the cache under its own key;
* pickling and ``copy.deepcopy`` through the model text;
* ``feature_name`` / ``categorical_feature`` / ``keep_training_booster``
  through ``engine.train``.

"The same trees": equal split features, children, leaf counts and leaf
assignment of every training row (a threshold may differ only on a gain
tie that puts the same rows on each side), leaf values within 1e-5
relative plus 1e-5 of the tree's largest (``tests/test_torch_learner.py``'s
bar).
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu import engine as jengine
from lightgbm_tpu_torch import engine as tengine
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.utils.log import LightGBMError

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 20, "verbose": -1}
SCHEDULE = [0.3, 0.2, 0.15, 0.1]


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
    y, y_reg, _ = pd.make_labels(x)
    return x, y, y_reg


def _jparams(params, growth="on"):
    return {**params, "device_growth": growth}


def _tparams(params, growth="on"):
    return {**params, "device_growth": growth, "device": "cpu"}


def _trees(booster):
    booster._gbdt._flush_pending()
    return booster._gbdt.models


def _assert_same_trees(jb, tb, x, rtol=1e-5):
    jt, tt = _trees(jb), _trees(tb)
    assert len(jt) == len(tt)
    for i, (a, b) in enumerate(zip(jt, tt)):
        n = a.num_leaves
        assert b.num_leaves == n, i
        for name in ("split_feature", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n - 1],
                                          getattr(a, name)[:n - 1],
                                          f"tree {i} {name}")
        np.testing.assert_array_equal(b.leaf_count[:n], a.leaf_count[:n])
        if n > 1:
            np.testing.assert_array_equal(b.predict_leaf(x),
                                          a.predict_leaf(x), f"tree {i}")
        scale = max(float(np.abs(a.leaf_value[:n]).max()), 1e-12)
        np.testing.assert_allclose(b.leaf_value[:n], a.leaf_value[:n],
                                   rtol=rtol, atol=rtol * scale,
                                   err_msg=f"tree {i}")


# ----------------------------------------------------------------------
# tests/test_api.py, re-pointed at the port

def test_train_learning_rates_callback(data):
    x, _, y_reg = data
    lrs = []

    def snoop(env):
        lrs.append(env.params.get("learning_rate"))

    tlgb.train(_tparams({**BASE, "objective": "regression"}),
               tlgb.Dataset(x, label=y_reg), num_boost_round=5,
               learning_rates=lambda it: 0.2 * (0.9 ** it),
               callbacks=[snoop], verbose_eval=False)
    assert lrs == [0.2 * 0.9 ** it for it in range(5)]


def test_train_continue_from_init_model(data, tmp_path):
    x, _, y_reg = data
    p = _tparams({**BASE, "objective": "regression", "metric": "l2",
                  "learning_rate": 0.1})
    xt, yt = x[1500:], y_reg[1500:]
    bst1 = tlgb.train(p, tlgb.Dataset(x[:1500], label=y_reg[:1500],
                                      free_raw_data=False),
                      num_boost_round=10, verbose_eval=False)
    mse1 = float(np.mean((bst1.predict(xt) - yt) ** 2))
    path = str(tmp_path / "m.txt")
    bst1.save_model(path)
    bst2 = tlgb.train(p, tlgb.Dataset(x[:1500], label=y_reg[:1500],
                                      free_raw_data=False),
                      num_boost_round=10, init_model=path,
                      verbose_eval=False)
    assert bst2.current_iteration() == 20
    assert float(np.mean((bst2.predict(xt) - yt) ** 2)) < mse1


def test_cv_returns_means_and_stdv(data):
    x, y, _ = data
    res = tlgb.cv(_tparams({**BASE, "metric": "auc"}),
                  tlgb.Dataset(x, label=y), num_boost_round=5, nfold=3,
                  stratified=True, verbose_eval=False)
    assert len(res["auc-mean"]) == 5
    assert len(res["auc-stdv"]) == 5
    assert res["auc-mean"][-1] > 0.7


def test_dataset_subset_and_reference(data):
    x, y, _ = data
    full = tlgb.Dataset(x, label=y, params={"verbosity": -1}).construct()
    sub = full.subset(np.arange(0, 1200))
    sub.construct()
    assert sub.num_data() == 1200
    np.testing.assert_array_equal(sub.get_label(), y[:1200])
    np.testing.assert_array_equal(sub._handle.binned,
                                  full._handle.binned[:1200])
    late = tlgb.Dataset(x[1200:], label=y[1200:]).set_reference(full)
    assert late.construct()._handle.check_align(full._handle)
    with pytest.raises(LightGBMError, match="after constructed"):
        late.set_reference(full)


# ----------------------------------------------------------------------
# continued training

@pytest.mark.parametrize("writer", ["jax", "torch", "booster"])
def test_continued_training_matches_jax(data, tmp_path, writer):
    x, y, _ = data
    p = {**BASE, "learning_rate": 0.2, "bagging_fraction": 0.8,
         "bagging_freq": 2, "feature_fraction": 0.8}
    path = str(tmp_path / "first.txt")
    if writer == "jax":
        jlgb.train(_jparams(p), jlgb.Dataset(x, y), 4,
                   verbose_eval=False).save_model(path)
        init = path
    else:
        first = tlgb.train(_tparams(p), tlgb.Dataset(x, y), 4,
                           verbose_eval=False)
        first.save_model(path)
        init = first if writer == "booster" else path
    jb = jlgb.train(_jparams(p), jlgb.Dataset(x, y, free_raw_data=False), 4,
                    init_model=path, verbose_eval=False)
    tb = tlgb.train(_tparams(p), tlgb.Dataset(x, y, free_raw_data=False), 4,
                    init_model=init, verbose_eval=False)
    assert tb.current_iteration() == jb.current_iteration() == 8
    # the loaded trees come first, as they were
    head = tlgb.Booster(model_file=path).model_to_string()
    cut = lambda s: s.split("Tree=4")[0].split("tree_sizes=")[1]
    assert cut(tb.model_to_string()).split("\n", 1)[1] == \
        cut(head.replace("end of trees", "Tree=4")).split("\n", 1)[1]
    _assert_same_trees(jb, tb, x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), atol=1e-5)
    # iter restarted at 0: the continued trees drew the first trees' masks
    assert tb._gbdt.iter == 4 and tb._gbdt.num_init_iteration == 4


def test_continued_training_cache_on_equals_off(data, tmp_path):
    """A cached grower the continued booster adopts reads the new init
    score (the score is copied into its buffers every launch)."""
    x, y, _ = data
    path = str(tmp_path / "m.txt")
    tlgb.train(_tparams(BASE), tlgb.Dataset(x, y), 3,
               verbose_eval=False).save_model(path)
    texts = []
    for cache in (True, False):
        b = tlgb.train({**_tparams(BASE), "grower_cache": cache},
                       tlgb.Dataset(x, y, free_raw_data=False), 3,
                       init_model=path, verbose_eval=False)
        texts.append(b.model_to_string().split("\nparameters:\n")[0])
    assert texts[0] == texts[1]


def test_continued_training_needs_the_raw_rows(data, tmp_path):
    x, y, _ = data
    path = str(tmp_path / "m.txt")
    tlgb.train(_tparams(BASE), tlgb.Dataset(x, y), 2,
               verbose_eval=False).save_model(path)
    with pytest.raises(LightGBMError, match="free_raw_data=False"):
        tlgb.train(_tparams(BASE), tlgb.Dataset(x, y), 2, init_model=path,
                   verbose_eval=False)
    with pytest.raises(TypeError, match="init_model"):
        tlgb.train(_tparams(BASE), tlgb.Dataset(x, y, free_raw_data=False),
                   2, init_model=3, verbose_eval=False)


def test_continued_training_from_csr_rows(data, tmp_path):
    import scipy.sparse
    x, y, _ = data
    xs = np.nan_to_num(x)
    path = str(tmp_path / "m.txt")
    tlgb.train(_tparams(BASE), tlgb.Dataset(xs, y), 3,
               verbose_eval=False).save_model(path)
    dense = tlgb.train(_tparams(BASE), tlgb.Dataset(xs, y,
                                                    free_raw_data=False),
                       2, init_model=path, verbose_eval=False)
    sparse = tlgb.train(_tparams(BASE), tlgb.Dataset(
        scipy.sparse.csr_matrix(xs), y, free_raw_data=False), 2,
        init_model=path, verbose_eval=False)
    cut = lambda b: b.model_to_string().split("\nparameters:\n")[0]
    assert cut(sparse) == cut(dense)


# ----------------------------------------------------------------------
# learning-rate schedules

@pytest.mark.parametrize("growth", ["on", "off"])
def test_learning_rate_schedule_matches_jax(data, growth):
    x, y, _ = data
    jb = jlgb.train(_jparams(BASE, growth), jlgb.Dataset(x, y), 4,
                    learning_rates=SCHEDULE, verbose_eval=False)
    tb = tlgb.train(_tparams(BASE, growth), tlgb.Dataset(x, y), 4,
                    learning_rates=SCHEDULE, verbose_eval=False)
    _assert_same_trees(jb, tb, x)
    # tree 0 carries the boost-from-average bias, which sets its
    # shrinkage to 1 (the reference's AddBias)
    assert [t.shrinkage for t in _trees(tb)[1:]] == SCHEDULE[1:]
    # the training scores took each tree at its rate
    np.testing.assert_allclose(tb._gbdt.train_score[0].double().numpy(),
                               tb._gbdt.predict_raw(x)[0], atol=1e-5)
    with pytest.raises(ValueError, match="num_boost_round"):
        tlgb.train(_tparams(BASE, growth), tlgb.Dataset(x, y), 3,
                   learning_rates=SCHEDULE, verbose_eval=False)


def test_reset_learning_rate_between_fused_chunks(data):
    """A learning rate reset between two fused chunks reaches the second
    chunk's trees: the rate is a buffer the captured tree reads, written
    every launch, never a constant of the capture."""
    x, y, _ = data
    b = tlgb.Booster(_tparams({**BASE, "learning_rate": 0.1}),
                     tlgb.Dataset(x, y))
    b.update_chunked(4, chunk=4)
    b.reset_parameter({"learning_rate": 0.05})
    b.update_chunked(4, chunk=4)
    assert b._gbdt.fused_eligible()
    assert [t.shrinkage for t in _trees(b)[1:]] == [0.1] * 3 + [0.05] * 4
    np.testing.assert_allclose(b._gbdt.train_score[0].double().numpy(),
                               b._gbdt.predict_raw(x)[0], atol=1e-5)


# ----------------------------------------------------------------------
# cv

def _fold_indices(engine, ds, **kw):
    return [(np.asarray(a.used_indices), np.asarray(b.used_indices))
            for a, b in engine._make_n_folds(ds, **kw)]


@pytest.mark.parametrize("kind", ["seeded", "unshuffled", "groups",
                                  "user", "splitter", "stratified"])
def test_cv_folds_equal_jax(data, kind):
    x, y, _ = data
    kw = dict(folds=None, nfold=3, params={}, seed=7, stratified=False,
              shuffle=kind != "unshuffled")
    group = None
    if kind == "groups":
        group = np.full(40, 50)
    elif kind == "user":
        rng = np.random.default_rng(3)
        perm = rng.permutation(len(y))
        kw["folds"] = [(perm[:1500], perm[1500:]), (perm[500:], perm[:500])]
    elif kind == "splitter":
        from sklearn.model_selection import KFold
        kw["folds"] = KFold(n_splits=4, shuffle=True, random_state=1)
    elif kind == "stratified":
        kw["stratified"] = True
    jf = _fold_indices(jengine, jlgb.Dataset(x, y, group=group), **kw)
    tf = _fold_indices(tengine, tlgb.Dataset(x, y, group=group), **kw)
    assert len(jf) == len(tf)
    for (ja, jt), (ta, tt) in zip(jf, tf):
        assert ja.tobytes() == ta.tobytes() and jt.tobytes() == tt.tobytes()


def test_cv_means_and_stdv_match_jax(data):
    x, y, _ = data
    kw = dict(num_boost_round=4, nfold=3, stratified=False, seed=5,
              metrics=["auc", "binary_logloss"])
    jr = jlgb.cv(_jparams(BASE), jlgb.Dataset(x, y), **kw)
    tr = tlgb.cv(_tparams(BASE), tlgb.Dataset(x, y), **kw)
    assert sorted(jr) == sorted(tr)
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_cv_early_stopping_and_fpreproc(data):
    x, y, _ = data
    seen = []

    def fpreproc(train, test, params):
        seen.append((train.num_data(), test.num_data()))
        return train, test, {**params, "learning_rate": 0.3}

    kw = dict(num_boost_round=30, nfold=2, stratified=False,
              metrics="binary_logloss", early_stopping_rounds=2)
    jr = jlgb.cv(_jparams(BASE), jlgb.Dataset(x, y), fpreproc=fpreproc,
                 **kw)
    tr = tlgb.cv(_tparams(BASE), tlgb.Dataset(x, y), fpreproc=fpreproc,
                 **kw)
    assert seen[:2] == seen[2:] == [(1000, 1000), (1000, 1000)]
    assert len(tr["binary_logloss-mean"]) == len(jr["binary_logloss-mean"])
    np.testing.assert_allclose(tr["binary_logloss-mean"],
                               jr["binary_logloss-mean"], atol=1e-6)


def test_cv_with_a_schedule_resets_every_fold(data):
    x, y, _ = data
    tr = tlgb.cv(_tparams(BASE), tlgb.Dataset(x, y), num_boost_round=3,
                 nfold=2, stratified=False, metrics="auc",
                 callbacks=[tlgb.reset_parameter(
                     learning_rate=[0.3, 0.2, 0.1])])
    jr = jlgb.cv(_jparams(BASE), jlgb.Dataset(x, y), num_boost_round=3,
                 nfold=2, stratified=False, metrics="auc",
                 callbacks=[jlgb.callback.reset_parameter(
                     learning_rate=[0.3, 0.2, 0.1])])
    np.testing.assert_allclose(tr["auc-mean"], jr["auc-mean"], atol=1e-6)


# ----------------------------------------------------------------------
# reset_parameter

def _two_updates(pkg, params, x, y, reset):
    ds = pkg.Dataset(x, y, params=params) if pkg is jlgb \
        else pkg.Dataset(x, y)
    b = pkg.Booster(params, ds)
    b.update()
    b.reset_parameter(reset)
    b.update()
    return b


@pytest.mark.parametrize("growth,reset", [
    ("on", {"learning_rate": 0.03}),
    ("off", {"learning_rate": 0.03}),
    ("off", {"min_data_in_leaf": 300}),
    ("off", {"lambda_l2": 50.0, "max_depth": 2}),
    ("off", {"feature_fraction": 0.5}),
])
def test_reset_parameter_taken_as_in_jax(data, growth, reset):
    x, y, _ = data
    jb = _two_updates(jlgb, _jparams(BASE, growth), x, y, reset)
    tb = _two_updates(tlgb, _tparams(BASE, growth), x, y, reset)
    _assert_same_trees(jb, tb, x)
    plain = _two_updates(tlgb, _tparams(BASE, growth), x, y, {})
    assert _trees(plain)[1].to_string() != _trees(tb)[1].to_string()
    assert tb._gbdt.config.to_dict().items() >= \
        {k: v for k, v in reset.items()}.items()


@pytest.mark.parametrize("reset", [
    {"min_data_in_leaf": 300}, {"lambda_l2": 50.0},
    {"feature_fraction": 0.5, "learning_rate": 0.05},
    {"num_leaves": 4}, {"bagging_seed": 9}])
def test_reset_parameter_refused_on_the_device_grower(data, reset):
    """The JAX device grower keeps these parameters' old values (its
    tree 2 is byte-equal to a run without the reset); the port refuses
    the reset by name and changes nothing."""
    x, y, _ = data
    b = tlgb.Booster(_tparams(BASE), tlgb.Dataset(x, y))
    b.update()
    before = dict(b.params)
    names = sorted(k for k in reset if k != "learning_rate")
    with pytest.raises(LightGBMError, match=", ".join(names)):
        b.reset_parameter(reset)
    assert b.params == before and b._gbdt.shrinkage_rate == 0.1


def test_refused_reset_keeps_the_grower_key(data):
    """Booster A trains, its reset of a captured parameter is refused, A
    is dropped; B, of A's params, adopts A's grower from the cache and
    grows the trees of a run without the cache."""
    x, y, _ = data
    tgrow.clear_grower_cache()
    a = tlgb.Booster(_tparams(BASE), tlgb.Dataset(x, y))
    a.update_chunked(3, chunk=3)
    with pytest.raises(LightGBMError, match="min_data_in_leaf"):
        a.reset_parameter({"min_data_in_leaf": 300})
    grower = a._gbdt._grower
    del a
    hits = tgrow.GROWER_CACHE_COUNTS["hits"]
    b = tlgb.train(_tparams(BASE), tlgb.Dataset(x, y), 4,
                   verbose_eval=False)
    assert tgrow.GROWER_CACHE_COUNTS["hits"] == hits + 1
    assert b._gbdt._grower is grower
    ref = tlgb.train({**_tparams(BASE), "grower_cache": False},
                     tlgb.Dataset(x, y), 4, verbose_eval=False)
    cut = lambda s: s.split("\nparameters:\n")[0]
    assert cut(b.model_to_string()) == cut(ref.model_to_string())
    tgrow.clear_grower_cache()


# ----------------------------------------------------------------------
# pickling, copies, the rest of train's signature

def test_pickle_and_deepcopy_round_trip(data):
    x, y, _ = data
    b = tlgb.train(_tparams(BASE), tlgb.Dataset(x, y), 4,
                   verbose_eval=False)
    b.best_iteration = 3
    again = pickle.loads(pickle.dumps(b))
    assert again.model_to_string() == b.model_to_string()
    assert again.best_iteration == 3 and again.params == b.params
    np.testing.assert_array_equal(again.predict(x), b.predict(x))
    for c in (copy.deepcopy(b), copy.copy(b)):
        assert c is not b and c.model_to_string() == b.model_to_string()
        np.testing.assert_array_equal(c.predict(x), b.predict(x))
    # a loaded booster pickles through its text too
    loaded = tlgb.Booster(model_str=b.model_to_string(),
                          params={"device": "cpu"})
    assert pickle.loads(pickle.dumps(loaded)).model_to_string() == \
        loaded.model_to_string()


def test_feature_name_categorical_and_keep_training_booster(data):
    xc = pd.make_categorical_features()
    y = pd.make_categorical_labels(xc)
    names = ["c0", "c1", "n0", "n1"]
    jb = jlgb.train(_jparams(BASE), jlgb.Dataset(xc, y), 3,
                    feature_name=names, categorical_feature=["c0", 1],
                    verbose_eval=False)
    tds = tlgb.Dataset(xc, y)
    tb = tlgb.train(_tparams(BASE), tds, 3, feature_name=names,
                    categorical_feature=["c0", 1], verbose_eval=False,
                    keep_training_booster=True)
    assert tb.feature_name() == names == tds.get_feature_name()
    assert tb._train_set is tds
    assert any(t.num_cat > 0 for t in _trees(tb))
    _assert_same_trees(jb, tb, xc)
    dropped = tlgb.train(_tparams(BASE), tlgb.Dataset(xc, y), 1,
                         verbose_eval=False)
    assert dropped._train_set is None
    with pytest.raises(LightGBMError, match="after constructed"):
        tds.set_categorical_feature([2])
