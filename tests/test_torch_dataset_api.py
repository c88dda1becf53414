"""The port's Dataset and Booster surface that the C ABI calls, against
the JAX package on the same inputs (``parity_data``):

* ``Dataset.subset``: codes, labels, weights and init scores equal to the
  JAX package's ``subset`` (``test_api.py::
  test_dataset_subset_and_reference`` re-pointed);
* the binary dataset file: a file written by either package loads in the
  other with byte-equal codes and fields, and trains the same model;
* the field getters and setters, ``num_data``/``num_feature``, feature
  names;
* ``rollback_one_iter``: the model text of a model trained one round
  fewer, and scores that train on to it;
* TreeSHAP ``pred_contrib``: the batch equal to the per-row recursion
  (``test_api.py::test_pred_contrib_batch_matches_scalar_oracle``
  re-pointed), within 1e-12 of the JAX package's ``_predict_contrib`` on
  the same trees.  Each row's feature contributions sum to the raw score
  minus the trees' expected values within 1e-9, the expected value of a
  tree being the mean of its leaf values over its training rows (the
  TreeSHAP identity).  The last column is, as in the JAX package, the sum
  of the trees' root values, which differs from those means by the
  rounding of the grown values (the JAX suite's 2e-3).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu.data.dataset import BinnedDataset as JBinned
from lightgbm_tpu_torch.data.dataset import BinnedDataset as TBinned
from lightgbm_tpu_torch.tree.tree import tree_shap_batch

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1}
TPARAMS = {**PARAMS, "device": "cpu"}


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


def _fields(md):
    return (md.label, md.weights, md.init_score, md.query_boundaries)


def _assert_fields_equal(a, b):
    for u, v in zip(_fields(a), _fields(b)):
        if u is None or v is None:
            assert u is None and v is None
        else:
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_dataset_subset_and_reference(data):
    x, y, _ = data
    full = tlgb.Dataset(x, label=y, params=TPARAMS).construct()
    sub = full.subset(np.arange(0, 1200))
    sub.construct()
    assert sub.num_data() == 1200
    np.testing.assert_array_equal(sub.get_label(), y[:1200])


def test_subset_equals_jax(data):
    x, y, _ = data
    w = np.linspace(0.5, 1.5, len(y))
    init = np.linspace(-0.1, 0.1, len(y))
    idx = np.random.default_rng(3).choice(len(y), 700, replace=False)
    jfull = jlgb.Dataset(x, label=y, weight=w, init_score=init,
                         params=PARAMS)
    tfull = tlgb.Dataset(x, label=y, weight=w, init_score=init,
                         params=TPARAMS)
    js = jfull.subset(idx).construct()._handle
    ts = tfull.subset(idx).construct()._handle
    np.testing.assert_array_equal(ts.binned, np.asarray(js.binned))
    _assert_fields_equal(ts.metadata, js.metadata)
    assert ts.num_total_features == js.num_total_features
    assert ts.used_features == list(js.used_features)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_binary_file_loads_in_the_other_package(data, tmp_path, writer):
    x, y, _ = data
    qsizes = [500, 700, 800]
    w = np.linspace(0.5, 1.5, len(y)).astype(np.float32)
    path = str(tmp_path / f"{writer}.bin")
    if writer == "jax":
        jlgb.Dataset(x, label=y, weight=w, group=qsizes,
                     params=PARAMS).save_binary(path)
    else:
        tlgb.Dataset(x, label=y, weight=w, group=qsizes,
                     params=TPARAMS).save_binary(path)
    assert TBinned.is_binary_file(path) and JBinned.is_binary_file(path)
    td = TBinned.load_binary(path)
    jd = JBinned.load_binary(path)
    assert isinstance(td.binned, np.ndarray)
    np.testing.assert_array_equal(td.binned, np.asarray(jd.binned))
    _assert_fields_equal(td.metadata, jd.metadata)
    np.testing.assert_array_equal(td.f_offset, jd.f_offset)
    np.testing.assert_array_equal(td.f_default_bin, jd.f_default_bin)
    assert repr([m.to_state() for m in td.bin_mappers]) == \
        repr([m.to_state() for m in jd.bin_mappers])
    # the file trains the model the in-memory set trains
    direct = tlgb.train(TPARAMS, tlgb.Dataset(x, label=y, params=TPARAMS),
                        num_boost_round=3)
    ds = tlgb.Dataset(path, label=y, weight=np.ones(len(y)),
                      params=TPARAMS)
    ds.construct()._handle.metadata.query_boundaries = None
    from_file = tlgb.train(TPARAMS, ds, num_boost_round=3)
    assert from_file.model_to_string() == direct.model_to_string()


def test_field_getters_and_setters(data):
    x, y, y_reg = data
    ds = tlgb.Dataset(x, label=y, params=TPARAMS).construct()
    assert ds.num_data() == len(y) and ds.num_feature() == x.shape[1]
    ds.set_label(y_reg)
    np.testing.assert_array_equal(ds.get_label(), y_reg.astype(np.float32))
    w = np.full(len(y), 2.0)
    ds.set_weight(w)
    np.testing.assert_array_equal(ds.get_weight(), w)
    init = np.full(len(y), 0.25)
    ds.set_init_score(init)
    np.testing.assert_array_equal(ds.get_init_score(), init)
    names = [f"f{i}" for i in range(x.shape[1])]
    ds.set_feature_name(names)
    assert ds._handle.feature_names == names
    with pytest.raises(tlgb.LightGBMError):
        ds.set_feature_name(names[:3])


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_rollback_gives_the_model_one_round_shorter(data, objective):
    x, y, y_reg = data
    label = y if objective == "binary" else y_reg
    params = {**TPARAMS, "objective": objective}

    def booster(rounds):
        b = tlgb.Booster(params, tlgb.Dataset(x, label=label, params=params))
        for _ in range(rounds):
            b.update()
        return b

    short = booster(4)
    long = booster(5)
    long.rollback_one_iter()
    assert long.current_iteration() == 4
    assert long.model_to_string() == short.model_to_string()
    score_short = short._gbdt.train_score.numpy()
    np.testing.assert_allclose(long._gbdt.train_score.numpy(), score_short,
                               rtol=0, atol=1e-5)
    assert long.num_model_per_iteration() == 1
    assert long.set_train_data_name("train") is long


def test_pred_contrib_batch_matches_scalar_oracle():
    rng = np.random.default_rng(0)
    n, f = 400, 8
    x = rng.standard_normal((n, f))
    x[rng.random((n, f)) < 0.1] = np.nan
    y = (np.nan_to_num(x[:, 0]) * 2 + np.abs(np.nan_to_num(x[:, 1]))
         + 0.1 * rng.standard_normal(n))
    bst = tlgb.train({"objective": "regression", "num_leaves": 31,
                      "verbosity": -1, "min_data_in_leaf": 5,
                      "device": "cpu"}, tlgb.Dataset(x, label=y),
                     num_boost_round=8)
    g = bst._gbdt
    g._flush_pending()
    rows = np.ascontiguousarray(x[:48], np.float64)
    nf = g.max_feature_idx + 1
    want = np.zeros((48, nf + 1))
    for tree in g.models:
        for i in range(48):
            tree.predict_contrib_row(rows[i], want[i])
    got = np.zeros((48, nf + 1))
    for tree in g.models:
        tree_shap_batch(tree, rows, got)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    contrib = np.asarray(bst.predict(rows, pred_contrib=True))
    np.testing.assert_allclose(contrib, want, rtol=1e-9, atol=1e-12)
    host_pred = sum(t.predict(rows) for t in g.models)
    np.testing.assert_allclose(contrib.sum(1), host_pred, atol=2e-3)


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_pred_contrib_equals_jax(data, objective):
    x, y, _ = data
    _, _, y_mc = pd.make_labels(x)
    params = {**TPARAMS, "objective": objective}
    label = y
    if objective == "multiclass":
        params["num_class"] = 3
        label = y_mc
    bst = tlgb.train(params, tlgb.Dataset(x, label=label, params=params),
                     num_boost_round=6)
    jbst = jlgb.Booster(model_str=bst.model_to_string())
    rows = x[:300]
    got = bst.predict(rows, pred_contrib=True)
    want = jbst._gbdt._predict_contrib(rows)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    raw = np.asarray(bst.predict(rows, raw_score=True))
    k = bst.num_model_per_iteration()
    g = bst._gbdt
    mean_value = np.zeros(k)
    for i, t in enumerate(g.models):
        n = t.num_leaves
        mean_value[i % k] += (t.leaf_value[:n] @ t.leaf_count[:n]
                              / max(t.leaf_count[:n].sum(), 1)
                              if n > 1 else t.leaf_value[0])
    sums = got.reshape(len(rows), k, -1)[:, :, :-1].sum(axis=2)
    np.testing.assert_allclose(sums + mean_value,
                               raw.reshape(len(rows), k), rtol=0, atol=1e-9)
    first = bst.predict(rows, pred_contrib=True, num_iteration=2)
    np.testing.assert_allclose(
        first, jbst._gbdt._predict_contrib(rows, num_iteration=2),
        rtol=0, atol=1e-12)
