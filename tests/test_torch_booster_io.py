"""The port's model-output surface against the JAX package's, on the same
trees: JAX-trained models (binary GBDT, K=3 multiclass, DART, whose
leaves were rescaled after growth, and RF, whose text says
``average_output``) rebuilt in the port through
``convert.booster_from_arrays``.

* ``model_to_string(num_iteration, start_iteration)`` byte-equal to the
  JAX package's for every slice, and the whole text to its own slice of
  everything;
* ``dump_model()`` equal as dicts (``Tree.to_json``);
* ``feature_importance`` in "split" and "gain" equal, over all iterations
  and the first few;
* ``feature_name``;
* ``save_model`` -> ``Booster(model_file=)``: the same text back, the
  packed forest's predictions bit-equal to the source model's, the host
  walk's within 1e-12 (the text keeps 17 digits after the point).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu_torch.convert import TREE_FIELDS, booster_from_arrays

# the params that reach both packages' parameter blocks alike
PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1, "device_type": "cpu",
          "device_growth": "on"}
MODELS = {
    "binary": ({}, 8),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, 4),
    "dart": ({"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0,
              "drop_seed": 4}, 6),
    "rf": ({"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.7},
           5),
}
SLICES = [(-1, 0), (3, 0), (-1, 2), (2, 3), (5, 4), (-1, 99), (0, 1)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def x():
    return pd.make_features()


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request, x):
    """(name, params, JAX booster, port booster of the same trees)."""
    y, _, y_mc = pd.make_labels(x)
    extra, rounds = MODELS[request.param]
    params = {**PARAMS, **extra}
    labels = y_mc if request.param == "multiclass" else y
    jb = jlgb.train(params, jlgb.Dataset(x, labels), num_boost_round=rounds,
                    verbose_eval=False)
    g = jb._gbdt
    g._flush_pending()
    trees = []
    for t in g.models:
        arrays = {name: getattr(t, name) for name in TREE_FIELDS}
        arrays.update(num_leaves=t.num_leaves, shrinkage=t.shrinkage)
        if t.num_cat:
            arrays.update(num_cat=t.num_cat, cat_boundaries=t.cat_boundaries,
                          cat_threshold=t.cat_threshold)
        trees.append(arrays)
    tb = booster_from_arrays(
        trees, params, max_feature_idx=g.max_feature_idx,
        feature_names=g.feature_names, objective=g.objective.to_string(),
        num_tree_per_iteration=g.num_model,
        average_output=g.average_output, feature_infos=g.feature_infos)
    return request.param, params, jb, tb


@pytest.mark.parametrize("num_iteration,start_iteration", SLICES)
def test_model_text_slices_byte_equal(pair, num_iteration, start_iteration):
    _, _, jb, tb = pair
    want = jb.model_to_string(num_iteration=num_iteration,
                              start_iteration=start_iteration)
    got = tb.model_to_string(num_iteration=num_iteration,
                             start_iteration=start_iteration)
    assert got == want


def test_whole_text_is_the_unsliced_text(pair):
    name, _, jb, tb = pair
    text = tb.model_to_string()
    assert text == tb._gbdt.model_to_string(0, -1)
    assert text == jb.model_to_string()
    assert ("\naverage_output\n" in text) == (name == "rf")
    n_trees = len(tb._gbdt.models)
    assert text.count("\nTree=") == n_trees


def test_dump_model_equal(pair):
    _, _, jb, tb = pair
    got = tb.dump_model()
    assert got == jb.dump_model()
    assert len(got["tree_info"]) == tb.num_trees()
    first = got["tree_info"][0]["tree_structure"]
    assert "split_feature" in first or "leaf_value" in first


@pytest.mark.parametrize("importance_type", ["split", "gain"])
@pytest.mark.parametrize("iteration", [-1, 2])
def test_feature_importance_equal(pair, importance_type, iteration):
    _, _, jb, tb = pair
    got = tb.feature_importance(importance_type, iteration)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(
        got, jb.feature_importance(importance_type, iteration))


def test_feature_name(pair):
    _, _, jb, tb = pair
    assert tb.feature_name() == jb.feature_name()


def test_save_model_round_trip(pair, x, tmp_path):
    name, params, _, tb = pair
    path = tmp_path / f"{name}.txt"
    assert tb.save_model(str(path), num_iteration=-1) is tb
    text = path.read_text()
    assert text == tb.model_to_string()
    loaded = tlgb.Booster(model_file=str(path), params=params)
    assert loaded.model_to_string() == text
    assert loaded.num_trees() == tb.num_trees()
    np.testing.assert_allclose(loaded.predict(x), tb.predict(x), rtol=1e-12,
                               atol=1e-15)
    # the packed forest reads float32 leaves: bit-equal through the text
    force = {**params, "device_type": "cpu", "device_predict": "force"}
    tb._gbdt.config.device_predict = "force"
    packed = tlgb.Booster(model_file=str(path), params=force)
    np.testing.assert_array_equal(packed.predict(x), tb.predict(x))
    tb._gbdt.config.device_predict = "auto"
    # a slice saved and loaded is the slice
    part = tmp_path / f"{name}_part.txt"
    tb.save_model(str(part), num_iteration=2, start_iteration=1)
    sliced = tlgb.Booster(model_file=str(part))
    assert sliced.current_iteration() == 2
    np.testing.assert_allclose(
        sliced.predict(x, raw_score=True),
        tb.predict(x, raw_score=True, num_iteration=2, start_iteration=1),
        rtol=1e-12, atol=1e-15)
