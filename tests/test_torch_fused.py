"""Fused chunked training in the port (``GBDT.train_chunked``,
``DeviceGrower.fused_train``, ``engine.train``'s fused driving), on the
CPU, where a tree's pieces run in the plain Python loop.

Against the port itself: a chunk of trees trains the same model as the
per-iteration path bit for bit (the fields of
``tests/conftest.py::assert_models_bit_identical`` plus ``train_score``),
with bagging, feature_fraction, the fork harness's config and
``grad_quant_bits=8``; a remainder shorter than the chunk runs
per-iteration; ineligible configurations do not fuse; a stump stall stops
and trims; ``update()`` after a chunk continues bit-identically.

Against the JAX package (``tests/test_fused.py``'s cases, synthetic data
only): its ``GBDT.train_chunked`` grows the same trees (structure equal,
leaf values within the 1e-5 of tests/test_torch_train.py); the int8
first tree of a fused chunk has the JAX package's text byte for byte
(op by op); ``engine.train`` with ``metric_freq=3``, valid sets and
``record_evaluation`` gives the same ``evals_result``, ``best_iteration``
and log lines as the per-iteration loop and the JAX package.
"""

import jax
import numpy as np
import pytest
import torch
from conftest import train_device_booster

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import callback as jcallback
from lightgbm_tpu_torch import callback as tcallback
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import BinnedDataset

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "max_bin": 63, "verbose": -1}
#: the fork harness's sampling knobs (src/capi/smoke_test.cpp:27-31)
HARNESS = {"feature_fraction": 0.8, "bagging_freq": 5,
           "bagging_fraction": 0.8}


def _binary_data(rows=3000, cols=10, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    logit = x[:, 0] + np.abs(x[:, 1]) - 0.5 * x[:, 2]
    y = (rng.random(rows) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return x, y


def _train(params, x, y, n_iters, chunk=0):
    """The port's GBDT on the CPU: ``chunk`` > 0 through train_chunked,
    else one train_one_iter a tree."""
    cfg = Config({**BASE, **params, "device": "cpu"})
    ds = BinnedDataset.construct_from_matrix(np.asarray(x, np.float64), cfg)
    ds.metadata.set_label(y)
    gb = GBDT(cfg)
    gb.init_train(ds)
    if chunk:
        gb.train_chunked(n_iters, chunk=chunk)
    else:
        for _ in range(n_iters):
            if gb.train_one_iter():
                break
    gb._flush_pending()
    return gb


def _assert_bit_identical(a, b):
    a._flush_pending()
    b._flush_pending()
    assert len(a.models) == len(b.models)
    for i, (ta, tb) in enumerate(zip(a.models, b.models)):
        assert ta.num_leaves == tb.num_leaves, f"tree {i}"
        nl = ta.num_leaves
        np.testing.assert_array_equal(ta.split_feature[:nl - 1],
                                      tb.split_feature[:nl - 1])
        np.testing.assert_array_equal(ta.threshold[:nl - 1],
                                      tb.threshold[:nl - 1])
        np.testing.assert_array_equal(ta.leaf_value[:nl],
                                      tb.leaf_value[:nl])
    assert torch.equal(a.train_score, b.train_score)
    assert a.model_to_string() == b.model_to_string()


CASES = {
    "binary": {},
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 2,
                "bagging_seed": 11},
    "feature_fraction": {"feature_fraction": 0.6,
                         "feature_fraction_seed": 7},
    "harness": HARNESS,
    "int8": {"grad_quant_bits": 8, "seed": 3},
}


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_bit_identical_to_per_iteration(name):
    """14 iterations as chunks of 4 (redraw boundaries on and off the
    chunk edges, a remainder of 2) against one tree at a time."""
    x, y = _binary_data()
    a = _train(CASES[name], x, y, 14)
    b = _train(CASES[name], x, y, 14, chunk=4)
    _assert_bit_identical(a, b)
    assert [s[1] for s in b.tree_stats] == [4, 4, 4, 1, 1]


def test_chunk_remainder_takes_the_per_iteration_path():
    """10 = 2 chunks of 4 + 2 single trees; the lagged stall check reads
    the previous chunk (one host sync, none for the first chunk), a single
    tree reads its own leaf count."""
    x, y = _binary_data(rows=1500)
    gb = _train({}, x, y, 10, chunk=4)
    stats = gb.tree_stats
    assert [s[1] for s in stats] == [4, 4, 1, 1]
    assert [s[3] for s in stats] == [0, 1, 1, 1]
    assert all(s[2] >= s[1] for s in stats)
    assert gb.iter == 10 and len(gb.models) == 10
    _assert_bit_identical(_train({}, x, y, 10), gb)


def test_one_class_labels_are_not_eligible():
    """Labels of one class leave nothing to train: no fusing, and
    train_chunked stops with the class's constant stump."""
    x, _ = _binary_data(rows=800)
    y = np.ones(len(x), np.float32)
    gb = _train({}, x, y, 0)
    assert not gb.fused_eligible()
    assert gb.train_chunked(6, chunk=3)
    assert len(gb.models) == 1 and gb.models[0].num_leaves == 1
    assert gb.tree_stats == []


def test_stump_stall_stops_and_trims_as_the_jax_package():
    """No split can clear min_sum_hessian_in_leaf: every tree is a stump,
    the lagged check on the first chunk stops training in the second, and
    the trailing stumps are trimmed to the one carrying the bias, as the
    JAX package's train_chunked does and as the per-iteration path
    stops."""
    x, y = _binary_data(rows=800)
    params = {"min_sum_hessian_in_leaf": 1e9}
    gb = _train(params, x, y, 12, chunk=4)
    assert gb._device_stop
    assert len(gb.models) == 1 and gb.iter == 1
    assert gb.models[0].num_leaves == 1
    jb = train_device_booster({**BASE, "device_growth": "on", **params},
                              x, y, 12, chunk=4)
    assert len(jb.models) == 1
    np.testing.assert_allclose(gb.models[0].leaf_value[0],
                               jb.models[0].leaf_value[0], rtol=1e-6)
    _assert_bit_identical(_train(params, x, y, 12), gb)


def test_update_after_a_chunk_continues_bit_identically():
    """Booster.update_chunked then Booster.update (bagging every 2 rounds:
    the update needs the mask of the last round the chunk drew) against
    nine single updates."""
    x, y = _binary_data(rows=2000)
    params = {**BASE, **CASES["bagging"], "device": "cpu"}
    a = tlgb.Booster(params, tlgb.Dataset(x, y))
    for _ in range(9):
        a.update()
    b = tlgb.Booster(params, tlgb.Dataset(x, y))
    b.update_chunked(7, chunk=7)
    assert [s[1] for s in b._gbdt.tree_stats] == [7]
    b.update()
    b.update()
    _assert_bit_identical(a._gbdt, b._gbdt)


@pytest.mark.parametrize("name", ["binary", "harness"])
def test_chunked_matches_jax_train_chunked(name):
    """The JAX package's GBDT.train_chunked on the same data and params:
    the same tree structures, leaf values within 1e-5, scores within
    1e-4 (f32 histogram sums in another order)."""
    x, y = _binary_data()
    params = CASES[name]
    gb = _train(params, x, y, 8, chunk=4)
    jb = train_device_booster({**BASE, "device_growth": "on", **params},
                              x, y, 8, chunk=4)
    assert len(gb.models) == len(jb.models) == 8
    for i, (tt, jt) in enumerate(zip(gb.models, jb.models)):
        assert tt.num_leaves == jt.num_leaves, f"tree {i}"
        nl = tt.num_leaves
        for field in ("split_feature", "threshold_in_bin", "left_child",
                      "right_child"):
            np.testing.assert_array_equal(
                getattr(tt, field)[:nl - 1],
                np.asarray(getattr(jt, field))[:nl - 1])
        np.testing.assert_allclose(tt.leaf_value[:nl],
                                   np.asarray(jt.leaf_value)[:nl],
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gb.train_score.numpy(),
                               np.asarray(jb.train_score), atol=1e-4)


def test_int8_fused_first_tree_text_byte_equal_to_jax_op_by_op():
    """grad_quant_bits=8: the first tree of a fused chunk of 2 (the
    quantization keys from the chunk's key table) has the text of the
    JAX package's first tree evaluated op by op, byte for byte."""
    x, y = _binary_data(rows=1200)
    params = {**BASE, "grad_quant_bits": 8, "seed": 3}
    with jax.disable_jit():
        jb = jlgb.train({**params, "device_growth": "on",
                         "hist_kernel": "einsum"}, jlgb.Dataset(x, y),
                        num_boost_round=1, verbose_eval=False)
    tb = tlgb.train({**params, "device": "cpu"}, tlgb.Dataset(x, y),
                    num_boost_round=2)
    assert [s[1] for s in tb._gbdt.tree_stats] == [2]
    want = jb.model_to_string().split("Tree=0\n")[1]
    got = tb.model_to_string().split("Tree=0\n")[1]
    assert got.split("\n\n")[0] == want.split("\n\n")[0]


def _engine(lgb, cb_mod, params, x, y, callbacks=None):
    lines = []
    real = cb_mod.log_info
    cb_mod.log_info = lines.append
    try:
        train = lgb.Dataset(x[:2400], y[:2400])
        valid = train.create_valid(x[2400:], y[2400:])
        evals = {}
        booster = lgb.train(params, train, 40, valid_sets=[valid],
                            early_stopping_rounds=4, evals_result=evals,
                            verbose_eval=True, callbacks=callbacks)
    finally:
        cb_mod.log_info = real
    return booster, evals, lines


def test_engine_fused_driving_keeps_the_eval_cadence():
    """engine.train with metric_freq=3, a valid set, early stopping and
    record_evaluation fuses the stretches between evaluations (chunks of
    3 trees) and gives the per-iteration loop's evals_result,
    best_iteration and log lines exactly (an opaque callback forces that
    loop), and the JAX package's best_iteration, evals_result within 1e-4
    and log lines in its words."""
    x, y = _binary_data()
    params = {**BASE, "learning_rate": 0.3, "metric_freq": 3,
              "metric": ["binary_logloss", "auc"], "device": "cpu"}
    fused, ev_f, lines_f = _engine(tlgb, tcallback, params, x, y)
    seen = []
    plain, ev_p, lines_p = _engine(tlgb, tcallback, params, x, y,
                                   callbacks=[seen.append])
    assert {s[1] for s in fused._gbdt.tree_stats} == {3}
    assert {s[1] for s in plain._gbdt.tree_stats} == {1}
    assert len(seen) == plain.current_iteration()
    assert fused.best_iteration == plain.best_iteration > 0
    assert ev_f == ev_p
    assert lines_f == lines_p
    assert fused.model_to_string() == plain.model_to_string()
    jparams = {k: v for k, v in params.items() if k != "device"}
    jb, ev_j, lines_j = _engine(jlgb, jcallback,
                                {**jparams, "device_growth": "on"}, x, y)
    assert jb.best_iteration == fused.best_iteration
    assert ev_j.keys() == ev_f.keys()
    for metric, vals in ev_f["valid_0"].items():
        np.testing.assert_allclose(vals, ev_j["valid_0"][metric],
                                   rtol=1e-4)
    assert [ln.split(":")[0] for ln in lines_j] \
        == [ln.split(":")[0] for ln in lines_f]


def test_engine_opaque_callback_or_fused_chunk_1_does_not_fuse():
    """A user callback without the eval_cadence_only mark, or
    fused_chunk <= 1, keeps engine.train on the per-iteration loop; with
    neither it fuses the whole run into one chunk."""
    x, y = _binary_data(rows=1200)
    params = {**BASE, "device": "cpu"}
    runs = {
        "fused": tlgb.train(params, tlgb.Dataset(x, y), 6),
        "callback": tlgb.train(params, tlgb.Dataset(x, y), 6,
                               callbacks=[lambda env: None]),
        "chunk1": tlgb.train({**params, "fused_chunk": 1},
                             tlgb.Dataset(x, y), 6),
    }
    assert [s[1] for s in runs["fused"]._gbdt.tree_stats] == [6]
    for name in ("callback", "chunk1"):
        assert [s[1] for s in runs[name]._gbdt.tree_stats] == [1] * 6
    assert runs["fused"].model_to_string() \
        == runs["callback"].model_to_string()


def test_snapshots_are_refused_by_name(tmp_path):
    """``snapshot_freq`` writes a snapshot every 2 iterations (the fused
    chunks are cut at the boundaries); a snapshot whose exact-score
    sidecar is gone is skipped by ``latest_snapshot`` and refused by name
    on resume."""
    from lightgbm_tpu_torch.robust.checkpoint import latest_snapshot
    x, y = _binary_data(rows=600)
    gb = _train({}, x, y, 0)
    path = str(tmp_path / "m.txt")
    gb.train_chunked(4, chunk=2, snapshot_freq=2, snapshot_path=path)
    assert latest_snapshot(path) == path + ".snapshot_iter_4"
    (tmp_path / "m.txt.snapshot_iter_4.state.npz").unlink()
    assert latest_snapshot(path) == path + ".snapshot_iter_2"
    with pytest.raises(Exception, match="no state sidecar"):
        _train({}, x, y, 0).resume_from_checkpoint(
            path + ".snapshot_iter_4")


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
