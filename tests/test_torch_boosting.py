"""GOSS, DART and random-forest boosting in the port against the JAX
package, both on their device growers (the JAX package with
``device_growth: on``, the default K=3 stat columns), on the parity
features (``tests/parity_data.py``).

* ``ops/bagging.goss_partition`` bit-equal to the JAX function on the same
  seeded inputs: ties at the threshold, ``num_data < n_pad``, scores
  summed over three classes; ``top_k``/``other_k`` in float32 as the JAX
  package computes them;
* GOSS at learning rate 0.3 for 6 iterations, past its 3-iteration
  warm-up: every tree structurally equal (features, bin thresholds,
  children, leaf counts), leaf values within 1e-5 relative, the last
  iteration's row mask equal to the JAX package's selection, raw
  predictions within 1e-5;
* DART over ``uniform_drop`` x ``xgboost_dart_mode``: the same
  ``drop_index`` every iteration, equal trees, validation scores equal to
  ``predict`` of the validation rows within 1e-5 of max|score|; the stop
  on constant labels, and a stall after a drop, leave the model
  consistent with ``predict``;
* RF in binary and 3-class multiclass: equal trees and predictions,
  ``average_output`` in the text, the text and file round trips,
  ``feval`` receiving the averaged (unconverted) predictions as in the
  JAX package; RF without bagging, an unknown ``boosting``, custom
  gradients and the default device without a card raise;
* none of the three fuses, and ``train_chunked(6, chunk=3)`` equals six
  single updates bit for bit.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu.ops.bagging import goss_partition as jgoss
from lightgbm_tpu_torch.boosting import RF, create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops.bagging import (goss_counts, goss_partition,
                                            goss_row_mask)
from lightgbm_tpu_torch.utils import random as trandom
from lightgbm_tpu_torch.utils.log import LightGBMError

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 20, "verbose": -1}
ROUNDS = 6
N_TRAIN = 1500


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
    y, y_reg, y_mc = pd.make_labels(x)
    return x, y, y_mc


def _trained(params, x, y, rounds=ROUNDS, **kw):
    """(JAX booster, port booster) of ``engine.train`` on the same data."""
    jb = jlgb.train({**params, "device_growth": "on"}, jlgb.Dataset(x, y),
                    num_boost_round=rounds, verbose_eval=False, **kw)
    tb = tlgb.train({**params, "device": "cpu"}, tlgb.Dataset(x, y),
                    num_boost_round=rounds, verbose_eval=False, **kw)
    return jb, tb


def _trees(booster):
    booster._gbdt._flush_pending()
    return booster._gbdt.models


def _assert_tree_equal(jt, tt, rtol=1e-5):
    n = jt.num_leaves
    assert tt.num_leaves == n
    for name in ("split_feature", "threshold_in_bin", "threshold",
                 "decision_type", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:n - 1],
                                      getattr(jt, name)[:n - 1], name)
    np.testing.assert_array_equal(tt.leaf_count[:n], jt.leaf_count[:n])
    np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                               rtol=rtol, atol=1e-9)


# ----------------------------------------------------------------------
# goss_partition against the JAX function

def _goss_inputs(case):
    """(scores (n_pad,) f32 as both packages see them, n_pad, num_data)."""
    rng = np.random.default_rng({"ties": 1, "padded": 2, "multiclass": 3}
                                [case])
    n_pad = 4096
    if case == "ties":
        # 3,000 rows over eight score values: the top_k-th largest is
        # shared by hundreds of rows, all kept
        num_data = 3000
        s = (rng.integers(0, 8, n_pad) / 4.0).astype(np.float32)
    elif case == "padded":
        num_data = 2500
        s = np.abs(rng.standard_normal(n_pad)).astype(np.float32)
    else:
        num_data = 4000
        g = rng.standard_normal((3, n_pad)).astype(np.float32)
        h = rng.random((3, n_pad)).astype(np.float32)
        js = np.asarray(jnp.abs(jnp.asarray(g) * jnp.asarray(h)).sum(axis=0))
        s = (torch.from_numpy(g) * torch.from_numpy(h)).abs().sum(0).numpy()
        np.testing.assert_array_equal(s, js)
    s[num_data:] = 0.0
    return s, n_pad, num_data


@pytest.mark.parametrize("case", ["ties", "padded", "multiclass"])
def test_goss_partition_bit_equal_to_jax(case):
    s, n_pad, num_data = _goss_inputs(case)
    seed, top, other = 17, 0.2, 0.1
    jbuf, jcnt, jmult = jgoss(jax.random.PRNGKey(seed), jnp.asarray(s),
                              n_pad, jnp.asarray(num_data, jnp.int32),
                              jnp.asarray(top, jnp.float32),
                              jnp.asarray(other, jnp.float32))
    key = trandom.PRNGKey(seed)
    buf, cnt, mult = goss_partition(key, torch.from_numpy(s), n_pad,
                                    num_data, top, other)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert int(cnt) == int(jcnt)
    assert mult.dtype == torch.float32
    np.testing.assert_array_equal(mult.numpy(), np.asarray(jmult))
    top_k, other_k = goss_counts(num_data, top, other)
    assert int(cnt) > top_k
    if case == "ties":
        # the threshold's ties are all in: more rows kept than top_k
        thr = np.sort(s[:num_data])[::-1][top_k - 1]
        assert (s[:num_data] >= thr).sum() > top_k
    # the grower's mask and multiplier are the same selection's
    mask, m = goss_row_mask(key, torch.from_numpy(s), n_pad, num_data, top,
                            other)
    want = np.zeros(n_pad, np.float32)
    want[buf.numpy()[:int(cnt)]] = 1.0
    np.testing.assert_array_equal(mask.numpy(), want[:num_data])
    np.testing.assert_array_equal(m.numpy(), mult.numpy()[:num_data])


@pytest.mark.parametrize("n,rate", [(10, 0.7), (2_000_000, 0.2),
                                    (2_000_000, 0.1), (1_234_567, 0.3),
                                    (3, 0.01)])
def test_goss_counts_in_float32(n, rate):
    """top_k and other_k as the JAX package computes them: the float32
    product truncated, at least 1 (10 x 0.7 is 6 in float32, 7 in
    float64)."""
    want = int(jnp.maximum((jnp.asarray(n, jnp.int32).astype(jnp.float32)
                            * jnp.asarray(rate, jnp.float32))
                           .astype(jnp.int32), 1))
    assert goss_counts(n, rate, rate) == (want, want)


# ----------------------------------------------------------------------
# GOSS training

GOSS = {**BASE, "boosting": "goss", "learning_rate": 0.3, "top_rate": 0.2,
        "other_rate": 0.1}


@pytest.fixture(scope="module")
def goss(data):
    x, y, _ = data
    return _trained(GOSS, x, y)


@pytest.mark.parametrize("i", range(ROUNDS))
def test_goss_trees_equal(goss, i):
    jb, tb = goss
    _assert_tree_equal(_trees(jb)[i], _trees(tb)[i])


def test_goss_selection_and_predictions(goss, data):
    """The last iteration sampled (iteration 5 >= the warm-up of 3): the
    port's row mask is the JAX package's selection; predictions agree."""
    x, _, _ = data
    jb, tb = goss
    jg, tg = jb._gbdt, tb._gbdt
    assert jg.bag_buffer is not None and tg.row_mask is not None
    want = np.zeros(len(np.asarray(jg.bag_buffer)), np.float32)
    want[np.asarray(jg.bag_buffer)[:jg.bag_count]] = 1.0
    np.testing.assert_array_equal(tg.row_mask.numpy(), want[:len(x)])
    top_k, other_k = goss_counts(len(x), 0.2, 0.1)
    assert top_k <= int(tg.row_mask.sum()) < len(x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), atol=1e-5)


# ----------------------------------------------------------------------
# DART

DART = {**BASE, "boosting": "dart", "learning_rate": 0.2, "drop_rate": 0.4,
        "skip_drop": 0.2, "max_drop": 3, "drop_seed": 4}
DART_MODES = {"weighted": (False, False), "uniform": (True, False),
              "weighted_xgb": (False, True), "uniform_xgb": (True, True)}


@pytest.fixture(scope="module", params=sorted(DART_MODES))
def dart(request, data):
    """(JAX booster, port booster, drop_index of each iteration of each)
    trained by single updates with a validation set."""
    x, y, _ = data
    uniform, xgb = DART_MODES[request.param]
    params = {**DART, "uniform_drop": uniform, "xgboost_dart_mode": xgb}
    xt, yt, xv, yv = x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:], y[N_TRAIN:]
    # the JAX package's Booster bins its Dataset with the Dataset's own
    # params (the port's merges the Booster's in)
    jd = jlgb.Dataset(xt, yt, params=params)
    jb = jlgb.Booster({**params, "device_growth": "on"}, jd)
    jb.add_valid(jd.create_valid(xv, yv), "v")
    td = tlgb.Dataset(xt, yt)
    tb = tlgb.Booster({**params, "device": "cpu"}, td)
    tb.add_valid(td.create_valid(xv, yv), "v")
    drops = ([], [])
    for _ in range(ROUNDS):
        for b, d in zip((jb, tb), drops):
            assert not b.update()
            d.append(list(b._gbdt.drop_index))
    return jb, tb, drops


def test_dart_drops_trees_and_valid_scores(dart, data):
    x, _, _ = data
    jb, tb, (jdrops, tdrops) = dart
    assert tdrops == jdrops
    assert sum(len(d) for d in tdrops) >= 2        # something was dropped
    for jt, tt in zip(_trees(jb), _trees(tb)):
        _assert_tree_equal(jt, tt)
    jb.eval_valid()
    tb.eval_valid()
    xv = x[N_TRAIN:]
    vscore = tb._gbdt.valid_sets[0].score[0].double().numpy()
    pred = tb.predict(xv, raw_score=True)
    scale = np.abs(pred).max()
    assert np.abs(vscore - pred).max() <= 1e-5 * scale
    np.testing.assert_allclose(
        vscore, np.asarray(jb._gbdt.valid_sets[0].score[0], np.float64),
        atol=1e-5 * scale)
    # the training score is the model's prediction of the training rows
    train = tb._gbdt.train_score[0].double().numpy()
    assert np.abs(train - tb.predict(x[:N_TRAIN], raw_score=True)).max() \
        <= 1e-5 * scale


def test_dart_stop_on_constant_labels(data):
    """Constant labels: nothing to split, the first iteration is a stump
    carrying the label's value, and the port stops there (the reference
    stops at the first stump too): one tree, predicting 2.5, its training
    score.  The JAX package checks for stumps 4 iterations late; its
    stalled iterations still drop the stump and rescale it, so its one
    tree predicts 1.25 (ROADMAP §3)."""
    x, _, _ = data
    y = np.full(len(x), 2.5)
    params = {**DART, "objective": "regression", "skip_drop": 0.0,
              "drop_rate": 1.0}
    jb, tb = _trained(params, x, y, rounds=6)
    assert tb.num_trees() == len(_trees(jb)) == 1
    pred = tb.predict(x, raw_score=True)
    np.testing.assert_array_equal(pred, 2.5)
    np.testing.assert_array_equal(tb._gbdt.train_score[0].numpy(), pred)
    np.testing.assert_array_equal(jb.predict(x, raw_score=True), 1.25)


def test_dart_stall_after_a_drop_restores_the_trees(data):
    """An iteration that drops trees and then grows only stumps stops
    training: the drop is undone, so the model text is the one before the
    iteration and ``predict`` still equals the training score."""
    x, y, _ = data
    params = {**DART, "skip_drop": 0.0, "drop_rate": 1.0, "device": "cpu"}
    b = tlgb.Booster(params, tlgb.Dataset(x, y))
    for _ in range(3):
        assert not b.update()
    trees = b.model_to_string().split("parameters:")[0]
    before = b.predict(x, raw_score=True)
    b._gbdt.config.min_data_in_leaf = 10 ** 9      # nothing can split
    assert b.update()
    assert b._gbdt.drop_index == []
    assert b.model_to_string().split("parameters:")[0] == trees
    pred = b.predict(x, raw_score=True)
    np.testing.assert_array_equal(pred, before)
    train = b._gbdt.train_score[0].double().numpy()
    assert np.abs(train - pred).max() <= 1e-5 * np.abs(pred).max()


def test_dart_early_stopping_warns_through_engine(data, caplog):
    x, y, _ = data
    d = tlgb.Dataset(x[:N_TRAIN], y[:N_TRAIN])
    v = d.create_valid(x[N_TRAIN:], y[N_TRAIN:])
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        b = tlgb.train({**DART, "device": "cpu"}, d, 3, valid_sets=[v],
                       early_stopping_rounds=1, verbose_eval=False)
    assert "Early stopping is not available in dart mode" in caplog.text
    assert b.current_iteration() == 3


# ----------------------------------------------------------------------
# RF

RF_PARAMS = {**BASE, "boosting": "rf", "bagging_freq": 1,
             "bagging_fraction": 0.7, "feature_fraction": 0.8}
RF_CASES = {"binary": {}, "multiclass": {"objective": "multiclass",
                                         "num_class": 3}}


@pytest.fixture(scope="module", params=sorted(RF_CASES))
def rf(request, data):
    """(case, JAX booster, port booster, feval predictions of each)."""
    x, y, y_mc = data
    labels = y_mc if request.param == "multiclass" else y
    params = {**RF_PARAMS, **RF_CASES[request.param]}
    seen = ([], [])

    def feval(into):
        def fn(preds, _dataset):
            into.append(np.array(preds))
            return "zero", 0.0, False
        return fn
    out = []
    for lib, extra, into in ((jlgb, {"device_growth": "on"}, seen[0]),
                             (tlgb, {"device": "cpu"}, seen[1])):
        d = lib.Dataset(x[:N_TRAIN], labels[:N_TRAIN])
        v = d.create_valid(x[N_TRAIN:], labels[N_TRAIN:])
        out.append(lib.train({**params, **extra}, d, 5, valid_sets=[v],
                             feval=feval(into), verbose_eval=False))
    return request.param, out[0], out[1], seen


def test_rf_trees_predictions_and_text(rf, data, tmp_path):
    x, _, _ = data
    case, jb, tb, _ = rf
    assert tb._gbdt.average_output and tb._gbdt.shrinkage_rate == 1.0
    for jt, tt in zip(_trees(jb), _trees(tb)):
        _assert_tree_equal(jt, tt)
    pred = tb.predict(x)
    np.testing.assert_allclose(pred, jb.predict(x), atol=1e-6)
    text = tb.model_to_string()
    assert "\naverage_output\n" in text
    path = tmp_path / f"rf_{case}.txt"
    tb.save_model(str(path))
    loaded = tlgb.Booster(model_file=str(path),
                          params={"device": "cpu", "device_predict": "force"})
    assert loaded._gbdt.average_output
    assert loaded.model_to_string().split("parameters:")[0] \
        == text.split("parameters:")[0]
    # the text keeps 17 digits after the point: the host walk's float64
    # sums move in the last bits, the packed forest's float32 leaves not
    host = tlgb.Booster(model_file=str(path))
    np.testing.assert_allclose(host.predict(x, raw_score=True),
                               tb.predict(x, raw_score=True), rtol=1e-12)
    tb._gbdt.config.device_predict = "force"
    np.testing.assert_array_equal(loaded.predict(x), tb.predict(x))
    tb._gbdt.config.device_predict = "auto"
    # the JAX package reads the port's text, averaging as well
    np.testing.assert_allclose(jlgb.Booster(model_str=text).predict(x), pred,
                               rtol=1e-12)


def test_rf_feval_gets_averaged_predictions(rf):
    """feval sees the validation scores averaged over the iterations and
    not converted, in both packages, every round."""
    case, _, tb, (jseen, tseen) = rf
    assert len(tseen) == len(jseen) == 5
    for a, b in zip(jseen, tseen):
        np.testing.assert_allclose(b, a, atol=1e-6)
    v = tb._gbdt.valid_sets[0].score.double().numpy() / 5
    want = v[0] if v.shape[0] == 1 else v.T.reshape(-1)
    np.testing.assert_allclose(tseen[-1], want, rtol=1e-12)
    if case == "binary":
        # an RF's average of -label leaves is a probability, not a margin
        assert 0.0 <= tseen[-1].min() and tseen[-1].max() <= 1.0


def test_rf_needs_bagging(data):
    x, y, _ = data
    with pytest.raises(ValueError, match="random forest needs bagging"):
        tlgb.train({**BASE, "boosting": "rf", "device": "cpu"},
                   tlgb.Dataset(x, y), 2)
    ds = tlgb.Dataset(x, y, params={"max_bin": 63}).construct()._handle
    cfg = Config({**RF_PARAMS, "device": "cpu"})
    cfg.bagging_freq = 0
    with pytest.raises(LightGBMError, match="RF mode requires bagging"):
        RF(cfg).init_train(ds)


@pytest.mark.parametrize("boosting", ["goss", "dart", "rf"])
def test_default_device_without_a_card_raises(data, boosting):
    """The entry point runs on the card unless asked for the CPU: without
    one, training raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device trains on it")
    x, y, _ = data
    params = {**CHUNKED[boosting]}
    with pytest.raises(LightGBMError, match="is_available"):
        tlgb.train(params, tlgb.Dataset(x, y), 2)


def test_unknown_boosting_raises():
    with pytest.raises(ValueError, match="unknown boosting type"):
        Config({"boosting": "xgboost"})
    cfg = Config({})
    cfg.boosting = "xgboost"
    with pytest.raises(ValueError, match="unknown boosting type: xgboost"):
        create_boosting(cfg)


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_custom_gradients_are_refused(data, boosting):
    x, y, _ = data
    params = {**(RF_PARAMS if boosting == "rf" else BASE), "device": "cpu"}
    b = tlgb.Booster(params, tlgb.Dataset(x, y))
    g = np.zeros(len(x), np.float32)
    match = "RF mode" if boosting == "rf" else "custom gradients"
    with pytest.raises(LightGBMError, match=match):
        b._gbdt.train_one_iter(g, g)


# ----------------------------------------------------------------------
# no fused path: chunked training is single updates

CHUNKED = {"goss": GOSS, "dart": DART, "rf": RF_PARAMS}


@pytest.mark.parametrize("name", sorted(CHUNKED))
def test_chunked_equals_single_updates(data, name):
    x, y, _ = data
    params = {**CHUNKED[name], "device": "cpu", "fused_chunk": 3}
    a = tlgb.Booster(params, tlgb.Dataset(x, y))
    b = tlgb.Booster(params, tlgb.Dataset(x, y))
    assert not a._gbdt.fused_eligible()
    assert type(a._gbdt).__name__ == name.upper()
    assert not a.update_chunked(6, chunk=3)
    for _ in range(6):
        assert not b.update()
    assert a.model_to_string() == b.model_to_string()
    assert torch.equal(a._gbdt.train_score, b._gbdt.train_score)
    assert [s[1] for s in a._gbdt.tree_stats] == [1] * 6
