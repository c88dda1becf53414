"""The port's pointwise objectives against the JAX package
(``lightgbm_tpu/objectives/regression.py``, ``xentropy.py``), on the CPU.

* gradients on identical seeded scores, labels and weights: bit for bit
  for L2 (also ``reg_sqrt``), L1, huber, quantile and mape; for fair and
  the formulas with ``exp``/``log1p``/``sigmoid``, whose last bits differ
  between XLA's CPU backend and torch (within 2 ulp), within 2 ulp plus
  twice the JAX package's own float32 error against the float64 formula;
* ``boost_from_score``, ``percentile``, ``weighted_percentile`` and
  ``renew_tree_output`` equal exactly, with the edge cases;
* training on ``parity_data``'s ``y_reg`` (both packages on their device
  growers): regression's first 3 trees structurally equal (leaf values
  within 1e-5), each other trainable objective's first tree, and every
  final training metric within the suite's 2e-3; fused and per-iteration
  training give the same model text for L2;
* the reference's regression model text loads and predicts its committed
  predictions within 1e-6;
* every JAX objective name is ported or refused by name; training the
  leaf-renewing objectives (L1, quantile, mape) on the host learner is
  held to the JAX package in ``tests/test_torch_learner.py``.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu.objectives import _REGISTRY as J_OBJECTIVES
from lightgbm_tpu.objectives import base as jbase
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import BinnedDataset
from lightgbm_tpu_torch.data.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.objectives import NOT_PORTED
from lightgbm_tpu_torch.objectives import _REGISTRY as T_OBJECTIVES
from lightgbm_tpu_torch.objectives import base as tbase
from lightgbm_tpu_torch.objectives import create_objective as tcreate
from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.utils.log import LightGBMError

N = 3000
EXACT = ["regression", "regression_sqrt", "regression_l1", "huber",
         "quantile", "mape"]
ULP2 = ["fair", "poisson", "gamma", "tweedie", "cross_entropy",
        "cross_entropy_lambda"]
FIXTURES = "tests/fixtures"


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


def _labels(name, rng, n):
    if name in ("poisson", "tweedie"):
        return rng.poisson(2.0, n).astype(np.float32)
    if name == "gamma":
        return rng.gamma(2.0, 1.5, n).astype(np.float32)
    if name.startswith("cross_entropy"):
        return rng.random(n).astype(np.float32)
    if name == "mape":
        return (rng.standard_normal(n) * 3).astype(np.float32)
    return (rng.standard_normal(n) * 2 + 1).astype(np.float32)


def _params(name):
    if name == "regression_sqrt":
        return {"objective": "regression", "reg_sqrt": True}
    return {"objective": name, "alpha": 0.7 if name == "quantile" else 0.9,
            "fair_c": 1.3, "tweedie_variance_power": 1.4,
            "poisson_max_delta_step": 0.6}


def _pair(name, label, weights, n):
    """(jax objective, port objective), both initialized on the same
    metadata."""
    params = _params(name)
    jmd, tmd = JMetadata(n), TMetadata(n)
    for md in (jmd, tmd):
        md.set_label(label)
        md.set_weights(weights)
    jo = jcreate(JConfig(params))
    jo.init(jmd, n)
    to = tcreate(TConfig(params))
    to.init(tmd, n, torch.device("cpu"))
    return jo, to


def _ordered(a):
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _max_ulps(a, b):
    return int(np.abs(_ordered(a) - _ordered(b)).max())


def _exact(name, obj, score, label, weights):
    """The gradient formula in float64 on the same f32 inputs."""
    s, y = score.astype(np.float64), label.astype(np.float64)
    w = 1.0 if weights is None else weights.astype(np.float64)
    if name == "fair":
        x, c = s - y, obj.c
        g, h = c * x / (np.abs(x) + c), c * c / (np.abs(x) + c) ** 2
    elif name == "poisson":
        g, h = np.exp(s) - y, np.exp(s + obj.max_delta_step)
    elif name == "gamma":
        e = np.exp(-s)
        g, h = 1.0 - y * e, y * e
    elif name == "tweedie":
        r = obj.rho
        e1, e2 = np.exp((1 - r) * s), np.exp((2 - r) * s)
        g, h = -y * e1 + e2, -y * (1 - r) * e1 + (2 - r) * e2
    elif name == "cross_entropy_lambda" and weights is not None:
        eps = 1e-15
        epf = np.exp(s)
        z = 1.0 - np.exp(-w * np.log1p(epf))
        c = 1.0 / np.maximum(1.0 - z, eps)
        b = c / np.maximum((c - 1.0) ** 2, eps) * (1.0 + w * epf - c)
        return ((1.0 - y / np.maximum(z, eps)) * w / (1.0 + 1.0 / epf),
                w * epf / (1.0 + epf) ** 2 * (1.0 + y * b))
    else:
        z = 1.0 / (1.0 + np.exp(-s))
        g, h = z - y, z * (1.0 - z)
    return g * w, h * w


def test_transcendentals_within_2_ulp():
    """exp, log1p and sigmoid of the same f32 inputs: XLA's CPU backend
    and torch round them within 2 ulp of each other."""
    import jax
    import jax.numpy as jnp
    x = (np.random.default_rng(10).standard_normal(100_000) * 3) \
        .astype(np.float32)
    t = torch.from_numpy(x)
    assert _max_ulps(torch.exp(t), jnp.exp(x)) <= 2
    assert _max_ulps(torch.log1p(t * t), jnp.log1p(x * x)) <= 2
    assert _max_ulps(torch.sigmoid(t), jax.nn.sigmoid(x)) <= 2


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", EXACT + ULP2)
def test_gradients_match_jax(name, weighted):
    """Bit for bit (EXACT); else each gradient differs from the JAX
    package's by at most 2 ulp plus twice the JAX package's own float32
    error against the float64 formula: a transcendental's last-bit
    difference (``test_transcendentals_within_2_ulp``) passes through a
    cancellation (exp(s) - y, z - y) into many ulps of a small result,
    never more than the rounding both packages share."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    label = _labels(name, rng, N)
    weights = rng.uniform(0.2, 2.0, N).astype(np.float32) if weighted \
        else None
    score = (rng.standard_normal(N) * 1.5).astype(np.float32)
    score[:4] = label[:4]             # diff == 0: sign 0, quantile's >= 0
    jo, to = _pair(name, label, weights, N)
    jg, jh = (np.asarray(a).reshape(-1) for a in
              jo.get_gradients(jnp.asarray(score)[None, :]))
    tg, th = (a.numpy() for a in
              to.get_gradients(torch.from_numpy(score)[None, :]))
    assert tg.dtype == th.dtype == np.float32
    if name in EXACT:
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(th, jh)
        return
    for t, j, e in zip((tg, th), (jg, jh),
                       _exact(name, to, score, label, weights)):
        j = j.astype(np.float64)
        ulp = np.spacing(np.abs(e).astype(np.float32)).astype(np.float64)
        bound = 2 * ulp + 2 * np.abs(j - e).max()
        assert (np.abs(t - j) <= bound).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", EXACT + ULP2)
def test_boost_from_score_matches_jax(name, weighted):
    rng = np.random.default_rng(12)
    label = _labels(name, rng, 501)
    weights = rng.uniform(0.0, 2.0, 501).astype(np.float32) if weighted \
        else None
    jo, to = _pair(name, label, weights, 501)
    assert to.boost_from_score(0) == jo.boost_from_score(0)
    assert to.is_constant_hessian == jo.is_constant_hessian
    assert to.is_renew_tree_output == jo.is_renew_tree_output
    x = np.linspace(-3, 3, 7)
    np.testing.assert_array_equal(to.convert_output(x), jo.convert_output(x))
    assert to.to_string() == jo.to_string()


def test_device_grad_only_for_plain_l2():
    rng = np.random.default_rng(13)
    for name in EXACT + ULP2:
        _, to = _pair(name, _labels(name, rng, 50), None, 50)
        fg = to.device_grad()
        assert (fg is not None) == (name in ("regression",
                                             "regression_sqrt")), name


PERCENTILE_CASES = {
    "empty": ([], None, 0.5),
    "one": ([3.5], None, 0.5),
    "pos_below_one": ([1.0, 2.0, 3.0], None, 0.9),
    "pos_at_cnt": ([1.0, 2.0, 3.0], None, 0.0),
    "interpolate": ([4.0, 1.0, 7.0, 2.0, 9.0], None, 0.3),
    "ties": ([2.0, 2.0, 2.0, 5.0], None, 0.5),
    "w_empty": ([], [], 0.5),
    "w_one": ([3.5], [2.0], 0.5),
    "w_zero_weights": ([1.0, 2.0, 3.0], [0.0, 0.0, 0.0], 0.5),
    "w_some_zero": ([1.0, 2.0, 3.0, 4.0], [0.0, 1.0, 0.0, 1.0], 0.5),
    "w_first": ([5.0, 1.0, 3.0], [1.0, 1.0, 1.0], 0.1),
    "w_last_interval": ([1.0, 2.0, 3.0], [1.0, 1.0, 1.0], 0.999),
    "w_interpolate": ([4.0, 1.0, 7.0, 2.0], [0.5, 1.5, 1.0, 2.0], 0.6),
}


@pytest.mark.parametrize("case", list(PERCENTILE_CASES))
def test_percentiles_match_jax(case):
    data, weights, alpha = PERCENTILE_CASES[case]
    data = np.asarray(data, np.float32)
    if weights is None:
        assert tbase.percentile(data, alpha) == jbase.percentile(data, alpha)
    else:
        w = np.asarray(weights, np.float32)
        assert tbase.weighted_percentile(data, w, alpha) \
            == jbase.weighted_percentile(data, w, alpha)


@pytest.mark.parametrize("name", ["regression_l1", "quantile", "mape"])
@pytest.mark.parametrize("rows", [0, 1, 2, 37])
def test_renew_tree_output_matches_jax(name, rows):
    rng = np.random.default_rng(14 + rows)
    jo, to = _pair(name, _labels(name, rng, 64), None, 64)
    res = rng.standard_normal(rows).astype(np.float32)
    w = rng.uniform(0, 1, rows).astype(np.float32)
    for weights in ((None, w) if name != "mape" else (w,)):
        assert to.renew_tree_output(0.0, res, weights) \
            == jo.renew_tree_output(0.0, res, weights)


# ----------------------------------------------------------------------
# training against the JAX package
# ----------------------------------------------------------------------
BASE = {"num_leaves": 31, "max_bin": 63, "learning_rate": 0.1,
        "min_data_in_leaf": 20, "verbose": -1}
TRAINED = ["regression", "huber", "fair", "poisson", "gamma", "tweedie",
           "cross_entropy"]


def _train_labels(name, y):
    if name in ("poisson", "gamma", "tweedie"):
        return np.exp(y / 3.0)
    if name.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-y))
    return y


@pytest.fixture(scope="module")
def parity():
    x = pd.make_features()
    _, y, _ = pd.make_labels(x)
    return x, y


def _trees(booster):
    booster._gbdt._flush_pending()
    return booster._gbdt.models


def _assert_same_tree(jt, tt, x):
    """Structurally equal on the training rows: the same split features,
    decision types and children, every row in the same leaf, the same
    leaf counts, leaf values within 1e-5.  A bin threshold may differ
    only where both thresholds put the same rows on each side: a gain tie
    whose winner the f32 residue of an empty default bin decides (ROADMAP
    §3, "default_left on a gain tie")."""
    assert jt.num_leaves == tt.num_leaves > 2
    n = jt.num_leaves
    for field in ("split_feature", "decision_type", "left_child",
                  "right_child"):
        np.testing.assert_array_equal(getattr(tt, field)[:n - 1],
                                      getattr(jt, field)[:n - 1], field)
    np.testing.assert_array_equal(tt.predict_leaf(x), jt.predict_leaf(x))
    np.testing.assert_array_equal(tt.leaf_count[:n], jt.leaf_count[:n])
    np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", TRAINED)
def test_training_matches_jax(parity, name):
    """10 rounds (regression) or 5: the first 3 trees (regression) or the
    first tree structurally equal, the final training metric within
    2e-3."""
    x, y = parity
    label = _train_labels(name, y)
    rounds, same = (10, 3) if name == "regression" else (5, 1)
    params = {**BASE, "objective": name}
    jb = jlgb.train({**params, "device_growth": "on"},
                    jlgb.Dataset(x, label), num_boost_round=rounds,
                    verbose_eval=False)
    tb = tlgb.train({**params, "device": "cpu"}, tlgb.Dataset(x, label),
                    num_boost_round=rounds)
    jts, tts = _trees(jb), _trees(tb)
    assert len(jts) == len(tts) == rounds
    for i in range(same):
        _assert_same_tree(jts[i], tts[i], x)
    (jn, jv), = [(r[1], r[2]) for r in jb.eval_train()]
    (tn, tv), = [(r[1], r[2]) for r in tb.eval_train()]
    assert jn == tn
    assert abs(tv - jv) < 2e-3, (tv, jv)
    np.testing.assert_allclose(tb.predict(x[:50]), jb.predict(x[:50]),
                               rtol=1e-3, atol=1e-3)


def _gbdt(params, x, y, n_iters, chunk):
    cfg = TConfig({**BASE, **params, "device": "cpu"})
    ds = BinnedDataset.construct_from_matrix(np.asarray(x, np.float64), cfg)
    ds.metadata.set_label(y)
    gb = GBDT(cfg)
    gb.init_train(ds)
    gb.train_chunked(n_iters, chunk=chunk)
    gb._flush_pending()
    return gb


@pytest.mark.parametrize("weighted", [False, True])
def test_l2_fused_equals_per_iteration(parity, weighted):
    """Plain L2 has a device gradient: chunks of 4 train the model the
    per-iteration path trains, bit for bit."""
    x, y = parity
    params = {"objective": "regression"}
    if weighted:
        params["bagging_fraction"] = 0.8
        params["bagging_freq"] = 2
    a = _gbdt(params, x, y, 9, chunk=0)
    b = _gbdt(params, x, y, 9, chunk=4)
    assert b.fused_eligible() and [s[1] for s in b.tree_stats] == [4, 4, 1]
    assert torch.equal(a.train_score, b.train_score)
    assert a.model_to_string() == b.model_to_string()


@pytest.mark.parametrize("name", ["huber", "poisson", "cross_entropy"])
def test_objectives_without_device_grad_do_not_fuse(parity, name):
    x, y = parity
    gb = _gbdt({"objective": name}, x, _train_labels(name, y), 5, chunk=4)
    assert not gb.fused_eligible()
    assert [s[1] for s in gb.tree_stats] == [1] * 5


def test_reference_regression_model_predicts_its_predictions():
    """The reference's model text (trained by the reference on the parity
    features) loads and predicts its committed predictions, as the JAX
    package's tests/test_parity.py holds it."""
    x = pd.make_features()[:pd.PRED_ROWS]
    want = np.loadtxt(f"{FIXTURES}/ref_regression.preds.txt")
    with open(f"{FIXTURES}/ref_regression.model.txt") as fh:
        text = fh.read()
    bst = tlgb.Booster(model_str=text)
    got = bst.predict(x, raw_score=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        got, jlgb.Booster(model_str=text).predict(x, raw_score=True))


def test_every_jax_objective_is_ported_or_refused_by_name():
    for name in J_OBJECTIVES:
        if name in NOT_PORTED:
            with pytest.raises(LightGBMError, match=name):
                tcreate(TConfig({"objective": name, "num_class": 3}))
        else:
            k = {"num_class": 3} if name.startswith("multiclass") else {}
            obj = tcreate(TConfig({"objective": name, **k}))
            assert type(obj).__name__ == J_OBJECTIVES[name].__name__
            assert obj.name == name
    assert set(T_OBJECTIVES) | set(NOT_PORTED) == set(J_OBJECTIVES)


def test_boost_from_average_off_warns_for_percentile_objectives(caplog):
    """The JAX package's warning branch (gbdt.py:436-440), reached here by
    a GBDT whose objective renews."""
    rng = np.random.default_rng(15)
    _, to = _pair("quantile", _labels("quantile", rng, 40), None, 40)
    gb = GBDT(TConfig({"boost_from_average": False}))
    gb.objective, gb.has_init_score = to, False

    class _Ds:
        num_features = 3
    gb.train_set = _Ds
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        assert gb.boost_from_average(0) == 0.0
    assert "Disabling boost_from_average in quantile" in caplog.text


def test_is_constant_hessian_is_carried(parity):
    x, y = parity
    for params, want in (({"objective": "regression"}, True),
                         ({"objective": "regression",
                           "bagging_fraction": 0.5, "bagging_freq": 1},
                          False),
                         ({"objective": "huber"}, False),
                         ({"objective": "fair"}, False)):
        cfg = TConfig({**BASE, **params, "device": "cpu"})
        ds = BinnedDataset.construct_from_matrix(x[:300], cfg)
        ds.metadata.set_label(y[:300])
        gb = GBDT(cfg)
        gb.init_train(ds)
        assert gb.is_constant_hessian is want, params


@pytest.mark.parametrize("name,scale", [("regression", 1e6),
                                        ("regression", 1e30),
                                        ("poisson", 60.0)])
def test_large_gradients_fit_the_fixed_point_scale(name, scale):
    """Large-magnitude L2 gradients (labels ~``scale``) and poisson ones
    (exp of scores up to ``scale``): ``hist_scale_exponents`` keeps every
    int64 sum in range, so the kernel's exact arithmetic
    (``wave_hist_fixed_reference``) agrees with the f32 plain version to
    its summation error, without overflow."""
    rng = np.random.default_rng(16)
    n, g, nb, w = 4096, 3, 16, 3
    if name == "regression":
        label = (rng.standard_normal(n) * scale).astype(np.float32)
        score = np.zeros(n, np.float32)
    else:
        label = rng.poisson(3.0, n).astype(np.float32)
        score = rng.uniform(0, scale, n).astype(np.float32)
    _, to = _pair(name, label, None, n)
    grad, hess = to.get_gradients(torch.from_numpy(score)[None, :])
    ghk = torch.stack([grad, hess, torch.ones(n)], 1).to(torch.bfloat16)
    bins = torch.from_numpy(rng.integers(0, nb, (g, n)).astype(np.uint8))
    leaf = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32))
    pending = torch.tensor([0, 2, 3], dtype=torch.int32)
    exp = hist_cuda.hist_scale_exponents(ghk, n)
    kw = dict(g=g, nb=nb, k=3, w=w)
    fixed = hist_cuda.wave_hist_fixed_reference(bins, leaf, ghk, pending,
                                                exp, **kw)
    plain = hist_cuda.wave_hist_reference(bins, leaf, ghk, pending, **kw)
    mag = hist_cuda.wave_hist_reference(bins, leaf, ghk.abs(), pending,
                                        **kw)
    assert torch.isfinite(fixed).all() and mag.max() > scale
    assert bool(((fixed - plain).abs() <= 1e-5 * mag).all())
