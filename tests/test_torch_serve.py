"""lightgbm_tpu_torch.serve against lightgbm_tpu.serve: the same models and
query rows, made with numpy from a seed, through both packages.

* packs equal field by field (fixture models, models trained by each
  package on NaN- and zero-missing features, random deep forests);
* leaves bit-equal to the JAX package and to the host ``Tree`` walk,
  scores within rtol 1e-5, atol 1e-6 of both (the JAX program sums the
  trees in another order, the host walk in float64);
* the decision edge cases one by one, the iteration slices, stumps and
  empty models, the ``device_predict`` routing, CSR prediction, the
  server, the fleet and the loaded-model output transforms.

On the CPU the kernel wrapper takes its plain version; tests/
test_torch_cuda.py holds the kernel against it on the card.
"""

import copy

import numpy as np
import pytest
import scipy.sparse
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import synthetic_forests as synthetic
from lightgbm_tpu.serve import fleet as jfleet
from lightgbm_tpu.serve import packed as jpacked
from lightgbm_tpu.tree.tree import Tree as JTree
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.serve import fleet, packed
from lightgbm_tpu_torch.serve.engine import PredictionServer
from lightgbm_tpu_torch.tree.tree import Tree

FIXTURES = "tests/fixtures"
CPU = {"device": "cpu", "verbose": -1}


def _text(name):
    with open(f"{FIXTURES}/ref_{name}.model.txt") as fh:
        return fh.read()


def _jax_trees(models):
    """JAX package ``Tree``s with the same arrays as the port's (a model
    text would round thresholds below 1e-17 to 0)."""
    out = []
    for t in models:
        j = JTree(t.max_leaves)
        for k, v in vars(t).items():
            if k in vars(j):
                setattr(j, k, copy.deepcopy(v))
        out.append(j)
    return out


def _train_pair(seed, zero_missing):
    """A binary model trained by each package on the same features: NaN-
    missing, or zero-missing with many exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2000, 6))
    if zero_missing:
        x[rng.random(x.shape) < 0.3] = 0.0
    else:
        x[rng.random(x.shape) < 0.1] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.abs(np.nan_to_num(x[:, 1]))
         > 0.5).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5, "zero_as_missing": zero_missing}
    jb = jlgb.train(params, jlgb.Dataset(x, label=y), num_boost_round=4)
    tb = tlgb.train({**params, **CPU}, tlgb.Dataset(x, y), 4)
    return jb, tb


@pytest.fixture(scope="module")
def trained():
    out = {}
    for name, zero in (("nan", False), ("zero", True)):
        jb, tb = _train_pair(3, zero)
        out[f"jax_{name}"] = jb.model_to_string()
        out[f"port_{name}"] = tb.model_to_string()
    return out


def _model(name, trained):
    return trained[name] if name in trained else _text(name)


def _queries(nf, n, seed, categorical=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nf)) * 2
    if categorical:
        x = np.round(x * 3)
        x[rng.random(x.shape) < 0.05] += 1e-12
    x[rng.random(x.shape) < 0.1] = np.nan
    x[rng.random(x.shape) < 0.1] = 0.0
    return x


def _host_leaves(models, x):
    return np.stack([t.predict_leaf(x) for t in models], axis=1)


def _assert_packs_equal(jpe, tpe):
    for f in packed.ARRAY_FIELDS:
        a = np.asarray(getattr(jpe, f))
        b = getattr(tpe, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (jpe.num_model, jpe.max_depth, jpe.num_trees, jpe.num_features) \
        == (tpe.num_model, tpe.max_depth, tpe.num_trees, tpe.num_features)


MODELS = ["binary", "categorical", "multiclass", "jax_nan", "port_nan",
          "jax_zero", "port_zero"]


@pytest.mark.parametrize("name", MODELS)
def test_pack_equals_jax_field_by_field(name, trained):
    text = _model(name, trained)
    jg = jlgb.Booster(model_str=text)._gbdt
    tg = tlgb.Booster(model_str=text, params=CPU)._gbdt
    _assert_packs_equal(jpacked.pack_gbdt(jg),
                        packed.pack_gbdt(tg, device="cpu"))


@pytest.mark.parametrize("name", MODELS)
def test_leaves_and_scores_against_jax_and_host(name, trained):
    text = _model(name, trained)
    jg = jlgb.Booster(model_str=text)._gbdt
    tg = tlgb.Booster(model_str=text, params=CPU)._gbdt
    x = _queries(tg.max_feature_idx + 1, 400, 1, name == "categorical")
    jpe = jpacked.pack_gbdt(jg)
    tpe = packed.pack_gbdt(tg, device="cpu")
    leaves = packed.predict_leaves(tpe, x)
    np.testing.assert_array_equal(leaves, jpacked.predict_leaves(jpe, x))
    np.testing.assert_array_equal(leaves, _host_leaves(tg.models, x))
    scores = packed.predict_scores(tpe, x)
    np.testing.assert_allclose(scores, jpacked.predict_scores(jpe, x),
                               rtol=1e-5, atol=1e-6)
    tg.config.device_predict = "off"
    np.testing.assert_allclose(scores, tg.predict_raw(x), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("num_model", [1, 3])
def test_random_deep_forest_against_jax_and_host(num_model):
    """Deep paths, every missing type, multi-word bitsets, thresholds past
    float32's range, values on and one ulp beside thresholds: leaves
    bit-equal to the JAX package.  With float32-denormal thresholds and
    values too (the JAX package's CPU program flushes those to zero, see
    test_route_left_edge_cases), leaves bit-equal to the host walk on
    rows away from thresholds."""
    cats = (1, 4)
    kw = dict(num_iterations=6, num_leaves=40, num_features=7,
              cat_features=cats, num_model=num_model)
    g = synthetic.random_forest(5, denormals=False, **kw)
    jm = _jax_trees(g.models)
    jpe = jpacked.pack_ensemble(jm, num_model, num_features=7)
    tpe = packed.pack_gbdt(g, device="cpu")
    _assert_packs_equal(jpe, tpe)
    assert tpe.max_depth >= 16
    x = synthetic.query_rows(g, 600, 2, cat_features=cats, denormals=False)
    leaves = packed.predict_leaves(tpe, x)
    np.testing.assert_array_equal(leaves, jpacked.predict_leaves(jpe, x))
    np.testing.assert_allclose(packed.predict_scores(tpe, x),
                               jpacked.predict_scores(jpe, x), rtol=1e-5,
                               atol=1e-6)
    g = synthetic.random_forest(6, **kw)
    tpe = packed.pack_gbdt(g, device="cpu")
    x = synthetic.query_rows(g, 600, 3, near=False, cat_features=cats)
    np.testing.assert_array_equal(packed.predict_leaves(tpe, x),
                                  _host_leaves(g.models, x))
    g.config.device_predict = "off"
    np.testing.assert_allclose(packed.predict_scores(tpe, x),
                               g.predict_raw(x), rtol=1e-5, atol=1e-6)


def _edge_cases():
    """(decision_type, threshold, value, bitset words) rows."""
    f32_max = float(np.finfo(np.float32).max)
    rows = []
    for t in (0.0, 1.0, 0.1, 1.2030428526077912, -2.5, 1e-40, -1e-40,
              1e-310, 1e30, 1e300, -1e300, f32_max):
        vals = [t, np.nextafter(t, np.inf), np.nextafter(t, -np.inf),
                np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-40, 1e-310, 1.0]
        for missing in range(3):
            for dl in (0, 2):
                rows += [(dl | missing << 2, t, v, ()) for v in vals]
    words = (0b1010_0101, 0x8000_0001)        # cats 0, 2, 5, 7, 32, 63
    for missing in (0, 1, 2):
        for v in (-1.0, 0.0, -0.0, 2.0, 3.0, 5.0, 5 - 1e-12, 5 + 1e-12,
                  6 - 1e-12, 33 - 1e-12, 32.0, 63.0, 63.9, 64.0, 2.0 ** 31,
                  -2.0 ** 31, 1e300, np.nan, np.inf, -np.inf, -0.5, 1e-40):
            rows.append((1 | missing << 2, 0.0, v, words))
    return rows


def test_route_left_edge_cases():
    """Each decision edge case: the port's route_left equals the JAX
    package's bit for bit, except where a float32 denormal is involved
    (the JAX package's CPU program flushes those to zero; the port keeps
    them, as numpy does); and equals the host walk's float64 decision
    wherever the hi/lo pairs hold the value and the threshold exactly."""
    import jax.numpy as jnp
    rows = _edge_cases()
    dt = np.asarray([r[0] for r in rows], np.int32)
    t = np.asarray([r[1] for r in rows])
    v = np.asarray([r[2] for r in rows])
    thi, tlo = packed.split_hi_lo(t)
    vhi, vlo = packed.split_hi_lo(v)
    words = np.zeros((len(rows), 2), np.uint32)
    clen = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        words[i, :len(r[3])] = r[3]
        clen[i] = len(r[3])
    port = packed.route_left(
        torch.from_numpy(dt), torch.from_numpy(thi), torch.from_numpy(tlo),
        torch.from_numpy(clen),
        lambda w: torch.from_numpy(words.astype(np.int64))[
            torch.arange(len(rows)), w],
        torch.from_numpy(vhi), torch.from_numpy(vlo)).numpy()
    jx = np.asarray(jpacked.route_left(
        jnp.asarray(dt), jnp.asarray(thi), jnp.asarray(tlo),
        jnp.asarray(clen),
        lambda w: jnp.asarray(words)[jnp.arange(len(rows)), w],
        jnp.asarray(vhi), jnp.asarray(vlo)))
    tiny = np.float32(np.finfo(np.float32).tiny)
    denormal = ((np.abs(thi) < tiny) & (thi != 0)) \
        | ((np.abs(vhi) < tiny) & (vhi != 0))
    np.testing.assert_array_equal(port[~denormal], jx[~denormal])
    # the host walk's decision, one single-node tree a row
    host = np.zeros(len(rows), bool)
    for i, r in enumerate(rows):
        if r[0] & 1 and np.isinf(r[2]):
            continue
        tree = Tree(2)
        tree.num_leaves = 2
        tree.decision_type[0] = r[0]
        if r[0] & 1:
            tree.num_cat = 1
            tree.cat_boundaries = [0, len(r[3])]
            tree.cat_threshold = list(r[3])
        else:
            tree.threshold[0] = r[1]
        host[i] = tree._decision_matrix(np.zeros(1, np.int32),
                                        np.asarray([r[2]]))[0]
    # the pairs decide as float64 does when both split exactly, when the
    # hi parts differ (f32 rounding keeps the order), or when v == t
    with np.errstate(invalid="ignore"):
        exact = np.isfinite(thi) & (np.isfinite(vhi) | np.isnan(vhi)) \
            & (thi.astype(np.float64) + tlo == t) \
            & ((vhi.astype(np.float64) + vlo == v) | np.isnan(v))
        exact |= (thi != vhi) & ~np.isnan(vhi)
        exact |= v == t
    # categorical: every finite value (the host walk's int() refuses inf)
    exact |= ((dt & 1) == 1) & ~np.isinf(v)
    assert exact.sum() > 500 and denormal.sum() > 50
    np.testing.assert_array_equal(port[exact], host[exact])


def test_iteration_slices_match_jax():
    text = _text("multiclass")
    jg = jlgb.Booster(model_str=text)._gbdt
    tg = tlgb.Booster(model_str=text, params=CPU)._gbdt
    x = _queries(tg.max_feature_idx + 1, 300, 4)
    for start, num in ((0, -1), (2, 3), (4, -1), (9, 5), (20, 2)):
        jpe = jpacked.pack_gbdt(jg, start, num)
        tpe = packed.pack_gbdt(tg, start, num, device="cpu")
        _assert_packs_equal(jpe, tpe)
        np.testing.assert_array_equal(packed.predict_leaves(tpe, x),
                                      jpacked.predict_leaves(jpe, x))
        for mode in ("force", "off"):
            tg.config.device_predict = mode
            np.testing.assert_allclose(
                tg.predict_raw(x, num_iteration=num, start_iteration=start),
                jg.predict_raw(x, num_iteration=num, start_iteration=start),
                rtol=1e-5, atol=1e-6)
        leaves = tg.predict(x, num_iteration=num, start_iteration=start,
                            pred_leaf=True)
        np.testing.assert_array_equal(
            leaves, jg.predict(x, num_iteration=num, start_iteration=start,
                               pred_leaf=True))


def test_stumps_and_empty_models():
    """Constant labels grow stumps carrying the bias; zero query rows and
    a model with no trees give empty results of the right shape."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((500, 4))
    y = np.ones(500)
    tb = tlgb.train({"objective": "binary", **CPU}, tlgb.Dataset(x, y), 2)
    g = tb._gbdt
    assert all(t.num_leaves == 1 for t in g.models)
    tpe = packed.pack_gbdt(g, device="cpu")
    jpe = jpacked.pack_gbdt(jlgb.Booster(model_str=tb.model_to_string())
                            ._gbdt)
    _assert_packs_equal(jpe, tpe)
    xq = rng.standard_normal((50, 4))
    g.config.device_predict = "off"
    np.testing.assert_allclose(packed.predict_scores(tpe, xq),
                               g.predict_raw(xq), rtol=1e-6, atol=1e-7)
    assert not packed.predict_leaves(tpe, xq).any()
    assert packed.predict_scores(tpe, np.zeros((0, 4))).shape == (1, 0)
    assert packed.predict_leaves(tpe, np.zeros((0, 4))).shape == (0, 1)
    empty = packed.pack_ensemble([], 1, num_features=4, device="cpu")
    assert empty.num_trees == 0 and empty.max_depth == 0
    np.testing.assert_array_equal(packed.predict_scores(empty, xq),
                                  np.zeros((1, 50)))
    assert packed.predict_leaves(empty, xq).shape == (50, 0)


def test_device_predict_routing(monkeypatch):
    """auto takes the packed path from device_predict_min_rows rows on and
    the host walk below; force and off override; pred_early_stop is
    host-only.  The packed path calls no Tree.predict."""
    text = _text("binary")
    booster = tlgb.Booster(model_str=text, params={
        **CPU, "device_predict_min_rows": 200})
    g = booster._gbdt
    calls = []
    real = Tree.predict
    monkeypatch.setattr(Tree, "predict",
                        lambda self, d: calls.append(1) or real(self, d))
    nf = g.max_feature_idx + 1
    big, small = _queries(nf, 200, 5), _queries(nf, 199, 6)
    for data, mode, host in ((big, "auto", False), (small, "auto", True),
                             (small, "force", False), (big, "off", True)):
        g.config.device_predict = mode
        calls.clear()
        booster.predict(data)
        assert bool(calls) == host, (len(data), mode)
    g.config.device_predict = "force"
    g.config.pred_early_stop = True
    calls.clear()
    booster.predict(big)
    assert calls


@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_pred_early_stop_matches_jax(name):
    """Row-wise prediction early stopping (host-only) stops the same rows
    after the same trees as the JAX package's."""
    text = _text(name)
    params = {"pred_early_stop": True, "pred_early_stop_freq": 2,
              "pred_early_stop_margin": 1.0}
    jb = jlgb.Booster(model_str=text, params=params)
    tb = tlgb.Booster(model_str=text, params={**CPU, **params})
    x = _queries(tb._gbdt.max_feature_idx + 1, 300, 14)
    got = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(got, jb.predict(x, raw_score=True),
                               rtol=0, atol=1e-12)
    tb._gbdt.config.pred_early_stop = False
    assert np.abs(got - tb.predict(x, raw_score=True)).max() > 1e-3


def test_pack_cache_follows_training():
    """The packed path's cached pack is rebuilt once more trees are
    trained: predictions keep equal to the host walk."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1500, 5))
    y = (x[:, 0] - x[:, 1] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 7,
              "device_predict": "force", **CPU}
    booster = tlgb.Booster(params, tlgb.Dataset(x, y))
    g = booster._gbdt
    for rounds in (2, 5):
        while booster.num_trees() < rounds:
            booster.update()
        dev = booster.predict(x, raw_score=True)
        assert g._packed_cache[0][2] == rounds
        g.config.device_predict = "off"
        np.testing.assert_allclose(dev, booster.predict(x, raw_score=True),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(dev, g.train_score[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
        g.config.device_predict = "force"


def test_csr_predict_in_chunks_equals_dense(monkeypatch):
    """A CSR batch past one 65536-row chunk predicts as the dense matrix
    does, on every route, and its leaves too.  Under auto the tail chunk,
    below device_predict_min_rows alone, takes the whole batch's route:
    no chunk walks the host trees."""
    text = _text("binary")
    booster = tlgb.Booster(model_str=text, params=CPU)
    nf = booster._gbdt.max_feature_idx + 1
    rng = np.random.default_rng(9)
    x = rng.standard_normal((70_000, nf))
    x[rng.random(x.shape) < 0.6] = 0.0
    csr = scipy.sparse.csr_matrix(x)
    calls = []
    real = Tree.predict
    monkeypatch.setattr(Tree, "predict",
                        lambda self, d: calls.append(len(d)) or real(self, d))
    for mode in ("auto", "force", "off"):
        booster._gbdt.config.device_predict = mode
        calls.clear()
        np.testing.assert_array_equal(booster.predict(csr),
                                      booster.predict(x))
        assert bool(calls) == (mode == "off"), (mode, calls[:3])
    np.testing.assert_array_equal(
        booster.predict(csr[:3000], pred_leaf=True, num_iteration=2,
                        start_iteration=1),
        booster.predict(x[:3000], pred_leaf=True, num_iteration=2,
                        start_iteration=1))


@pytest.mark.parametrize("name", ["multiclass", "regression", "binary"])
def test_loaded_model_output_transform_matches_jax(name):
    """A model loaded from text converts its raw scores by its objective
    line as the JAX package does (softmax for multiclass, identity for
    regression, sigmoid for binary), on the host path."""
    text = _text(name)
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, params=CPU)
    x = np.random.default_rng(10).standard_normal(
        (50, tb._gbdt.max_feature_idx + 1))
    got, want = tb.predict(x), jb.predict(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if name == "multiclass":
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)


def test_convert_by_name_covers_every_transform():
    from lightgbm_tpu.boosting.gbdt import _convert_by_name as jconv
    from lightgbm_tpu_torch.boosting.gbdt import _convert_by_name as tconv
    raw = np.random.default_rng(11).standard_normal((3, 20))
    for obj in ("binary sigmoid:2", "multiclassova num_class:3",
                "cross_entropy", "poisson", "gamma", "tweedie",
                "multiclass num_class:3", "cross_entropy_lambda",
                "regression", "huber", ""):
        np.testing.assert_array_equal(tconv(obj, raw), jconv(obj, raw))


# -- server ---------------------------------------------------------------

def _window(seed, rounds=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1200, 6))
    y = (x[:, 0] + np.abs(x[:, 1]) > 0.5).astype(float)
    return tlgb.train({"objective": "binary", "num_leaves": 15, **CPU},
                      tlgb.Dataset(x, y), rounds)


def test_server_predicts_as_booster_and_swaps():
    a, b = _window(1), _window(2)
    xq = np.random.default_rng(3).standard_normal((300, 6))
    server = PredictionServer(a, device="cpu")
    for raw in (False, True):
        a._gbdt.config.device_predict = "force"
        np.testing.assert_array_equal(server.predict(xq, raw_score=raw),
                                      a.predict(xq, raw_score=raw))
        a._gbdt.config.device_predict = "off"
        np.testing.assert_allclose(server.predict(xq, raw_score=raw),
                                   a.predict(xq, raw_score=raw), rtol=1e-5,
                                   atol=1e-6)
    server.swap(b._gbdt)                         # same pads
    b._gbdt.config.device_predict = "force"
    got = server.predict(xq)
    np.testing.assert_array_equal(got, b.predict(xq))
    assert np.abs(got - a.predict(xq)).max() > 1e-3
    c = _window(4, rounds=9)                     # more trees: other pads
    server.swap(c)
    server.warmup()
    c._gbdt.config.device_predict = "force"
    np.testing.assert_array_equal(server.predict(xq), c.predict(xq))
    with pytest.raises(tlgb.LightGBMError, match="features"):
        server.predict(xq[:, :3])


def test_server_microbatch_queue():
    server = PredictionServer(_window(11), device="cpu", max_batch=4096,
                              max_wait_ms=5.0)
    rng = np.random.default_rng(7)
    queries = [rng.standard_normal((n, 6)) for n in (17, 1, 64, 33)]
    with server:
        futures = [server.submit(q, raw_score=i == 2)
                   for i, q in enumerate(queries)]
        bad = server.submit(np.zeros((2, 3)))
        got = [f.result(timeout=30) for f in futures]
        with pytest.raises(tlgb.LightGBMError):
            bad.result(timeout=30)
    for i, (q, g) in enumerate(zip(queries, got)):
        np.testing.assert_array_equal(g, server.predict(q,
                                                        raw_score=i == 2))
    with pytest.raises(tlgb.LightGBMError, match="not running"):
        server.submit(queries[0])


def test_server_accepts_a_model_file(tmp_path):
    path = tmp_path / "model.txt"
    path.write_text(_text("multiclass"))
    server = PredictionServer(str(path), device="cpu")
    booster = tlgb.Booster(model_str=_text("multiclass"),
                           params={**CPU, "device_predict": "force"})
    x = _queries(booster._gbdt.max_feature_idx + 1, 40, 12)
    got = server.predict(x)
    assert got.shape == (40, 3)
    np.testing.assert_array_equal(got, booster.predict(x))
    assert isinstance(GBDT.load_model_from_file(str(path)), GBDT)


# -- fleet ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tenants():
    """Three binary models of different pads (one with bitsets): the
    port's and the JAX package's fleets of them."""
    gs = [synthetic.random_forest(s, num_iterations=it, num_leaves=lv,
                                  num_features=6, cat_features=cats,
                                  denormals=False)
          for s, it, lv, cats in ((1, 3, 12, ()), (2, 5, 30, (2,)),
                                  (3, 2, 8, ()))]
    return gs


def test_fleet_tenants_route_as_their_solo_packs(tenants):
    fl, packs = fleet.pack_fleet(tenants, device="cpu")
    x = synthetic.query_rows(tenants[1], 300, 4, cat_features=(2,),
                             denormals=False)
    for m, pe in enumerate(packs):
        np.testing.assert_array_equal(
            fleet.fleet_predict_leaves(fl, m, x)[:, :pe.num_trees],
            packed.predict_leaves(pe, x))
        np.testing.assert_array_equal(fleet.fleet_predict_scores(fl, m, x),
                                      packed.predict_scores(pe, x))
    tid = np.random.default_rng(5).integers(0, 3, len(x)).astype(np.int32)
    mixed = fleet.fleet_predict_scores(fl, tid, x)
    for m, pe in enumerate(packs):
        np.testing.assert_array_equal(mixed[:, tid == m],
                                      packed.predict_scores(pe, x[tid == m]))
    jfl = jfleet.stack_packs([jpacked.pack_ensemble(
        _jax_trees(g.models), 1, num_features=6) for g in tenants])
    for f in packed.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(fl, f).numpy(),
                                      np.asarray(getattr(jfl, f)))
    np.testing.assert_array_equal(fleet.fleet_predict_leaves(fl, tid, x),
                                  jfleet.fleet_predict_leaves(jfl, tid, x))
    with pytest.raises(tlgb.LightGBMError, match="tenant_ids"):
        fleet.fleet_predict_scores(fl, 3, x)


def test_fleet_tenant_swap_is_an_index_copy(tenants):
    fl, packs = fleet.pack_fleet(tenants, device="cpu")
    x = synthetic.query_rows(tenants[0], 200, 6, denormals=False)
    before = [fleet.fleet_predict_scores(fl, m, x) for m in (0, 1)]
    ptr = fl.split_feature.data_ptr()
    assert fl.fits(packs[2])
    assert fleet.write_tenant(fl, 0, packs[2]) is fl
    assert fl.split_feature.data_ptr() == ptr
    np.testing.assert_array_equal(fleet.fleet_predict_scores(fl, 0, x),
                                  packed.predict_scores(packs[2], x))
    np.testing.assert_array_equal(fleet.fleet_predict_scores(fl, 1, x),
                                  before[1])
    small, _ = fleet.pack_fleet(tenants[2:], device="cpu")
    with pytest.raises(tlgb.LightGBMError, match="does not fit"):
        fleet.write_tenant(small, 0, packs[1])


def test_fleet_bf16_values_against_jax(tenants):
    """bf16 leaf tables equal the JAX package's bit for bit; routing is
    unchanged and scores move only by the value rounding."""
    fl, packs = fleet.pack_fleet(tenants, device="cpu", value_dtype="bf16")
    assert fl.leaf_value.dtype == torch.bfloat16
    jfl = jfleet.stack_packs([jpacked.pack_ensemble(
        _jax_trees(g.models), 1, num_features=6) for g in tenants],
        value_dtype="bf16")
    np.testing.assert_array_equal(
        fl.leaf_value.view(torch.int16).numpy(),
        np.asarray(jfl.leaf_value).view(np.int16))
    x = synthetic.query_rows(tenants[1], 300, 7, cat_features=(2,),
                             denormals=False)
    tid = np.arange(len(x), dtype=np.int32) % 3
    np.testing.assert_allclose(fleet.fleet_predict_scores(fl, tid, x),
                               jfleet.fleet_predict_scores(jfl, tid, x),
                               rtol=1e-5, atol=1e-6)
    f32, _ = fleet.pack_fleet(tenants, device="cpu")
    np.testing.assert_array_equal(fleet.fleet_predict_leaves(fl, tid, x),
                                  fleet.fleet_predict_leaves(f32, tid, x))
    np.testing.assert_allclose(fleet.fleet_predict_scores(fl, tid, x),
                               fleet.fleet_predict_scores(f32, tid, x),
                               atol=0.05)


def test_packed_from_arrays_round_trip():
    jg = jlgb.Booster(model_str=_text("categorical"))._gbdt
    jpe = jpacked.pack_gbdt(jg)
    tpe = convert.packed_from_arrays(
        {f: np.asarray(getattr(jpe, f)) for f in packed.ARRAY_FIELDS},
        num_model=jpe.num_model, max_depth=jpe.max_depth,
        num_trees=jpe.num_trees, num_features=jpe.num_features,
        device="cpu")
    _assert_packs_equal(jpe, tpe)
    x = _queries(jpe.num_features, 200, 13, categorical=True)
    np.testing.assert_array_equal(packed.predict_leaves(tpe, x),
                                  jpacked.predict_leaves(jpe, x))


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
