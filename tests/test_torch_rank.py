"""The port's LambdarankNDCG and query metadata against the JAX package
(``lightgbm_tpu/objectives/rank.py``, ``data/dataset.py`` ``Metadata``,
``basic.py`` ``Dataset``), on the CPU, on a small seeded ranking set whose
queries fill the 8-, 16-, 32- and 64-document buckets.

* the gradient equals the JAX package's within rtol 1e-4 / atol 1e-7,
  weighted and not, with one batch a bucket and with many (a small pair
  budget), and ``chip_smoke.lambdarank_grad_f64`` (the card run's float64
  plain version) within rtol 1e-4 / atol 1e-6.  Not rtol 1e-5: both
  packages' float32 gradients sit up to ~3e-5 (relative) from the
  float64 one on small hessians, through the cancellation in
  ``|disc_i - disc_j|`` of adjacent positions, so they differ from each
  other by as much.  A row's gradient is a sum of pair terms of both
  signs, summed in another order by each package, so its rtol is taken
  of the sum of its terms' magnitudes (the hessian's terms are all
  positive: of itself);
* ``device_grad`` is what the fused path captures: one (N,) score in,
  the rows' (grad, hess) out; the grower's sample piece hands it the
  unpadded score, so row bucketing changes nothing (the JAX package's
  ``device_grad_rowwise=False`` needs no effect here);
* training (both packages on their device growers): the first tree
  structurally equal, NDCG within 2e-3; fused == per-iteration model
  text; the same trees with ``train_row_bucketing`` true and false;
  validation with ``ndcg@1..5`` and early stopping as the JAX package;
* ``Dataset(x, y, None, w, group)`` means ``group`` in both packages, with
  equal query boundaries and weights; a validation set keeps its own
  queries, on every constructor.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Metadata as JMetadata
from lightgbm_tpu.objectives import create_objective as jcreate
from lightgbm_tpu.objectives import rank as jrank
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import BinnedDataset
from lightgbm_tpu_torch.data.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.objectives import create_objective as tcreate
from lightgbm_tpu_torch.objectives import rank as trank
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = torch.device("cpu")
BASE = {"objective": "lambdarank", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.1, "min_data_in_leaf": 10, "verbose": -1}


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


def rank_data(n_queries=60, cols=8, seed=5):
    """Seeded queries of 2-63 documents (every bucket from 8 to 64),
    relevance 0-4 from a noisy utility with a per-query offset."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, 64, n_queries)
    sizes[:4] = [1, 8, 9, 64]                 # bucket edges
    n = int(sizes.sum())
    x = rng.standard_normal((n, cols))
    qoff = np.repeat(rng.standard_normal(n_queries), sizes)
    util = (x[:, 0] + 0.5 * np.abs(x[:, 1]) - 0.3 * x[:, 2] + 0.5 * qoff
            + 0.7 * rng.standard_normal(n))
    y = np.digitize(util, np.quantile(util, [0.5, 0.75, 0.9, 0.97]))
    return x, y.astype(np.float64), sizes


@pytest.fixture(scope="module")
def data():
    return rank_data()


def _pair(label, sizes, weights=None, params=None):
    n = len(label)
    jmd, tmd = JMetadata(n), TMetadata(n)
    for md in (jmd, tmd):
        md.set_label(label)
        md.set_weights(weights)
        md.set_query(sizes)
    params = {"objective": "lambdarank", **(params or {})}
    jo = jcreate(JConfig(params))
    jo.init(jmd, n)
    to = tcreate(TConfig(params))
    to.init(tmd, n, CPU)
    return jo, to


@pytest.mark.parametrize("budget", [None, 1 << 12])
@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match_jax_and_the_f64_plain_version(data, weighted,
                                                       budget, monkeypatch):
    """``budget`` 4096 floats cuts every bucket into batches (64 queries
    of 8, 16 of 16, 4 of 32, 1 of 64) with padded ones at the end."""
    import jax.numpy as jnp
    _, y, sizes = data
    if budget is not None:
        monkeypatch.setattr(jrank, "_PAIR_BUDGET", budget)
        monkeypatch.setattr(trank, "_PAIR_BUDGET", budget)
    rng = np.random.default_rng(21)
    n = len(y)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    params = {"sigmoid": 1.5, "max_position": 10}
    jo, to = _pair(y, sizes, w, params)
    assert sorted(to.bucket_sizes) == [8, 16, 32, 64]
    if budget is not None:
        assert all(b == min(budget // (p * p), q)
                   for p, (q, b) in to.bucket_sizes.items())
        assert any(q > b for q, b in to.bucket_sizes.values())
    score = (rng.standard_normal(n) * 2).astype(np.float32)
    score[:20] = 0.5                          # ties: the stable order
    jg, jh = (np.asarray(a, np.float64) for a in
              jo.get_gradients(jnp.asarray(score)[None, :]))
    tg, th = (a.numpy().astype(np.float64) for a in
              to.get_gradients(torch.from_numpy(score)[None, :]))
    qb = np.concatenate([[0], np.cumsum(sizes)])
    fg, fh, mag = chip_smoke.lambdarank_grad_f64(score, y, qb,
                                                 to.label_gain, 1.5, 10)
    if w is not None:
        fg, fh, mag = fg * w, fh * w, mag * w
    assert (np.abs(tg - jg) <= 1e-4 * mag + 1e-7).all()
    np.testing.assert_allclose(th, jh, rtol=1e-4, atol=1e-7)
    assert (np.abs(tg - fg) <= 1e-4 * mag + 1e-6).all()
    np.testing.assert_allclose(th, fh, rtol=1e-4, atol=1e-6)
    assert np.abs(tg).max() > 0.05


def test_device_grad_is_the_per_iteration_gradient(data):
    _, y, sizes = data
    _, to = _pair(y, sizes)
    fn, args = to.device_grad()
    assert to.device_grad()[1] is args       # captured once per grower
    score = torch.linspace(-1, 1, len(y))
    g, h = fn(score, args)
    g2, h2 = to.get_gradients(score[None, :])
    assert g.shape == h.shape == (len(y),)
    assert torch.equal(g, g2) and torch.equal(h, h2)
    assert not to.device_grad_rowwise


def test_rank_refusals(data):
    x, y, sizes = data
    with pytest.raises(LightGBMError, match="query information"):
        tlgb.train({**BASE, "device": "cpu"}, tlgb.Dataset(x, y), 1)
    md = TMetadata(len(y))
    md.set_label(y)
    md.set_query(sizes)
    obj = tcreate(TConfig({"objective": "lambdarank",
                           "label_gain": [0, 1, 3]}))
    with pytest.raises(LightGBMError, match="label_gain"):
        obj.init(md, len(y), CPU)
    md = TMetadata(len(y))
    with pytest.raises(LightGBMError, match="sum of query counts"):
        md.set_query(sizes[:-1])


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def _trees(booster):
    booster._gbdt._flush_pending()
    return booster._gbdt.models


def test_training_matches_jax(data):
    x, y, sizes = data
    jb = jlgb.train({**BASE, "device_growth": "on"},
                    jlgb.Dataset(x, y, group=sizes), num_boost_round=5,
                    verbose_eval=False)
    tb = tlgb.train({**BASE, "device": "cpu"},
                    tlgb.Dataset(x, y, group=sizes), num_boost_round=5)
    jt, tt = _trees(jb)[0], _trees(tb)[0]
    n = jt.num_leaves
    assert n == tt.num_leaves > 2
    for field in ("split_feature", "threshold_in_bin", "decision_type",
                  "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, field)[:n - 1],
                                      getattr(jt, field)[:n - 1], field)
    np.testing.assert_array_equal(tt.leaf_count[:n], jt.leaf_count[:n])
    np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                               rtol=1e-5, atol=1e-7)
    jr, tr = jb.eval_train(), tb.eval_train()
    assert [r[1] for r in tr] == [r[1] for r in jr] == \
        [f"ndcg@{k}" for k in range(1, 6)]
    for a, b in zip(tr, jr):
        assert abs(a[2] - b[2]) < 2e-3 and a[3] is b[3] is True


def _gbdt(x, y, sizes, n_iters, chunk, **params):
    cfg = TConfig({**BASE, **params, "device": "cpu"})
    ds = BinnedDataset.construct_from_matrix(x, cfg)
    ds.metadata.set_label(y)
    ds.metadata.set_query(sizes)
    gb = GBDT(cfg)
    gb.init_train(ds)
    gb.train_chunked(n_iters, chunk=chunk)
    gb._flush_pending()
    return gb


def test_fused_equals_per_iteration(data):
    x, y, sizes = data
    a = _gbdt(x, y, sizes, 6, chunk=0)
    b = _gbdt(x, y, sizes, 6, chunk=3)
    assert b.fused_eligible() and [s[1] for s in b.tree_stats] == [3, 3]
    assert torch.equal(a.train_score, b.train_score)
    assert a.model_to_string() == b.model_to_string()


def test_row_bucketing_changes_nothing(data, monkeypatch):
    """The grower pads its rows to a pow2 bucket; the sample piece still
    hands the gradient the (num_data,) score (never bucket-padded), so
    the trees are those of an unpadded grower."""
    from lightgbm_tpu_torch.ops import grow
    x, y, sizes = data
    seen = []
    real = grow.DeviceGrower._piece_sample

    def spy(self, redraw):
        seen.append((self._st.score.shape[0], self.n_pad))
        return real(self, redraw)
    monkeypatch.setattr(grow.DeviceGrower, "_piece_sample", spy)
    a = _gbdt(x, y, sizes, 4, chunk=4, train_row_bucketing=True)
    b = _gbdt(x, y, sizes, 4, chunk=4, train_row_bucketing=False)
    n = len(y)
    assert a._grower.n_pad > n == b._grower.n_pad
    assert seen and all(s == n for s, _ in seen)
    assert torch.equal(a.train_score, b.train_score)
    # the trees' text (the parameters block names the option)
    assert a.model_to_string().split("parameters:")[0] \
        == b.model_to_string().split("parameters:")[0]


def test_valid_ndcg_and_early_stopping_match_jax(data):
    """eval_valid with several results (ndcg@1, @3, @5) and early
    stopping on them: the same names, values within 2e-3 and the same
    best iteration as the JAX package."""
    x, y, sizes = data
    xv, yv, sv = rank_data(n_queries=25, seed=9)
    params = {**BASE, "eval_at": [1, 3, 5], "metric": "ndcg"}
    out = {}
    for name, lgb, extra in (("jax", jlgb, {"device_growth": "on"}),
                             ("torch", tlgb, {"device": "cpu"})):
        train = lgb.Dataset(x, y, group=sizes)
        valid = train.create_valid(xv, yv, group=sv)
        ev = {}
        kw = {"verbose_eval": False} if name == "jax" else {}
        bst = lgb.train({**params, **extra}, train, 20, valid_sets=[valid],
                        early_stopping_rounds=3, evals_result=ev, **kw)
        out[name] = (bst.best_iteration, ev)
    (jbest, jev), (tbest, tev) = out["jax"], out["torch"]
    assert tbest == jbest
    assert list(tev["valid_0"]) == list(jev["valid_0"]) == \
        ["ndcg@1", "ndcg@3", "ndcg@5"]
    for k in tev["valid_0"]:
        np.testing.assert_allclose(tev["valid_0"][k], jev["valid_0"][k],
                                   atol=2e-3)


# ----------------------------------------------------------------------
# query metadata and the Dataset API
# ----------------------------------------------------------------------
def test_dataset_positional_group_and_query_weights(data):
    x, y, sizes = data
    w = np.random.default_rng(3).uniform(0.1, 2.0, len(y))
    jd = jlgb.Dataset(x, y, None, w, sizes).construct()
    td = tlgb.Dataset(x, y, None, w, sizes).construct()
    jmd, tmd = jd._handle.metadata, td._handle.metadata
    np.testing.assert_array_equal(tmd.query_boundaries, jmd.query_boundaries)
    np.testing.assert_array_equal(tmd.query_weights, jmd.query_weights)
    assert tmd.num_queries() == jmd.num_queries() == len(sizes)
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    # boundaries in place of sizes; set_weights refreshes query_weights
    md = TMetadata(len(y))
    md.set_query(np.concatenate([[0], np.cumsum(sizes)]))
    np.testing.assert_array_equal(md.query_boundaries, tmd.query_boundaries)
    md.set_weights(w)
    np.testing.assert_array_equal(md.query_weights, tmd.query_weights)
    td.set_group(sizes[::-1].copy())
    np.testing.assert_array_equal(td.get_group(), sizes[::-1])
    assert tlgb.Dataset(x, y, group=sizes).get_group() is sizes


@pytest.mark.parametrize("kind", ["dense", "csr", "tensor"])
def test_validation_set_keeps_its_own_queries(data, kind):
    import scipy.sparse as sp
    x, y, sizes = data
    xv, yv, sv = rank_data(n_queries=7, seed=4)
    conv = {"dense": lambda a: a, "csr": sp.csr_matrix,
            "tensor": lambda a: torch.from_numpy(a.astype(np.float32))}[kind]
    params = {"device": "cpu", "verbose": -1}
    train = tlgb.Dataset(conv(x), y, group=sizes, params=params)
    valid = train.create_valid(conv(xv), yv, group=sv).construct()
    np.testing.assert_array_equal(valid.get_group(), sv)
    np.testing.assert_array_equal(train.construct().get_group(), sizes)
    assert valid._handle.reference is train._handle
