"""The port's categorical splits against the JAX package, on the CPU.

* the categorical scan (``ops/split.py``) on seeded histograms of
  ``parity_data.make_categorical_features`` (30 and 8 categories) in
  one-hot and sorted-subset mode, with ``cat_smooth``, ``cat_l2``,
  ``max_cat_threshold`` and ``max_cat_to_onehot`` varied: gains within
  rtol 1e-6, membership rows equal except on a gain tie (the f32 prefix
  sums differ in order: a forward and a reverse candidate that split the
  same bins differently only by f32 noise), the left sums within the
  numerical scan's bar; the int32 scan byte-equal; equal ratios sorted
  stably as ``jnp.argsort(stable=True)`` sorts them;
* a categorical tree of the device grower against the JAX device
  grower from the same gradients: split records and bin sets equal, the
  score within 1e-6; under ``grad_quant_bits=8`` byte-equal to the JAX
  grower run op by op, and the first model text byte-equal;
* ``engine.train`` with categorical columns (by index and by name):
  binary and regression trees equal to the JAX package's (every row's
  leaf, counts, bitsets), fused text equal to per-iteration text in f32
  and int8, validation scores by the binned traversal equal to
  ``Booster.predict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops.grow import DeviceGrower as JGrower
from lightgbm_tpu.tree import tree as jtree
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grow import DeviceGrower as TGrower
from lightgbm_tpu_torch.tree import tree as ttree

NB = 64
CATS = [0, 1]
BASE = {"objective": "binary", "max_bin": 63, "verbose": -1}
CPU = torch.device("cpu")


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


@pytest.fixture(scope="module")
def data():
    x = pd.make_categorical_features()
    return x, pd.make_categorical_labels(x)


def _datasets(params, x):
    jc, tc = JConfig(params), TConfig(params)
    return (jc, JDataset.construct_from_matrix(x, jc, categorical=CATS),
            tc, TDataset.construct_from_matrix(x, tc, categorical=CATS))


def _histograms(ds, n_leaves, seed, quant=False):
    """(B, S, 3) leaf histograms of random rows and their (B, 3) totals:
    f32 of random gradients, or int32 of int8-range quantized ones."""
    rng = np.random.default_rng(seed)
    n, g = ds.binned.shape
    leaf = rng.integers(0, n_leaves, n)
    if quant:
        stats = np.stack([rng.integers(-127, 128, n),
                          rng.integers(0, 128, n), np.ones(n, np.int64)], 1)
        hist = np.zeros((n_leaves, g * NB, 3), np.int64)
    else:
        stats = np.stack([rng.standard_normal(n) + 0.3 * np.sin(
            ds.binned[:, 0]), rng.random(n) + 0.05, np.ones(n)], 1)
        hist = np.zeros((n_leaves, g * NB, 3))
    for gi in range(g):
        np.add.at(hist, (leaf, gi * NB + ds.binned[:, gi].astype(np.int64)),
                  stats)
    hist = hist.astype(np.int32 if quant else np.float32)
    return hist, hist[:, :NB].sum(1).astype(hist.dtype)


def _jax_per_feature(jd, jc, hist, totals):
    meta = jsplit.FeatureMeta.from_dataset(jd, slot_stride=NB)
    hp = jsplit.SplitHyper.from_config(jc)
    cons = jnp.asarray([-np.inf, np.inf], jnp.float32)

    def one(h, t):
        shift = jsplit.min_gain_shift_of(t, hp)
        fh = jsplit.feature_histograms(h, t, meta)
        return jsplit.per_feature_best(fh, t, cons, meta, hp, True, shift)
    return jax.vmap(one)(jnp.asarray(hist), jnp.asarray(totals))


def _port_per_feature(td, tc, hist, totals):
    meta = tsplit.FeatureMeta.from_dataset(td, NB, CPU)
    hp = tsplit.SplitHyper.from_config(tc)
    t = torch.from_numpy(totals)
    shift = tsplit.min_gain_shift_of(t, hp)
    fh = tsplit.feature_histograms(torch.from_numpy(hist), t, meta)
    return tsplit.per_feature_best(fh, t, meta, hp, shift, has_cat=True)


SCAN_PARAMS = {
    "defaults": {},
    "onehot8": {"max_cat_to_onehot": 8, "cat_l2": 1.0},
    "threshold4": {"max_cat_threshold": 4, "cat_smooth": 1.0,
                   "min_data_per_group": 5},
    "smooth_l2": {"cat_smooth": 30.0, "cat_l2": 25.0,
                  "min_data_in_leaf": 5, "min_data_per_group": 40},
}


@pytest.mark.parametrize("case", list(SCAN_PARAMS))
def test_categorical_scan_matches_jax(case):
    """Each feature's best candidate of every leaf: gains within rtol
    1e-6; where the membership rows differ, the two candidates are the
    same partition of the feature's used bins seen from either side (a
    tie the f32 prefix sums break), so the left sums are the other
    side's; elsewhere the left sums agree within 1e-5 of their scale."""
    p = {**BASE, **SCAN_PARAMS[case]}
    jc, jd, tc, td = _datasets(p, pd.make_categorical_features())
    hist, totals = _histograms(jd, 6, seed=len(case))
    want = _jax_per_feature(jd, jc, hist, totals)
    got = _port_per_feature(td, tc, hist, totals)
    jg, tg = np.asarray(want.gain), got.gain.numpy()
    live = jg > tsplit.NEG_INF
    assert live[:, CATS].any()
    np.testing.assert_array_equal(tg > tsplit.NEG_INF, live)
    cat = live & np.isin(np.arange(jg.shape[1]), CATS)[None, :]
    np.testing.assert_allclose(tg[cat], jg[cat], rtol=1e-6)
    # the numerical features: test_torch_split.py's bar
    assert (np.abs(tg - jg)[live & ~cat] <= 1e-5 * jg[live].max()).all()
    jm, tm = np.asarray(want.cat_member), got.cat_member.numpy()
    jl, tl = np.asarray(want.left), got.left.numpy()
    scale = np.abs(jl).max(axis=(0, 1))
    nbin = td.f_num_bin
    for b, f in np.ndindex(*jg.shape):
        if not live[b, f]:
            continue
        if (jm[b, f] == tm[b, f]).all():
            assert (np.abs(tl[b, f] - jl[b, f]) <= 1e-5 * scale).all()
            continue
        used = np.arange(256) < nbin[f]
        assert not (jm[b, f] & tm[b, f]).any()
        assert ((jm[b, f] | tm[b, f]) <= used).all()
        if f in CATS:
            np.testing.assert_allclose(tl[b, f] + jl[b, f],
                                       np.asarray(totals)[b], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(want.cat_extra_l2)[0],
                                  got.cat_extra_l2.numpy())


@pytest.mark.parametrize("case", ["defaults", "threshold4", "smooth_l2"])
def test_categorical_int32_scan_byte_equal_to_jax(case):
    """The int32 scan of grad_quant_bits=8 with categorical features:
    the packed records, the membership rows and the exact left totals
    equal the JAX package's byte for byte."""
    p = {**BASE, **SCAN_PARAMS[case]}
    jc, jd, tc, td = _datasets(p, pd.make_categorical_features())
    hist, totals = _histograms(jd, 5, seed=11, quant=True)
    scales = np.array([0.0123, 0.00456], np.float32)
    mask = np.ones(jd.num_features, bool)
    want, want_c, want_l = jsplit.find_best_split_stack(
        jnp.asarray(hist), jnp.asarray(totals),
        jnp.asarray([-np.inf, np.inf], jnp.float32), jnp.asarray(mask),
        jsplit.FeatureMeta.from_dataset(jd, slot_stride=NB),
        jsplit.SplitHyper.from_config(jc), True, scales=jnp.asarray(scales))
    got, got_c, got_l = tsplit.find_best_split(
        torch.from_numpy(hist), torch.from_numpy(totals),
        torch.from_numpy(mask), tsplit.FeatureMeta.from_dataset(td, NB, CPU),
        tsplit.SplitHyper.from_config(tc), has_cat=True,
        scales=torch.from_numpy(scales))
    want = np.asarray(want)
    assert (want[:, tsplit.F_IS_CAT] == 1).any()
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_equal_ratios_sort_stably():
    """Bins with equal g / (h + cat_smooth) keep their bin order in the
    sorted scan, as ``jnp.argsort(stable=True)`` keeps it: the same
    membership rows and left sums as the JAX package."""
    p = {**BASE, "cat_smooth": 1.0, "max_cat_threshold": 8,
         "min_data_in_leaf": 1, "min_data_per_group": 1}
    jc, jd, tc, td = _datasets(p, pd.make_categorical_features())
    hist = np.zeros((3, jd.binned.shape[1] * NB, 3), np.float32)
    meta = tsplit.FeatureMeta.from_dataset(td, NB, CPU)
    slots = meta.slot_idx[0].numpy()[meta.valid_nondefault[0].numpy()]
    # feature 0's bins: four ratio levels, each shared by several bins
    level = np.arange(len(slots)) % 4
    for b in range(3):
        hist[b, slots, 0] = np.array([-2.0, -0.5, 0.5, 2.0])[level] * (b + 1)
        hist[b, slots, 1] = 4.0
        hist[b, slots, 2] = 10.0
    totals = hist[:, :NB].sum(1)
    want = _jax_per_feature(jd, jc, hist, totals)
    got = _port_per_feature(td, tc, hist, totals)
    assert (np.asarray(want.gain)[:, 0] > tsplit.NEG_INF).all()
    np.testing.assert_array_equal(got.cat_member.numpy()[:, 0],
                                  np.asarray(want.cat_member)[:, 0])
    np.testing.assert_array_equal(got.left.numpy()[:, 0],
                                  np.asarray(want.left)[:, 0])


def test_categorical_bitsets_match_jax():
    """The inner-bin and raw-category bitsets of a bin set, with the
    NaN bin (no category) and bins past 255 left out of the raw one."""
    x = pd.make_categorical_features().copy()
    x[::7, 0] = np.nan
    _, jd, _, td = _datasets({**BASE, "max_cat_threshold": 64}, x)
    jm, tm = jd.bin_mappers[0], td.bin_mappers[0]
    assert list(tm.bin_2_categorical) == list(jm.bin_2_categorical)
    for bins in ([0, 3, 5], list(range(tm.num_bin)), [1, 300], []):
        assert ttree.categorical_bitsets(tm, bins) \
            == jtree.categorical_bitsets(jm, bins)


# ---------------------------------------------------------------------------
# one tree of the device grower
def _grads(x, seed):
    rng = np.random.default_rng(seed)
    n = len(x)
    score = (0.3 * rng.standard_normal(n)).astype(np.float32)
    grad = (rng.standard_normal(n) + np.sin(x[:, 0])).astype(np.float32)
    hess = (0.05 + rng.random(n)).astype(np.float32)
    return score, grad, hess


def _same_partition(a, b):
    """Whether two leaf assignments of the same rows group them alike."""
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def _grow(params, seed, exact=True):
    """One tree of each grower from the same gradients: the port's
    (GrowResult), the JAX package's outputs, the leaf count.  ``exact``:
    the records are equal; else the trees may differ by mirrored
    categorical ties (below)."""
    x = pd.make_categorical_features()
    p = {**BASE, "device_growth": "on", "num_leaves": 15,
         "min_data_per_group": 10, "cat_smooth": 5.0, **params}
    jc, jd, tc, td = _datasets(p, x)
    score, grad, hess = _grads(x, seed)
    out = JGrower(jd, jc).grow_one_iter(
        jnp.asarray(score), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(jd.num_features, bool))
    res = TGrower(td, TConfig({**p, "device": "cpu"}), CPU).grow_one_iter(
        torch.from_numpy(score), torch.from_numpy(grad),
        torch.from_numpy(hess))
    nl = int(out[4])
    assert int(res.num_leaves) == nl >= 8
    rec_i = np.asarray(out[1])[:nl - 1]
    cat = np.isin(rec_i[:, 2], CATS)
    assert cat.any()
    got_i, got_c = res.rec_i.numpy()[:nl - 1], res.rec_c.numpy()[:nl - 1]
    want_c = np.asarray(out[3])[:nl - 1]
    if exact:
        np.testing.assert_array_equal(got_i, rec_i)
        np.testing.assert_array_equal(got_c[cat], want_c[cat])
        return res, out, nl
    # the same features and thresholds in the same order; a categorical
    # record whose bin set differs is the mirror of the JAX package's
    # (the two children swapped), and every training row lands in a leaf
    # of the same partition
    np.testing.assert_array_equal(got_i[:, 2:], rec_i[:, 2:])
    got_f, want_f = res.rec_f.numpy()[:nl - 1], np.asarray(out[2])[:nl - 1]
    for r in np.flatnonzero(cat & (got_c != want_c).any(axis=1)):
        assert (got_f[r, [3, 6]] == want_f[r, [6, 3]]).all()
    from lightgbm_tpu_torch.boosting.gbdt import _replay_records
    tc_ = TConfig({**p, "device": "cpu"})
    trees = [_replay_records(ri, rf, rc, nl, 1.0, 0.0, td, tc_)
             for ri, rf, rc in ((got_i, got_f, got_c),
                                (rec_i, want_f, want_c))]
    leaves = [t.predict_leaf(x) for t in trees]
    assert _same_partition(*leaves)
    np.testing.assert_allclose(trees[0].predict(x), trees[1].predict(x),
                               rtol=1e-5)
    return res, out, nl


@pytest.mark.parametrize("params,seed", [
    ({}, 0), ({}, 3), ({"max_cat_to_onehot": 8}, 1),
    ({"cat_l2": 2.0, "max_cat_threshold": 6, "lambda_l2": 1.0}, 2),
], ids=["sorted", "sorted_seed3", "onehot", "threshold6_l2"])
def test_categorical_tree_matches_jax_grower(params, seed):
    """f32: the split records equal the JAX grower's up to mirrored
    categorical ties (a forward and a reverse candidate of the sorted
    scan that put the same bins on opposite sides tie in gain, and f32
    noise picks one: "sorted_seed3"'s third split); every training row's
    leaf is in the same partition, its value within 1e-5, the gains
    within 1e-5 of their scale and the score within 1e-6
    (test_torch_grow.py's bar)."""
    res, out, nl = _grow(params, seed, exact=False)
    got, want = res.rec_f.numpy()[:nl - 1], np.asarray(out[2])[:nl - 1]
    assert (np.abs(got[:, 0] - want[:, 0])
            <= 1e-5 * np.abs(want[:, 0]).max()).all()
    np.testing.assert_allclose(res.score.numpy(), np.asarray(out[0]),
                               rtol=0, atol=1e-6)


def test_int8_categorical_tree_byte_equal_to_jax_op_by_op():
    """grad_quant_bits=8 against the JAX grower run op by op: records,
    bin sets, root value and score byte for byte (the refit keeps the
    growth value of leaves a categorical split made)."""
    with jax.disable_jit():
        res, out, nl = _grow({"grad_quant_bits": 8, "hist_kernel": "einsum",
                              "cat_l2": 3.0}, 2)
    bits = lambda a: np.asarray(a, np.float32).view(np.uint32)
    np.testing.assert_array_equal(bits(res.rec_f.numpy()[:nl - 1]),
                                  bits(np.asarray(out[2])[:nl - 1]))
    np.testing.assert_array_equal(res.rec_c.numpy()[:nl - 1],
                                  np.asarray(out[3])[:nl - 1])
    np.testing.assert_array_equal(bits(res.score.numpy()), bits(out[0]))


# ---------------------------------------------------------------------------
# training
TRAIN = {**BASE, "num_leaves": 15, "learning_rate": 0.1,
         "min_data_per_group": 20, "cat_smooth": 5.0}


def test_int8_first_tree_text_byte_equal_to_jax_op_by_op(data):
    x, y = data
    params = {**TRAIN, "grad_quant_bits": 8, "cat_l2": 3.0}
    with jax.disable_jit():
        jb = jlgb.train({**params, "device_growth": "on",
                         "hist_kernel": "einsum"},
                        jlgb.Dataset(x, y, categorical_feature=CATS),
                        num_boost_round=1, verbose_eval=False)
    tb = tlgb.train({**params, "device": "cpu"},
                    tlgb.Dataset(x, y, categorical_feature=CATS), 1)
    got = tb.model_to_string().split("parameters:")[0]
    assert "cat_threshold=" in got
    assert got == jb.model_to_string().split("parameters:")[0]


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_trees_equal_jax(data, objective):
    """3 rounds: every tree's splits, counts and bitsets equal, leaf
    values within 1e-5, and every training row in the same leaf."""
    x, y = data
    if objective == "regression":
        y = y * 2.0 + np.sin(x[:, 0]) + x[:, 2]
    params = {**TRAIN, "objective": objective}
    jb = jlgb.train({**params, "device_growth": "on"},
                    jlgb.Dataset(x, y, categorical_feature=CATS), 3,
                    verbose_eval=False)
    tb = tlgb.train({**params, "device": "cpu"},
                    tlgb.Dataset(x, y, categorical_feature=CATS), 3)
    jb._gbdt._flush_pending()
    tb._gbdt._flush_pending()
    n_cat = 0
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        n = a.num_leaves
        assert b.num_leaves == n > 2
        for name in ("split_feature", "threshold_in_bin", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n - 1],
                                          getattr(a, name)[:n - 1], name)
        np.testing.assert_array_equal(b.leaf_count[:n], a.leaf_count[:n])
        assert b.cat_threshold == a.cat_threshold
        assert b.cat_threshold_inner == a.cat_threshold_inner
        np.testing.assert_allclose(b.leaf_value[:n], a.leaf_value[:n],
                                   rtol=1e-5)
        np.testing.assert_array_equal(b.predict_leaf(x), a.predict_leaf(x))
        n_cat += b.num_cat
    assert n_cat > 0


@pytest.mark.parametrize("quant", [0, 8])
def test_fused_text_equals_per_iteration(data, quant):
    """Categorical binary training in fused chunks gives the model text
    of the per-iteration loop, in f32 and under int8."""
    x, y = data
    params = {**TRAIN, "grad_quant_bits": quant, "device": "cpu",
              "bagging_freq": 2, "bagging_fraction": 0.8,
              "feature_fraction": 0.75}
    fused = tlgb.Booster(params, tlgb.Dataset(x, y, categorical_feature=CATS))
    assert fused._gbdt.fused_eligible()
    fused.update_chunked(6, chunk=3)
    plain = tlgb.Booster(params, tlgb.Dataset(x, y, categorical_feature=CATS))
    for _ in range(6):
        plain.update()
    text = fused.model_to_string()
    assert "cat_threshold=" in text
    assert text == plain.model_to_string()


def test_categorical_feature_by_name_and_index(data):
    x, y = data
    names = ["site", "channel", "dist", "frac"]
    texts = []
    for cats in (CATS, ["site", "channel"], ["channel", 0]):
        tb = tlgb.train({**TRAIN, "device": "cpu"},
                        tlgb.Dataset(x, y, feature_name=names,
                                     categorical_feature=cats), 2)
        texts.append(tb.model_to_string())
    assert texts[0] == texts[1] == texts[2]
    assert "num_cat=" in texts[0] and "cat_threshold=" in texts[0]
    with pytest.raises(Exception, match="unknown categorical feature"):
        tlgb.Dataset(x, y, feature_name=names,
                     categorical_feature=["nope"]).construct()


def test_valid_scores_follow_predict(data):
    """The valid set's scores (the binned traversal reads the inner-bin
    bitsets) equal ``Booster.predict``'s raw scores (the host walk reads
    the raw-category ones) within 1e-5."""
    x, y = data
    xv = pd.make_categorical_features(700)[::-1].copy()
    yv = pd.make_categorical_labels(xv)
    train = tlgb.Dataset(x, y, categorical_feature=CATS)
    valid = train.create_valid(xv, yv)
    tb = tlgb.train({**TRAIN, "device": "cpu", "metric": "binary_logloss"},
                    train, 5, valid_sets=[valid], verbose_eval=False)
    gb = tb._gbdt
    gb.eval_valid()
    np.testing.assert_allclose(gb.valid_sets[0].score[0].numpy(),
                               tb.predict(xv, raw_score=True), rtol=0,
                               atol=1e-5)
