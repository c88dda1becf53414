"""The device grower's stat-column layouts in the port against the JAX
package (both growers, ``device_growth: on``): the striped K=4 counts and
the int8 K=6 stripes from ``COUNT_SPLIT_ROWS`` rows, ``gpu_use_dp``'s
K=5/6 hi/lo columns, and the int8 f32 fallback scan past
``INT32_SCAN_ROWS``.  The bounds are lowered in both packages' modules to
force these layouts on the parity features' 2,000 rows (as the JAX suite
forces its own), and restored after.

* the layout, wave width, stage plan and row pad agree with the JAX
  package's functions at the real bounds (2^23 + 1, 2^24 and 20,000,000
  rows; the exact-rows rule past ``2 * COUNT_SPLIT_ROWS``);
* one tree from injected gradients: the striped and hi/lo layouts give
  the JAX grower's split records (1e-5 of each field's magnitude, as
  ``test_torch_grow.py``; 5e-5 for the hi/lo columns, whose four f32
  sums each package adds in its own order), and equal the unstriped
  layout's tree at rtol 1e-5; int8 K=6 below the int32 bound is
  byte-equal to the JAX grower run op by op; the f32 fallback grows the
  same trees (records equal, f32 fields within 1e-5), its counts exact;
* the kernel wrapper's int8 guard counts rows per stripe column.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.ops.grow as jgrow
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.ops.grow as tgrow
import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
from lightgbm_tpu.ops import stage_plan as jplan
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.ops import hist_cuda
from lightgbm_tpu_torch.ops.stage_plan import legacy_stage_plan

BASE = {"objective": "binary", "max_bin": 63, "verbose": -1,
        "device_growth": "on", "hist_kernel": "einsum",
        "learning_rate": 0.1, "num_leaves": 31, "seed": 3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bounds():
    """Set COUNT_SPLIT_ROWS / INT32_SCAN_ROWS in both packages; restored
    after the test."""
    old = {m: (m.COUNT_SPLIT_ROWS, m.INT32_SCAN_ROWS)
           for m in (jgrow, tgrow)}

    def set_(count_split=None, int32_scan=None):
        for m in (jgrow, tgrow):
            if count_split is not None:
                m.COUNT_SPLIT_ROWS = count_split
            if int32_scan is not None:
                m.INT32_SCAN_ROWS = int32_scan
    try:
        yield set_
    finally:
        for m, (c, i) in old.items():
            m.COUNT_SPLIT_ROWS, m.INT32_SCAN_ROWS = c, i


@pytest.fixture(scope="module")
def feats():
    return pd.make_features()


@pytest.mark.parametrize("rows,extra", [
    ((1 << 23) + 1, {}), (1 << 24, {}), (20_000_000, {}),
    (20_000_000, {"grad_quant_bits": 8}), ((1 << 23) + 1,
                                           {"grad_quant_bits": 8}),
    (2_000_000, {"gpu_use_dp": True}), (20_000_000, {"gpu_use_dp": True}),
    (20_000_000, {"train_row_bucketing": False}),
])
def test_layout_rows_and_plan_match_jax(rows, extra):
    """The port's row pad and the JAX grower's row count; then the layout
    (K), wave width and stage plan computed from it, equal to the JAX
    package's own functions.  Past 2 * COUNT_SPLIT_ROWS's bucket the pad
    is the exact row count."""
    cfg = TConfig({**BASE, "device": "cpu", **extra})
    jcfg = JConfig({**BASE, **extra})
    layout_rows, n_pad = tgrow.grower_rows(rows, cfg)
    quant = "grad_quant_bits" in extra
    bucket = jgrow.bucket_size(rows) if cfg.train_row_bucketing else rows
    jax_rows = rows if (quant or bucket >= 2 * jgrow.COUNT_SPLIT_ROWS) \
        else bucket
    assert layout_rows == jax_rows
    assert n_pad == (rows if bucket >= 2 * jgrow.COUNT_SPLIT_ROWS
                     else bucket)
    assert tgrow._hist_layout(layout_rows, cfg) \
        == jgrow._hist_layout(jax_rows, jcfg)
    k = tgrow._hist_layout(layout_rows, cfg)[2]
    w = tgrow._wave_width(255, k)
    assert w == jgrow._wave_width(255, k)
    assert legacy_stage_plan(255, w, k) \
        == [tuple(p) for p in jplan.legacy_stage_plan(255, w, k)]
    assert jgrow.default_stage_plan(jax_rows, JConfig({**BASE, **extra,
                                                       "num_leaves": 255})) \
        == legacy_stage_plan(255, w, k)
    if rows == 20_000_000 and not extra:
        assert (k, w) == (4, 96)
    if rows == 20_000_000 and quant:
        assert (k, w) == (6, 64)
        assert n_pad > tgrow.INT32_SCAN_ROWS     # the f32 fallback


def _grow_pair(x, params, seed, op_by_op=False):
    """One tree from the same injected gradients on both growers:
    (port GrowResult, JAX outputs, port grower, JAX grower)."""
    rng = np.random.default_rng(seed)
    n = len(x)
    score = (0.3 * rng.standard_normal(n)).astype(np.float32)
    grad = rng.standard_normal(n).astype(np.float32)
    hess = (0.05 + rng.random(n)).astype(np.float32)
    jc, tc = JConfig(params), TConfig({**params, "device": "cpu"})
    jg = jgrow.DeviceGrower(JDataset.construct_from_matrix(x, jc), jc)
    tg = tgrow.DeviceGrower(TDataset.construct_from_matrix(x, tc), tc,
                            torch.device("cpu"))
    jm = jnp.ones(tg._ff_nf, bool)

    def run():
        return jg.grow_one_iter(jnp.asarray(score), jnp.asarray(grad),
                                jnp.asarray(hess), jm, tree_idx=2)
    if op_by_op:
        with jax.disable_jit():
            out = run()
    else:
        out = run()
    res = tg.grow_one_iter(torch.from_numpy(score), torch.from_numpy(grad),
                           torch.from_numpy(hess), tree_idx=2)
    return res, out, tg, jg


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


LAYOUTS = [
    # (extra params, COUNT_SPLIT_ROWS, INT32_SCAN_ROWS, port K, level)
    ({}, 1500, None, 4, "close"),
    ({"gpu_use_dp": True}, None, None, 5, "hi_lo"),
    ({"gpu_use_dp": True}, 1500, None, 6, "hi_lo"),
    ({"grad_quant_bits": 8}, 1500, None, 6, "bytes"),
    ({"grad_quant_bits": 8}, 1500, 1000, 6, "same_trees"),
    ({"grad_quant_bits": 8}, None, 1000, 3, "same_trees"),
]


@pytest.mark.parametrize("extra,count_split,int32_scan,k,level", LAYOUTS,
                         ids=["bf16_k4", "dp_k5", "dp_k6", "int8_k6",
                              "int8_k6_f32_fallback", "int8_k3_fallback"])
def test_layout_tree_matches_jax(bounds, feats, extra, count_split,
                                 int32_scan, k, level):
    bounds(count_split, int32_scan)
    params = {**BASE, **extra}
    res, out, tg, jg = _grow_pair(feats, params, seed=k,
                                  op_by_op=level == "bytes")
    assert tg.hist_cols == jg.programs.hist_cols == k
    assert tg.wave_width == jg.programs.wave_width
    assert tg.int_scan == bool(getattr(jg.programs, "int_scan", False))
    j_nl = int(out[4])
    assert int(res.num_leaves) == j_nl >= 3
    nrec = j_nl - 1
    np.testing.assert_array_equal(res.rec_i.numpy()[:nrec],
                                  np.asarray(out[1])[:nrec])
    got, want = res.rec_f.numpy()[:nrec], np.asarray(out[2])[:nrec]
    if level == "bytes":
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(res.score.numpy()),
                                      _bits(out[0]))
        return
    # hi/lo columns: each package sums g_hi, g_lo, h_hi and h_lo in f32
    # in its own order, and a small leaf's output and gain amplify that
    scale = np.abs(want).max(axis=0)
    tol = 5e-5 if level == "hi_lo" else 1e-5
    assert (np.abs(got - want) <= tol * scale).all()
    # counts are exact in every layout: the root's children hold every row
    assert got[0, 3] + got[0, 6] == len(feats)
    np.testing.assert_allclose(res.score.numpy(), np.asarray(out[0]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("extra", [{}, {"gpu_use_dp": True},
                                   {"grad_quant_bits": 8}],
                         ids=["bf16", "dp", "int8"])
def test_striped_equals_unstriped(bounds, feats, extra):
    """Forced stripes change only how the columns split the rows: the
    port's striped model equals its unstriped one (rtol 1e-5, as the JAX
    suite's test_striped_count_columns_match_default; int8 sums are
    integers, so the int8 model is byte-equal)."""
    y = pd.make_labels(feats)[1]
    params = {**BASE, **extra, "objective": "regression", "device": "cpu"}
    plain = tlgb.train(params, tlgb.Dataset(feats, y), 4, verbose_eval=False)
    bounds(1500)
    striped = tlgb.train(params, tlgb.Dataset(feats, y), 4,
                         verbose_eval=False)
    assert striped._gbdt._grower.striped
    assert not plain._gbdt._grower.striped
    a = striped.predict(feats, raw_score=True)
    b = plain.predict(feats, raw_score=True)
    if "grad_quant_bits" in extra:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for tree in striped._gbdt.models:
        assert int(tree.leaf_count[:tree.num_leaves].sum()) == len(feats)


def test_fallback_fused_equals_per_iteration(bounds, feats):
    """The int8 f32 fallback with bagging and feature_fraction: a fused
    chunk equals per-iteration training bit for bit (the refit's int64
    fixed-point sums do not depend on their order)."""
    bounds(1500, 1000)
    y = pd.make_labels(feats)[0]
    params = {**BASE, "device": "cpu", "grad_quant_bits": 8,
              "bagging_fraction": 0.8, "bagging_freq": 2,
              "feature_fraction": 0.8}
    a = tlgb.Booster(params=params, train_set=tlgb.Dataset(feats, y))
    b = tlgb.Booster(params=params, train_set=tlgb.Dataset(feats, y))
    assert not a._gbdt._grower.int_scan
    a.update_chunked(4, chunk=4)
    for _ in range(4):
        b.update()
    assert a.model_to_string() == b.model_to_string()


def test_int8_guard_counts_rows_per_stripe_column():
    """An int8 call whose columns each sum at most INT8_EXACT_ROWS rows
    passes the guard however many rows it has; one column over the limit
    is refused (checked before any work, on any device)."""
    n = 64
    bins = torch.zeros((1, n), dtype=torch.uint8)
    leaf = torch.zeros(n, dtype=torch.int32)
    ghk = torch.ones((n, 6), dtype=torch.int8)
    pending = torch.zeros(1, dtype=torch.int32)
    kw = dict(g=1, nb=64, k=6, w=1)
    limit = hist_cuda.INT8_EXACT_ROWS
    with pytest.raises(ValueError, match="one column"):
        hist_cuda.wave_hist(bins, leaf, ghk, pending, col_rows=limit + 1,
                            **kw)
    out = hist_cuda.wave_hist(bins, leaf, ghk, pending, col_rows=limit, **kw)
    assert int(out[0, :, 0].sum()) == 6 * n


def test_gpu_use_dp_wins_over_quantization(feats):
    """As the JAX config has it (tests/test_quant.py): gpu_use_dp drops
    grad_quant_bits, and the grower takes the hi/lo K=5 columns."""
    params = {**BASE, "grad_quant_bits": 8, "gpu_use_dp": True}
    tc = TConfig({**params, "device": "cpu"})
    assert tc.grad_quant_bits == JConfig(params).grad_quant_bits == 0
    grower = tgrow.DeviceGrower(TDataset.construct_from_matrix(feats, tc),
                                tc, torch.device("cpu"))
    assert (grower.hist_cols, grower.quant_bits) == (5, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_window_plain_versions_agree(dtype):
    """The list mode's two plain versions: the f32 ``index_add_`` one (the
    CPU path) within 1e-5 of each bin's |stat| sum of the exact
    fixed-point one (int8: equal); a permuted list gives the same
    fixed-point sums bit for bit."""
    gen = torch.Generator().manual_seed(3)
    n, g, nb, k = 5000, 4, 64, 3
    bins = torch.randint(0, nb, (g, n), generator=gen, dtype=torch.uint8)
    if dtype == torch.int8:
        ghk = torch.randint(-127, 128, (n, k), generator=gen,
                            dtype=torch.int8)
    else:
        ghk = torch.randn((n, k), generator=gen).to(dtype)
    rows = torch.randperm(n, generator=gen)[:3001].to(torch.int32)
    kw = dict(g=g, nb=nb, k=k)
    plain = hist_cuda.wave_hist_rows(bins, ghk, rows, **kw)
    if dtype == torch.int8:
        ref = torch.zeros((g * nb, k), dtype=torch.int32)
        for r in rows.tolist():
            for gi in range(g):
                ref[gi * nb + int(bins[gi, r])] += ghk[r].int()
        assert torch.equal(plain, ref)
        return
    e = hist_cuda.exponents_for_rows(ghk.abs().amax(0).float(), len(rows))
    exact = hist_cuda.wave_hist_rows_fixed_reference(bins, ghk, rows, e, **kw)
    again = hist_cuda.wave_hist_rows_fixed_reference(
        bins, ghk, rows.flip(0).contiguous(), e, **kw)
    assert torch.equal(exact.view(torch.int32), again.view(torch.int32))
    mag = hist_cuda.wave_hist_rows(bins, ghk.abs(), rows, **kw)
    assert ((plain - exact).abs() <= 1e-5 * mag + 1e-6).all()
