"""The port's windowed-retrain pipeline (``lightgbm_tpu_torch/pipeline/``)
on the CPU, every case of ``tests/test_pipeline.py`` re-pointed at it, and
its window models held against the JAX package's pipeline (its device
grower, ``device_growth: on``) on the same windows:

* determinism — rebinning off and ``window_policy=fresh``: the pipelined
  loop's models are byte-identical to the serial loop's;
* against the JAX pipeline — stationary windows under ``fresh``,
  ``refit`` and ``warm``: equal tree structures, leaf values and raw
  predictions within 1e-6 of max|value|, the per-window drift within
  1e-9 and the ``rebinned`` flags equal; on windows whose labels shift
  (a rebin), and on CSR windows, the drift and flags agree and a tree
  parts only at a split whose gain is f32 noise in one package
  (ROADMAP §3);
* fault isolation — a prep-thread exception surfaces as
  :class:`PipelineError` with the completed windows, and serving keeps
  answering from the last good model;
* drift-gated rebinding, the policies and a per-window policy callable;
* CSR prep with evaluation through the server;
* ``BinMapperCache`` save/load, across the two packages too;
* checkpoint resume byte-identical to an uninterrupted run, serving the
  last good model, from a checkpoint either package wrote;
* the overlap accounting.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lightgbm_tpu.pipeline import BinMapperCache as JBinMapperCache
from lightgbm_tpu.pipeline import PreppedWindow as JPreppedWindow
from lightgbm_tpu.pipeline import RetrainPipeline as JRetrainPipeline
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.pipeline import (BinMapperCache, PipelineError,
                                         PreppedWindow, RetrainPipeline)
from lightgbm_tpu_torch.robust import faults
from lightgbm_tpu_torch.robust.checkpoint import load_pipeline_checkpoint

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 5, "verbosity": -1, "metric": "none",
          "num_iterations": 8, "device": "cpu"}
JAX_PARAMS = {k: v for k, v in PARAMS.items() if k != "device"}
JAX_PARAMS["device_growth"] = "on"
#: a split gain at or below this fraction of its tree's largest gain is
#: f32 rounding noise (~8 ulp of the largest gain)
NOISE_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarmed_faults():
    faults.clear()
    yield
    faults.clear()


def _dense_window(seed, n=3000, nf=8, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nf)) + shift
    y = (x[:, 0] + 0.5 * x[:, 1] > shift).astype(np.float64)
    return x, y


def _dense_prep(seed_base, with_eval=False, cls=PreppedWindow):
    def prep(w):
        x, y = _dense_window(seed_base + w)
        return cls(label=y, dense=x,
                   eval_dense=x if with_eval else None,
                   eval_label=y if with_eval else None)
    return prep


def _shift_prep(cls):
    def prep(w):
        x, y = _dense_window(80 + w, shift=4.0 if w >= 2 else 0.0)
        return cls(label=y, dense=x)
    return prep


def _model_strings(results):
    return [r.booster.model_to_string() for r in results]


def _trees(gbdt):
    gbdt._flush_pending()
    return gbdt.models


def _assert_same_tree(jt, tt, scale):
    n = jt.num_leaves
    assert tt.num_leaves == n
    for name in ("split_feature", "threshold_in_bin", "decision_type",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:n - 1],
                                      getattr(jt, name)[:n - 1], name)
    np.testing.assert_array_equal(tt.leaf_count[:n], jt.leaf_count[:n])
    np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                               rtol=0, atol=1e-6 * scale)


def _assert_windows_match(jres, tres, x):
    assert [r.rebinned for r in tres] == [r.rebinned for r in jres]
    assert [r.policy for r in tres] == [r.policy for r in jres]
    assert [r.num_trees for r in tres] == [r.num_trees for r in jres]
    for jr, tr in zip(jres, tres):
        if jr.drift is None:
            assert tr.drift is None
        else:
            assert abs(tr.drift - jr.drift) <= 1e-9
        jt, tt = _trees(jr.booster), _trees(tr.booster)
        scale = max(np.abs(t.leaf_value[:t.num_leaves]).max() for t in jt)
        for a, b in zip(jt, tt):
            _assert_same_tree(a, b, scale)
        jp = np.asarray(jr.booster.predict_raw(x))
        tp = tr.booster.predict_raw(x)
        np.testing.assert_allclose(tp, jp, rtol=0,
                                   atol=1e-6 * max(np.abs(jp).max(), 1.0))


def _assert_first_difference_is_noise(jres, tres):
    """Drift within 1e-9 and equal flags a window; each window's trees
    equal (structure and counts) up to the first node where the two
    packages split differently, and there one of them splits at an f32
    noise-level gain: a leaf whose exact best gain is 0 (its rows' g/h
    ratio is one constant), which f32 rounding puts just above the bar in
    one package and not in the other.  The trees after it differ."""
    assert [r.rebinned for r in tres] == [r.rebinned for r in jres]
    for jr, tr in zip(jres, tres):
        if jr.drift is None:
            assert tr.drift is None
        else:
            assert abs(tr.drift - jr.drift) <= 1e-9
        for jt, tt in zip(_trees(jr.booster), _trees(tr.booster)):
            n = min(jt.num_leaves, tt.num_leaves) - 1
            diff = [i for i in range(n)
                    if (jt.split_feature[i], jt.threshold_in_bin[i])
                    != (tt.split_feature[i], tt.threshold_in_bin[i])]
            if not diff and jt.num_leaves == tt.num_leaves:
                np.testing.assert_array_equal(tt.leaf_count[:n + 1],
                                              jt.leaf_count[:n + 1])
                continue
            k = diff[0] if diff else n
            noise = NOISE_REL * max(jt.split_gain[:jt.num_leaves - 1].max(),
                                    tt.split_gain[:tt.num_leaves - 1].max())
            assert min(jt.split_gain[min(k, jt.num_leaves - 2)],
                       tt.split_gain[min(k, tt.num_leaves - 2)]) <= noise
            break


# ----------------------------------------------------------------------
# the tests/test_pipeline.py cases, on the port

def test_pipelined_byte_identical_to_serial():
    kw = dict(window_policy="fresh", rebin_on_drift=False, serve=False)
    serial = RetrainPipeline(PARAMS, pipelined=False, **kw)
    rs = serial.run(range(3), _dense_prep(40))
    piped = RetrainPipeline(PARAMS, pipelined=True, **kw)
    rp = piped.run(range(3), _dense_prep(40))
    assert _model_strings(rs) == _model_strings(rp)
    assert [r.rebinned for r in rp] == [True, False, False]
    assert all(r.drift is None for r in rp[:1])


def test_prep_fault_surfaces_and_serving_survives():
    base = _dense_prep(60, with_eval=True)

    def prep(w):
        if w == 2:
            raise ValueError("featurization blew up")
        return base(w)

    pipe = RetrainPipeline(PARAMS, window_policy="fresh")
    with pytest.raises(PipelineError) as ei:
        pipe.run(range(4), prep, eval_fn=lambda pred, pw: {})
    err = ei.value
    assert err.window == 2
    assert [r.window for r in err.results] == [0, 1]
    assert isinstance(err.__cause__, ValueError)
    x, _ = _dense_window(61)
    pred = pipe.server.predict(x)
    assert np.isfinite(np.asarray(pred)).all()
    ref = err.results[-1].booster.predict(x)
    np.testing.assert_allclose(np.asarray(pred), ref, rtol=1e-4,
                               atol=1e-6)


def test_drift_rebind_on_shift_only():
    pipe = RetrainPipeline(PARAMS, window_policy="fresh", serve=False,
                           drift_threshold=0.1)
    res = pipe.run(range(4), _shift_prep(PreppedWindow))
    assert [r.rebinned for r in res] == [True, False, True, False]
    assert res[2].drift > 0.1
    assert res[1].drift < 0.05
    assert res[3].drift < 0.05
    assert pipe.bins.rebinds == 1


def test_policies_refit_and_warm():
    cfg = dict(rebin_on_drift=False, serve=False)
    refit = RetrainPipeline(PARAMS, window_policy="refit", **cfg)
    rr = refit.run(range(3), _dense_prep(100))
    assert [r.policy for r in rr] == ["fresh", "refit", "refit"]
    assert [r.num_trees for r in rr] == [8, 8, 8]
    t0 = rr[0].booster.models[2]
    t1 = rr[1].booster.models[2]
    np.testing.assert_array_equal(
        t0.split_feature[:t0.num_leaves - 1],
        t1.split_feature[:t1.num_leaves - 1])
    assert not np.allclose(t0.leaf_value[:t0.num_leaves],
                           t1.leaf_value[:t1.num_leaves])

    warm = RetrainPipeline(PARAMS, window_policy="warm",
                           warm_iterations=4, **cfg)
    rw = warm.run(range(3), _dense_prep(100))
    assert [r.policy for r in rw] == ["fresh", "warm", "warm"]
    assert [r.num_trees for r in rw] == [8, 12, 16]
    prefix = rw[1].booster.models[:8]
    np.testing.assert_array_equal(
        rw[0].booster.models[2].split_feature[:14],
        prefix[2].split_feature[:14])


def test_per_window_policy_callable():
    pol = {0: "fresh", 1: "refit", 2: "warm"}
    pipe = RetrainPipeline(PARAMS, window_policy=lambda w: pol[w],
                           warm_iterations=2, rebin_on_drift=False,
                           serve=False)
    res = pipe.run(range(3), _dense_prep(120))
    assert [r.policy for r in res] == ["fresh", "refit", "warm"]
    assert [r.num_trees for r in res] == [8, 8, 10]


def _csr_prep(cls):
    def prep(w):
        rng = np.random.default_rng(140 + w)
        x = sp.random(2500, 12, density=0.3, random_state=rng,
                      data_rvs=lambda k: rng.exponential(2.0, k)).tocsr()
        y = (np.asarray(x[:, :3].sum(axis=1)).ravel() > 1.5).astype(
            np.float64)
        csr = (x.indptr, x.indices, x.data, x.shape[1])
        return cls(label=y, csr=csr, eval_csr=csr, eval_label=y)
    return prep


def _err(pred, pw):
    return {"err": float(np.mean((np.asarray(pred) >= 0.5)
                                 != (pw.eval_label >= 0.5)))}


def test_csr_prep_and_eval_through_server():
    pipe = RetrainPipeline(PARAMS, eval_chunk_rows=1024)
    res = pipe.run(range(3), _csr_prep(PreppedWindow), eval_fn=_err)
    assert res[0].eval_metrics is None
    assert res[1].eval_metrics["err"] < 0.2
    assert res[2].swap_same_shape is not None
    assert res[1].rows == 2500
    # the same windows through the JAX package's pipeline: the same
    # flags and drift, trees that part only at a noise-level split, and a
    # served-model error as low
    jres = JRetrainPipeline(JAX_PARAMS, eval_chunk_rows=1024).run(
        range(3), _csr_prep(JPreppedWindow), eval_fn=_err)
    _assert_first_difference_is_noise(jres, res)
    for jr, tr in zip(jres[1:], res[1:]):
        assert tr.eval_metrics["err"] < 0.02 and jr.eval_metrics["err"] < 0.02


def test_bin_mapper_cache_save_load_roundtrip(tmp_path):
    cfg = Config({**PARAMS, "monotone_constraints": "1,0,-1,0,0,0,0,0"})
    cache = BinMapperCache(rebin_on_drift=False)
    x, y = _dense_window(160)
    ds0, info0 = cache.dataset_for(cfg, dense=x, label=y)
    assert info0["rebinned"]
    path = str(tmp_path / "bins.pkl")
    cache.save(path)

    x2, y2 = _dense_window(161)
    ds_a, info_a = cache.dataset_for(cfg, dense=x2, label=y2)

    fresh = BinMapperCache.load(path)
    ds_b, info_b = fresh.dataset_for(cfg, dense=x2, label=y2)
    assert not info_a["rebinned"] and not info_b["rebinned"]
    np.testing.assert_array_equal(ds_a.binned, ds_b.binned)
    assert info_b["drift"] == pytest.approx(info_a["drift"], rel=1e-9)
    np.testing.assert_array_equal(ds_b.monotone_constraints,
                                  ds_a.monotone_constraints)
    assert ds_b.monotone_constraints[0] == 1
    np.testing.assert_array_equal(ds_b.feature_penalty,
                                  ds_a.feature_penalty)


def test_bin_mapper_cache_files_cross_packages(tmp_path):
    """A cache either package saved loads in the other and bins the next
    window to the same codes with the same drift."""
    from lightgbm_tpu.config import Config as JConfig
    x, y = _dense_window(170)
    x2, y2 = _dense_window(171)
    jcache = JBinMapperCache(rebin_on_drift=False)
    jcache.dataset_for(JConfig(JAX_PARAMS), dense=x, label=y)
    tcache = BinMapperCache(rebin_on_drift=False)
    tcache.dataset_for(Config(PARAMS), dense=x, label=y)
    jcache.save(str(tmp_path / "j.pkl"))
    tcache.save(str(tmp_path / "t.pkl"))
    t_from_j = BinMapperCache.load(str(tmp_path / "j.pkl"))
    j_from_t = JBinMapperCache.load(str(tmp_path / "t.pkl"))
    ds_t, info_t = t_from_j.dataset_for(Config(PARAMS), dense=x2, label=y2)
    ds_j, info_j = j_from_t.dataset_for(JConfig(JAX_PARAMS), dense=x2,
                                        label=y2)
    np.testing.assert_array_equal(ds_t.binned, np.asarray(ds_j.binned))
    assert abs(info_t["drift"] - info_j["drift"]) <= 1e-9


def test_checkpoint_resume_byte_identical(tmp_path):
    kw = dict(window_policy="fresh", rebin_on_drift=False, serve=False)
    ref = RetrainPipeline(PARAMS, **kw)
    ref_final = ref.run(range(4), _dense_prep(200))[-1] \
        .booster.model_to_string()

    ckpt = str(tmp_path / "ckpt")
    faults.configure("pipeline.prep:at=2")
    pipe = RetrainPipeline(PARAMS, checkpoint_dir=ckpt, **kw)
    with pytest.raises(PipelineError) as ei:
        pipe.run(range(4), _dense_prep(200))
    assert ei.value.window == 2
    assert [r.window for r in ei.value.results] == [0, 1]
    faults.clear()

    calls = []
    resumed = RetrainPipeline.resume(ckpt, PARAMS, **kw)
    prep = _dense_prep(200)

    def counting_prep(w):
        calls.append(w)
        return prep(w)

    res = resumed.run(range(4), counting_prep)
    assert [r.window for r in res] == [2, 3]
    assert calls == [2, 3]
    assert res[-1].booster.model_to_string() == ref_final
    assert load_pipeline_checkpoint(ckpt).window == 3


def test_checkpoint_resume_serves_last_good_model(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    kw = dict(window_policy="fresh", rebin_on_drift=False, serve=False)
    pipe = RetrainPipeline(PARAMS, checkpoint_dir=ckpt, **kw)
    first = pipe.run(range(2), _dense_prep(220, with_eval=True))

    resumed = RetrainPipeline.resume(ckpt, PARAMS, window_policy="fresh",
                                     rebin_on_drift=False)
    assert resumed._prev is not None
    np.testing.assert_allclose(
        resumed._prev.predict(_dense_window(221)[0][:64]),
        first[-1].booster.predict(_dense_window(221)[0][:64]),
        rtol=1e-12)
    res = resumed.run(
        range(4), _dense_prep(220, with_eval=True),
        eval_fn=lambda pred, pw: {"n": len(np.asarray(pred))})
    assert res[0].window == 2 and res[0].eval_metrics is not None
    x, _ = _dense_window(221)
    np.testing.assert_allclose(
        np.asarray(resumed.server.predict(x[:64])),
        np.asarray(res[-1].booster.predict(x[:64])), rtol=1e-4,
        atol=1e-6)


def test_checkpoint_written_by_jax_resumes_in_port(tmp_path):
    """The JAX package's pipeline checkpoint (manifest, model text, bin
    cache) resumes in the port: the restored model serves, and the port
    finishes the windows with the models the JAX pipeline trains on
    them."""
    kw = dict(window_policy="fresh", rebin_on_drift=False, serve=False)
    ckpt = str(tmp_path / "jckpt")
    JRetrainPipeline(JAX_PARAMS, checkpoint_dir=ckpt, **kw).run(
        range(2), _dense_prep(230, cls=JPreppedWindow))
    resumed = RetrainPipeline.resume(ckpt, PARAMS, window_policy="fresh",
                                     rebin_on_drift=False)
    x, _ = _dense_window(231)
    jfinal = JRetrainPipeline(JAX_PARAMS, **kw).run(
        range(3), _dense_prep(230, cls=JPreppedWindow))
    np.testing.assert_allclose(np.asarray(resumed.server.predict(x)),
                               np.asarray(jfinal[1].booster.predict(x)),
                               rtol=1e-5, atol=1e-7)
    res = resumed.run(range(3), _dense_prep(230))
    assert [r.window for r in res] == [2]
    _assert_windows_match(jfinal[2:], res, x)


def test_overlap_accounting():
    serial = RetrainPipeline(PARAMS, pipelined=False, serve=False)
    serial.run(range(3), _dense_prep(180))
    assert serial.overlap_fraction == pytest.approx(0.0)

    piped = RetrainPipeline(PARAMS, pipelined=True, serve=False)
    piped.run(range(3), _dense_prep(180))
    assert piped.overlap_fraction is not None
    assert piped.overlap_fraction > 0.2


@pytest.mark.parametrize("policy", ["fresh", "warm"])
def test_dropped_boosters_hand_their_grower_on(policy):
    """Under ``keep_boosters=False`` the previous window's booster hands
    its grower back before the next window trains: one grower serves
    every window (one cache miss, then hits), and each window's model is
    that of a run that keeps its boosters."""
    from lightgbm_tpu_torch.ops import grow
    kw = dict(window_policy=policy, warm_iterations=2,
              rebin_on_drift=False, serve=False)
    want = _model_strings(RetrainPipeline(PARAMS, **kw).run(
        range(3), _dense_prep(200)))
    grow.clear_grower_cache()
    before = dict(grow.GROWER_CACHE_COUNTS)
    texts = []
    pipe = RetrainPipeline(PARAMS, keep_boosters=False, **kw)
    res = pipe.run(range(3), _dense_prep(200), on_window=lambda r:
                   texts.append(r.booster.model_to_string()))
    assert [r.booster for r in res] == [None] * 3
    assert texts == want
    assert grow.GROWER_CACHE_COUNTS["misses"] - before["misses"] == 1
    assert grow.GROWER_CACHE_COUNTS["hits"] - before["hits"] == 2


# ----------------------------------------------------------------------
# the port's window models against the JAX package's pipeline

@pytest.mark.parametrize("policy", ["fresh", "refit", "warm"])
def test_window_models_match_jax(policy):
    kw = dict(window_policy=policy, warm_iterations=4, drift_threshold=0.1,
              serve=False)
    jres = JRetrainPipeline(JAX_PARAMS, **kw).run(
        range(3), _dense_prep(300, cls=JPreppedWindow))
    tres = RetrainPipeline(PARAMS, **kw).run(range(3), _dense_prep(300))
    _assert_windows_match(jres, tres, _dense_window(399)[0])


def test_rebinned_windows_match_jax_up_to_noise_gain_ties():
    """Labels shift at window 2 (a rebin), and 96% of its rows become
    positive.  Drift and flags agree; windows before the shift are equal
    trees; after it a tree may differ, but only from a node whose split
    gain is f32 noise in one package (ROADMAP §3)."""
    kw = dict(window_policy="fresh", drift_threshold=0.1, serve=False)
    jres = JRetrainPipeline(JAX_PARAMS, **kw).run(
        range(4), _shift_prep(JPreppedWindow))
    tres = RetrainPipeline(PARAMS, **kw).run(range(4),
                                             _shift_prep(PreppedWindow))
    assert [r.rebinned for r in tres] == [True, False, True, False]
    _assert_windows_match(jres[:2], tres[:2], _dense_window(999)[0])
    _assert_first_difference_is_noise(jres[2:], tres[2:])
