"""The wave-stage plan of the port (``ops/stage_plan.py``,
``DeviceGrower.profile_stage_plan``, the plan's route in
``boosting/gbdt.py``) against the JAX package's:

* ``tests/test_stage_plan.py``'s cases re-pointed at the port (its fallback
  constants are the card's, the one pinned difference);
* every pure function equal to the JAX package's on the same inputs, over
  a grid of leaf budgets, stat columns, widths and costs: plans,
  digests, costs, wave counts and fits byte-equal;
* the store beside the compile cache: the round trip, corrupt and foreign
  files refused, the file name the same under any PYTHONHASHSEED, and a
  persisted plan adopted under ``wave_plan=auto`` (``plan_source``
  "persisted", nothing measured);
* the plan's digest in ``grower_key``: two boosters of equal config, one
  built before a plan was installed and one after, never share a grower;
  a plan installed on a cached grower re-keys it;
* the trees under an explicit non-legacy plan equal to the JAX device
  grower's under the same plan;
* ``profile_stage_plan`` on the CPU (the plain version of kernel 1 timed
  by the host clock): its spans, timings and gauges through ``obs``, the
  plan installed and adopted by a second booster with no new profile,
  ``auto``'s 2% bar, and ``auto`` measuring only with a store and from
  ``AUTO_PROFILE_MIN_ROWS`` rows.
"""

import contextlib
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu.ops import stage_plan as jsp
from lightgbm_tpu_torch import compile_cache, obs
from lightgbm_tpu_torch.ops import build
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import stage_plan as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
        "min_data_in_leaf": 5, "verbose": -1}


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
    return x, pd.make_labels(x)[0]


@pytest.fixture(autouse=True)
def _kernel_dir():
    """A booster that names a compile cache moves the process-wide kernel
    directory; each test ends in the package's default one."""
    prev = build.BUILD_DIR
    yield
    build.BUILD_DIR = prev


def _cc(tmp_path):
    """Params naming a compile cache directory (and so a plan store)
    under ``tmp_path``."""
    return {"compile_cache_dir": str(tmp_path / "cc")}


@pytest.fixture(autouse=True)
def _fresh_growers():
    tgrow.clear_grower_cache()
    yield
    tgrow.clear_grower_cache()


def _tparams(extra=None):
    return {**BASE, "device": "cpu", **(extra or {})}


# ----------------------------------------------------------------------
# tests/test_stage_plan.py, re-pointed at the port

def test_legacy_plan_matches_historical_doubling():
    assert sp.legacy_stage_plan(255, 128, 3) == [
        (4, 8), (16, 32), (32, 64), (64, 128), (128, None)]
    assert sp.legacy_stage_plan(255, 76, 5) == [
        (4, 8), (16, 32), (19, 64), (38, 128), (76, None)]
    assert sp.legacy_stage_plan(15, 14, 3) == [(4, 8), (14, None)]


def test_plan_cost_counts_frontier_limited_waves():
    cost, waves = sp.plan_cost([(128, None)], 255, 3, 10.0, 0.1)
    assert waves == 8
    legacy = sp.legacy_stage_plan(255, 128, 3)
    cost_l, waves_l = sp.plan_cost(legacy, 255, 3, 10.0, 0.1)
    assert waves_l == 8 and cost_l < cost
    _, waves_n = sp.plan_cost([(4, 128), (128, None)], 255, 3, 10.0, 0.1)
    assert waves_n > 8


def test_derive_prefers_wide_when_fixed_dominates():
    flat = {w: 100.0 for w in (4, 8, 16, 32, 64, 128)}
    assert sp.derive_stage_plan(255, 128, 3, 100.0, 1e-4,
                                measured_ms=flat) == [(128, None)]
    plan2 = sp.derive_stage_plan(255, 128, 3, fixed_ms=1e-3, col_ms=1.0)
    assert len(plan2) > 1
    assert sp.plan_cost(plan2, 255, 3, 1e-3, 1.0)[0] \
        < sp.plan_cost([(128, None)], 255, 3, 1e-3, 1.0)[0]


def test_fit_wave_costs_recovers_linear_model():
    widths = [4, 8, 16, 32, 64, 128]
    ms = [12.0 + 0.25 * w * 3 for w in widths]
    np.testing.assert_allclose(sp.fit_wave_costs(widths, ms, 3),
                               [12.0, 0.25], rtol=1e-6)
    # a degenerate probe falls back to the card's constants (the JAX
    # package's are a TPU's: the one pinned difference)
    assert sp.fit_wave_costs([4], [1.0], 3) == (sp.DEFAULT_FIXED_MS,
                                                sp.DEFAULT_COL_MS)
    np.testing.assert_allclose(
        sp.fit_wave_costs([4], [1.0], 3, num_data=sp.REF_ROWS // 2),
        [sp.DEFAULT_FIXED_MS / 2, sp.DEFAULT_COL_MS / 2])
    assert (sp.DEFAULT_FIXED_MS, sp.DEFAULT_COL_MS, sp.REF_ROWS) != \
        (jsp.DEFAULT_FIXED_MS, jsp.DEFAULT_COL_MS, jsp.REF_ROWS)


def test_plan_digest_stable_and_cache_roundtrip():
    plan = [(4, 8), (128, None)]
    assert sp.plan_digest(plan) == sp.plan_digest([[4, 8], [128, None]])
    assert sp.plan_digest(plan) != sp.plan_digest([(8, 16), (128, None)])
    sig = ("torch-test-sig", 1, 2)
    assert sp.cached_plan(sig) is None
    sp.cache_plan(sig, plan)
    assert sp.cached_plan(sig) == [(4, 8), (128, None)]
    sp.forget_plan(sig)


def test_derive_beats_legacy_gate():
    legacy = sp.legacy_stage_plan(255, 128, 3)
    floor = {4: 150.0, 8: 150.0, 16: 150.0, 32: 150.0, 64: 150.0,
             128: 100.0}
    assert sp.plan_beats([(128, None)], legacy, 255, 3, 100.0, 1e-4,
                         measured_ms=floor)
    flat = {w: 100.0 for w in (4, 8, 16, 32, 64, 128)}
    assert not sp.plan_beats([(128, None)], legacy, 255, 3, 100.0, 1e-4,
                             measured_ms=flat)
    assert not sp.plan_beats([(128, None)], legacy, 255, 3, 1e-3, 1.0)
    assert not sp.plan_beats(legacy, legacy, 255, 3, 10.0, 0.1)


def test_gain_must_clear_the_probe_spread():
    """The wide plan of ``test_derive_beats_legacy_gate``'s floor beats
    the ladder by far more than 2%; ``auto`` takes it only while it still
    does with its probes at their slowest and the ladder's at their
    fastest."""
    legacy = sp.legacy_stage_plan(255, 128, 3)
    wide = [(128, None)]
    lo = {4: 140.0, 8: 140.0, 16: 140.0, 32: 140.0, 64: 140.0, 128: 90.0}
    hi = {w: v + 20.0 for w, v in lo.items()}
    assert sp.plan_beats_spread(wide, legacy, 255, lo, hi)
    assert not sp.plan_beats_spread(wide, legacy, 255, lo,
                                    {**hi, 128: 1000.0})
    assert not sp.plan_beats_spread(legacy, legacy, 255, lo, hi)
    # no spread: plan_beats at those times, the JAX package's bar
    for a, b in ((wide, legacy), (legacy, legacy), (legacy, wide)):
        assert sp.plan_beats_spread(a, b, 255, lo, lo) == sp.plan_beats(
            a, b, 255, 3, 100.0, 1e-4, measured_ms=lo)
    # a gain above 2% at the medians but not at the worst case: kept out
    med = {4: 150.0, 8: 150.0, 16: 150.0, 32: 150.0, 64: 150.0,
           128: 146.0}
    c_wide, _ = sp.plan_cost_fn(wide, 255, med.__getitem__)
    c_leg, _ = sp.plan_cost_fn(legacy, 255, med.__getitem__)
    assert c_wide < 0.98 * c_leg
    assert sp.plan_beats([(128, None)], legacy, 255, 3, 100.0, 1e-4,
                         measured_ms=med)
    assert not sp.plan_beats_spread(
        wide, legacy, 255, {w: v - 2.0 for w, v in med.items()},
        {w: v + 2.0 for w, v in med.items()})


def test_plan_persistence_roundtrip(tmp_path, monkeypatch):
    sig = ("persist-sig", 4096, 3, 64, False, "digest")
    plan = [(4, 8), (16, 32), (128, None)]
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert sp.store_dir(tlgb.Config({})) is None
    assert sp.save_plan(sig, plan, None) is None
    store = sp.store_dir(tlgb.Config(_cc(tmp_path)))
    assert store == str(tmp_path / "cc" / "stage_plans")
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
    assert sp.store_dir(tlgb.Config({})) == store
    assert sp.store_dir(tlgb.Config({"compile_cache_dir": "off"})) is None
    assert sp.load_plan(sig, store) is None
    path = sp.save_plan(sig, plan, store)
    assert os.path.exists(path) and sp.load_plan(sig, store) == plan
    sp.cache_plan(sig + ("v2",), plan, store)
    assert sp.load_plan(sig + ("v2",), store) == plan
    sp.cache_plan(sig + ("v3",), plan)
    assert sp.load_plan(sig + ("v3",), store) is None
    payload = json.load(open(path))
    payload["plan"] = [[8, 16], [128, None]]      # a stale digest
    json.dump(payload, open(path, "w"))
    assert sp.load_plan(sig, store) is None
    sp.save_plan(sig, plan, store)
    payload = json.load(open(path))
    payload["signature"] = "something else"
    json.dump(payload, open(path, "w"))
    assert sp.load_plan(sig, store) is None
    open(path, "w").write("{not json")
    assert sp.load_plan(sig, store) is None
    sp.save_plan(sig, plan, store)
    sp.cache_plan(sig, plan)
    sp.forget_plan(sig, store)
    assert sp.cached_plan(sig) is None and sp.load_plan(sig, store) is None
    for s in (sig + ("v2",), sig + ("v3",)):
        sp.forget_plan(s, store)


def test_persisted_plan_key_stable_across_hashseeds(tmp_path):
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lightgbm_tpu_torch.ops import stage_plan as sp\n"
        "sig = ('sig', 4096, 3, 64, False, 'abc123')\n"
        f"print(json.dumps({{'path': sp._plan_path(sig, "
        f"{str(tmp_path / 'cc')!r})}}))\n")
    outs = []
    for seed in ("1", "271828"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        r = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, cwd=REPO)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1]


# ----------------------------------------------------------------------
# the pure functions, against the JAX package's

GRID = list(itertools.product((15, 31, 63, 255, 1000), (3, 4, 5, 6)))


@pytest.mark.parametrize("num_leaves,hist_cols", GRID)
def test_pure_functions_equal_jax(num_leaves, hist_cols):
    rng = np.random.default_rng(num_leaves * 10 + hist_cols)
    wave_width = min(max(int(128 * 3.0 / hist_cols), 4),
                     max(num_leaves - 1, 1))
    legacy = sp.legacy_stage_plan(num_leaves, wave_width, hist_cols)
    assert legacy == jsp.legacy_stage_plan(num_leaves, wave_width,
                                           hist_cols)
    assert sp._ladder(wave_width) == jsp._ladder(wave_width)
    widths = sorted({w for w, _ in legacy} | set(sp._ladder(wave_width))
                    | {wave_width})
    for trial in range(4):
        fixed, col = rng.uniform(0.01, 20.0), rng.uniform(1e-5, 0.5)
        measured = None if trial == 0 else {
            w: float(rng.uniform(0.1, 30.0)) for w in widths
            if rng.random() < 0.8}
        for packing in (True, False):
            a = sp.derive_stage_plan(num_leaves, wave_width, hist_cols,
                                     fixed, col, measured_ms=measured,
                                     frontier_packing=packing)
            b = jsp.derive_stage_plan(num_leaves, wave_width, hist_cols,
                                      fixed, col, measured_ms=measured,
                                      frontier_packing=packing)
            assert a == b and sp.plan_digest(a) == jsp.plan_digest(b)
        for plan in (legacy, a, [(wave_width, None)]):
            assert sp.plan_cost(plan, num_leaves, hist_cols, fixed, col) \
                == jsp.plan_cost(plan, num_leaves, hist_cols, fixed, col)
            ws = sp.wave_cost_fn(hist_cols, fixed, col, measured)
            wj = jsp.wave_cost_fn(hist_cols, fixed, col, measured)
            assert sp.plan_cost_fn(plan, num_leaves, ws) \
                == jsp.plan_cost_fn(plan, num_leaves, wj)
            assert sp.plan_dispatches(plan, num_leaves) \
                == jsp.plan_dispatches(plan, num_leaves, fused=True)
            assert sp.plan_beats(plan, legacy, num_leaves, hist_cols, fixed,
                                 col, measured_ms=measured) \
                == jsp.plan_beats(plan, legacy, num_leaves, hist_cols,
                                  fixed, col, measured_ms=measured)
        ms = [fixed + col * w * hist_cols + rng.normal(0, 0.01)
              for w in widths]
        if len(widths) >= 2 and sp.fit_wave_costs(widths, ms, hist_cols)[1] \
                != sp.DEFAULT_COL_MS:
            assert sp.fit_wave_costs(widths, ms, hist_cols) \
                == jsp.fit_wave_costs(widths, ms, hist_cols)
    assert sp.MIN_IMPROVEMENT == jsp.MIN_IMPROVEMENT == 0.02
    assert sp.AUTO_PROFILE_MIN_ROWS == jsp.AUTO_PROFILE_MIN_ROWS


# ----------------------------------------------------------------------
# the grower: resolution, keys, profiles

def _booster(x, y, extra=None):
    return tlgb.Booster(_tparams(extra),
                        tlgb.Dataset(x, y, params=_tparams(extra)))


def test_auto_grower_adopts_persisted_plan(data, tmp_path):
    x, y = data
    sig = _booster(x, y)._gbdt._grower.signature
    custom = [(8, 16), (30, None)]
    cc = _cc(tmp_path)
    store = sp.store_dir(tlgb.Config(cc))
    try:
        sp.forget_plan(sig, store)
        sp.save_plan(sig, custom, store)
        loads = tgrow.PLAN_COUNTS["persisted_loads"]
        profiles = tgrow.PLAN_COUNTS["profiles"]
        g = _booster(x, y, cc)._gbdt._grower
        assert (g.stage_plan, g.plan_source) == (custom, "persisted")
        assert tgrow.PLAN_COUNTS["persisted_loads"] == loads + 1
        # profiled adopts it too, measuring nothing
        g2 = _booster(x, y, {**cc, "wave_plan": "profiled"})._gbdt._grower
        assert g2.stage_plan == custom
        assert tgrow.PLAN_COUNTS["profiles"] == profiles
        # a corrupt file, once forgotten in the process, gives the ladder
        sp.forget_plan(sig)
        open(sp.save_plan(sig, custom, store), "w").write("garbage")
        g3 = _booster(x, y, cc)._gbdt._grower
        assert g3.plan_source == "default"
        assert g3.stage_plan == tgrow.default_stage_plan(len(y), g3.config)
    finally:
        sp.forget_plan(sig, store)
    # fixed ignores a plan in the process cache
    sp.cache_plan(sig, custom)
    try:
        g4 = _booster(x, y, {"wave_plan": "fixed"})._gbdt._grower
        assert g4.plan_source == "default" and g4.stage_plan != custom
    finally:
        sp.forget_plan(sig)


def test_plan_store_follows_the_booster_config(data, tmp_path, monkeypatch):
    """A booster that names a compile cache moves the process-wide kernel
    directory, but a later booster that names none has no plan store: it
    neither adopts the stored plan nor measures under ``auto``."""
    x, y = data
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setattr(sp, "AUTO_PROFILE_MIN_ROWS", 1000)
    cc = _cc(tmp_path)
    store = sp.store_dir(tlgb.Config(cc))
    custom = [(8, 16), (30, None)]
    b = _booster(x, y, {**cc, "wave_plan": "fixed"})
    sig = b._gbdt._grower.signature
    assert str(build.BUILD_DIR) == cc["compile_cache_dir"]
    assert compile_cache.artifact_dir("stage_plans", b._gbdt.config) \
        == store
    try:
        sp.save_plan(sig, custom, store)
        profiles = tgrow.PLAN_COUNTS["profiles"]
        g = _booster(x, y)._gbdt._grower
        assert g.plan_source == "default" and g.stage_plan != custom
        assert tgrow.PLAN_COUNTS["profiles"] == profiles
        assert _booster(x, y, cc)._gbdt._grower.stage_plan == custom
    finally:
        sp.forget_plan(sig, store)


def test_plan_digest_in_grower_key(data):
    """Booster A (legacy plan) trains and is dropped; a plan is installed
    for the signature; booster B of A's config does not take A's idle
    grower, and a plan installed on a cached grower re-keys it."""
    x, y = data
    a = _booster(x, y)
    a.update()
    grower_a, sig = a._gbdt._grower, a._gbdt._grower.signature
    legacy = list(grower_a.stage_plan)
    del a
    custom = [(8, 16), (30, None)]
    sp.cache_plan(sig, custom)
    try:
        b = _booster(x, y)
        assert b._gbdt._grower is not grower_a
        assert b._gbdt._grower.stage_plan == custom
        assert tgrow._GROWER_CACHE[id(b._gbdt._grower)][0][-1] \
            == sp.plan_digest(custom)
        b.update()
        b._gbdt._grower.install_plan(legacy)
        assert tgrow._GROWER_CACHE[id(b._gbdt._grower)][0][-1] \
            == sp.plan_digest(legacy)
        assert b._gbdt._grower._graphs is None
    finally:
        sp.forget_plan(sig)


def test_trees_under_a_plan_equal_jax(data):
    x, y = data
    # a narrow early stage: more waves than the ladder, another order
    plan = [(4, 16), (30, None)]
    jp = {**BASE, "device_growth": "on"}
    jb0 = jlgb.Booster(jp, jlgb.Dataset(x, y, params=jp))
    jsig = jb0._gbdt._grower._base_signature
    tsig = _booster(x, y)._gbdt._grower.signature
    jsp.cache_plan(jsig, plan, persist=False)
    sp.cache_plan(tsig, plan)
    try:
        jb = jlgb.train(jp, jlgb.Dataset(x, y, params=jp), 4,
                        verbose_eval=False)
        tb = tlgb.train(_tparams(), tlgb.Dataset(x, y), 4,
                        verbose_eval=False)
        assert jb._gbdt._grower.stage_plan == plan
        assert tb._gbdt._grower.stage_plan == plan
        legacy = tlgb.train(_tparams({"wave_plan": "fixed"}),
                            tlgb.Dataset(x, y), 4, verbose_eval=False)
    finally:
        jsp.forget_plan(jsig)
        sp.forget_plan(tsig)
    from test_torch_engine_api import _assert_same_trees
    _assert_same_trees(jb, tb, x)
    waves = lambda b: [w for _, _, w, _ in b._gbdt.tree_stats]
    assert waves(tb) != waves(legacy)


def test_profile_stage_plan_records_and_installs(data, monkeypatch):
    x, y = data
    monkeypatch.setattr(tgrow, "PROBE_REPS", 1)
    obs.reset()
    obs.configure(enabled=True)
    try:
        b1 = _booster(x, y)
        g = b1._gbdt._grower
        sp.forget_plan(g.signature)
        assert g.plan_source == "default"
        before = tgrow.PLAN_COUNTS["profiles"]
        out = g.profile_stage_plan()
        assert out["profiled"] and tgrow.PLAN_COUNTS["profiles"] == before + 1
        widths = sorted(out["stage_ms"])
        assert widths == [4, 8, 16, 30]
        assert sorted(out["residual_ms"]) == widths
        assert out["plan"][-1] == (30, None)
        assert g.stage_plan == out["plan"] and g.plan_source == "profiled"
        snap = obs.snapshot()
        assert snap["counters"]["grow.plan_profiles"] == 1
        for w in widths:
            assert f"grow.stage.w{w}_ms" in snap["gauges"]
            assert snap["timings"][f"grow.stage.w{w}"]["count"] == 1
        assert "grow.hist.wave_hist_k3_bf16" in snap["timings"]
        assert {"grow.stage.fixed_ms", "grow.stage.col_ms"} \
            <= set(snap["gauges"])
        probes = [e.args for e in obs.STATE.trace._copy()
                  if e.name == "grow.stage_probe"]
        assert probes == [{"width": w, "hist_cols": 3} for w in widths]
        # measured once: a second profile, and a second booster of the
        # signature under profiled, measure nothing
        assert not g.profile_stage_plan()["profiled"]
        b2 = _booster(x, y, {"wave_plan": "profiled"})
        assert b2._gbdt._grower.stage_plan == out["plan"]
        assert tgrow.PLAN_COUNTS["profiles"] == before + 1
        for _ in range(2):
            b2.update()
        assert b2.num_trees() == 2
    finally:
        sp.forget_plan(b1._gbdt._grower.signature)
        obs.configure(enabled=False)
        obs.reset()


def test_auto_measures_only_with_a_store_and_at_scale(data, tmp_path,
                                                      monkeypatch):
    x, y = data
    profiles = tgrow.PLAN_COUNTS["profiles"]
    g = _booster(x, y)._gbdt._grower
    sp.forget_plan(g.signature)
    assert tgrow.PLAN_COUNTS["profiles"] == profiles     # below the rows
    monkeypatch.setattr(sp, "AUTO_PROFILE_MIN_ROWS", 1000)
    g = _booster(x, y)._gbdt._grower
    assert tgrow.PLAN_COUNTS["profiles"] == profiles     # no store
    cc = _cc(tmp_path)
    store = sp.store_dir(tlgb.Config(cc))
    b = _booster(x, y, cc)
    g = b._gbdt._grower
    assert tgrow.PLAN_COUNTS["profiles"] == profiles + 1
    assert g.plan_source == "profiled"
    assert set(b._gbdt.plan_profile["spread_ms"]) \
        == set(b._gbdt.plan_profile["stage_ms"])
    # the verdict is kept whether or not it beat the ladder
    assert sp.load_plan(g.signature, store) == g.stage_plan
    legacy = tgrow.default_stage_plan(len(y), g.config)
    derived = [(30, None)]
    monkeypatch.setattr(sp, "derive_stage_plan", lambda *a, **k:
                        list(derived))
    for beats, want in ((False, legacy), (True, derived)):
        # the derived plan is taken only past the 2% bar at the probes'
        # worst case (an idle cached grower keeps its measured plan: drop
        # it too)
        sp.forget_plan(g.signature, store)
        tgrow.clear_grower_cache()
        monkeypatch.setattr(sp, "plan_beats_spread", lambda *a, **k: beats)
        g2 = _booster(x, y, cc)._gbdt._grower
        assert g2.stage_plan == want
        assert sp.load_plan(g2.signature, store) == want
    sp.forget_plan(g2.signature, store)
