"""Warm-up, the build cache and the grower cache of the port
(``warmup.py``, ``compile_cache.py``, ``ops/grow.py``'s grower cache) on
the CPU: ``test_coldstart.py``'s warm-up cases re-pointed at the port
(the zero-miss probe becomes a zero-capture one: a booster of the warmed
key takes the warmed grower), the grower cache against
``grower_cache=false`` (byte-equal model texts over three windows with
bagging and feature_fraction, fused and per iteration), misses on
different keys, its LRU bound, and the build directory that
``compile_cache_dir`` / ``LGBM_TPU_COMPILE_CACHE`` names."""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import LightGBMError, compile_cache
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import build, grow
from lightgbm_tpu_torch.warmup import (_synth_dataset, _warmup_iters,
                                       run_warmup, warmup_serve,
                                       warmup_train)

BASE = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
        "min_data_in_leaf": 5, "verbosity": -1, "device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_grower_cache():
    compile_cache.clear()
    yield
    compile_cache.clear()


def _window(seed, n=1500, nf=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nf))
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.standard_normal(n)
         > 0).astype(np.float64)
    return x, y


def _hits_misses():
    return (grow.GROWER_CACHE_COUNTS["hits"],
            grow.GROWER_CACHE_COUNTS["misses"])


def test_warmup_iters_schedule():
    assert _warmup_iters(50, 25) == 25          # divides: one chunk
    assert _warmup_iters(7, 3) == 4             # chunk + remainder
    assert _warmup_iters(2, 0) == 2             # per-iteration only
    assert _warmup_iters(2, 20) == 2            # fewer iters than chunk


def test_warmup_train_then_zero_capture_probe():
    """The warmed grower waits idle in the cache; a booster of the same
    declared shape takes it (a hit: its graphs replay, nothing is
    captured) and trains the model a fresh grower trains."""
    params = {**BASE, "num_iterations": 2, "fused_chunk": 2,
              "device_growth": "on"}
    report = warmup_train(1100, 6, params=params)
    assert report["rows"] == 1100
    assert report["row_bucket"] == 2048
    assert report["device_growth"] is True
    assert report["iterations_run"] == 2
    assert report["cache_misses"] == 0 and report["captures"] == 0
    assert grow.cached_growers() == 1
    h, m = _hits_misses()
    cfg = Config(params)
    from lightgbm_tpu_torch.boosting import create_boosting
    g = create_boosting(cfg)
    g.init_train(_synth_dataset(1100, 6, cfg))
    assert _hits_misses() == (h + 1, m)
    g.train_chunked(2, chunk=2)
    fresh = create_boosting(Config({**params, "grower_cache": False}))
    fresh.init_train(_synth_dataset(1100, 6, cfg))
    fresh.train_chunked(2, chunk=2)
    assert g.model_to_string().split("parameters:")[0] == \
        fresh.model_to_string().split("parameters:")[0]


def test_warmup_serve_runs_the_declared_buckets():
    report = warmup_serve([64, 1000], 4, params={**BASE,
                                                 "num_iterations": 2})
    assert report["row_buckets"] == [128, 1024]
    assert report["programs"] == 2
    default = warmup_serve([], 4, params={**BASE, "num_iterations": 2,
                                          "device_predict_min_rows": 4096})
    assert default["row_buckets"] == [128, 1024, 4096, 8192]


def test_run_warmup_requires_declaration():
    with pytest.raises(LightGBMError, match="declared shape"):
        run_warmup(Config({"verbosity": -1, "device": "cpu"}))


@pytest.mark.parametrize("fused", [True, False])
def test_reused_grower_trains_the_uncached_models(fused):
    """Three windows of the fork's sampling (bagging every 2 iterations,
    feature_fraction), each a new booster whose predecessor was dropped:
    windows 1-2 take window 0's grower, and every model text equals the
    one a fresh grower (``grower_cache=false``) trains, byte for byte."""
    params = {**BASE, "bagging_freq": 2, "bagging_fraction": 0.7,
              "feature_fraction": 0.8, "fused_chunk": 4 if fused else 1}

    def run(cache):
        texts = []
        h0, m0 = _hits_misses()
        for w in range(3):
            x, y = _window(w)
            b = lt.train({**params, "grower_cache": cache,
                          "seed": 7 + w}, lt.Dataset(x, label=y),
                         num_boost_round=6)
            texts.append(b.model_to_string())
            del b
        h1, m1 = _hits_misses()
        return texts, h1 - h0, m1 - m0

    cached, hits, misses = run(True)
    assert (hits, misses) == (2, 1)
    fresh, hits, misses = run(False)
    assert (hits, misses) == (0, 0)
    for a, b in zip(cached, fresh):
        assert a.replace("[grower_cache: 1]", "[grower_cache: 0]") \
            .replace("[grower_cache: True]", "[grower_cache: False]") == b


def test_live_boosters_never_share_and_different_keys_miss():
    x, y = _window(0)
    a = lt.Booster(BASE, lt.Dataset(x, label=y))
    h, m = _hits_misses()
    b = lt.Booster(BASE, lt.Dataset(x, label=y))   # a is alive: a miss
    assert _hits_misses() == (h, m + 1)
    assert a._gbdt._grower is not b._gbdt._grower
    g_a = a._gbdt._grower
    a._gbdt.release_grower()
    assert a._gbdt._grower is None
    c = lt.Booster(BASE, lt.Dataset(x, label=y))   # a's, now idle
    assert c._gbdt._grower is g_a and _hits_misses() == (h + 1, m + 1)
    for other in ({**BASE, "num_leaves": 5},            # the config
                  {**BASE, "max_bin": 31}):             # the groups' bins
        lt.Booster(other, lt.Dataset(x, label=y))
    x2, y2 = _window(1, n=1400)
    lt.Booster(BASE, lt.Dataset(x2, label=y2))          # the rows
    assert _hits_misses() == (h + 1, m + 4)


def test_grower_cache_lru_eviction(monkeypatch):
    """Past its bound the cache drops its oldest grower; the newest stay
    and are reused."""
    monkeypatch.setattr(grow, "GROWER_CACHE_MAX", 3)
    x, y = _window(0)
    first = lt.Booster({**BASE, "num_leaves": 3}, lt.Dataset(x, label=y))
    g_first = first._gbdt._grower
    del first
    for leaves in (4, 5, 6):
        lt.Booster({**BASE, "num_leaves": leaves}, lt.Dataset(x, label=y))
    assert grow.cached_growers() == 3
    again = lt.Booster({**BASE, "num_leaves": 3}, lt.Dataset(x, label=y))
    assert again._gbdt._grower is not g_first       # evicted: rebuilt
    h, m = _hits_misses()
    lt.Booster({**BASE, "num_leaves": 6}, lt.Dataset(x, label=y))
    assert _hits_misses() == (h + 1, m)              # newest: a hit
    assert compile_cache.clear() == 3
    assert grow.cached_growers() == 0


def test_rollback_on_a_reused_grower():
    x, y = _window(3)
    lt.train(BASE, lt.Dataset(x, label=y), num_boost_round=2)
    b = lt.Booster(BASE, lt.Dataset(x, label=y))
    for _ in range(3):
        b.update()
    b.rollback_one_iter()
    ref = lt.Booster({**BASE, "grower_cache": False},
                     lt.Dataset(x, label=y))
    for _ in range(2):
        ref.update()
    cut = lambda s: s.split("parameters:")[0]
    assert cut(b.model_to_string()) == cut(ref.model_to_string())


def test_compile_cache_names_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    assert compile_cache.configure(None) is None
    assert compile_cache.configure("off") is None
    path = compile_cache.configure(str(tmp_path / "kernels"))
    assert path == str(tmp_path / "kernels")
    assert compile_cache.cache_dir() == path
    assert build.library_path("wave_hist").parent == tmp_path / "kernels"
    cfg = Config({"compile_cache_dir": str(tmp_path / "p"),
                  "device": "cpu"})
    assert compile_cache.configure_from_config(cfg) == str(tmp_path / "p")
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    assert compile_cache.configure_from_env() == str(tmp_path / "env")
    # a library already at its digest name is found, not built
    out = build.library_path("wave_hist")
    out.write_bytes(b"")
    found = build.COUNTS["found"]
    proc, where = build.start_build("wave_hist")
    assert proc is None and where == out
    assert build.COUNTS["found"] == found + 1
    assert set(compile_cache.counters()) == {"misses", "hits", "captures"}
    assert "grower_cache" not in lt.config.IGNORED_PARAMS
    assert "compile_cache_dir" not in lt.config.IGNORED_PARAMS
