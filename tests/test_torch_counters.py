"""The port's process-wide counters under threads: the grower cache's
hits and misses (``ops/grow.py::GROWER_CACHE_COUNTS``), the stage plans
adopted from the store (``ops/grow.py::PLAN_COUNTS``), the kernel
libraries found built (``ops/build.py::COUNTS``) and the captures
(``obs/capture_track.py::COUNTS``).  The fleet's replica threads, the C
ABI's threads and the soak's tenant threads reach these paths; each bump
happens under a lock (as the JAX package's ``compile_cache.py`` counts
under its ``_LOCK``), so 8 threads bumping each counter through its real
code path read an exact total."""

import sys
import threading
import types

import pytest
import torch

from lightgbm_tpu_torch.obs import capture_track
from lightgbm_tpu_torch.ops import build, grow

THREADS = 8
ROUNDS = 400


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fast_switches():
    """Switch threads as often as the interpreter allows, so a bump that
    is not atomic would interleave."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(old)


def _hammer(fn) -> None:
    start = threading.Barrier(THREADS)
    errors = []

    def worker():
        try:
            start.wait()
            for _ in range(ROUNDS):
                fn()
        except BaseException as e:   # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)


def test_capture_counts_exact_under_threads():
    before = capture_track.COUNTS["captures"]
    _hammer(lambda: capture_track.record("probe", "()", 0.0, 0.0))
    assert capture_track.COUNTS["captures"] - before == THREADS * ROUNDS


def test_build_counts_exact_under_threads(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    out = build.library_path("wave_hist")
    out.write_bytes(b"")          # a library found built: no nvcc
    before = dict(build.COUNTS)
    _hammer(lambda: build.start_build("wave_hist"))
    assert build.COUNTS["found"] - before["found"] == THREADS * ROUNDS
    assert build.COUNTS["built"] == before["built"]


def test_plan_counts_exact_under_threads(monkeypatch):
    sp = grow.stage_plan_mod
    monkeypatch.setattr(sp, "cached_plan", lambda sig: None)
    monkeypatch.setattr(sp, "load_plan", lambda sig, store: [(4, None)])
    monkeypatch.setattr(sp, "cache_plan", lambda sig, plan: None)
    monkeypatch.setattr(sp, "store_dir", lambda config: "store")
    config = types.SimpleNamespace(wave_plan="auto")
    before = grow.PLAN_COUNTS["persisted_loads"]

    def adopt():
        assert grow.resolve_stage_plan(("sig",), config, 100) == \
            ([(4, None)], "persisted")

    _hammer(adopt)
    assert grow.PLAN_COUNTS["persisted_loads"] - before == \
        THREADS * ROUNDS


def test_grower_cache_counts_exact_under_threads(monkeypatch):
    """Every acquisition is one hit or one miss: the two counters sum to
    the acquisitions exactly, whatever the interleaving."""

    class Stub:
        def __init__(self, *args, **kwargs):
            pass

        def adopt(self, *args, **kwargs):
            pass

    class Owner:
        pass

    monkeypatch.setattr(grow, "DeviceGrower", Stub)
    monkeypatch.setattr(grow, "plan_signature", lambda *a: ("sig",))
    monkeypatch.setattr(grow, "resolve_stage_plan",
                        lambda sig, config, n: ([(4, None)], "default"))
    monkeypatch.setattr(grow, "grower_key", lambda *a, **k: ("key",))
    monkeypatch.setattr(grow, "_GROWER_CACHE", type(grow._GROWER_CACHE)())
    config = types.SimpleNamespace(grower_cache=True)
    dataset = types.SimpleNamespace(num_data=100)
    before = dict(grow.GROWER_CACHE_COUNTS)

    def acquire():
        # the owner dies at once: its grower goes back to the cache idle
        grow.acquire_grower(dataset, config, "cpu", None, Owner())

    _hammer(acquire)
    hits = grow.GROWER_CACHE_COUNTS["hits"] - before["hits"]
    misses = grow.GROWER_CACHE_COUNTS["misses"] - before["misses"]
    assert hits + misses == THREADS * ROUNDS
    assert hits > 0 and misses > 0
