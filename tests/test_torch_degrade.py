"""The degrade-to-host path of the port's servers (``serve/engine.py``,
``serve/fleet.py``) against the JAX package's, on the CPU:

* under ``serve.dispatch`` / ``serve.fleet.dispatch`` the degraded
  answers equal the JAX servers' degraded answers on the same trees (both
  the host ``Tree`` walk in float64);
* one scripted request sequence on an injected clock gives the JAX
  server's counter and gauge sequence step for step (``serve.ok``,
  ``serve.fallback_requests``, ``serve.device_failures``,
  ``serve.failed``, ``serve.input_errors``, the ``serve.degraded`` gauge,
  the ``serve.degraded_time`` timing; per replica in the fleet, with the
  ``serve.fleet.degraded_replicas`` anchor at 0);
* the breaker's lifecycle: trip, dark seconds, one probe a re-probe
  interval, recovery;
* input errors never count against the device, nor reach the fallback;
* a kernel library that does not build raises and never degrades; nor
  does a real launch error (a CUDA error, a bug in the wrapper), even
  under ``host_fallback=True``: only the injected dispatch fault
  degrades; ``host_fallback=False`` raises the injected fault too.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu import obs as jobs
from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
from lightgbm_tpu.obs.state import STATE as JSTATE
from lightgbm_tpu.robust import faults as jfaults
from lightgbm_tpu.robust.retry import CircuitBreaker as JBreaker
from lightgbm_tpu.serve import FleetServer as JFleetServer
from lightgbm_tpu.serve import PredictionServer as JServer
from lightgbm_tpu_torch import LightGBMError, obs
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import BinnedDataset
from lightgbm_tpu_torch.obs.state import STATE
from lightgbm_tpu_torch.ops.build import KernelBuildError
from lightgbm_tpu_torch.robust import faults
from lightgbm_tpu_torch.robust.retry import CircuitBreaker
from lightgbm_tpu_torch.serve import FleetServer, PredictionServer
from lightgbm_tpu_torch.serve import engine as engine_mod
from lightgbm_tpu_torch.serve import fleet as fleet_mod

NF = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clean():
    for mod, state, fl in ((obs, STATE, faults), (jobs, JSTATE, jfaults)):
        fl.clear()
        mod.configure(enabled=False)
        mod.reset()
        state.rolling = None
        state.last_slo = None


@pytest.fixture(autouse=True)
def _clean_state():
    _clean()
    yield
    _clean()


def _booster(seed, objective="binary"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((800, NF))
    x[rng.random(x.shape) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.nan_to_num(x[:, 1]) ** 2 > 0.5) \
        .astype(np.float64)
    cfg = Config({"objective": objective, "num_leaves": 15,
                  "min_data_in_leaf": 5, "verbosity": -1, "device": "cpu"})
    ds = BinnedDataset.construct_from_matrix(x, cfg, [])
    ds.metadata.set_label(y)
    bst = create_boosting(cfg)
    bst.init_train(ds)
    for _ in range(6):
        bst.train_one_iter()
    bst._flush_pending()
    return bst


@pytest.fixture(scope="module")
def pair():
    """Two port boosters and the same trees loaded into the JAX package."""
    bsts = [_booster(s) for s in (5, 6)]
    jb = [JGBDT.load_model_from_string(b.model_to_string()) for b in bsts]
    return bsts, jb


def _query(seed, n=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, NF))
    q[rng.random(q.shape) < 0.1] = np.nan
    return q


def test_degraded_answers_equal_the_jax_servers(pair):
    bsts, jb = pair
    q = _query(1)
    srv = PredictionServer(bsts[0], device="cpu")
    jsrv = JServer(jb[0])
    healthy = srv.predict(q, raw_score=True)
    faults.configure("serve.dispatch:persist")
    jfaults.configure("serve.dispatch:persist")
    for raw in (True, False):
        got, want = srv.predict(q, raw_score=raw), jsrv.predict(
            q, raw_score=raw)
        np.testing.assert_array_equal(got, want)
    # the host walk against the kernel's plain version
    np.testing.assert_allclose(srv.predict(q, raw_score=True), healthy,
                               rtol=1e-5, atol=1e-6)
    fs = FleetServer(bsts, device="cpu", replicas=2)
    jfs = JFleetServer(jb, replicas=2)
    faults.configure("serve.fleet.dispatch:persist")
    jfaults.configure("serve.fleet.dispatch:persist")
    tid = np.arange(len(q)) % 2
    for raw in (True, False):
        np.testing.assert_array_equal(fs.predict(tid, q, raw_score=raw),
                                      jfs.predict(tid, q, raw_score=raw))


SERVER_KEYS = ("serve.ok", "serve.fallback_requests", "serve.device_failures",
               "serve.failed", "serve.input_errors", "serve.requests")


def _state(mod, keys, gauges, timing):
    reg = mod.registry()
    t = reg.timing(timing)
    return (tuple(reg.counter(k) for k in keys),
            tuple(reg.gauge(g) for g in gauges),
            None if t is None else (t.count, round(t.total, 9)))


def _script(server, jserver, mod, jmod, t, q, steps, keys, gauges, timing,
            call):
    """Run ``steps`` (clock advance, data) on both servers; the states after
    every step."""
    seq, jseq = [], []
    for dt, data in steps:
        t[0] += dt
        for srv, m, out in ((server, mod, seq), (jserver, jmod, jseq)):
            try:
                call(srv, data)
                err = None
            except Exception as e:   # noqa: BLE001
                err = type(e).__name__
            out.append((err, srv.degraded if hasattr(srv, "degraded")
                        else tuple(srv.degraded_replicas()))
                       + _state(m, keys, gauges, timing))
    return seq, jseq


def test_server_counter_and_gauge_sequence_equals_the_jax_server(pair):
    bsts, jb = pair
    obs.configure(enabled=True)
    jobs.configure(enabled=True)
    t = [100.0]
    srv = PredictionServer(bsts[0], device="cpu", breaker=CircuitBreaker(
        failure_threshold=3, reprobe_interval_s=2.0, clock=lambda: t[0]))
    jsrv = JServer(jb[0], breaker=JBreaker(
        failure_threshold=3, reprobe_interval_s=2.0, clock=lambda: t[0]))
    faults.configure("serve.dispatch:after=1:n=5")
    jfaults.configure("serve.dispatch:after=1:n=5")
    q, narrow = _query(2), _query(3)[:, :2]
    steps = ([(0.5, q)] * 5 + [(0.5, narrow)] + [(0.75, q)] * 6
             + [(2.5, q), (0.5, q)])
    seq, jseq = _script(srv, jsrv, obs, jobs, t, q, steps, SERVER_KEYS,
                        ("serve.degraded", "serve.batch_rows"),
                        "serve.degraded_time",
                        lambda s, d: s.predict(d))
    assert seq == jseq
    # the sequence went dark and came back: trip, a probe that failed, the
    # recovery, and the dark time on the injected clock
    assert any(s[1] for s in seq) and not seq[-1][1]
    counts = dict(zip(SERVER_KEYS, seq[-1][2]))
    assert counts["serve.device_failures"] >= 3
    assert counts["serve.input_errors"] == 1
    assert seq[-1][4] is not None and seq[-1][4][0] == 1


FLEET_KEYS = tuple(f"serve.fleet.{k}" for k in (
    "ok", "fallback_requests", "device_failures", "failed", "input_errors",
    "requests"))


def test_fleet_counter_and_gauge_sequence_equals_the_jax_fleet(pair):
    bsts, jb = pair
    obs.configure(enabled=True)
    jobs.configure(enabled=True)
    t = [100.0]
    fs = FleetServer(bsts, device="cpu", replicas=2,
                     breaker_factory=lambda r: CircuitBreaker(
                         2, 1.0, clock=lambda: t[0]))
    jfs = JFleetServer(jb, replicas=2, breaker_factory=lambda r: JBreaker(
        2, 1.0, clock=lambda: t[0]))
    # the anchor: 0 dark replicas from the start
    assert obs.registry().gauge("serve.fleet.degraded_replicas") == 0
    faults.configure("serve.fleet.dispatch:after=2:n=4")
    jfaults.configure("serve.fleet.dispatch:after=2:n=4")
    q = _query(4)
    tid = np.arange(len(q)) % 2
    steps = [(0.3, 0), (0.3, 1), (0.3, 0), (0.3, 1), (0.3, 0), (0.3, 1),
             (0.3, 0), (1.5, 0), (0.1, 1), (1.5, 1), (0.1, 0)]

    def call(s, rep):
        return s.predict(tid, q, replica=rep)
    seq, jseq = _script(
        fs, jfs, obs, jobs, t, q, steps, FLEET_KEYS,
        ("serve.fleet.degraded_replicas", "serve.fleet.replica_degraded.0",
         "serve.fleet.replica_degraded.1"), "serve.fleet.degraded_time",
        call)
    assert seq == jseq
    assert any(s[1] for s in seq) and seq[-1][1] == ()
    assert obs.registry().counter("serve.fleet.tenant.0.rows") \
        == jobs.registry().counter("serve.fleet.tenant.0.rows")


def test_breaker_lifecycle_on_an_injected_clock(pair):
    bsts, _ = pair
    obs.configure(enabled=True)
    t = [10.0]
    br = CircuitBreaker(failure_threshold=2, reprobe_interval_s=5.0,
                        clock=lambda: t[0])
    srv = PredictionServer(bsts[0], device="cpu", breaker=br)
    q = _query(5)
    faults.configure("serve.dispatch:n=3")
    srv.predict(q)
    assert not srv.degraded
    srv.predict(q)                           # the second failure trips it
    assert srv.degraded and br.state == "open"
    assert obs.registry().gauge("serve.degraded") == 1
    t[0] += 2.0
    assert srv.dark_seconds == pytest.approx(2.0)
    calls = faults.calls().get("serve.dispatch", 0)
    srv.predict(q)                           # no probe before 5 s
    assert faults.calls().get("serve.dispatch", 0) == calls
    t[0] += 3.5
    srv.predict(q)                           # the probe: the 3rd failure
    assert srv.degraded and faults.calls()["serve.dispatch"] == calls + 1
    t[0] += 5.0
    srv.predict(q)                           # the next probe recovers
    assert not srv.degraded
    dark = obs.registry().timing("serve.degraded_time")
    assert dark.count == 1 and dark.total == pytest.approx(10.5)
    assert obs.registry().gauge("serve.degraded") == 0
    assert obs.registry().counter("serve.fallback_requests") == 4
    assert obs.registry().counter("serve.device_failures") == 3


def test_input_errors_never_count_against_the_device(pair):
    bsts, _ = pair
    obs.configure(enabled=True)
    srv = PredictionServer(bsts[0], device="cpu", breaker=CircuitBreaker(1))
    fs = FleetServer(bsts, device="cpu", breaker_factory=lambda r:
                     CircuitBreaker(1))
    faults.configure("serve.dispatch:persist,serve.fleet.dispatch:persist")
    before = dict(engine_mod.FALLBACK_COUNTS)
    for bad in (lambda: srv.predict(_query(6)[:, :2]),
                lambda: fs.predict(0, _query(6)[:, :3]),
                lambda: fs.predict(5, _query(6)),
                lambda: fs.predict(np.zeros(3), _query(6))):
        with pytest.raises(LightGBMError):
            bad()
    reg = obs.registry()
    assert reg.counter("serve.input_errors") == 1
    assert reg.counter("serve.fleet.input_errors") == 3
    for k in ("serve.device_failures", "serve.fallback_requests",
              "serve.failed", "serve.fleet.device_failures",
              "serve.fleet.fallback_requests", "serve.fleet.failed"):
        assert reg.counter(k) == 0, k
    assert not srv.degraded and fs.degraded_replicas() == []
    assert engine_mod.FALLBACK_COUNTS == before
    assert faults.calls() == {}


def test_kernel_build_failure_raises_and_never_degrades(pair, monkeypatch):
    bsts, _ = pair
    obs.configure(enabled=True)

    def broken(*a, **k):
        raise KernelBuildError("nvcc failed (1) for libforest_predict.so")
    srv = PredictionServer(bsts[0], device="cpu")
    fs = FleetServer(bsts, device="cpu")
    monkeypatch.setattr(engine_mod, "predict_scores", broken)
    monkeypatch.setattr(fleet_mod, "fleet_predict_scores", broken)
    before = dict(engine_mod.FALLBACK_COUNTS)
    for _ in range(4):
        with pytest.raises(KernelBuildError):
            srv.predict(_query(7))
        with pytest.raises(KernelBuildError):
            fs.predict(0, _query(7))
    assert not srv.degraded and fs.degraded_replicas() == []
    assert engine_mod.FALLBACK_COUNTS == before
    reg = obs.registry()
    assert reg.counter("serve.failed") == 4
    assert reg.counter("serve.fleet.failed") == 4
    assert reg.counter("serve.fallback_requests") == 0
    # on the card the library is built where the server is built
    monkeypatch.setattr(engine_mod, "_kernel_lib", broken)
    with pytest.raises(KernelBuildError):
        engine_mod.require_kernel(torch.device("cuda", 0))
    engine_mod.require_kernel(torch.device("cpu"))


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    TypeError("launch_forest() got an unexpected keyword argument")],
    ids=["cuda_error", "wrapper_bug"])
def test_real_launch_errors_raise_even_with_host_fallback(pair, monkeypatch,
                                                          error):
    """The port parts from the JAX package here: a launch error that the
    chaos harness did not inject is the card's or the code's, so both
    servers raise it under the default ``host_fallback=True``, count it as
    failed, and leave the breaker and the fallback counts alone."""
    bsts, _ = pair
    obs.configure(enabled=True)

    def launch(*a, **k):
        raise error
    srv = PredictionServer(bsts[0], device="cpu")
    fs = FleetServer(bsts, device="cpu")
    assert srv.host_fallback and fs.host_fallback
    monkeypatch.setattr(engine_mod, "predict_scores", launch)
    monkeypatch.setattr(fleet_mod, "fleet_predict_scores", launch)
    before = dict(engine_mod.FALLBACK_COUNTS)
    for _ in range(4):
        with pytest.raises(type(error), match=str(error)[:12]):
            srv.predict(_query(7))
        with pytest.raises(type(error), match=str(error)[:12]):
            fs.predict(0, _query(7))
    assert not srv.degraded and fs.degraded_replicas() == []
    assert engine_mod.FALLBACK_COUNTS == before
    reg = obs.registry()
    assert reg.counter("serve.failed") == 4
    assert reg.counter("serve.fleet.failed") == 4
    for name in ("serve.device_failures", "serve.fallback_requests",
                 "serve.fleet.device_failures",
                 "serve.fleet.fallback_requests"):
        assert reg.counter(name) == 0


def test_without_host_fallback_the_device_error_raises(pair):
    bsts, _ = pair
    obs.configure(enabled=True)
    srv = PredictionServer(bsts[0], device="cpu", host_fallback=False)
    faults.configure("serve.dispatch:persist")
    with pytest.raises(faults.InjectedFault):
        srv.predict(_query(8))
    assert obs.registry().counter("serve.failed") == 1
    assert obs.registry().counter("serve.fallback_requests") == 0


def test_micro_batches_degrade_per_request(pair):
    """The queue's requests are answered from the host walk too, and their
    latency and queue wait are recorded."""
    bsts, _ = pair
    obs.configure(enabled=True)
    srv = PredictionServer(bsts[0], device="cpu")
    want = srv.predict(_query(9))
    faults.configure("serve.dispatch:persist")
    with srv:
        futs = [srv.submit(_query(9)[i:i + 8]) for i in range(0, 64, 8)]
        got = np.concatenate([f.result(timeout=30) for f in futs])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    reg = obs.registry()
    assert reg.counter("serve.fallback_requests") >= 1
    assert reg.timing("serve.request_latency").count == 8
    assert reg.timing("serve.queue_wait").count == 8
