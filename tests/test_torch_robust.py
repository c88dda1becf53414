"""The port's fault-tolerance layer (``lightgbm_tpu_torch/robust/``)
against the JAX package's (``lightgbm_tpu/robust/``), and the cases of
``tests/test_robust.py`` that the port has re-pointed at it.

* one ``fault_spec`` fires at the same invocations in both packages
  (count/at/after/persist rules, and the probabilistic mode: both draw
  ``_hash_uniform``, equal bit for bit);
* ``backoff_delay`` gives equal delays, ``CircuitBreaker`` goes through
  the same state sequence under one clock;
* atomic writes survive an injected ``io.write`` fault;
* ``save/load_train_state`` round-trips, and a pipeline checkpoint
  manifest (and its model text) written by either package is read by the
  other;
* the grower's dispatch: an injected transient fault is retried and
  absorbed (the same model as without it), a persistent one exhausts the
  retries, and an error that is not transient (a CUDA error, a
  ``RuntimeError``) raises at once, with no retry.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu.robust import checkpoint as jcheckpoint
from lightgbm_tpu.robust import faults as jfaults
from lightgbm_tpu.robust import retry as jretry
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import BinnedDataset
from lightgbm_tpu_torch.robust import (CircuitBreaker, InjectedFault,
                                       InjectedOSError, InjectedTimeout,
                                       RetryError, RetryPolicy,
                                       backoff_delay, checkpoint, faults,
                                       transient_dispatch_errors,
                                       with_retries)
from lightgbm_tpu_torch.utils.log import LightGBMError


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _survives(mod, site, n):
    out = []
    for _ in range(n):
        try:
            mod.check(site)
            out.append(True)
        except mod.InjectedFault:
            out.append(False)
    return out


# ---------------------------------------------------------------------------
# fault injection, both packages

SPECS = [
    ("grow.dispatch:n=2", "grow.dispatch", 6),
    ("pipeline.prep:at=3", "pipeline.prep", 6),
    ("pipeline.train:after=2:n=1", "pipeline.train", 6),
    ("io.write:at=1:persist", "io.write", 6),
    ("io.write:p=0.5:seed=7", "io.write", 64),
    ("pipeline.prep:p=0.2:seed=3:after=4", "pipeline.prep", 64),
]


@pytest.mark.parametrize("spec,site,n", SPECS)
def test_fault_spec_fires_at_the_same_invocations(spec, site, n):
    faults.configure(spec)
    jfaults.configure(spec)
    mine = _survives(faults, site, n)
    assert mine == _survives(jfaults, site, n)
    assert faults.counts() == jfaults.counts()
    assert faults.calls() == jfaults.calls()
    assert not all(mine)


def test_hash_uniform_equal_bit_for_bit():
    keys = [("io.write", i, 7) for i in range(100)] \
        + [("retry", 123, "grow.dispatch", a) for a in range(10)]
    assert [faults._hash_uniform(*k) for k in keys] \
        == [jfaults._hash_uniform(*k) for k in keys]


def test_fault_count_and_at_rules():
    faults.configure("grow.dispatch:n=2,pipeline.train:at=3")
    assert _survives(faults, "grow.dispatch", 4) == [False, False, True,
                                                     True]
    assert _survives(faults, "pipeline.train", 5) == [True, True, True,
                                                      False, True]
    assert faults.counts() == {"grow.dispatch": 2, "pipeline.train": 1}
    assert _survives(faults, "io.write", 3) == [True, True, True]


def test_fault_error_flavors_inherit_builtin_types():
    faults.configure("io.write:n=1:error=oserror,"
                     "pipeline.prep:n=1:error=timeout")
    with pytest.raises(OSError) as ei:
        faults.check("io.write")
    assert isinstance(ei.value, InjectedOSError)
    with pytest.raises(TimeoutError) as ei:
        faults.check("pipeline.prep")
    assert isinstance(ei.value, InjectedTimeout)


def test_fault_env_and_config_arming(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "pipeline.prep:n=1")
    faults.configure_from_env()
    assert faults.active()
    with pytest.raises(InjectedFault):
        faults.check("pipeline.prep")
    cfg = Config({"fault_spec": "grow.dispatch:at=1", "verbosity": -1})
    faults.configure_from_config(cfg)
    faults.check("grow.dispatch")
    faults.configure_from_config(cfg)           # must NOT reset to 0
    with pytest.raises(InjectedFault):
        faults.check("grow.dispatch")


def test_fault_spec_rejects_garbage():
    with pytest.raises(LightGBMError):
        faults.parse_fault_spec("io.write:bogus")
    with pytest.raises(LightGBMError):
        faults.parse_fault_spec("io.write:error=nope")


# ---------------------------------------------------------------------------
# retries and the breaker, both packages

@pytest.mark.parametrize("attempt", range(6))
def test_backoff_delay_equal(attempt):
    mine = RetryPolicy(max_attempts=9, base_delay_s=0.01, max_delay_s=0.2)
    theirs = jretry.RetryPolicy(max_attempts=9, base_delay_s=0.01,
                                max_delay_s=0.2)
    for site in ("", "grow.dispatch", "io.write"):
        assert backoff_delay(mine, attempt, site) \
            == jretry.backoff_delay(theirs, attempt, site)


def test_with_retries_recovers_and_backs_off():
    calls, delays = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return 42

    policy = RetryPolicy(max_attempts=5, base_delay_s=0.01,
                         max_delay_s=0.5, retry_on=(OSError,))
    assert with_retries(flaky, policy, site="t",
                        sleep=delays.append) == 42
    assert len(calls) == 3 and len(delays) == 2
    assert delays == [backoff_delay(policy, 0, "t"),
                      backoff_delay(policy, 1, "t")]


def test_with_retries_exhausts_and_propagates_non_retryable():
    def always():
        raise OSError("down")

    with pytest.raises(RetryError, match="failed after 3 attempts"):
        with_retries(always, RetryPolicy(max_attempts=3,
                                         base_delay_s=0.001,
                                         retry_on=(OSError,)),
                     site="x", sleep=lambda d: None)
    calls = []

    def bad_shape():
        calls.append(1)
        raise ValueError("wrong shape")

    with pytest.raises(ValueError):
        with_retries(bad_shape,
                     RetryPolicy(max_attempts=5, retry_on=(OSError,)),
                     sleep=lambda d: None)
    assert len(calls) == 1


def _breaker_trace(cls):
    t = [0.0]
    b = cls(failure_threshold=2, reprobe_interval_s=1.0,
            clock=lambda: t[0])
    out = []
    for now, op in [(0.0, "allow"), (0.0, "fail"), (0.0, "fail"),
                    (0.0, "allow"), (0.5, "allow"), (1.1, "allow"),
                    (1.1, "fail"), (1.2, "allow"), (2.5, "allow"),
                    (2.5, "ok"), (2.6, "allow"), (2.6, "ok")]:
        t[0] = now
        res = {"allow": b.allow, "fail": b.record_failure,
               "ok": b.record_success}[op]()
        out.append((op, res, b.state, round(b.dark_seconds(), 9)))
    return out


def test_circuit_breaker_same_state_sequence():
    trace = _breaker_trace(CircuitBreaker)
    assert trace == _breaker_trace(jretry.CircuitBreaker)
    assert [s for _, _, s, _ in trace].count("open") == 7


def test_transient_dispatch_errors_leave_out_runtime_errors():
    """The port retries injected faults, OSError and TimeoutError only:
    a CUDA error is a RuntimeError, sticky in PyTorch, and must raise at
    once (ROADMAP §3)."""
    errs = transient_dispatch_errors()
    assert errs == (InjectedFault, OSError, TimeoutError)
    assert not issubclass(RuntimeError, errs)


# ---------------------------------------------------------------------------
# checkpoints

def test_atomic_write_survives_injected_crash(tmp_path):
    p = str(tmp_path / "f.txt")
    checkpoint.atomic_write_text(p, "GENERATION-1")
    faults.configure("io.write:n=1")
    with pytest.raises(InjectedFault):
        checkpoint.atomic_write_text(p, "GENERATION-2")
    assert open(p).read() == "GENERATION-1"
    faults.clear()
    checkpoint.atomic_write_text(p, "GENERATION-2")
    assert open(p).read() == "GENERATION-2"


def test_train_state_roundtrip_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    score = rng.standard_normal((3, 257)).astype(np.float32)
    p = str(tmp_path / "s.npz")
    checkpoint.save_train_state(p, score, 17)
    got, it, rng_state = checkpoint.load_train_state(p)
    np.testing.assert_array_equal(got, score)
    assert it == 17 and rng_state is None
    jscore, jit, rng_state = jcheckpoint.load_train_state(p)
    np.testing.assert_array_equal(jscore, score)
    assert jit == 17 and rng_state is None
    q = str(tmp_path / "j.npz")
    jcheckpoint.save_train_state(q, score, 9)
    got, it, rng_state = checkpoint.load_train_state(q)
    np.testing.assert_array_equal(got, score)
    assert it == 9 and rng_state is None
    assert checkpoint.load_train_state(str(tmp_path / "none")) is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pipeline_manifest_read_by_either_package(tmp_path, writer):
    d = str(tmp_path / "ckpt")
    save = (checkpoint if writer == "port" else jcheckpoint) \
        .save_pipeline_checkpoint
    save(d, window=2, model_str="tree\nversion=v2\n",
         meta={"policy": "fresh", "rows": 10})
    save(d, window=3, model_str="tree\nversion=v2\nW3\n",
         meta={"policy": "warm", "rows": 11, "trace_id": "abc"})
    for mod in (checkpoint, jcheckpoint):
        cp = mod.load_pipeline_checkpoint(d)
        assert cp.window == 3
        assert cp.model_string() == "tree\nversion=v2\nW3\n"
        assert cp.bins_path is None
        assert cp.meta == {"policy": "warm", "rows": 11, "trace_id": "abc"}
        assert cp.trace_id == "abc"
        assert mod.has_pipeline_checkpoint(d)
    # the older window's payload was collected
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) \
        == ["checkpoint.json", "model.3.txt"]


def test_pipeline_checkpoint_crash_between_payload_and_manifest(tmp_path):
    d = str(tmp_path / "ckpt")
    checkpoint.save_pipeline_checkpoint(d, window=0, model_str="W0")
    faults.configure("io.write:at=1")      # 0: model.1.txt, 1: manifest
    with pytest.raises(InjectedFault):
        checkpoint.save_pipeline_checkpoint(d, window=1, model_str="W1")
    faults.clear()
    cp = checkpoint.load_pipeline_checkpoint(d)
    assert cp.window == 0 and cp.model_string() == "W0"


# ---------------------------------------------------------------------------
# the grower's dispatch guard

def _gbdt(extra=None):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1200, 6))
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)
    cfg = Config({"objective": "binary", "num_leaves": 7, "max_bin": 63,
                  "min_data_in_leaf": 5, "verbosity": -1, "device": "cpu",
                  **(extra or {})})
    ds = BinnedDataset.construct_from_matrix(x, cfg)
    ds.metadata.set_label(y)
    g = GBDT(cfg)
    g.init_train(ds)
    return g


@pytest.mark.parametrize("chunk", [1, 3])
def test_transient_dispatch_fault_is_retried_and_absorbed(chunk):
    want = _gbdt()
    want.train_chunked(3, chunk=chunk)
    g = _gbdt({"fault_spec": "grow.dispatch:n=1"})
    g.train_chunked(3, chunk=chunk)
    assert faults.counts() == {"grow.dispatch": 1}
    assert g.model_to_string().split("parameters:")[0] \
        == want.model_to_string().split("parameters:")[0]


def test_persistent_dispatch_fault_exhausts_retries():
    g = _gbdt({"fault_spec": "grow.dispatch:persist:at=0",
               "dispatch_retries": 2})
    with pytest.raises(RetryError, match="3 attempts"):
        g.train_chunked(2, chunk=1)


def test_device_error_is_not_retried(monkeypatch):
    g = _gbdt()
    calls = []

    def cuda_error(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(g._grower, "grow_one_iter", cuda_error)
    with pytest.raises(RuntimeError, match="CUDA error"):
        g.train_chunked(1, chunk=1)
    assert calls == [1]
