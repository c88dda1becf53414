"""The port's streaming telemetry (``lightgbm_tpu_torch/obs/rolling.py``,
``slo.py``, ``export.py``) against the JAX package's, and the cases of
``tests/test_obs_stream.py`` re-pointed at the port:

* one replayed (timestamp, value) sequence through both packages'
  ``RollingRegistry``: equal window snapshots, deltas, time-weighted
  gauge means and percentiles (fixed bucket bounds), the late-write drop;
* SLO reports equal on the same rolling state (availability with dark
  time, latency percentiles, burn, freshness, the 1e-12 boundary), the
  spec grammar's errors, the window past the ring's capacity;
* ``prometheus_text`` byte-equal, with name sanitizing and collisions;
* the exporter: a jammed queue drops and counts without blocking, write
  errors are counted and never raised, the lines and the exposition pass
  the schema validator, the scrape endpoint on a free port, the
  configure-time spec checks, the sticky rolling opt-out;
* ``train`` with ``stream_path`` / ``prom_path`` / ``obs_http_port``
  exports while it trains (the options the port refused before).
"""

import importlib.util
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import obs as jobs
from lightgbm_tpu.obs import slo as jslo
from lightgbm_tpu.obs.export import prometheus_text as jprometheus_text
from lightgbm_tpu.obs.rolling import RollingRegistry as JRolling
from lightgbm_tpu.obs.state import STATE as JSTATE
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import slo
from lightgbm_tpu_torch.obs.export import (StreamExporter, prometheus_text,
                                           sanitize_metric_name)
from lightgbm_tpu_torch.obs.rolling import HIST_BOUNDS, RollingRegistry
from lightgbm_tpu_torch.obs.state import STATE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "validate_metrics", os.path.join(REPO, "scripts",
                                     "validate_metrics.py"))
validate_metrics = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(validate_metrics)

T0 = 1_700_000_000.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clean(mod, state):
    exp = state.exporter
    state.exporter = None
    if exp is not None:
        exp.stop(timeout_s=2.0)
    mod.configure(enabled=False)
    mod.reset()
    state.rolling = None
    state.rolling_opt_out = False
    state.last_slo = None
    state.pending_slo_spec = None
    state.metrics_path = state.trace_path = state.events_path = None


@pytest.fixture(autouse=True)
def _clean_obs_state():
    _clean(obs, STATE)
    _clean(jobs, JSTATE)
    yield
    _clean(obs, STATE)
    _clean(jobs, JSTATE)


def _replay(cls):
    """One (timestamp, value) sequence: timings over 40 s, counters in and
    far outside the ring, a gauge's transitions, a late write."""
    r = cls(bucket_seconds=1.0, num_buckets=60, clock=lambda: T0)
    rng = np.random.default_rng(3)
    for i in range(300):
        r.observe("serve.predict", float(rng.lognormal(-6.0, 1.2)),
                  now=T0 - 49 + i * 0.15)
        r.observe("serve.fleet.predict", 0.001 * (i % 17 + 1),
                  now=T0 - 30 + i * 0.1)
    r.inc("serve.ok", 7, now=T0 - 5)
    r.inc("serve.ok", 3, now=T0 - 30)
    r.inc("serve.ok", 99, now=T0 - 300)          # far outside the ring
    r.inc("serve.failed", 2, now=T0 - 12)
    r.inc("serve.fallback_requests", 4, now=T0 - 8)
    r.inc("serve.input_errors", 9, now=T0 - 3)
    r.set_gauge("serve.degraded", 1, now=T0 - 50)
    r.set_gauge("serve.degraded", 0, now=T0 - 20)
    r.set_gauge("serve.degraded", 0, now=T0 - 19)   # same value: no-op
    r.set_gauge("pipeline.last_swap_unix", T0 - 12, now=T0 - 12)
    r.set_gauge("late", 2, now=T0)
    r.set_gauge("late", 7, now=T0 - 5)             # dropped
    r.inc("late.c", 1, now=T0)
    r.inc("late.c", 1, now=T0 - 100)               # dropped
    return r


@pytest.mark.parametrize("window_s", [None, 60.0, 10.0, 3.0])
def test_rolling_snapshots_equal_the_jax_package(window_s):
    a = _replay(RollingRegistry).window(window_s, T0)
    b = _replay(JRolling).window(window_s, T0)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    # later instants too: the window slides past the samples
    for dt in (5.0, 30.0, 120.0):
        assert _replay(RollingRegistry).window(window_s, T0 + dt) \
            == _replay(JRolling).window(window_s, T0 + dt)


def test_rolling_queries_and_bounds():
    r, j = _replay(RollingRegistry), _replay(JRolling)
    for name in ("serve.ok", "late.c", "never"):
        for w in (60.0, 10.0):
            assert r.counter_delta(name, w, T0) == j.counter_delta(name, w,
                                                                  T0)
    assert r.counter_delta("serve.ok", 60.0, T0) == 10
    assert r.counter_delta("late.c", 60.0, T0) == 1
    assert r.gauge_mean("serve.degraded", 60.0, T0) == pytest.approx(0.6)
    assert r.gauge_mean("serve.degraded", 60.0, T0) \
        == j.gauge_mean("serve.degraded", 60.0, T0)
    assert r.gauge_last("late") == 2 and r.gauge_mean("never.set") is None
    for q in (0.5, 0.95, 0.99, 1.0):
        p = r.percentile("serve.predict", q, 60.0, T0)
        assert p == j.percentile("serve.predict", q, 60.0, T0)
        assert any(abs(p - b) < 1e-15 for b in HIST_BOUNDS) \
            or round(p, 6) == r.timing_stats("serve.predict", 60.0,
                                             T0)["max_s"]
    assert len(HIST_BOUNDS) == 96


SPECS = [
    "availability>=0.999,p95_ms<=100,burn<=14,window_s=60",
    "availability>=0.5,p50_ms<=1,p99_ms<=5,freshness_s<=30,window_s=60",
    "source=serve.fleet;window_s=30;p95_ms<=20",
    "availability>=0.999,burn<=2,freshness_s<=5,window_s=10",
    "metric=serve.fleet.predict,p95_ms<=5,window_s=60",
    "window_p95_s<=1,window_s=60",
]


@pytest.mark.parametrize("spec", SPECS)
def test_slo_reports_equal_the_jax_package(spec):
    a = slo.SloSpec.parse(spec).evaluate(
        rolling=_replay(RollingRegistry), registry=obs.registry(), now=T0)
    b = jslo.SloSpec.parse(spec).evaluate(
        rolling=_replay(JRolling), registry=jobs.registry(), now=T0)
    assert a.to_json() == b.to_json()
    assert a.digest() == b.digest()
    assert slo.SloSpec.parse(spec).text == jslo.SloSpec.parse(spec).text


def _boundary(ok, failed, dark=None):
    r = RollingRegistry(bucket_seconds=1.0, num_buckets=120,
                        clock=lambda: T0)
    if ok:
        r.inc("serve.ok", ok, now=T0 - 1)
    if failed:
        r.inc("serve.failed", failed, now=T0 - 1)
    if dark is not None:
        r.set_gauge("serve.degraded", dark, now=T0 - 119)
    return r


def test_slo_boundaries():
    spec = slo.SloSpec.parse("availability>=0.999,window_s=120")
    assert spec.evaluate(rolling=_boundary(999, 1), now=T0).ok
    assert not spec.evaluate(rolling=_boundary(998, 2), now=T0).ok
    r = _boundary(10, 0)
    r.inc("serve.input_errors", 500, now=T0 - 1)
    rep = slo.SloSpec.parse("availability>=1.0,window_s=120").evaluate(
        rolling=r, now=T0)
    assert rep.ok and rep.counts["input_errors"] == 500
    # every request answered by the fallback, the breaker open the whole
    # window: availability collapses
    r = _boundary(0, 0, dark=1)
    r.inc("serve.fallback_requests", 100, now=T0 - 1)
    rep = spec.evaluate(rolling=r, now=T0)
    assert not rep.ok and rep.counts["dark_fraction"] > 0.9
    # the burn rate exactly at its bound passes
    rep = slo.SloSpec.parse("availability>=0.999,burn<=10,window_s=120") \
        .evaluate(rolling=_boundary(990, 10), now=T0)
    assert rep.objective("burn").observed == pytest.approx(10.0)
    assert rep.objective("burn").ok


def test_slo_spec_errors_and_capacity():
    for bad in ("", "availability<=0.9", "p95_ms>=5", "burn<=2",
                "nonsense>=1", "availability>=2.0", "availability>=x"):
        with pytest.raises(slo.SloSpecError):
            slo.SloSpec.parse(bad)
    spec = slo.SloSpec.parse("availability>=0.999,window_s=600")
    with pytest.raises(slo.SloSpecError, match="capacity"):
        spec.evaluate(rolling=_boundary(5, 0), now=T0)
    with pytest.raises(slo.SloSpecError, match="enable telemetry"):
        spec.evaluate(now=T0)


def _cumulative():
    return {"counters": {"serve.ok": 12, "a.b": 1, "a_b": 2,
                         "serve.fleet.tenant.0.rows": 640},
            "gauges": {"serve.degraded": 0, "9lives": 1.5},
            "timings": {"serve.predict": {
                "count": 10, "total_s": 1.0, "mean_s": 0.1,
                "p50_s": 0.1, "p95_s": 0.2, "max_s": 0.3},
                "serve.fleet.predict": {
                "count": 4, "total_s": 0.02, "mean_s": 0.005,
                "p50_s": 0.004, "p95_s": 0.006, "p99_s": 0.007,
                "max_s": 0.008}}}


def test_prometheus_text_byte_equal():
    roll = _replay(RollingRegistry).window(60.0, T0)
    for rolling in (None, roll):
        text, coll = prometheus_text(_cumulative(), rolling)
        jtext, jcoll = jprometheus_text(_cumulative(), rolling)
        assert text == jtext and coll == jcoll == 1
        assert validate_metrics.validate_prometheus(text) == []
    assert sanitize_metric_name("serve.fleet.tenant.0.rows") \
        == "lgbm_serve_fleet_tenant_0_rows"


def test_jammed_queue_drops_and_counts(tmp_path):
    obs.configure(enabled=True)
    obs.inc("serve.ok", 3)
    exp = StreamExporter(stream_path=str(tmp_path / "s.jsonl"), queue_max=2)
    # the writer is not started: the queue jams after two offers and every
    # further emit() drops without blocking
    for _ in range(5):
        exp.emit()
    assert exp.dropped == 3
    assert obs.registry().counter("export.dropped") == 3
    exp.start()
    exp.stop()
    lines = [json.loads(ln) for ln in open(tmp_path / "s.jsonl")]
    assert len(lines) >= 2
    for doc in lines:
        assert validate_metrics.validate_stream_line(doc) == []
        assert doc["schema"] == "lightgbm-tpu-stream"


def test_write_errors_and_injected_faults_counted_not_raised(tmp_path):
    from lightgbm_tpu_torch.robust import faults
    obs.configure(enabled=True)
    exp = StreamExporter(
        stream_path=str(tmp_path / "no_such_dir" / "s.jsonl"))
    exp.flush_now()
    assert exp.write_errors == 1
    assert obs.registry().counter("export.write_errors") == 1
    ok = StreamExporter(stream_path=str(tmp_path / "s.jsonl"))
    faults.configure("obs.export:n=2")
    try:
        assert ok.emit() is False        # the injected fault: a drop
        ok.flush_now()                   # and a write error
    finally:
        faults.clear()
    assert ok.dropped == 1 and ok.write_errors == 1
    ok.flush_now()
    assert ok.flushes == 1


def test_prom_file_and_stream_validate(tmp_path):
    obs.configure(enabled=True)
    obs.inc("serve.ok", 4)
    obs.observe("serve.predict", 0.002)
    obs.set_gauge("serve.degraded", 0)
    sp, pp = str(tmp_path / "s.jsonl"), str(tmp_path / "m.prom")
    StreamExporter(stream_path=sp, prom_path=pp,
                   slo_spec="availability>=0.9").flush_now()
    assert validate_metrics.validate_prometheus(open(pp).read()) == []
    doc = json.loads(open(sp).readline())
    assert validate_metrics.validate_stream_line(doc) == []
    assert doc["counters"]["serve.ok"]["delta"] == 4
    assert doc["slo"]["ok"] is True


def test_scrape_endpoint_on_a_free_port():
    obs.configure(enabled=True)
    obs.inc("serve.ok", 2)
    exp = StreamExporter(http_port=0).start()
    try:
        assert exp.http_port > 0
        exp.flush_now()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{exp.http_port}/metrics",
            timeout=5).read().decode()
    finally:
        exp.stop()
    assert validate_metrics.validate_prometheus(body) == []
    assert "lgbm_serve_ok_total 2" in body


def test_configure_paths_specs_and_opt_out(tmp_path):
    sp, pp = str(tmp_path / "s.jsonl"), str(tmp_path / "m.prom")
    obs.configure(enabled=True, stream_path=sp)
    first = STATE.exporter
    obs.configure(enabled=True, stream_path=sp)
    assert STATE.exporter is first           # per-window: no churn
    obs.configure(enabled=True, prom_path=pp)
    assert STATE.exporter.stream_path == sp
    assert STATE.exporter.prom_path == pp    # additive
    with pytest.raises(slo.SloSpecError):
        obs.configure(enabled=True, slo_spec="availabilty>=0.999")
    _clean(obs, STATE)
    obs.configure(enabled=True, rolling=False)
    assert STATE.rolling is None
    obs.configure(enabled=True)
    assert STATE.rolling is None             # sticky
    obs.configure(enabled=True, rolling=True)
    assert STATE.rolling is not None
    obs.inc("serve.ok", 5)
    rep = slo.evaluate("availability>=0.999")
    assert rep.ok and obs.summary()["slo"]["ok"] is True
    assert obs.snapshot()["slo"]["ok"] is True
    assert obs.rolling_snapshot()["counters"]["serve.ok"]["delta"] == 5


def test_timer_sink_lands_phase_timings():
    from lightgbm_tpu_torch.utils.log import TRAIN_TIMER
    obs.configure(enabled=True)
    TRAIN_TIMER.start("hist")
    TRAIN_TIMER.stop("hist")
    assert obs.registry().timing("phase.hist").count == 1
    assert "phase.hist" in obs.rolling_snapshot()["timings"]
    obs.configure(enabled=False)
    TRAIN_TIMER.start("hist")
    TRAIN_TIMER.stop("hist")
    assert obs.registry().timing("phase.hist").count == 1


EXPORT_OPTIONS = [
    ({"stream_path": "s.jsonl"}, "stream"),
    ({"prom_path": "m.prom"}, "prom"),
    ({"obs_http_port": 0, "prom_path": "m.prom"}, "http"),
    ({"stream_path": "s.jsonl", "obs_export_interval": 0.05}, "interval"),
    ({"profile_attribution": True}, "profile"),
]


@pytest.mark.parametrize("extra,what", EXPORT_OPTIONS,
                         ids=[w for _, w in EXPORT_OPTIONS])
def test_train_with_the_exporter_options(tmp_path, extra, what):
    """The options the port refused before now select the exporter (and
    the counted probe costs), from ``engine.train`` and from
    ``RetrainPipeline``."""
    from lightgbm_tpu_torch.pipeline import RetrainPipeline
    extra = {k: (str(tmp_path / v) if k.endswith("_path") else v)
             for k, v in extra.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((600, 5))
    y = (x[:, 0] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "device": "cpu", **extra}
    RetrainPipeline(params, serve=False)
    tlgb.train(params, tlgb.Dataset(x, y), 3, verbose_eval=False)
    assert obs.enabled()
    if what == "profile":
        assert STATE.profile_attribution and STATE.exporter is None
        return
    exp = STATE.exporter
    if what == "interval":
        assert exp.interval_s == pytest.approx(0.05)
    if what == "http":
        # obs_http_port=0 is "no endpoint", as in the JAX package
        assert exp.http_port is None
    obs.flush()
    if "stream_path" in extra:
        lines = [json.loads(ln) for ln in open(extra["stream_path"])]
        assert lines and all(
            validate_metrics.validate_stream_line(d) == [] for d in lines)
    if "prom_path" in extra:
        text = open(extra["prom_path"]).read()
        assert validate_metrics.validate_prometheus(text) == []
        assert "lgbm_train_init_train_total 1" in text


def test_train_serves_the_scrape_endpoint(monkeypatch):
    """``obs_http_port`` (here through ``LGBM_TPU_OBS_HTTP``'s parameter
    twin on a free port found first) serves the exposition while
    training."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((600, 5))
    y = (x[:, 0] > 0).astype(float)
    tlgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                "device": "cpu", "obs_http_port": port},
               tlgb.Dataset(x, y), 2, verbose_eval=False)
    exp = STATE.exporter
    assert exp.http_port == port
    exp.flush_now()
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=5).read().decode()
    assert validate_metrics.validate_prometheus(body) == []
    assert "lgbm_train_init_train_total 1" in body
