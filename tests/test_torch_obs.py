"""The port's telemetry (``lightgbm_tpu_torch/obs/``) against the JAX
package's (``lightgbm_tpu/obs/``), and the cases of ``tests/test_obs.py``
and ``tests/test_tracing.py`` that the port has re-pointed at it.

* one sequence of ``inc``/``set_gauge``/``max_gauge``/``observe``/
  ``span``/``instant`` through both packages: the snapshots agree on
  counter, gauge and timing names, counts and the percentiles of the
  given durations; the Chrome trace and the JSONL load as JSON with the
  same event names and categories;
* a ``SpanContext`` follows a value across a thread; the pipeline's prep
  thread joins the run's trace; a resumed pipeline keeps the trace id;
* ``metrics_enabled`` with ``engine.train`` records ``train.iter`` spans
  (fused chunks and single iterations) and the engine's iteration hooks;
  ``trace_path``/``metrics_path`` write their files;
* with telemetry off a training run makes no span object;
* CUDA-graph captures are counted by name and signature
  (``obs/capture_track.py``) while telemetry is on, and not when off.
"""

import json
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import obs as jobs
from lightgbm_tpu.obs.registry import MetricsRegistry as JRegistry
from lightgbm_tpu.obs.state import STATE as JSTATE
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import capture_track, tracing
from lightgbm_tpu_torch.obs.registry import RESERVOIR_SIZE, MetricsRegistry
from lightgbm_tpu_torch.obs.state import STATE
from lightgbm_tpu_torch.pipeline import PreppedWindow, RetrainPipeline
from lightgbm_tpu_torch.robust.checkpoint import load_pipeline_checkpoint


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clean(mod, state):
    mod.configure(enabled=False)
    mod.reset()
    state.metrics_path = state.trace_path = state.events_path = None
    state.sync = False
    state.trace_context = False


@pytest.fixture(autouse=True)
def _clean_obs_state():
    _clean(obs, STATE)
    _clean(jobs, JSTATE)
    yield
    _clean(obs, STATE)
    _clean(jobs, JSTATE)


def _drive(mod):
    """The same sequence of recording calls into one package's obs."""
    mod.configure(enabled=True)
    for i in range(5):
        mod.inc("pipeline.windows")
        mod.inc("train.snapshots", 2)
        mod.set_gauge("pipeline.drift", 0.01 * i)
        mod.max_gauge("device.peak_bytes_in_use", [5, 9, 3, 7, 1][i])
    for d in np.linspace(0.001, 0.1, 50):
        mod.observe("pipeline.prep", float(d))
    for i in range(3):
        with mod.span("pipeline.window", cat="pipeline", window=i) as sp:
            sp.set(rows=10 * i)
            with mod.span("pipeline.train", cat="pipeline", window=i):
                pass
        mod.instant("pipeline.window_features", cat="pipeline", window=i)
    mod.counter_sample("device_memory", bytes_in_use=123)


def _names_and_cats(events):
    return sorted((e["name"], e.get("cat"), e.get("ph", e.get("kind")))
                  for e in events if e.get("ph") != "M")


def test_snapshots_agree_with_jax(tmp_path):
    _drive(obs)
    _drive(jobs)
    mine, theirs = obs.snapshot(), jobs.snapshot()
    assert mine["counters"] == theirs["counters"]
    assert mine["gauges"] == theirs["gauges"]
    assert sorted(mine["timings"]) == sorted(theirs["timings"])
    for name, stat in mine["timings"].items():
        assert stat["count"] == theirs["timings"][name]["count"]
    # the given durations: equal totals and percentiles
    assert mine["timings"]["pipeline.prep"] \
        == theirs["timings"]["pipeline.prep"]
    assert mine["events"] == theirs["events"]

    paths = {}
    for tag, mod in (("t", obs), ("j", jobs)):
        paths[tag] = (mod.dump_trace(str(tmp_path / f"{tag}.json")),
                      mod.dump_events_jsonl(str(tmp_path / f"{tag}.jsonl")))
    chrome = {k: json.load(open(v[0]))["traceEvents"]
              for k, v in paths.items()}
    assert _names_and_cats(chrome["t"]) == _names_and_cats(chrome["j"])
    jsonl = {k: [json.loads(line) for line in open(v[1])]
             for k, v in paths.items()}
    assert [(e["name"], e["cat"], e["kind"]) for e in jsonl["t"]] \
        == [(e["name"], e["cat"], e["kind"]) for e in jsonl["j"]]
    assert all("dur_s" in e for e in jsonl["t"] if e["kind"] == "span")


@pytest.mark.parametrize("n", [7, 500, RESERVOIR_SIZE + 300])
def test_registry_percentiles_equal_jax(n):
    durations = np.random.default_rng(n).exponential(0.01, n)
    mine, theirs = MetricsRegistry(), JRegistry()
    for d in durations:
        mine.observe("t", float(d))
        theirs.observe("t", float(d))
    assert mine.timing("t").to_dict() == theirs.timing("t").to_dict()
    assert len(mine.timing("t").samples) == min(n, RESERVOIR_SIZE)


def test_disabled_span_records_nothing():
    assert not obs.enabled()
    with obs.span("x") as sp:
        sp.sync_value = torch.zeros(3)
        assert sp.sync_value is None
    assert obs.span("a") is obs.span("b")
    obs.inc("c")
    obs.observe("t", 1.0)
    snap = obs.snapshot()
    assert snap["counters"] == {} and snap["timings"] == {}
    assert len(STATE.trace) == 0


def test_sync_span_waits_on_its_value():
    obs.configure(enabled=True, sync=True)
    with obs.span("synced") as sp:
        sp.sync_value = torch.ones(4)
    assert obs.snapshot()["timings"]["synced"]["count"] == 1


# ---------------------------------------------------------------------------
# trace context

def test_span_context_follows_a_value_across_a_thread():
    obs.configure(enabled=True, trace_context=True)
    seen = {}
    with obs.span("parent", cat="x"):
        ctx = tracing.capture()

        def worker():
            tok = tracing.set_current(ctx)
            try:
                with obs.span("child", cat="x"):
                    seen["inner"] = tracing.capture()
            finally:
                tracing.reset(tok)
            seen["after"] = tracing.capture()

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    events = {e.name: e.args for e in STATE.trace._copy()}
    assert events["child"]["trace_id"] == events["parent"]["trace_id"]
    assert events["child"]["parent_id"] == events["parent"]["span_id"]
    assert seen["inner"].span_id == events["child"]["span_id"]
    assert seen["after"] is None


def test_disabled_allocates_no_context():
    assert tracing.capture() is None
    assert tracing.current() is None
    assert tracing.new_root() is None
    assert tracing.set_current(None) is None
    tracing.reset(None)
    assert tracing.link_args(None) == {}
    obs.configure(enabled=True, trace_context=False)
    with obs.span("plain", cat="x"):
        assert tracing.capture() is None
    args = STATE.trace._copy()[0].args
    assert "span_id" not in (args or {})


PIPE_PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
               "min_data_in_leaf": 5, "verbosity": -1, "metric": "none",
               "num_iterations": 4, "device": "cpu"}


def _prep(seed_base, n=1200, nf=6):
    def prep(w):
        rng = np.random.default_rng(seed_base + w)
        x = rng.standard_normal((n, nf))
        y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)
        return PreppedWindow(label=y, dense=x, eval_dense=x, eval_label=y)
    return prep


def test_prep_thread_spans_join_callers_trace():
    obs.configure(enabled=True, trace_context=True)
    pipe = RetrainPipeline(PIPE_PARAMS, chunk=2, serve=False)
    pipe.run(range(2), _prep(200))
    events = STATE.trace._copy()
    preps = [e.args for e in events if e.name == "pipeline.prep_window"]
    assert len(preps) == 2
    assert {a["trace_id"] for a in preps} == {pipe._trace_id}
    windows = [e.args for e in events if e.name == "pipeline.window"]
    assert {a["parent_id"] for a in windows} \
        == {a["span_id"] for a in preps}
    snap = obs.snapshot()
    for name in ("pipeline.prep", "pipeline.train", "pipeline.stall",
                 "pipeline.swap"):
        if name == "pipeline.swap":
            continue                 # serve=False: nothing swapped
        assert snap["timings"][name]["count"] == 2, name
    assert snap["counters"]["pipeline.windows"] == 2
    assert obs.summary()["pipeline"]["windows"] == 2


def test_resume_keeps_originating_trace_id(tmp_path):
    obs.configure(enabled=True, trace_context=True)
    cpdir = str(tmp_path / "cp")
    kw = dict(chunk=2, serve=False, window_policy="fresh",
              rebin_on_drift=False)
    pipe = RetrainPipeline(PIPE_PARAMS, checkpoint_dir=cpdir, **kw)
    pipe.run(range(2), _prep(300))
    origin = pipe._trace_id
    assert origin and load_pipeline_checkpoint(cpdir).trace_id == origin
    obs.reset()
    resumed = RetrainPipeline.resume(cpdir, PIPE_PARAMS, **kw)
    assert resumed._trace_id == origin
    resumed.run(range(3), _prep(300))
    windows = [e.args for e in STATE.trace._copy()
               if e.name == "pipeline.window"]
    assert windows and {a["trace_id"] for a in windows} == {origin}


# ---------------------------------------------------------------------------
# training

def _data(n=800):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 5))
    y = (x[:, 0] + x[:, 1] ** 2 > 0).astype(np.float64)
    return x, y


TRAIN = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "metric": "binary_logloss", "min_data_in_leaf": 5,
         "device": "cpu"}


@pytest.mark.parametrize("fused_chunk", [20, 1])
def test_metrics_enabled_records_train_iter(fused_chunk):
    x, y = _data()
    ds = tlgb.Dataset(x, label=y)
    tlgb.train({**TRAIN, "metrics_enabled": True,
                "fused_chunk": fused_chunk}, ds, num_boost_round=4,
               verbose_eval=False)
    snap = obs.snapshot()
    assert snap["timings"]["train.iter"]["count"] == 4
    assert snap["counters"]["train.init_train"] == 1
    assert snap["timings"]["engine.iter"]["count"] >= 1
    if fused_chunk > 1:
        assert snap["counters"]["train.fused_chunks"] == 1
        assert snap["gauges"]["train.fused_chunk_len"] == 4
    names = {e.name for e in STATE.trace._copy()}
    assert {"init_train", "engine_iter"} <= names
    assert ("train.chunk" if fused_chunk > 1 else "train.iter") in names


def test_trace_and_metrics_paths_write_files(tmp_path):
    x, y = _data()
    trace = str(tmp_path / "t.json")
    metrics = str(tmp_path / "m.json")
    events = str(tmp_path / "e.jsonl")
    tlgb.train({**TRAIN, "trace_path": trace, "metrics_path": metrics,
                "events_path": events}, tlgb.Dataset(x, label=y),
               num_boost_round=3, verbose_eval=False)
    doc = json.load(open(metrics))
    assert doc["schema"] == obs.SCHEMA_NAME
    assert doc["timings"]["train.iter"]["count"] == 3
    assert any(e["name"] == "train.chunk"
               for e in json.load(open(trace))["traceEvents"])
    assert all(json.loads(line)["name"] for line in open(events))


def test_windowed_retrain_accumulates():
    x, y = _data()
    for _ in range(2):
        tlgb.train({**TRAIN, "metrics_enabled": True},
                   tlgb.Dataset(x, label=y), num_boost_round=2,
                   verbose_eval=False)
    assert obs.snapshot()["counters"]["train.init_train"] == 2


def test_obs_off_training_makes_no_span(monkeypatch):
    made = []
    real = obs._Span

    def counting(*a, **k):
        made.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(obs, "_Span", counting)
    x, y = _data()
    bst = tlgb.train({**TRAIN, "fused_chunk": 1}, tlgb.Dataset(x, label=y),
                     num_boost_round=3, valid_sets=None, verbose_eval=False)
    bst.update_chunked(3, chunk=3)
    bst.predict(x)
    assert made == []
    assert len(STATE.trace) == 0


def test_capture_track_counts_by_signature():
    capture_track.record("grow.tree", "(a)", 0.0, 0.5)
    assert capture_track.total() == 0            # off: nothing counted
    obs.configure(enabled=True)
    capture_track.record("grow.tree", capture_track.signature_of(
        (1024, 8, 64, 15, 0, None)), 0.0, 0.25)
    capture_track.record("grow.tree", "(1024, 8, 64, 15, 0, True)", 0.0,
                         0.5)
    capture_track.record("grow.tree", "(1024, 8, 64, 15, 0, True)", 0.0,
                         0.25)
    snap = obs.snapshot()
    assert snap["captures"]["grow.tree"]["captures"] == 3
    assert snap["captures"]["grow.tree"]["signatures"] == {
        "(1024, 8, 64, 15, 0, None)": 1, "(1024, 8, 64, 15, 0, True)": 2}
    assert capture_track.total() == 3
    assert capture_track.seconds() == pytest.approx(1.0)
    assert obs.summary()["captures_total"] == 3
    assert any(e.name == "capture:grow.tree" for e in STATE.trace._copy())

