"""The device clock of the grower's trees (``ops/clock.py``) and the
program's spans on the profiler's clock (``obs.span`` while a
``torch.profiler`` records), on the CPU:

* trees of a fused chunk and of the per-iteration path carry a
  ``device_clock`` after ``_flush_pending``, with ``start <= waves_start
  <= waves_end <= end`` and ``0 < hist_ns <= waves_end - waves_start``;
  a fused tree's gradient ``0 < grad_ns <= waves_start - start``, a
  per-iteration tree's (gradients from the host) 0;
* the clock changes no result: model text is the same with the clocks
  read or dropped, and the chunk's records equal the per-iteration
  trees';
* a stamp outside the slot table is left alone, and every stamp is
  counted: four a tree, two a wave and two a fused tree's gradient;
* under ``torch.profiler`` with telemetry off, a tensor ``Dataset`` build
  and a chunked train emit ``user_annotation`` events of the data and
  boosting spans; with no profiler and telemetry off ``obs.span`` is the
  shared null span; with telemetry on a span is both a registry entry and
  a profiler range.

One card test holds a captured tree's clock to the same inequalities and
a chunk's summed tree time to its host-clock wall.
"""

import json
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs.state import STATE
from lightgbm_tpu_torch.ops import clock

PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "bagging_freq": 2, "bagging_fraction": 0.8,
          "feature_fraction": 0.8, "device_type": "cpu"}
SPANS = ("data.construct", "data.sample", "data.find_bins", "data.bundle",
         "data.codes", "train.init", "train.chunk", "train.wait")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.configure(enabled=False)
    obs.reset()
    yield
    obs.configure(enabled=False)
    obs.reset()


def _rows(n=4_000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6))
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.standard_normal(n) > 0)
    return x, y.astype(float)


def _trained(path: str, params=PARAMS, iters: int = 4):
    """A booster trained ``iters`` iterations by one fused chunk
    (``fused``) or by ``update`` (``per_iteration``), its trees
    materialized."""
    x, y = _rows()
    b = lt.Booster(params, lt.Dataset(x, y, params=params))
    if path == "fused":
        b.update_chunked(iters, chunk=iters)
    else:
        for _ in range(iters):
            b.update()
    b._gbdt._flush_pending()
    return b


@pytest.mark.parametrize("path", ["fused", "per_iteration"])
def test_trees_carry_a_device_clock(path):
    b = _trained(path)
    trees = b._gbdt.models
    assert len(trees) == 4
    for t in trees:
        assert isinstance(t.device_clock, clock.DeviceClock)
        assert t.device_clock._fields == clock.FIELDS


@pytest.mark.parametrize("path", ["fused", "per_iteration"])
def test_clock_fields_are_ordered(path):
    trees = _trained(path)._gbdt.models
    for t in trees:
        c = t.device_clock
        assert c.start <= c.waves_start <= c.waves_end <= c.end
        assert 0 < c.hist_ns <= c.waves_end - c.waves_start
    # one host clock: each tree starts after the one before it ended
    for a, b in zip(trees, trees[1:]):
        assert a.device_clock.end <= b.device_clock.start


def test_clock_changes_no_model_text():
    fused = _trained("fused")
    per = _trained("per_iteration")
    text = fused.model_to_string()
    assert [t.device_clock for t in fused._gbdt.models]
    assert fused.model_to_string() == text
    for t in fused._gbdt.models:
        t.device_clock = None
    assert fused.model_to_string() == text
    assert per.model_to_string() == text
    # a loaded model's trees carry none
    loaded = lt.Booster(model_str=text)
    assert all(t.device_clock is None for t in loaded._gbdt.models)


def test_stamp_outside_the_table_is_left_alone():
    table = torch.zeros((2, len(clock.FIELDS)), dtype=torch.int64)
    ctl = torch.tensor([1, 0, 0, 2], dtype=torch.int32)
    clock.stamp(table, ctl, clock.END)
    assert int(table.abs().sum()) == 0
    ctl[3] = 1
    clock.stamp(table, ctl, clock.START, clock.OPEN_TREE)
    clock.stamp(table, ctl, clock.HIST, clock.OPEN)
    time.sleep(0.001)
    clock.stamp(table, ctl, clock.HIST, clock.CLOSE)
    assert int(table[0].abs().sum()) == 0
    assert table[1, clock.START] > 0
    assert table[1, clock.HIST] >= 1_000_000
    # a tree's first stamp zeroes both sums
    table[1, clock.GRAD] = 5
    clock.stamp(table, ctl, clock.START, clock.OPEN_TREE)
    assert table[1, clock.HIST] == table[1, clock.GRAD] == 0


@pytest.mark.parametrize("path", ["fused", "per_iteration"])
def test_gradient_clock_on_fused_trees_only(path):
    for t in _trained(path)._gbdt.models:
        c = t.device_clock
        if path == "fused":
            assert 0 < c.grad_ns <= c.waves_start - c.start
        else:
            assert c.grad_ns == 0


@pytest.mark.parametrize("path", ["fused", "per_iteration"])
def test_stamps_are_counted_four_a_tree_and_two_a_wave(path):
    """Four a tree and two a wave, and two more a fused tree (its
    gradient)."""
    clock.stamp.launches.reset()
    gb = _trained(path)._gbdt
    waves = sum(int(s[2]) for s in gb.tree_stats)
    assert waves > 0
    grads = len(gb.models) if path == "fused" else 0
    assert clock.stamp.launches.read() \
        == 4 * len(gb.models) + 2 * waves + 2 * grads


def test_host_arrays_cut_one_copy_back_into_its_tensors():
    from lightgbm_tpu_torch.boosting.gbdt import _host_arrays
    parts = (torch.arange(5, dtype=torch.int64) * (1 << 40),
             torch.arange(-6, 6, dtype=torch.int32).reshape(3, 4),
             torch.linspace(-1, 1, 7), torch.tensor([[7]], dtype=torch.int32))
    out = _host_arrays(*parts)
    for t, a in zip(parts, out):
        assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape)
        assert np.array_equal(a, t.numpy())


@pytest.fixture(scope="module")
def profiled_events():
    """Names of the ``user_annotation`` events of a tensor Dataset build
    and a chunked train (two chunks of 2, then one iteration) under the
    profiler, telemetry off."""
    obs.configure(enabled=False)
    x, y = _rows()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ds = lt.Dataset(torch.from_numpy(x.astype(np.float32)), y,
                        params=PARAMS).construct()
        b = lt.Booster(PARAMS, ds)
        b.update_chunked(4, chunk=2)
        b.update()
    events = prof.events()
    return Counter(e.name for e in events if e.name in SPANS), len(STATE.trace)


@pytest.mark.parametrize("name", SPANS)
def test_spans_reach_the_profiler_with_telemetry_off(profiled_events, name):
    names, buffered = profiled_events
    assert names[name] >= 1
    assert buffered == 0                 # no buffer event with telemetry off


def test_spans_export_as_user_annotations(tmp_path):
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("data.find_bins", cat="data") as sp:
            sp.set(rows=3)
            sp.sync_value = torch.ones(2)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["cat"] for e in events if e.get("name") == "data.find_bins"] \
        == ["user_annotation"]
    assert len(STATE.trace) == 0


def test_no_profiler_and_telemetry_off_is_the_null_span():
    assert obs.span("train.chunk", cat="boost") is obs._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.span("train.chunk") is not obs._NULL_SPAN
    assert obs.span("train.chunk") is obs._NULL_SPAN


def test_telemetry_on_span_is_also_a_profiler_range():
    obs.configure(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("train.wait", cat="boost"):
            pass
    assert [e.name for e in prof.events()].count("train.wait") == 1
    assert obs.snapshot()["timings"]["train.wait"]["count"] == 1
    assert [e.name for e in STATE.trace._copy()] == ["train.wait"]


def test_chunk_span_is_recorded_once_per_chunk():
    obs.configure(enabled=True)
    x, y = _rows()
    b = lt.Booster(PARAMS, lt.Dataset(x, y, params=PARAMS))
    b.update_chunked(4, chunk=2)
    snap = obs.snapshot()
    assert snap["timings"]["train.chunk"]["count"] == 2
    assert snap["timings"]["train.iter"]["count"] == 4
    chunks = [e for e in STATE.trace._copy() if e.name == "train.chunk"]
    assert [e.args["iteration"] for e in chunks] == [2, 4]


@pytest.mark.cuda
def test_captured_tree_clock_on_the_card():
    """A captured chunk's trees: the clock's inequalities on the card's
    ``%globaltimer``, and the chunk's summed tree time within its host
    wall; the trees equal the per-iteration path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the stamp kernel has no CPU "
                    "mode)")
    params = {**PARAMS, "device_type": "cuda", "num_leaves": 31}
    x, y = _rows(20_000)
    b = lt.Booster(params, lt.Dataset(x, y, params=params))
    b.update_chunked(4, chunk=4)                  # builds the graphs
    b._gbdt._flush_pending()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.update_chunked(4, chunk=4)
    torch.cuda.synchronize()
    wall_ns = (time.perf_counter() - t0) * 1e9
    b._gbdt._flush_pending()
    trees = b._gbdt.models[4:]
    for t in trees:
        c = t.device_clock
        assert c.start <= c.waves_start <= c.waves_end <= c.end
        assert 0 < c.hist_ns <= c.waves_end - c.waves_start
        assert 0 < c.grad_ns <= c.waves_start - c.start
    assert sum(t.device_clock.end - t.device_clock.start
               for t in trees) <= wall_ns
    per = lt.Booster(params, lt.Dataset(x, y, params=params))
    for _ in range(8):
        per.update()
    assert per.model_to_string() == b.model_to_string()
