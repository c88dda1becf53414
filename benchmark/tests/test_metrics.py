"""The metric arithmetic on hand-made traces and trees: the idle union,
the breakdown, kernel time by name, the least time and the whole step's
share of the peak."""

from pathlib import Path

import numpy as np
import pytest

from benchmark import cost, trace
from benchmark.metrics import common
from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]


def reader(name):
    return Spec(ROOT).metric(name)


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def hand_trace():
    # window 0-1000 us; kernels 100-300 and 250-400 overlap (union
    # 100-400), a copy 600-700, a kernel straddling the end 950-1100;
    # the host was in "aten::copy_" during 400-600 and "sort" 700-950
    return trace.Trace([
        ev("user_annotation", "bench.window", 0, 1000),
        ev("kernel", "void (anonymous namespace)::rows_kernel<float, "
           "false, true, true>(Params)", 100, 200),
        ev("kernel", "void scatter_rows_kernel(int)", 250, 150),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 600, 100),
        ev("kernel", "void trees_kernel<double, 64>(Params)", 950, 150),
        ev("cpu_op", "aten::copy_", 390, 220),
        ev("cpu_op", "sort", 690, 270),
        ev("kernel", "outside", 2000, 10),
    ])


def test_idle_union_and_window():
    t = hand_trace()
    assert t.window_s == pytest.approx(1000e-6)
    # busy: 100-400, 600-700, 950-1000 = 450 us
    assert t.busy_s == pytest.approx(450e-6)
    assert t.idle_pct() == pytest.approx(55.0)


def test_kernel_names_and_breakdown():
    t = hand_trace()
    # the pattern takes rows_kernel and trees_kernel, not
    # scatter_rows_kernel; the kernel outside the window is left out
    forest = r"(?<![\w])(rows_kernel|trees_kernel)\b"
    assert len(t.kernels(forest)) == 2
    assert t.kernel_s(forest) == pytest.approx(350e-6)
    assert len(t.kernels()) == 3
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("void (anonymous")
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    # gaps 0-100 (host), 400-600 (copy_), 700-950 (sort)
    assert gaps["sort"] == pytest.approx(250e-6)
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(550e-6)


def test_union_merges():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]


class FakeTree:
    """A tree of 3 leaves: root (100 rows) -> leaf 0 (30) and node 1
    (70) -> leaves 1 (40) and 2 (30)."""
    num_leaves = 3
    leaf_count = np.array([30, 40, 30])
    internal_count = np.array([100, 70])
    left_child = np.array([-1, -2])
    right_child = np.array([1, -3])


def test_tree_work_by_hand():
    facts = {"trees": [FakeTree()], "waves": 2, "rows": 100, "groups": 2,
             "features": 2, "k": 3}
    ph = common.tree_phases(facts)
    # kernel 1: 2 waves read 100 leaf ids; the root's 100 rows and the
    # smaller children 30 and 30 listed (codes 2 + stats 2*3 bytes
    # each); 3 histograms of 2 groups x 256 bins x 3 stats x 4 bytes
    b, f = ph["wave_hist"]
    assert b == 2 * 100 * 4 + 160 * (2 + 6) + 3 * 2 * 256 * 3 * 4
    assert f == 160 * 2 * 3
    assert ph["score_update"] == (100 * 12 + 3 * 4, 200)
    assert ph["find_best"][1] == 5 * 2 * 256 * cost.FIND_OPS_PER_SLOT
    least = common.least_s(ph)
    assert least == pytest.approx(sum(cost.least_seconds(*v)
                                      for v in ph.values()))
    facts["wall_s"] = least * 4
    assert reader("mfu.train")(facts) == pytest.approx(25.0)
    assert reader("host_syncs_per_iter.train")(
        {"syncs": 1, "iters": 20}) == pytest.approx(0.05)
    assert reader("bin_s.window")({"bin_s": [1.0, 2.0]}) == 1.5
    # a reader with nothing to read gives nothing
    assert reader("bin_s.window")({"bin_s": []}) is None
    # the window adds its codes: 100 rows x 3 float32 columns read, a
    # code a used column written
    facts["columns"] = 3
    ph = dict(ph, binning=cost.binning(100, 3, 2))
    assert reader("mfu.window")(facts) == pytest.approx(
        100.0 * common.least_s(ph) / facts["wall_s"])


def test_roofline_is_the_least_time_over_the_measured():
    assert common.roofline_pct(1.0, 4.0) == 25.0
    assert common.roofline_pct(1.0, 0.0) is None
    # bytes bound: 3.35e12 bytes take one second
    assert cost.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert cost.least_seconds(1.0, 67e12) == pytest.approx(1.0)
