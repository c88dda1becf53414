"""The readers of what the program records itself (``benchmark/metrics/
program.py`` and its eight metrics) on fabricated facts: trees with
hand-made device clocks, and a trace of hand-made events, each reading
worked out by hand; each returns None with nothing to read."""

from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

from benchmark import trace
from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]

CLOCK_READERS = ("grow_busy_share.train", "hist_share.train",
                 "split_share.train", "hist_roofline.train",
                 "grow_busy_share.window")
SPAN_READERS = {"bin_find_s.window": "data.find_bins",
                "bin_sample_s.window": "data.sample",
                "train_init_s.window": "train.init"}


def reader(name):
    return Spec(ROOT).metric(name)


class Clock(NamedTuple):
    start: int
    waves_start: int
    waves_end: int
    end: int
    hist_ns: int


class Tree:
    """A tree of 3 leaves: root (100 rows) -> leaf 0 (30) and node 1
    (70) -> leaves 1 (40) and 2 (30); the smaller child of each split
    holds 30 rows."""
    num_leaves = 3
    leaf_count = np.array([30, 40, 30])
    internal_count = np.array([100, 70])
    left_child = np.array([-1, -2])
    right_child = np.array([1, -3])

    def __init__(self, clock=None):
        if clock is not None:
            self.device_clock = clock


def clocked_facts(**over):
    # tree 1: 1000 ns, waves 800 ns of which kernel 1 300 ns; tree 2:
    # 1000 ns, waves 500 ns of which kernel 1 200 ns; a 4 us window
    trees = [Tree(Clock(1000, 1100, 1900, 2000, 300)),
             Tree(Clock(3000, 3200, 3700, 4000, 200))]
    facts = dict(trees=trees, wall_s=4e-6, waves=4, rows=1000, groups=2,
                 features=2, k=3)
    facts.update(over)
    return facts


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def span_facts():
    # window 0-1000 us; data.find_bins 100-300 and 900-1100 (100 us of it
    # inside), one outside the window; data.sample 50-80
    return {"trace": trace.Trace([
        ev("user_annotation", "bench.window", 0, 1000),
        ev("user_annotation", "data.find_bins", 100, 200),
        ev("user_annotation", "data.find_bins", 900, 200),
        ev("user_annotation", "data.find_bins", 2000, 100),
        ev("user_annotation", "data.sample", 50, 30),
        ev("kernel", "data.sample", 400, 100),
        ev("cpu_op", "aten::copy_", 60, 10),
    ])}


@pytest.mark.parametrize("name", ["grow_busy_share.train",
                                  "grow_busy_share.window"])
def test_busy_share(name):
    # 2000 ns of trees in a 4 us window
    assert reader(name)(clocked_facts()) == pytest.approx(50.0)


def test_hist_share():
    # 500 ns of kernel 1 in 2000 ns of trees
    assert reader("hist_share.train")(clocked_facts()) == \
        pytest.approx(25.0)


def test_split_share():
    # waves outside kernel 1: (800 - 300) + (500 - 200) = 800 of 2000 ns
    assert reader("split_share.train")(clocked_facts()) == \
        pytest.approx(40.0)


def test_hist_roofline():
    # a tree: 2 waves over 1000 rows read 8000 bytes of leaf ids; 160
    # listed rows (100 at the root, 30 + 30 smaller children) x (2 codes
    # + 3 bf16 stats) 1280 bytes; 3 histograms x 2 groups x 256 bins x 3
    # stats x 4 bytes 18432 bytes: 27712 a tree, 55424 for two, against
    # 1920 adds; the bytes bound it at 3.35 TB/s, over 500 ns of kernel 1
    want = 100.0 * (55424 / 3.35e12) / 500e-9
    assert reader("hist_roofline.train")(clocked_facts()) == \
        pytest.approx(want)


def test_shares_are_not_clamped():
    # trees longer than the window read over 100: a fault to report
    assert reader("grow_busy_share.train")(clocked_facts(wall_s=1e-6)) == \
        pytest.approx(200.0)


@pytest.mark.parametrize("name", CLOCK_READERS)
def test_clock_readers_return_none_without_a_clock(name):
    assert reader(name)(clocked_facts(trees=[Tree(), Tree()])) is None
    assert reader(name)(clocked_facts(trees=[])) is None
    # one tree without a clock: the traced trees are not all clocked
    mixed = clocked_facts()
    mixed["trees"].append(Tree())
    assert reader(name)(mixed) is None


def test_span_seconds():
    f = span_facts()
    # 200 + 100 us of data.find_bins inside the window
    assert reader("bin_find_s.window")(f) == pytest.approx(300e-6)
    # the kernel of the same name is no host span
    assert reader("bin_sample_s.window")(f) == pytest.approx(30e-6)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_return_none_without_the_span(name):
    f = span_facts()
    if name == "train_init_s.window":
        assert reader(name)(f) is None
    empty = {"trace": trace.Trace([
        ev("user_annotation", "bench.window", 0, 1000),
        ev("cpu_op", "aten::copy_", 60, 10)])}
    assert reader(name)(empty) is None
    assert reader(name)({}) is None
