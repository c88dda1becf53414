"""The ranking cell, ``mslr.train``, at a tiny size on the CPU in a copy of
the benchmark: the ``mslr`` configuration through the ``rank_train``
loop is correct and reports its four metrics; with the lambdarank
reference's pair discount, or its ``0.01 + |delta|`` scaling, taken out,
the same training is not correct; no file that was there is edited.
Its readers on hand-made facts: a program whose clock has no gradient
field reads nothing."""

import json
import shutil
from pathlib import Path
from typing import NamedTuple

import pytest
import torch

from benchmark import cost_rank
from benchmark.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = Path("benchmark/reference/objectives/lambdarank.py")
#: the cell at test size: few rows and queries, small trees
SIZES = dict(train_rows=3000, queries=30, longest_query=300)
MIX = dict(chunk=4, trace_steps=1, sample_among=1, judged_chunks=2)
METRICS = ("mfu.rank", "rank_grad_share.rank", "rank_grad_roofline.rank",
           "hist_share.rank")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tmp_path_factory.mktemp("rank") / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def _run(root, out, trace):
    from benchmark import run
    run.set_env()
    cfg = json.loads((root / "benchmark/configs/mslr.json").read_text())
    sizes = dict(SIZES, params={**cfg["params"], "num_leaves": 15})
    return run.run("mslr.train", 20261019123457, 0.2, trace,
                   device_name="cpu", out_root=out, root=root, sizes=sizes,
                   mix_overrides=MIX)


def test_rank_cell_is_correct_and_reads_its_metrics(checkout, tmp_path):
    before = {p: p.read_bytes() for p in checkout.rglob("*") if p.is_file()}
    res = _run(checkout, tmp_path, True)
    assert res["correct"], res["checks"]
    assert res["_forbidden"] == []
    # the CPU's plain loop stamps the host clock: every metric reads
    for m in METRICS:
        assert 0 < res["metrics"][m]["value"] < 100, m
    assert {p: p.read_bytes() for p in before} == before


@pytest.mark.parametrize("cut", [
    ("pdisc = (disc[:, None] - disc[None, :]).abs()", "pdisc = 1.0"),
    ("dndcg / (SCORE_EPS + delta.abs())", "dndcg"),
], ids=["pair_discount", "score_distance"])
def test_rank_cell_without_a_term_is_not_correct(checkout, tmp_path, cut):
    path = checkout / REFERENCE
    text = path.read_text()
    assert text.count(cut[0]) == 1
    path.write_text(text.replace(cut[0], cut[1]))
    try:
        res = _run(checkout, tmp_path, False)
    finally:
        path.write_text(text)
    assert not res["correct"], res["checks"]


class Clock(NamedTuple):
    start: int
    waves_start: int
    waves_end: int
    end: int
    hist_ns: int
    grad_ns: int


class OldClock(NamedTuple):
    start: int
    waves_start: int
    waves_end: int
    end: int
    hist_ns: int


class Tree:
    """A tree of 3 leaves: root (100 rows) -> leaf 0 (30) and node 1
    (70) -> leaves 1 (40) and 2 (30)."""
    num_leaves = 3
    leaf_count = [30, 40, 30]
    internal_count = [100, 70]
    left_child = [-1, -2]
    right_child = [1, -3]

    def __init__(self, clock):
        self.device_clock = clock


def _facts(clock):
    """Two trees of 1000 ns, 250 of it the gradient and 300 kernel 1, on
    ``clock``'s fields; two queries of 50 rows."""
    stamps = [(0, 400, 900, 1000, 300, 250),
              (2000, 2400, 2900, 3000, 300, 250)]
    n = len(clock._fields)
    return dict(trees=[Tree(clock(*v[:n])) for v in stamps], wall_s=4e-6,
                waves=4, rows=100, groups=2, features=2, k=3,
                query_sizes=[50, 50], pairs=900)


@pytest.mark.parametrize("name", METRICS)
def test_readers_by_hand(name):
    read = Spec(ROOT).metric(name)
    facts = _facts(Clock)
    work = cost_rank.rank_gradients(100, [50, 50], 900)
    # 100 rows x 16 bytes + 2 queries x 8; 900 pairs x 22 + 2 x 50 x 6
    assert work == (1616.0, 900 * 22 + 600.0)
    want = {"rank_grad_share.rank": 25.0, "hist_share.rank": 30.0}
    if name in want:
        assert read(facts) == pytest.approx(want[name])
    elif name == "rank_grad_roofline.rank":
        from benchmark import cost
        assert read(facts) == pytest.approx(
            100 * 2 * cost.least_seconds(*work) / 500e-9)
    else:
        assert read(facts) > 0
    old = _facts(OldClock)
    if name.startswith("rank_grad"):
        assert read(old) is None
    else:
        assert read(old) is not None


def test_label_ordered_pairs():
    # query 1: labels 0, 0, 1, 2 -> 5 ordered pairs; query 2: 3, 3 -> 0
    y = torch.tensor([0., 0., 1., 2., 3., 3.])
    assert cost_rank.label_ordered_pairs(y, torch.tensor([4, 2])) == 5
