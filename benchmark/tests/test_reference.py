"""The plain reference on tiny cases checked by hand, and its
independence from the program."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import bins, forest, rng, splits
from benchmark.reference.objectives import binary

REF = Path(__file__).resolve().parents[1] / "reference"


def test_bins_by_hand():
    # values 1..10 twice each: runs of >= 3 rows close a bin between
    # 2|3, 4|5, 6|7 and 8|9, beside the bin of zero
    col = np.repeat(np.arange(1.0, 11.0), 2)
    x = torch.tensor(col, dtype=torch.float32)[:, None]
    p = dict(bin_construct_sample_cnt=200000, data_random_seed=1,
             min_data_in_leaf=1, max_bin=255, min_data_in_bin=3)
    b = bins.Bins(x, p)
    m = b.mappers[0]
    assert m.num_bin == 6 and m.default_bin == 0 and not m.trivial
    assert m.upper[0] == bins.K_ZERO_THRESHOLD
    assert np.allclose(m.upper[1:5], [2.5, 4.5, 6.5, 8.5])
    assert b.codes(x)[:, 0].tolist() == np.repeat([1, 2, 3, 4, 5],
                                                  4).tolist()
    # zero's bin stored as 0, the rest one up where zero is not bin 0
    neg = torch.tensor([-2.0, -2, -2, 0, 0, 0, 3, 3, 3])[:, None]
    bn = bins.Bins(neg, p)
    assert bn.mappers[0].default_bin == 1
    assert bn.stored(bn.codes(neg))[:, 0].tolist() == [1, 1, 1, 0, 0, 0,
                                                        3, 3, 3]


def test_bins_refuse_nan_and_bundles():
    p = dict(bin_construct_sample_cnt=10, data_random_seed=1,
             min_data_in_leaf=1, max_bin=255, min_data_in_bin=1)
    with pytest.raises(ValueError):
        bins.Bins(torch.tensor([[1.0], [float("nan")]]), p)
    # two columns never non-zero in the same row could be bundled
    x = torch.tensor([[1.0, 0], [2, 0], [0, 1], [0, 2]])
    with pytest.raises(ValueError):
        bins.Bins(x, p)


def test_one_split_by_hand():
    # labels 0 0 1 1 at codes 0 0 1 1; p = 0.5 at the start, g = 0.5 - y,
    # h = 0.25: the root's split at bin 0 gains 1/0.5 + 1/0.5 - 0 = 4,
    # and its leaves output -G/H = -2 and +2
    codes = torch.tensor([[0], [0], [1], [1]], dtype=torch.uint8)
    p = splits.Params(dict(num_leaves=2, learning_rate=1.0,
                           min_data_in_leaf=1, min_sum_hessian_in_leaf=0.0))
    sp = splits.Splitter(codes, [2], p)
    g = torch.tensor([0.5, 0.5, -0.5, -0.5], dtype=torch.float64)
    stats = torch.stack([g, torch.full_like(g, 0.25), torch.ones_like(g)], 1)
    hist = sp.hist(torch.arange(4), stats)
    tot = stats.sum(0)
    assert sp.best(hist, tot, None) == (4.0, 0, 0)
    assert sp.gain(hist, tot, 0, 0, None) == 4.0
    # a node of 2 rows is not split under min_data_in_leaf 1 (> 2 needed)
    assert sp.best(sp.hist(torch.arange(2), stats), stats[:2].sum(0),
                   None)[1] == -1


def test_binary_objective_by_hand():
    y = torch.tensor([0.0, 1.0, 1.0, 1.0])
    assert binary.init_score(y) == pytest.approx(math.log(3.0))
    g, h = binary.gradients(torch.zeros(4), y)
    # at score 0, p = 1/2: g = p - y, h = p (1 - p)
    assert g.tolist() == [0.5, -0.5, -0.5, -0.5]
    assert h.tolist() == [0.25] * 4
    assert g.dtype == torch.float32


def test_judge_by_hand():
    from benchmark import compare
    x = torch.tensor([[1.0], [1.0], [2.0], [2.0]] * 10)
    y = torch.tensor([0.0, 0, 1, 1] * 10)
    p = dict(bin_construct_sample_cnt=1000, data_random_seed=1,
             min_data_in_leaf=1, max_bin=255, min_data_in_bin=1,
             num_leaves=2, learning_rate=1.0, min_sum_hessian_in_leaf=0.0,
             stat_dtype="float64")
    b = bins.Bins(x, p)
    thr = float(b.mappers[0].upper[1])
    right = dict(num_leaves=2, split_feature=[0], threshold=[thr],
                 decision_type=[2], left_child=[-1], right_child=[-2],
                 leaf_value=[-2.0, 2.0], leaf_count=[20, 20],
                 internal_count=[40])
    def judge(tree, first=0, start=None, end=None, trees=()):
        return compare.judge_trees(x, y, p, b, binary,
                                   list(trees) + [forest.Tree(**tree)],
                                   [(first, start)], 1, end, lambda m: None)

    out = judge(right, end=torch.tensor([-2.0, -2, 2, 2] * 10))
    assert out == {"split_regret": 0.0, "leaf_gap": 0.0,
                   "median_leaf_gap": 0.0, "score_gap": 0.0}
    out = judge(dict(right, leaf_value=[-2.0, 2.2]))
    assert out["leaf_gap"] == pytest.approx(0.1)
    assert out["median_leaf_gap"] == pytest.approx(0.05)
    assert judge(dict(right, threshold=[0.5]))["split_regret"] == math.inf
    # a second tree judged from the program's scores after the first:
    # at scores -2 (y = 0) and +2 (y = 1), g = +-q and h = q (1 - q)
    # with q = 1/(1 + e^2), so the leaves output -+1/(1 - q)
    start = torch.tensor([-2.0, -2, 2, 2] * 10)
    q = 1.0 / (1.0 + math.exp(2.0))
    v = 1.0 / (1.0 - q)
    second = dict(right, leaf_value=[-v, v])
    out = judge(second, first=1, start=start,
                end=torch.tensor([-2.0 - v, -2 - v, 2 + v, 2 + v] * 10),
                trees=[forest.Tree(**right)])
    assert out["split_regret"] == 0.0
    assert out["leaf_gap"] < 1e-6 and out["score_gap"] < 1e-6
    # without the program's scores, a later tree cannot be judged
    assert judge(second, first=1, trees=[forest.Tree(**right)])[
        "split_regret"] == math.inf


TREE = dict(num_leaves=3, split_feature=[0, 1], threshold=[0.5, 2.5],
            decision_type=[2, 2], left_child=[-1, -2], right_child=[1, -3],
            leaf_value=[-1, 0.25, 3], leaf_count=[5, 3, 2],
            internal_count=[10, 5])


def test_forest_by_hand():
    trees = [forest.Tree(**TREE)]
    x = torch.tensor([[0.2, 9.0], [0.7, 1.0], [0.7, 3.0],
                      [float("nan"), 0.0]])
    out = forest.forest_output(trees + trees, x)
    # NaN with missing type none counts as 0 and goes left
    assert out.tolist() == [-2.0, 0.5, 6.0, -2.0]


def test_threefry_known_answers():
    # Random123's threefry2x32_20 known answers (as jax's tests pin them)
    m = 0xFFFFFFFF
    assert rng.threefry(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    assert rng.threefry(m, m, m, m) == (0x1CB996FC, 0xBB002BE7)
    assert rng.threefry(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3) \
        == (0xC4923A9C, 0x483DF7A0)
    u = rng.uniform(rng.prng_key(3), 5000, "cpu")
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    bag = rng.bag(0, 3000, 0.8, 3, "cpu")
    assert abs(float(bag.float().mean()) - 0.8) < 0.05
    f = rng.features(4, 53, 0.8, 2, "cpu")
    assert int(f.sum()) == math.ceil(53 * 0.8)


def test_reference_imports_nothing_of_the_program():
    bench = REF.parent
    for path in (list(REF.rglob("*.py")) + list((bench / "data").glob("*.py"))
                 + [bench / "compare.py", bench / "cost.py"]):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("lightgbm_tpu",
                                               "lightgbm_tpu_torch", "jax",
                                               "jaxlib"), (path, n)
