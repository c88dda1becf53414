"""The port's LambdarankNDCG against the benchmark's plain lambdarank
reference (``benchmark/reference/objectives/lambdarank.py``: float64
torch, query by query, no padded buckets), on the CPU; no JAX.

* the reference on a three-document query worked by hand;
* the port's gradient (``objectives/rank.py::rank_grad``) within the
  tolerance of ``tests/test_torch_rank.py`` of the reference's, on
  seeded scores, with queries that fill the 8- to 64-document buckets, a
  one-document query, a query whose labels are all equal and tied
  scores, with one batch a bucket and with many;
* a few hundred rows of the benchmark's ranking generator trained
  through ``Booster.update_chunked`` from card-style tensors (``label``
  and ``group`` tensors), whose trees the reference judges sound (the
  benchmark's own comparison, ``benchmark/compare.py``);
* ``Dataset(..., label=, group=)`` takes tensors as it takes arrays; on
  the card (a ``cuda`` test) tensors on the card.
"""

import math

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from benchmark import compare
from benchmark.data import mslr
from benchmark.loops import plain_trees
from benchmark.reference.objectives import lambdarank as ref
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import Metadata
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.objectives import rank as trank

CPU = torch.device("cpu")
PARAMS = {"sigmoid": 1.0, "max_position": 20}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_on_a_query_worked_by_hand():
    # scores 0.5, 1.0, 0.0 with grades 2, 0, 1: by score the documents
    # stand 1, 0, 2 (discounts 1, 1/log2 3, 1/2); the ordered pairs
    # (high, low) are (0, 1), (0, 2) and (2, 1)
    score = torch.tensor([0.5, 1.0, 0.0])
    y = torch.tensor([2.0, 0.0, 1.0])
    g, h, mag = ref.bind([0, 3], PARAMS).terms(score, y)
    d = {1: 1.0, 0: 1 / math.log2(3), 2: 0.5}
    gain = {0: 3.0, 1: 0.0, 2: 1.0}
    inv = 1 / (3.0 * 1.0 + 1.0 / math.log2(3))
    s = {0: 0.5, 1: 1.0, 2: 0.0}
    want_g, want_h, want_m = [0.0] * 3, [0.0] * 3, [0.0] * 3
    for hi, lo in ((0, 1), (0, 2), (2, 1)):
        delta = s[hi] - s[lo]
        dn = (gain[hi] - gain[lo]) * abs(d[hi] - d[lo]) * inv \
            / (float(np.float32(0.01)) + abs(delta))
        p = 2 / (1 + math.exp(2 * delta))
        want_g[hi] -= p * dn
        want_g[lo] += p * dn
        for r in (hi, lo):
            want_h[r] += 2 * dn * p * (2 - p)
            want_m[r] += p * dn
    assert g.tolist() == pytest.approx(want_g, rel=1e-12)
    assert h.tolist() == pytest.approx(want_h, rel=1e-12)
    assert mag.tolist() == pytest.approx(want_m, rel=1e-12)
    assert ref.bind([0, 3], PARAMS).init_score(y) == 0.0


def _queries(seed=3):
    """Grades and sizes: queries of 2-63 documents (the 8- to 64-document
    buckets), one of one document and one whose grades are all 2."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, 64, 50)
    sizes[:5] = [1, 8, 9, 64, 17]
    y = rng.choice(5, int(sizes.sum()), p=[0.52, 0.32, 0.13, 0.02, 0.01])
    y[1 + 8 + 9 + 64:][:17] = 2
    return y.astype(np.float32), sizes


@pytest.mark.parametrize("budget", [None, 1 << 12])
def test_port_gradient_within_tolerance_of_the_reference(budget,
                                                         monkeypatch):
    """rtol 1e-4 of each row's sum of term magnitudes (a row's lambdas
    have both signs), the hessian of itself: the port's float32 pair
    sums stand up to ~3e-5 of float64 ones on small hessians
    (``tests/test_torch_rank.py``)."""
    if budget is not None:
        monkeypatch.setattr(trank, "_PAIR_BUDGET", budget)
    y, sizes = _queries()
    n = len(y)
    md = Metadata(n)
    md.set_label(y)
    md.set_query(sizes)
    obj = create_objective(Config({"objective": "lambdarank", **PARAMS}))
    obj.init(md, n, CPU)
    assert sorted(obj.bucket_sizes) == [8, 16, 32, 64]
    rng = np.random.default_rng(11)
    score = torch.from_numpy((rng.standard_normal(n) * 2).astype(np.float32))
    score[30:60] = 0.25                           # ties: the stable order
    tg, th = (a.double() for a in obj.get_gradients(score[None, :]))
    qb = np.concatenate([[0], np.cumsum(sizes)])
    fg, fh, mag = ref.bind(qb, PARAMS).terms(score, torch.from_numpy(y))
    assert bool(((tg - fg).abs() <= 1e-4 * mag + 1e-6).all())
    torch.testing.assert_close(th, fh, rtol=1e-4, atol=1e-6)
    # the one-document query and the all-2 query have no pair
    assert float(fg[0]) == float(fh[0]) == 0.0
    same = slice(1 + 8 + 9 + 64, 1 + 8 + 9 + 64 + 17)
    assert float(fg[same].abs().sum()) == float(fh[same].sum()) == 0.0
    assert float(tg[same].abs().sum()) == 0.0
    assert float(fg.abs().max()) > 0.05


def test_trained_trees_are_sound_by_the_reference():
    n, q, longest = 600, 8, 150
    sizes = mslr.query_sizes(n, 5, 0, q, longest)
    x, y = mslr.make(n, 5, 0, CPU, queries=q, longest_query=longest)
    params = {"objective": "lambdarank", "num_leaves": 7, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
              "device_type": "cpu", **PARAMS}
    ds = lt.Dataset(x, label=y, group=sizes, params=params)
    b = lt.Booster(params=params, train_set=ds)
    gb = b._gbdt
    starts = [(0, None)]
    b.update_chunked(3, 3)
    starts.append((len(gb.models), gb.train_score[0].clone()))
    b.update_chunked(3, 3)
    end = gb.train_score[0].clone()
    gb._flush_pending()
    judge = {**params, "bin_construct_sample_cnt": 200000,
             "data_random_seed": 1, "min_data_in_bin": 3, "lambda_l2": 0.0,
             "stat_dtype": "bfloat16"}
    log = []
    mism, bins = compare.codes_mismatch(x, ds._handle.binned, judge,
                                        log.append)
    assert mism == 0
    trees = plain_trees(gb.models)
    qb = torch.cat([torch.zeros(1, dtype=torch.int64), sizes.cumsum(0)])
    out = compare.judge_trees(x, y, judge, bins,
                              ref.bind(qb.tolist(), judge), trees, starts,
                              2, end, log.append)
    assert all(t.num_leaves > 2 for t in trees)
    assert out["split_regret"] <= 1e-6, log
    assert out["median_leaf_gap"] <= 1e-6, log
    assert out["score_gap"] <= 1e-5, log


def test_dataset_takes_tensor_labels_and_queries():
    y, sizes = _queries()
    x = np.random.default_rng(0).standard_normal((len(y), 4))
    a = lt.Dataset(x, label=y, group=sizes).construct()
    b = lt.Dataset(x, label=torch.from_numpy(y),
                   group=torch.from_numpy(sizes)).construct()
    np.testing.assert_array_equal(b.get_group(), a.get_group())
    np.testing.assert_array_equal(b.get_label(), a.get_label())
    b.set_group(torch.from_numpy(sizes[::-1].copy()))
    np.testing.assert_array_equal(b.get_group(), sizes[::-1])


@pytest.mark.cuda
def test_dataset_takes_card_tensors():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the tensors live on the card)")
    dev = torch.device("cuda")
    n, q, longest = 3000, 25, 300
    sizes = mslr.query_sizes(n, 7, 0, q, longest)
    x, y = mslr.make(n, 7, 0, dev, queries=q, longest_query=longest)
    params = {"objective": "lambdarank", "num_leaves": 15, "verbose": -1}
    on_card = lt.Booster(params, lt.Dataset(
        x, label=y, group=sizes.to(dev), params=params))
    on_card.update_chunked(4, 4)
    on_host = lt.Booster(params, lt.Dataset(
        x, label=y.cpu().numpy(), group=sizes.numpy(), params=params))
    on_host.update_chunked(4, 4)
    assert on_card.model_to_string() == on_host.model_to_string()
