"""One tree grown by the port's device grower (ops/grow.py, plain
PyTorch histograms on the CPU) against the JAX package's DeviceGrower
(device_growth=on, hist_kernel=interpret: the Pallas kernel in interpret
mode serves the full-width stage, as on the TPU), from the same injected
gradients.

Split records must be equal (leaf, right id, feature, threshold,
default-left); the f32 record fields and the new score agree to f32
summation noise: the histograms sum the same bf16 values in a different
order (rtol 1e-5 of each record field's magnitude), and the score update
is the same bf16 hi/lo gather (atol 1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
from lightgbm_tpu.ops.grow import DeviceGrower as JGrower
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.ops.grow import DeviceGrower as TGrower


def _grads(n, seed):
    rng = np.random.default_rng(seed)
    score = (0.3 * rng.standard_normal(n)).astype(np.float32)
    grad = rng.standard_normal(n).astype(np.float32)
    hess = (0.05 + rng.random(n)).astype(np.float32)
    return score, grad, hess


@pytest.mark.parametrize("params", [
    {"num_leaves": 15},
    {"num_leaves": 7, "min_data_in_leaf": 50, "lambda_l2": 1.0},
    {"num_leaves": 15, "max_depth": 3},
    {"num_leaves": 3},
    {"num_leaves": 40, "min_data_in_leaf": 5},
], ids=["leaves15", "leaves7_l2", "depth3", "leaves3", "leaves40"])
def test_one_tree_matches_jax(params):
    p = {"objective": "binary", "max_bin": 63, "verbose": -1,
         "device_growth": "on", "hist_kernel": "interpret",
         "learning_rate": 0.1, **params}
    x = pd.make_features()
    n = len(x)
    score, grad, hess = _grads(n, seed=params["num_leaves"])
    jc, tc = JConfig(p), TConfig({**p, "device": "cpu"})
    jd = JDataset.construct_from_matrix(x, jc)
    td = TDataset.construct_from_matrix(x, tc)

    jg = JGrower(jd, jc)
    out = jg.grow_one_iter(jnp.asarray(score), jnp.asarray(grad),
                           jnp.asarray(hess),
                           jnp.ones(jd.num_features, bool))
    j_score, j_rec_i, j_rec_f = (np.asarray(a) for a in out[:3])
    j_nl, j_root, j_waves = int(out[4]), float(out[5]), int(out[6])

    tg = TGrower(td, tc, torch.device("cpu"))
    res = tg.grow_one_iter(torch.from_numpy(score), torch.from_numpy(grad),
                           torch.from_numpy(hess))

    assert res.num_leaves == j_nl >= 3
    assert res.waves == j_waves
    nrec = j_nl - 1
    np.testing.assert_array_equal(res.rec_i.numpy()[:nrec], j_rec_i[:nrec])
    got_f, want_f = res.rec_f.numpy()[:nrec], j_rec_f[:nrec]
    scale = np.abs(want_f).max(axis=0)
    assert (np.abs(got_f - want_f) <= 1e-5 * scale).all()
    np.testing.assert_allclose(float(res.root_value), j_root, rtol=1e-5)
    np.testing.assert_allclose(res.score.numpy(), j_score, rtol=0,
                               atol=1e-6)


def test_stump_leaves_score_unchanged():
    """No split clears min_sum_hessian_in_leaf: one leaf, zero score
    update."""
    x = pd.make_features()
    n = len(x)
    tc = TConfig({"objective": "binary", "device": "cpu", "verbose": -1,
                  "min_sum_hessian_in_leaf": float(n)})
    td = TDataset.construct_from_matrix(x, tc)
    score, grad, hess = _grads(n, seed=1)
    res = TGrower(td, tc, torch.device("cpu")).grow_one_iter(
        torch.from_numpy(score), torch.from_numpy(grad),
        torch.from_numpy(hess))
    assert res.num_leaves == 1
    np.testing.assert_array_equal(res.score.numpy(), score)


def _pair(p, seed):
    """Both growers on the parity features with the same params, and
    injected gradients."""
    x = pd.make_features()
    score, grad, hess = _grads(len(x), seed=seed)
    jc, tc = JConfig(p), TConfig({**p, "device": "cpu"})
    jg = JGrower(JDataset.construct_from_matrix(x, jc), jc)
    tg = TGrower(TDataset.construct_from_matrix(x, tc), tc,
                 torch.device("cpu"))
    return jg, tg, (score, grad, hess)


def _masks(jg, tg, tree_idx, bag_seed):
    """The per-tree feature_fraction mask of each grower and, with a bag
    seed, the JAX package's bagging row mask for both."""
    from lightgbm_tpu.ops.bagging import bagging_row_mask
    from lightgbm_tpu_torch.ops.histogram import bucket_size
    jm, tm = jg.feature_mask_for(tree_idx), tg.feature_mask_for(tree_idx)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if bag_seed is None:
        return jm, tm, None, None
    n = tg.num_data
    rm = np.array(bagging_row_mask(bag_seed, bucket_size(n), n, 0.8))
    assert 0 < rm.sum() < n
    return jm, tm, jnp.asarray(rm), torch.from_numpy(rm)


QUANT = {"objective": "binary", "max_bin": 63, "verbose": -1,
         "device_growth": "on", "hist_kernel": "interpret",
         "learning_rate": 0.1, "grad_quant_bits": 8, "seed": 3}
# rec_f fields computed without a multiply-add: the left sums (one int32
# sum times the scale) and the counts
EXACT_F = [1, 2, 3, 6]


def _grow_quant(params, bag_seed, tree_idx):
    jg, tg, (score, grad, hess) = _pair({**QUANT, **params},
                                        seed=tree_idx + 20)
    jm, tm, jrm, trm = _masks(jg, tg, tree_idx, bag_seed)
    out = jg.grow_one_iter(jnp.asarray(score), jnp.asarray(grad),
                           jnp.asarray(hess), jm, row_mask=jrm,
                           tree_idx=tree_idx)
    res = tg.grow_one_iter(torch.from_numpy(score), torch.from_numpy(grad),
                           torch.from_numpy(hess), feature_mask=tm,
                           row_mask=trm, tree_idx=tree_idx)
    j_nl = int(out[4])
    assert res.num_leaves == j_nl >= 3
    assert res.waves == int(out[6])
    nrec = j_nl - 1
    np.testing.assert_array_equal(res.rec_i.numpy()[:nrec],
                                  np.asarray(out[1])[:nrec])
    return (res.rec_f.numpy()[:nrec], np.asarray(out[2])[:nrec], res,
            out)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("params,bag_seed,tree_idx", [
    ({"num_leaves": 15}, None, 0),
    ({"num_leaves": 31, "min_data_in_leaf": 5, "lambda_l2": 1.0}, None, 3),
    ({"num_leaves": 31, "feature_fraction": 0.8}, 8, 5),
    ({"num_leaves": 7, "feature_fraction": 0.5, "max_depth": 3}, 13, 2),
], ids=["leaves15", "leaves31_l2", "bag_ff", "bag_ff_depth3"])
def test_quantized_tree_matches_jax(params, bag_seed, tree_idx):
    """grad_quant_bits=8 against the jitted JAX grower: int8 stat columns,
    int32 histograms and scan, refit leaf values.  The split records and
    every integer-derived field are byte-equal.  Inside a jit, XLA's CPU
    backend contracts a*b+c into fused multiply-adds (one rounding), so
    the gain, right-child and output fields may differ from the port's
    IEEE f32 in the last bits: 1e-6 of each field's magnitude.
    test_quantized_tree_byte_equal_to_jax_op_by_op shows that this is the
    only difference."""
    got, want, res, out = _grow_quant(params, bag_seed, tree_idx)
    np.testing.assert_array_equal(_bits(got[:, EXACT_F]),
                                  _bits(want[:, EXACT_F]))
    scale = np.abs(want).max(axis=0)
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    np.testing.assert_allclose(res.score.numpy(), np.asarray(out[0]),
                               rtol=0, atol=1e-6)


def test_quantized_tree_byte_equal_to_jax_op_by_op():
    """The JAX grower evaluated op by op (jax.disable_jit, so no FMA
    contraction) grows a bagged, feature-masked quantized tree whose
    records, root value and new score are the port's byte for byte."""
    with jax.disable_jit():
        got, want, res, out = _grow_quant(
            {"num_leaves": 7, "feature_fraction": 0.8,
             "hist_kernel": "einsum"}, 8, 5)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _bits(res.root_value) == _bits(out[5])
    np.testing.assert_array_equal(_bits(res.score.numpy()), _bits(out[0]))


@pytest.mark.parametrize("params,bag_seed,tree_idx", [
    ({"num_leaves": 31, "feature_fraction": 0.8}, 8, 0),
    ({"num_leaves": 15, "feature_fraction": 0.5, "min_data_in_leaf": 30},
     21, 7),
], ids=["harness", "ff_half"])
def test_bagged_feature_masked_tree_matches_jax(params, bag_seed, tree_idx):
    """bf16 stat columns with the bagging row mask and the per-tree
    feature_fraction mask: records equal to the tolerance of
    test_one_tree_matches_jax; out-of-bag rows are still routed, so the
    whole score moves."""
    p = {"objective": "binary", "max_bin": 63, "verbose": -1,
         "device_growth": "on", "hist_kernel": "interpret",
         "learning_rate": 0.1, "seed": 5, **params}
    jg, tg, (score, grad, hess) = _pair(p, seed=tree_idx + 40)
    jm, tm, jrm, trm = _masks(jg, tg, tree_idx, bag_seed)
    out = jg.grow_one_iter(jnp.asarray(score), jnp.asarray(grad),
                           jnp.asarray(hess), jm, row_mask=jrm,
                           tree_idx=tree_idx)
    res = tg.grow_one_iter(torch.from_numpy(score), torch.from_numpy(grad),
                           torch.from_numpy(hess), feature_mask=tm,
                           row_mask=trm, tree_idx=tree_idx)
    j_nl = int(out[4])
    assert res.num_leaves == j_nl >= 3
    nrec = j_nl - 1
    j_rec_i, j_rec_f = np.asarray(out[1])[:nrec], np.asarray(out[2])[:nrec]
    np.testing.assert_array_equal(res.rec_i.numpy()[:nrec], j_rec_i)
    assert not np.isin(j_rec_i[:, 2], np.flatnonzero(~tm.numpy())).any()
    got_f = res.rec_f.numpy()[:nrec]
    scale = np.abs(j_rec_f).max(axis=0)
    assert (np.abs(got_f - j_rec_f) <= 1e-5 * scale).all()
    # in-bag counts only: the root's two children hold the bag
    assert j_rec_f[0, 3] + j_rec_f[0, 6] == trm.sum()
    np.testing.assert_allclose(res.score.numpy(), np.asarray(out[0]),
                               rtol=0, atol=1e-6)
    assert (res.score.numpy() != score)[trm.numpy() == 0].all()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread: with several test
    workers on one machine, each op's OpenMP team of one thread a core
    oversubscribes the cores, and the port's test files ran 10-60x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
