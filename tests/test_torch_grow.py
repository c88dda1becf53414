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
