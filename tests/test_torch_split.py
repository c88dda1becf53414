"""The port's batched best-split scan (ops/split.py) against the JAX
package's vmapped one, on the same numpy histograms: integer fields
(feature, threshold) exact, f32 fields within 1e-5 of each field's
largest magnitude in the stack: the two frameworks sum the 256-bin
prefixes in different orders, and the right-child fields and outputs are
differences of such sums (total - left), which turns a 1e-7 relative
summation difference into a few 1e-6 of the field's scale.

default-left is exact too, except on a gain tie: when a feature's missing
bin is empty, its reconstructed stats are the f32 residue total - sum(bins)
(+-1e-6, sign set by summation order), and the missing-left and
missing-right variants then differ only by that residue."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.ops import split as tsplit

NB = 64
INT_FIELDS = [tsplit.F_FEATURE, tsplit.F_THRESHOLD]


def _histograms(ds, n_leaves, seed):
    """(B, S, 3) f32 leaf histograms of random rows with random
    gradients, and their (B, 3) totals."""
    rng = np.random.default_rng(seed)
    n, g = ds.binned.shape
    leaf = rng.integers(0, n_leaves, n)
    grad = rng.standard_normal(n)
    hess = rng.random(n) + 0.05
    stats = np.stack([grad, hess, np.ones(n)], 1)
    hist = np.zeros((n_leaves, g * NB, 3))
    for gi in range(g):
        np.add.at(hist, (leaf, gi * NB + ds.binned[:, gi].astype(np.int64)),
                  stats)
    hist = hist.astype(np.float32)
    return hist, hist[:, :NB].sum(1)


@pytest.mark.parametrize("params", [
    {},
    {"lambda_l1": 0.5, "lambda_l2": 2.0, "min_data_in_leaf": 40},
    {"max_delta_step": 0.3, "min_sum_hessian_in_leaf": 5.0,
     "min_gain_to_split": 0.2},
    {"use_missing": False},
    {"zero_as_missing": True},
], ids=["plain", "l1_l2", "max_delta", "no_missing", "zero_missing"])
def test_find_best_matches_jax(params):
    p = {"objective": "binary", "max_bin": 63, "verbose": -1, **params}
    x = pd.make_features()
    jc, tc = JConfig(p), TConfig(p)
    jd = JDataset.construct_from_matrix(x, jc)
    td = TDataset.construct_from_matrix(x, tc)
    hist, totals = _histograms(jd, n_leaves=6, seed=len(params))
    nf = jd.num_features
    mask = np.ones(nf, bool)
    mask[1] = False                           # a feature_fraction-style mask

    jmeta = jsplit.FeatureMeta.from_dataset(jd, slot_stride=NB)
    want, _, _ = jsplit.find_best_split_stack(
        jnp.asarray(hist), jnp.asarray(totals),
        jnp.asarray([-np.inf, np.inf], jnp.float32), jnp.asarray(mask),
        jmeta, jsplit.SplitHyper.from_config(jc), False)
    want = np.asarray(want)

    tmeta = tsplit.FeatureMeta.from_dataset(td, NB, torch.device("cpu"))
    got = tsplit.find_best_split(
        torch.from_numpy(hist), torch.from_numpy(totals),
        torch.from_numpy(mask), tmeta,
        tsplit.SplitHyper.from_config(tc))[0].numpy()

    assert got.shape == want.shape == (6, 13)
    assert (want[:, tsplit.F_GAIN] > tsplit.NEG_INF).any()
    np.testing.assert_array_equal(got[:, INT_FIELDS], want[:, INT_FIELDS])
    scale = np.abs(want).max(axis=0)
    dl = tsplit.F_DEFAULT_LEFT
    err = np.abs(got - want)
    ok = err <= 1e-5 * scale
    ok[:, dl] = True
    assert ok.all(), (err / scale).max(axis=0)
    flip = got[:, dl] != want[:, dl]
    # a flip is a tie: the same gain either way, to f32 summation noise
    assert (err[flip, tsplit.F_GAIN] <= 1e-5 * scale[tsplit.F_GAIN]).all()


@pytest.mark.parametrize("params", [{}, {"lambda_l2": 1.0,
                                         "min_data_in_leaf": 40}],
                         ids=["plain", "l2"])
def test_quantized_scan_byte_equal_to_jax(params):
    """The int32 scan of grad_quant_bits=8 on int32 histograms of
    quantized stats: the records and the exact int32 left totals equal
    the JAX package's scan (run op by op) byte for byte."""
    p = {"objective": "binary", "max_bin": 63, "verbose": -1, **params}
    x = pd.make_features()
    jc, tc = JConfig(p), TConfig(p)
    jd = JDataset.construct_from_matrix(x, jc)
    td = TDataset.construct_from_matrix(x, tc)
    rng = np.random.default_rng(11)
    n, g = jd.binned.shape
    leaf = rng.integers(0, 5, n)
    stats = np.stack([rng.integers(-127, 128, n), rng.integers(0, 128, n),
                      np.ones(n, np.int64)], 1)
    hist = np.zeros((5, g * NB, 3), np.int64)
    for gi in range(g):
        np.add.at(hist, (leaf, gi * NB + jd.binned[:, gi].astype(np.int64)),
                  stats)
    hist = hist.astype(np.int32)
    totals = hist[:, :NB].sum(1).astype(np.int32)
    scales = np.array([0.0123, 0.00456], np.float32)
    mask = np.ones(jd.num_features, bool)
    mask[2] = False

    jmeta = jsplit.FeatureMeta.from_dataset(jd, slot_stride=NB)
    want, _, want_l = jsplit.find_best_split_stack(
        jnp.asarray(hist), jnp.asarray(totals),
        jnp.asarray([-np.inf, np.inf], jnp.float32), jnp.asarray(mask),
        jmeta, jsplit.SplitHyper.from_config(jc), False,
        scales=jnp.asarray(scales))
    tmeta = tsplit.FeatureMeta.from_dataset(td, NB, torch.device("cpu"))
    got, _, got_l = tsplit.find_best_split(
        torch.from_numpy(hist), torch.from_numpy(totals),
        torch.from_numpy(mask), tmeta, tsplit.SplitHyper.from_config(tc),
        scales=torch.from_numpy(scales))
    want = np.asarray(want)
    assert (want[:, tsplit.F_GAIN] > tsplit.NEG_INF).any()
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
