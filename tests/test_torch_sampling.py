"""The port's sampling draws against the JAX package's, for the same seeds
and tree indices: feature_fraction masks, bagging masks and permutation
buffers, and the int8 quantized stat columns are byte-equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lightgbm_tpu.ops import bagging as jbag
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu_torch.ops import bagging as tbag
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.utils import random as trandom


@pytest.mark.parametrize("nf,frac", [(28, 0.8), (7, 0.5), (53, 0.8),
                                     (3, 0.1)])
@pytest.mark.parametrize("tree_idx", [0, 1, 9, 1234])
def test_feature_fraction_mask_equals_jax(nf, frac, tree_idx):
    seed = 2 + nf
    k = max(1, int(np.ceil(nf * frac)))
    want = np.asarray(jgrow.feature_fraction_mask(seed, tree_idx, nf, k))
    got = tgrow.feature_fraction_mask(seed, tree_idx, nf, k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == k


@pytest.mark.parametrize("num_data", [1000, 2000, 5000])
@pytest.mark.parametrize("seed,fraction", [(3, 0.8), (3 + 5, 0.8),
                                           (0x7FFFFFFF, 0.5)])
def test_bagging_equals_jax(num_data, seed, fraction):
    """At the host learner's pad bucket_size(num_data): the row mask of
    the fused scan's formulation and the permutation buffer of the
    per-iteration one."""
    n_pad = thist.bucket_size(num_data)
    assert n_pad == jhist.bucket_size(num_data)
    want = np.asarray(jbag.bagging_row_mask(seed, n_pad, num_data,
                                            fraction))
    got = tbag.bagging_row_mask(seed, n_pad, num_data, fraction).numpy()
    assert got.dtype == np.float32 and got.shape == (num_data,)
    np.testing.assert_array_equal(got, want)
    jbuf, jcnt = jbag.bagging_partition(jax.random.PRNGKey(seed), n_pad,
                                        num_data, fraction)
    tbuf, tcnt = tbag.bagging_partition(trandom.PRNGKey(seed), n_pad,
                                        num_data, fraction)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert int(tcnt) == int(jcnt) == int(want.sum())


def _grads(n, seed):
    rng = np.random.default_rng(seed)
    grad = rng.standard_normal(n).astype(np.float32)
    hess = (0.05 + rng.random(n)).astype(np.float32) * 0.25
    return grad, hess


@pytest.mark.parametrize("n,seed,tree_idx", [(2000, 0, 0), (3001, 5, 7),
                                             (4096, 11, 123)])
def test_quantize_gh_equals_jax(n, seed, tree_idx):
    grad, hess = _grads(n, seed)
    grad[::17] = 0.0
    qseed = (seed + 5) & 0x7FFFFFFF
    jkey = jax.random.fold_in(jax.random.PRNGKey(qseed), tree_idx)
    want = [np.asarray(a) for a in jhist.quantize_gh(
        jnp.asarray(grad), jnp.asarray(hess), jkey)]
    tkey = trandom.fold_in(trandom.PRNGKey(qseed), tree_idx)
    got = [a.numpy() for a in thist.quantize_gh(
        torch.from_numpy(grad), torch.from_numpy(hess), tkey)]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.float32
        assert g.view(np.uint32) == w.view(np.uint32)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, w)
    assert np.abs(got[2]).max() <= thist.QUANT_MAX


def test_quantization_noise_does_not_depend_on_the_row_pad():
    """The port's grower pads rows to a pow2 bucket, the JAX grower to its
    chunk: the int8 columns of the real rows are the same either way."""
    grad, hess = _grads(3000, 2)
    key = trandom.fold_in(trandom.PRNGKey(9), 4)
    short = thist.quantize_gh(torch.from_numpy(grad), torch.from_numpy(hess),
                              key)
    pad = lambda a: torch.nn.functional.pad(torch.from_numpy(a), (0, 1096))
    long_ = thist.quantize_gh(pad(grad), pad(hess), key)
    for a, b in zip(short, long_):
        np.testing.assert_array_equal(b.numpy()[:3000] if b.dim() else
                                      b.numpy(), a.numpy())
    assert not long_[2][3000:].any() and not long_[3][3000:].any()
