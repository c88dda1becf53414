"""The port's Threefry (lightgbm_tpu_torch/utils/random.py) against
jax.random as the JAX package calls it: keys, fold_in, split and uniform
draws are equal bit for bit, for several seeds, fold_in indices and
shapes (odd sizes, the bucket_size pads of bagging, 2-D shapes)."""

import numpy as np
import pytest
import torch

import jax
from lightgbm_tpu_torch.ops.histogram import bucket_size
from lightgbm_tpu_torch.utils import random as trandom

SEEDS = [0, 1, 7, 42, 12345, 0x7FFFFFFF]


def _key(k):
    return tuple(int(v) for v in np.asarray(k).tolist())


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_draws_use_the_partitionable_layout():
    """The counters the port reproduces are those of
    jax_threefry_partitionable; the JAX package runs with it on."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    assert _key(jk) == tk
    for d in (0, 1, 5, 1000, 0x7FFFFFFF):
        assert _key(jax.random.fold_in(jk, d)) == trandom.fold_in(tk, d)
    for num in (2, 3):
        assert [_key(k) for k in jax.random.split(jk, num)] \
            == trandom.split(tk, num)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [1, 7, 28, 1000, 3001,
                                   bucket_size(3001), (3, 5)])
def test_uniform_equals_jax(seed, shape):
    key = trandom.fold_in(trandom.PRNGKey(seed), seed % 97)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), seed % 97)
    shp = shape if isinstance(shape, tuple) else (shape,)
    want = _bits(jax.random.uniform(jkey, shp))
    got = trandom.uniform(key, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shp
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("seed", [3, 0x7FFFFFFF])
def test_element_does_not_depend_on_the_draw_length(seed):
    """Element i of a 1-D draw depends on i and the key only, in jax and
    in the port: the grower may draw at its own row pad."""
    jk = jax.random.PRNGKey(seed)
    short, long_ = (_bits(jax.random.uniform(jk, (n,))) for n in (1500,
                                                                    4096))
    np.testing.assert_array_equal(long_[:1500], short)
    tk = trandom.PRNGKey(seed)
    np.testing.assert_array_equal(_bits(trandom.uniform(tk, 4096).numpy()),
                                  long_)


def test_prngkey_rejects_out_of_range_seeds():
    with pytest.raises(ValueError, match="seed"):
        trandom.PRNGKey(-1)
    with pytest.raises(ValueError, match="seed"):
        trandom.PRNGKey(1 << 32)
