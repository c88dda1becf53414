"""Host binning of the port against the JAX package: bin boundaries bit
for bit, and the binned dataset (codes, groups, offsets, per-feature
lookups) byte for byte."""

import numpy as np
import pytest

import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.binning import BinMapper as JBinMapper
from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import bin_mappers_from_arrays
from lightgbm_tpu_torch.data.binning import BinMapper as TBinMapper
from lightgbm_tpu_torch.data.dataset import BinnedDataset as TDataset


def _assert_mappers_equal(a, b):
    assert a.num_bin == b.num_bin
    assert a.missing_type == b.missing_type
    assert a.default_bin == b.default_bin
    assert a.is_trivial == b.is_trivial
    np.testing.assert_array_equal(
        np.asarray(a.bin_upper_bound).view(np.uint64),
        np.asarray(b.bin_upper_bound).view(np.uint64))


CASES = list(pd.bin_cases())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bin_boundaries_bit_equal(case):
    _, max_bin, mdib, values = case
    values = np.asarray(values, np.float64)
    mappers = []
    for cls in (JBinMapper, TBinMapper):
        m = cls()
        m.find_bin(values, len(values), max_bin, mdib, 0,
                   use_missing=True, zero_as_missing=False)
        mappers.append(m)
    _assert_mappers_equal(*mappers)


def _features_with_bundles(rows=pd.N_ROWS):
    """parity features plus mutually exclusive sparse columns, so the
    bundling pass really merges groups."""
    x = pd.make_features(rows)
    rng = np.random.default_rng(pd.SEED + 9)
    which = rng.integers(0, 8, rows)
    sparse = np.zeros((rows, 4))
    for j in range(4):
        hit = which == j
        sparse[hit, j] = rng.standard_normal(int(hit.sum())) + 3.0
    return np.ascontiguousarray(np.concatenate([x, sparse], axis=1))


@pytest.mark.parametrize("max_bin", [63, 255])
@pytest.mark.parametrize("bundled", [False, True])
def test_binned_dataset_byte_equal(max_bin, bundled):
    x = _features_with_bundles() if bundled else pd.make_features()
    params = {"objective": "binary", "max_bin": max_bin, "verbose": -1}
    jd = JDataset.construct_from_matrix(x, JConfig(params))
    td = TDataset.construct_from_matrix(x, TConfig(params))
    assert [g.feature_indices for g in td.groups] == \
        [g.feature_indices for g in jd.groups]
    assert [g.bin_offsets for g in td.groups] == \
        [g.bin_offsets for g in jd.groups]
    if bundled:
        assert td.num_groups < td.num_features
    assert td.binned.dtype == np.uint8
    np.testing.assert_array_equal(td.binned, jd.binned)
    for name in ("f_group", "f_offset", "f_num_bin", "f_default_bin",
                 "f_missing_type", "f_is_categorical"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name),
                                      err_msg=name)
    assert td.used_features == jd.used_features
    for a, b in zip(td.bin_mappers, jd.bin_mappers):
        _assert_mappers_equal(a, b)
        assert a.feature_info_str() == b.feature_info_str()


def test_bin_mappers_from_jax_states():
    x = pd.make_features()
    jd = JDataset.construct_from_matrix(x, JConfig({"max_bin": 63}))
    mappers = bin_mappers_from_arrays([m.to_state() for m in jd.bin_mappers])
    for f, (a, b) in enumerate(zip(mappers, jd.bin_mappers)):
        _assert_mappers_equal(a, b)
        np.testing.assert_array_equal(a.values_to_bins(x[:, f]),
                                      b.values_to_bins(x[:, f]))


@pytest.mark.parametrize("max_bin", [63, 255])
def test_csr_binned_dataset_byte_equal(max_bin):
    """A scipy CSR matrix bins without being densified; codes, groups and
    lookups are the JAX package's construct_from_csr byte for byte (and
    the dense path's)."""
    import scipy.sparse as sp
    x = _features_with_bundles()
    x[np.abs(x) < 0.3] = 0.0                  # real sparsity in every column
    csr = sp.csr_matrix(x)
    params = {"objective": "binary", "max_bin": max_bin, "verbose": -1}
    args = (csr.indptr, csr.indices, csr.data, csr.shape[1])
    jd = JDataset.construct_from_csr(*args, JConfig(params))
    td = TDataset.construct_from_csr(*args, TConfig(params))
    assert [g.feature_indices for g in td.groups] == \
        [g.feature_indices for g in jd.groups]
    assert td.num_groups < td.num_features
    np.testing.assert_array_equal(td.binned, jd.binned)
    for name in ("f_group", "f_offset", "f_num_bin", "f_default_bin",
                 "f_missing_type"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name),
                                      err_msg=name)
    for a, b in zip(td.bin_mappers, jd.bin_mappers):
        _assert_mappers_equal(a, b)
    dense = TDataset.construct_from_matrix(x, TConfig(params))
    np.testing.assert_array_equal(td.binned, dense.binned)
