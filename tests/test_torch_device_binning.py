"""Binning on the tensor's device (``BinnedDataset.construct_from_device_matrix``)
against the JAX package's ``construct_from_device_matrix`` and against the
port's host ``construct_from_matrix``, on the same float32 inputs: the
(N, G) uint8 codes byte for byte, and the mappers, groups and lookups
equal.  Here the tensors lie on the CPU, so the codes come from the same
torch ops the card runs; ``tests/test_torch_cuda.py`` holds the card's
codes against these.

Validation-style construction (``reference=``) adopts a training set's
mappers on every constructor (device, dense, CSR).  Float32 denormals bin
as zero on every path: bin finding treats |v| <= 1e-35 as zero, so no
bin boundary lies in the denormal range, and XLA's flushing them to zero
on the CPU (which moves the JAX package's tree routing, ROADMAP §3) does
not move a code.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
from lightgbm_tpu.utils.log import LightGBMError as JLightGBMError
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.data.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.utils.log import LightGBMError

BASE = {"objective": "binary", "verbose": -1}


def _bundled(rows=pd.N_ROWS):
    """parity features plus four mutually exclusive sparse columns that
    the bundling pass merges."""
    x = pd.make_features(rows)
    rng = np.random.default_rng(pd.SEED + 9)
    which = rng.integers(0, 8, rows)
    sparse = np.zeros((rows, 4))
    for j in range(4):
        hit = which == j
        sparse[hit, j] = rng.standard_normal(int(hit.sum())) + 3.0
    return np.concatenate([x, sparse], axis=1)


def _denormals(rows=pd.N_ROWS):
    """parity features with float32 denormals in two columns (a third of
    one column's values, and a column of denormals and normal values)."""
    x = pd.make_features(rows).astype(np.float32)
    rng = np.random.default_rng(pd.SEED + 11)
    tiny = rng.integers(-300, 300, rows).astype(np.float32) \
        * np.float32(1e-41)
    x[:, 0] = np.where(rng.random(rows) < 0.3, tiny, x[:, 0])
    x[:, 9] = np.where(rng.random(rows) < 0.5, tiny, x[:, 9])
    assert (np.abs(x[:, 0]) < np.finfo(np.float32).tiny).sum() > 100
    return x


CASES = {
    "max_bin63": (pd.make_features, {"max_bin": 63}),
    "max_bin255": (pd.make_features, {"max_bin": 255}),
    "sampled": (pd.make_features, {"max_bin": 255,
                                   "bin_construct_sample_cnt": 500}),
    "nan_no_missing": (pd.make_features, {"use_missing": False}),
    "zero_as_missing": (pd.make_features, {"zero_as_missing": True}),
    "bundled": (_bundled, {"max_bin": 63}),
    "denormals": (_denormals, {"max_bin": 63}),
}


def _assert_same_dataset(a, b):
    """Groups, lookups and mappers of two port datasets, or of a port and
    a JAX one, equal."""
    assert [g.feature_indices for g in a.groups] == \
        [g.feature_indices for g in b.groups]
    assert [g.bin_offsets for g in a.groups] == \
        [g.bin_offsets for g in b.groups]
    assert a.used_features == b.used_features
    for name in ("f_group", "f_offset", "f_num_bin", "f_default_bin",
                 "f_missing_type", "f_is_categorical"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    for ma, mb in zip(a.bin_mappers, b.bin_mappers):
        assert ma.feature_info_str() == mb.feature_info_str()
        np.testing.assert_array_equal(
            np.asarray(ma.bin_upper_bound).view(np.uint64),
            np.asarray(mb.bin_upper_bound).view(np.uint64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_codes_byte_equal_to_jax_and_host(case):
    make, extra = CASES[case]
    x = np.ascontiguousarray(make(), np.float32)
    params = {**BASE, **extra}
    dev = TDataset.construct_from_device_matrix(torch.from_numpy(x),
                                                TConfig(params))
    host = TDataset.construct_from_matrix(x, TConfig(params))
    jax_dev = JDataset.construct_from_device_matrix(jnp.asarray(x),
                                                    JConfig(params))
    assert dev.device_binned and isinstance(dev.binned, torch.Tensor)
    assert dev.binned.dtype == torch.uint8
    assert tuple(dev.binned.shape) == (len(x), host.num_groups)
    codes = dev.binned.numpy()
    np.testing.assert_array_equal(codes, host.binned)
    np.testing.assert_array_equal(codes, np.asarray(jax_dev.binned))
    _assert_same_dataset(dev, host)
    _assert_same_dataset(dev, jax_dev)
    if case == "bundled":
        assert dev.num_groups < dev.num_features
    if case == "max_bin255":
        # the lognormal column's zero falls below every value: default bin 0
        assert 0 in set(dev.f_default_bin.tolist())
    if case == "nan_no_missing":
        assert np.isnan(x).any() and not dev.f_missing_type.any()
    if case == "zero_as_missing":
        assert 1 in dev.f_missing_type and 2 not in dev.f_missing_type


def test_numpy_input_is_uploaded_to_the_device_asked_for():
    x = pd.make_features().astype(np.float32)
    ds = TDataset.construct_from_device_matrix(x, TConfig(BASE),
                                               device="cpu")
    assert ds.binned.device.type == "cpu"
    np.testing.assert_array_equal(
        ds.binned.numpy(), TDataset.construct_from_matrix(
            x, TConfig(BASE)).binned)


def _split():
    x = _bundled().astype(np.float32)
    x[np.abs(x) < 0.3] = 0.0          # sparsity for the CSR path
    return x[:1500], x[1500:]


@pytest.mark.parametrize("train_on", ["device", "host"])
def test_reference_codes_on_every_constructor(train_on):
    """A validation set adopts the training set's mappers and groups and
    finds no bins: device, dense and CSR codes equal each other and the
    JAX package's host construction with the same reference."""
    xt, xv = _split()
    params = {**BASE, "max_bin": 63}
    cfg = TConfig(params)
    ref = (TDataset.construct_from_device_matrix(torch.from_numpy(xt), cfg)
           if train_on == "device" else
           TDataset.construct_from_matrix(xt, cfg))
    jref = JDataset.construct_from_matrix(xt, JConfig(params))
    csr = sp.csr_matrix(xv)
    csr_args = (csr.indptr, csr.indices, csr.data, csr.shape[1])
    dev = TDataset.construct_from_device_matrix(torch.from_numpy(xv), cfg,
                                                reference=ref)
    dense = TDataset.construct_from_matrix(xv, cfg, reference=ref)
    from_csr = TDataset.construct_from_csr(*csr_args, cfg, reference=ref)
    jdense = JDataset.construct_from_matrix(xv, JConfig(params),
                                            reference=jref)
    jcsr = JDataset.construct_from_csr(*csr_args, JConfig(params),
                                       reference=jref)
    for ds in (dev, dense, from_csr):
        assert ds.reference is ref and ds.bin_mappers is ref.bin_mappers
        assert ds.groups is ref.groups and ds.check_align(ref)
        assert ds.num_data == len(xv)
    assert ref.num_groups < ref.num_features
    np.testing.assert_array_equal(dev.binned.numpy(), dense.binned)
    np.testing.assert_array_equal(from_csr.binned, dense.binned)
    np.testing.assert_array_equal(dense.binned, jdense.binned)
    np.testing.assert_array_equal(from_csr.binned, jcsr.binned)
    # a reference build finds no bins: its own would differ
    own = TDataset.construct_from_matrix(xv, cfg)
    assert [m.feature_info_str() for m in own.bin_mappers] != \
        [m.feature_info_str() for m in dense.bin_mappers]


def test_refusals_carry_the_jax_messages():
    xt, xv = _split()
    cfg = TConfig({**BASE, "max_bin": 63})
    ref = TDataset.construct_from_matrix(xt, cfg)
    narrow = xv[:, :-1]
    csr = sp.csr_matrix(narrow)
    msg = (f"validation data has {narrow.shape[1]} features, train has "
           f"{xt.shape[1]}")
    with pytest.raises(LightGBMError, match=msg):
        TDataset.construct_from_device_matrix(
            torch.from_numpy(np.ascontiguousarray(narrow)), cfg,
            reference=ref)
    with pytest.raises(LightGBMError, match=msg):
        TDataset.construct_from_matrix(narrow, cfg, reference=ref)
    with pytest.raises(LightGBMError, match=msg):
        TDataset.construct_from_csr(csr.indptr, csr.indices, csr.data,
                                    csr.shape[1], cfg, reference=ref)
    jcfg = JConfig({"max_bin": 63})
    with pytest.raises(JLightGBMError, match=msg):
        JDataset.construct_from_matrix(
            narrow, jcfg,
            reference=JDataset.construct_from_matrix(xt, jcfg))
    # categorical mappers: the device path refuses them
    xc = pd.make_categorical_features().astype(np.float32)
    cat_ref = TDataset.construct_from_matrix(xc, cfg, categorical=[0, 1])
    with pytest.raises(LightGBMError,
                       match="construct_from_device_matrix supports "
                             "numerical features only"):
        TDataset.construct_from_device_matrix(torch.from_numpy(xc), cfg,
                                              reference=cat_ref)
    with pytest.raises(LightGBMError, match="float32"):
        TDataset.construct_from_device_matrix(
            torch.from_numpy(xt.astype(np.float64)), cfg)


def test_first_trees_equal_from_device_and_host_binning():
    """Training from device-binned codes grows the host-binned trees,
    field by field, and the same model text."""
    x = pd.make_features().astype(np.float32)
    y, _, _ = pd.make_labels(x)
    params = {**BASE, "num_leaves": 15, "max_bin": 63, "device": "cpu"}
    boosters = [tlgb.train(params, tlgb.Dataset(data, y), 3)
                for data in (torch.from_numpy(x), x)]
    assert boosters[0]._train_set._handle.device_binned
    trees = []
    for b in boosters:
        b._gbdt._flush_pending()
        trees.append(b._gbdt.models)
    for a, b in zip(*trees):
        assert a.num_leaves == b.num_leaves > 2
        for name in ("split_feature", "threshold_in_bin", "threshold",
                     "decision_type", "left_child", "right_child",
                     "leaf_value", "leaf_count"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), name)
    assert boosters[0].model_to_string() == boosters[1].model_to_string()


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
