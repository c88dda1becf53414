"""Single-controller row sharding of the port's device grower
(``ops/shard.py``, ``ops/grow.py``, ``ops/hist_cuda.wave_hist_sharded``)
on the CPU, with meshes of 2 and 4 CPU shards:

* ``grad_quant_bits=8`` (with bagging and feature_fraction): the model
  text is the unsharded port's byte for byte, and the sharded tree is the
  JAX grower's as ``tests/test_torch_grow.py`` holds the unsharded one
  (integer fields byte-equal, the rest within 1e-6);
* bf16 K=3: the trees are the unsharded port's up to the plain version's
  f32 summation (each shard's f32 histogram, summed in shard order; on
  the card the shards reduce in fixed point, bit-equal:
  ``tests/test_torch_cuda.py``), and run to run the same;
* the bagging and feature_fraction masks do not depend on the shard
  count; the layout helpers;
* ``data_sharding=single_controller`` with one device trains unsharded
  and logs it; ``multi_controller`` without a coordinator raises the JAX
  package's bring-up error; a sharded grower is never handed to an
  unsharded booster.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
from lightgbm_tpu.ops.grow import DeviceGrower as JGrower
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import BinnedDataset
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import hist_cuda, shard
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = torch.device("cpu")
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "device": "cpu", "verbose": -1,
        "data_sharding": "single_controller"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    x = pd.make_features()
    return x, pd.make_labels(x)[0]


def _train(data, extra, shards, rounds=4):
    x, y = data
    cfg = Config({**BASE, **extra})
    ds = BinnedDataset.construct_from_matrix(x, cfg)
    ds.metadata.set_label(y)
    b = create_boosting(cfg)
    b.mesh = None if shards is None else [CPU] * shards
    b.init_train(ds)
    for _ in range(rounds):
        b.train_one_iter()
    return b


def _text(b):
    return b.model_to_string().split("\nparameters:\n")[0]


INT8_BAG = {"grad_quant_bits": 8, "bagging_fraction": 0.7,
            "bagging_freq": 2, "feature_fraction": 0.8}


@pytest.mark.parametrize("shards", [2, 4])
def test_int8_sharded_text_equals_unsharded(data, shards):
    whole = _train(data, INT8_BAG, None)
    sharded = _train(data, INT8_BAG, shards)
    g = sharded._grower
    assert g.mesh == [CPU] * shards and whole._grower.mesh is None
    assert g.n_pad == shards * g.shard_spec.local_rows >= g.num_data
    assert g.exp_rows == whole._grower.n_pad
    assert _text(sharded) == _text(whole)


@pytest.mark.parametrize("shards", [2, 4])
def test_int8_sharded_tree_equals_jax(shards):
    """One bagged, feature-masked quantized tree of the sharded port
    against the JAX grower (``test_torch_grow.py::
    test_quantized_tree_matches_jax``'s bar)."""
    p = {"objective": "binary", "max_bin": 63, "verbose": -1,
         "device_growth": "on", "hist_kernel": "interpret",
         "learning_rate": 0.1, "grad_quant_bits": 8, "seed": 3,
         "num_leaves": 31, "feature_fraction": 0.8}
    x = pd.make_features()
    rng = np.random.default_rng(25)
    n = len(x)
    score = rng.standard_normal(n).astype(np.float32) * 0.1
    grad = rng.standard_normal(n).astype(np.float32)
    hess = rng.uniform(0.05, 0.3, n).astype(np.float32)
    jc, tc = JConfig(p), Config({**p, "device": "cpu"})
    jg = JGrower(JDataset.construct_from_matrix(x, jc), jc)
    tg = tgrow.DeviceGrower(BinnedDataset.construct_from_matrix(x, tc), tc,
                            CPU, mesh=[CPU] * shards)
    jm, tm = jg.feature_mask_for(5), tg.feature_mask_for(5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    out = jg.grow_one_iter(jnp.asarray(score), jnp.asarray(grad),
                           jnp.asarray(hess), jm, tree_idx=5)
    res = tg.grow_one_iter(torch.from_numpy(score), torch.from_numpy(grad),
                           torch.from_numpy(hess), feature_mask=tm,
                           tree_idx=5)
    nl = int(out[4])
    assert int(res.num_leaves) == nl >= 3
    np.testing.assert_array_equal(res.rec_i.numpy()[:nl - 1],
                                  np.asarray(out[1])[:nl - 1])
    got, want = res.rec_f.numpy()[:nl - 1], np.asarray(out[2])[:nl - 1]
    exact = [1, 2, 3, 6]
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    assert (np.abs(got - want) <= 1e-6 * np.abs(want).max(axis=0)).all()
    np.testing.assert_allclose(res.score.numpy(), np.asarray(out[0]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shards", [2, 4])
def test_bf16_sharded_trees_equal_unsharded(data, shards):
    x, _ = data
    whole = _train(data, {}, None)
    a, b = _train(data, {}, shards), _train(data, {}, shards)
    assert _text(a) == _text(b)             # run to run
    for g in (whole, a):
        g._flush_pending()
    for tw, ts in zip(whole.models, a.models):
        n = tw.num_leaves
        assert ts.num_leaves == n
        np.testing.assert_array_equal(ts.split_feature[:n - 1],
                                      tw.split_feature[:n - 1])
        np.testing.assert_array_equal(ts.predict_leaf(x),
                                      tw.predict_leaf(x))
        np.testing.assert_allclose(ts.leaf_value[:n], tw.leaf_value[:n],
                                   rtol=1e-5, atol=1e-7)


def test_masks_do_not_depend_on_the_shard_count(data):
    extra = {"bagging_fraction": 0.6, "bagging_freq": 1,
             "feature_fraction": 0.5}
    growers = [_train(data, extra, s, rounds=1)._grower
               for s in (None, 2, 4)]
    for it in range(3):
        ref = growers[0]
        for g in growers[1:]:
            assert torch.equal(g.bag_mask_at(it), ref.bag_mask_at(it))
            assert torch.equal(g.feature_mask_for(it),
                               ref.feature_mask_for(it))


def test_layout_helpers():
    cfg = Config({})
    spec = shard.shard_spec(2500, [CPU] * 4, cfg)
    assert spec.n_shards == 4 and spec.local_rows == 1024
    assert spec.draw_npad == 4096 and spec.bag_npad == 4096
    assert [shard.local_valid_rows(spec, d) for d in range(4)] == \
        [1024, 1024, 452, 0]
    assert shard.shard_local_rows(2500, 4, Config(
        {"train_row_bucketing": False})) == 625
    full = torch.arange(3000.0)
    blocks = [shard.slice_global_draw(spec, full, d) for d in range(4)]
    assert all(b.shape == (1024,) for b in blocks)
    assert torch.equal(torch.cat(blocks)[:3000], full)
    assert not torch.cat(blocks)[3000:].any()
    assert shard.replicate_to_all([CPU] * 2)(full)[1] is full
    assert [t.tolist() for t in shard.host_replicated([CPU] * 3, [1, 2])] \
        == [[1, 2]] * 3


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_plain_sharded_histogram_sums_the_shards(dtype):
    rng = np.random.default_rng(2)
    n, g, nb, k, w = 3000, 4, 64, 3, 5
    bins = torch.from_numpy(rng.integers(0, nb, (g, n)).astype(np.uint8))
    leaf = torch.from_numpy(rng.integers(-1, w, n).astype(np.int32))
    if dtype == torch.int8:
        ghk = torch.from_numpy(rng.integers(-127, 128, (n, k))
                               .astype(np.int8))
    else:
        ghk = torch.from_numpy(rng.standard_normal((n, k))
                               .astype(np.float32)).to(dtype)
    pending = torch.arange(w, dtype=torch.int32)
    whole = hist_cuda.wave_hist(bins, leaf, ghk, pending, g=g, nb=nb, k=k,
                                w=w)
    codes = [bins[:, :1000].contiguous(), bins[:, 1000:].contiguous()]
    got = hist_cuda.wave_hist_sharded(codes, leaf, ghk, pending, g=g, nb=nb,
                                      k=k, w=w)
    if dtype == torch.int8:
        assert torch.equal(got, whole)
    else:
        torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)
    rows = torch.from_numpy(rng.permutation(n)[:2000].astype(np.int32))
    ghk_f = ghk.float()
    one = hist_cuda.wave_hist_rows(bins, ghk_f, rows, g=g, nb=nb, k=k)
    parts = [(bins[:, a:b].contiguous(), ghk_f[a:b],
              rows[(rows >= a) & (rows < b)] - a)
             for a, b in ((0, 1000), (1000, n))]
    torch.testing.assert_close(
        hist_cuda.wave_hist_rows_sharded(parts, nb=nb, k=k), one,
        rtol=1e-5, atol=1e-4)


def test_one_device_trains_unsharded_and_logs(data, caplog):
    with caplog.at_level("INFO"):
        assert shard.resolve_shard_mesh(Config(BASE), devices=[CPU]) is None
    assert "training unsharded" in caplog.text
    assert shard.resolve_shard_mesh(Config(BASE), devices=[CPU] * 2) == \
        [CPU, CPU]
    assert shard.resolve_shard_mesh(Config({})) is None
    b = _train(data, {}, None, rounds=1)
    assert b._grower.mesh is None


def test_multi_controller_refused_by_name():
    """multi_controller is ported (tests/test_torch_multihost*.py):
    without a coordinator its bring-up raises the JAX package's error by
    name."""
    cfg = Config({"data_sharding": "multi_controller"})
    with pytest.raises(LightGBMError, match="multi_controller: no "
                                            "coordinator configured"):
        shard.resolve_shard_mesh(cfg)


def test_sharded_grower_is_not_adopted_unsharded(data):
    tgrow.clear_grower_cache()
    try:
        a = _train(data, {}, 2, rounds=1)
        g = a._grower
        a.release_grower()
        b = _train(data, {}, None, rounds=1)
        assert b._grower is not g and b._grower.mesh is None
        b.release_grower()
        c = _train(data, {}, 2, rounds=1)
        assert c._grower is g
    finally:
        tgrow.clear_grower_cache()
