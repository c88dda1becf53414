"""Distributed find-bin and pre-partitioned construction of the port
(``data/distributed.py``) against ``lightgbm_tpu.data.distributed``, on
the parity features and seeded numpy data:

* ``partition_features`` equal to the JAX package's;
* shards that see identical samples give the single-host mappers;
* ``construct_pre_partitioned`` codes, mappers and offsets equal to the
  JAX package's, and a data-parallel learner trains on them;
* misaligned and partial gathers are rejected.
"""

import numpy as np
import pytest
import torch

import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import distributed as jdist
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import distributed as tdist
from lightgbm_tpu_torch.data.dataset import BinnedDataset
from lightgbm_tpu_torch.parallel import create_tree_learner
from lightgbm_tpu_torch.utils.log import LightGBMError


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def x():
    return pd.make_features()


def _states(mappers):
    return [repr(sorted(m.to_state().items())) for m in mappers]


@pytest.mark.parametrize("nf,machines", [(10, 4), (7, 3), (28, 4), (3, 8),
                                         (1, 1)])
def test_partition_features_equals_jax(nf, machines):
    got = tdist.partition_features(nf, machines)
    assert got == jdist.partition_features(nf, machines)
    start, length = got
    assert sum(length) == nf and start[0] == 0


@pytest.mark.parametrize("machines", [2, 4])
def test_identical_samples_give_the_single_host_mappers(x, machines):
    params = {"max_bin": 63, "min_data_in_leaf": 20}
    cfg = Config(params)
    pairs = [tdist.find_bin_shard(x, r, machines, cfg)
             for r in range(machines)]
    mappers = tdist.allgather_mappers(pairs[::-1],
                                      num_total_features=x.shape[1])
    single = BinnedDataset.construct_from_matrix(x, cfg).bin_mappers
    assert _states(mappers) == _states(single)
    jpairs = [jdist.find_bin_shard(x, r, machines, JConfig(params))
              for r in range(machines)]
    assert _states(mappers) == _states(jdist.allgather_mappers(jpairs))


@pytest.mark.parametrize("sample", [0, 300])
def test_pre_partitioned_codes_equal_jax(x, sample):
    blocks = np.array_split(x, 4)
    params = {"max_bin": 63, "verbose": -1, "data_random_seed": 5}
    jds, joff = jdist.construct_pre_partitioned(
        blocks, JConfig(params), sample_per_shard=sample)
    tds, toff = tdist.construct_pre_partitioned(
        blocks, Config(params), sample_per_shard=sample)
    np.testing.assert_array_equal(toff, joff)
    assert tds.num_data == len(x) == tds.binned.shape[0]
    np.testing.assert_array_equal(tds.binned, np.asarray(jds.binned))
    assert _states(tds.bin_mappers) == _states(jds.bin_mappers)
    assert [g.feature_indices for g in tds.groups] == \
        [g.feature_indices for g in jds.groups]


def test_data_parallel_learner_trains_on_pre_partitioned_rows(x):
    y = pd.make_labels(x)[0]
    cfg = Config({"objective": "binary", "num_leaves": 15, "max_bin": 63,
                  "tree_learner": "data", "num_machines": 4,
                  "verbose": -1})
    ds, _ = tdist.construct_pre_partitioned(np.array_split(x, 4), cfg)
    ds.metadata.set_label(y)
    learner = create_tree_learner(cfg, ds, torch.device("cpu"),
                                  mesh=[torch.device("cpu")] * 4)
    g = torch.from_numpy((0.5 - y).astype(np.float32))
    tree = learner.train(g, torch.full_like(g, 0.25))
    assert tree.num_leaves == 15
    assert sum(len(r) for r in learner.leaf_indices_host().values()) \
        == len(x)


def test_misaligned_and_partial_gathers_are_rejected(x):
    cfg = Config({"max_bin": 63})
    pairs = [tdist.find_bin_shard(x, r, 3, cfg) for r in range(3)]
    with pytest.raises(LightGBMError, match="misaligned"):
        tdist.allgather_mappers([pairs[0], pairs[2]])
    with pytest.raises(LightGBMError, match="partial gather"):
        tdist.allgather_mappers(pairs[:2], num_total_features=x.shape[1])
    with pytest.raises(LightGBMError, match="feature count"):
        tdist.construct_pre_partitioned([x, x[:, :5]], cfg)
    with pytest.raises(LightGBMError, match="at least one"):
        tdist.construct_pre_partitioned([], cfg)
    gathered = tdist.allgather_mappers(
        pairs[1:], gather_fn=lambda mine: [pairs[0]] + mine,
        num_total_features=x.shape[1])
    assert len(gathered) == x.shape[1]
