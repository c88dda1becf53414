"""Distributed find-bin and pre-partitioned dataset construction
(counterpart of ``lightgbm_tpu/data/distributed.py``).

The reference's multi-machine loader (``dataset_loader.cpp:765-923``)
splits bin finding across workers: machine ``i`` runs ``FindBin`` for the
contiguous feature block ``[start[i], start[i]+len[i])`` on its own local
sample, and the serialized ``BinMapper``s are allgathered so every machine
shares identical mappers; rows are pre-partitioned, one shard a machine
(``:657-704``), so the dense matrix only ever exists a shard at a time.

The pieces are plain functions.  In one process (the single-controller
plane, the tests) every shard's sample is at hand and
``allgather_mappers`` is a concatenation.  Across processes (one a host,
a ``torch.distributed`` process group up) each process passes
:func:`torch_process_gather` as the gather hook, the counterpart of the
JAX package's ``jax_process_gather``.  The exactness contract holds
either way: mapper states round-trip bit for bit
(``BinMapper.to_state``/``from_state``).

Bins for feature ``f`` come from the owning shard's sample only (the
reference's accepted approximation), and the final mapper list is the
same on every shard.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils.log import LightGBMError
from ..utils.random import make_rng
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper
from .dataset import BinnedDataset, Metadata


def partition_features(num_total_features: int, num_machines: int):
    """(start, length) per machine — the reference's contiguous block
    split (dataset_loader.cpp:846-857)."""
    step = max((num_total_features + num_machines - 1) // num_machines, 1)
    start, length = [0] * num_machines, [0] * num_machines
    for i in range(num_machines - 1):
        length[i] = min(step, num_total_features - start[i])
        start[i + 1] = start[i] + length[i]
    length[num_machines - 1] = num_total_features - start[num_machines - 1]
    return start, length


def find_bin_shard(local_sample: np.ndarray, rank: int, num_machines: int,
                   config, categorical: Sequence[int] = (),
                   total_sample_cnt: Optional[int] = None,
                   num_data: Optional[int] = None):
    """Find bin mappers for THIS shard's owned feature block from its
    local sample.  Returns ``(start, serialized_mapper_states)`` where
    states are ``BinMapper.to_state()`` dicts (the CopyTo buffer analog,
    dataset_loader.cpp:885-899) ready to allgather."""
    local_sample = np.asarray(local_sample, np.float64)
    nf = local_sample.shape[1]
    start, length = partition_features(nf, num_machines)
    lo, ln = start[rank], length[rank]
    total = int(total_sample_cnt or local_sample.shape[0])
    nd = int(num_data or local_sample.shape[0])
    # EXACT mirror of the local path's scaling (dataset.py _find_bins;
    # dataset_loader.cpp:787) so identical samples give identical
    # mappers — the module's exactness contract
    filter_cnt = int(0.95 * config.min_data_in_leaf / max(nd, 1)
                     * local_sample.shape[0])
    cats = set(int(c) for c in categorical)
    states = []
    for f in range(lo, lo + ln):
        m = BinMapper()
        bt = BIN_CATEGORICAL if f in cats else BIN_NUMERICAL
        vals = local_sample[:, f]
        # recorded values only — exact zeros stay implicit, matching the
        # local path's `col != 0.0` classification (values below the
        # kZeroThreshold but nonzero are still "recorded" there)
        vals = vals[(vals != 0.0) | np.isnan(vals)]
        m.find_bin(vals, total, config.max_bin, config.min_data_in_bin,
                   filter_cnt, bin_type=bt,
                   use_missing=bool(config.use_missing),
                   zero_as_missing=bool(config.zero_as_missing))
        states.append(m.to_state())
    return lo, states


def allgather_mappers(shard_states, gather_fn=None,
                      num_total_features: Optional[int] = None
                      ) -> List[BinMapper]:
    """Assemble the full mapper list from every shard's
    ``(start, states)`` pair — the Allgather of serialized BinMappers
    (dataset_loader.cpp:900-917).  ``gather_fn`` exchanges the local
    pair for the list of all pairs under multi-controller; defaults to
    the identity for single-controller callers that already hold all
    shards.  Pass ``num_total_features`` to catch a partial gather (a
    dropped trailing shard is otherwise a contiguous prefix)."""
    if gather_fn is not None:
        shard_states = gather_fn(shard_states)
    pairs = sorted(shard_states, key=lambda p: p[0])
    expect = 0
    mappers: List[BinMapper] = []
    for lo, states in pairs:
        if lo != expect:
            raise LightGBMError(
                f"distributed find-bin shards misaligned: expected "
                f"feature {expect}, got {lo}")
        mappers.extend(BinMapper.from_state(s) for s in states)
        expect = lo + len(states)
    if num_total_features is not None and expect != num_total_features:
        raise LightGBMError(
            f"distributed find-bin gathered {expect} features, expected "
            f"{num_total_features} (partial gather?)")
    return mappers


def torch_process_gather(pair, max_bytes: int = 1 << 22, group=None):
    """The multi-controller gather hook of :func:`allgather_mappers`:
    exchanges this process's ``(start, states)`` pair for every process's
    pair over ``torch.distributed`` (the reference's ``Network::
    Allgather`` of serialized BinMappers, dataset_loader.cpp:900-917).
    Each pair is pickled into a fixed-size, length-prefixed uint8 buffer
    (the JAX package's ``jax_process_gather`` layout) and the buffers are
    all-gathered over ``group`` (default the whole process group, which
    must be up)."""
    import pickle

    import torch
    import torch.distributed as dist

    blob = pickle.dumps(pair)
    if len(blob) + 8 > max_bytes:
        raise LightGBMError(
            f"serialized mapper shard ({len(blob)} bytes) exceeds the "
            f"{max_bytes}-byte gather buffer; raise max_bytes")
    buf = np.zeros(max_bytes, np.uint8)
    buf[:8] = np.frombuffer(len(blob).to_bytes(8, "little"), np.uint8)
    buf[8:8 + len(blob)] = np.frombuffer(blob, np.uint8)
    mine = torch.from_numpy(buf)
    world = dist.get_world_size(group)
    outs = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(outs, mine, group=group)
    out = []
    for row in outs:
        row = row.numpy()
        ln = int.from_bytes(bytes(row[:8]), "little")
        out.append(pickle.loads(bytes(row[8:8 + ln])))
    return out


def construct_pre_partitioned(row_shards: Sequence[np.ndarray], config,
                              categorical: Sequence[int] = (),
                              sample_per_shard: int = 0):
    """Full pre-partitioned pipeline over already-sharded rows (the
    ``pre_partition=true`` path, dataset_loader.cpp:657-704): each shard
    finds bins for its owned feature block from ITS OWN rows (optionally
    subsampled), mappers are allgathered, and each shard's rows are
    binned ONE SHARD AT A TIME against the shared mappers — the dense
    float64 view exists only per shard, never globally.  The dataset
    structure (EFB bundling, group layout) comes from shard 0's rows,
    the same owner-shard approximation the reference accepts for bins.

    Returns ``(dataset, shard_row_offsets)``; the dataset's binned
    matrix is the concatenation of the shard blocks in shard order, so
    the data-parallel learner splits it over its workers."""
    num_machines = len(row_shards)
    if num_machines == 0:
        raise LightGBMError("need at least one row shard")
    shards = [np.asarray(s, np.float64) for s in row_shards]
    nf = shards[0].shape[1]
    if any(s.shape[1] != nf for s in shards):
        raise LightGBMError("row shards disagree on feature count")
    total_rows = sum(s.shape[0] for s in shards)

    pairs = []
    for rank, s in enumerate(shards):
        sample = s
        if sample_per_shard and s.shape[0] > sample_per_shard:
            rng = make_rng(int(config.data_random_seed) + rank)
            sample = s[rng.choice(s.shape[0], sample_per_shard,
                                  replace=False)]
        pairs.append(find_bin_shard(sample, rank, num_machines, config,
                                    categorical,
                                    total_sample_cnt=sample.shape[0],
                                    num_data=total_rows))
    mappers = allgather_mappers(pairs, num_total_features=nf)

    # shard 0 defines the structure; the other shards bin against it
    # with reference alignment (CreateValid semantics) and only their
    # uint8 blocks are kept
    ds0 = BinnedDataset.construct_from_matrix(
        shards[0], config, categorical, predefined_mappers=mappers)
    blocks = [np.asarray(ds0.binned)]
    for s in shards[1:]:
        part = BinnedDataset.construct_from_matrix(s, config,
                                                   reference=ds0)
        blocks.append(np.asarray(part.binned))
    ds = ds0
    ds.binned = np.concatenate(blocks, axis=0)
    ds.num_data = total_rows
    ds.metadata = Metadata(total_rows)
    offsets = np.concatenate(
        [[0], np.cumsum([s.shape[0] for s in shards])])
    return ds, offsets
