"""Data-parallel tree learner (counterpart of
``lightgbm_tpu/parallel/data_parallel.py``, reference
``src/treelearner/data_parallel_tree_learner.cpp``).

Rows are split contiguously over the network's workers: worker ``d``
owns the global rows ``[d * n_loc, d * n_loc + n_valid[d])`` (``n_loc``
the power-of-two bucket of ``ceil(N / D)``, as the JAX learner lays them
out) and holds their codes on its device.  Each worker keeps its own
index buffer and a ``(begin, count)`` window a leaf; only the global
counts are known to the host loop, as in the reference.  A leaf's
histogram is kernel 1's list mode once a worker over the worker's window
(``ops/hist_cuda.wave_hist_rows_sharded``), the workers' int64
fixed-point sums reduced before the one conversion, with the exponents of
the leaf's global row count: on the card the global histogram is the
serial learner's bit for bit, so the trees are too.  The split search runs
on the reduced histogram with global counts, and each worker partitions
its own window.  The reduction is logged as one ``(G, NB, 3)`` f32
allreduce a histogram, the JAX learner's comm volume.

Bagging and GOSS draw the serial learner's selection at its canonical
global shape and give each worker its rows of it, so a bagged data-parallel
tree is the serial one too (the JAX learner draws per worker).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..ops.hist_cuda import exponents_for_rows, wave_hist_rows_sharded
from ..ops.histogram import bucket_size, stat_columns
from ..ops.partition import apply_leaf_outputs, partition_leaf
from ..tree.learner import SerialTreeLearner, SplitParams, _LeafInfo
from .network import Network


class DataParallelTreeLearner(SerialTreeLearner):
    """Rows split over the workers; leaf histograms reduced exactly."""

    def __init__(self, config, dataset, device: torch.device,
                 network: Network, binned_t=None):
        super().__init__(config, dataset, device, binned_t)
        self.net = network
        d = network.num_machines
        n = self.num_data
        self.n_shards = d
        self.n_loc = bucket_size(max(int(math.ceil(n / d)), 1))
        self.n_valid = np.clip(n - np.arange(d) * self.n_loc, 0,
                               self.n_loc).astype(np.int64)
        self.row_lo = np.minimum(np.arange(d) * self.n_loc, n)
        # each worker's (G, n_valid[d]) codes on its device
        self.shard_codes = [
            self.binned_t[:, lo:lo + nv].to(dev, copy=True).contiguous()
            for lo, nv, dev in zip(self.row_lo, self.n_valid, network.mesh)]
        self._full = [torch.arange(int(nv), dtype=torch.int32, device=dev)
                      for nv, dev in zip(self.n_valid, network.mesh)]
        self.buffers = None
        self.leaf_begin = self.leaf_count = None

    # ------------------------------------------------------------------
    def _split_selection(self, buf: torch.Tensor, cnt: int):
        """Each worker's local rows of a global selection (the first
        ``cnt`` entries of ``buf``), in order: (buffers, counts)."""
        sel = buf[:cnt].long()
        bufs, counts = [], []
        for lo, nv, dev in zip(self.row_lo, self.n_valid, self.net.mesh):
            mine = sel[(sel >= lo) & (sel < lo + nv)] - int(lo)
            bufs.append(mine.to(device=dev, dtype=torch.int32))
            counts.append(int(mine.shape[0]))
        return bufs, np.asarray(counts, np.int64)

    def bagging_state(self, seed: int, fraction: float):
        buf, cnt = super().bagging_state(seed, fraction)
        return self._split_selection(buf, cnt), cnt

    def goss_state(self, seed: int, score_abs: torch.Tensor, top_rate: float,
                   other_rate: float):
        buf, cnt, mult = super().goss_state(seed, score_abs, top_rate,
                                            other_rate)
        return self._split_selection(buf, cnt), cnt, mult

    def _init_state(self, indices_buffer, data_count, grad, hess):
        if indices_buffer is None:
            bufs, counts = self._full, self.n_valid
            data_count = self.num_data
        else:
            bufs, counts = indices_buffer
        # private copies: partitions rewrite them in place
        self.buffers = [b.clone() for b in bufs]
        self.data_count = int(data_count)
        L = int(self.config.num_leaves)
        self.leaf_begin = np.zeros((self.n_shards, L), np.int64)
        self.leaf_count = np.zeros((self.n_shards, L), np.int64)
        self.leaf_count[:, 0] = counts
        self._next_leaf = 1
        self._shard_ghk = []
        amax = None
        for lo, nv, dev in zip(self.row_lo, self.n_valid, self.net.mesh):
            ghk = stat_columns(grad[lo:lo + nv], hess[lo:lo + nv]).to(dev)
            self._shard_ghk.append(ghk)
            if nv:
                m = ghk.abs().amax(dim=0).to(self.device)
                amax = m if amax is None else torch.maximum(amax, m)
        self._amax = amax
        return grad, hess

    def _windows(self, leaf: int):
        """Each worker's window of ``leaf``: (begin, count) pairs."""
        return [(int(self.leaf_begin[d, leaf]), int(self.leaf_count[d, leaf]))
                for d in range(self.n_shards)]

    def _leaf_histogram(self, grad, hess, info: _LeafInfo):
        shards = [(c, gh, buf[b:b + n]) for c, gh, buf, (b, n) in zip(
            self.shard_codes, self._shard_ghk, self.buffers,
            self._windows(info.leaf_id))]
        hist = wave_hist_rows_sharded(
            shards, nb=self.nb, k=3, device=self.device,
            scale_exp=exponents_for_rows(self._amax, info.count))
        # the one collective a split: the global histogram
        self.net._log("allreduce", hist)
        return hist

    def _partition(self, info: _LeafInfo, sp: SplitParams) -> int:
        """Each worker partitions its window; the right child's windows
        go to the leaf id the tree gives it next."""
        member = torch.as_tensor(sp.cat_member) if sp.is_cat else None
        right = self._next_leaf
        self._next_leaf += 1
        total = 0
        for d, (b, n) in enumerate(self._windows(info.leaf_id)):
            buf, codes = self.buffers[d], self.shard_codes[d]
            left = 0
            if n:
                rows, left = partition_leaf(
                    codes, buf[b:b + n], group=sp.group, offset=sp.offset,
                    width=sp.width, default_bin=sp.default_bin,
                    num_bin=sp.num_bin, missing=sp.missing,
                    threshold=sp.threshold, default_left=sp.default_left,
                    is_cat=sp.is_cat, cat_member=None if member is None
                    else member.to(codes.device))
                buf[b:b + n] = rows
            self.leaf_count[d, info.leaf_id] = left
            self.leaf_begin[d, right] = b + left
            self.leaf_count[d, right] = n - left
            total += left
        return total

    # ------------------------------------------------------------------
    def update_score(self, score: torch.Tensor, tree,
                     multiplier: float = 1.0) -> torch.Tensor:
        """Each worker adds its leaves' outputs to its rows of the global
        score through its windows, in place."""
        leaves = sorted(self.leaves)
        vals = {leaf: tree.leaf_value[leaf] * multiplier for leaf in leaves}
        for d, (lo, nv) in enumerate(zip(self.row_lo, self.n_valid)):
            if not nv:
                continue
            order = sorted(leaves, key=lambda leaf: (
                self.leaf_begin[d, leaf], self.leaf_count[d, leaf]))
            apply_leaf_outputs(
                score[lo:lo + nv], self.buffers[d].to(score.device),
                [int(self.leaf_count[d, leaf]) for leaf in order],
                np.asarray([vals[leaf] for leaf in order], np.float32))
        return score

    def leaf_indices_host(self) -> Dict[int, np.ndarray]:
        bufs = [b.cpu().numpy() for b in self.buffers]
        out = {}
        for leaf in self.leaves:
            parts = [int(lo) + bufs[d][b:b + n] for d, (lo, (b, n)) in
                     enumerate(zip(self.row_lo, self._windows(leaf)))]
            out[leaf] = np.concatenate(parts).astype(np.int64)
        return out
