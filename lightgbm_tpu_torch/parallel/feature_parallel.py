"""Feature-parallel tree learner (counterpart of
``lightgbm_tpu/parallel/feature_parallel.py``, reference
``src/treelearner/feature_parallel_tree_learner.cpp``).

Every worker holds all rows (the partition is the serial learner's, the
same on every worker); the feature *search* is split: worker ``w`` owns
the contiguous block of feature groups ``[w * g_loc, (w + 1) * g_loc)``,
builds its groups' histograms with kernel 1's list mode over the leaf's
window (``ops/hist_cuda.wave_hist_rows_sharded``, one launch a worker on
its block of the codes) and scans only its own features.  The best split
is elected by ``argmax_allreduce`` of the workers' records, keyed by gain
with ties to the smaller feature id (``SyncUpGlobalBestSplit``,
``parallel_tree_learner.h:183-207``), which is the serial argmax's order.
A group's histogram does not depend on which worker sums it, so the trees
are the serial learner's byte for byte.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.hist_cuda import exponents_for_rows, wave_hist_rows_sharded
from ..ops.split import F_FEATURE, F_GAIN, find_best_split
from ..tree.learner import SerialTreeLearner, _LeafInfo
from .network import Network


class FeatureParallelTreeLearner(SerialTreeLearner):
    """Feature groups split over the workers; split records elected."""

    def __init__(self, config, dataset, device: torch.device,
                 network: Network, binned_t=None):
        super().__init__(config, dataset, device, binned_t)
        self.net = network
        d = network.num_machines
        g = dataset.num_groups
        self.g_loc = max(int(math.ceil(g / d)), 1)
        self.group_lo = [min(w * self.g_loc, g) for w in range(d)]
        self.group_hi = [min((w + 1) * self.g_loc, g) for w in range(d)]
        # each worker's block of the codes, every row
        self.shard_codes = [
            self.binned_t[lo:hi].to(dev, copy=True).contiguous()
            for lo, hi, dev in zip(self.group_lo, self.group_hi,
                                   network.mesh)]
        f_group = torch.as_tensor(np.asarray(dataset.f_group, np.int64),
                                  device=device)
        self._owned = [(f_group >= lo) & (f_group < hi)
                       for lo, hi in zip(self.group_lo, self.group_hi)]

    def _leaf_histogram(self, grad, hess, info: _LeafInfo):
        rows = self._rows(info)
        parts = wave_hist_rows_sharded(
            [(c, self._ghk.to(c.device), rows.to(c.device))
             for c in self.shard_codes],
            nb=self.nb, k=3, reduce=False,
            scale_exp=exponents_for_rows(self._amax, info.count))
        return torch.cat([p.to(self.device) for p in parts])

    def _find_best(self, info: _LeafInfo, feature_mask):
        total = torch.as_tensor(np.asarray(info.total, np.float32),
                                device=self.device)
        recs = self.net.run_sharded(lambda owned: find_best_split(
            info.hist[None], total[None], feature_mask & owned, self.meta,
            self.hyper, has_cat=self.has_cat,
            constraint=(info.cmin, info.cmax)))(self._owned)
        keys = [p[0, F_GAIN] for p, _, _ in recs]
        ties = [p[0, F_FEATURE].to(torch.int32) for p, _, _ in recs]
        if self.has_cat:
            out, _ = self.net.argmax_allreduce(
                keys, [(p[0], m[0]) for p, m, _ in recs], ties)
            packed, member = out[0]
            return packed, member > 0.5
        out, _ = self.net.argmax_allreduce(keys, [p[0] for p, _, _ in recs],
                                           ties)
        return out[0], None
