"""Voting-parallel tree learner (PV-Tree; counterpart of
``lightgbm_tpu/parallel/voting_parallel.py``, reference
``src/treelearner/voting_parallel_tree_learner.cpp``).

Rows are split over the workers as in the data-parallel learner, but the
full histogram is not reduced.  For each leaf every worker

1. builds its local histogram (kernel 1's list mode over its window, with
   the exponents of the leaf's global row count) and local totals; the
   totals are allreduced;
2. finds its local per-feature best gains with ``min_data_in_leaf`` and
   ``min_sum_hessian_in_leaf`` divided by the number of workers
   (``voting_parallel_tree_learner.cpp:53-55``) and proposes its top
   ``top_k`` features (``:322-341``);
3. a global vote elects the ``2 * top_k`` most-proposed features, ties to
   the smaller feature id (``GlobalVoting``, ``:166-195``);
4. only the elected features' histogram rows are allreduced
   (``:365-366``), and the final scan runs on them with the global
   totals (:func:`_elected_best_impl`).

The comm volume a split drops from ``(G, NB, 3)`` to ``(2k, 256, 3)``.
Voting trees can differ from serial ones when the best feature is not
elected; with ``top_k`` covering every feature they are the serial trees
up to the f32 sums of the local histograms (the elected rows are summed
in f32, not in fixed point).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hist_cuda import exponents_for_rows, wave_hist_rows_sharded
from ..ops.split import (NEG_INF, FeatureMeta, find_best_split,
                         feature_histograms, masked_feature_gain,
                         min_gain_shift_of, per_feature_best)
from ..tree.learner import _LeafInfo
from .data_parallel import DataParallelTreeLearner
from .network import Network


def _elected_best_impl(fh_raw, total, constraint, feature_mask, eids,
                       meta: FeatureMeta, hp, has_cat: bool, num_slots: int):
    """The final scan over the elected features' global histograms
    (``fh_raw`` (E, 256, 3), their default bins still empty; ``eids``
    (E,) int64, -1 padded): the raw rows go back to their slots of an
    otherwise empty flat histogram and the serial scan runs there with
    every other feature masked, so the argmax's tie order is the serial
    one (ascending feature id)."""
    real = eids >= 0
    idx = meta.slot_idx[eids.clamp(min=0)]
    ok = meta.valid_nondefault[eids.clamp(min=0)] & real[:, None]
    flat = torch.zeros((num_slots, 3), dtype=fh_raw.dtype,
                       device=fh_raw.device)
    flat[idx[ok]] = fh_raw[ok]
    elected = torch.zeros_like(feature_mask)
    elected[eids[real]] = True
    packed, member, _ = find_best_split(
        flat[None], total[None], feature_mask & elected, meta, hp,
        has_cat=has_cat, constraint=constraint)
    return packed[0], None if member is None else member[0]


class VotingParallelTreeLearner(DataParallelTreeLearner):
    """Data-parallel with top-k feature voting."""

    def __init__(self, config, dataset, device: torch.device,
                 network: Network, binned_t=None):
        super().__init__(config, dataset, device, network, binned_t)
        nf = dataset.num_features
        self.k = max(1, min(int(config.top_k), nf))
        self.n_elect = min(2 * self.k, nf)
        d = network.num_machines
        hp = self.hyper
        self._hyper_local = hp._replace(
            min_data_in_leaf=hp.min_data_in_leaf / d,
            min_sum_hessian_in_leaf=hp.min_sum_hessian_in_leaf / d)

    # a histogram handle: (local hists, local totals, global totals)
    def _leaf_histogram(self, grad, hess, info: _LeafInfo):
        shards = [(c, gh, buf[b:b + n]) for c, gh, buf, (b, n) in zip(
            self.shard_codes, self._shard_ghk, self.buffers,
            self._windows(info.leaf_id))]
        local = wave_hist_rows_sharded(
            shards, nb=self.nb, k=3, reduce=False,
            scale_exp=exponents_for_rows(self._amax, info.count))
        loc_tot = [h[:self.nb].sum(0) for h in local]
        glob_tot = self.net.allreduce(loc_tot)[0]
        return local, loc_tot, glob_tot

    def _leaf_totals(self, hist) -> np.ndarray:
        return hist[2].double().cpu().numpy()

    def _subtract(self, parent, small):
        return ([a - b for a, b in zip(parent[0], small[0])],
                [a - b for a, b in zip(parent[1], small[1])],
                parent[2] - small[2])

    def _find_best(self, info: _LeafInfo, feature_mask):
        local, loc_tot, glob_tot = info.hist
        meta, nf = self.meta, self.dataset.num_features
        cmin, cmax = float(np.float32(info.cmin)), \
            float(np.float32(info.cmax))

        # 1-2. local per-feature bests -> each worker's top-k vote
        def vote(h, tot):
            h, tot = h.to(self.device), tot.to(self.device)
            shift = min_gain_shift_of(tot[None], self._hyper_local)
            fh = feature_histograms(h[None], tot[None], meta)
            pf = per_feature_best(fh, tot[None], meta, self._hyper_local,
                                  shift, cmin, cmax, has_cat=self.has_cat)
            gains = masked_feature_gain(pf, meta, feature_mask, shift)[0]
            order = torch.sort(gains, descending=True, stable=True)
            return order.indices[:self.k], order.values[:self.k]
        votes_by_worker = self.net.run_sharded(vote)(local, loc_tot)

        # 3. the election (GlobalVoting), on the host
        votes = np.zeros(nf, np.int64)
        for ids, gains in votes_by_worker:
            ids, gains = ids.cpu().numpy(), gains.cpu().numpy()
            np.add.at(votes, ids[gains > NEG_INF / 2], 1)
        order = np.lexsort((np.arange(nf), -votes))[:self.n_elect]
        elected = np.sort(order[votes[order] > 0])
        eids = np.full(self.n_elect, -1, np.int64)
        eids[:len(elected)] = elected
        eids_t = torch.as_tensor(eids, device=self.device)

        # 4. allreduce the elected features' raw histograms only
        safe = eids_t.clamp(min=0)
        real = (eids_t >= 0)[:, None, None]

        def gather(h):
            h = h.to(self.device)
            return h[meta.slot_idx[safe]] \
                * (meta.valid_nondefault[safe][..., None] & real)
        fh_raw = self.net.allreduce(self.net.run_sharded(gather)(local))[0]
        return _elected_best_impl(fh_raw, glob_tot.to(self.device),
                                  (info.cmin, info.cmax), feature_mask,
                                  eids_t, meta, self.hyper, self.has_cat,
                                  int(local[0].shape[0]))
