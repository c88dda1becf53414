"""LambdarankNDCG objective (reference ``src/objective/rank_objective.hpp``).

Counterpart of ``lightgbm_tpu/objectives/rank.py:35-245``.  In place of
the reference's per-query pair loops, queries are padded into power-of-two
length buckets (at least 8) and every (doc_i, doc_j) pair of a query is a
(P, P) matrix: sort by score, broadcast the deltas, mask the pairs whose
labels do not order them, and row/column-sum the pairwise lambdas.  A
bucket runs in batches of at most ``_PAIR_BUDGET // P**2`` queries to bound
the (B, P, P) working set.

The host part (``init``: inverse max DCG, the buckets, the inverse
permutation) is numpy; the gradient is torch ops on the scores' device
with its loop over buckets and batches fixed at ``init``: no host read, no
data-dependent branch, so a captured CUDA graph can replay it
(``ops/graphs.py``).  As in the JAX package the sigmoid is exact,
``2 / (1 + exp(2 sigma delta))``, not the reference's lookup table.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.log import LightGBMError
from .base import ObjectiveFunction

_PAIR_BUDGET = 1 << 24   # floats of one (B, P, P) temporary
_MIN_BUCKET = 8


def default_label_gain(n=31) -> List[float]:
    return [float((1 << i) - 1) for i in range(n)]


def _pair_grads(gain_table, sigmoid: float, score_ext, rows, labels, valid,
                inv_mdcg, pdisc):
    """(lambda, hessian) of a batch of B queries padded to P documents,
    each (B, P) in the batch's row order (``_bucket_grads``'s
    ``one_query``, lightgbm_tpu/objectives/rank.py:188-218)."""
    s = score_ext[rows]                                       # (B, P)
    order = torch.sort(-s.masked_fill(~valid, float("-inf")), dim=1,
                       stable=True).indices
    ss = s.gather(1, order)
    ls = labels.gather(1, order)
    vs = valid.gather(1, order)
    g = gain_table[ls.clamp(min=0)]
    cnt = vs.sum(1)
    best = ss[:, 0]
    worst = ss.gather(1, (cnt - 1).clamp(min=0)[:, None])[:, 0]
    delta = ss[:, :, None] - ss[:, None, :]                   # (B, P, P)
    dndcg = (g[:, :, None] - g[:, None, :]) * pdisc * inv_mdcg[:, None, None]
    dndcg = torch.where((best != worst)[:, None, None],
                        dndcg / (0.01 + delta.abs()), dndcg)
    mask = (vs[:, :, None] & vs[:, None, :]
            & (ls[:, :, None] > ls[:, None, :]))
    sig = 2.0 / (1.0 + torch.exp(2.0 * sigmoid * delta))
    del delta
    lam = torch.where(mask, -dndcg * sig, 0.0)
    hes = torch.where(mask, 2.0 * dndcg * sig * (2.0 - sig), 0.0)
    del dndcg, sig, mask
    lam_s = lam.sum(2) - lam.sum(1)
    hes_s = hes.sum(2) + hes.sum(1)
    # un-sort: position order[b, k] of the query takes sorted entry k
    return (torch.empty_like(lam_s).scatter_(1, order, lam_s),
            torch.empty_like(hes_s).scatter_(1, order, hes_s))


def rank_grad(score, args):
    """(grad, hess) of every row from the (N,) f32 score: each batch of
    each bucket's pair matrices, then ONE gather through the inverse
    permutation (``_all_grads``, lightgbm_tpu/objectives/rank.py:231)."""
    gain_table, sigmoid, buckets, inv_perm, weights = args
    score_ext = F.pad(score, (0, 1))          # pads read the trailing 0
    flats = []
    for rows, labels, valid, inv_mdcg, pdisc, batch in buckets:
        for b0 in range(0, rows.shape[0], batch):
            sl = slice(b0, b0 + batch)
            lam, hes = _pair_grads(gain_table, sigmoid, score_ext, rows[sl],
                                   labels[sl], valid[sl], inv_mdcg[sl],
                                   pdisc)
            flats.append(torch.stack([lam.reshape(-1), hes.reshape(-1)], 1))
    gh = torch.cat(flats).index_select(0, inv_perm)
    g, h = gh[:, 0], gh[:, 1]
    if weights is not None:
        g, h = g * weights, h * weights
    return g, h


class LambdarankNDCG(ObjectiveFunction):
    name = "lambdarank"
    # gradients are query-segment sums (the JAX package keeps its fused
    # path's rows unbucketed for it)
    device_grad_rowwise = False

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        gains = list(config.label_gain or [])
        self.label_gain = [float(g) for g in gains] or default_label_gain()
        self.max_position = int(getattr(config, "max_position", 20) or 20)
        if self.sigmoid <= 0:
            raise LightGBMError("sigmoid param must be greater than zero")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        qb = metadata.query_boundaries
        if qb is None:
            raise LightGBMError("Lambdarank tasks require query information")
        self.query_boundaries = np.asarray(qb, np.int64)
        num_queries = len(qb) - 1
        labels = self.label.astype(np.int32)
        if labels.max(initial=0) >= len(self.label_gain):
            raise LightGBMError(
                f"label_gain has {len(self.label_gain)} entries but labels "
                f"reach {labels.max()}; set label_gain explicitly")
        # inverse max DCG per query at max_position (rank_objective.hpp:56-67)
        disc = 1.0 / np.log2(np.arange(2, 2 + max(self.max_position, 1)))
        gains = np.asarray(self.label_gain, np.float64)
        inv_mdcg = np.zeros(num_queries)
        for q in range(num_queries):
            ls = np.sort(labels[qb[q]:qb[q + 1]])[::-1][:self.max_position]
            mdcg = (gains[ls] * disc[:len(ls)]).sum()
            inv_mdcg[q] = 1.0 / mdcg if mdcg > 0 else 0.0
        # queries by padded length; each bucket padded to whole batches of
        # dummy queries (rows -> the trailing zero score, invalid)
        lengths = np.diff(self.query_boundaries)
        pads = np.maximum(_MIN_BUCKET, 1 << np.ceil(np.log2(
            np.maximum(lengths, 1))).astype(np.int64))
        i64 = dict(dtype=torch.int64, device=device)
        self.bucket_sizes = {}
        buckets, flat_rows = [], []
        for p in sorted(set(pads.tolist())):
            qs = np.flatnonzero(pads == p)
            batch = max(1, min(_PAIR_BUDGET // (p * p), len(qs)))
            nq = -(-len(qs) // batch) * batch
            rows = np.full((nq, p), num_data, np.int64)
            labs = np.zeros((nq, p), np.int64)
            inv = np.zeros(nq, np.float32)
            for i, q in enumerate(qs):
                lo, hi = qb[q], qb[q + 1]
                rows[i, :hi - lo] = np.arange(lo, hi)
                labs[i, :hi - lo] = labels[lo:hi]
            inv[:len(qs)] = inv_mdcg[qs]
            d = 1.0 / torch.log2(torch.arange(2, 2 + p, dtype=torch.float32))
            buckets.append((torch.as_tensor(rows, **i64),
                            torch.as_tensor(labs, **i64),
                            torch.as_tensor(rows != num_data, device=device),
                            torch.as_tensor(inv, device=device),
                            (d[:, None] - d[None, :]).abs().to(device),
                            batch))
            self.bucket_sizes[p] = (len(qs), batch)
            flat_rows.append(rows.reshape(-1))
        # position of each data row in the concatenated bucket layout:
        # the gradients assemble with one gather
        concat = np.concatenate(flat_rows)
        pos = np.zeros(num_data + 1, np.int64)
        pos[concat] = np.arange(len(concat))
        self._gargs = (torch.as_tensor(self.label_gain, dtype=torch.float32,
                                       device=device),
                       self.sigmoid, tuple(buckets),
                       torch.as_tensor(pos[:num_data], **i64),
                       self.weights_d)

    def get_gradients(self, scores):
        return rank_grad(scores[0].float(), self._gargs)

    def device_grad(self):
        """(lightgbm_tpu/objectives/rank.py:139-170): the bucket loop is
        fixed at ``init``."""
        return rank_grad, self._gargs

    def to_string(self):
        return self.name
