"""LambdaRank with NDCG, LightGBM v2.2.2's ``lambdarank`` objective
(``src/objective/rank_objective.hpp``, ``LambdarankNDCG::
GetGradientsForOneQuery``), in plain float64 torch, query by query: the
queries of one length are worked together, each in its own (L, L) pair
matrix, with no padding to a shared size.

For each query of L documents, with ``gain(l) = 2**l - 1`` (the default
``label_gain``) and the discount ``1 / log2(2 + i)`` of position i:

* ``inverse_max_dcg``: 1 over the DCG of the query's labels sorted
  descending, at its first ``max_position`` (20) positions (0 when that
  DCG is 0: the query then has no pair);
* the documents are sorted by score, descending and stable (ties keep
  the query's order); every pair (high at position i, low at position j)
  whose labels order it, ``label_high > label_low``, gives
  ``delta_pair_NDCG = (gain_high - gain_low) * |disc_i - disc_j| *
  inverse_max_dcg``, divided by ``0.01f + |s_high - s_low|`` when the
  query's best and worst scores differ;
* ``p = 2 / (1 + exp(2 * sigmoid * (s_high - s_low)))``; ``-p * dNDCG``
  is added to the high document's gradient and subtracted from the low
  one's; ``2 * dNDCG * p * (2 - p)`` is added to both hessians.

``init_score`` is 0: lambdarank has no BoostFromScore.

Departures from v2.2.2:

* the sigmoid is exact, where v2.2.2 reads a table of 2^20 bins over
  ``[-50, 50] / sigmoid``; the table's error (~1e-4 of p at its steepest)
  lies far below the bfloat16 rounding of the gradient columns that the
  configurations state;
* sums in float64 (v2.2.2 sums a document's pairs in double and adds
  them to float32 gradients); the caller rounds as the configuration
  states;
* no row weights (the benchmark's ranking configuration has none) and no
  score at ``kMinScore`` (-inf: no score of a trained model is).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
#: v2.2.2's score-distance term, the float literal ``0.01f``
SCORE_EPS = float(np.float32(0.01))
#: pair cells a working set holds at most (one float64 (B, L, L) temporary)
PAIR_BUDGET = 1 << 24


def default_label_gain(n: int = 31) -> List[float]:
    return [float((1 << i) - 1) for i in range(n)]


class Lambdarank:
    """The objective bound to one set's query boundaries and the
    configuration's ``label_gain``, ``max_position`` and ``sigmoid``."""

    def __init__(self, query_boundaries, params: dict):
        qb = np.asarray(query_boundaries, np.int64).reshape(-1)
        if len(qb) < 2 or qb[0] != 0 or (np.diff(qb) < 0).any():
            raise ValueError("query boundaries must rise from 0")
        self.qb = qb
        self.label_gain = [float(g) for g in
                           (params.get("label_gain") or default_label_gain())]
        self.max_position = int(params.get("max_position", 20))
        self.sigmoid = float(params.get("sigmoid", 1.0))
        if self.sigmoid <= 0:
            raise ValueError("sigmoid must be greater than zero")
        sizes = np.diff(qb)
        #: query length -> the first rows of its queries
        self.by_length: Dict[int, np.ndarray] = {
            int(n): qb[:-1][sizes == n] for n in np.unique(sizes) if n > 1}

    def init_score(self, y: torch.Tensor) -> float:
        return 0.0

    def gradients(self, score: torch.Tensor, y: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gradient, hessian) of every row, float64, from the float32
        scores."""
        g, h, _ = self.terms(score, y)
        return g, h

    def terms(self, score: torch.Tensor, y: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(gradient, hessian, magnitude) of every row, float64: the
        magnitude is the sum of the absolute values of a row's pair
        lambdas, the scale its gradient is summed at (a row's lambdas have
        both signs)."""
        dev = score.device
        s = score.to(F64).reshape(-1)
        lab = y.to(dev).reshape(-1).long()
        if int(self.qb[-1]) != s.numel() or lab.numel() != s.numel():
            raise ValueError(f"{s.numel()} scores for queries of "
                             f"{int(self.qb[-1])} rows")
        if int(lab.min()) < 0 or int(lab.max()) >= len(self.label_gain):
            raise ValueError("labels outside label_gain")
        gains = torch.tensor(self.label_gain, dtype=F64, device=dev)
        out = torch.zeros((3, s.numel()), dtype=F64, device=dev)
        for n, starts in self.by_length.items():
            per = max(1, PAIR_BUDGET // (n * n))
            offs = torch.arange(n, device=dev)
            for b in range(0, len(starts), per):
                first = torch.as_tensor(starts[b:b + per], device=dev)
                self._queries(first[:, None] + offs, s, lab, gains, out)
        return out[0], out[1], out[2]

    def _queries(self, rows, s, lab, gains, out) -> None:
        """The pair sums of the B queries of one length L, ``rows`` (B, L),
        into ``out``'s rows."""
        n = rows.shape[1]
        dev = s.device
        disc = 1.0 / torch.log2(torch.arange(2, 2 + n, dtype=F64,
                                             device=dev))
        # inverse max DCG at max_position
        k = min(n, self.max_position)
        ideal = torch.sort(lab[rows], dim=1, descending=True).values[:, :k]
        mdcg = (gains[ideal] * disc[:k]).sum(1)
        inv = torch.where(mdcg > 0, 1.0 / mdcg, torch.zeros_like(mdcg))
        # documents by score, descending and stable
        order = torch.sort(s[rows], dim=1, descending=True,
                           stable=True).indices
        srow = rows.gather(1, order)
        ss, ls = s[srow], lab[srow]
        gl = gains[ls]
        spread = ss[:, 0] != ss[:, -1]
        delta = ss[:, :, None] - ss[:, None, :]
        pdisc = (disc[:, None] - disc[None, :]).abs()
        dndcg = (gl[:, :, None] - gl[:, None, :]) * pdisc * inv[:, None, None]
        dndcg = torch.where(spread[:, None, None],
                            dndcg / (SCORE_EPS + delta.abs()), dndcg)
        p = 2.0 / (1.0 + torch.exp(2.0 * self.sigmoid * delta))
        pair = ls[:, :, None] > ls[:, None, :]
        lam = torch.where(pair, -p * dndcg, 0.0)
        hes = torch.where(pair, 2.0 * dndcg * p * (2.0 - p), 0.0)
        flat = srow.reshape(-1)
        out[0].index_put_((flat,), (lam.sum(2) - lam.sum(1)).reshape(-1))
        out[1].index_put_((flat,), (hes.sum(2) + hes.sum(1)).reshape(-1))
        mag = lam.abs()
        out[2].index_put_((flat,), (mag.sum(2) + mag.sum(1)).reshape(-1))


def bind(query_boundaries: Sequence[int], params: dict) -> Lambdarank:
    """The objective of a set with these query boundaries (from 0, one
    past each query's last row), as ``compare.judge_trees`` takes it:
    ``init_score(y)`` and ``gradients(score, y)``."""
    return Lambdarank(query_boundaries, params)
