"""The lambdarank gradient's counted work, beside the frozen counts of
``cost.py`` (whose row-wise ``gradients`` it replaces in a ranking
cell), held to the same peaks (``cost.least_seconds``).  It is counted
from the queries and labels the benchmark made, never from the
program's buckets, so it reads the same work whatever computes the
gradient: padding that a program adds or cuts moves the time it is held
against and not the count.

The float32 operations of one label-ordered pair, as the reference
(``reference/objectives/lambdarank.py``) does them:

* the score difference, its absolute value and ``0.01 + |delta|``: 3;
* the gain difference, ``|disc_i - disc_j|`` (2), the two products with
  it and with the inverse max DCG, the division by the score distance:
  6;
* the sigmoid ``2 / (1 + exp(2 sigma delta))``: a product, the
  exponential, an add and a division: 4;
* the lambda ``p * dNDCG``: 1; the hessian ``2 dNDCG p (2 - p)``: 4;
* the four sums (lambda into the high and the low document, the
  hessian into both): 4.

That is 22 a pair.  Sorting a query of L documents by score takes
``L ceil(log2 L)`` compares, one operation each.  Bytes: each row's
score and label read and its gradient and hessian written (float32: 16
bytes), and each query's boundary read (8 bytes).
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import torch

PAIR_OPS = 22
ROW_BYTES = 16
QUERY_BYTES = 8


def label_ordered_pairs(y: torch.Tensor, sizes: torch.Tensor) -> int:
    """The pairs of documents of one query whose labels differ, each
    counted once: per query of L documents, ``(L**2 - sum over labels of
    its count**2) / 2``.  ``y`` holds whole-number labels, ``sizes`` the
    query lengths in row order."""
    lab = y.reshape(-1).long()
    sizes = sizes.to(lab.device).long()
    q = torch.repeat_interleave(torch.arange(len(sizes), device=lab.device),
                                sizes)
    counts = torch.zeros((len(sizes), int(lab.max()) + 1), dtype=torch.int64,
                         device=lab.device)
    counts.index_put_((q, lab), torch.ones_like(lab), accumulate=True)
    return (int((sizes * sizes).sum()) - int((counts * counts).sum())) // 2


def rank_gradients(rows: int, query_sizes: Iterable[int],
                   pairs: int) -> Tuple[float, float]:
    """(bytes, flops) of one gradient of every row."""
    sizes = [int(n) for n in query_sizes]
    compares = sum(n * math.ceil(math.log2(n)) for n in sizes if n > 1)
    return (float(rows * ROW_BYTES + len(sizes) * QUERY_BYTES),
            float(pairs * PAIR_OPS + compares))

