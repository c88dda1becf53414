"""Ranking rows with the shape of MSLR-WEB30K (Microsoft Learning to Rank,
Qin and Liu 2013; LightGBM docs/Experiments.rst "MS LTR", Fold 1's
training set): query-document rows of 136 feature columns in queries of
lognormal length, labelled with relevance grades 0-4 at MSLR's skew.
The rows are ``bench.py::synth_mslr``'s, made with torch on the card:
standard normal columns, and a label that is a noisy function of them
plus a per-query offset, cut into grades at global quantiles.

* :func:`query_sizes`: the queries' lengths in row order (host int64),
  the same lengths for every seed in an order drawn from it on the host,
  the same on every device;
* :func:`make`: the rows and their grades, on the run's device.
"""

from __future__ import annotations

import math

import torch

from benchmark.data import generator

COLUMNS = 136
#: MSLR-WEB30K Fold 1's mean query length: 2,270,296 rows / 18,919
#: queries; fewer rows than a configuration states (a test's size) get
#: fewer queries, none shorter than this on average
MEAN_LENGTH = 120
#: the spread of the lengths' logarithm
SIGMA = 0.7
#: the cumulative shares of grades 0-3 (52, 32, 13, 2 and 1%)
GRADE_CUTS = (0.52, 0.84, 0.97, 0.99)
#: the stream offset of the lengths' order (apart from the rows')
SIZE_STREAM = 1 << 20


def query_sizes(n: int, seed: int, stream: int, queries: int,
                longest_query: int) -> torch.Tensor:
    """(q,) int64 lengths summing to exactly ``n``: ``queries`` of them
    (at most one per :data:`MEAN_LENGTH` rows) at the quantiles of a
    lognormal law with mean ``n / q`` and :data:`SIGMA`, none longer than
    ``longest_query`` and one that long, none empty; their order drawn
    from the seed.  The lengths themselves are the same for every seed,
    as a published fold's are: a draw of each length would move the
    longest queries, and with them the work of the program's padded
    gradient, from seed to seed."""
    q = min(int(queries), max(1, n // MEAN_LENGTH))
    top_len = min(int(longest_query), n - q + 1)
    if q == 1:
        return torch.tensor([n], dtype=torch.int64)
    mu = math.log(n / q) - SIGMA * SIGMA / 2
    u = (torch.arange(q, dtype=torch.float64) + 0.5) / q
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    raw = torch.exp(mu + SIGMA * z).clamp(1.0, top_len)
    # the longest query, and the rest scaled to the rows left
    rest = n - top_len
    share = raw[:-1] * (rest / float(raw[:-1].sum()))
    size = share.floor().clamp(1, top_len).long()
    left = rest - int(size.sum())
    # the rows left over by the rounding, one a query, to those whose
    # share lost most; rows taken back from the largest
    while left != 0:
        room = size < top_len if left > 0 else size > 1
        key = (share - size if left > 0 else share).masked_fill(
            ~room, -math.inf)
        pick = key.topk(min(abs(left), int(room.sum()))).indices
        step = 1 if left > 0 else -1
        size[pick] += step
        left -= step * len(pick)
    sizes = torch.cat([size, torch.tensor([top_len])])
    g = generator(seed, stream + SIZE_STREAM, "cpu")
    return sizes[torch.randperm(q, generator=g)]


def make(n: int, seed: int, stream: int, device, queries: int = None,
         longest_query: int = None, **_):
    """(x (n, 136) float32, y (n,) float32 grades 0-4) over the queries
    of :func:`query_sizes` with the same arguments."""
    if queries is None or longest_query is None:
        raise ValueError("the mslr rows need queries and longest_query")
    sizes = query_sizes(n, seed, stream, queries, longest_query)
    g = generator(seed, stream, device)
    kw = dict(generator=g, device=device, dtype=torch.float32)
    w = torch.randn((COLUMNS, 2), **kw) / math.sqrt(COLUMNS)
    x = torch.randn((n, COLUMNS), **kw)
    qoff = torch.repeat_interleave(torch.randn((len(sizes),), **kw),
                                   sizes.to(device))
    xw = x @ w
    util = (xw[:, 0] + 0.7 * xw[:, 1].abs() + 0.8 * qoff
            + 0.9 * torch.randn((n,), **kw))
    ranked = torch.sort(util).values
    cuts = ranked[[int(c * (n - 1)) for c in GRADE_CUTS]]
    y = torch.bucketize(util, cuts, right=True).to(torch.float32)
    return x, y
