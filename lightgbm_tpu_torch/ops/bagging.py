"""Row bagging: a Bernoulli in-bag draw per bagging round, and GOSS's
one-side selection.

Counterpart of ``lightgbm_tpu/ops/bagging.py``.  The uniform draw comes from the port's Threefry (``utils/random.py``) with
the JAX package's key and shape, so the bags are its bags bit for bit:
``PRNGKey(seed)`` with ``seed = (bagging_seed + it) & 0x7FFFFFFF`` and
``(n_pad,)`` uniforms, ``n_pad`` being the host learner's bagging-buffer
pad ``bucket_size(num_data)``.  :func:`bag_mask` takes the key as a
``(2,)`` int64 tensor, so a captured CUDA graph redraws each round's bag
from a key the host writes before the replay.  :func:`goss_partition`
keeps the rows of the largest ``|g*h|`` and samples the rest
(``goss.hpp:88-133``), with the JAX package's float32 counts and
threshold.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import random as trandom


def _bag_selection(key, n_pad: int, num_data: int, fraction: float,
                   device=None):
    """(valid, selected) bool ``(n_pad,)`` vectors: row ``i`` is in the
    bag when it is a real row and its uniform is below ``fraction`` (in
    float32, as the JAX package compares); a tensor ``key`` sets the
    device."""
    if isinstance(key, torch.Tensor):
        device = key.device
    valid = torch.arange(n_pad, device=device) < int(num_data)
    u = trandom.uniform(key, (n_pad,), device=device)
    return valid, valid & (u < float(np.float32(fraction)))


def bagging_partition(key, n_pad: int, num_data: int, fraction: float,
                      device=None):
    """(buffer ``(n_pad,)`` int32 with the selected rows first, then the
    other real rows, then the padding, each in row order; selected
    count as a 0-d int tensor)."""
    valid, selected = _bag_selection(key, n_pad, num_data, fraction, device)
    sort_key = torch.where(selected, 0, torch.where(valid, 1, 2))
    order = torch.argsort(sort_key, stable=True)
    return order.to(torch.int32), selected.sum()


def bag_mask(key, n_pad: int, num_data: int, fraction: float,
             device=None) -> torch.Tensor:
    """``(num_data,)`` f32 0/1 in-bag indicator of the draw
    :func:`bagging_partition` makes for ``(key, n_pad)``; ``key`` a host
    pair or a ``(2,)`` int64 tensor."""
    _, sel = _bag_selection(key, n_pad, num_data, fraction, device)
    return sel[:int(num_data)].to(torch.float32)


def bagging_row_mask(seed: int, n_pad: int, num_data: int, fraction: float,
                     device=None) -> torch.Tensor:
    """:func:`bag_mask` under ``PRNGKey(seed)``."""
    return bag_mask(trandom.PRNGKey(seed), n_pad, num_data, fraction, device)


def goss_counts(num_data: int, top_rate: float, other_rate: float):
    """(top_k, other_k): ``max(int(f32(num_data) * f32(rate)), 1)`` in
    float32, as the JAX package computes them (in float64 the two can
    differ: 2M rows x 0.2)."""
    n = np.float32(num_data)
    return (max(int(n * np.float32(top_rate)), 1),
            max(int(n * np.float32(other_rate)), 1))


def goss_partition(key, grad_abs: torch.Tensor, n_pad: int, num_data: int,
                   top_rate: float, other_rate: float):
    """GOSS selection on ``(n_pad,)`` float32 scores (``|g*h|`` summed
    over classes; rows past ``num_data`` are never selected).  Returns
    (buffer ``(n_pad,)`` int32 with the selected rows first, then the
    other real rows, then the padding; selected count as a 0-d int tensor;
    ``(n_pad,)`` float32 multiplier: ``(num_data - top_k) / other_k`` on
    the sampled rows, 1 elsewhere), the JAX package's
    ``goss_partition``.  The rows whose score is at least the ``top_k``-th
    largest are kept (ties at the threshold all kept); each other real
    row is sampled when its uniform under ``key`` is below
    ``other_k / max(rest, 1)``.  Nothing is read back to the host."""
    sel, mult, valid = _goss_selection(key, grad_abs, n_pad, num_data,
                                       top_rate, other_rate)
    sort_key = torch.where(sel, 0, torch.where(valid, 1, 2))
    order = torch.argsort(sort_key, stable=True)
    return order.to(torch.int32), sel.sum(), mult


def goss_row_mask(key, grad_abs: torch.Tensor, n_pad: int, num_data: int,
                  top_rate: float, other_rate: float):
    """The grower's inputs from :func:`goss_partition`'s selection:
    (``(num_data,)`` f32 0/1 in-bag mask, ``(num_data,)`` f32
    multiplier)."""
    sel, mult, _ = _goss_selection(key, grad_abs, n_pad, num_data,
                                   top_rate, other_rate)
    n = int(num_data)
    return sel[:n].to(torch.float32), mult[:n]


def _goss_selection(key, grad_abs, n_pad, num_data, top_rate, other_rate):
    dev = grad_abs.device
    valid = torch.arange(n_pad, device=dev) < int(num_data)
    top_k, other_k = goss_counts(num_data, top_rate, other_rate)
    scores = torch.where(valid, grad_abs, float("-inf"))
    threshold = torch.sort(scores, descending=True).values[
        min(max(top_k - 1, 0), n_pad - 1)]
    is_top = valid & (grad_abs >= threshold)
    rest = valid & ~is_top
    n_rest = rest.sum().clamp(min=1).to(torch.float32)
    # other_k / n_rest as one correctly rounded f32 division (a python
    # numerator would make torch multiply by the reciprocal)
    prob = torch.full_like(n_rest, float(other_k)) / n_rest
    u = trandom.uniform(key, (n_pad,), device=dev)
    sampled = rest & (u < prob)
    ratio = float(np.float32(num_data - top_k) / np.float32(other_k))
    mult = torch.where(sampled, ratio, 1.0).to(torch.float32)
    return is_top | sampled, mult, valid
