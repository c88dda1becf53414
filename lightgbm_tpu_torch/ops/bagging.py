"""Row bagging: a Bernoulli in-bag draw per bagging round.

Counterpart of ``lightgbm_tpu/ops/bagging.py`` (GOSS is not ported yet).
The uniform draw comes from the port's Threefry (``utils/random.py``) with
the JAX package's key and shape, so the bags are its bags bit for bit:
``PRNGKey(seed)`` with ``seed = (bagging_seed + it) & 0x7FFFFFFF`` and
``(n_pad,)`` uniforms, ``n_pad`` being the host learner's bagging-buffer
pad ``bucket_size(num_data)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import random as trandom


def _bag_selection(key, n_pad: int, num_data: int, fraction: float,
                   device=None):
    """(valid, selected) bool ``(n_pad,)`` vectors: row ``i`` is in the
    bag when it is a real row and its uniform is below ``fraction`` (in
    float32, as the JAX package compares)."""
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


def bagging_row_mask(seed: int, n_pad: int, num_data: int, fraction: float,
                     device=None) -> torch.Tensor:
    """``(num_data,)`` f32 0/1 in-bag indicator of the draw
    :func:`bagging_partition` makes for ``(PRNGKey(seed), n_pad)``."""
    _, sel = _bag_selection(trandom.PRNGKey(seed), n_pad, num_data,
                            fraction, device)
    return sel[:int(num_data)].to(torch.float32)
