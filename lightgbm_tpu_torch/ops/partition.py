"""A leaf's stable partition and the score update through the partition
(counterpart of ``lightgbm_tpu/ops/partition.py``).

The host learner keeps a buffer of row indices in which each leaf owns a
contiguous window.  A split reorders the leaf's window stably: the rows
going left first, then the rows going right, each in their old order
(the reference's ``DataPartition::Split``, ``data_partition.hpp:109-200``).
The JAX package sorts a padded window by a 0/1/2/3 key; here the two
sides are compacted by boolean selection, which keeps order and yields
the exact left count.

Row routing is ``DenseBin::Split`` (``src/io/dense_bin.hpp:190-250``), as
the device grower routes:

* a row whose group slot lies outside the split feature's slot range, or
  at the feature's default bin, goes to the default side: ``default_left``
  for MissingType::Zero, else ``default_bin <= threshold``;
* the NaN bin (MissingType::NaN) follows ``default_left``;
* otherwise ``bin <= threshold``;
* a categorical row goes left iff its bin is in the chosen set.
"""

from __future__ import annotations

import torch


def goes_left(slot: torch.Tensor, *, offset: int, width: int,
              default_bin: int, num_bin: int, missing: int, threshold: int,
              default_left: bool, is_cat: bool,
              cat_member: torch.Tensor = None) -> torch.Tensor:
    """(m,) bool: whether each row with group slot ``slot`` (uint8 codes
    of the split feature's group) goes left."""
    slot = slot.long()
    shift = 1 if default_bin == 0 else 0
    in_range = (slot >= offset) & (slot < offset + width)
    bin_ = torch.where(in_range, slot - offset + shift,
                       torch.full_like(slot, default_bin))
    if is_cat:
        return cat_member[bin_.clamp(0, 255)]
    default_goes_left = default_left if missing == 1 \
        else default_bin <= threshold
    is_default = bin_ == default_bin
    is_na = (bin_ == num_bin - 1) if missing == 2 \
        else torch.zeros_like(is_default)
    left = torch.where(is_na, torch.full_like(is_default, default_left),
                       bin_ <= threshold)
    return torch.where(is_default,
                       torch.full_like(is_default, default_goes_left), left)


def partition_leaf(binned_t: torch.Tensor, rows: torch.Tensor, *, group: int,
                   **split) -> tuple:
    """Stable partition of one leaf's rows (``rows``, 1-D int32 indices
    into the ``(G, N)`` codes ``binned_t``): returns (the reordered rows,
    the left count as a host int; one host read)."""
    left = goes_left(binned_t[group, rows.long()], **split)
    out = torch.cat([rows[left], rows[~left]])
    return out, int(left.sum())


def apply_leaf_outputs(score: torch.Tensor, indices: torch.Tensor,
                       counts, values) -> torch.Tensor:
    """``score[indices[p]] += values[leaf of position p]`` in place, the
    leaves' windows ``counts`` long and consecutive from position 0; later
    positions (out-of-bag rows) get nothing (``ScoreUpdater::AddScore``
    through the partition).  Each row is added once, so the result does
    not depend on the order of the adds."""
    dev = score.device
    c = torch.as_tensor(counts, dtype=torch.int64)
    v = torch.as_tensor(values, dtype=torch.float32)
    per_pos = torch.repeat_interleave(v, c).to(dev)
    m = int(c.sum())
    return score.index_add_(0, indices[:m].long(), per_pos)
