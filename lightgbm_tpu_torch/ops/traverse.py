"""Tree traversal over a binned matrix, with torch ops on its device.

Counterpart of ``lightgbm_tpu/ops/traverse.py``: every row carries a node
pointer, and one step advances all rows a level (gather the node's fields,
decode the feature's bin from its group slot, branch), as the reference's
``Tree::GetLeaf`` decides (``include/LightGBM/tree.h:487-508``).  The JAX
package loops until a device-side ``any`` says every row reached a leaf;
here the loop runs exactly the tree's depth, known on the host, so scoring
a tree reads nothing back from the device.

This is the training side's traversal, one tree over the binned rows of a
dataset that shares the training set's mappers (validation sets).  Batch
prediction from raw values goes through ``serve/packed.py`` instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..tree.tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree

#: columns of ``DeviceTree.nodes``
(N_GROUP, N_OFFSET, N_WIDTH, N_DEFAULT_BIN, N_NUM_BIN, N_MISSING,
 N_THRESHOLD, N_DEFAULT_LEFT, N_IS_CAT, N_LEFT, N_RIGHT) = range(11)
#: 32-bit words of a categorical node's bitset over inner bins
CAT_WORDS = 8


class DeviceTree(NamedTuple):
    """One tree's fields on the device: ``nodes`` (max_nodes, 11) int32 (the
    ``N_*`` columns), ``cat_bitset`` (max_nodes * 8,) int64 words over
    inner bins, ``leaf_value`` (max_leaves,) float32; and two host-known
    values: ``depth``, the steps that bring every row to a leaf, and
    ``has_cat``, whether any node splits on a category (a tree without
    one skips the bitset decision)."""
    nodes: torch.Tensor
    cat_bitset: torch.Tensor
    leaf_value: torch.Tensor
    depth: int
    has_cat: bool


def tree_depth(tree: Tree) -> int:
    """Internal nodes on the longest root-to-leaf path; a stump takes one
    step (its root's children are both leaf 0)."""
    if tree.num_leaves <= 1:
        return 1
    depth, stack = 0, [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        for child in (tree.left_child[node], tree.right_child[node]):
            if child >= 0:
                stack.append((int(child), d + 1))
    return depth


def device_tree(tree: Tree, dataset, max_leaves: int,
                device) -> DeviceTree:
    """The device fields of a host tree, with the dataset's per-feature
    lookups (group, offset, bins, default bin)."""
    mn = max(max_leaves - 1, 1)
    nodes = np.zeros((mn, 11), np.int32)
    nodes[:, N_WIDTH] = 1
    nodes[:, N_NUM_BIN] = 1
    nodes[:, N_LEFT] = -1
    nodes[:, N_RIGHT] = -1
    cb = np.zeros((mn, CAT_WORDS), np.int64)
    for node in range(tree.num_leaves - 1):
        f = int(tree.split_feature_inner[node])
        nbin = int(dataset.f_num_bin[f])
        dbin = int(dataset.f_default_bin[f])
        dt = int(tree.decision_type[node])
        row = nodes[node]
        row[N_GROUP] = dataset.f_group[f]
        row[N_OFFSET] = dataset.f_offset[f]
        row[N_WIDTH] = nbin - (1 if dbin == 0 else 0)
        row[N_DEFAULT_BIN] = dbin
        row[N_NUM_BIN] = nbin
        row[N_MISSING] = (dt >> 2) & 3
        row[N_DEFAULT_LEFT] = bool(dt & K_DEFAULT_LEFT_MASK)
        row[N_IS_CAT] = bool(dt & K_CATEGORICAL_MASK)
        if row[N_IS_CAT]:
            cat_idx = int(tree.threshold_in_bin[node])
            lo = tree.cat_boundaries_inner[cat_idx]
            hi = tree.cat_boundaries_inner[cat_idx + 1]
            words = tree.cat_threshold_inner[lo:hi][:CAT_WORDS]
            cb[node, :len(words)] = words
        else:
            row[N_THRESHOLD] = int(tree.threshold_in_bin[node])
        row[N_LEFT] = tree.left_child[node]
        row[N_RIGHT] = tree.right_child[node]
    lv = np.zeros(max_leaves, np.float32)
    lv[:tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
    return DeviceTree(torch.from_numpy(nodes).to(device),
                      torch.from_numpy(cb.reshape(-1)).to(device),
                      torch.from_numpy(lv).to(device), tree_depth(tree),
                      bool(nodes[:, N_IS_CAT].any()))


def _goes_left(binned: torch.Tensor, t: DeviceTree, cur: torch.Tensor,
               f: torch.Tensor) -> torch.Tensor:
    """Each row's decision at its node ``cur``, whose fields ``f`` (N, 11)
    were gathered per row."""
    slot = torch.gather(binned, 1, f[:, N_GROUP:N_GROUP + 1].long()) \
        .view(-1).to(torch.int32)
    off, db, thr = f[:, N_OFFSET], f[:, N_DEFAULT_BIN], f[:, N_THRESHOLD]
    miss, dl = f[:, N_MISSING], f[:, N_DEFAULT_LEFT] != 0
    in_range = (slot >= off) & (slot < off + f[:, N_WIDTH])
    bin_ = torch.where(in_range, slot - off + (db == 0).to(torch.int32), db)
    is_na = (miss == 2) & (bin_ == f[:, N_NUM_BIN] - 1)
    default_goes_left = torch.where(miss == 1, dl, db <= thr)
    left_num = torch.where(bin_ == db, default_goes_left,
                           torch.where(is_na, dl, bin_ <= thr))
    if not t.has_cat:
        return left_num
    word = t.cat_bitset[cur * CAT_WORDS
                        + (bin_ >> 5).clamp(0, CAT_WORDS - 1).long()]
    left_cat = ((word >> (bin_ & 31).long()) & 1) == 1
    return torch.where(f[:, N_IS_CAT] != 0, left_cat, left_num)


def traverse(binned: torch.Tensor, t: DeviceTree) -> torch.Tensor:
    """(N,) int64 leaf index of every row of an (N, G) uint8 binned matrix,
    after ``t.depth`` steps."""
    node = torch.zeros(binned.shape[0], dtype=torch.int64,
                       device=binned.device)
    for _ in range(t.depth):
        active = node >= 0
        cur = node.clamp(min=0)
        f = t.nodes[cur]
        left = _goes_left(binned, t, cur, f)
        nxt = torch.where(left, f[:, N_LEFT], f[:, N_RIGHT]).long()
        node = torch.where(active, nxt, node)
    return ~node


def add_tree_score(score: torch.Tensor, binned: torch.Tensor,
                   t: DeviceTree, multiplier: float) -> torch.Tensor:
    """``score + multiplier * leaf_value[traverse(binned)]``."""
    return score + multiplier * t.leaf_value[traverse(binned, t)]


def add_constant_score(score: torch.Tensor, value: float) -> torch.Tensor:
    return score + value
