"""Plain model traversal: trees (numerical splits) given as LightGBM's
arrays, walked over float32 rows in float64 on the rows' device, as LightGBM's ``Tree::NumericalDecision`` decides,
every tree of a block of rows at once, the leaf values summed in tree
order."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

K_ZERO_THRESHOLD = float(np.float32(1e-35))


class Tree:
    """One tree's arrays (LightGBM's names); a child ``c < 0`` is leaf
    ``~c``."""

    FIELDS = {"leaf_value": np.float64, "leaf_count": np.int64,
              "split_feature": np.int64, "threshold": np.float64,
              "decision_type": np.int64, "left_child": np.int64,
              "right_child": np.int64, "internal_count": np.int64}

    def __init__(self, num_leaves: int, **arrays):
        self.num_leaves = int(num_leaves)
        n = self.num_leaves - 1
        for k, dt in self.FIELDS.items():
            a = np.array(arrays[k], dtype=dt)
            setattr(self, k, a[:self.num_leaves] if k.startswith("leaf")
                    else a[:n])
        if (self.decision_type & 1).any():
            raise ValueError("the plain traversal has no categorical splits")


class Forest:
    """Trees stacked into padded tables on ``device``."""

    def __init__(self, trees: List[Tree], device):
        self.t = len(trees)
        self.nodes = max([max(tr.num_leaves - 1, 1) for tr in trees] or [1])
        self.leaves = max([tr.num_leaves for tr in trees] or [1])
        t, n, l_ = self.t, self.nodes, self.leaves
        sf = np.zeros((t, n), np.int64)
        th = np.zeros((t, n), np.float64)
        dt = np.zeros((t, n), np.int64)
        lc = np.full((t, n), -1, np.int64)
        rc = np.full((t, n), -1, np.int64)
        lv = np.zeros((t, l_), np.float64)
        root = np.zeros(t, np.int64)
        for i, tr in enumerate(trees):
            k = tr.num_leaves - 1
            lv[i, :tr.num_leaves] = tr.leaf_value[:tr.num_leaves]
            if k <= 0:
                root[i] = -1
                continue
            sf[i, :k], th[i, :k], dt[i, :k] = (tr.split_feature,
                                               tr.threshold, tr.decision_type)
            lc[i, :k], rc[i, :k] = tr.left_child, tr.right_child
        as_t = lambda a: torch.from_numpy(a).to(device)
        self.sf, self.th, self.dt = as_t(sf).view(-1), as_t(th).view(-1), \
            as_t(dt).view(-1)
        self.lc, self.rc = as_t(lc).view(-1), as_t(rc).view(-1)
        self.lv = as_t(lv)
        self.root = as_t(root)
        self.base = torch.arange(t, device=device) * n

    def leaves_of(self, x: torch.Tensor) -> torch.Tensor:
        """(R, T) leaf of every row of ``x`` (R, F) in every tree."""
        node = self.root[None, :].expand(x.shape[0], -1).clone()
        while True:
            active = node >= 0
            if not bool(active.any()):
                return ~node
            idx = self.base[None, :] + node.clamp(min=0)
            v = torch.gather(x, 1, self.sf[idx]).double()
            dt = self.dt[idx]
            mt = (dt >> 2) & 3
            v = torch.where(torch.isnan(v) & (mt != 2), 0.0, v)
            missing = ((mt == 1) & (v.abs() <= K_ZERO_THRESHOLD)) \
                | ((mt == 2) & torch.isnan(v))
            left = torch.where(missing, (dt & 2) != 0, v <= self.th[idx])
            nxt = torch.where(left, self.lc[idx], self.rc[idx])
            node = torch.where(active, nxt, node)

    def values(self, x: torch.Tensor) -> torch.Tensor:
        """(R, T) float64 leaf value of every row in every tree."""
        leaf = self.leaves_of(x)
        return torch.gather(self.lv[None].expand(x.shape[0], -1, -1), 2,
                            leaf[..., None])[..., 0]

    def output(self, x: torch.Tensor, block: int = 0) -> torch.Tensor:
        """(R,) float64 sum of the trees' values of every row."""
        block = block or max(1, (1 << 24) // max(self.t, 1))
        out = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
        for b in range(0, x.shape[0], block):
            out[b:b + block] = self.values(x[b:b + block]).sum(1)
        return out


def tree_output(tree: Tree, x: torch.Tensor) -> torch.Tensor:
    return Forest([tree], x.device).output(x)


def forest_output(trees: List[Tree], x: torch.Tensor) -> torch.Tensor:
    return Forest(trees, x.device).output(x)
