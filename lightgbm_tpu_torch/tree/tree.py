"""Decision-tree model: flat arrays, host prediction, text serialization.

Counterpart of ``lightgbm_tpu/tree/tree.py`` (the reference ``Tree``,
``include/LightGBM/tree.h``, on numpy arrays).  Node wiring, decision-type
bit encoding (bit0 categorical, bit1 default_left, bits>=2 missing type)
and the text fields are the "v2" model format, so model texts move between
this package, the JAX package and the reference.  TreeSHAP, JSON dumps and
if-else code generation are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..data.binning import K_ZERO_THRESHOLD

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2

def _avoid_inf(x: float) -> float:
    """Common::AvoidInf — clamp +-inf to +-1e300 for serialization."""
    if x >= 1e300:
        return 1e300
    if x <= -1e300:
        return -1e300
    return float(x)


def find_in_bitset(words, val: int) -> bool:
    i1 = val // 32
    if val < 0 or i1 >= len(words):
        return False
    return bool((words[i1] >> (val % 32)) & 1)


class Tree:
    """One decision tree.  Leaves are referenced as ``~leaf`` in child arrays
    (matching the reference encoding: child >= 0 internal node, < 0 leaf)."""

    def __init__(self, max_leaves: int):
        self.max_leaves = max_leaves
        n = max_leaves
        self.num_leaves = 1
        self.left_child = np.zeros(n - 1, np.int32)
        self.right_child = np.zeros(n - 1, np.int32)
        self.split_feature_inner = np.zeros(n - 1, np.int32)
        self.split_feature = np.zeros(n - 1, np.int32)
        self.threshold_in_bin = np.zeros(n - 1, np.int32)
        self.threshold = np.zeros(n - 1, np.float64)
        self.decision_type = np.zeros(n - 1, np.int8)
        self.split_gain = np.zeros(n - 1, np.float64)
        self.leaf_parent = np.full(n, -1, np.int32)
        self.leaf_value = np.zeros(n, np.float64)
        self.leaf_count = np.zeros(n, np.int64)
        self.internal_value = np.zeros(n - 1, np.float64)
        self.internal_count = np.zeros(n - 1, np.int64)
        self.leaf_depth = np.zeros(n, np.int32)
        self.shrinkage = 1.0
        # categorical split storage: threshold_in_bin/threshold hold an index
        # into cat_boundaries; bitsets are over inner bins / raw categories
        self.num_cat = 0
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        self.cat_boundaries_inner: List[int] = [0]
        self.cat_threshold_inner: List[int] = []

    # ------------------------------------------------------------------
    def _split_common(self, leaf, feature, real_feature, left_value,
                     right_value, left_cnt, right_cnt, gain):
        new_node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = feature
        self.split_feature[new_node] = real_feature
        self.split_gain[new_node] = _avoid_inf(gain)
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~self.num_leaves
        self.leaf_parent[leaf] = new_node
        self.leaf_parent[self.num_leaves] = new_node
        # parent's output becomes the internal (expected) value
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_count[new_node] = left_cnt + right_cnt
        self.leaf_value[leaf] = 0.0 if math.isnan(left_value) else left_value
        self.leaf_count[leaf] = left_cnt
        self.leaf_value[self.num_leaves] = (0.0 if math.isnan(right_value)
                                            else right_value)
        self.leaf_count[self.num_leaves] = right_cnt
        self.leaf_depth[self.num_leaves] = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] += 1
        return new_node

    def split(self, leaf, feature, real_feature, threshold_bin,
              threshold_double, left_value, right_value, left_cnt, right_cnt,
              gain, missing_type: int, default_left: bool) -> int:
        """Numerical split; returns the new (right) leaf index."""
        node = self._split_common(leaf, feature, real_feature, left_value,
                                  right_value, left_cnt, right_cnt, gain)
        dt = 0
        if default_left:
            dt |= K_DEFAULT_LEFT_MASK
        dt |= (int(missing_type) & 3) << 2
        self.decision_type[node] = dt
        self.threshold_in_bin[node] = threshold_bin
        self.threshold[node] = _avoid_inf(threshold_double)
        self.num_leaves += 1
        return self.num_leaves - 1

    # ------------------------------------------------------------------
    def apply_shrinkage(self, rate: float):
        self.leaf_value[:self.num_leaves] *= rate
        self.internal_value[:max(self.num_leaves - 1, 0)] *= rate
        self.shrinkage *= rate

    def add_bias(self, val: float):
        self.leaf_value[:self.num_leaves] += val
        self.internal_value[:max(self.num_leaves - 1, 0)] += val
        self.shrinkage = 1.0

    # -- prediction (vectorized numpy over raw feature values) ----------
    def _decision_matrix(self, node: np.ndarray, fval: np.ndarray) -> np.ndarray:
        """goes-left per row given current node vector (raw values).
        Mirrors NumericalDecision / CategoricalDecision (tree.h:212-278)."""
        dt = self.decision_type[node]
        is_cat = (dt & K_CATEGORICAL_MASK) != 0
        default_left = (dt & K_DEFAULT_LEFT_MASK) != 0
        missing = (dt.astype(np.int32) >> 2) & 3
        nan_mask = np.isnan(fval)
        v = np.where(nan_mask & (missing != 2), 0.0, fval)
        is_miss = ((missing == 1) & (np.abs(v) <= K_ZERO_THRESHOLD)) | \
                  ((missing == 2) & nan_mask)
        left = np.where(is_miss, default_left, v <= self.threshold[node])
        if self.num_cat > 0 and is_cat.any():
            ci = np.nonzero(is_cat)[0]
            for i in ci:
                fv = fval[i]
                iv = -1 if np.isnan(fv) else int(fv)
                if np.isnan(fv) and missing[i] != 2:
                    iv = 0
                cat_idx = int(self.threshold[node[i]])
                lo, hi = self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1]
                left[i] = (iv >= 0 and
                           find_in_bitset(self.cat_threshold[lo:hi], iv))
        return left

    def predict_leaf(self, data: np.ndarray) -> np.ndarray:
        """Leaf index per row for a dense (rows, features) raw matrix."""
        n = data.shape[0]
        if self.num_leaves == 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int32)
        active = np.ones(n, bool)
        out = np.zeros(n, np.int32)
        while active.any():
            idx = np.nonzero(active)[0]
            cur = node[idx]
            fval = data[idx, self.split_feature[cur]]
            left = self._decision_matrix(cur, fval)
            nxt = np.where(left, self.left_child[cur], self.right_child[cur])
            leaf_mask = nxt < 0
            out[idx[leaf_mask]] = ~nxt[leaf_mask]
            node[idx] = np.where(leaf_mask, 0, nxt)
            active[idx] = ~leaf_mask
        return out

    def predict(self, data: np.ndarray) -> np.ndarray:
        return self.leaf_value[self.predict_leaf(data)]

    # -- serialization -----------------------------------------------------
    def to_string(self) -> str:
        n = self.num_leaves

        def arr(a, k):
            return " ".join(_fmt(v) for v in a[:k])

        lines = [f"num_leaves={n}", f"num_cat={self.num_cat}"]
        lines.append("split_feature=" + arr(self.split_feature, n - 1))
        lines.append("split_gain=" + arr(self.split_gain, n - 1))
        lines.append("threshold=" + " ".join(
            _fmt_double(v) for v in self.threshold[:n - 1]))
        lines.append("decision_type=" + arr(self.decision_type, n - 1))
        lines.append("left_child=" + arr(self.left_child, n - 1))
        lines.append("right_child=" + arr(self.right_child, n - 1))
        lines.append("leaf_value=" + " ".join(
            _fmt_double(v) for v in self.leaf_value[:n]))
        lines.append("leaf_count=" + arr(self.leaf_count, n))
        lines.append("internal_value=" + arr(self.internal_value, n - 1))
        lines.append("internal_count=" + arr(self.internal_count, n - 1))
        if self.num_cat > 0:
            lines.append("cat_boundaries=" + " ".join(
                str(v) for v in self.cat_boundaries))
            lines.append("cat_threshold=" + " ".join(
                str(v) for v in self.cat_threshold))
        lines.append(f"shrinkage={_fmt(self.shrinkage)}")
        return "\n".join(lines) + "\n\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        n = int(kv["num_leaves"])
        t = cls(max(n, 2))
        t.num_leaves = n
        t.num_cat = int(kv.get("num_cat", 0))

        def ints(key, count, dtype=np.int64):
            if count <= 0 or key not in kv or not kv[key].strip():
                return np.zeros(max(count, 0), dtype)
            return np.asarray([int(float(x)) for x in kv[key].split()], dtype)

        def floats(key, count):
            if count <= 0 or key not in kv or not kv[key].strip():
                return np.zeros(max(count, 0), np.float64)
            return np.asarray([float(x) for x in kv[key].split()], np.float64)

        if n > 1:
            t.split_feature = ints("split_feature", n - 1, np.int32)
            t.split_feature_inner = t.split_feature.copy()
            t.split_gain = floats("split_gain", n - 1)
            t.threshold = floats("threshold", n - 1)
            t.threshold_in_bin = np.zeros(n - 1, np.int32)
            t.decision_type = ints("decision_type", n - 1, np.int8)
            t.left_child = ints("left_child", n - 1, np.int32)
            t.right_child = ints("right_child", n - 1, np.int32)
            t.internal_value = floats("internal_value", n - 1)
            t.internal_count = ints("internal_count", n - 1)
        t.leaf_value = np.resize(floats("leaf_value", n), max(n, 2))
        t.leaf_count = np.resize(ints("leaf_count", n)
                                 if "leaf_count" in kv else np.zeros(n, np.int64),
                                 max(n, 2))
        if t.num_cat > 0:
            t.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
            # inner bitsets unavailable from file; raw-value prediction only
            t.cat_boundaries_inner = list(t.cat_boundaries)
            t.cat_threshold_inner = list(t.cat_threshold)
        t.shrinkage = float(kv.get("shrinkage", 1))
        # rebuild leaf parents/depths
        t.leaf_parent = np.full(max(n, 2), -1, np.int32)
        for node in range(n - 1):
            for child in (t.left_child[node], t.right_child[node]):
                if child < 0:
                    t.leaf_parent[~child] = node
        return t

def _fmt(v) -> str:
    if isinstance(v, (np.floating, float)):
        return repr(float(v)) if v != int(v) else str(int(v))
    return str(int(v))


def _fmt_double(v) -> str:
    return np.format_float_positional(
        float(v), precision=17, unique=True, trim="0")
