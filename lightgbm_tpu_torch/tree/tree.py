"""Decision-tree model: flat arrays, host prediction, text serialization.

Counterpart of ``lightgbm_tpu/tree/tree.py`` (the reference ``Tree``,
``include/LightGBM/tree.h``, on numpy arrays).  Node wiring, decision-type
bit encoding (bit0 categorical, bit1 default_left, bits>=2 missing type)
and the text fields are the "v2" model format, so model texts move between
this package, the JAX package and the reference; ``to_json`` is the JSON
dump; ``tree_shap_batch`` is TreeSHAP over a batch of rows (host float64,
as in the JAX package) and ``to_if_else`` the C++ code generation of the
CLI's ``convert_model`` task.
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


def construct_bitset(values) -> List[int]:
    """Common::ConstructBitset: ints -> uint32 bitset words."""
    if len(values) == 0:
        return []
    words = [0] * (int(max(values)) // 32 + 1)
    for v in values:
        v = int(v)
        words[v // 32] |= 1 << (v % 32)
    return words


def categorical_bitsets(mapper, member_bins):
    """(inner-bin bitset, raw-category bitset) of a categorical split whose
    LEFT side is the bin set ``member_bins``
    (``lightgbm_tpu/tree/tree.py::categorical_bitsets``): bins past 255
    and the bins with no category (``bin_2_categorical[b] < 0``) stay out
    of the raw one.  The binned validation traversal reads the first, the
    host walk and the packed forest the second."""
    member_bins = [int(b) for b in member_bins if int(b) < 256]
    cats = [int(mapper.bin_2_categorical[b]) for b in member_bins
            if b < len(mapper.bin_2_categorical)
            and mapper.bin_2_categorical[b] >= 0]
    return construct_bitset(member_bins), construct_bitset(cats)


class Tree:
    """One decision tree.  Leaves are referenced as ``~leaf`` in child arrays
    (matching the reference encoding: child >= 0 internal node, < 0 leaf)."""

    #: the device grower's stamps of this tree (``ops/clock.py``
    #: ``DeviceClock``); None for a tree grown elsewhere or loaded.  Not
    #: part of the model: no text, comparison or prediction reads it
    device_clock = None

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

    def split_categorical(self, leaf, feature, real_feature, bitset_inner,
                          bitset, left_value, right_value, left_cnt,
                          right_cnt, gain, missing_type: int) -> int:
        """Categorical split: ``bitset_inner`` over bins, ``bitset`` over
        raw category values; returns the new (right) leaf index."""
        node = self._split_common(leaf, feature, real_feature, left_value,
                                  right_value, left_cnt, right_cnt, gain)
        self.decision_type[node] = (K_CATEGORICAL_MASK
                                    | ((int(missing_type) & 3) << 2))
        self.threshold_in_bin[node] = self.num_cat
        self.threshold[node] = self.num_cat
        self.num_cat += 1
        self.cat_threshold_inner.extend(int(w) for w in bitset_inner)
        self.cat_boundaries_inner.append(len(self.cat_threshold_inner))
        self.cat_threshold.extend(int(w) for w in bitset)
        self.cat_boundaries.append(len(self.cat_threshold))
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
            # CategoricalDecision: the value truncated toward zero (NaN is
            # category 0 unless the missing type is NaN, then it goes
            # right), left iff its bit is set in the node's raw bitset
            ci = np.nonzero(is_cat)[0]
            fv = fval[ci]
            nan = np.isnan(fv)
            iv = np.trunc(np.clip(np.where(nan, 0.0, fv), -1.0, 2.0 ** 31))
            iv = np.where(nan & (missing[ci] == 2), -1, iv).astype(np.int64)
            cat_idx = self.threshold[node[ci]].astype(np.int64)
            bounds = np.asarray(self.cat_boundaries, np.int64)
            lo, n_words = bounds[cat_idx], np.diff(bounds)[cat_idx]
            widx = iv >> 5
            inside = (iv >= 0) & (widx < n_words)
            words = np.asarray(self.cat_threshold + [0], np.int64)
            word = words[np.where(inside, lo + widx, -1)]
            left[ci] = inside & (((word >> (iv & 31)) & 1) == 1)
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

    def expected_value(self) -> float:
        if self.num_leaves == 1:
            return float(self.leaf_value[0])
        return float(self.internal_value[0])

    def predict_contrib_row(self, row: np.ndarray, contribs: np.ndarray):
        """TreeSHAP of one row (the per-row recursion of tree.h:466-485,
        the oracle of :func:`tree_shap_batch`); adds into ``contribs``
        (num_features + 1,)."""
        contribs[-1] += self.expected_value()
        if self.num_leaves > 1:
            _tree_shap(self, np.asarray(row, np.float64), contribs)

    def to_if_else(self, index: int, is_predict_leaf: bool) -> str:
        """C++ if-else code of the tree (reference SaveModelToIfElse,
        gbdt_model_text.cpp:150-240)."""
        name = "PredictTree" + str(index) + ("Leaf" if is_predict_leaf
                                             else "")
        body = self._node_if_else(0 if self.num_leaves > 1 else -1,
                                  is_predict_leaf, 1)
        return f"double {name}(const double* arr) {{\n{body}}}\n"

    def _node_if_else(self, idx: int, leaf_mode: bool, indent: int) -> str:
        pad = "  " * indent
        if idx < 0:
            val = (~idx) if leaf_mode else self.leaf_value[~idx]
            return f"{pad}return {val};\n"
        dt = int(self.decision_type[idx])
        f = int(self.split_feature[idx])
        missing = (dt >> 2) & 3
        default_left = bool(dt & K_DEFAULT_LEFT_MASK)
        if dt & K_CATEGORICAL_MASK:
            cat_idx = int(self.threshold[idx])
            lo = self.cat_boundaries[cat_idx]
            hi = self.cat_boundaries[cat_idx + 1]
            words = ",".join(str(w) for w in self.cat_threshold[lo:hi])
            cond = (f"CategoricalDecision(arr[{f}], (const uint32_t[])"
                    f"{{{words}}}, {hi - lo})")
        else:
            thr = repr(float(self.threshold[idx]))
            miss = {1: f"IsZero(arr[{f}])",
                    2: f"std::isnan(arr[{f}])"}.get(missing, "false")
            cond = (f"(({miss}) ? {str(default_left).lower()} : "
                    f"(arr[{f}] <= {thr}))")
        left = self._node_if_else(int(self.left_child[idx]), leaf_mode,
                                  indent + 1)
        right = self._node_if_else(int(self.right_child[idx]), leaf_mode,
                                   indent + 1)
        return f"{pad}if ({cond}) {{\n{left}{pad}}} else {{\n{right}{pad}}}\n"

    # -- serialization -----------------------------------------------------
    def to_json(self) -> dict:
        """The tree as ``dump_model`` writes it: nested split and leaf
        records (``lightgbm_tpu/tree/tree.py::Tree.to_json``)."""
        def node_json(idx):
            if idx < 0:
                leaf = ~idx
                return {
                    "leaf_index": int(leaf),
                    "leaf_value": float(self.leaf_value[leaf]),
                    "leaf_count": int(self.leaf_count[leaf]),
                }
            dt = int(self.decision_type[idx])
            return {
                "split_index": int(idx),
                "split_feature": int(self.split_feature[idx]),
                "split_gain": float(self.split_gain[idx]),
                "threshold": float(self.threshold[idx]),
                "decision_type": "==" if dt & K_CATEGORICAL_MASK else "<=",
                "default_left": bool(dt & K_DEFAULT_LEFT_MASK),
                "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
                "internal_value": float(self.internal_value[idx]),
                "internal_count": int(self.internal_count[idx]),
                "left_child": node_json(int(self.left_child[idx])),
                "right_child": node_json(int(self.right_child[idx])),
            }

        return {
            "num_leaves": int(self.num_leaves),
            "num_cat": int(self.num_cat),
            "shrinkage": float(self.shrinkage),
            "tree_structure": node_json(0 if self.num_leaves > 1 else -1),
        }

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


# ---------------------------------------------------------------------------
# TreeSHAP (reference src/io/tree.cpp TreeSHAP; lightgbm_tpu/tree/tree.py)
# ---------------------------------------------------------------------------

def _decide_left(tree: Tree, rows: np.ndarray, node: int) -> np.ndarray:
    """(rows,) bool: whether each row takes the left child at ``node``,
    by :meth:`Tree._decision_matrix` (one decision rule for prediction
    and SHAP)."""
    nodes = np.full(rows.shape[0], node, np.int32)
    return tree._decision_matrix(nodes, rows[:, tree.split_feature[node]])


def _structural_depth(tree: Tree) -> int:
    """Max depth from the children arrays (a loaded tree has no depths)."""
    depth = {0: 0}
    max_d = 0
    for node in range(tree.num_leaves - 1):
        d = depth[node] + 1
        for c in (int(tree.left_child[node]), int(tree.right_child[node])):
            if c >= 0:
                depth[c] = d
        max_d = max(max_d, d)
    return max_d


def _child_count(tree: Tree, c: int) -> float:
    return float(tree.leaf_count[~c] if c < 0 else tree.internal_count[c])


class _Path:
    """TreeSHAP path state over a batch of rows: the feature of each path
    position is a scalar (the recursion's control flow depends on the tree
    only), its zero/one fractions and weight are (rows,) arrays.  A scalar
    row is a batch of one."""

    __slots__ = ("feature", "zero", "one", "pweight")

    def __init__(self, depth_cap, rows):
        self.feature = np.full(depth_cap, -1, np.int64)
        self.zero = np.zeros((depth_cap, rows))
        self.one = np.zeros((depth_cap, rows))
        self.pweight = np.zeros((depth_cap, rows))

    def fork(self, k):
        """A copy of the first ``k`` positions (later ones are written
        before they are read)."""
        out = _Path.__new__(_Path)
        out.feature = self.feature.copy()
        out.zero = np.empty_like(self.zero)
        out.one = np.empty_like(self.one)
        out.pweight = np.empty_like(self.pweight)
        out.zero[:k] = self.zero[:k]
        out.one[:k] = self.one[:k]
        out.pweight[:k] = self.pweight[:k]
        return out

    def extend(self, ud, zero_fraction, one_fraction, feature):
        self.feature[ud] = feature
        self.zero[ud] = zero_fraction
        self.one[ud] = one_fraction
        self.pweight[ud] = 1.0 if ud == 0 else 0.0
        pw = self.pweight
        for i in range(ud - 1, -1, -1):
            pw[i + 1] += one_fraction * pw[i] * (i + 1) / (ud + 1)
            pw[i] = zero_fraction * pw[i] * (ud - i) / (ud + 1)

    def _fractions(self, path_index):
        one = self.one[path_index]
        zero = self.zero[path_index]
        nonzero = one != 0
        return (one, zero, nonzero, np.where(nonzero, one, 1.0),
                np.where(zero != 0, zero, 1.0))

    def unwind(self, ud, path_index):
        one, zero, nonzero, safe_one, safe_zero = self._fractions(path_index)
        next_one = self.pweight[ud].copy()
        for i in range(ud - 1, -1, -1):
            tmp = self.pweight[i].copy()
            pw_nz = next_one * (ud + 1) / ((i + 1) * safe_one)
            pw_z = tmp * (ud + 1) / (safe_zero * (ud - i))
            self.pweight[i] = np.where(nonzero, pw_nz, pw_z)
            next_one = np.where(nonzero,
                                tmp - pw_nz * zero * (ud - i) / (ud + 1),
                                next_one)
        for i in range(path_index, ud):
            self.feature[i] = self.feature[i + 1]
            self.zero[i] = self.zero[i + 1]
            self.one[i] = self.one[i + 1]

    def unwound_sum(self, ud, path_index):
        one, zero, nonzero, safe_one, safe_zero = self._fractions(path_index)
        next_one = self.pweight[ud].copy()
        total = np.zeros_like(next_one)
        for i in range(ud - 1, -1, -1):
            tmp = next_one * (ud + 1) / ((i + 1) * safe_one)
            total += np.where(nonzero, tmp, self.pweight[i] * (ud + 1)
                              / (safe_zero * (ud - i)))
            next_one = np.where(nonzero, self.pweight[i] - tmp * zero
                                * (ud - i) / (ud + 1), next_one)
        return total


def tree_shap_batch(tree: Tree, rows: np.ndarray, contribs: np.ndarray):
    """TreeSHAP for a batch (``lightgbm_tpu/tree/tree.py::tree_shap_batch``):
    ``rows`` (B, F) float64, ``contribs`` (B, F + 1) accumulated in place,
    the last column taking the tree's expected value."""
    contribs[:, -1] += tree.expected_value()
    if tree.num_leaves <= 1:
        return
    _shap_recurse(tree, rows, contribs)


def _tree_shap(tree: Tree, row: np.ndarray, contribs: np.ndarray):
    """TreeSHAP of one row into ``contribs`` (F + 1,), without the
    expected value (the per-row reference recursion)."""
    out = np.zeros((1, contribs.shape[0]))
    _shap_recurse(tree, row[None, :], out)
    contribs += out[0]


def _shap_recurse(tree: Tree, rows: np.ndarray, contribs: np.ndarray):
    depth_cap = _structural_depth(tree) + 2
    nrows = rows.shape[0]

    def recurse(node, ud, parent, parent_zero, parent_one, parent_feature):
        path = parent.fork(ud + 1)
        path.extend(ud, parent_zero, parent_one, parent_feature)
        if node < 0:
            leaf_v = float(tree.leaf_value[~node])
            for i in range(1, ud + 1):
                w = path.unwound_sum(ud, i)
                contribs[:, path.feature[i]] += (
                    w * (path.one[i] - path.zero[i]) * leaf_v)
            return
        left_mask = _decide_left(tree, rows, node)
        node_count = max(float(tree.internal_count[node]), 1.0)
        lc = int(tree.left_child[node])
        rc = int(tree.right_child[node])
        inc_zero = np.ones(nrows)
        inc_one = np.ones(nrows)
        feature = int(tree.split_feature[node])
        path_index = 0
        while path_index <= ud and path.feature[path_index] != feature:
            path_index += 1
        if path_index != ud + 1:
            inc_zero = path.zero[path_index].copy()
            inc_one = path.one[path_index].copy()
            path.unwind(ud, path_index)
            ud -= 1
        recurse(lc, ud + 1, path, _child_count(tree, lc) / node_count
                * inc_zero, inc_one * left_mask, feature)
        recurse(rc, ud + 1, path, _child_count(tree, rc) / node_count
                * inc_zero, inc_one * ~left_mask, feature)

    recurse(0, 0, _Path(depth_cap, nrows), 1.0, np.ones(nrows), -1)
