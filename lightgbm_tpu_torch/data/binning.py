"""BinMapper: per-feature value -> bin mapping.

Re-implements the behaviour of the reference ``BinMapper``
(``src/io/bin.cpp:74-402``, ``include/LightGBM/bin.h:452-488``) in
numpy/python: greedy equal-count binning over sampled distinct values with the
zero bin treated specially, count-sorted categorical bins, and the three
missing-value modes (None / Zero / NaN — NaN always maps to the last bin).
The algorithm and edge-case semantics match the reference so that bin
boundaries — and therefore trees and metrics — are comparable; the code is
written fresh for a dense device-resident representation.

A copy of ``lightgbm_tpu/data/binning.py``: bin boundaries must match the
JAX package bit for bit, so the algorithm is kept line for line.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

# values with |v| <= kZeroThreshold are "zero".  The reference writes the
# literal as 1e-35f (meta.h:40) — a float32 constant promoted to double —
# so the working threshold is float32(1e-35), not double 1e-35; matching
# it exactly keeps the -kZeroThreshold/+kZeroThreshold bin bounds
# bit-identical (tests/test_parity.py)
K_ZERO_THRESHOLD = float(np.float32(1e-35))

MISSING_NONE = "none"
MISSING_ZERO = "zero"
MISSING_NAN = "nan"

BIN_NUMERICAL = "numerical"
BIN_CATEGORICAL = "categorical"


def _double_upper_bound(v: float) -> float:
    """Next representable double above v (reference Common::GetDoubleUpperBound)."""
    return float(np.nextafter(np.float64(v), np.float64(np.inf)))


def _feq(a: float, b: float) -> bool:
    """Ordered approximate-equality used when merging near-identical doubles
    (reference Common::CheckDoubleEqualOrdered)."""
    upper = float(np.nextafter(np.float64(a), np.float64(np.inf)))
    return a <= b <= upper


def _greedy_find_bin_scalar(distinct_values: np.ndarray, counts: np.ndarray,
                            max_bin: int, total_cnt: int,
                            min_data_in_bin: int) -> List[float]:
    """Reference-shaped scalar implementation of GreedyFindBin
    (bin.cpp:74-150); kept as the semantics oracle for the vectorized
    version below (tests fuzz one against the other)."""
    num_distinct = len(distinct_values)
    bounds: List[float] = []
    if max_bin <= 0:
        raise ValueError("max_bin must be positive")
    if num_distinct == 0:
        return [math.inf]
    if num_distinct <= max_bin:
        cur = 0
        for i in range(num_distinct - 1):
            cur += int(counts[i])
            if cur >= min_data_in_bin:
                val = _double_upper_bound((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bounds or not _feq(bounds[-1], val):
                    bounds.append(val)
                    cur = 0
        bounds.append(math.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = total_cnt - int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    upper = []
    lower = [float(distinct_values[0])]
    cur = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur += int(counts[i])
        if (is_big[i] or cur >= mean_bin_size
                or (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            upper.append(float(distinct_values[i]))
            lower.append(float(distinct_values[i + 1]))
            if len(upper) >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    for i in range(len(upper)):
        val = _double_upper_bound((upper[i] + lower[i + 1]) / 2.0)
        if not bounds or not _feq(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int,
                     min_data_in_bin: int) -> List[float]:
    """Greedy equal-count binning (reference GreedyFindBin, bin.cpp:74-150).

    Vectorized: instead of walking every distinct value, each emitted
    boundary is located with O(log n) searches (cumulative-count
    searchsorted + next-big-bin lookup), so the cost is O(max_bin log n)
    rather than O(n) Python iterations.  Bit-identical to the scalar
    oracle above (fuzz-tested)."""
    num_distinct = len(distinct_values)
    if max_bin <= 0:
        raise ValueError("max_bin must be positive")
    if num_distinct == 0:
        return [math.inf]
    bounds: List[float] = []
    if num_distinct <= max_bin:
        # small case: emit a boundary whenever >= min_data_in_bin rows
        # accumulated; the scalar loop is already O(max_bin)
        return _greedy_find_bin_scalar(distinct_values, counts, max_bin,
                                       total_cnt, min_data_in_bin)

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    counts = np.asarray(counts, np.int64)
    mean0 = total_cnt / max_bin
    is_big = counts >= mean0
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = total_cnt - int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    cum = np.cumsum(counts)                       # inclusive prefix counts
    cum_nb = np.cumsum(np.where(is_big, 0, counts))  # non-big prefix
    big_idx = np.nonzero(is_big)[0]

    upper: List[float] = []
    lower: List[float] = [float(distinct_values[0])]
    i0 = 0                                        # first index of open bin
    limit = num_distinct - 1                      # scalar loop scans [0, n-2]
    while len(upper) < max_bin - 1:
        base = cum[i0 - 1] if i0 > 0 else 0
        # condition A: is_big[i]
        j = np.searchsorted(big_idx, i0)
        i_a = int(big_idx[j]) if j < len(big_idx) else limit
        # condition B: cur = cum[i] - base >= mean_bin_size (clamped to the
        # open segment: mean can hit 0 at the tail, where the scalar loop
        # still fires no earlier than the running index)
        i_b = max(int(np.searchsorted(cum, base + mean_bin_size)), i0)
        # condition C: is_big[i+1] and cur >= max(1, mean/2)
        i_half = int(np.searchsorted(cum, base + max(1.0,
                                                     mean_bin_size * 0.5)))
        jj = np.searchsorted(big_idx, max(i0, i_half) + 1)
        i_c = int(big_idx[jj]) - 1 if jj < len(big_idx) else limit
        i = min(i_a, i_b, i_c)
        if i >= limit:        # no boundary fires within the scanned range
            break
        upper.append(float(distinct_values[i]))
        lower.append(float(distinct_values[i + 1]))
        if len(upper) >= max_bin - 1:
            break
        # rest_sample_cnt drops by all non-big counts consumed so far
        if not is_big[i]:
            nb_consumed = int(cum_nb[i])
            rest_bin_cnt -= 1
            mean_bin_size = (rest_sample_cnt - nb_consumed) \
                / max(rest_bin_cnt, 1)
        i0 = i + 1
    for i in range(len(upper)):
        val = _double_upper_bound((upper[i] + lower[i + 1]) / 2.0)
        if not bounds or not _feq(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def _find_bin_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_sample_cnt: int,
                              min_data_in_bin: int) -> List[float]:
    """Bin negative and positive halves separately with a dedicated zero bin
    (reference FindBinWithZeroAsOneBin, bin.cpp:152-206)."""
    neg_mask = distinct_values <= -K_ZERO_THRESHOLD
    pos_mask = distinct_values > K_ZERO_THRESHOLD
    zero_mask = ~neg_mask & ~pos_mask
    left_cnt_data = int(counts[neg_mask].sum())
    cnt_zero = int(counts[zero_mask].sum())
    right_cnt_data = int(counts[pos_mask].sum())

    left_idx = np.nonzero(~neg_mask)[0]
    left_cnt = int(left_idx[0]) if len(left_idx) else len(distinct_values)

    bounds: List[float] = []
    if left_cnt > 0:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bounds = _greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                  left_max_bin, left_cnt_data, min_data_in_bin)
        bounds[-1] = -K_ZERO_THRESHOLD

    right_idx = np.nonzero(pos_mask[left_cnt:])[0]
    if len(right_idx):
        right_start = left_cnt + int(right_idx[0])
        right_max_bin = max_bin - 1 - len(bounds)
        if right_max_bin <= 0:
            raise ValueError("max_bin too small for zero-as-one-bin split")
        right_bounds = _greedy_find_bin(distinct_values[right_start:],
                                        counts[right_start:], right_max_bin,
                                        right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(right_bounds)
    else:
        bounds.append(math.inf)
    return bounds


def _need_filter(cnt_in_bin: Sequence[int], total_cnt: int, filter_cnt: int,
                 bin_type: str) -> bool:
    """True if no split of this feature can satisfy min_data constraints
    (reference NeedFilter, bin.cpp:50-72)."""
    if bin_type == BIN_NUMERICAL:
        s = 0
        for c in cnt_in_bin[:-1]:
            s += c
            if s >= filter_cnt and total_cnt - s >= filter_cnt:
                return False
        return True
    if len(cnt_in_bin) <= 2:
        for c in cnt_in_bin[:-1]:
            if c >= filter_cnt and total_cnt - c >= filter_cnt:
                return False
        return True
    return False


class BinMapper:
    """Per-feature value->bin mapping, serializable for distributed find-bin."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: str = MISSING_NONE
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_type: str = BIN_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([math.inf])
        self.bin_2_categorical: np.ndarray = np.empty(0, dtype=np.int64)
        self.categorical_2_bin: dict = {}
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int,
                 bin_type: str = BIN_NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False) -> "BinMapper":
        """Construct the mapping from sampled values of one feature.

        ``values`` are the sampled *recorded* values; ``total_sample_cnt`` is
        the number of sampled rows (unrecorded rows are implicit zeros), the
        same contract as reference ``BinMapper::FindBin`` (bin.cpp:208-402).
        """
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        values = values[~nan_mask]
        num_sample_values = len(values)

        if not use_missing:
            self.missing_type = MISSING_NONE
            na_cnt = 0
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - num_sample_values - na_cnt)
        if zero_cnt < 0:
            zero_cnt = 0

        # distinct values with counts; merge near-equal doubles (pairwise
        # CheckDoubleEqualOrdered on consecutive sorted samples, as the
        # reference does), fold the implicit zeros in at their sorted
        # position.  Vectorized: group boundaries are where the next value
        # exceeds nextafter(prev); the group's representative is its LAST
        # member (the scalar loop kept overwriting with ``cur``).
        values.sort(kind="stable")
        if num_sample_values > 0:
            same = values[1:] <= np.nextafter(values[:-1], np.inf)
            starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
            ends = np.concatenate([starts[1:], [num_sample_values]])
            dv = values[ends - 1]
            cv = (ends - starts).astype(np.int64)
            # zero-group insertion exactly where the scalar loop put it:
            # between a group ending < 0 and the next starting > 0 (note:
            # the scalar test uses the RAW neighbours values[i-1], values[i]
            # of the group boundary, which are the group's last/next-first)
            prevs = values[starts[1:] - 1]
            curs = values[starts[1:]]
            zpos = np.nonzero((prevs < 0.0) & (curs > 0.0))[0]
            if len(zpos):
                at = int(zpos[0]) + 1
                dv = np.insert(dv, at, 0.0)
                cv = np.insert(cv, at, zero_cnt)
            elif values[0] > 0.0 and zero_cnt > 0:
                dv = np.concatenate([[0.0], dv])
                cv = np.concatenate([[zero_cnt], cv])
            elif values[-1] < 0.0 and zero_cnt > 0:
                dv = np.concatenate([dv, [0.0]])
                cv = np.concatenate([cv, [zero_cnt]])
        else:
            dv = np.asarray([0.0])
            cv = np.asarray([zero_cnt], dtype=np.int64)

        if len(dv) == 0:
            dv = np.asarray([0.0])
            cv = np.asarray([max(total_sample_cnt - na_cnt, 0)],
                            dtype=np.int64)
        self.min_val = float(dv[0])
        self.max_val = float(dv[-1])

        cnt_in_bin: List[int] = []
        if bin_type == BIN_NUMERICAL:
            if self.missing_type == MISSING_NAN:
                bounds = _find_bin_zero_as_one_bin(
                    dv, cv, max_bin - 1, total_sample_cnt - na_cnt, min_data_in_bin)
                bounds.append(math.nan)
            else:
                bounds = _find_bin_zero_as_one_bin(
                    dv, cv, max_bin, total_sample_cnt, min_data_in_bin)
                if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
            i_bins = np.searchsorted(self.bin_upper_bound, dv, side="left")
            cnt_in_bin = np.bincount(i_bins, weights=cv.astype(np.float64),
                                     minlength=self.num_bin
                                     ).astype(np.int64).tolist()
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
        else:
            cnt_in_bin = self._find_bin_categorical(
                dv, cv, na_cnt, total_sample_cnt, max_bin, min_data_in_bin)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and _need_filter(
                cnt_in_bin, total_sample_cnt, min_split_data, bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
            self.sparse_rate = (cnt_in_bin[self.default_bin]
                                / max(total_sample_cnt, 1))
        else:
            self.sparse_rate = 1.0
        return self

    def _find_bin_categorical(self, dv, cv, na_cnt, total_sample_cnt, max_bin,
                              min_data_in_bin) -> List[int]:
        """Count-sorted categorical binning (reference bin.cpp:302-377)."""
        cats: List[int] = []
        counts: List[int] = []
        for v, c in zip(dv, cv):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                continue
            if cats and iv == cats[-1]:
                counts[-1] += int(c)
            else:
                cats.append(iv)
                counts.append(int(c))
        self.num_bin = 0
        rest_cnt = total_sample_cnt - na_cnt
        cnt_in_bin: List[int] = []
        self.categorical_2_bin = {}
        b2c: List[int] = []
        if rest_cnt > 0 and cats:
            order = np.argsort(np.asarray(counts), kind="stable")[::-1]
            cats = [cats[i] for i in order]
            counts = [counts[i] for i in order]
            # bin 0 must not be category 0 (default/zero category keeps a
            # non-zero bin id, reference bin.cpp:330-338)
            if cats[0] == 0:
                if len(cats) == 1:
                    cats.append(cats[0] + 1)
                    counts.append(0)
                cats[0], cats[1] = cats[1], cats[0]
                counts[0], counts[1] = counts[1], counts[0]
            cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
            used_cnt = 0
            max_bin = min(len(cats), max_bin)
            cur = 0
            while cur < len(cats) and (used_cnt < cut_cnt or self.num_bin < max_bin):
                if counts[cur] < min_data_in_bin and cur > 1:
                    break
                b2c.append(cats[cur])
                self.categorical_2_bin[cats[cur]] = self.num_bin
                used_cnt += counts[cur]
                cnt_in_bin.append(counts[cur])
                self.num_bin += 1
                cur += 1
            if cur == len(cats) and na_cnt > 0:
                b2c.append(-1)   # -1 represents NaN
                self.categorical_2_bin[-1] = self.num_bin
                cnt_in_bin.append(0)
                self.num_bin += 1
            if cur == len(cats) and na_cnt == 0:
                self.missing_type = MISSING_NONE
            elif na_cnt == 0:
                self.missing_type = MISSING_ZERO
            else:
                self.missing_type = MISSING_NAN
            if cnt_in_bin:
                cnt_in_bin[-1] += total_sample_cnt - used_cnt
        self.bin_2_categorical = np.asarray(b2c, dtype=np.int64)
        return cnt_in_bin

    # ------------------------------------------------------------------
    def value_to_bin(self, value: float) -> int:
        """Scalar value->bin (reference bin.h:452-488)."""
        if isinstance(value, float) and math.isnan(value):
            if self.missing_type == MISSING_NAN:
                return self.num_bin - 1
            value = 0.0
        if self.bin_type == BIN_NUMERICAL:
            hi = self.num_bin - (2 if self.missing_type == MISSING_NAN else 1)
            lo = 0
            while lo < hi:
                mid = (hi + lo - 1) // 2
                if value <= self.bin_upper_bound[mid]:
                    hi = mid
                else:
                    lo = mid + 1
            return lo
        iv = int(value)
        if iv < 0:
            return self.num_bin - 1
        return self.categorical_2_bin.get(iv, self.num_bin - 1)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin for a column of raw values."""
        values = np.asarray(values, dtype=np.float64)
        out = np.empty(len(values), dtype=np.int32)
        nan_mask = np.isnan(values)
        if self.bin_type == BIN_NUMERICAL:
            n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
            filled = np.where(nan_mask, 0.0, values)
            # bin = first i with value <= upper_bound[i]; side='left' on the
            # ascending bounds gives exactly that, clamped to the last
            # searchable bin when value exceeds every bound
            out[:] = np.searchsorted(self.bin_upper_bound[:n_search - 1],
                                     filled, side="left")
            if self.missing_type == MISSING_NAN:
                out[nan_mask] = self.num_bin - 1
        else:
            iv = np.where(nan_mask, -1, values).astype(np.int64)
            default = self.num_bin - 1
            if len(self.bin_2_categorical):
                max_cat = int(max(self.categorical_2_bin.keys(), default=0))
                if max_cat < (1 << 22):
                    lut = np.full(max_cat + 2, default, dtype=np.int32)
                    for c, b in self.categorical_2_bin.items():
                        if c >= 0:
                            lut[c] = b
                    clipped = np.clip(iv, 0, max_cat + 1)
                    out[:] = lut[clipped]
                    out[iv < 0] = default
                    out[iv > max_cat] = default
                else:
                    out[:] = [self.categorical_2_bin.get(int(v), default)
                              if v >= 0 else default for v in iv]
            else:
                out[:] = default
        return out

    # ------------------------------------------------------------------
    def bin_to_value(self, bin_idx: int) -> float:
        """Representative raw value of a bin (used for threshold output)."""
        if self.bin_type == BIN_NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])

    def to_state(self) -> dict:
        """Serializable state (analog of CopyTo for distributed find-bin and
        the dataset binary cache)."""
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": self.bin_2_categorical.tolist(),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_state(cls, state: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(state["num_bin"])
        m.missing_type = state["missing_type"]
        m.is_trivial = bool(state["is_trivial"])
        m.sparse_rate = float(state["sparse_rate"])
        m.bin_type = state["bin_type"]
        m.bin_upper_bound = np.asarray(state["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = np.asarray(state["bin_2_categorical"], dtype=np.int64)
        m.categorical_2_bin = {int(c): i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = float(state["min_val"])
        m.max_val = float(state["max_val"])
        m.default_bin = int(state["default_bin"])
        return m

    # feature_infos string for the text model format: numerical "[min:max]",
    # categorical "cat1:cat2:..." (reference dataset.cpp feature infos)
    def feature_info_str(self) -> str:
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_NUMERICAL:
            return f"[{self.min_val}:{self.max_val}]"
        return ":".join(str(int(c)) for c in self.bin_2_categorical)
