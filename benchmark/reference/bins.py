"""Plain bin finding and codes: LightGBM's numerical ``BinMapper``
(``src/io/bin.cpp``: ``GreedyFindBin``, ``FindBinWithZeroAsOneBin``,
``NeedFilter``) on the ``bin_construct_sample_cnt`` sampled rows, in
float64 numpy with the reference's scalar loops, and the codes of every
row by a float64 search among the bounds.

Numerical features without NaN only (what the benchmark's generators
make): a NaN, or a pair of features that exclusive feature bundling
could merge, raises, so the comparison fails rather than judging against
semantics this file does not have.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

#: |v| <= this is zero (meta.h's 1e-35f, a float32 constant)
K_ZERO_THRESHOLD = float(np.float32(1e-35))


def sample_rows(num_data: int, sample_cnt: int, data_random_seed: int):
    """Sorted indices of the rows bins are found on: a numpy Generator
    seeded with ``data_random_seed`` choosing ``sample_cnt`` rows without
    replacement (all rows when there are no more)."""
    if sample_cnt >= num_data:
        return np.arange(num_data)
    rng = np.random.default_rng(np.uint64(data_random_seed
                                          & 0xFFFFFFFFFFFFFFFF))
    return np.sort(rng.choice(num_data, size=sample_cnt, replace=False))


def _upper(v: float) -> float:
    return float(np.nextafter(np.float64(v), np.float64(np.inf)))


def _feq(a: float, b: float) -> bool:
    return a <= b <= _upper(a)


def greedy_find_bin(dv, cv, max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """GreedyFindBin (bin.cpp:74-150), line by line."""
    n = len(dv)
    bounds: List[float] = []
    if n == 0:
        return [math.inf]
    if n <= max_bin:
        cur = 0
        for i in range(n - 1):
            cur += int(cv[i])
            if cur >= min_data_in_bin:
                val = _upper((dv[i] + dv[i + 1]) / 2.0)
                if not bounds or not _feq(bounds[-1], val):
                    bounds.append(val)
                    cur = 0
        bounds.append(math.inf)
        return bounds
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    is_big = [int(c) >= mean_bin_size for c in cv]
    rest_bin_cnt = max_bin - sum(is_big)
    rest_sample_cnt = total_cnt - sum(int(c) for c, b in zip(cv, is_big)
                                      if b)
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    upper, lower = [], [float(dv[0])]
    cur = 0
    for i in range(n - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(cv[i])
        cur += int(cv[i])
        if (is_big[i] or cur >= mean_bin_size
                or (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            upper.append(float(dv[i]))
            lower.append(float(dv[i + 1]))
            if len(upper) >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    for i in range(len(upper)):
        val = _upper((upper[i] + lower[i + 1]) / 2.0)
        if not bounds or not _feq(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def find_bin_zero_as_one_bin(dv, cv, max_bin: int, total_cnt: int,
                             min_data_in_bin: int) -> List[float]:
    """FindBinWithZeroAsOneBin (bin.cpp:152-206): the negative and the
    positive values binned apart around a bin of their own for zero."""
    neg = dv <= -K_ZERO_THRESHOLD
    pos = dv > K_ZERO_THRESHOLD
    cnt_zero = int(cv[~neg & ~pos].sum())
    left_cnt_data = int(cv[neg].sum())
    right_cnt_data = int(cv[pos].sum())
    left_cnt = int(np.argmax(~neg)) if (~neg).any() else len(dv)
    bounds: List[float] = []
    if left_cnt > 0:
        left_max_bin = max(1, int(left_cnt_data / max(total_cnt - cnt_zero, 1)
                                  * (max_bin - 1)))
        bounds = greedy_find_bin(dv[:left_cnt], cv[:left_cnt], left_max_bin,
                                 left_cnt_data, min_data_in_bin)
        bounds[-1] = -K_ZERO_THRESHOLD
    right = np.nonzero(pos[left_cnt:])[0]
    if len(right):
        start = left_cnt + int(right[0])
        right_max_bin = max_bin - 1 - len(bounds)
        rb = greedy_find_bin(dv[start:], cv[start:], right_max_bin,
                             right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(rb)
    else:
        bounds.append(math.inf)
    return bounds


def _distinct(values: np.ndarray, zero_cnt: int):
    """Sorted distinct values and counts, zero's implicit count folded in
    where the reference's loop puts it."""
    values = np.sort(values, kind="stable")
    dv: List[float] = []
    cv: List[int] = []
    if len(values) == 0 or (values[0] > 0.0 and zero_cnt > 0):
        dv.append(0.0)
        cv.append(zero_cnt)
    if len(values):
        # runs of consecutive values each within one ulp above the last;
        # a run is represented by its last value
        same = values[1:] <= np.nextafter(values[:-1], np.inf)
        cross = (values[:-1] < 0.0) & (values[1:] > 0.0)
        starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
        ends = np.concatenate([starts[1:], [len(values)]])
        for s, e in zip(starts.tolist(), ends.tolist()):
            if s > 0 and cross[s - 1]:
                dv.append(0.0)
                cv.append(zero_cnt)
            dv.append(float(values[e - 1]))
            cv.append(e - s)
        if values[-1] < 0.0 and zero_cnt > 0:
            dv.append(0.0)
            cv.append(zero_cnt)
    return np.asarray(dv, np.float64), np.asarray(cv, np.int64)


class Mapper:
    """One numerical feature's bins: ``upper`` bounds (float64, the last
    +inf), ``default_bin`` (zero's bin) and whether it is trivial."""

    def __init__(self, sample_col: np.ndarray, total_cnt: int, max_bin: int,
                 min_data_in_bin: int, filter_cnt: int):
        if np.isnan(sample_col).any():
            raise ValueError("the plain binning has no NaN handling")
        rec = sample_col[sample_col != 0.0]
        zero_cnt = max(int(total_cnt - len(rec)), 0)
        dv, cv = _distinct(rec, zero_cnt)
        if len(dv) == 0:
            dv, cv = np.asarray([0.0]), np.asarray([total_cnt], np.int64)
        bounds = find_bin_zero_as_one_bin(dv, cv, max_bin, total_cnt,
                                          min_data_in_bin)
        self.upper = np.asarray(bounds, np.float64)
        self.num_bin = len(bounds)
        idx = np.searchsorted(self.upper, dv, side="left")
        cnt = np.bincount(idx, weights=cv.astype(np.float64),
                          minlength=self.num_bin).astype(np.int64)
        self.trivial = self.num_bin <= 1
        if not self.trivial:
            s, keep = 0, False
            for c in cnt[:-1]:
                s += int(c)
                if s >= filter_cnt and total_cnt - s >= filter_cnt:
                    keep = True
                    break
            self.trivial = not keep
        self.default_bin = int(np.searchsorted(self.upper[:-1], 0.0,
                                               side="left"))


class Bins:
    """Bins of every column of ``x`` (an (N, F) float32 tensor) found on
    the sampled rows, and the used (non-trivial) columns in order."""

    def __init__(self, x: torch.Tensor, p: dict):
        n = int(x.shape[0])
        idx = sample_rows(n, int(p["bin_construct_sample_cnt"]),
                          int(p["data_random_seed"]))
        sample = x[torch.from_numpy(idx).to(x.device)].double().cpu().numpy()
        cnt = len(idx)
        filter_cnt = int(0.95 * p["min_data_in_leaf"] / max(n, 1) * cnt)
        self.mappers = [Mapper(sample[:, f], cnt, int(p["max_bin"]),
                               int(p["min_data_in_bin"]), filter_cnt)
                        for f in range(sample.shape[1])]
        self.used = [f for f, m in enumerate(self.mappers) if not m.trivial]
        self._check_no_bundle(sample)

    def _check_no_bundle(self, sample: np.ndarray) -> None:
        """Exclusive feature bundling (max_conflict_rate 0) merges two
        features only if no sampled row has both non-zero; refuse data
        where some pair could merge."""
        nz = torch.from_numpy(sample[:, self.used] != 0.0).double()
        both = nz.t() @ nz
        both.fill_diagonal_(1.0)
        if bool((both == 0).any()):
            raise ValueError("two features could be bundled; the plain "
                             "binning keeps every feature apart")

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        """(N, F') uint8 bin of every row in each used column."""
        out = torch.empty((x.shape[0], len(self.used)), dtype=torch.uint8,
                          device=x.device)
        for j, f in enumerate(self.used):
            ub = torch.from_numpy(self.mappers[f].upper[:-1]).to(x.device)
            out[:, j] = torch.searchsorted(ub, x[:, f].double(),
                                           side="left").to(torch.uint8)
        return out

    def stored(self, codes: torch.Tensor) -> torch.Tensor:
        """The codes as a one-feature group stores them: zero's bin as 0,
        every other bin ``b`` as ``b + 1``, or as ``b`` when zero's bin is
        bin 0 (feature_group.h's offset of 1)."""
        out = torch.empty_like(codes)
        for j, f in enumerate(self.used):
            d = self.mappers[f].default_bin
            c = codes[:, j]
            out[:, j] = c if d == 0 else torch.where(c == d, 0, c + 1)
        return out

    def num_bins(self) -> List[int]:
        return [self.mappers[f].num_bin for f in self.used]
