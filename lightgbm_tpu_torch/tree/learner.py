"""Serial leaf-wise tree learner driven from the host (counterpart of
``lightgbm_tpu/tree/learner.py``, the reference's ``SerialTreeLearner``,
``src/treelearner/serial_tree_learner.cpp:157-221``).

It trains what the device grower (``ops/grow.py``) does not take:
monotone constraints, forced splits, the objectives that renew their leaf
outputs (``regression_l1``, ``quantile``, ``mape``), custom gradients
(``fobj``), ``device_growth=off`` and ``2 * COUNT_SPLIT_ROWS`` rows or more
(``ops/grow.py::host_learner_reason``).  The host runs the best-first
loop and keeps the tree; the device keeps the ``(G, N)`` codes, the
gradients and a buffer of row indices in which every leaf owns a
contiguous window.  Each split

  1. partitions the split leaf's window stably (``ops/partition.py``),
  2. builds the smaller child's histogram over its window on the wave
     kernel's list mode (``ops/histogram.build_histogram``; full-f32 stat
     columns summed in int64 fixed point on the card),
  3. takes the larger child as parent minus smaller, and
  4. scans both children for their best split (``ops/split.py``),

and the host reads the two children's split records and the partition's
left count: the per-split syncs are the design of this learner, so it is
not captured into a CUDA graph.  A window is the exact slice of the
buffer: the kernel reads a row list of any length, so there is no bucket
padding (the JAX package pads windows to powers of two to bound its
compiled programs).

The device work sits behind the JAX package's hooks (``_init_state``,
``_leaf_histogram``, ``_leaf_totals``, ``_find_best``, ``_partition``,
``_subtract``, ``bagging_state``, ``goss_state``) for the distributed
learners to override.  Monotone constraints propagate the children's
output midpoint (serial_tree_learner.cpp:765-776); forced splits follow
the JSON breadth first (``ForceSplits``, serial_tree_learner.cpp:546-701).
Left counts come from the partition (exact at any row count), not from
the f32 count column.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..ops.bagging import bagging_partition, goss_partition
from ..ops.histogram import (bucket_size, build_histogram, slot_pitch,
                             stat_columns)
from ..ops.partition import apply_leaf_outputs, partition_leaf
from ..ops.split import (F_DEFAULT_LEFT, F_FEATURE, F_GAIN, F_IS_CAT,
                         F_LEFT_C, F_LEFT_G, F_LEFT_H, F_LEFT_OUT,
                         F_RIGHT_C, F_RIGHT_G, F_RIGHT_H, F_RIGHT_OUT,
                         F_THRESHOLD, FeatureMeta, SplitHyper,
                         find_best_split)
from ..utils import random as trandom
from ..utils.log import TRAIN_TIMER, log_warning
from .tree import Tree, categorical_bitsets


class SplitParams(NamedTuple):
    """Host-side decoded split of one leaf, for the partition."""
    group: int
    offset: int
    width: int
    default_bin: int
    num_bin: int
    missing: int
    threshold: int
    default_left: bool
    is_cat: bool
    cat_member: np.ndarray    # (256,) bool


class _LeafInfo:
    __slots__ = ("leaf_id", "begin", "count", "total", "cmin", "cmax",
                 "hist", "best", "depth", "output")

    def __init__(self, leaf_id, begin, count, total, cmin, cmax, hist, depth,
                 output):
        self.leaf_id = leaf_id
        self.begin = begin
        self.count = count          # rows of the leaf
        self.total = total          # (g, h, c) floats on the host
        self.cmin = cmin
        self.cmax = cmax
        self.hist = hist            # (G*nb, 3) device histogram or None
        self.best = None            # (packed (13,), member) from find_best
        self.depth = depth
        self.output = output        # current leaf output value


class SerialTreeLearner:
    """Grows one tree from ``(N,)`` f32 gradient and hessian tensors on
    ``device``."""

    def __init__(self, config, dataset, device: torch.device,
                 binned_t: Optional[torch.Tensor] = None):
        self.config = config
        self.dataset = dataset
        self.device = device
        self.num_data = int(dataset.num_data)
        # the bagging and GOSS draws' pad (the JAX package's index buffer)
        self.n_pad = bucket_size(max(self.num_data, 1))
        self.nb = slot_pitch(dataset)
        if binned_t is None:
            binned = dataset.binned
            if not isinstance(binned, torch.Tensor):
                binned = torch.from_numpy(np.asarray(binned))
            binned_t = binned.to(device).t().contiguous()
        # (G, N) codes, as the kernel reads them per group (a device
        # grower's codes when one already holds them on the card)
        self.binned_t = binned_t
        self.meta = FeatureMeta.from_dataset(dataset, slot_stride=self.nb,
                                             device=device)
        self.hyper = SplitHyper.from_config(config)
        self.has_cat = bool(np.asarray(dataset.f_is_categorical).any())
        self._full_indices = torch.arange(self.n_pad, dtype=torch.int32,
                                          device=device)
        self._rng = np.random.RandomState(
            (config.feature_fraction_seed if config.feature_fraction_seed
             else config.seed + 2) & 0x7FFFFFFF)
        self.forced_splits = None   # parsed forced-split JSON or None
        # int8 quantization is the device grower's representation; this
        # learner keeps full-f32 histograms and says so on its first tree
        self._warn_quant = int(getattr(config, "grad_quant_bits", 0)
                               or 0) > 0
        self.buffer = None
        self.data_count = self.num_data
        self.leaves: Dict[int, _LeafInfo] = {}
        self._ghk = self._amax = None

    @property
    def traverse_binned(self) -> torch.Tensor:
        """``(G, N)`` codes for whole-data traversals
        (``ops/traverse.py`` with ``groups_major``)."""
        return self.binned_t

    # ------------------------------------------------------------------
    def _feature_mask(self) -> torch.Tensor:
        """The JAX package's numpy draw (``RandomState.choice`` without
        replacement, one stream per learner; not Threefry)."""
        nf = self.dataset.num_features
        frac = self.config.feature_fraction
        if frac >= 1.0 or nf <= 1:
            return torch.ones(nf, dtype=torch.bool, device=self.device)
        k = max(1, int(math.ceil(nf * frac)))
        chosen = self._rng.choice(nf, size=k, replace=False)
        mask = np.zeros(nf, dtype=bool)
        mask[chosen] = True
        return torch.as_tensor(mask, device=self.device)

    # ------------------------------------------------------------------
    # overridable device hooks
    def bagging_state(self, seed: int, fraction: float):
        """Bagging selection: (index buffer with the in-bag rows first,
        in-bag count)."""
        buf, cnt = bagging_partition(trandom.PRNGKey(seed), self.n_pad,
                                     self.num_data, fraction, self.device)
        return buf, int(cnt)

    def goss_state(self, seed: int, score_abs: torch.Tensor, top_rate: float,
                   other_rate: float):
        """GOSS selection (goss.hpp:88-133): (index buffer, selected
        count, (N,) grad/hess multiplier)."""
        pad = self.n_pad - self.num_data
        if pad > 0:
            score_abs = torch.nn.functional.pad(score_abs, (0, pad))
        buf, cnt, mult = goss_partition(trandom.PRNGKey(seed), score_abs,
                                        self.n_pad, self.num_data, top_rate,
                                        other_rate)
        return buf, int(cnt), mult[:self.num_data]

    def _init_state(self, indices_buffer, data_count, grad, hess):
        """The tree's partition buffer (a private copy: partitions write
        it in place, and the caller's bagging buffer serves several
        trees) and stat columns; returns (grad, hess)."""
        if indices_buffer is None:
            indices_buffer = self._full_indices
            data_count = self.num_data
        self.buffer = indices_buffer.to(torch.int32).clone()
        self.data_count = int(data_count)
        self._ghk = stat_columns(grad, hess)
        self._amax = self._ghk.abs().amax(dim=0)
        return grad, hess

    def _rows(self, info: _LeafInfo) -> torch.Tensor:
        return self.buffer[info.begin:info.begin + info.count]

    def _leaf_histogram(self, grad, hess, info: _LeafInfo):
        TRAIN_TIMER.start("hist")
        out = build_histogram(self.binned_t, self._ghk, self._rows(info),
                              self.nb, self._amax)
        return TRAIN_TIMER.stop_sync("hist", out)

    def _leaf_totals(self, hist) -> np.ndarray:
        """Leaf totals from group 0's slots (every row lands in one)."""
        return hist[:self.nb].sum(0).double().cpu().numpy()

    def _subtract(self, parent_hist, small_hist):
        """Larger child = parent - smaller child (the histogram
        subtraction trick, ``serial_tree_learner.cpp:508-513``)."""
        return parent_hist - small_hist

    def _find_best(self, info: _LeafInfo, feature_mask):
        total = torch.as_tensor(np.asarray(info.total, np.float32),
                                device=self.device)
        TRAIN_TIMER.start("find_split")
        packed, member, _ = find_best_split(
            info.hist[None], total[None], feature_mask, self.meta,
            self.hyper, has_cat=self.has_cat,
            constraint=(info.cmin, info.cmax))
        TRAIN_TIMER.stop_sync("find_split", packed)
        return packed[0], None if member is None else member[0]

    def _partition(self, info: _LeafInfo, sp: SplitParams) -> int:
        """Partition the leaf's window (the left child keeps the leaf's
        id and the window's head); returns the left count."""
        member = torch.as_tensor(sp.cat_member, device=self.device) \
            if sp.is_cat else None
        TRAIN_TIMER.start("partition")
        rows, left = partition_leaf(
            self.binned_t, self._rows(info), group=sp.group,
            offset=sp.offset, width=sp.width, default_bin=sp.default_bin,
            num_bin=sp.num_bin, missing=sp.missing, threshold=sp.threshold,
            default_left=sp.default_left, is_cat=sp.is_cat,
            cat_member=member)
        self.buffer[info.begin:info.begin + info.count] = rows
        TRAIN_TIMER.stop_sync("partition", self.buffer)
        return left

    # ------------------------------------------------------------------
    def train(self, grad, hess, indices_buffer=None, data_count=None,
              feature_mask=None) -> Tree:
        """Grow one tree.  ``indices_buffer`` is the bagging state of
        :meth:`bagging_state` (a permutation whose first ``data_count``
        entries are the rows to use); all rows by default."""
        cfg = self.config
        if self._warn_quant:
            self._warn_quant = False
            log_warning("grad_quant_bits is only applied by the "
                        "on-device grower; the host tree learner keeps "
                        "full-precision f32 histograms")
        grad, hess = self._init_state(indices_buffer, data_count, grad, hess)
        if feature_mask is None:
            feature_mask = self._feature_mask()

        tree = Tree(cfg.num_leaves)
        leaves: Dict[int, _LeafInfo] = {}
        if self.dataset.num_groups == 0 or self.dataset.num_features == 0:
            rows = self.buffer[:self.data_count].long()
            g, h = float(grad[rows].sum()), float(hess[rows].sum())
            root = _LeafInfo(0, 0, self.data_count,
                             np.asarray([g, h, self.data_count]),
                             -math.inf, math.inf, None, 0,
                             self._leaf_output(g, h))
            tree.leaf_value[0] = root.output
            leaves[0] = root
            self.leaves = leaves
            return tree

        root = _LeafInfo(0, 0, self.data_count, None, -math.inf, math.inf,
                         None, 0, 0.0)
        root.hist = self._leaf_histogram(grad, hess, root)
        root.total = self._leaf_totals(root.hist)
        root.output = self._leaf_output(root.total[0], root.total[1])
        tree.leaf_value[0] = root.output
        leaves[0] = root
        self._schedule_find_best(root, feature_mask)

        forced_queue = self._init_forced(tree)
        if forced_queue:
            self._run_forced(tree, leaves, forced_queue, grad, hess,
                             feature_mask)

        while len(leaves) < cfg.num_leaves:
            best_leaf, best = self._pick_best_leaf(leaves)
            if best_leaf is None:
                break
            self._apply_split(tree, leaves, best_leaf, best, grad, hess,
                              feature_mask)
        self.leaves = leaves
        return tree

    # ------------------------------------------------------------------
    def _leaf_output(self, sum_g, sum_h):
        cfg = self.config
        l1, l2 = cfg.lambda_l1, cfg.lambda_l2
        reg = max(abs(sum_g) - l1, 0.0) * (1 if sum_g >= 0 else -1) \
            if l1 > 0 else sum_g
        out = -reg / (sum_h + l2) if (sum_h + l2) != 0 else 0.0
        mds = cfg.max_delta_step
        if mds > 0 and abs(out) > mds:
            out = math.copysign(mds, out)
        return out

    def _splittable(self, info: _LeafInfo) -> bool:
        cfg = self.config
        if info.count <= 2 * cfg.min_data_in_leaf:
            return False
        if info.total[1] <= 2 * cfg.min_sum_hessian_in_leaf:
            return False
        if cfg.max_depth > 0 and info.depth >= cfg.max_depth:
            return False
        return True

    def _schedule_find_best(self, info: _LeafInfo, feature_mask):
        info.best = self._find_best(info, feature_mask) \
            if self._splittable(info) else None

    def _pick_best_leaf(self, leaves):
        """The leaf of the largest gain (the first on a tie); reads the
        pending records (usually the two new children) in one copy."""
        pending = [leaf for leaf in leaves
                   if leaves[leaf].best is not None
                   and isinstance(leaves[leaf].best[0], torch.Tensor)]
        if pending:
            host = torch.stack([leaves[leaf].best[0]
                                for leaf in pending]).cpu().numpy()
            for leaf, vec in zip(pending, host):
                leaves[leaf].best = (vec, leaves[leaf].best[1])
        best_leaf, best_rec, best_gain = None, None, 0.0
        for leaf in sorted(leaves):
            info = leaves[leaf]
            if info.best is None:
                continue
            gain = info.best[0][F_GAIN]
            if gain > best_gain:
                best_leaf, best_rec, best_gain = leaf, info.best, gain
        return best_leaf, best_rec

    # ------------------------------------------------------------------
    def _apply_split(self, tree, leaves, leaf, best, grad, hess,
                     feature_mask):
        ds = self.dataset
        info = leaves[leaf]
        vec, member = best
        f = int(vec[F_FEATURE])
        real_f = ds.used_features[f]
        mapper = ds.bin_mappers[real_f]
        nb = int(ds.f_num_bin[f])
        default_bin = int(ds.f_default_bin[f])
        is_cat = bool(vec[F_IS_CAT])
        sp = SplitParams(
            group=int(ds.f_group[f]), offset=int(ds.f_offset[f]),
            width=nb - (1 if default_bin == 0 else 0),
            default_bin=default_bin, num_bin=nb,
            missing=int(ds.f_missing_type[f]),
            threshold=int(vec[F_THRESHOLD]),
            default_left=bool(vec[F_DEFAULT_LEFT]), is_cat=is_cat,
            cat_member=(np.asarray(member.cpu() if isinstance(
                member, torch.Tensor) else member, bool) if is_cat
                else np.zeros(256, bool)))

        left_sum = np.asarray([vec[F_LEFT_G], vec[F_LEFT_H], vec[F_LEFT_C]],
                              np.float64)
        right_sum = np.asarray([vec[F_RIGHT_G], vec[F_RIGHT_H],
                                vec[F_RIGHT_C]], np.float64)
        left_out = float(vec[F_LEFT_OUT])
        right_out = float(vec[F_RIGHT_OUT])
        gain = float(vec[F_GAIN])

        # the partition's exact left count (the record's f32 count column
        # is exact only below 2^24 rows)
        lc = self._partition(info, sp)
        rc = info.count - lc
        if is_cat:
            member_bins = [int(bb) for bb in np.nonzero(sp.cat_member)[0]
                           if bb < nb]
            bitset_inner, bitset = categorical_bitsets(mapper, member_bins)
            right_leaf = tree.split_categorical(
                leaf, f, real_f, bitset_inner, bitset, left_out, right_out,
                lc, rc, gain, sp.missing)
        else:
            right_leaf = tree.split(
                leaf, f, real_f, sp.threshold,
                mapper.bin_to_value(sp.threshold), left_out, right_out, lc,
                rc, gain, sp.missing, sp.default_left)

        cmin, cmax = info.cmin, info.cmax
        lmin, lmax, rmin, rmax = cmin, cmax, cmin, cmax
        mono = int(ds.monotone_constraints[f])
        if mono != 0 and not is_cat:
            mid = (left_out + right_out) / 2.0
            if mono > 0:
                lmax, rmin = mid, mid
            else:
                lmin, rmax = mid, mid

        left_info = _LeafInfo(leaf, info.begin, lc, left_sum, lmin, lmax,
                              None, info.depth + 1, left_out)
        right_info = _LeafInfo(right_leaf, info.begin + lc, rc, right_sum,
                               rmin, rmax, None, info.depth + 1, right_out)
        leaves[leaf] = left_info
        leaves[right_leaf] = right_info

        # histogram: build the smaller child, subtract for the larger
        small, large = ((left_info, right_info) if lc <= rc
                        else (right_info, left_info))
        if self._splittable(small) or self._splittable(large):
            small.hist = self._leaf_histogram(grad, hess, small)
            large.hist = self._subtract(info.hist, small.hist)
        info.hist = None
        self._schedule_find_best(left_info, feature_mask)
        self._schedule_find_best(right_info, feature_mask)
        return right_leaf

    # ------------------------------------------------------------------
    # forced splits (reference ForceSplits, serial_tree_learner.cpp:546-701)
    def _init_forced(self, tree):
        """The breadth-first queue of (leaf, spec) forced splits."""
        if not self.forced_splits:
            return []
        return [(0, self.forced_splits)]

    def _run_forced(self, tree, leaves, forced_queue, grad, hess,
                    feature_mask):
        """Apply the forced-split JSON breadth first before best-gain
        growth.  A branch whose forced split is invalid (an unused
        feature, a min_data/min_hessian violation) is abandoned with a
        warning, as the reference skips it."""
        cfg = self.config
        while forced_queue and len(leaves) < cfg.num_leaves:
            leaf, spec = forced_queue.pop(0)
            right = self._apply_forced_split(tree, leaves, leaf, spec,
                                             grad, hess, feature_mask)
            if right is None:
                continue
            if isinstance(spec.get("left"), dict):
                forced_queue.append((leaf, spec["left"]))
            if isinstance(spec.get("right"), dict):
                forced_queue.append((right, spec["right"]))

    def _apply_forced_split(self, tree, leaves, leaf, spec, grad, hess,
                            feature_mask):
        ds = self.dataset
        cfg = self.config
        info = leaves[leaf]
        real_f = int(spec.get("feature", -1))
        try:
            fi = ds.used_features.index(real_f)
        except ValueError:
            log_warning(f"forced split on unused feature {real_f}; "
                        f"skipping branch")
            return None
        if info.hist is None or not self._splittable(info):
            return None
        mapper = ds.bin_mappers[real_f]
        if bool(ds.f_is_categorical[fi]):
            log_warning("forced categorical splits are not supported; "
                        "skipping branch")
            return None
        thr_bin = int(mapper.value_to_bin(float(spec["threshold"])))
        nb = int(ds.f_num_bin[fi])
        db = int(ds.f_default_bin[fi])
        miss = int(ds.f_missing_type[fi])
        thr_bin = min(thr_bin, nb - 2) if nb > 1 else 0
        # the feature's histogram with the default bin reconstructed
        flat = info.hist.double().cpu().numpy().reshape(-1, 3)
        grp = int(ds.f_group[fi])
        off = int(ds.f_offset[fi])
        shift = 1 if db == 0 else 0
        fh = np.zeros((256, 3), np.float64)
        for b in range(nb):
            if b != db:
                fh[b] = flat[grp * self.nb + off + b - shift]
        fh[db] = np.maximum(info.total - fh[:nb].sum(0) + fh[db], 0.0)
        # left = bins <= thr (the partition's rule with default_left
        # False: the NaN bin goes right)
        left_bins = np.arange(nb) <= thr_bin
        if miss == 2:
            left_bins[nb - 1] = False
        left = fh[:nb][left_bins].sum(0)
        right_sum = info.total - left
        if (left[2] < cfg.min_data_in_leaf
                or right_sum[2] < cfg.min_data_in_leaf
                or left[1] < cfg.min_sum_hessian_in_leaf
                or right_sum[1] < cfg.min_sum_hessian_in_leaf):
            log_warning(f"forced split on feature {real_f} violates "
                        f"min_data/min_hessian constraints; skipping branch")
            return None
        vec = np.zeros(13, np.float32)
        vec[F_FEATURE] = fi
        vec[F_THRESHOLD] = thr_bin
        vec[F_LEFT_G], vec[F_LEFT_H], vec[F_LEFT_C] = left
        vec[F_RIGHT_G], vec[F_RIGHT_H], vec[F_RIGHT_C] = right_sum
        vec[F_LEFT_OUT] = self._leaf_output(left[0], left[1])
        vec[F_RIGHT_OUT] = self._leaf_output(right_sum[0], right_sum[1])
        return self._apply_split(tree, leaves, leaf,
                                 (vec, np.zeros(256, bool)), grad, hess,
                                 feature_mask)

    # ------------------------------------------------------------------
    def leaf_regions(self):
        """[(leaf, begin, count)] of the final partition, by position."""
        return sorted(((leaf, li.begin, li.count)
                       for leaf, li in self.leaves.items()),
                      key=lambda t: t[1])

    def update_score(self, score: torch.Tensor, tree: Tree,
                     multiplier: float = 1.0) -> torch.Tensor:
        """Training-score update through the leaves' windows
        (``ScoreUpdater::AddScore``), in place.  Only the windows' rows
        get it: out-of-bag rows are the boosting layer's
        (gbdt.cpp:451-471)."""
        regions = self.leaf_regions()
        return apply_leaf_outputs(
            score, self.buffer, [r[2] for r in regions],
            np.asarray([tree.leaf_value[r[0]] * multiplier
                        for r in regions], np.float32))

    def leaf_indices_host(self) -> Dict[int, np.ndarray]:
        """Each leaf's row indices (host), for the leaf renewal."""
        buf = self.buffer[:self.data_count].cpu().numpy()
        return {leaf: buf[b:b + c] for leaf, b, c in self.leaf_regions()}
