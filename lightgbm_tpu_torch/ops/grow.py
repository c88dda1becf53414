"""Leaf-wise tree growth on the device, in synchronized waves.

Counterpart of ``lightgbm_tpu/ops/grow.py`` (``GrowerPrograms._grow_impl``
and ``DeviceGrower``), unsharded, numerical features, with bf16 stat
columns or, under ``grad_quant_bits=8``, int8 quantized ones, and with the
per-tree bagging row mask and feature_fraction mask.  The formulation is
the JAX package's:

* a per-row ``leaf_id`` vector stands in for a row permutation; a split
  rewrites it with one elementwise pass over the ``(G, N)`` binned matrix;
* each *wave* builds, in one pass over all rows, the histograms of up to W
  pending leaves (the smaller child of each new split) with the
  hand-written kernel (``ops/hist_cuda.wave_hist``); the larger sibling is
  the parent minus the smaller one;
* every new leaf's best split comes from one batched scan
  (``ops/split.find_best_split_stack``), and the wave applies up to W of
  the best-gain splits at once, within the ``num_leaves`` budget;
* wave widths follow the legacy stage plan (``ops/stage_plan.py``).

Under ``grad_quant_bits=8`` the histograms, leaf totals and the split
scan stay int32 in quantized units (``ops/split.find_best_split_quant``),
so the parent-minus-sibling subtraction and every count are exact; after
growth each leaf's value is refit from the full-precision gradients with
an exact base-128 digit sum and written back into the split record that
created the leaf.

The JAX package runs the wave loop inside one ``lax.while_loop`` with no
host sync.  Here it is a Python loop that reads one number per wave (the
count of splits the wave applied) on the host; :class:`GrowResult` reports
the waves and host syncs.  Capturing a tree as a CUDA graph is later work.

Every per-leaf tensor has one junk row (index L; records: index L-1) that
absorbs the scatters of empty lanes, so a scatter never writes a live leaf
twice.  CUDA ``index_put_`` writes duplicate indices in no fixed order;
only the junk row ever receives duplicates, and nothing reads it as a
result.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import random as trandom
from ..utils.log import LightGBMError
from .hist_cuda import MAX_LEAF_BOUND, hist_scale_exponents, wave_hist
from .histogram import QUANT_MAX, bucket_size, quantize_gh
from .split import (F_DEFAULT_LEFT, F_FEATURE, F_GAIN, F_LEFT_C, F_LEFT_G,
                    F_LEFT_H, F_LEFT_OUT, F_RIGHT_C, F_RIGHT_G, F_RIGHT_H,
                    F_RIGHT_OUT, F_THRESHOLD, NEG_INF, FeatureMeta,
                    SplitHyper, find_best_split_quant, find_best_split_stack)
from .stage_plan import legacy_stage_plan

REC_I_FIELDS = 5    # leaf, right, feature, threshold, default_left
REC_F_FIELDS = 9    # gain, lg, lh, lc, rg, rh, rc, left_out, right_out
REC_F_LEFT_OUT, REC_F_RIGHT_OUT = 7, 8
# at or above this many rows the JAX package stripes its stat columns
# (two count columns; under quantization two g and h columns too) to keep
# every accumulator exact; the port has no striped layout yet.  Its
# quantized f32 fallback scan starts higher still, past (2^31 - 1) // 127
# rows (where int32 sums of |q| <= 127 could overflow), so refusing the
# striped layouts refuses that too.
COUNT_SPLIT_ROWS = 1 << 24
HIST_COLS = 3       # [g, h, 1] stat columns, bf16 or int8


class GrowResult(NamedTuple):
    score: torch.Tensor       # (num_data,) f32 score after this tree
    rec_i: torch.Tensor       # (L-1, 5) int32 split records
    rec_f: torch.Tensor       # (L-1, 9) f32 split records
    num_leaves: int
    root_value: torch.Tensor  # () f32 root leaf output
    waves: int
    host_syncs: int


def _wave_width(num_leaves: int, hist_cols: int) -> int:
    scale = 3.0 / hist_cols
    wmax = max(int(128 * scale), 4)
    return min(wmax, max(int(num_leaves) - 1, 1))


def _hist_layout(num_data: int, config):
    """(quant_bits, striped) for this row count and config
    (``lightgbm_tpu/ops/grow.py::_hist_layout``).  The port runs only the
    layouts with :data:`HIST_COLS` columns: ``check_slice_config``
    refuses the striped and gpu_use_dp ones."""
    quant_bits = int(getattr(config, "grad_quant_bits", 0) or 0)
    return quant_bits, int(num_data) >= COUNT_SPLIT_ROWS


def feature_fraction_mask(seed: int, tree_idx: int, nf: int, k: int,
                          device=None) -> torch.Tensor:
    """(nf,) bool mask of ``k`` features drawn without replacement: the
    ``k`` smallest of ``nf`` uniforms under ``fold_in(PRNGKey(seed),
    tree_idx)`` (``lightgbm_tpu/ops/grow.py::feature_fraction_mask``)."""
    key = trandom.fold_in(trandom.PRNGKey(seed), tree_idx)
    u = trandom.uniform(key, (nf,), device=device)
    thr = torch.sort(u).values[k - 1]
    return u <= thr


def check_slice_config(config, dataset) -> None:
    """Refuse, by name, the options whose code paths the port does not
    have yet (the JAX package either supports them on its device grower
    or falls back to its host learner; the port has neither)."""
    todo = []
    n = int(dataset.num_data)
    quant_bits, striped = _hist_layout(n, config)
    if quant_bits not in (0, 8):
        todo.append(f"grad_quant_bits={quant_bits}")
    if striped:
        todo.append(f"{n} rows >= {COUNT_SPLIT_ROWS} (striped stat columns"
                    + (" and the f32 quantized scan" if quant_bits else "")
                    + ")")
    if config.gpu_use_dp:
        todo.append("gpu_use_dp (K=5/6 hi/lo stat columns)")
    if str(config.wave_plan) == "profiled":
        todo.append("wave_plan=profiled")
    if config.boosting != "gbdt":
        todo.append(f"boosting={config.boosting}")
    if np.asarray(dataset.f_is_categorical).any():
        todo.append("categorical features")
    if np.asarray(dataset.monotone_constraints).any():
        todo.append("monotone_constraints")
    if getattr(config, "forcedsplits_filename", ""):
        todo.append("forced splits")
    if int(config.num_leaves) > MAX_LEAF_BOUND:
        todo.append(f"num_leaves > {MAX_LEAF_BOUND}")
    if todo:
        raise LightGBMError("not ported to lightgbm_tpu_torch yet: "
                            + ", ".join(todo))


class DeviceGrower:
    """Grows one tree per call on ``device``.  Owns the ``(G, n_pad)``
    uint8 binned matrix (the transpose of the dataset's ``(N, G)`` one;
    the histogram kernel and the split application both read it per
    group) and the per-feature metadata."""

    def __init__(self, dataset, config, device: torch.device):
        check_slice_config(config, dataset)
        if dataset.num_groups == 0:
            raise LightGBMError("no usable features: every feature is "
                                "constant")
        self.config = config
        self.device = device
        self.num_data = int(dataset.num_data)
        self.num_groups = int(dataset.num_groups)
        self.num_leaves = int(config.num_leaves)
        # per-group slot pitch: smallest power of two covering every group
        nb = 64
        for grp in dataset.groups:
            while grp.num_total_bin > nb:
                nb *= 2
        self.nb = nb
        self.num_slots = self.num_groups * nb
        # pow2 row bucket: one set of buffer shapes per bucket (the shapes
        # a later CUDA-graph capture keys on); pad rows carry leaf id -1
        # and zero stats
        self.n_pad = bucket_size(max(self.num_data, 1)) \
            if config.train_row_bucketing \
            else self.num_data
        # a device-binned dataset's codes are transposed where they lie
        binned = dataset.binned
        if not isinstance(binned, torch.Tensor):
            binned = torch.from_numpy(binned)
        self.binned_t = torch.zeros((self.num_groups, self.n_pad),
                                    dtype=torch.uint8, device=device)
        self.binned_t[:, :self.num_data] = binned.to(device).t()
        self.meta = FeatureMeta.from_dataset(dataset, slot_stride=nb,
                                             device=device)
        self.hyper = SplitHyper.from_config(config)
        i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                        device=device)
        nbins = np.asarray(dataset.f_num_bin, np.int64)
        dbins = np.asarray(dataset.f_default_bin, np.int64)
        self.f_group = i64(dataset.f_group)
        self.f_offset = i64(dataset.f_offset)
        self.f_width = i64(nbins - (dbins == 0))
        self.quant_bits, _ = _hist_layout(self.num_data, config)
        self.wave_width = _wave_width(self.num_leaves, HIST_COLS)
        self.stage_plan = legacy_stage_plan(self.num_leaves, self.wave_width,
                                            HIST_COLS)
        self.lr = float(config.learning_rate)
        self._valid = torch.arange(self.n_pad, device=device) < self.num_data
        # sampling seeds (lightgbm_tpu/ops/grow.py:364-379)
        nf = int(self.meta.num_bin.shape[0])
        self._ff_frac = float(config.feature_fraction)
        self._ff_nf = nf
        self._ff_k = max(1, int(np.ceil(nf * self._ff_frac)))
        self._ff_seed = int(config.feature_fraction_seed
                            if config.feature_fraction_seed
                            else config.seed + 2) & 0x7FFFFFFF
        self._quant_seed = (int(config.seed) + 5) & 0x7FFFFFFF

    # ------------------------------------------------------------------
    def feature_mask_for(self, tree_idx: int) -> torch.Tensor:
        """The feature_fraction mask of global tree ``tree_idx``
        (``iter * num_model + class``); all features when the fraction
        is 1."""
        if self._ff_frac >= 1.0 or self._ff_nf <= 1:
            return torch.ones(self._ff_nf, dtype=torch.bool,
                              device=self.device)
        return feature_fraction_mask(self._ff_seed, tree_idx, self._ff_nf,
                                     self._ff_k, self.device)

    def _leaf_output(self, g, h):
        hp = self.hyper
        s = torch.sign(g) * torch.clamp(g.abs() - hp.lambda_l1, min=0.0)
        out = -s / (h + hp.lambda_l2 + 1e-35)
        if hp.max_delta_step <= 0.0:
            return out
        return torch.clamp(out, -hp.max_delta_step, hp.max_delta_step)

    def _splittable(self, total, depth, hess_scale=None):
        """``hess_scale`` dequantizes the hessian column of int32 totals
        (the quantized scan); counts compare directly either way."""
        cfg = self.config
        hess = total[..., 1]
        if hess_scale is not None:
            hess = hess.float() * hess_scale
        ok = (total[..., 2] > 2 * cfg.min_data_in_leaf) \
            & (hess > 2 * cfg.min_sum_hessian_in_leaf)
        if cfg.max_depth > 0:
            ok = ok & (depth < cfg.max_depth)
        return ok

    def _stat_columns(self, grad, hess, one_f, tree_idx):
        """(n_pad, 3) stat columns and the (2,) f32 dequantization scales
        (None without quantization).  ``one_f`` is the f32 0/1 row
        indicator (real row x in-bag); ``grad``/``hess`` are zero past
        the real rows but NOT bag-masked: the quantization scale is taken
        over every real row, out-of-bag ones included, as the JAX package
        takes it.

        int8: ``[g_q, h_q, 1]`` masked by ``one_f``, the rounding noise
        keyed ``fold_in(PRNGKey((seed + 5) & 0x7FFFFFFF), tree_idx)``.
        bf16 (lightgbm_tpu/ops/grow.py:597): g and h are rounded to bf16
        BEFORE the histogram, on purpose; ``.to(torch.bfloat16)`` rounds
        to nearest even like XLA's convert, so both packages see the same
        column values."""
        if self.quant_bits:
            key = trandom.fold_in(trandom.PRNGKey(self._quant_seed),
                                  tree_idx)
            sg, sh, gq, hq = quantize_gh(grad, hess, key)
            m8 = one_f.to(torch.int8)
            return torch.stack([gq * m8, hq * m8, m8], 1), torch.stack([sg,
                                                                       sh])
        one = one_f.to(torch.bfloat16)
        return torch.stack([grad.to(torch.bfloat16) * one,
                            hess.to(torch.bfloat16) * one, one], 1), None

    def _wave_hist(self, leaf_id, gh, pending, scale_exp):
        """(W, S, 3) histograms of the pending leaves: f32, or int32 in
        quantized units."""
        w = pending.shape[0]
        out = wave_hist(self.binned_t, leaf_id, gh, pending,
                        g=self.num_groups, nb=self.nb, k=HIST_COLS, w=w,
                        scale_exp=scale_exp, leaf_bound=self.num_leaves)
        return out.permute(2, 0, 1)             # (G*NB, K, W) -> (W, S, K)

    def _refit(self, grad, hess, one_f, leaf_id, scales):
        """(L,) leaf values refit from the full-precision gradients
        (lightgbm_tpu/ops/grow.py:1036-1058): each masked gradient is
        split into three base-128 int8 digits against the quantization
        scale (round to nearest, no noise) and the digits are summed per
        leaf in integers, so the sums are exact in any order."""
        L = self.num_leaves

        def digits(x, s):
            cols, r, sd = [], x, s
            for _ in range(3):
                d = torch.clamp(torch.round(r / sd), -QUANT_MAX, QUANT_MAX)
                r = r - d * sd
                cols.append(d.to(torch.int32))
                sd = sd / 128.0
            return cols

        dcols = torch.stack(digits(grad * one_f, scales[0])
                            + digits(hess * one_f, scales[1]), 1)
        idx = torch.where(leaf_id >= 0, leaf_id, L).long()
        sums6 = torch.zeros((L + 1, 6), dtype=torch.int32,
                            device=self.device).index_add_(0, idx, dcols)
        s = sums6[:L].float()
        gsum = (s[:, 0] + s[:, 1] * (1 / 128.0)
                + s[:, 2] * (1 / 16384.0)) * scales[0]
        hsum = (s[:, 3] + s[:, 4] * (1 / 128.0)
                + s[:, 5] * (1 / 16384.0)) * scales[1]
        return self._leaf_output(gsum, hsum)

    # ------------------------------------------------------------------
    def grow_one_iter(self, score, grad, hess, lr=None, feature_mask=None,
                      row_mask=None, tree_idx: int = 0) -> GrowResult:
        """Grow one tree from (num_data,) f32 gradients and return the
        updated score and the split records (device tensors).
        ``row_mask`` is the (num_data,) f32 0/1 in-bag indicator of
        bagging: out-of-bag rows drop out of the histograms and counts but
        are still routed to leaves, so the score update reaches them.
        ``tree_idx`` is the global tree index keying the quantization
        noise."""
        dev = self.device
        L, S, nb = self.num_leaves, self.num_slots, self.nb
        lr = self.lr if lr is None else float(lr)
        if feature_mask is None:
            feature_mask = torch.ones(self.meta.num_bin.shape[0],
                                      dtype=torch.bool, device=dev)
        pad = self.n_pad - self.num_data
        valid_f = self._valid.float()
        grad = F.pad(grad, (0, pad)) * valid_f
        hess = F.pad(hess, (0, pad)) * valid_f
        one_f = valid_f if row_mask is None \
            else valid_f * F.pad(row_mask, (0, pad))
        gh, qscales = self._stat_columns(grad, hess, one_f, tree_idx)
        quant = qscales is not None
        scale_exp = None if quant else hist_scale_exponents(gh, self.n_pad)
        i32 = dict(dtype=torch.int32, device=dev)
        hdtype = torch.int32 if quant else torch.float32

        leaf_id = torch.where(self._valid, 0, -1).to(torch.int32)
        hist = torch.zeros((L + 1, S, 3), dtype=hdtype, device=dev)
        total = torch.zeros((L + 1, 3), dtype=hdtype, device=dev)
        # the winner's exact int32 left totals (quantized scan only)
        bestl = torch.zeros((L + 1, 3), **i32) if quant else None
        value = torch.zeros((L + 1,), dtype=torch.float32, device=dev)
        depth = torch.zeros((L + 1,), **i32)
        neg_row = torch.full((13,), NEG_INF, dtype=torch.float32, device=dev)
        best = neg_row.repeat(L + 1, 1)
        rec_i = torch.full((L, REC_I_FIELDS), -1, **i32)
        rec_f = torch.zeros((L, REC_F_FIELDS), dtype=torch.float32,
                            device=dev)
        lane_of = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)

        W = self.wave_width
        # first stage width: copied exactly (lightgbm_tpu/ops/grow.py:710);
        # with the stage ladder it decides the growth order near the
        # num_leaves budget
        w0 = min(4, W) if (4 < W and 8 < L) else W
        p_parent = torch.full((w0,), -1, **i32)
        p_small = torch.full((w0,), -1, **i32)
        p_small[0] = 0
        p_large = torch.full((w0,), -1, **i32)
        nl, waves, syncs, done = 1, 0, 0, False

        for ws, cap in self.stage_plan:
            grow_by = ws - p_parent.shape[0]
            if grow_by > 0:
                p_parent, p_small, p_large = (
                    F.pad(p, (0, grow_by), value=-1)
                    for p in (p_parent, p_small, p_large))
            limit = L if cap is None else min(cap, L)
            while not done and nl < limit:
                # 1. fresh histograms of the pending smaller children
                fresh = self._wave_hist(leaf_id, gh, p_small, scale_exp)
                if waves == 0:
                    # root: totals from group 0's slots (every row hits one)
                    total[0] = fresh[0, :nb, :].sum(0)
                    rt = total[0].float()
                    if quant:
                        rt = rt[:2] * qscales
                    value[0] = self._leaf_output(rt[0], rt[1])
                # 2. larger sibling = parent - smaller (read the parents
                # before the fresh histograms overwrite their slots)
                par = torch.where(p_parent >= 0, p_parent, L).long()
                large = hist[par] - fresh
                sm_ok, lg_ok = p_small >= 0, p_large >= 0
                sm_idx = torch.where(sm_ok, p_small, L).long()
                lg_idx = torch.where(lg_ok, p_large, L).long()
                hist[sm_idx] = torch.where(sm_ok[:, None, None], fresh,
                                           hist[sm_idx])
                hist[lg_idx] = torch.where(lg_ok[:, None, None], large,
                                           hist[lg_idx])

                # 3. find-best for both siblings of every new split, one
                # batched scan over the (2*Ws, S, 3) stack
                ids = torch.cat([torch.where(sm_ok, p_small, -1),
                                 torch.where(lg_ok, p_large, -1)]).long()
                idc = ids.clamp(0, L - 1)
                stack = torch.cat([fresh, large])
                if quant:
                    packed, lint = find_best_split_quant(
                        stack, total[idc], qscales, feature_mask, self.meta,
                        self.hyper)
                    ok = self._splittable(total[idc], depth[idc],
                                          hess_scale=qscales[1])
                else:
                    packed = find_best_split_stack(
                        stack, total[idc], feature_mask, self.meta,
                        self.hyper)
                    ok = self._splittable(total[idc], depth[idc])
                ok = ok & (ids >= 0)
                packed[:, F_GAIN] = torch.where(
                    ok, packed[:, F_GAIN],
                    torch.full_like(packed[:, F_GAIN], NEG_INF))
                safe = torch.where(ids >= 0, ids, L)
                best[safe] = torch.where((ids >= 0)[:, None], packed,
                                         best[safe])
                if quant:
                    bestl[safe] = torch.where((ids >= 0)[:, None], lint,
                                              bestl[safe])

                # 4. select up to Ws best-gain splits within the budget.
                # Trouble spot (lightgbm_tpu/ops/grow.py:846): lax.top_k
                # breaks ties toward the lower index; torch.topk promises
                # no order on ties, a stable descending sort does.
                top_vals, top_idx = torch.sort(best[:L, F_GAIN],
                                               descending=True, stable=True)
                top_vals, lsel = top_vals[:ws], top_idx[:ws]
                lanes = torch.arange(ws, device=dev)
                sel = (top_vals > 0.0) & (lanes < L - nl)
                napply = int(sel.sum())               # the wave's host sync
                syncs += 1
                waves += 1
                if napply == 0:
                    done = True
                    break
                rank = torch.cumsum(sel.long(), 0) - 1
                vecs = best[lsel]                     # (Ws, 13)
                r_ids = nl + rank
                f = vecs[:, F_FEATURE].long()
                thr = vecs[:, F_THRESHOLD].long()
                dl = vecs[:, F_DEFAULT_LEFT] > 0.5

                # 5. apply the selected splits to leaf_id: each row looks up
                # its leaf's lane (a row belongs to at most one selected
                # leaf), reads that split's feature group and decides
                # left or right as lightgbm_tpu/ops/grow.py:869-916 does
                lane_of.fill_(-1)
                lane_of[torch.where(sel, lsel, L)] = lanes
                lane_of[L] = -1
                row_lane = lane_of[torch.where(leaf_id >= 0, leaf_id,
                                               L).long()]
                lane = row_lane.clamp(min=0)
                fl = f[lane]
                cols = self.binned_t.gather(
                    0, self.f_group[fl][None, :])[0].long()
                off, wid = self.f_offset[fl], self.f_width[fl]
                db = self.meta.default_bin[fl].long()
                nbin = self.meta.num_bin[fl].long()
                miss = self.meta.missing[fl]
                dl_r, thr_r = dl[lane], thr[lane]
                def_left = torch.where(miss == 1, dl_r, db <= thr_r)
                shift = (db == 0).long()
                in_range = (cols >= off) & (cols < off + wid)
                bin_ = torch.where(in_range, cols - off + shift, db)
                is_na = (miss == 2) & (bin_ == nbin - 1)
                goes_left = torch.where(bin_ == db, def_left,
                                        torch.where(is_na, dl_r,
                                                    bin_ <= thr_r))
                move = (row_lane >= 0) & ~goes_left
                leaf_id = torch.where(move, r_ids[lane].to(torch.int32),
                                      leaf_id)

                # 6. bookkeeping: scatter into the L-padded state
                safe_l = torch.where(sel, lsel, L)
                safe_r = torch.where(sel, r_ids, L)
                sel2 = sel[:, None]
                if quant:
                    # exact integer child totals: the winner's left sums
                    # from the scan, the right child by subtraction (read
                    # the parent before the scatter overwrites its slot)
                    lsum = bestl[lsel]
                    rsum = total[lsel] - lsum
                    small_left = lsum[:, 2] <= rsum[:, 2]
                else:
                    lsum = vecs[:, [F_LEFT_G, F_LEFT_H, F_LEFT_C]]
                    rsum = vecs[:, [F_RIGHT_G, F_RIGHT_H, F_RIGHT_C]]
                    small_left = vecs[:, F_LEFT_C] <= vecs[:, F_RIGHT_C]
                total[safe_l] = torch.where(sel2, lsum, total[safe_l])
                total[safe_r] = torch.where(sel2, rsum, total[safe_r])
                value[safe_l] = torch.where(sel, vecs[:, F_LEFT_OUT],
                                            value[safe_l])
                value[safe_r] = torch.where(sel, vecs[:, F_RIGHT_OUT],
                                            value[safe_r])
                child_d = depth[lsel] + 1
                depth[safe_l] = torch.where(sel, child_d, depth[safe_l])
                depth[safe_r] = torch.where(sel, child_d, depth[safe_r])
                best[safe_l] = torch.where(sel2, neg_row, best[safe_l])
                best[safe_r] = torch.where(sel2, neg_row, best[safe_r])
                ridx = torch.where(sel, nl - 1 + rank, L - 1)
                new_ri = torch.stack([lsel, r_ids, f, thr, dl.long()],
                                     dim=1).to(torch.int32)
                new_rf = vecs[:, [F_GAIN, F_LEFT_G, F_LEFT_H, F_LEFT_C,
                                  F_RIGHT_G, F_RIGHT_H, F_RIGHT_C,
                                  F_LEFT_OUT, F_RIGHT_OUT]]
                rec_i[ridx] = torch.where(sel2, new_ri, rec_i[ridx])
                rec_f[ridx] = torch.where(sel2, new_rf, rec_f[ridx])
                # pending for the next wave: the smaller child gets the
                # fresh histogram
                lsel32, r32 = lsel.to(torch.int32), r_ids.to(torch.int32)
                p_parent = torch.where(sel, lsel32, -1)
                p_small = torch.where(
                    sel, torch.where(small_left, lsel32, r32), -1)
                p_large = torch.where(
                    sel, torch.where(small_left, r32, lsel32), -1)
                nl += napply

        leaf_vals = value[:L]
        if quant:
            leaf_vals = self._refit_into_records(
                self._refit(grad, hess, one_f, leaf_id, qscales), rec_i,
                rec_f, nl)

        # score update.  Trouble spot (lightgbm_tpu/ops/grow.py:1109-1116):
        # the JAX package adds float32(bf16(v)) + float32(bf16(v - hi)) per
        # row through a one-hot einsum with one nonzero per row, which is
        # exactly this gather; a direct score += lr * value[leaf_id] is
        # more accurate but diverges from the JAX package from tree 2 on.
        # A stump (root never split) applies nothing.
        lr32 = float(np.float32(lr))
        scaled = leaf_vals * lr32 * (1.0 if nl > 1 else 0.0)
        vhi = scaled.to(torch.bfloat16)
        vlo = (scaled - vhi.float()).to(torch.bfloat16)
        lid = leaf_id[:self.num_data].long()
        new_score = score + (vhi.float()[lid] + vlo.float()[lid])
        keep = max(L - 1, 1)
        return GrowResult(new_score, rec_i[:keep], rec_f[:keep], nl,
                          value[0], waves, syncs)

    def _refit_into_records(self, refit, rec_i, rec_f, nl):
        """Write each existing leaf's refit value into the record that
        created it (the last record naming the leaf: a left child keeps
        its parent's id, a right id is fresh), in place; returns the (L,)
        leaf values (0 past the last leaf)."""
        L = self.num_leaves
        dev = self.device
        exists = torch.arange(L, device=dev) < nl
        recs = torch.arange(L, dtype=torch.int64, device=dev)
        lid, rid = rec_i[:, 0].long(), rec_i[:, 1].long()
        base = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
        last_l = base.scatter_reduce(0, torch.where(lid >= 0, lid, L), recs,
                                     reduce="amax")
        last_r = base.scatter_reduce(0, torch.where(rid >= 0, rid, L), recs,
                                     reduce="amax")
        crec = torch.maximum(last_l[:L], last_r[:L])
        is_left = last_l[:L] >= last_r[:L]
        do = exists & (crec >= 0)
        leaf_vals = torch.where(exists, refit, torch.zeros_like(refit))
        rows = torch.where(do, crec, L - 1)          # junk record row
        cols = torch.where(is_left, REC_F_LEFT_OUT, REC_F_RIGHT_OUT)
        rec_f[rows, cols] = torch.where(do, leaf_vals, rec_f[rows, cols])
        return leaf_vals
