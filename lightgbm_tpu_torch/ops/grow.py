"""Leaf-wise tree growth on the device, in synchronized waves.

Counterpart of ``lightgbm_tpu/ops/grow.py`` (``GrowerPrograms._grow_impl``
and ``DeviceGrower``), unsharded, with bf16 stat columns or, under
``grad_quant_bits=8``, int8 quantized ones, with the per-tree bagging row
mask and feature_fraction mask, and with categorical splits.  The
formulation is the JAX package's:

* a per-row ``leaf_id`` vector stands in for a row permutation; a split
  rewrites it with one elementwise pass over the ``(G, N)`` binned matrix;
* each *wave* builds, in one pass over all rows, the histograms of up to W
  pending leaves (the smaller child of each new split) with the
  hand-written kernel (``ops/hist_cuda.wave_hist``); the larger sibling is
  the parent minus the smaller one;
* every new leaf's best split comes from one batched scan
  (``ops/split.find_best_split``), and the wave applies up to W of
  the best-gain splits at once, within the ``num_leaves`` budget;
* wave widths follow the legacy stage plan (``ops/stage_plan.py``);
* a categorical split sends a row left iff the bit of its decoded bin is
  set in the winner's bin set, kept per leaf as a (256,) membership row
  (``bestc``) and recorded as eight int32 words (``rec_c``).  Every
  categorical step is gated on ``has_cat`` (a dataset with a categorical
  feature), so other models run exactly the ops they ran before.

Under ``grad_quant_bits=8`` the histograms, leaf totals and the split
scan stay int32 in quantized units (``ops/split.find_best_split`` with
``scales``), so the parent-minus-sibling subtraction and every count are
exact; after
growth each leaf's value is refit from the full-precision gradients with
an exact base-128 digit sum and written back into the split record that
created the leaf.

The JAX package runs the wave loop inside ``lax.while_loop``s, one per
stage, with no host sync.  Here a tree is cut into pieces that work in
place on tensors allocated once per grower (``_ensure_state``): a sample
piece (fused trees: gradients, the bagging redraw, the feature mask), a
start piece (stat columns, a fresh root), one wave piece per stage width
and a finish piece (refit, score update, the records into a chunk slot).
The leaf count, the done flag, the wave count and the chunk slot live in
device control words (``ctl``), so no piece reads anything back.  On the
card the pieces are captured once as CUDA graphs and composed into one
graph a tree, each stage's wave the body of a WHILE node that loops while
``not done and nl < limit`` (``ops/graphs.py``, ``csrc/graph_loop.cu``);
on the CPU the same pieces run in a Python loop that reads the control
words.  A wave that selects nothing is an exact no-op on the tree.

Every per-leaf tensor has one junk row (index L; records: index L-1) that
absorbs the scatters of empty lanes, so a scatter never writes a live leaf
twice.  CUDA ``index_put_`` writes duplicate indices in no fixed order;
only the junk row ever receives duplicates, and nothing reads it as a
result.
"""

from __future__ import annotations

import functools
import time
import types
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import random as trandom
from ..utils.log import LightGBMError
from .bagging import bag_mask
from .hist_cuda import MAX_LEAF_BOUND, hist_scale_exponents, wave_hist
from .histogram import QUANT_MAX, bucket_size, quantize_gh_keys
from .split import (F_DEFAULT_LEFT, F_FEATURE, F_GAIN, F_LEFT_C, F_LEFT_G,
                    F_LEFT_H, F_LEFT_OUT, F_RIGHT_C, F_RIGHT_G, F_RIGHT_H,
                    F_IS_CAT, F_RIGHT_OUT, F_THRESHOLD, NEG_INF,
                    FeatureMeta, SplitHyper, find_best_split)
from .stage_plan import legacy_stage_plan

REC_I_FIELDS = 5    # leaf, right, feature, threshold, default_left
REC_F_FIELDS = 9    # gain, lg, lh, lc, rg, rh, rc, left_out, right_out
REC_F_LEFT_OUT, REC_F_RIGHT_OUT = 7, 8
REC_C_WORDS = 8     # a categorical split's 256-bin set as int32 words
# at or above this many rows the JAX package stripes its stat columns
# (two count columns; under quantization two g and h columns too) to keep
# every accumulator exact; the port has no striped layout yet.  Its
# quantized f32 fallback scan starts higher still, past (2^31 - 1) // 127
# rows (where int32 sums of |q| <= 127 could overflow), so refusing the
# striped layouts refuses that too.
COUNT_SPLIT_ROWS = 1 << 24
HIST_COLS = 3       # [g, h, 1] stat columns, bf16 or int8
#: key words of a tree in the key table: feature_fraction (2), int8 noise
#: g and h (2 + 2), bagging (2)
KEY_WORDS = 8


class GrowResult(NamedTuple):
    score: torch.Tensor       # (num_data,) f32 score after this tree
    rec_i: torch.Tensor       # (L-1, 5) int32 split records
    rec_f: torch.Tensor       # (L-1, 9) f32 split records
    rec_c: torch.Tensor       # (L-1, 8) int32 categorical bin sets
    num_leaves: torch.Tensor  # () int32, on the device
    root_value: torch.Tensor  # () f32 root leaf output
    waves: torch.Tensor       # () int32 waves run, on the device


class FusedResult(NamedTuple):
    """Device views of a fused chunk's outputs, K trees."""
    score: torch.Tensor       # (num_data,) f32 score after the chunk
    rec_i: torch.Tensor       # (K, L-1, 5) int32
    rec_f: torch.Tensor       # (K, L-1, 9) f32
    rec_c: torch.Tensor       # (K, L-1, 8) int32
    nl: torch.Tensor          # (K,) int32 leaves
    waves: torch.Tensor       # (K,) int32 waves
    qscales: torch.Tensor     # (K, 2) f32 int8 scales (ones without)


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
    return feature_mask_from_key(key, nf, k, device)


def feature_mask_from_key(key, nf: int, k: int,
                          device=None) -> torch.Tensor:
    """:func:`feature_fraction_mask` under ``key`` (a host pair or a
    ``(2,)`` int64 tensor, as a captured graph reads it)."""
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
        self.has_cat = bool(np.asarray(dataset.f_is_categorical).any())
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
        self._ff_active = self._ff_frac < 1.0 and nf > 1
        # bagging (GBDT.bagging's rounds; redrawn inside fused chunks)
        self._bag_fraction = float(config.bagging_fraction)
        self._bag_freq = int(config.bagging_freq)
        self._bag_on = self._bag_fraction < 1.0 and self._bag_freq > 0
        self._bag_seed = int(config.bagging_seed)
        self._bag_npad = bucket_size(max(self.num_data, 1))
        # constants of the pieces (made here, never inside a capture)
        self._valid_f = self._valid.float()
        self._leaf0 = torch.where(self._valid, 0, -1).to(torch.int32)
        self._ctl0 = torch.tensor([1, 0, 0], dtype=torch.int32,
                                  device=device)
        self._neg_row = torch.full((13,), NEG_INF, dtype=torch.float32,
                                   device=device)
        self._bit_pos = torch.arange(32, dtype=torch.int32, device=device)
        # packed-record columns the wave gathers (index tensors on the
        # device: a list index would copy from the host inside a capture)
        self._cols = {k: torch.tensor(v, dtype=torch.int64, device=device)
                      for k, v in (
                          ("left", [F_LEFT_G, F_LEFT_H, F_LEFT_C]),
                          ("right", [F_RIGHT_G, F_RIGHT_H, F_RIGHT_C]),
                          ("record", [F_GAIN, F_LEFT_G, F_LEFT_H, F_LEFT_C,
                                      F_RIGHT_G, F_RIGHT_H, F_RIGHT_C,
                                      F_LEFT_OUT, F_RIGHT_OUT]))}
        self._stages = [(ws, self.num_leaves if cap is None
                         else min(cap, self.num_leaves))
                        for ws, cap in self.stage_plan]
        self._st = None
        self._graphs = None
        self._composed = {}
        self._grad = None
        #: host seconds of the eager warm-up before the captures, of the
        #: captures and of instantiating the composed graphs, the composed
        #: graphs built and the waves the warm-up ran (chip_smoke.py)
        self.capture_stats = dict(warmup_s=0.0, capture_s=0.0,
                                  instantiate_s=0.0, graphs=0,
                                  warmup_waves=0)
        self._ensure_state(max(int(getattr(config, "fused_chunk", 1)), 1))

    # ------------------------------------------------------------------
    def feature_mask_for(self, tree_idx: int) -> torch.Tensor:
        """The feature_fraction mask of global tree ``tree_idx``
        (``iter * num_model + class``); all features when the fraction
        is 1."""
        if not self._ff_active:
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
    # the tree's state on the device, and the pieces of a tree
    def _ensure_state(self, capacity: int) -> None:
        """Allocate every tensor a tree's pieces read or write, once, with
        chunk outputs for ``capacity`` trees; a larger capacity
        reallocates them and drops the captured graphs (they hold the old
        buffers' addresses)."""
        st = self._st
        if st is not None and st.capacity >= capacity:
            return
        self._drop_graphs()
        capacity = max(int(capacity), 1 if st is None else st.capacity)
        dev = self.device
        L, S, n, N = self.num_leaves, self.num_slots, self.n_pad, \
            self.num_data
        quant = bool(self.quant_bits)
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        hdtype = torch.int32 if quant else torch.float32
        keep = max(L - 1, 1)
        W = self.wave_width
        self._st = types.SimpleNamespace(
            capacity=capacity,
            # inputs, written by the host before a launch (or, fused, by
            # the sample piece from the key table)
            score=torch.zeros(N, **f32), grad=torch.zeros(N, **f32),
            hess=torch.zeros(N, **f32), row_mask=torch.ones(N, **f32),
            fmask=torch.ones(self._ff_nf, dtype=torch.bool, device=dev),
            lr=torch.zeros((), **f32),
            keys=torch.zeros((capacity, KEY_WORDS), dtype=torch.int64,
                             device=dev),
            # [leaf count, done, waves, tree slot t of the chunk]
            ctl=torch.zeros(4, **i32),
            # one tree's working state
            grad_p=torch.zeros(n, **f32), hess_p=torch.zeros(n, **f32),
            one_f=torch.zeros(n, **f32),
            gh=torch.zeros((n, HIST_COLS), dtype=torch.int8 if quant
                           else torch.bfloat16, device=dev),
            qscales=torch.ones(2, **f32), scale_exp=torch.zeros(3, **i32),
            leaf_id=torch.zeros(n, **i32),
            hist=torch.zeros((L + 1, S, 3), dtype=hdtype, device=dev),
            total=torch.zeros((L + 1, 3), dtype=hdtype, device=dev),
            # the winner's exact int32 left totals (quantized scan only)
            bestl=torch.zeros((L + 1, 3), **i32) if quant else None,
            # the winner's bin set of each leaf (categorical scan only)
            bestc=torch.zeros((L + 1, 256), dtype=torch.bool, device=dev)
            if self.has_cat else None,
            value=torch.zeros(L + 1, **f32), depth=torch.zeros(L + 1, **i32),
            best=torch.zeros((L + 1, 13), **f32),
            rec_i=torch.zeros((L, REC_I_FIELDS), **i32),
            rec_f=torch.zeros((L, REC_F_FIELDS), **f32),
            rec_c=torch.zeros((L, REC_C_WORDS), **i32),
            lane_of=torch.zeros(L + 1, dtype=torch.int64, device=dev),
            p_parent=torch.zeros(W, **i32), p_small=torch.zeros(W, **i32),
            p_large=torch.zeros(W, **i32),
            # chunk outputs, slot t per tree
            out_rec_i=torch.zeros((capacity, keep, REC_I_FIELDS), **i32),
            out_rec_f=torch.zeros((capacity, keep, REC_F_FIELDS), **f32),
            out_rec_c=torch.zeros((capacity, keep, REC_C_WORDS), **i32),
            out_nl=torch.zeros(capacity, **i32),
            out_waves=torch.zeros(capacity, **i32),
            out_root=torch.zeros(capacity, **f32),
            out_qscales=torch.ones((capacity, 2), **f32))

    def _tree_keys(self, tree_idx: int, it: int) -> list:
        """The :data:`KEY_WORDS` key words of a tree, derived on the host
        as the JAX package derives them: the feature_fraction key
        ``fold_in(PRNGKey(ff_seed), tree_idx)``, the int8 noise keys
        ``split(fold_in(PRNGKey(quant_seed), tree_idx))`` and the bagging
        key ``PRNGKey((bagging_seed + it) & 0x7FFFFFFF)`` (zeros where
        unused)."""
        row = [0] * KEY_WORDS
        if self._ff_active:
            row[0:2] = trandom.fold_in(trandom.PRNGKey(self._ff_seed),
                                       tree_idx)
        if self.quant_bits:
            kg, kh = trandom.split(trandom.fold_in(
                trandom.PRNGKey(self._quant_seed), tree_idx))
            row[2:6] = (*kg, *kh)
        if self._bag_on:
            row[6:8] = trandom.PRNGKey((self._bag_seed + it) & 0x7FFFFFFF)
        return row

    def _write_keys(self, rows) -> None:
        """One host-to-device copy of the chunk's key table."""
        host = torch.tensor(rows, dtype=torch.int64)
        if self.device.type == "cuda":
            host = host.pin_memory()
        self._st.keys[:len(rows)].copy_(host, non_blocking=True)

    def _tree_key(self):
        """(KEY_WORDS,) int64 key words of the chunk's current tree slot
        (read on the device: an index tensor, never a host int)."""
        st = self._st
        return st.keys.index_select(0, st.ctl[3:4].long())[0]

    def _piece_sample(self, redraw: bool) -> None:
        """Fused trees only: gradients from the current score, the
        bagging redraw (``redraw``: the host knows which trees start a
        round) and the feature_fraction mask, into the input buffers."""
        st = self._st
        key = self._tree_key()
        grad_fn, gargs = self._grad
        g, h = grad_fn(st.score, gargs)
        st.grad.copy_(g)
        st.hess.copy_(h)
        if redraw:
            st.row_mask.copy_(bag_mask(key[6:8], self._bag_npad,
                                       self.num_data, self._bag_fraction))
        if self._ff_active:
            st.fmask.copy_(feature_mask_from_key(key[0:2], self._ff_nf,
                                                 self._ff_k))

    def _piece_start(self) -> None:
        """Stat columns (and under int8 the quantization draws) from the
        input buffers, and a fresh tree state: one root leaf."""
        st = self._st
        pad = self.n_pad - self.num_data
        valid_f = self._valid_f
        st.grad_p.copy_(F.pad(st.grad, (0, pad)) * valid_f)
        st.hess_p.copy_(F.pad(st.hess, (0, pad)) * valid_f)
        st.one_f.copy_(valid_f * F.pad(st.row_mask, (0, pad)))
        if self.quant_bits:
            key = self._tree_key()
            sg, sh, gq, hq = quantize_gh_keys(st.grad_p, st.hess_p,
                                              key[2:4], key[4:6])
            m8 = st.one_f.to(torch.int8)
            st.gh.copy_(torch.stack([gq * m8, hq * m8, m8], 1))
            st.qscales.copy_(torch.stack([sg, sh]))
        else:
            # bf16 (lightgbm_tpu/ops/grow.py:597): g and h are rounded to
            # bf16 BEFORE the histogram, on purpose; .to(torch.bfloat16)
            # rounds to nearest even like XLA's convert, so both packages
            # see the same column values.  grad_p/hess_p are zero past the
            # real rows but NOT bag-masked: the int8 scale above is taken
            # over every real row, out-of-bag ones included, as the JAX
            # package takes it
            one = st.one_f.to(torch.bfloat16)
            st.gh.copy_(torch.stack([st.grad_p.to(torch.bfloat16) * one,
                                     st.hess_p.to(torch.bfloat16) * one,
                                     one], 1))
            st.scale_exp.copy_(hist_scale_exponents(st.gh, self.n_pad))
        st.leaf_id.copy_(self._leaf0)
        st.hist.zero_()
        st.total.zero_()
        if st.bestl is not None:
            st.bestl.zero_()
        if st.bestc is not None:
            st.bestc.zero_()
            st.rec_c.zero_()
        st.value.zero_()
        st.depth.zero_()
        st.best.fill_(NEG_INF)
        st.rec_i.fill_(-1)
        st.rec_f.zero_()
        for p in (st.p_parent, st.p_small, st.p_large):
            p.fill_(-1)
        st.p_small[:1].fill_(0)
        st.ctl[:3].copy_(self._ctl0)

    def _piece_wave(self, ws: int) -> None:
        """One wave of width ``ws`` on the tree state (the JAX ``make_wave``
        body).  Reads nothing back: the leaf count, the done flag and the
        wave count stay on the device (``ctl``).  A wave that selects no
        split is an exact no-op on the tree: every scatter lands on the
        junk rows, the pending lists become empty, and ``done`` is set."""
        st = self._st
        dev = self.device
        L, nb = self.num_leaves, self.nb
        quant = bool(self.quant_bits)
        hist, total, value, depth, best = (st.hist, st.total, st.value,
                                           st.depth, st.best)
        nl = st.ctl[0]
        p_parent, p_small, p_large = (st.p_parent[:ws], st.p_small[:ws],
                                      st.p_large[:ws])
        # 1. fresh histograms of the pending smaller children
        fresh = self._wave_hist(st.leaf_id, st.gh, p_small,
                                None if quant else st.scale_exp)
        # root (first wave only): totals from group 0's slots (every row
        # hits one)
        first = st.ctl[2] == 0
        total[0] = torch.where(first, fresh[0, :nb, :].sum(0), total[0])
        rt = total[0].float()
        if quant:
            rt = rt[:2] * st.qscales
        value[0] = torch.where(first, self._leaf_output(rt[0], rt[1]),
                               value[0])
        # 2. larger sibling = parent - smaller (read the parents before
        # the fresh histograms overwrite their slots)
        par = torch.where(p_parent >= 0, p_parent, L).long()
        large = hist[par] - fresh
        sm_ok, lg_ok = p_small >= 0, p_large >= 0
        sm_idx = torch.where(sm_ok, p_small, L).long()
        lg_idx = torch.where(lg_ok, p_large, L).long()
        hist[sm_idx] = torch.where(sm_ok[:, None, None], fresh,
                                   hist[sm_idx])
        hist[lg_idx] = torch.where(lg_ok[:, None, None], large,
                                   hist[lg_idx])

        # 3. find-best for both siblings of every new split, one batched
        # scan over the (2*Ws, S, 3) stack
        ids = torch.cat([torch.where(sm_ok, p_small, -1),
                         torch.where(lg_ok, p_large, -1)]).long()
        idc = ids.clamp(0, L - 1)
        stack = torch.cat([fresh, large])
        packed, catm, lint = find_best_split(
            stack, total[idc], st.fmask, self.meta, self.hyper,
            has_cat=self.has_cat, scales=st.qscales if quant else None)
        ok = self._splittable(total[idc], depth[idc],
                              hess_scale=st.qscales[1] if quant else None)
        ok = ok & (ids >= 0)
        packed[:, F_GAIN] = torch.where(
            ok, packed[:, F_GAIN],
            torch.full_like(packed[:, F_GAIN], NEG_INF))
        safe = torch.where(ids >= 0, ids, L)
        best[safe] = torch.where((ids >= 0)[:, None], packed, best[safe])
        if quant:
            st.bestl[safe] = torch.where((ids >= 0)[:, None], lint,
                                         st.bestl[safe])
        if self.has_cat:
            st.bestc[safe] = torch.where((ids >= 0)[:, None], catm,
                                         st.bestc[safe])

        # 4. select up to Ws best-gain splits within the budget.  Trouble
        # spot (lightgbm_tpu/ops/grow.py:846): lax.top_k breaks ties
        # toward the lower index; torch.topk promises no order on ties, a
        # stable descending sort does.
        top_vals, top_idx = torch.sort(best[:L, F_GAIN], descending=True,
                                       stable=True)
        top_vals, lsel = top_vals[:ws], top_idx[:ws]
        lanes = torch.arange(ws, device=dev)
        sel = (top_vals > 0.0) & (lanes < L - nl)
        napply = sel.sum()
        rank = torch.cumsum(sel.long(), 0) - 1
        vecs = best[lsel]                             # (Ws, 13)
        r_ids = nl + rank
        f = vecs[:, F_FEATURE].long()
        thr = vecs[:, F_THRESHOLD].long()
        dl = vecs[:, F_DEFAULT_LEFT] > 0.5

        # 5. apply the selected splits to leaf_id: each row looks up its
        # leaf's lane (a row belongs to at most one selected leaf), reads
        # that split's feature group and decides left or right as
        # lightgbm_tpu/ops/grow.py:869-916 does
        lane_of = st.lane_of
        lane_of.fill_(-1)
        lane_of[torch.where(sel, lsel, L)] = lanes
        lane_of[L:].fill_(-1)
        leaf_id = st.leaf_id
        row_lane = lane_of[torch.where(leaf_id >= 0, leaf_id, L).long()]
        lane = row_lane.clamp(min=0)
        fl = f[lane]
        cols = self.binned_t.gather(0, self.f_group[fl][None, :])[0].long()
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
                                torch.where(is_na, dl_r, bin_ <= thr_r))
        if self.has_cat:
            # categorical routing (lightgbm_tpu/ops/grow.py:892-911): left
            # iff the decoded bin's bit is set in the lane's 8-word set;
            # the word is gathered where the JAX package selects it
            bits = st.bestc[lsel].view(ws, REC_C_WORDS, 32).to(torch.int32)
            words = (bits << self._bit_pos).sum(dim=2, dtype=torch.int32)
            word = words.view(-1)[lane * REC_C_WORDS + (bin_ >> 5)]
            left_cat = ((word >> (bin_ & 31)) & 1) == 1
            is_cat = vecs[:, F_IS_CAT] > 0.5
            goes_left = torch.where(is_cat[lane], left_cat, goes_left)
        move = (row_lane >= 0) & ~goes_left
        leaf_id.copy_(torch.where(move, r_ids[lane].to(torch.int32),
                                  leaf_id))

        # 6. bookkeeping: scatter into the L-padded state
        safe_l = torch.where(sel, lsel, L)
        safe_r = torch.where(sel, r_ids, L)
        sel2 = sel[:, None]
        if quant:
            # exact integer child totals: the winner's left sums from the
            # scan, the right child by subtraction (read the parent before
            # the scatter overwrites its slot)
            lsum = st.bestl[lsel]
            rsum = total[lsel] - lsum
            small_left = lsum[:, 2] <= rsum[:, 2]
        else:
            lsum = vecs.index_select(1, self._cols["left"])
            rsum = vecs.index_select(1, self._cols["right"])
            small_left = vecs[:, F_LEFT_C] <= vecs[:, F_RIGHT_C]
        total[safe_l] = torch.where(sel2, lsum, total[safe_l])
        total[safe_r] = torch.where(sel2, rsum, total[safe_r])
        value[safe_l] = torch.where(sel, vecs[:, F_LEFT_OUT], value[safe_l])
        value[safe_r] = torch.where(sel, vecs[:, F_RIGHT_OUT],
                                    value[safe_r])
        child_d = depth[lsel] + 1
        depth[safe_l] = torch.where(sel, child_d, depth[safe_l])
        depth[safe_r] = torch.where(sel, child_d, depth[safe_r])
        best[safe_l] = torch.where(sel2, self._neg_row, best[safe_l])
        best[safe_r] = torch.where(sel2, self._neg_row, best[safe_r])
        ridx = torch.where(sel, nl - 1 + rank, L - 1)
        new_ri = torch.stack([lsel, r_ids, f, thr, dl.long()],
                             dim=1).to(torch.int32)
        new_rf = vecs.index_select(1, self._cols["record"])
        st.rec_i[ridx] = torch.where(sel2, new_ri, st.rec_i[ridx])
        st.rec_f[ridx] = torch.where(sel2, new_rf, st.rec_f[ridx])
        if self.has_cat:
            st.rec_c[ridx] = torch.where(sel2, words, st.rec_c[ridx])
        # pending for the next wave: the smaller child gets the fresh
        # histogram
        lsel32, r32 = lsel.to(torch.int32), r_ids.to(torch.int32)
        p_parent.copy_(torch.where(sel, lsel32, -1))
        p_small.copy_(torch.where(sel, torch.where(small_left, lsel32, r32),
                                  -1))
        p_large.copy_(torch.where(sel, torch.where(small_left, r32, lsel32),
                                  -1))
        # control words last: every use of the leaf count above is queued
        st.ctl[2:3].add_(1)
        st.ctl[1:2].copy_((napply == 0).to(torch.int32).view(1))
        st.ctl[0:1].add_(napply.to(torch.int32).view(1))

    def _piece_finish(self) -> None:
        """The int8 refit, the score update, and the tree's records into
        chunk slot t (then t + 1)."""
        st = self._st
        L = self.num_leaves
        nl = st.ctl[0]
        leaf_vals = st.value[:L]
        if self.quant_bits:
            leaf_vals = self._refit_into_records(
                self._refit(st.grad_p, st.hess_p, st.one_f, st.leaf_id,
                            st.qscales), st.rec_i, st.rec_f, nl, st.value)
        # score update.  Trouble spot (lightgbm_tpu/ops/grow.py:1109-1116):
        # the JAX package adds float32(bf16(v)) + float32(bf16(v - hi)) per
        # row through a one-hot einsum with one nonzero per row, which is
        # exactly this gather; a direct score += lr * value[leaf_id] is
        # more accurate but diverges from the JAX package from tree 2 on.
        # A stump (root never split) applies nothing.
        scaled = leaf_vals * st.lr * (nl > 1).to(torch.float32)
        vhi = scaled.to(torch.bfloat16)
        vlo = (scaled - vhi.float()).to(torch.bfloat16)
        lid = st.leaf_id[:self.num_data].long()
        st.score.add_(vhi.float()[lid] + vlo.float()[lid])
        t = st.ctl[3:4].long()
        keep = max(L - 1, 1)
        st.out_rec_i.index_copy_(0, t, st.rec_i[None, :keep])
        st.out_rec_f.index_copy_(0, t, st.rec_f[None, :keep])
        st.out_rec_c.index_copy_(0, t, st.rec_c[None, :keep])
        st.out_nl.index_copy_(0, t, st.ctl[0:1])
        st.out_waves.index_copy_(0, t, st.ctl[2:3])
        st.out_root.index_copy_(0, t, st.value[0:1])
        st.out_qscales.index_copy_(0, t, st.qscales[None])
        st.ctl[3:4].add_(1)

    # ------------------------------------------------------------------
    # running a tree: the Python loop on the CPU, one launch on the card
    def _run_tree(self, sample) -> None:
        """Grow one tree into chunk slot t.  ``sample`` None: the host
        wrote the gradients and masks; False / True: a fused tree, without
        or with the bagging redraw.  On the CPU the pieces run in a Python
        loop that reads the control words (the plain version); on the card
        the composed graph runs, or the call raises."""
        if self.device.type == "cuda":
            self._graph(sample).launch()
            return
        self._run_pieces(sample)

    def _run_pieces(self, sample) -> None:
        """The plain version of a tree: the pieces in a Python loop that
        reads the control words (a host read a wave).  The CPU path; the
        card tests and chip_smoke.py run it on CUDA tensors to hold the
        captured tree against it."""
        if sample is not None:
            self._piece_sample(sample)
        self._piece_start()
        ctl = self._st.ctl
        for ws, limit in self._stages:
            while int(ctl[1]) == 0 and int(ctl[0]) < limit:
                self._piece_wave(ws)
        self._piece_finish()

    def _graph(self, sample):
        """The composed graph of a tree variant, warmed up, captured and
        instantiated at first use (``ops/graphs.py``): the pieces once per
        grower, the sample piece once per bagging variant.  The graphs
        read and write only the buffers of ``_ensure_state``; call before
        writing a launch's inputs (the warm-up runs every piece once)."""
        g = self._composed.get(sample)
        if g is not None:
            return g
        from . import graphs
        stats = self.capture_stats
        t0 = time.perf_counter()
        if self._graphs is None:
            # the launch counter and every lazy initialization must exist
            # before the captures: run each piece once, eagerly
            wave_hist.launches.counter(self.device)
            self._st.ctl[3:4].zero_()
            self._piece_start()
            for ws, _ in self._stages:
                self._piece_wave(ws)
            self._piece_finish()
            torch.cuda.synchronize(self.device)
            stats["warmup_waves"] += len(self._stages)
            t1 = time.perf_counter()
            stats["warmup_s"] += t1 - t0
            gs = graphs.GraphSet(self.device)
            self._graphs = dict(
                set=gs, start=gs.capture(self._piece_start),
                waves=[gs.capture(functools.partial(self._piece_wave, ws))
                       for ws, _ in self._stages],
                finish=gs.capture(self._piece_finish))
            t0 = time.perf_counter()
            stats["capture_s"] += t0 - t1
        pieces = self._graphs
        steps = []
        if sample is not None:
            key = ("sample", bool(sample))
            if key not in pieces:
                self._piece_sample(bool(sample))
                torch.cuda.synchronize(self.device)
                pieces[key] = pieces["set"].capture(
                    functools.partial(self._piece_sample, bool(sample)))
            steps.append((pieces[key], None))
            t1 = time.perf_counter()
            stats["capture_s"] += t1 - t0
            t0 = t1
        steps.append((pieces["start"], None))
        steps.extend((wg, limit) for wg, (_, limit)
                     in zip(pieces["waves"], self._stages))
        steps.append((pieces["finish"], None))
        g = self._composed[sample] = graphs.compose(steps, self._st.ctl)
        stats["instantiate_s"] += time.perf_counter() - t0
        stats["graphs"] += 1
        return g

    def _drop_graphs(self) -> None:
        for g in self._composed.values():
            g.close()
        self._composed = {}
        self._graphs = None

    # ------------------------------------------------------------------
    def grow_one_iter(self, score, grad, hess, lr=None, feature_mask=None,
                      row_mask=None, tree_idx: int = 0) -> GrowResult:
        """Grow one tree from (num_data,) f32 gradients and return the
        updated score and the split records (device tensors).
        ``row_mask`` is the (num_data,) f32 0/1 in-bag indicator of
        bagging: out-of-bag rows drop out of the histograms and counts but
        are still routed to leaves, so the score update reaches them.
        ``tree_idx`` is the global tree index keying the quantization
        noise.  On the card this is one launch of the captured tree; no
        value is read back."""
        self._ensure_state(1)
        if self.device.type == "cuda":
            self._graph(None)
        st = self._st
        st.score.copy_(score)
        st.grad.copy_(grad)
        st.hess.copy_(hess)
        st.lr.fill_(float(np.float32(self.lr if lr is None else lr)))
        if feature_mask is None:
            st.fmask.fill_(True)
        else:
            st.fmask.copy_(feature_mask)
        if row_mask is None:
            st.row_mask.fill_(1.0)
        else:
            st.row_mask.copy_(row_mask)
        self._write_keys([self._tree_keys(tree_idx, 0)])
        st.ctl[3:4].zero_()
        self._run_tree(None)
        return GrowResult(st.score.clone(), st.out_rec_i[0].clone(),
                          st.out_rec_f[0].clone(), st.out_rec_c[0].clone(),
                          st.out_nl[0].clone(),
                          st.out_root[0].clone(), st.out_waves[0].clone())

    def fused_train(self, length: int, score, lr: float, it0: int,
                    grad_fn) -> FusedResult:
        """``length`` whole boosting iterations from iteration ``it0``
        (counterpart of ``lightgbm_tpu/ops/grow.py::fused_train``): per
        tree, gradients from the current score (``grad_fn``: the
        objective's ``device_grad`` pair), the bagging redraw on trees
        where ``it % bagging_freq == 0`` (the mask active at ``it0`` is
        drawn first when ``it0`` is not a boundary), the feature_fraction
        mask, growth and the score update.  On the card: one key-table
        copy, then ``length`` launches of the captured tree, no host read
        in between.  Returns device views (valid until the next call)."""
        self._ensure_state(length)
        if self._grad is None:
            self._grad = grad_fn
        elif any(a is not b for a, b in zip(self._grad, grad_fn)):
            raise ValueError("fused_train: the gradient pair is captured "
                             "once per grower and cannot change")
        redraw = [self._bag_on and (it0 + j) % self._bag_freq == 0
                  for j in range(length)]
        if self.device.type == "cuda":
            for r in sorted(set(redraw)):
                self._graph(r)
        st = self._st
        st.score.copy_(score)
        st.lr.fill_(float(np.float32(lr)))
        self._write_keys([self._tree_keys(it0 + j, it0 + j)
                          for j in range(length)])
        st.ctl[3:4].zero_()
        if not self._ff_active:
            st.fmask.fill_(True)
        if not self._bag_on:
            st.row_mask.fill_(1.0)
        elif it0 % self._bag_freq:
            st.row_mask.copy_(self.bag_mask_at(it0 - it0 % self._bag_freq))
        for r in redraw:
            self._run_tree(r)
        return FusedResult(st.score, st.out_rec_i[:length],
                           st.out_rec_f[:length], st.out_rec_c[:length],
                           st.out_nl[:length],
                           st.out_waves[:length], st.out_qscales[:length])

    def bag_mask_at(self, it: int) -> torch.Tensor:
        """(num_data,) f32 in-bag mask of the bagging round drawn at
        iteration ``it`` (``GBDT.bagging``'s draw)."""
        return bag_mask(trandom.PRNGKey((self._bag_seed + it) & 0x7FFFFFFF),
                        self._bag_npad, self.num_data, self._bag_fraction,
                        self.device)

    def _refit_into_records(self, refit, rec_i, rec_f, nl, value):
        """Write each existing leaf's refit value into the record that
        created it (the last record naming the leaf: a left child keeps
        its parent's id, a right id is fresh), in place; returns the (L,)
        leaf values (0 past the last leaf).  A leaf that a categorical
        split created keeps its growth value (``value``): a sorted-mode
        split's outputs take ``lambda_l2 + cat_l2``, which the refit
        formula would drop (lightgbm_tpu/ops/grow.py:1087-1095)."""
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
        if self.has_cat:
            cfeat = rec_i[torch.where(do, crec, 0), 2].long()
            from_cat = do & (self.meta.is_cat[cfeat.clamp(min=0)] == 1)
            refit = torch.where(from_cat, value[:L], refit)
        leaf_vals = torch.where(exists, refit, torch.zeros_like(refit))
        rows = torch.where(do, crec, L - 1)          # junk record row
        cols = torch.where(is_left, REC_F_LEFT_OUT, REC_F_RIGHT_OUT)
        rec_f[rows, cols] = torch.where(do, leaf_vals, rec_f[rows, cols])
        return leaf_vals
