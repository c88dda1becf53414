"""Best-split scan over all features of a stack of leaves, as torch ops.

Counterpart of ``lightgbm_tpu/ops/split.py``.  Every
(feature, direction, threshold) candidate is evaluated at once with prefix
sums over the 256-bin axis, and argmaxes pick the winners:

* default-bin reconstruction from leaf totals (``FixHistogram``,
  ``src/io/dataset.cpp:802-822``): the grouped storage never records the
  default bin, so ``hist[default] = leaf_total - sum(others)``;
* missing handling: the two scan directions are two candidate variants,
  missing stats placed left (``default_left=True``) or right, with the
  reference's skipped-threshold rules for MissingType::Zero and NaN;
* L1/L2-regularized leaf outputs with ``max_delta_step`` clamping and
  monotone-constraint zeroing (``GetSplitGains``);
* with ``has_cat``, the categorical scans of
  ``FindBestThresholdCategorical`` (feature_histogram.hpp:113-273): one
  bin against the rest when ``num_bin <= max_cat_to_onehot``, else the
  bins sorted by ``g / (h + cat_smooth)`` and scanned from both ends with
  ``lambda_l2 + cat_l2``, at most ``max_cat_threshold`` bins a side.  The
  winner's bin set travels as a (B, 256) membership row.

The JAX package ``vmap``s the single-leaf scan over a histogram stack; here
the stack is a written-out leading batch dimension B.

:func:`find_best_split` with ``scales`` is the int32 scan of
``grad_quant_bits=8``: the quantized histograms stay integer through
default-bin reconstruction and every prefix sum, so both are exact, and
are dequantized only where the gain and leaf-output math needs real
units.  Ties break as in the JAX package: ``torch.argmax`` returns the
first maximum, which is ``jnp.argmax``'s rule (lower feature index,
default-left variant first), and the categorical sort is stable.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

K_EPSILON = 1e-15
NEG_INF = -1e30

# indices into the packed best-split vector
(F_GAIN, F_FEATURE, F_THRESHOLD, F_DEFAULT_LEFT, F_IS_CAT,
 F_LEFT_G, F_LEFT_H, F_LEFT_C, F_RIGHT_G, F_RIGHT_H, F_RIGHT_C,
 F_LEFT_OUT, F_RIGHT_OUT) = range(13)


class SplitHyper(NamedTuple):
    """Split hyper-parameters (host floats)."""
    lambda_l1: float
    lambda_l2: float
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    max_delta_step: float
    cat_smooth: float
    cat_l2: float
    max_cat_threshold: float
    max_cat_to_onehot: float
    min_data_per_group: float

    @classmethod
    def from_config(cls, c) -> "SplitHyper":
        # rounded through float32: the JAX package carries these as f32
        f = lambda v: float(np.float32(v))
        return cls(f(c.lambda_l1), f(c.lambda_l2), f(c.min_data_in_leaf),
                   f(c.min_sum_hessian_in_leaf), f(c.min_gain_to_split),
                   f(c.max_delta_step), f(c.cat_smooth), f(c.cat_l2),
                   f(c.max_cat_threshold), f(c.max_cat_to_onehot),
                   f(c.min_data_per_group))


class FeatureMeta(NamedTuple):
    """Per-feature metadata as tensors on the training device."""
    slot_idx: torch.Tensor          # (F, 256) int64 flat index into the hist
    valid_nondefault: torch.Tensor  # (F, 256) bool
    num_bin: torch.Tensor           # (F,) int32
    default_bin: torch.Tensor       # (F,) int32
    missing: torch.Tensor           # (F,) int32 0/1/2 none/zero/nan
    is_cat: torch.Tensor            # (F,) int32
    mono: torch.Tensor              # (F,) int32
    penalty: torch.Tensor           # (F,) float32
    global_id: torch.Tensor         # (F,) int32

    @classmethod
    def from_dataset(cls, dataset, slot_stride: int,
                     device: torch.device) -> "FeatureMeta":
        """``slot_stride`` is the per-group slot pitch of the flat
        histogram (the smallest power of two covering every group)."""
        nb = dataset.f_num_bin.astype(np.int32)
        db = dataset.f_default_bin.astype(np.int32)
        off = dataset.f_offset.astype(np.int64)
        grp = dataset.f_group.astype(np.int64)
        b = np.arange(256, dtype=np.int64)[None, :]
        shift = (db == 0).astype(np.int64)
        slot = grp[:, None] * int(slot_stride) + off[:, None] + b \
            - shift[:, None]
        valid = (b < nb[:, None]) & (b != db[:, None])
        slot = np.where(valid, slot, 0)
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                          device=device)
        return cls(t(slot, torch.int64), t(valid, torch.bool),
                   t(nb, torch.int32), t(db, torch.int32),
                   t(dataset.f_missing_type, torch.int32),
                   t(dataset.f_is_categorical, torch.int32),
                   t(dataset.monotone_constraints, torch.int32),
                   t(dataset.feature_penalty, torch.float32),
                   t(np.arange(len(nb)), torch.int32))


def _threshold_l1(s, l1):
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def _calc_output(g, h, l1, l2, max_delta_step):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:447-455)."""
    out = -_threshold_l1(g, l1) / (h + l2)
    if max_delta_step <= 0.0:
        return out
    return torch.clamp(out, -max_delta_step, max_delta_step)


def _gain_given_output(g, h, l1, l2, out):
    """GetLeafSplitGainGivenOutput (feature_histogram.hpp:495-498)."""
    sg = _threshold_l1(g, l1)
    return -(2.0 * sg * out + (h + l2) * out * out)


def _split_gain(gl, hl, gr, hr, hp: SplitHyper, cmin, cmax, mono,
                l2=None):
    """GetSplitGains: child-gain sum with monotone violation -> 0.
    ``l2`` overrides ``hp.lambda_l2`` (the sorted categorical scan's)."""
    l1, mds = hp.lambda_l1, hp.max_delta_step
    l2 = hp.lambda_l2 if l2 is None else l2
    ol = torch.clamp(_calc_output(gl, hl, l1, l2, mds), cmin, cmax)
    orr = torch.clamp(_calc_output(gr, hr, l1, l2, mds), cmin, cmax)
    gain = (_gain_given_output(gl, hl, l1, l2, ol)
            + _gain_given_output(gr, hr, l1, l2, orr))
    violates = ((mono > 0) & (ol > orr)) | ((mono < 0) & (ol < orr))
    return torch.where(violates, torch.zeros_like(gain), gain)


def feature_histograms(hists, totals, meta: FeatureMeta):
    """(B, S, 3) flat slots -> (B, F, 256, 3) per-feature histograms with
    the default bin reconstructed from the leaf totals (B, 3).  f32, or
    int32 for the quantized scan (then the reconstruction is exact)."""
    fh = hists[:, meta.slot_idx] * meta.valid_nondefault[..., None]
    b = torch.arange(256, device=hists.device)[None, :]
    default_vals = totals[:, None, :] - fh.sum(dim=2, dtype=fh.dtype)
    default_vals[..., 2] = torch.clamp(default_vals[..., 2], min=0)
    is_default = (b == meta.default_bin[:, None]) \
        & (b < meta.num_bin[:, None])                          # (F, 256)
    return torch.where(is_default[None, ..., None],
                       default_vals[:, :, None, :], fh)


class PerFeatureBest(NamedTuple):
    gain: torch.Tensor          # (B, F) raw child-gain sum, NEG_INF if none
    threshold: torch.Tensor     # (B, F) int64 threshold bin
    default_left: torch.Tensor  # (B, F) bool
    left: torch.Tensor          # (B, F, 3) left-child (g, h, c); int32
    #                             quantized units under the int32 scan
    cat_member: torch.Tensor = None    # (B, F, 256) bool bin set going
    #                                    left, with has_cat
    cat_extra_l2: torch.Tensor = None  # (F,) cat_l2 of the sorted mode


def per_feature_best(fh, totals, meta: FeatureMeta, hp: SplitHyper,
                     min_gain_shift, cmin=-np.inf, cmax=np.inf,
                     scales=None, has_cat: bool = False) -> PerFeatureBest:
    """The threshold scans: each feature's best candidate of every leaf
    in the stack (no argmax over features).  ``scales`` (3,) f32
    ``[scale_g, scale_h, 1]`` switches on the int32 scan: ``fh`` is then
    int32 and ``totals`` real units; the prefix sums stay integer and the
    candidates are dequantized once, after them.  ``has_cat`` adds the
    categorical scans (:func:`_categorical_best`) for the features with
    ``meta.is_cat``."""
    tg = totals[:, 0, None, None, None]
    th = totals[:, 1, None, None, None] + 2.0 * K_EPSILON
    tc = totals[:, 2, None, None, None]
    nbin = meta.num_bin[:, None]                               # (F, 1)
    nb = nbin.float()
    db = meta.default_bin[:, None]
    miss = meta.missing[:, None]
    b = torch.arange(256, device=fh.device)[None, :]           # (1, 256)
    bsz, nf = fh.shape[0], fh.shape[1]

    in_feat = b < nbin
    na_mask = (miss == 2) & (b == nbin - 1)
    zero_sep = (miss == 1) & (nb > 2)                          # zero-as-missing
    zero_mask = zero_sep & (b == db)
    miss_mask = (na_mask | zero_mask) & in_feat
    base = fh * (in_feat & ~miss_mask)[..., None]
    prefix = torch.cumsum(base, dim=2, dtype=fh.dtype)         # (B, F, 256, 3)
    miss_stats = (fh * miss_mask[..., None]).sum(dim=2, dtype=fh.dtype)

    # variant 0 = missing left (default_left=True, reference dir=-1 scan)
    # variant 1 = missing right (default_left=False, dir=+1)
    lefts = torch.stack([prefix + miss_stats[:, :, None, :], prefix],
                        dim=2)                                 # (B, F, 2, 256, 3)
    lefts_f = lefts if scales is None else lefts.float() * scales

    t_ok = b < nbin - 1                                        # right side real bins
    two_dir = ((miss == 2) & (nb > 2)) | zero_sep
    na_small = (miss == 2) & (nb <= 2)                         # forced dl=False
    v0_ok = t_ok & ~na_small & ~((miss == 2) & (b >= nbin - 2))
    v0_ok = v0_ok & ~(zero_sep & (b == db - 1))
    v0_ok = v0_ok | (t_ok & (miss == 0))                       # plain scan -> v0
    v1_ok = t_ok & (two_dir | na_small)
    v1_ok = v1_ok & ~(zero_sep & (b == db))
    var_ok = torch.stack([v0_ok, v1_ok], dim=1)                # (F, 2, 256)

    gl = lefts_f[..., 0]
    hl = lefts_f[..., 1] + K_EPSILON
    cl = lefts_f[..., 2]
    gr, hr, cr = tg - gl, th - hl, tc - cl
    data_ok = ((cl >= hp.min_data_in_leaf) & (cr >= hp.min_data_in_leaf)
               & (hl >= hp.min_sum_hessian_in_leaf)
               & (hr >= hp.min_sum_hessian_in_leaf))
    mono = meta.mono[:, None, None]
    gains = _split_gain(gl, hl, gr, hr, hp, cmin, cmax, mono)
    ok = var_ok & data_ok & (gains > min_gain_shift[:, None, None, None])
    num_gains = torch.where(ok, gains, torch.full_like(gains, NEG_INF))

    flat = num_gains.reshape(bsz, nf, 512)
    arg = torch.argmax(flat, dim=2)                            # first max: dir=-1
    best_gain = torch.gather(flat, 2, arg[..., None])[..., 0]
    left = torch.gather(lefts.reshape(bsz, nf, 512, 3), 2,
                        arg[..., None, None].expand(bsz, nf, 1, 3))[:, :, 0]
    if not has_cat:
        return PerFeatureBest(best_gain, arg % 256, arg < 256, left)
    cat_gain, cat_left, member, extra_l2 = _categorical_best(
        fh, totals, meta, hp, min_gain_shift, cmin, cmax, scales)
    is_cat = (meta.is_cat == 1)[None, :]
    return PerFeatureBest(torch.where(is_cat, cat_gain, best_gain),
                          arg % 256, arg < 256,
                          torch.where(is_cat[..., None], cat_left, left),
                          member, extra_l2)


def _categorical_best(fh, totals, meta: FeatureMeta, hp: SplitHyper,
                      min_gain_shift, cmin, cmax, scales):
    """The categorical half of ``per_feature_best``
    (``lightgbm_tpu/ops/split.py:303-394``) over the stack: (gain (B, F),
    left (B, F, 3) in the histogram's units, membership (B, F, 256) bool,
    extra l2 (F,)).  One-hot mode puts one bin left; sorted-subset mode
    sorts the eligible bins (count >= cat_smooth) by ``g / (h +
    cat_smooth)`` and takes a prefix from the low end or from the high
    end.  The left sums are the membership row times the histogram,
    integer under the int32 scan."""
    tg = totals[:, 0, None, None]
    th = totals[:, 1, None, None] + 2.0 * K_EPSILON
    tc = totals[:, 2, None, None]
    shift = min_gain_shift[:, None, None]
    nbin = meta.num_bin[:, None]
    miss = meta.missing[:, None]
    b = torch.arange(256, device=fh.device)[None, :]
    fh_f = fh if scales is None else fh.float() * scales
    used = b < nbin - 1 + (miss == 0).to(nbin.dtype)           # (F, 256)

    def data_ok(cl, cr, hl, hr, min_right):
        return ((cl >= hp.min_data_in_leaf) & (cr >= min_right)
                & (hl >= hp.min_sum_hessian_in_leaf)
                & (hr >= hp.min_sum_hessian_in_leaf))

    # one-hot mode: left = one bin t (single-bin stats dequantize exactly)
    gl, hl, cl = fh_f[..., 0], fh_f[..., 1] + K_EPSILON, fh_f[..., 2]
    gr, hr, cr = tg - gl, th - hl, tc - cl
    oh = _split_gain(gl, hl, gr, hr, hp, cmin, cmax, 0)
    ok = used & data_ok(cl, cr, hl, hr, hp.min_data_in_leaf) & (oh > shift)
    oh = torch.where(ok, oh, torch.full_like(oh, NEG_INF))
    oh_arg = torch.argmax(oh, dim=2)
    oh_best = torch.gather(oh, 2, oh_arg[..., None])[..., 0]

    # sorted-subset mode
    l2c = float(np.float32(hp.lambda_l2) + np.float32(hp.cat_l2))
    eligible = used & (fh[..., 2] >= hp.cat_smooth)            # (B, F, 256)
    n_used = eligible.sum(dim=2)                               # (B, F)
    n_used_f = n_used.float()
    ratio = torch.where(eligible,
                        fh_f[..., 0] / (fh_f[..., 1] + hp.cat_smooth),
                        torch.full_like(fh_f[..., 0], np.inf))
    order = torch.sort(ratio, dim=2, stable=True).indices     # (B, F, 256)
    sorted_el = torch.gather(eligible, 2, order)
    sorted_fh = torch.gather(fh, 2, order[..., None].expand_as(fh)) \
        * sorted_el[..., None]
    k = b.float() + 1.0                                        # bins taken
    max_k = torch.minimum(torch.full_like(n_used_f, hp.max_cat_threshold),
                          torch.floor((n_used_f + 1.0) / 2.0))[..., None]
    k_ok = (k <= max_k) & (k <= torch.clamp(n_used_f[..., None] - 1.0,
                                            min=0.0))
    min_right = max(hp.min_data_in_leaf, hp.min_data_per_group)

    def scan(sfh):
        ps = torch.cumsum(sfh, dim=2, dtype=sfh.dtype)         # exact if int
        psf = ps if scales is None else ps.float() * scales
        gl, hl, cl = psf[..., 0], psf[..., 1] + K_EPSILON, psf[..., 2]
        gr, hr, cr = tg - gl, th - hl, tc - cl
        g = _split_gain(gl, hl, gr, hr, hp, cmin, cmax, 0, l2=l2c)
        ok = k_ok & data_ok(cl, cr, hl, hr, min_right) & (g > shift)
        return torch.where(ok, g, torch.full_like(g, NEG_INF))

    # the reverse scan takes from the high-ratio end of the eligible
    # prefix: flip, then rotate the n_used eligible entries to the front
    # (the JAX package's per-feature roll, as a gather)
    rot = (b + (256 - n_used)[..., None]) % 256                # (B, F, 256)
    rev_fh = torch.gather(torch.flip(sorted_fh, dims=[2]), 2,
                          rot[..., None].expand_as(fh))
    both = torch.stack([scan(sorted_fh), scan(rev_fh)], dim=2)
    flat = both.reshape(both.shape[0], both.shape[1], 512)
    srt_arg = torch.argmax(flat, dim=2)
    srt_best = torch.gather(flat, 2, srt_arg[..., None])[..., 0]
    srt_k = (srt_arg % 256 + 1)[..., None]

    use_onehot = meta.num_bin.float() <= hp.max_cat_to_onehot  # (F,)
    gain = torch.where(use_onehot[None, :], oh_best, srt_best)
    # membership of each feature's winner: sorted position of every bin
    inv_pos = torch.empty_like(order).scatter_(
        2, order, b.expand_as(order).contiguous())
    nu = n_used[..., None]
    fwd = inv_pos < srt_k
    rev = (inv_pos >= nu - srt_k) & (inv_pos < nu)
    member = torch.where((srt_arg < 256)[..., None], fwd, rev) & eligible
    member = torch.where(use_onehot[None, :, None], b == oh_arg[..., None],
                         member)
    left = (fh * member[..., None]).sum(dim=2, dtype=fh.dtype)
    extra_l2 = torch.where(use_onehot, 0.0, hp.cat_l2)
    return gain, left, member, extra_l2


def masked_feature_gain(pf: PerFeatureBest, meta: FeatureMeta, feature_mask,
                        min_gain_shift):
    """(B, F) shifted gains with penalty and masking applied; NEG_INF for
    excluded features."""
    g = (pf.gain - min_gain_shift[:, None]) * meta.penalty
    ok = feature_mask & (meta.num_bin > 1) & (meta.global_id >= 0)
    return torch.where(ok, g, torch.full_like(g, NEG_INF))


def pack_best(best_f, feat_gain, pf: PerFeatureBest, totals,
              meta: FeatureMeta, hp: SplitHyper, cmin=-np.inf, cmax=np.inf,
              scales=None):
    """(B, 13) float32 records of each leaf's winning split (F_* fields),
    in real units (``scales`` dequantizes the int32 scan's left sums),
    and the winner's (B, 256) membership row (None without categorical
    features).  A sorted-mode categorical winner's outputs take
    ``lambda_l2 + cat_l2``."""
    tg, th, tc = totals[:, 0], totals[:, 1] + 2.0 * K_EPSILON, totals[:, 2]
    l1, l2, mds = hp.lambda_l1, hp.lambda_l2, hp.max_delta_step
    rows = torch.arange(best_f.shape[0], device=best_f.device)
    left = pf.left[rows, best_f]                               # (B, 3)
    if scales is not None:
        left = left.float() * scales
    is_cat = meta.is_cat[best_f] == 1
    member = None
    if pf.cat_member is not None:
        member = pf.cat_member[rows, best_f]
        l2 = l2 + torch.where(is_cat, pf.cat_extra_l2[best_f], 0.0)
    lg, lh, lc = left[:, 0], left[:, 1] + K_EPSILON, left[:, 2]
    rg = tg - lg
    left_out = torch.clamp(_calc_output(lg, lh, l1, l2, mds), cmin, cmax)
    rh = th - lh
    right_out = torch.clamp(_calc_output(rg, rh, l1, l2, mds), cmin, cmax)
    f32 = lambda t: t.to(torch.float32)
    return torch.stack([
        feat_gain[rows, best_f],
        f32(meta.global_id[best_f]),
        f32(pf.threshold[rows, best_f]),
        f32(pf.default_left[rows, best_f]),
        f32(is_cat),
        lg, left[:, 1], lc,
        rg, th - 2.0 * K_EPSILON - left[:, 1], tc - lc,
        left_out, right_out,
    ], dim=1), member


def min_gain_shift_of(totals, hp: SplitHyper):
    """Parent gain + min_gain_to_split: the bar every candidate must clear
    (GetLeafSplitGain on the leaf totals), (B,)."""
    tg, th = totals[:, 0], totals[:, 1] + 2.0 * K_EPSILON
    l1, l2, mds = hp.lambda_l1, hp.lambda_l2, hp.max_delta_step
    parent_out = _calc_output(tg, th, l1, l2, mds)
    return (_gain_given_output(tg, th, l1, l2, parent_out)
            + hp.min_gain_to_split)


def find_best_split(hists, totals, feature_mask, meta: FeatureMeta,
                    hp: SplitHyper, has_cat: bool = False, scales=None,
                    constraint=None):
    """Best split of every leaf of a (B, S, 3) histogram stack with (B, 3)
    totals: (packed (B, 13) f32 records in real units, the gain NEG_INF
    where no candidate clears the bar; the winners' (B, 256) bool
    membership rows, None unless ``has_cat``; the winners' exact (B, 3)
    int32 left totals, None unless ``scales``).

    ``scales`` (2,) f32 ``[scale_g, scale_h]`` switches on the int32 scan
    of ``grad_quant_bits=8``: ``hists`` and ``totals`` are then int32 in
    quantized units, and the caller takes the right child as total -
    left.

    ``constraint`` ``(cmin, cmax)`` bounds every leaf output of the stack
    (the host learner's monotone midpoints; f32 values, as the JAX
    package carries them): outputs are clamped to it before the
    monotone-violation test and in the records."""
    cmin, cmax = (-np.inf, np.inf) if constraint is None else (
        float(np.float32(constraint[0])), float(np.float32(constraint[1])))
    if scales is None:
        totals_f, svec = totals, None
    else:
        svec = torch.cat([scales.float(),
                          torch.ones(1, dtype=torch.float32,
                                     device=scales.device)])
        totals_f = totals.float() * svec
    shift = min_gain_shift_of(totals_f, hp)
    fh = feature_histograms(hists, totals, meta)
    pf = per_feature_best(fh, totals_f, meta, hp, shift, cmin, cmax,
                          scales=svec, has_cat=has_cat)
    feat_gain = masked_feature_gain(pf, meta, feature_mask, shift)
    best_f = torch.argmax(feat_gain, dim=1)
    packed, member = pack_best(best_f, feat_gain, pf, totals_f, meta, hp,
                               cmin, cmax, scales=svec)
    lint = None
    if scales is not None:
        rows = torch.arange(best_f.shape[0], device=best_f.device)
        lint = pf.left[rows, best_f].to(torch.int32)
    return packed, member, lint
