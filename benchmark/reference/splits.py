"""Plain split finding, in float64 torch on the codes' device, with no
kernels and no graphs: what a tree of the program should hold at a
node, given the rows that reach it and their gradients (the objective's
reference, ``reference/objectives``).

* gradients and hessians rounded as the configuration states its
  gradient columns (bfloat16 for the port's default);
* the bag of rows and the features a tree may use, where the
  configuration samples them (``rng``);
* a node's histogram of its bagged rows, and its best split: the largest
  ``G_l^2/(H_l + l2) + G_r^2/(H_r + l2) - G^2/(H + l2)`` over every
  feature allowed and threshold ``t`` (bins <= t go left; the lower
  feature, then the lower threshold, on ties) with at least
  ``min_data_in_leaf`` rows and ``min_sum_hessian_in_leaf`` on each side,
  in a node with more than twice those; a leaf outputs ``-G/(H + l2)``
  times the learning rate.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import rng

F64 = torch.float64


class Params:
    def __init__(self, p: dict):
        self.num_leaves = int(p["num_leaves"])
        self.lr = float(p["learning_rate"])
        self.min_data = float(p["min_data_in_leaf"])
        self.min_hess = float(p["min_sum_hessian_in_leaf"])
        self.l2 = float(p.get("lambda_l2", 0.0))
        self.stat_dtype = p.get("stat_dtype", "float32")
        self.bag_fraction = float(p.get("bagging_fraction", 1.0))
        self.bag_freq = int(p.get("bagging_freq", 0))
        self.bag_seed = int(p.get("bagging_seed", 3))
        self.ff = float(p.get("feature_fraction", 1.0))
        self.ff_seed = int(p.get("feature_fraction_seed", 2))


def round_stat(v: torch.Tensor, stat_dtype: str) -> torch.Tensor:
    """``v`` rounded to the configuration's gradient type, in float64."""
    if stat_dtype == "bfloat16":
        return v.float().to(torch.bfloat16).to(F64)
    if stat_dtype == "float32":
        return v.float().to(F64)
    if stat_dtype == "float64":
        return v.to(F64)
    raise ValueError(f"unknown stat_dtype {stat_dtype!r}")


def bag_at(p: Params, it: int, n: int, device) -> Optional[torch.Tensor]:
    """Tree ``it``'s bag: the draw of the bagging round it falls in."""
    if p.bag_fraction >= 1.0 or p.bag_freq <= 0:
        return None
    return rng.bag(it - it % p.bag_freq, n, p.bag_fraction, p.bag_seed,
                   device)


def features_at(p: Params, it: int, nf: int,
                device) -> Optional[torch.Tensor]:
    if p.ff >= 1.0 or nf <= 1:
        return None
    return rng.features(it, nf, p.ff, p.ff_seed, device)


class Splitter:
    """Histograms and splits over ``codes`` (N, F) uint8, the bins of the
    used features, each with ``nbins`` bins."""

    def __init__(self, codes: torch.Tensor, nbins, p: Params):
        self.codes = codes
        self.n, self.f = (int(s) for s in codes.shape)
        self.p = p
        dev = codes.device
        self.offs = (torch.arange(self.f, device=dev) * 256)[None, :]
        nb = torch.as_tensor(list(nbins), device=dev)
        t = torch.arange(256, device=dev)[None, :]
        self.thr_ok = t < (nb[:, None] - 1)

    def hist(self, idx: torch.Tensor, stats: torch.Tensor,
             block: int = 1 << 20) -> torch.Tensor:
        """(F, 256, 3) sums of ``stats`` (N, 3) over the rows ``idx``."""
        out = torch.zeros((self.f * 256, 3), dtype=F64,
                          device=self.codes.device)
        for b in range(0, idx.numel(), block):
            r = idx[b:b + block]
            key = (self.codes[r].long() + self.offs).reshape(-1)
            val = stats[r][:, None, :].expand(-1, self.f, 3).reshape(-1, 3)
            out.index_add_(0, key, val)
        return out.view(self.f, 256, 3)

    def splittable(self, tot: torch.Tensor) -> bool:
        return float(tot[2]) > 2 * self.p.min_data \
            and float(tot[1]) > 2 * self.p.min_hess

    def _gains(self, hist, tot, fmask):
        p = self.p
        left = hist.cumsum(1)
        right = tot[None, None, :] - left
        ok = self.thr_ok & (left[..., 2] >= p.min_data) \
            & (right[..., 2] >= p.min_data) \
            & (left[..., 1] >= p.min_hess) & (right[..., 1] >= p.min_hess)
        if fmask is not None:
            ok &= fmask[:, None]
        gain = left[..., 0] ** 2 / (left[..., 1] + p.l2) \
            + right[..., 0] ** 2 / (right[..., 1] + p.l2)
        shift = float(tot[0] ** 2 / (tot[1] + p.l2))
        return torch.where(ok, gain, -math.inf), shift

    def best(self, hist: torch.Tensor, tot: torch.Tensor,
             fmask: Optional[torch.Tensor]):
        """(gain over the parent's, feature, threshold) of the node's best
        split, or (-inf, -1, -1) where it has none."""
        if not self.splittable(tot):
            return -math.inf, -1, -1
        gain, shift = self._gains(hist, tot, fmask)
        flat = gain.reshape(-1)
        i = int(torch.argmax(flat))
        g = float(flat[i])
        if not math.isfinite(g) or g <= shift:
            return -math.inf, -1, -1
        return g - shift, i // 256, i % 256

    def gain(self, hist, tot, f: int, t: int, fmask) -> float:
        """Gain over the parent's of splitting at feature ``f``, threshold
        ``t``; -inf where the constraints forbid it."""
        if not self.splittable(tot):
            return -math.inf
        gain, shift = self._gains(hist, tot, fmask)
        return float(gain[f, t]) - shift
