"""The comparisons that decide ``correct``: the program's outputs against
the plain reference, each number beside its limit.

Every check is ``(name, value, limit)`` and passes when ``value <=
limit``; a comparison that cannot be made (shapes that differ, a
reference that refuses the data) reads ``inf``.  A cell's limits file
gives each number its limit, or ``null`` for a number that is logged
and not compared.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .reference import bins as ref_bins
from .reference import forest as ref_forest
from .reference import splits as ref_splits


def _gap_stats(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    d = (prog.double() - ref.double()).abs()
    return {"median": float(d.median()), "max": float(d.max())}


def codes_mismatch(x: torch.Tensor, prog_codes: Optional[torch.Tensor],
                   params: dict, log) -> Tuple[float, "ref_bins.Bins"]:
    """(rows x columns whose code differs from the reference's, the
    reference's bins); the codes are compared as a one-feature group
    stores them."""
    bins = ref_bins.Bins(x, params)
    ref = bins.stored(bins.codes(x))
    if prog_codes is None or tuple(prog_codes.shape) != tuple(ref.shape):
        log(f"codes: shape {None if prog_codes is None else tuple(prog_codes.shape)}"
            f" against the reference's {tuple(ref.shape)}")
        return math.inf, bins
    n = 0
    for b in range(0, ref.shape[0], 1 << 22):
        n += int((prog_codes[b:b + (1 << 22)].to(ref.device)
                  != ref[b:b + (1 << 22)]).sum())
    return float(n), bins


def judge_trees(x: torch.Tensor, y: torch.Tensor, params: dict,
                bins: "ref_bins.Bins", objective, trees: list,
                starts: List[Tuple[int, Optional[torch.Tensor]]], k: int,
                end: Optional[torch.Tensor], log) -> Dict[str, float]:
    """For each ``(first, start)`` of ``starts``, the program's trees
    ``first`` to ``first + k - 1`` of ``trees`` (its trees from the
    first, as plain arrays), each judged on the scores the program's
    earlier trees give every row: from ``start``, the program's training
    scores before tree ``first`` (None for the first tree: the
    reference's own starting score), adding each judged tree's leaf
    values in float32 as the scores are kept.  On those scores:
    ``objective``'s gradients (rounded as the configuration states), the
    bag and feature set of the tree's iteration, and, at every split of
    the program's tree, the reference's own histogram of the node's
    bagged rows and the best split it finds there.

    * ``split_regret``: the largest shortfall of a chosen split's gain
      from the best one, over the best split's gain (``inf`` for a split
      the constraints forbid);
    * ``leaf_gap``: in each tree ``first``, whose starting scores are
      the program's own, the largest gap between a leaf's value and
      ``-G/(H + l2)`` times the learning rate over its bagged rows, over
      the larger of that value and the tree's median one (later trees'
      are logged);
    * ``median_leaf_gap``: the median leaf's gap in each tree ``first``,
      which the float32 sums of a small leaf's large ancestors do not
      sway;
    * ``score_gap``: the largest gap between ``end``, the program's
      training scores after the last of ``trees``, and the walk of all
      of ``trees`` over every row (left out where ``end`` is None).

    A near tie, which the program's float32 scan may break either way,
    costs a regret of rounding size; the trees that follow are judged on
    the program's own trees, so they do not drift apart."""
    bad = [f for f, st in starts
           if len(trees) < f + k or (f > 0 and st is None)]
    if bad or not starts:
        log(f"trees: the model has {len(trees)}, trees from {bad} judged")
        return {"split_regret": math.inf, "leaf_gap": math.inf,
                "median_leaf_gap": math.inf, "score_gap": math.inf}
    prm = ref_splits.Params(params)
    codes = bins.codes(x)
    col = {f: j for j, f in enumerate(bins.used)}
    gr = ref_splits.Splitter(codes, bins.num_bins(), prm)
    yd = y.to(x.device)
    init = objective.init_score(yd)
    regret = leaf = med = 0.0
    for first, start in starts:
        score = (torch.full((gr.n,), init, dtype=torch.float32,
                            device=x.device)
                 if first == 0 else start.to(x.device).float())
        r_, l_, m_ = _judge_from(trees, first, k, score, init, yd, prm, gr,
                                 bins, col, codes, objective, x.device, log)
        regret, leaf, med = max(regret, r_), max(leaf, l_), max(med, m_)
    out = {"split_regret": regret, "leaf_gap": leaf,
           "median_leaf_gap": med}
    if end is not None:
        model = ref_forest.forest_output(trees, x)
        st = _gap_stats(end.to(x.device), model)
        log(f"training scores against the program's {len(trees)} trees: "
            f"|gap| median {st['median']:.3e} max {st['max']:.3e}")
        out["score_gap"] = st["max"]
        _log_worst_rows(trees, x, starts, end, model, log)
    return out


def _judge_from(trees, first, k, score, init, yd, prm, gr, bins, col, codes,
                objective, device, log):
    """(split regret, leaf gap, median leaf gap) of trees ``first`` to
    ``first + k - 1`` from the program's scores ``score`` before tree
    ``first``; the leaf gaps are tree ``first``'s."""
    regret = leaf = med = 0.0
    for t in range(first, first + k):
        tree = trees[t]
        bag = ref_splits.bag_at(prm, t, gr.n, device)
        fmask = ref_splits.features_at(prm, t, gr.f, device)
        g32, h32 = objective.gradients(score, yd)
        g = ref_splits.round_stat(g32, prm.stat_dtype)
        h = ref_splits.round_stat(h32, prm.stat_dtype)
        w = torch.ones_like(g) if bag is None else bag.to(torch.float64)
        stats = torch.stack([g * w, h * w, w], 1)
        value = torch.empty(gr.n, dtype=torch.float64, device=device)
        expect = np.zeros(tree.num_leaves)
        rows = torch.arange(gr.n, device=device)
        inbag = rows if bag is None else rows[bag]
        todo = [(0 if tree.num_leaves > 1 else -1, rows,
                 gr.hist(inbag, stats), stats.sum(0))]
        t_regret = 0.0
        while todo:
            node, r, hist, tot = todo.pop()
            if node < 0:
                lf = ~node
                gg, hh = float(tot[0]), float(tot[1])
                v = prm.lr * (-gg / (hh + prm.l2)) if tree.num_leaves > 1 \
                    else 0.0
                expect[lf] = v + (init if t == 0 else 0.0)
                value[r] = float(tree.leaf_value[lf])
                continue
            f = col.get(int(tree.split_feature[node]))
            upper = bins.mappers[int(tree.split_feature[node])].upper \
                if f is not None else None
            tb = -1 if upper is None else int(np.searchsorted(
                upper, float(tree.threshold[node])))
            best = gr.best(hist, tot, fmask)
            chosen = gr.gain(hist, tot, f, tb, fmask) \
                if f is not None and 0 <= tb < len(upper) - 1 \
                and upper[tb] == float(tree.threshold[node]) else -math.inf
            if not math.isfinite(chosen):
                log(f"tree {t + 1} node {node}: feature "
                    f"{int(tree.split_feature[node])} threshold "
                    f"{float(tree.threshold[node])!r} is no allowed split")
            shift = float(tot[0] ** 2 / (tot[1] + prm.l2))
            if not math.isfinite(chosen):
                t_regret = math.inf
            elif best[1] >= 0:
                t_regret = max(t_regret, (best[0] - chosen)
                               / (best[0] + shift))
            go_r = codes[r, f].long() > tb
            lr_, rr = r[~go_r], r[go_r]
            left = hist[f, :tb + 1].sum(0)
            ltot, rtot = left, tot - left
            small_left = bool(ltot[2] <= rtot[2])
            sr = lr_ if small_left else rr
            if bag is not None:
                sr = sr[bag[sr]]
            sh = gr.hist(sr, stats)
            lh, rh = (sh, hist - sh) if small_left else (hist - sh, sh)
            todo.append((int(tree.left_child[node]), lr_, lh, ltot))
            todo.append((int(tree.right_child[node]), rr, rh, rtot))
        lv = np.asarray(tree.leaf_value[:tree.num_leaves], np.float64)
        scale = np.maximum(np.abs(expect), np.median(np.abs(expect)))
        gaps = np.abs(lv - expect) / scale
        t_leaf, t_med = float(np.max(gaps)), float(np.median(gaps))
        log(f"tree {t + 1}: {tree.num_leaves} leaves; split regret "
            f"{t_regret:.3e}, leaf gap {t_leaf:.3e} (median {t_med:.3e})")
        regret = max(regret, t_regret)
        if t == first:
            leaf, med = t_leaf, t_med
        # the first tree's leaf values carry the starting score
        score = (score.double() + value
                 - (init if t == 0 else 0.0)).float()
    return regret, leaf, med


def _log_worst_rows(trees, x, starts, end, model, log, n=3) -> None:
    """Where the scores part: the rows whose score is farthest from the
    walk, each against the walk of the trees before each judged chunk's
    start, so that a gap is placed in the chunk whose trees made it."""
    d = (end.to(x.device).double() - model).abs()
    far = int((d > 1e-4).sum())
    top = torch.topk(d, min(n, d.numel())).indices
    log(f"score gap: {far} rows past 1e-4; the farthest {top.tolist()}")
    for first, start in starts:
        if start is None:
            continue
        before = ref_forest.forest_output(trees[:first], x[top])
        gap = (start.to(x.device)[top].double() - before).abs()
        log(f"  before tree {first + 1}: gaps {gap.tolist()}")
    log(f"  after tree {len(trees)}: gaps {d[top].tolist()}")
