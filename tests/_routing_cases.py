"""Inputs of a wave's row routing (``ops/routing.split_rows``) and an
oracle for it, shared by the CPU tests (``test_torch_routing.py``) and the
card tests (``test_torch_cuda.py``).

The oracle routes each selected lane's rows with the host learner's
``ops/partition.goes_left``, an implementation of the same rules written
apart from the wave's."""

import numpy as np
import torch

from lightgbm_tpu_torch.ops import partition
from lightgbm_tpu_torch.ops.routing import CAT_WORDS

#: features of :func:`feature_rows`: (group, offset, num_bin,
#: default_bin, missing type); groups 0 and 1 each hold one feature
#: (offset 0), groups 2-4 bundles of several.  Default bin 0 and not 0,
#: each missing type (0 none, 1 zero, 2 NaN).
FEATURES = [
    (0, 0, 256, 0, 0), (1, 0, 200, 37, 2),
    (2, 0, 40, 0, 1), (2, 39, 60, 12, 0), (2, 99, 30, 0, 2),
    (3, 0, 17, 3, 1), (3, 17, 100, 0, 0), (3, 117, 130, 64, 2),
    (4, 0, 8, 0, 2), (4, 7, 5, 2, 1), (4, 12, 240, 239, 2),
    (4, 252, 3, 1, 0),
]
GROUPS = 5


def feature_rows():
    """The ``(F, 6)`` int32 table of :data:`FEATURES`
    (``routing.feature_table``'s columns)."""
    rows = [(g, off, nb - (db == 0), db, nb, miss)
            for g, off, nb, db, miss in FEATURES]
    return torch.tensor(rows, dtype=torch.int32)


def make_case(n, num_leaves, ws, *, nsel, cat=False, pad_blocks=0, seed=0,
              dev="cpu"):
    """One wave's inputs: ``n`` rows over :data:`GROUPS` groups with leaf
    ids in [-1, num_leaves) (-1 on one row in ten; with ``pad_blocks``,
    the tail of each of that many row blocks, as a sharded grower pads
    them), ``ws`` lanes of which the first ``nsel`` are selected (lane w
    splits on feature w mod F with default_left (w // F) odd, so every
    feature meets both), the others holding garbage; with ``cat``, every
    third selected lane categorical with a random bin set.  Returns the
    positional arguments of ``split_rows`` after ``leaf_id``, with
    ``leaf_id`` first."""
    rng = np.random.default_rng(seed)
    nf = len(FEATURES)
    L = int(num_leaves)
    codes = rng.integers(0, 256, (GROUPS, n)).astype(np.uint8)
    # most codes inside the groups' slot ranges
    top = np.array([max(o + nb for g2, o, nb, _, _ in FEATURES if g2 == g)
                    for g in range(GROUPS)])
    inside = rng.random((GROUPS, n)) < 0.9
    codes = np.where(inside, rng.integers(0, top[:, None], (GROUPS, n)),
                     codes).astype(np.uint8)
    leaf = rng.integers(0, L, n).astype(np.int32)
    leaf[rng.random(n) < 0.1] = -1
    if pad_blocks:
        m = -(-n // pad_blocks)
        for b in range(pad_blocks):
            leaf[b * m + m * 3 // 4:(b + 1) * m] = -1
    nsel = min(nsel, ws, L)
    leaves = rng.permutation(L)[:nsel]
    sel = np.arange(ws) < nsel
    lsel = rng.integers(-5, L + 5, ws).astype(np.int64)
    lsel[:nsel] = leaves
    f = np.full(ws, np.iinfo(np.int64).min, np.int64)
    f[:nsel] = np.arange(nsel) % nf
    thr = rng.integers(-(1 << 40), 1 << 40, ws).astype(np.int64)
    for w in range(nsel):
        thr[w] = rng.integers(0, FEATURES[f[w]][2] - 1)
    dl = rng.random(ws) < 0.5
    dl[:nsel] = (np.arange(nsel) // nf) % 2 == 1
    r_ids = (L + np.arange(ws)).astype(np.int64)
    words = is_cat = None
    if cat:
        words = torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, (ws, CAT_WORDS)).astype(np.int32))
        is_cat = torch.from_numpy((np.arange(ws) % 3 == 2) & sel)
    t = torch.from_numpy
    out = [t(leaf), t(codes), feature_rows(), t(sel), t(lsel), t(r_ids),
           t(f), t(thr), t(dl), words, is_cat]
    return [None if x is None else x.to(dev) for x in out]


def oracle(leaf_id, codes, feat, sel, lsel, r_ids, f, thr, dl, words=None,
           is_cat=None, **_):
    """The leaf ids after the wave, lane by lane through
    ``partition.goes_left`` (CPU tensors)."""
    out = leaf_id.clone()
    for w in np.flatnonzero(sel.numpy()):
        rows = torch.nonzero(leaf_id == lsel[w]).squeeze(1)
        g, off, wid, db, nb, miss = (int(v) for v in feat[int(f[w])])
        member = None
        cat = is_cat is not None and bool(is_cat[w])
        if cat:
            bits = words[w].to(torch.int64) & 0xFFFFFFFF
            member = ((bits[:, None] >> torch.arange(32)) & 1).reshape(-1) \
                .bool()
        left = partition.goes_left(
            codes[g, rows], offset=off, width=wid, default_bin=db,
            num_bin=nb, missing=miss, threshold=int(thr[w]),
            default_left=bool(dl[w]), is_cat=cat, cat_member=member)
        out[rows[~left]] = int(r_ids[w])
    return out
