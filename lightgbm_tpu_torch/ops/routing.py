"""A wave's row routing (the device grower's step 5): the hand-written
kernel and its plain version.

After a wave selects up to Ws splits (its lanes: ``sel``, the leaves
``lsel`` they split, their features ``f``, thresholds ``thr``,
``default_left`` flags ``dl`` and right children ``r_ids``), every row
whose leaf a selected lane splits reads the code of the lane's feature
group and moves to the right child unless it goes left, by the rules of
``DenseBin::Split`` that ``ops/partition.py`` states; under a categorical
split a row goes left iff its bin's bit is set in the lane's eight-word
set (``words``, with ``is_cat``).  This is the leaf-id update of
``lightgbm_tpu/ops/grow.py``'s wave (:869-916).

:func:`split_rows` launches ``csrc/split_rows.cu`` for CUDA tensors and
takes :func:`split_rows_reference` only for CPU tensors; both update the
leaf ids in place, and the two agree bit for bit (integer logic).  A
feature's group, slot range, default bin, bin count and missing type come
from one ``(F, 6)`` int32 table (:func:`feature_table`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import load_library
from .hist_cuda import DeviceLaunchCount, _inputs_on_card, _sm_count

#: columns of :func:`feature_table`
(FEAT_GROUP, FEAT_OFFSET, FEAT_WIDTH, FEAT_DEFAULT, FEAT_NUM_BIN,
 FEAT_MISSING) = range(6)
#: words of a categorical split's 256-bin set
CAT_WORDS = 8
#: the most lanes a launch takes (csrc/split_rows.cu kMaxLanes; the
#: grower's widest wave is 128)
MAX_LANES = 128
#: the most leaves the kernel's shared leaf -> lane map takes
MAX_LEAVES = 1 << 15
#: threads a block and blocks an SM (csrc/split_rows.cu kThreads,
#: kBlocksPerSM): each block builds the lanes' tables once, then walks its
#: share of the rows
THREADS = 1024
BLOCKS_PER_SM = 2


def feature_table(dataset, device) -> torch.Tensor:
    """``(F, 6)`` int32: each feature's group, slot offset in the group,
    slot width (its bins less the default's slot when the default bin is
    0), default bin, bin count and missing type (0/1/2: none, zero,
    NaN)."""
    nb = np.asarray(dataset.f_num_bin, np.int64)
    db = np.asarray(dataset.f_default_bin, np.int64)
    cols = (dataset.f_group, dataset.f_offset, nb - (db == 0), db, nb,
            dataset.f_missing_type)
    table = np.stack([np.asarray(c, np.int64) for c in cols], 1)
    return torch.as_tensor(table.astype(np.int32), device=device)


def _check(leaf_id, codes, feat, sel, lsel, r_ids, f, thr, dl, words,
           is_cat, num_leaves) -> int:
    """Shapes, dtypes and devices of a launch's inputs; returns Ws."""
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be (G, n) uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    n = codes.shape[1]
    if leaf_id.shape != (n,) or leaf_id.dtype != torch.int32:
        raise ValueError(f"leaf_id must be ({n},) int32, got "
                         f"{tuple(leaf_id.shape)} {leaf_id.dtype}")
    if feat.dim() != 2 or feat.shape[1] != 6 or feat.dtype != torch.int32:
        raise ValueError(f"feat must be (F, 6) int32, got "
                         f"{tuple(feat.shape)} {feat.dtype}")
    if sel.dim() != 1 or sel.dtype != torch.bool:
        raise ValueError(f"sel must be (Ws,) bool, got {tuple(sel.shape)} "
                         f"{sel.dtype}")
    ws = sel.shape[0]
    for name, t, dt in (("lsel", lsel, torch.int64),
                        ("r_ids", r_ids, torch.int64),
                        ("f", f, torch.int64), ("thr", thr, torch.int64),
                        ("dl", dl, torch.bool)):
        if t.shape != (ws,) or t.dtype != dt:
            raise ValueError(f"{name} must be ({ws},) {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (words is None) != (is_cat is None):
        raise ValueError("words and is_cat come together (a model with a "
                         "categorical feature) or not at all")
    if words is not None:
        if words.shape != (ws, CAT_WORDS) or words.dtype != torch.int32:
            raise ValueError(f"words must be ({ws}, {CAT_WORDS}) int32, got "
                             f"{tuple(words.shape)} {words.dtype}")
        if is_cat.shape != (ws,) or is_cat.dtype != torch.bool:
            raise ValueError(f"is_cat must be ({ws},) bool, got "
                             f"{tuple(is_cat.shape)} {is_cat.dtype}")
    if ws < 1 or int(num_leaves) < 1:
        raise ValueError(f"need Ws >= 1 and num_leaves >= 1, got Ws={ws} "
                         f"num_leaves={num_leaves}")
    tensors = [leaf_id, codes, feat, sel, lsel, r_ids, f, thr, dl]
    if words is not None:
        tensors += [words, is_cat]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    return ws


def split_rows_reference(leaf_id, codes, feat, sel, lsel, r_ids, f, thr, dl,
                         words=None, is_cat=None, *,
                         num_leaves: int) -> torch.Tensor:
    """The plain PyTorch version: the ``(n,)`` int32 leaf ids after the
    wave's splits (a new tensor).  Each row looks up its leaf's lane (a
    row belongs to at most one selected leaf), reads that split's group
    and decides left or right as lightgbm_tpu/ops/grow.py:869-916 does."""
    ws = _check(leaf_id, codes, feat, sel, lsel, r_ids, f, thr, dl, words,
                is_cat, num_leaves)
    L = int(num_leaves)
    dev = leaf_id.device
    lane_of = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
    lane_of[torch.where(sel, lsel, L)] = torch.arange(ws, device=dev)
    lane_of[L:].fill_(-1)
    row_lane = lane_of[torch.where(leaf_id >= 0, leaf_id, L).long()]
    lane = row_lane.clamp(min=0)
    # an unselected lane's feature may be anything: read feature 0 there
    ft = feat[torch.where(sel, f, 0)[lane]].long()
    grp, off, wid = ft[:, FEAT_GROUP], ft[:, FEAT_OFFSET], ft[:, FEAT_WIDTH]
    db, nbin = ft[:, FEAT_DEFAULT], ft[:, FEAT_NUM_BIN]
    miss = ft[:, FEAT_MISSING]
    cols = codes.gather(0, grp[None, :])[0].long()
    dl_r, thr_r = dl[lane], thr[lane]
    def_left = torch.where(miss == 1, dl_r, db <= thr_r)
    shift = (db == 0).long()
    in_range = (cols >= off) & (cols < off + wid)
    bin_ = torch.where(in_range, cols - off + shift, db)
    is_na = (miss == 2) & (bin_ == nbin - 1)
    goes_left = torch.where(bin_ == db, def_left,
                            torch.where(is_na, dl_r, bin_ <= thr_r))
    if words is not None:
        # categorical routing (lightgbm_tpu/ops/grow.py:892-911): left iff
        # the decoded bin's bit is set in the lane's 8-word set
        word = words.reshape(-1)[lane * CAT_WORDS + (bin_ >> 5)]
        left_cat = ((word >> (bin_ & 31)) & 1) == 1
        goes_left = torch.where(is_cat[lane], left_cat, goes_left)
    move = (row_lane >= 0) & ~goes_left
    return torch.where(move, r_ids[lane].to(torch.int32), leaf_id)


def _launcher():
    fn = load_library("split_rows").split_rows_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, ll, p, i, p, p, p, p, p, p, p, p, i, i, i, p, p]
        fn.restype = i
    return fn


def split_rows(leaf_id, codes, feat, sel, lsel, r_ids, f, thr, dl,
               words=None, is_cat=None, *, num_leaves: int) -> torch.Tensor:
    """Route the rows of a wave's selected splits: ``leaf_id`` ((n,)
    int32, -1 for rows in no leaf) is updated in place and returned.
    ``codes`` is the ``(G, n)`` uint8 codes, ``feat`` the
    :func:`feature_table`; ``sel``, ``dl`` (and ``is_cat``) are (Ws,)
    bool, ``lsel``, ``r_ids``, ``f`` and ``thr`` (Ws,) int64, ``words``
    (Ws, 8) int32; every leaf id is below ``num_leaves``.  A selected
    lane names a leaf below ``num_leaves`` and a feature of ``feat``, no
    two the same leaf.

    CUDA tensors launch the kernel (one launch on the current stream,
    counted on the device in :attr:`split_rows.launches`) or raise; CPU
    tensors take :func:`split_rows_reference`."""
    ws = _check(leaf_id, codes, feat, sel, lsel, r_ids, f, thr, dl, words,
                is_cat, num_leaves)
    dev = leaf_id.device
    if dev.type == "cpu":
        return leaf_id.copy_(split_rows_reference(
            leaf_id, codes, feat, sel, lsel, r_ids, f, thr, dl, words,
            is_cat, num_leaves=num_leaves))
    tensors = dict(leaf_id=leaf_id, codes=codes, feat=feat, sel=sel,
                   lsel=lsel, r_ids=r_ids, f=f, thr=thr, dl=dl)
    if words is not None:
        tensors.update(words=words, is_cat=is_cat)
    _inputs_on_card("split_rows", **tensors)
    if ws > MAX_LANES:
        raise ValueError(f"Ws must be at most {MAX_LANES}, got {ws}")
    if int(num_leaves) > MAX_LEAVES:
        raise ValueError(f"num_leaves must be at most {MAX_LEAVES} (the "
                         f"kernel's shared leaf -> lane map), got "
                         f"{num_leaves}")
    n = leaf_id.shape[0]
    blocks = max(1, min(-(-n // (4 * THREADS)),
                        BLOCKS_PER_SM * _sm_count(dev)))
    count = split_rows.launches.counter(dev)
    rc = _launcher()(
        leaf_id.data_ptr(), codes.data_ptr(), n, feat.data_ptr(),
        feat.shape[0], sel.data_ptr(), lsel.data_ptr(), r_ids.data_ptr(),
        f.data_ptr(), thr.data_ptr(), dl.data_ptr(),
        None if words is None else words.data_ptr(),
        None if is_cat is None else is_cat.data_ptr(), ws, int(num_leaves),
        blocks, count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split_rows kernel launch failed: CUDA error {rc}")
    return leaf_id


#: kernel launches made through :func:`split_rows`, counted on the device
#: by the kernel itself (a replayed graph's too; read by chip_smoke.py)
split_rows.launches = DeviceLaunchCount()
