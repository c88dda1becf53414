"""Packed-forest prediction: the whole ensemble as flat tensors on a device.

Counterpart of ``lightgbm_tpu/serve/packed.py``.  An arbitrary tree slice
is packed into padded tensors keyed on RAW feature values (no dataset, no
bin mappers, so models loaded from text pack the same as trained ones),
with the JAX package's fields, dtypes and pads.  Every row is routed
through every tree by ``csrc/forest_predict.cu`` (:func:`forest_predict`),
which replaces the JAX package's ``lax.scan`` over the padded depth.  The
kernel reads a node-record table derived once from the pack
(:func:`forest_records`, cached on the pack): one 16-byte record and one
word a node visit instead of six separate tables.

Thresholds are stored as hi/lo float32 pairs (``hi = f32(t)``, ``lo =
f32(t - hi)``) and query values are split the same way, so the decision
is the JAX package's bit for bit, and the float64 ``v <= t`` of the host
walk unless a value sits within ~2^-49 relative of a threshold.  Leaf
values are summed in float32 in tree order (the JAX program sums in
another order, the host walk in float64: both agree to ~1e-6 relative).

The JAX package pads query rows to a pow2 bucket to bound its jit
compiles; the kernel compiles nothing per shape and the port pads no rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.binning import K_ZERO_THRESHOLD
from ..ops.build import load_library
from ..tree.tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK, Tree
from ..utils.log import LightGBMError

#: K_ZERO_THRESHOLD as the f32 the decision compares against
K_ZERO = np.float32(K_ZERO_THRESHOLD)
#: |value| clamp before the int32 categorical cast (2e9 < 2^31; any real
#: category index that large is out of every bitset's range anyway)
CAT_CLIP = np.float32(2.0e9)
#: (rows x trees) pairs the plain version routes at once
_PLAIN_PAIRS = 1 << 22


def _pow2_at_least(n: int, lo: int = 1) -> int:
    p = max(int(lo), 1)
    while p < n:
        p <<= 1
    return p


def _depth_pad(d: int) -> int:
    """Depth pads to a pow2 (min 8), the JAX package's pad: the kernel's
    loop bound, and part of :meth:`PackedEnsemble.shape_signature`."""
    return _pow2_at_least(int(d), 8) if d > 0 else 0


def _structural_depth(tree: Tree) -> int:
    """Max depth from the children arrays (leaf_depth is not in the model
    text, so it cannot be trusted for loaded trees)."""
    depth = {0: 0}
    max_d = 0
    for node in range(tree.num_leaves - 1):
        d = depth[node] + 1
        for c in (int(tree.left_child[node]), int(tree.right_child[node])):
            if c >= 0:
                depth[c] = d
        max_d = max(max_d, d)
    return max_d


def split_hi_lo(arr64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split float64 into (hi, lo) float32 on the host.  Non-finite hi
    (NaN, or +-inf from f32 overflow) takes lo = 0: hi alone decides."""
    arr64 = np.asarray(arr64, np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        hi = arr64.astype(np.float32)
        lo = np.where(np.isfinite(hi), arr64 - hi.astype(np.float64),
                      0.0).astype(np.float32)
    return hi, lo


def split_hi_lo_torch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`split_hi_lo` in torch ops on ``x``'s device (f32 or f64 in;
    an f32 value widens exactly, so its lo is 0)."""
    x = x.double()
    hi = x.float()
    lo = torch.where(torch.isfinite(hi), (x - hi.double()).float(),
                     torch.zeros((), dtype=torch.float32, device=x.device))
    return hi, lo


class ForestTables(NamedTuple):
    """The kernel's view of a pack: every table with a leading tenant axis
    M ((M, T, N) node tables, (M, W) words, (M, T, L) leaf values, (M, T)
    stump flags); a solo pack is M = 1."""
    split_feature: torch.Tensor
    threshold_hi: torch.Tensor
    threshold_lo: torch.Tensor
    decision_type: torch.Tensor
    left_child: torch.Tensor
    right_child: torch.Tensor
    cat_start: torch.Tensor
    cat_len: torch.Tensor
    cat_words: torch.Tensor
    leaf_value: torch.Tensor
    is_stump: torch.Tensor


ARRAY_FIELDS = ForestTables._fields


class ForestRecords(NamedTuple):
    """The kernel's node-record table, derived from a pack's
    :class:`ForestTables` by :func:`forest_records` (lossless: see
    :func:`decode_records`).

    ``blob`` is (M, T, S) int32, one row of S = :func:`record_words` (N)
    words a tree, 16-byte aligned so that a run of trees is one bulk copy:

    ==============  ==========================================================
    words           contents
    ==============  ==========================================================
    [0, 4N)         node i's hot record at 4i: threshold_hi, threshold_lo (f32
                    bits), left_child, right_child -- one 16-byte load
    [4N, 5N)        split_feature << 4 | decision_type
    [5N, 6N + 1)    leaf values as f32 bits (bf16 values widen exactly)
    6N + 1          is_stump
    ==============  ==========================================================

    ``cat`` is (M, T, N, 2) int32 (cat_start, cat_len): only categorical
    nodes read it.  ``cat_words`` is the pack's own tensor.  ``live`` is
    (M,) int32: the trees of each tenant up to its last one that is not a
    stump of leaf value 0 (the padding of the tree pad and of a fleet's
    smaller tenants); the rest add +0 and reach leaf 0, and the kernel's
    rows route neither copies nor walks them."""
    blob: torch.Tensor
    cat: torch.Tensor
    cat_words: torch.Tensor
    live: torch.Tensor


#: decision_type keeps bits 0-3 (categorical, default left, missing type)
_DT_BITS = 4
#: split_feature must stay below this to share a word with decision_type
MAX_SPLIT_FEATURE = 1 << (31 - _DT_BITS)


def record_words(nodes: int) -> int:
    """Words of one tree's row of :attr:`ForestRecords.blob`: 4N record
    words, N feature/decision words, N + 1 leaf values and the stump flag,
    rounded up to 16 bytes."""
    return (6 * int(nodes) + 2 + 3) // 4 * 4


def forest_records(tables: ForestTables) -> ForestRecords:
    """The node-record table of ``tables``, built with torch ops on their
    device.  Raises if a field does not fit its slot (a split feature of
    2^27 or more, a decision type outside 0-15), so the table never loses
    what the pack holds."""
    m_, t, n = tables.split_feature.shape
    sf, dt = tables.split_feature, tables.decision_type
    if sf.numel():
        lo_f, hi_f, lo_d, hi_d = torch.stack(
            [sf.min(), sf.max(), dt.min(), dt.max()]).tolist()
        if lo_f < 0 or hi_f >= MAX_SPLIT_FEATURE:
            raise LightGBMError(
                f"split features must lie in [0, {MAX_SPLIT_FEATURE}) for "
                f"the node records; got [{lo_f}, {hi_f}]")
        if lo_d < 0 or hi_d >= 1 << _DT_BITS:
            raise LightGBMError(
                f"decision types must lie in [0, {1 << _DT_BITS}); got "
                f"[{lo_d}, {hi_d}]")
    blob = torch.zeros((m_, t, record_words(n)), dtype=torch.int32,
                       device=sf.device)
    hot = torch.stack([tables.threshold_hi.view(torch.int32),
                       tables.threshold_lo.view(torch.int32),
                       tables.left_child, tables.right_child], dim=-1)
    blob[..., :4 * n] = hot.reshape(m_, t, 4 * n)
    blob[..., 4 * n:5 * n] = (sf << _DT_BITS) | dt
    blob[..., 5 * n:6 * n + 1] = tables.leaf_value.float().view(torch.int32)
    blob[..., 6 * n + 1] = tables.is_stump.to(torch.int32)
    cat = torch.stack([tables.cat_start, tables.cat_len], dim=-1)
    pad = tables.is_stump & (tables.leaf_value[..., 0].float() == 0)
    live = torch.where(pad, 0, torch.arange(1, t + 1, device=sf.device)) \
        .amax(dim=1).to(torch.int32)
    return ForestRecords(blob, cat.contiguous(), tables.cat_words, live)


def decode_records(rec: ForestRecords,
                   value_dtype=torch.float32) -> ForestTables:
    """The plain inverse of :func:`forest_records`: the pack's tables, leaf
    values narrowed to ``value_dtype`` (exact for a bf16 pack)."""
    m_, t, _ = rec.blob.shape
    n = rec.cat.shape[2]
    hot = rec.blob[..., :4 * n].reshape(m_, t, n, 4)
    word = rec.blob[..., 4 * n:5 * n]
    as_f32 = lambda a: a.contiguous().view(torch.float32)
    return ForestTables(
        split_feature=word >> _DT_BITS, threshold_hi=as_f32(hot[..., 0]),
        threshold_lo=as_f32(hot[..., 1]),
        decision_type=word & ((1 << _DT_BITS) - 1),
        left_child=hot[..., 2].contiguous(),
        right_child=hot[..., 3].contiguous(),
        cat_start=rec.cat[..., 0].contiguous(),
        cat_len=rec.cat[..., 1].contiguous(), cat_words=rec.cat_words,
        leaf_value=as_f32(rec.blob[..., 5 * n:6 * n + 1]).to(value_dtype),
        is_stump=rec.blob[..., 6 * n + 1] != 0)


@dataclasses.dataclass(frozen=True)
class PackedEnsemble:
    """An ensemble slice as padded tensors on one device.

    T = padded tree count (padded iterations x num_model, iteration-major
    like ``GBDT.models``), N = padded internal-node count, L = N + 1,
    W = padded categorical bitset words:

    ================  ===========  =========================================
    field             shape/dtype  contents
    ================  ===========  =========================================
    split_feature     (T,N) i32    raw feature index per node
    threshold_hi/lo   (T,N) f32    float64 threshold as a hi/lo f32 pair
    decision_type     (T,N) i32    bit0 cat, bit1 default_left, bits2-3
                                   missing type (reference encoding)
    left/right_child  (T,N) i32    child node; negative = ~leaf
    cat_start/len     (T,N) i32    slice of ``cat_words`` per cat node
    cat_words         (W,)  u32    all trees' raw-category bitsets, packed
    leaf_value        (T,L) f32    shrinkage-applied leaf outputs
    is_stump          (T,)  bool   single-leaf trees (and tree padding)
    ================  ===========  =========================================
    """

    split_feature: torch.Tensor
    threshold_hi: torch.Tensor
    threshold_lo: torch.Tensor
    decision_type: torch.Tensor
    left_child: torch.Tensor
    right_child: torch.Tensor
    cat_start: torch.Tensor
    cat_len: torch.Tensor
    cat_words: torch.Tensor
    leaf_value: torch.Tensor
    is_stump: torch.Tensor
    num_model: int = 1
    max_depth: int = 0
    num_trees: int = 0          # real (unpadded) tree count
    num_features: int = 1       # columns a query matrix must provide

    @property
    def device(self) -> torch.device:
        return self.split_feature.device

    @property
    def num_iterations(self) -> int:
        return self.num_trees // max(self.num_model, 1)

    def shape_signature(self) -> tuple:
        """Hashable pad signature (the JAX package's: equal signatures
        reuse its compiled programs; the port compiles nothing per shape
        and uses it to tell whether a tenant pack fits a fleet)."""
        return (tuple(self.split_feature.shape),
                tuple(self.leaf_value.shape), tuple(self.cat_words.shape),
                self.num_model, self.max_depth, self.num_features)

    def tables(self) -> ForestTables:
        return ForestTables(*(getattr(self, f).unsqueeze(0)
                              for f in ARRAY_FIELDS))

    @functools.cached_property
    def records(self) -> ForestRecords:
        """The kernel's node records (:func:`forest_records`), built on
        first use and kept with the pack (its tensors never change)."""
        return forest_records(self.tables())


def tree_slice(models: List[Tree], num_model: int,
               start_iteration: int = 0,
               num_iteration: int = -1) -> List[Tree]:
    """The served tree slice ``models[start*K : end*K]`` (K =
    ``num_model``), with the clamping every consumer agrees on."""
    k = max(int(num_model), 1)
    total_iter = len(models) // k
    start = max(0, min(int(start_iteration), total_iter))
    end = total_iter if num_iteration <= 0 \
        else min(start + int(num_iteration), total_iter)
    return models[start * k:end * k]


def pack_ensemble(models: List[Tree], num_model: int,
                  start_iteration: int = 0, num_iteration: int = -1,
                  num_features: Optional[int] = None,
                  device="cuda") -> PackedEnsemble:
    """Flatten ``models[start*K : end*K]`` (K = ``num_model``) into a
    :class:`PackedEnsemble` on ``device``, from the host ``Tree`` objects
    alone."""
    k = max(int(num_model), 1)
    trees = tree_slice(models, num_model, start_iteration, num_iteration)
    n_iter = len(trees) // k

    t_pad = _pow2_at_least(max(n_iter, 1)) * k
    max_nodes = max([t.num_leaves - 1 for t in trees] or [0])
    n_pad = _pow2_at_least(max(max_nodes, 1))
    depth = max([_structural_depth(t) for t in trees] or [0])

    sf = np.zeros((t_pad, n_pad), np.int32)
    thi = np.zeros((t_pad, n_pad), np.float32)
    tlo = np.zeros((t_pad, n_pad), np.float32)
    dt = np.zeros((t_pad, n_pad), np.int32)
    lc = np.full((t_pad, n_pad), -1, np.int32)
    rc = np.full((t_pad, n_pad), -1, np.int32)
    cstart = np.zeros((t_pad, n_pad), np.int32)
    clen = np.zeros((t_pad, n_pad), np.int32)
    lv = np.zeros((t_pad, n_pad + 1), np.float32)
    stump = np.ones(t_pad, bool)
    words: List[int] = []
    max_split_f = -1

    for ti, tree in enumerate(trees):
        n = tree.num_leaves - 1
        if n <= 0:
            # a real stump: only leaf 0's value (the bias) contributes
            lv[ti, 0] = np.float32(tree.leaf_value[0])
            continue
        stump[ti] = False
        sf[ti, :n] = tree.split_feature[:n]
        max_split_f = max(max_split_f, int(tree.split_feature[:n].max()))
        thi[ti, :n], tlo[ti, :n] = split_hi_lo(tree.threshold[:n])
        dt[ti, :n] = tree.decision_type[:n].astype(np.int32)
        lc[ti, :n] = tree.left_child[:n]
        rc[ti, :n] = tree.right_child[:n]
        lv[ti, :tree.num_leaves] = \
            tree.leaf_value[:tree.num_leaves].astype(np.float32)
        if tree.num_cat > 0:
            for node in range(n):
                if not int(tree.decision_type[node]) & K_CATEGORICAL_MASK:
                    continue
                cat_idx = int(tree.threshold[node])
                wlo = tree.cat_boundaries[cat_idx]
                whi = tree.cat_boundaries[cat_idx + 1]
                cstart[ti, node] = len(words)
                clen[ti, node] = whi - wlo
                words.extend(int(w) for w in tree.cat_threshold[wlo:whi])

    cat_words = np.zeros(_pow2_at_least(max(len(words), 1)), np.uint32)
    cat_words[:len(words)] = np.asarray(words, np.uint32)

    nf = int(num_features) if num_features else max(max_split_f + 1, 1)
    if nf <= max_split_f:
        raise LightGBMError(
            f"num_features={nf} is smaller than the ensemble's highest "
            f"split feature index {max_split_f}")
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(a).to(dev)
    # uint32 moves as its int32 bits: a view is all a backend has to offer
    words_t = as_t(cat_words.view(np.int32)).view(torch.uint32)
    return PackedEnsemble(
        as_t(sf), as_t(thi), as_t(tlo), as_t(dt), as_t(lc), as_t(rc),
        as_t(cstart), as_t(clen), words_t, as_t(lv), as_t(stump),
        num_model=k, max_depth=_depth_pad(depth), num_trees=len(trees),
        num_features=nf)


def pack_gbdt(gbdt, start_iteration: int = 0, num_iteration: int = -1,
              device="cuda") -> PackedEnsemble:
    """Pack a ``GBDT`` (trained or loaded from text: only ``models``,
    ``num_model`` and ``max_feature_idx`` are read) onto ``device``."""
    gbdt._flush_pending()
    return pack_ensemble(gbdt.models, gbdt.num_model,
                         start_iteration=start_iteration,
                         num_iteration=num_iteration,
                         num_features=gbdt.max_feature_idx + 1,
                         device=device)


# ---------------------------------------------------------------------------
# the plain PyTorch version of the traversal
# ---------------------------------------------------------------------------

def route_left(dt, thi, tlo, cat_len, fetch_word, vhi, vlo):
    """Goes-left from per-(row, tree) gathered node tables: the reference
    decision semantics (missing modes, zero threshold, hi/lo lexicographic
    compare, categorical bitsets) as the JAX package's ``route_left`` has
    them.  ``fetch_word(widx)`` gathers the bitset word at an in-range
    word index, as int64."""
    dev = vhi.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    is_cat = (dt & K_CATEGORICAL_MASK) != 0
    default_left = (dt & K_DEFAULT_LEFT_MASK) != 0
    missing = (dt >> 2) & 3
    nan_v = torch.isnan(vhi)
    zhi = torch.where(nan_v & (missing != 2), zero, vhi)
    zlo = torch.where(nan_v, zero, vlo)
    k_zero = torch.tensor(K_ZERO, device=dev)
    is_miss = ((missing == 1) & (zhi.abs() <= k_zero)) \
        | ((missing == 2) & nan_v)
    le = (zhi < thi) | ((zhi == thi) & (zlo <= tlo))
    left_num = torch.where(is_miss, default_left, le)

    # categorical: iv = trunc-toward-zero int of the raw value (exact via
    # the hi/lo pair: when hi is integral the sign of lo says whether the
    # true value sits just below or above it), -1 for NaN with NaN
    # missing-handling, 0 for NaN otherwise
    clip = torch.tensor(CAT_CLIP, device=dev)
    zc = torch.minimum(torch.maximum(zhi, -clip), clip)
    iv0 = zc.to(torch.int32)
    integral = zc == iv0.to(torch.float32)
    iv = iv0 - (integral & (zc > 0) & (zlo < 0)).to(torch.int32) \
        + (integral & (zc < 0) & (zlo > 0)).to(torch.int32)
    iv = torch.where(nan_v, torch.where(missing == 2, -1, 0).to(torch.int32),
                     iv)
    widx = iv >> 5
    in_range = (iv >= 0) & (widx < cat_len)
    word = fetch_word(torch.where(in_range, widx, 0))
    bit = ((word >> (iv & 31).to(torch.int64)) & 1) == 1
    return torch.where(is_cat, in_range & bit, left_num)


def _traverse(tables: ForestTables, tid, xhi, xlo, max_depth: int):
    """(R, T) int32 leaf per (row, tree): every pair advances one level a
    step, up to ``max_depth`` steps, finished pairs (negative node =
    ~leaf) staying put; ``tid`` is the (R,) tenant of each row."""
    _, t, n = tables.split_feature.shape
    w = tables.cat_words.shape[1]
    dev = xhi.device
    tid = tid.to(torch.int64)
    tree = tid[:, None] * t + torch.arange(t, device=dev)[None, :]
    base = tree * n                                           # (R, T)
    wbase = (tid * w)[:, None]
    r_ix = torch.arange(xhi.shape[0], device=dev)[:, None]
    flat = {f: getattr(tables, f).reshape(-1) for f in ARRAY_FIELDS}
    words = flat["cat_words"].view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    node = torch.where(flat["is_stump"][tree], -1, 0).to(torch.int32)
    for _ in range(max_depth):
        act = node >= 0
        if not bool(act.any()):
            break
        i = base + node.clamp(min=0)
        sf = flat["split_feature"][i].to(torch.int64)
        start = flat["cat_start"][i]
        left = route_left(
            flat["decision_type"][i], flat["threshold_hi"][i],
            flat["threshold_lo"][i], flat["cat_len"][i],
            lambda widx: words[wbase + (start + widx).to(torch.int64)],
            xhi[r_ix, sf], xlo[r_ix, sf])
        nxt = torch.where(left, flat["left_child"][i],
                          flat["right_child"][i])
        node = torch.where(act, nxt, node)
    return ~node


def forest_predict_reference(tables: ForestTables, x: torch.Tensor,
                             tid: Optional[torch.Tensor] = None, *,
                             num_model: int, max_depth: int,
                             leaves: bool = False) -> torch.Tensor:
    """The plain PyTorch version of :func:`forest_predict`: the JAX
    package's lattice walk in chunks of rows, and the per-class sums of
    the gathered f32 leaf values in tree order."""
    _check(tables, x, tid, num_model)
    r = x.shape[0]
    m_, t, n = tables.split_feature.shape
    dev = x.device
    if tid is None:
        tid = torch.zeros(r, dtype=torch.int32, device=dev)
    out = (torch.empty((r, t), dtype=torch.int32, device=dev) if leaves
           else torch.zeros((num_model, r), dtype=torch.float32,
                            device=dev))
    leaf_value = tables.leaf_value.reshape(m_ * t, n + 1)
    step = max(1, _PLAIN_PAIRS // max(t, 1))
    for lo in range(0, r, step):
        hi = min(r, lo + step)
        xhi, xlo = split_hi_lo_torch(x[lo:hi])
        tt = tid[lo:hi]
        lv = _traverse(tables, tt, xhi, xlo, max_depth)
        if leaves:
            out[lo:hi] = lv
            continue
        tree = tt.to(torch.int64)[:, None] * t \
            + torch.arange(t, device=dev)[None, :]
        vals = leaf_value[tree, lv.to(torch.int64)].to(torch.float32)
        acc = out[:, lo:hi]
        for j in range(t):
            acc[j % num_model] += vals[:, j]
    return out


def _check(tables: ForestTables, x, tid, num_model: int) -> None:
    m_, t, n = tables.split_feature.shape
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x must be 2-D float32 or float64, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.stride(1) != 1:
        raise ValueError("x must have contiguous rows")
    if num_model < 1 or t % num_model:
        raise ValueError(f"tree pad {t} is not a multiple of num_model "
                         f"{num_model}")
    if tables.leaf_value.shape != (m_, t, n + 1) or tables.leaf_value.dtype \
            not in (torch.float32, torch.bfloat16):
        raise ValueError("leaf_value must be (M, T, N + 1) f32 or bf16")
    if tid is not None and (tid.shape != (x.shape[0],)
                            or tid.dtype != torch.int32):
        raise ValueError(f"tenant ids must be ({x.shape[0]},) int32")
    devs = {x.device} | {a.device for a in tables} \
        | ({tid.device} if tid is not None else set())
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


# ---------------------------------------------------------------------------
# the launch geometry: csrc/forest_predict.cu takes its numbers from here
# ---------------------------------------------------------------------------

#: shared memory one block may use (H100: 227 KB), and what one SM holds
#: (228 KB, of which every resident block reserves 1 KB)
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
#: threads of a block (the rows route: one row a thread)
MAX_THREADS = 256
#: walks a trees-route thread advances at once (the kernel's kTreeWalks)
TREE_WALKS = 2
#: trees of the largest shared-memory chunk, and of a chunk read from
#: global memory (where the chunk only sizes the leaves tile)
MAX_CHUNK_TREES = 64
GLOBAL_CHUNK_TREES = 32
#: the fewest trees a chunk must hold before more blocks an SM are
#: preferred to fewer blocks with larger chunks
MIN_CHUNK_TREES = 4
#: resident rows-route rows an SM the geometry aims for (1024 threads: the
#: registers of 256-thread blocks at up to 64 a thread), and the blocks an
#: SM it considers
ROWS_PER_SM = 1024
MAX_BLOCKS_PER_SM = 8
#: the rows route groups a fleet's rows by tenant up to this many tenants
#: (one shared-memory counter each), counting GROUP_ROWS rows a block
MAX_GROUP_TENANTS = 4096
GROUP_ROWS = 8192
MAX_GROUP_BLOCKS = 256
#: the trees route keeps a block's shared memory under TREES_SMEM_BUDGET
#: where it can
TREES_SMEM_BUDGET = 48 * 1024
#: the route crossovers (choose_route), measured on the card by
#: scripts/compare_forest_cuda.py --sweep over forests of 4 to 512 trees
#: of 16 to 256 padded nodes and rows of 112 to 2400 bytes (PERF.md): the
#: trees route wins up to TREES_ROUTE_ROWS_PER_SM rows an SM; where a row
#: has WIDE_ROW_BYTES_PER_TREE bytes or more for each tree, to
#: WIDE_ROWS_PER_SM_PER_BYTE more rows an SM for each byte a tree past
#: that, and at every size if the rows route then keeps at most
#: FEW_RESIDENT_ROWS rows resident an SM; the rows route wins requests of
#: at most SMALL_REQUEST_PAIRS (row, tree) pairs against
#: SMALL_FOREST_TREES trees or fewer
TREES_ROUTE_ROWS_PER_SM = 128
WIDE_ROW_BYTES_PER_TREE = 32
WIDE_ROWS_PER_SM_PER_BYTE = 48
FEW_RESIDENT_ROWS = 384
SMALL_FOREST_TREES = 16
SMALL_REQUEST_PAIRS = 64


class ForestGeometry(NamedTuple):
    """One launch of the forest kernel.  ``route`` "rows": a thread walks
    one row through every tree, ``rows_per_block`` rows a block, the
    trees in chunks of ``chunk_trees`` (copied into shared memory when
    ``smem_trees``, a fleet's rows grouped by tenant first by
    ``group_blocks`` counting blocks), the rows staged in shared memory
    when ``stage_rows``.  ``route`` "trees": ``threads /
    rows_per_block`` threads share each row and walk its trees in passes
    of ``chunk_trees`` trees, then one thread a class sums a pass's
    values in tree order."""
    route: str
    threads: int
    rows_per_block: int
    chunk_trees: int
    smem_trees: bool
    stage_rows: bool
    group_blocks: int
    smem_bytes: int
    grid: int


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def rows_smem_bytes(rows_per_block: int, chunk_trees: int, tree_words: int,
                    nf: int, x_bytes: int, num_model: int, leaves: bool,
                    smem_trees: bool, stage_rows: bool) -> int:
    """Dynamic shared memory of a rows-route block, laid out as the kernel
    lays it out: a two-chunk ring of tree rows and its two mbarriers, the
    staged rows (row-major at an odd pitch of ``nf | 1`` values: (hi, lo)
    pairs of f64 rows, hi alone of f32 rows), then the leaves tile (rows x
    odd pitch) or the per-class sums (scores, K > 1)."""
    b = 2 * chunk_trees * tree_words * 4 + 16 if smem_trees else 0
    if stage_rows:
        b += (nf | 1) * rows_per_block * x_bytes
    if leaves:
        b += rows_per_block * (chunk_trees | 1) * 4
    elif num_model > 1:
        b += num_model * rows_per_block * 4
    return b


def trees_smem_bytes(rows_per_block: int, pass_trees: int, nf: int,
                     x_bytes: int, num_model: int, leaves: bool) -> int:
    """Dynamic shared memory of a trees-route block: the staged rows (as
    the rows route stages them), then (scores) each row's leaf value of
    every tree of a pass and its per-class sums."""
    b = rows_per_block * (nf | 1) * x_bytes
    if not leaves:
        b += rows_per_block * (pass_trees + num_model) * 4
    return b


def _trees_geometry(rows, trees, nf, x_bytes, num_model, leaves):
    lanes = min(MAX_THREADS, _pow2_at_least(_cdiv(trees, TREE_WALKS)))
    g = min(MAX_THREADS // lanes, _pow2_at_least(rows))
    smem = functools.partial(trees_smem_bytes, g, nf=nf, x_bytes=x_bytes,
                             num_model=num_model, leaves=leaves)
    # every tree in one pass where that stays within the budget
    least = min(trees, lanes * TREE_WALKS)
    pass_trees = trees
    while pass_trees > least and smem(pass_trees) > TREES_SMEM_BUDGET:
        pass_trees = max(least, _cdiv(pass_trees, 2))
    if smem(pass_trees) > SMEM_PER_BLOCK:
        return None
    return ForestGeometry("trees", lanes * g, g, pass_trees, False, True, 0,
                          smem(pass_trees), _cdiv(rows, g))


def _rows_geometry(rows, trees, nodes, nf, x_bytes, num_model, leaves,
                   tenants):
    s = record_words(nodes)
    rb_max = min(MAX_THREADS, max(32, _pow2_at_least(rows)))
    sizes = [rb_max >> i for i in range(8) if rb_max >> i >= 32]
    smem = functools.partial(rows_smem_bytes, tree_words=s, nf=nf,
                             x_bytes=x_bytes, num_model=num_model,
                             leaves=leaves)

    def chunk(rb, budget):
        # the largest chunk within budget (the leaves tile's odd pitch may
        # add one column)
        tile = rb * 4 if leaves else 0
        fixed = smem(rb, 0, smem_trees=True, stage_rows=True) + tile
        per_tree = 2 * s * 4 + tile
        return min(trees, MAX_CHUNK_TREES, (budget - fixed) // per_tree)

    if tenants <= MAX_GROUP_TENANTS:
        # the most resident rows an SM (up to ROWS_PER_SM), then the most
        # rows a block, then the largest chunk: a chunk of fewer than
        # MIN_CHUNK_TREES trees only where no larger one fits
        best = None
        for rb in sizes:
            for blocks in range(MAX_BLOCKS_PER_SM, 0, -1):
                budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // blocks - 1024)
                c = chunk(rb, budget)
                least = min(trees, MIN_CHUNK_TREES) if blocks > 1 else 1
                if c >= least:
                    key = (min(blocks * rb, ROWS_PER_SM), rb, c)
                    best = max(best or key, key)
                    break
        if best is not None:
            _, rb, c = best
            gb = (min(MAX_GROUP_BLOCKS, _cdiv(rows, GROUP_ROWS))
                  if tenants > 1 else 0)
            return ForestGeometry(
                "rows", rb, rb, c, True, True, gb,
                smem(rb, c, smem_trees=True, stage_rows=True),
                _cdiv(rows, rb) + (tenants if gb else 0))
    # the trees from global memory: the rows staged if they fit
    c = min(trees, GLOBAL_CHUNK_TREES)
    for stage in (True, False):
        for rb in sizes:
            b = smem(rb, c, smem_trees=False, stage_rows=stage)
            if b <= SMEM_PER_BLOCK:
                return ForestGeometry("rows", rb, rb, c, False, stage, 0, b,
                                      _cdiv(rows, rb))
    return None


def choose_route(rows: int, trees: int, row_bytes: int, resident: int,
                 sm_count: int) -> str:
    """The faster route for ``rows`` query rows of ``row_bytes`` bytes over
    ``trees`` padded trees, where the rows route would keep ``resident``
    rows an SM, on a card of ``sm_count`` SMs: from the crossovers
    measured (the constants above).

    The rows route walks a row's trees one after another in one thread:
    a block takes about the time of its deepest lane through every tree,
    plus its row stage, so it is flat in the batch size until the card is
    full.  The trees route spreads a row's trees over a block: it costs
    one walk's latency and an ordered sum, then grows with rows x trees.
    A few rows against a few trees are faster walked in one thread; the
    trees route then wins until the rows route has ~128 rows an SM, or,
    where the rows route spends its time staging rows that are wide for
    the forest, longer the wider they are, and at every size where those
    rows (or large trees) leave it few rows resident."""
    if trees <= SMALL_FOREST_TREES and rows * trees <= SMALL_REQUEST_PAIRS:
        return "rows"
    limit = TREES_ROUTE_ROWS_PER_SM
    if row_bytes >= WIDE_ROW_BYTES_PER_TREE * trees:
        if resident <= FEW_RESIDENT_ROWS:
            return "trees"
        limit += (WIDE_ROWS_PER_SM_PER_BYTE
                  * (row_bytes - WIDE_ROW_BYTES_PER_TREE * trees) // trees)
    return "trees" if rows <= limit * sm_count else "rows"


def resident_rows(geo: ForestGeometry) -> int:
    """Rows of a rows-route launch resident on an SM at once (as
    _rows_geometry counts them)."""
    blocks = min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (geo.smem_bytes + 1024))
    return min(geo.rows_per_block * blocks, ROWS_PER_SM)


@functools.lru_cache(maxsize=4096)   # a server's request sizes repeat
def forest_geometry(rows: int, trees: int, nodes: int, nf: int, x_f64: bool,
                    leaves: bool, num_model: int, tenants: int = 1,
                    sm_count: int = 132,
                    route: Optional[str] = None) -> ForestGeometry:
    """The launch of the forest kernel for ``rows`` query rows of ``nf``
    columns (f64 or f32) over ``trees`` padded trees of ``nodes`` padded
    nodes a tenant, ``tenants`` tenants in the batch.

    :func:`choose_route` picks the route (small batches: the trees
    route, a row's trees spread over a block; larger ones the rows route,
    with the rows a block and the tree chunk that keep the most rows
    resident on an SM).  ``route`` forces one (for measurements; the
    wrapper never passes it).  Never more than SMEM_PER_BLOCK bytes of
    shared memory."""
    x_bytes = 8 if x_f64 else 4
    if route not in (None, "rows", "trees"):
        raise ValueError(f"unknown route {route!r}")
    rows_geo = _rows_geometry(rows, trees, nodes, nf, x_bytes, num_model,
                              leaves, tenants)
    if route is None:
        route = ("trees" if rows_geo is None else choose_route(
            rows, trees, nf * x_bytes, resident_rows(rows_geo), sm_count))
    if route == "trees":
        geo = _trees_geometry(rows, trees, nf, x_bytes, num_model, leaves)
        if geo is not None:
            return geo
    if rows_geo is None:
        raise LightGBMError(f"no forest_predict launch fits {num_model} "
                            f"classes in {SMEM_PER_BLOCK} bytes of shared "
                            f"memory")
    return rows_geo


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_lib():
    fn = load_library("forest_predict").forest_predict_launch
    if fn.argtypes is None:
        p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        fn.argtypes = [p, i, ll, ll, i, p, i, p, p, p, p] + [i] * 6 + [f] \
            + [i] * 9 + [p] * 4
        fn.restype = ctypes.c_int
    return fn


def _check_records(rec: ForestRecords, tables: ForestTables) -> None:
    m_, t, n = tables.split_feature.shape
    if (rec.blob.shape != (m_, t, record_words(n))
            or rec.cat.shape != (m_, t, n, 2)
            or rec.live.shape != (m_,)
            or rec.blob.dtype != torch.int32 or rec.cat.dtype != torch.int32
            or rec.live.dtype != torch.int32
            or not (rec.blob.is_contiguous() and rec.cat.is_contiguous())
            or rec.blob.data_ptr() % 16):
        raise ValueError("records do not match the tables (build them with "
                         "forest_records)")


def forest_predict(tables: ForestTables, x: torch.Tensor,
                   tid: Optional[torch.Tensor] = None, *, num_model: int,
                   max_depth: int, leaves: bool = False,
                   records: Optional[ForestRecords] = None) -> torch.Tensor:
    """Route every row of ``x`` ((R, F) f32 or f64 raw values, rows
    contiguous) through every tree of ``tables`` (tenant ``tid[r]`` for
    row r, tenant 0 without ``tid``).  Returns the (K, R) f32 per-class
    sums of the reached leaf values, tree order, or with ``leaves`` the
    (R, T) int32 leaf indices, padding trees included.

    CUDA tensors launch ``csrc/forest_predict.cu`` on the route
    :func:`forest_geometry` picks (and raise if it cannot launch); CPU
    tensors take :func:`forest_predict_reference`.  ``records`` are the
    tables' node records (:func:`forest_records`; a pack caches them),
    built here when not given.  ``x`` must hold every column the tables
    split on and tenant ids must lie in [0, M): the kernel does not check
    them."""
    dev = x.device
    if dev.type == "cpu":
        return forest_predict_reference(tables, x, tid, num_model=num_model,
                                        max_depth=max_depth, leaves=leaves)
    _check(tables, x, tid, num_model)
    if dev.type != "cuda":
        raise ValueError(f"forest_predict runs on cuda or cpu tensors, got "
                         f"{dev}")
    if records is None:
        records = forest_records(tables)
    _check_records(records, tables)
    m_, t, n = tables.split_feature.shape
    geo = forest_geometry(
        x.shape[0], t, n, x.shape[1], x.dtype == torch.float64, leaves,
        num_model, tenants=m_ if tid is not None else 1,
        sm_count=_sm_count(dev.index))
    return launch_forest(records, x, tid, geo, num_model=num_model,
                         max_depth=max_depth, leaves=leaves)


def launch_forest(records: ForestRecords, x: torch.Tensor,
                  tid: Optional[torch.Tensor], geo: ForestGeometry, *,
                  num_model: int, max_depth: int,
                  leaves: bool = False) -> torch.Tensor:
    """One launch of the kernel at geometry ``geo`` (what
    :func:`forest_predict` does after choosing it; called directly only
    to time a forced route).  Counts the launch and its route."""
    dev = x.device
    m_, t, s = records.blob.shape
    n = records.cat.shape[2]
    if tid is not None and not tid.is_contiguous():
        raise ValueError("tid must be contiguous")
    r = x.shape[0]
    out = (torch.empty((r, t), dtype=torch.int32, device=dev) if leaves
           else torch.empty((num_model, r), dtype=torch.float32, device=dev))
    if r == 0:
        return out
    groups = m_ if geo.group_blocks else 0
    scratch = (torch.empty(r + 2 * (groups + 1) + geo.group_blocks * groups,
                           dtype=torch.int32, device=dev) if groups else None)
    rc = _kernel_lib()(
        x.data_ptr(), int(x.dtype == torch.float64), r, x.stride(0),
        x.shape[1], None if tid is None else tid.data_ptr(), m_,
        records.blob.data_ptr(), records.cat.data_ptr(),
        records.cat_words.data_ptr(), records.live.data_ptr(), t, n, s,
        records.cat_words.shape[-1],
        num_model, max_depth, float(K_ZERO), int(geo.route == "trees"),
        geo.threads, geo.rows_per_block, geo.chunk_trees,
        int(geo.smem_trees), int(geo.stage_rows), geo.group_blocks,
        geo.smem_bytes, geo.grid,
        None if scratch is None else scratch.data_ptr(),
        None if leaves else out.data_ptr(),
        out.data_ptr() if leaves else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"forest_predict kernel launch failed: CUDA "
                           f"error {rc} ({geo})")
    with _COUNT_LOCK:
        forest_predict.launches += 1
        forest_predict.routes[geo.route] += 1
    return out


#: kernel launches made through :func:`forest_predict`, in all and by
#: route (read by chip_smoke.py and the card tests); a server's threads
#: launch concurrently, so the counts change under a lock
forest_predict.launches = 0
forest_predict.routes = {"rows": 0, "trees": 0}
_COUNT_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# numpy in, numpy out
# ---------------------------------------------------------------------------

def query_tensor(data, num_features: int, device) -> torch.Tensor:
    """A raw query matrix as the (R, num_features) f32 or f64 tensor the
    kernel reads, on ``device``: validated, cut to the pack's columns and
    uploaded as it is (f32 stays f32: the kernel widens it exactly).  A
    tensor is read where it lies when that is ``device``."""
    if isinstance(data, torch.Tensor):
        x = data if data.dtype in (torch.float32, torch.float64) \
            else data.double()
        if x.dim() != 2:
            raise LightGBMError("query data must be 2-dimensional")
        if x.shape[1] < num_features:
            raise LightGBMError(
                f"query data has {x.shape[1]} features but the packed "
                f"ensemble needs {num_features}")
        return x[:, :num_features].contiguous().to(device)
    x = np.asarray(data)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    if x.ndim != 2:
        raise LightGBMError("query data must be 2-dimensional")
    if x.shape[1] < num_features:
        raise LightGBMError(
            f"query data has {x.shape[1]} features but the packed "
            f"ensemble needs {num_features}")
    return torch.from_numpy(np.ascontiguousarray(x[:, :num_features])) \
        .to(device)


def predict_scores(pe: PackedEnsemble, data) -> np.ndarray:
    """Raw scores (num_model, rows) float64 for a raw query matrix: one
    kernel launch whatever the tree count or batch size."""
    n = int(data.shape[0])
    if n == 0 or pe.num_trees == 0:
        return np.zeros((pe.num_model, n), np.float64)
    x = query_tensor(data, pe.num_features, pe.device)
    out = forest_predict(pe.tables(), x, num_model=pe.num_model,
                         max_depth=pe.max_depth, records=pe.records)
    return out.cpu().numpy().astype(np.float64)


def predict_leaves(pe: PackedEnsemble, data) -> np.ndarray:
    """Leaf index (rows, num_trees) int32: the packed form of stacking
    ``Tree.predict_leaf`` per tree."""
    n = int(data.shape[0])
    if n == 0 or pe.num_trees == 0:
        return np.zeros((n, pe.num_trees), np.int32)
    x = query_tensor(data, pe.num_features, pe.device)
    out = forest_predict(pe.tables(), x, num_model=pe.num_model,
                         max_depth=pe.max_depth, leaves=True,
                         records=pe.records)
    return out[:, :pe.num_trees].cpu().numpy()
