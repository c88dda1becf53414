"""Packed-forest prediction: the whole ensemble as flat tensors on a device.

Counterpart of ``lightgbm_tpu/serve/packed.py``.  An arbitrary tree slice
is packed into padded tensors keyed on RAW feature values (no dataset, no
bin mappers, so models loaded from text pack the same as trained ones),
with the JAX package's fields, dtypes and pads.  Every row is routed
through every tree in one launch of ``csrc/forest_predict.cu``
(:func:`forest_predict`), which replaces the JAX package's ``lax.scan``
over the padded depth.

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


def _kernel_lib():
    fn = load_library("forest_predict").forest_predict_launch
    if fn.argtypes is None:
        p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        fn.argtypes = [p, i, ll, ll, i, p] + [p] * 10 + [i, p] \
            + [i] * 6 + [f, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def forest_predict(tables: ForestTables, x: torch.Tensor,
                   tid: Optional[torch.Tensor] = None, *, num_model: int,
                   max_depth: int, leaves: bool = False) -> torch.Tensor:
    """Route every row of ``x`` ((R, F) f32 or f64 raw values, rows
    contiguous) through every tree of ``tables`` (tenant ``tid[r]`` for
    row r, tenant 0 without ``tid``).  Returns the (K, R) f32 per-class
    sums of the reached leaf values, tree order, or with ``leaves`` the
    (R, T) int32 leaf indices, padding trees included.

    CUDA tensors launch ``csrc/forest_predict.cu`` (and raise if it cannot
    launch); CPU tensors take :func:`forest_predict_reference`.  ``x``
    must hold every column the tables split on and tenant ids must lie in
    [0, M): the kernel does not check them."""
    dev = x.device
    if dev.type == "cpu":
        return forest_predict_reference(tables, x, tid, num_model=num_model,
                                        max_depth=max_depth, leaves=leaves)
    _check(tables, x, tid, num_model)
    if dev.type != "cuda":
        raise ValueError(f"forest_predict runs on cuda or cpu tensors, got "
                         f"{dev}")
    for name, a in zip(ARRAY_FIELDS + ("tid",), (*tables, tid)):
        if a is not None and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m_, t, n = tables.split_feature.shape
    r = x.shape[0]
    out = (torch.empty((r, t), dtype=torch.int32, device=dev) if leaves
           else torch.empty((num_model, r), dtype=torch.float32, device=dev))
    if r == 0:
        return out
    fn = _kernel_lib()
    tb = tables
    rc = fn(x.data_ptr(), int(x.dtype == torch.float64), r, x.stride(0),
            x.shape[1], None if tid is None else tid.data_ptr(),
            tb.split_feature.data_ptr(), tb.threshold_hi.data_ptr(),
            tb.threshold_lo.data_ptr(), tb.decision_type.data_ptr(),
            tb.left_child.data_ptr(), tb.right_child.data_ptr(),
            tb.cat_start.data_ptr(), tb.cat_len.data_ptr(),
            tb.cat_words.data_ptr(), tb.leaf_value.data_ptr(),
            int(tb.leaf_value.dtype == torch.bfloat16),
            tb.is_stump.data_ptr(), t, n, n + 1, tb.cat_words.shape[1],
            num_model, max_depth, float(K_ZERO),
            None if leaves else out.data_ptr(),
            out.data_ptr() if leaves else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"forest_predict kernel launch failed: CUDA "
                           f"error {rc}")
    forest_predict.launches += 1
    return out


#: kernel launches made through :func:`forest_predict` (read by
#: chip_smoke.py and the card tests)
forest_predict.launches = 0


# ---------------------------------------------------------------------------
# numpy in, numpy out
# ---------------------------------------------------------------------------

def query_tensor(data, num_features: int, device) -> torch.Tensor:
    """A raw query matrix as the (R, num_features) f32 or f64 tensor the
    kernel reads, on ``device``: validated, cut to the pack's columns and
    uploaded as it is (f32 stays f32: the kernel widens it exactly)."""
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
                         max_depth=pe.max_depth)
    return out.cpu().numpy().astype(np.float64)


def predict_leaves(pe: PackedEnsemble, data) -> np.ndarray:
    """Leaf index (rows, num_trees) int32: the packed form of stacking
    ``Tree.predict_leaf`` per tree."""
    n = int(data.shape[0])
    if n == 0 or pe.num_trees == 0:
        return np.zeros((n, pe.num_trees), np.int32)
    x = query_tensor(data, pe.num_features, pe.device)
    out = forest_predict(pe.tables(), x, num_model=pe.num_model,
                         max_depth=pe.max_depth, leaves=True)
    return out[:, :pe.num_trees].cpu().numpy()
