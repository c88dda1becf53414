"""The wave histogram: two hand-written Hopper kernels and their plain
version.

Counterpart of ``lightgbm_tpu/ops/hist_pallas.py`` (``wave_hist_pallas``
and ``wave_hist_pallas_v2``).  All compute, for a wave of W pending
leaves::

    out[g*NB + b, k, w] = sum of ghk[r, k] over rows r with
                          binned_t[g, r] == b and leaf_id[r] == pending[w]

returning ``(G*NB, K, W)`` float32 (bf16 or f32 stat columns) or int32
(int8 stat columns), the layout of ``wave_hist_pallas``.  Non-negative
``pending`` entries are distinct leaf ids; a slot whose entry is negative
is empty and stays zero.  (The TPU kernel's equality mask would gather
the rows of leaf -1 there, the bucket padding, whose stats the grower
zeroes: same result.)

:func:`wave_hist` launches ``csrc/wave_hist.cu`` for CUDA tensors and takes
the plain version :func:`wave_hist_reference` only for CPU tensors.  The
kernel accumulates bf16 and f32 stats in int64 fixed point (one
power-of-two scale per stat column, :func:`hist_scale_exponents`), so its
f32 result is the exactly rounded sum of the fixed-point values,
bit-identical run to run (an f32 stat keeps its bits above the column's
scale; a bf16 one keeps all of them); the plain version sums in f32 in
``index_add_`` order.  The two therefore agree to f32 summation error, not
bit for bit; int8 stats agree exactly.  A striped layout (K=4 or 6: each
of g, h or the count in two columns, rows split between them) keeps every
column's sum inside its accumulator; the int8 guard counts the rows of
one column (``col_rows``), not of the call.

:func:`wave_hist_rows` is the host learner's one-slot histogram: the same
kernel over a caller's row list (a leaf's window of the partition
buffer) in place of the wave's sorted list, with full-f32 stat columns
(``lightgbm_tpu/tree/learner.py::_window_histogram``).  Its plain
version is :func:`wave_hist_rows_reference`.

Both take ``acc=``, an accumulator the launch adds into without the
conversion to f32: :func:`wave_hist_sharded` (the row-sharded device
grower, ``ops/shard.py``) and :func:`wave_hist_rows_sharded` (the
parallel learners) launch kernel 1 once a shard into one accumulator and
convert once (:func:`fixed_to_f32`, the kernel's own conversion launched
alone) with the exponents of the global row count, so the reduced
histogram is the unsharded one bit for bit.  On the CPU they sum each
shard's plain version in shard order.

:func:`wave_hist_v2` launches ``csrc/wave_hist_v2.cu``, the TPU v2 kernel's
formulation: the histogram as the one-hot matrix product on the tensor
cores, bf16 only, any W, duplicate pending ids allowed (each slot its own
column).  Its plain version is the same :func:`wave_hist_reference`.  The
grower does not route to it (nor does the JAX grower to its v2); it runs
from ``scripts/ubench_hist_cuda.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import load_library

#: widest wave the kernel's int16 row -> slot map takes
MAX_WAVE = (1 << 15) - 1
#: largest leaf id bound the kernel's shared leaf -> slot table takes
MAX_LEAF_BOUND = 1 << 14
#: int32 accumulation of int8 stats is exact up to this many rows
INT8_EXACT_ROWS = ((1 << 31) - 1) // 127


def hist_scale_exponents(ghk: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(K,) int32 fixed-point exponents for bf16 or f32 stat columns:
    column k is accumulated as ``round(v * 2**e[k])`` in int64.  With
    ``max|col| < 2**p`` and ``n_rows <= 2**q``, ``e = 62 - p - q`` keeps
    every sum of ``n_rows`` values below ``2**62``.  Computed on the
    device (no host sync); the grower calls it once per tree."""
    return exponents_for_rows(ghk.abs().amax(dim=0).float(), n_rows)


def exponents_for_rows(amax: torch.Tensor, n_rows: int) -> torch.Tensor:
    """:func:`hist_scale_exponents` from the (K,) column maxima ``amax``:
    the host learner takes the maxima once a tree and the exponents of
    each leaf window from its row count."""
    _, p = torch.frexp(amax)
    q = max(int(n_rows) - 1, 0).bit_length()
    e = (62 - q) - p.to(torch.int32)
    return torch.where(amax > 0, e, torch.zeros_like(e)).contiguous()


_STAT_DTYPES = (torch.bfloat16, torch.int8, torch.float32)
#: the kernel's stat modes (csrc/wave_hist.cu ``Mode``)
_MODE = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}


def _check_int8_rows(ghk, rows: int) -> None:
    if ghk.dtype == torch.int8 and rows > INT8_EXACT_ROWS:
        raise ValueError(f"int8 stats over {rows} rows of one column can "
                         f"overflow int32 accumulators (limit "
                         f"{INT8_EXACT_ROWS})")


def _check(binned_t, leaf_id, ghk, pending, g, nb, k, w, col_rows=None):
    if binned_t.dim() != 2 or binned_t.shape[0] != g:
        raise ValueError(f"binned_t must be (G={g}, n), got "
                         f"{tuple(binned_t.shape)}")
    n = binned_t.shape[1]
    if binned_t.dtype != torch.uint8:
        raise ValueError(f"binned_t must be uint8, got {binned_t.dtype}")
    if leaf_id.shape != (n,) or leaf_id.dtype != torch.int32:
        raise ValueError(f"leaf_id must be ({n},) int32, got "
                         f"{tuple(leaf_id.shape)} {leaf_id.dtype}")
    if ghk.shape != (n, k):
        raise ValueError(f"ghk must be ({n}, {k}), got {tuple(ghk.shape)}")
    if ghk.dtype not in _STAT_DTYPES:
        raise ValueError(f"ghk must be bf16, int8 or f32 stat columns, got "
                         f"{ghk.dtype}")
    if pending.shape != (w,) or pending.dtype != torch.int32:
        raise ValueError(f"pending must be ({w},) int32, got "
                         f"{tuple(pending.shape)} {pending.dtype}")
    if k not in (3, 4, 5, 6):
        raise ValueError(f"K must be one of 3, 4, 5, 6, got {k}")
    if not 0 < nb <= 256 or w < 1:
        raise ValueError(f"need 0 < NB <= 256 and W >= 1, got NB={nb} W={w}")
    _check_int8_rows(ghk, n if col_rows is None else int(col_rows))
    devs = {t.device for t in (binned_t, leaf_id, ghk, pending)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    return n


def wave_hist_reference(binned_t, leaf_id, ghk, pending, *, g: int, nb: int,
                        k: int, w: int) -> torch.Tensor:
    """The plain PyTorch version: per slot, select the slot's rows and
    ``index_add_`` their stats into every group's bins, accumulating in
    f32 (bf16 or f32 input) or int32 (int8 input)."""
    _check(binned_t, leaf_id, ghk, pending, g, nb, k, w, col_rows=0)
    dev = binned_t.device
    acc = torch.int32 if ghk.dtype == torch.int8 else torch.float32
    vals = ghk.to(acc)
    out = torch.zeros((g * nb, k, w), dtype=acc, device=dev)
    base = (torch.arange(g, device=dev, dtype=torch.int64) * nb)[:, None]
    for s in range(w):
        hit = (leaf_id == pending[s]) & (pending[s] >= 0)
        rows = torch.nonzero(hit).squeeze(1)
        b = binned_t[:, rows].long()                      # (G, m)
        ok = (b < nb).reshape(-1)
        idx = (base + b).reshape(-1)[ok]
        v = vals[rows].repeat(g, 1)[ok]                   # (G*m, K)
        tile = torch.zeros((g * nb, k), dtype=acc, device=dev)
        tile.index_add_(0, idx, v)
        out[:, :, s] = tile
    return out


def wave_hist_fixed_reference(binned_t, leaf_id, ghk, pending, scale_exp,
                              *, g: int, nb: int, k: int,
                              w: int) -> torch.Tensor:
    """The exact plain version of :func:`wave_hist`'s bf16 and f32
    arithmetic, in torch ops on any device: each stat ``v`` of column
    ``k`` becomes the int64 ``round_half_even(v * 2**scale_exp[k])``, the
    integers are summed with ``index_add_`` into ``(G*NB, K, W)``, and the
    sums are scaled back as ``(acc.double() * 2**-scale_exp).float()``.
    Integer sums do not depend on their order, so the kernel must equal it
    bit for bit.  A test oracle: nothing on the training path calls it."""
    _check(binned_t, leaf_id, ghk, pending, g, nb, k, w)
    dev = binned_t.device
    e = scale_exp.to(device=dev, dtype=torch.float64)
    q = _fixed_point(ghk, e)
    acc = torch.zeros((g * nb, k, w), dtype=torch.int64, device=dev)
    base = (torch.arange(g, device=dev, dtype=torch.int64) * nb)[:, None]
    for s in range(w):
        rows = torch.nonzero((leaf_id == pending[s])
                             & (pending[s] >= 0)).squeeze(1)
        b = binned_t[:, rows].long()                      # (G, m)
        ok = (b < nb).reshape(-1)
        idx = (base + b).reshape(-1)[ok]
        tile = torch.zeros((g * nb, k), dtype=torch.int64, device=dev)
        tile.index_add_(0, idx, q[rows].repeat(g, 1)[ok])
        acc[:, :, s] = tile
    return (acc.double() * torch.exp2(-e)[None, :, None]).float()


def _fixed_point(ghk, e):
    """int64 ``round_half_even(v * 2**e)`` of bf16 or f32 stats (the
    product is exact in f64, so rounding it rounds the true product)."""
    if ghk.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the fixed-point reference takes bf16 or f32 "
                         f"stat columns, got {ghk.dtype}")
    return torch.round(ghk.double() * torch.exp2(e)).to(torch.int64)


def _check_rows(binned_t, ghk, rows, g, nb, k):
    if binned_t.dim() != 2 or binned_t.shape[0] != g \
            or binned_t.dtype != torch.uint8:
        raise ValueError(f"binned_t must be (G={g}, n) uint8, got "
                         f"{tuple(binned_t.shape)} {binned_t.dtype}")
    n = binned_t.shape[1]
    if ghk.shape != (n, k) or ghk.dtype not in _STAT_DTYPES:
        raise ValueError(f"ghk must be ({n}, {k}) bf16, int8 or f32, got "
                         f"{tuple(ghk.shape)} {ghk.dtype}")
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be a 1-D int32 list, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if k not in (3, 4, 5, 6) or not 0 < nb <= 256:
        raise ValueError(f"need K in 3..6 and 0 < NB <= 256, got K={k} "
                         f"NB={nb}")
    _check_int8_rows(ghk, rows.shape[0])
    devs = {t.device for t in (binned_t, ghk, rows)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    return n


def wave_hist_rows_reference(binned_t, ghk, rows, *, g: int, nb: int,
                             k: int) -> torch.Tensor:
    """The plain version of :func:`wave_hist_rows`: ``index_add_`` of the
    listed rows' stats into every group's bins, in list order, in f32
    (bf16 or f32 input) or int32 (int8 input)."""
    _check_rows(binned_t, ghk, rows, g, nb, k)
    acc = torch.int32 if ghk.dtype == torch.int8 else torch.float32
    r = rows.long()
    return _rows_sum(binned_t, r, ghk[r].to(acc), g, nb, k)


def _rows_sum(binned_t, r, vals, g, nb, k):
    """``index_add_`` of the (m, K) ``vals`` of rows ``r`` into each
    group's bins, a group at a time (no (G*m, K) copy)."""
    out = torch.zeros((g * nb, k), dtype=vals.dtype, device=vals.device)
    for gi in range(g):
        b = binned_t[gi, r].long()
        ok = b < nb
        out.index_add_(0, (gi * nb + b)[ok], vals[ok])
    return out


def wave_hist_rows_fixed_reference(binned_t, ghk, rows, scale_exp, *, g: int,
                                   nb: int, k: int) -> torch.Tensor:
    """The exact plain version of :func:`wave_hist_rows` (as
    :func:`wave_hist_fixed_reference`): the kernel must equal it bit for
    bit.  A test oracle."""
    _check_rows(binned_t, ghk, rows, g, nb, k)
    e = scale_exp.to(device=binned_t.device, dtype=torch.float64)
    r = rows.long()
    acc = _rows_sum(binned_t, r, _fixed_point(ghk[r], e), g, nb, k)
    return (acc.double() * torch.exp2(-e)[None, :]).float()


#: shared memory a CTA of csrc/wave_hist.cu may use for its slice of the
#: wave tile (of the 227 KB an H100 CTA can have)
_SMEM_BUDGET = 225 * 1024


class Geometry(NamedTuple):
    """Launch shape of ``csrc/wave_hist.cu``: ``tiles`` slot tiles of
    ``wt`` slots, CTA (tile, part of ``splits``, group tile of ``gb``
    groups) reads its part of its tile's rows (the rows of the wave sorted
    by slot tile; every row at W=1) into ``smem``
    dynamic shared-memory bytes; the pre-pass runs ``pre_blocks`` blocks
    of ``pre_rows`` rows."""
    wt: int
    gb: int
    tiles: int
    splits: int
    smem: int
    pre_blocks: int
    pre_rows: int


def _cta_smem(nb, k, wt, gb, quant):
    """A CTA's (gb, NB, K, wt) int64 (int32 for int8 stats) tile."""
    return gb * nb * k * wt * (4 if quant else 8)


def _balanced(g, gb):
    """The same number of groups in every group tile, at most ``gb``."""
    return -(-g // -(-g // gb))


@functools.lru_cache(maxsize=1024)
def _geometry(n, g, nb, k, w, quant, sm_count) -> Geometry:
    """The fewest slot tiles whose CTA tile fits the shared-memory budget
    (slots balanced over them), then as many groups as fit beside the
    slots share each row's slot and stats (``gb``, balanced over the group
    tiles), and each tile's rows are split into parts so that the CTAs
    about fill the card's SMs (one CTA each)."""
    n1 = max(n, 1)
    wt = 1
    while _cta_smem(nb, k, wt + 1, 1, quant) <= _SMEM_BUDGET:
        wt += 1
    tiles = -(-w // wt)
    wt = -(-w // tiles)
    gb = 1
    while gb < g and _cta_smem(nb, k, wt, gb + 1, quant) <= _SMEM_BUDGET:
        gb += 1
    gb = _balanced(g, gb)
    splits = max(1, sm_count // (tiles * -(-g // gb)))
    pre_blocks = max(1, min(2 * sm_count, -(-n1 // 4096)))
    return Geometry(wt, gb, tiles, splits, _cta_smem(nb, k, wt, gb, quant),
                    pre_blocks, -(-n1 // pre_blocks))


def _cta_work(geo: Geometry, slot_of_row: torch.Tensor, g: int, w: int):
    """What each CTA of a launch reads, as the kernel computes it from the
    pre-pass's (n,) row -> slot map (-1 outside the wave): yields ``(cta,
    groups, own_slots, rows)`` with ``cta`` = (part, group tile, slot
    tile), ``groups`` and ``own_slots`` (the slots whose cells it holds)
    as ``range``s and ``rows`` the (m,) tensor of the list entries it
    reads.  The list is the rows of the wave sorted by slot tile (the
    kernel's counting sort orders rows within a pre-pass block
    arbitrarily; this takes them in row order); at W=1 it is every row.
    A part is ``len * part // splits`` onward, as the kernel splits its
    tile's list."""
    n = slot_of_row.numel()
    if w > 1:
        rows = torch.nonzero(slot_of_row >= 0).squeeze(1)
        tile = slot_of_row[rows].long() // geo.wt
        order = rows[torch.sort(tile, stable=True).indices]
        lens = torch.bincount(tile, minlength=geo.tiles).tolist()
    else:
        order, lens = torch.arange(n), [n]
    starts = [sum(lens[:t]) for t in range(geo.tiles)]
    for part in range(geo.splits):
        for gt in range(-(-g // geo.gb)):
            groups = range(gt * geo.gb, min(g, gt * geo.gb + geo.gb))
            for t in range(geo.tiles):
                own = range(t * geo.wt, min(w, t * geo.wt + geo.wt))
                s, m = starts[t], lens[t]
                yield ((part, gt, t), groups, own,
                       order[s + m * part // geo.splits:
                             s + m * (part + 1) // geo.splits])


def _kernel_lib():
    lib = load_library("wave_hist")
    fn = lib.wave_hist_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, ll, i, i, i, i, i,
                       i, i, i, i, ll, i, i, ll, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _inputs_on_card(name: str, **tensors) -> None:
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")


def wave_hist(binned_t, leaf_id, ghk, pending, *, g: int, nb: int, k: int,
              w: int, scale_exp=None, leaf_bound=None,
              col_rows=None, acc=None) -> torch.Tensor:
    """Wave histogram ``(G*NB, K, W)``; see the module docstring.

    CUDA tensors launch the kernel (and raise if it cannot launch); CPU
    tensors take :func:`wave_hist_reference`.  ``scale_exp`` is the (K,)
    int32 output of :func:`hist_scale_exponents` for bf16 or f32 stats;
    ``leaf_bound`` exceeds every pending leaf id (the grower passes
    ``num_leaves``; at most :data:`MAX_LEAF_BOUND`).  Both are computed
    here when omitted, the bound with one host sync.  ``col_rows`` is the
    most rows any one stat column holds (a striped int8 layout: the
    larger stripe; default every row), which the int8 guard counts.
    ``acc`` (cards only) is an accumulator the launch adds into, int64
    for bf16 or f32 stats (int32 for int8), with no conversion: it is
    returned as it is (:func:`wave_hist_sharded`)."""
    n = _check(binned_t, leaf_id, ghk, pending, g, nb, k, w, col_rows)
    dev = binned_t.device
    if dev.type == "cpu":
        if acc is not None:
            raise ValueError("acc is a card accumulator; CPU tensors take "
                             "the plain version")
        return wave_hist_reference(binned_t, leaf_id, ghk, pending, g=g,
                                   nb=nb, k=k, w=w)
    _inputs_on_card("wave_hist", binned_t=binned_t, leaf_id=leaf_id, ghk=ghk,
                    pending=pending)
    if w > MAX_WAVE:
        raise ValueError(f"W must be at most {MAX_WAVE}, got {w}")
    quant = ghk.dtype == torch.int8
    if not quant:
        scale_exp = _scale_exp_on_card(scale_exp, ghk, n, k, dev)
    if leaf_bound is None:
        leaf_bound = max(int(pending.max().item()) + 1, 1)
    if not 0 < leaf_bound <= MAX_LEAF_BOUND:
        raise ValueError(f"leaf_bound must be in [1, {MAX_LEAF_BOUND}], got "
                         f"{leaf_bound}")
    fn = _kernel_lib()
    geo = _geometry(n, g, nb, k, w, quant, _sm_count(dev))
    if geo.tiles * 4 + leaf_bound * 2 > 48 * 1024:
        raise ValueError(f"W={w} over {geo.tiles} slot tiles with "
                         f"leaf_bound={leaf_bound} overflows the pre-pass's "
                         f"shared memory")
    size = (g * nb, k, w)
    slots = torch.empty((n,), dtype=torch.int16, device=dev)
    counts = list_ = tile_range = None
    if w > 1:
        # the sort's tile ranges (int64), per-block tile counts and row
        # list, in one scratch tensor
        scratch = torch.empty((4 * geo.tiles + geo.pre_blocks * geo.tiles
                               + n,), dtype=torch.int32, device=dev)
        tile_range = scratch.data_ptr()
        counts = tile_range + 16 * geo.tiles
        list_ = counts + 4 * geo.pre_blocks * geo.tiles
    keep = quant or acc is not None
    acc = _accumulator(acc, size, quant, dev)
    out = acc if keep else torch.empty(size, dtype=torch.float32,
                                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(binned_t.data_ptr(), leaf_id.data_ptr(), ghk.data_ptr(),
            pending.data_ptr(), None if quant else scale_exp.data_ptr(),
            slots.data_ptr(), counts, list_, tile_range, acc.data_ptr(),
            None if keep else out.data_ptr(), n, g, nb, k, w, geo.wt,
            geo.gb, geo.tiles, geo.splits, geo.pre_blocks, geo.pre_rows,
            leaf_bound, _MODE[ghk.dtype], geo.smem, stream)
    if rc != 0:
        raise RuntimeError(f"wave_hist kernel launch failed: CUDA error {rc}")
    wave_hist.launches.bump(dev)
    return out


def _accumulator(acc, size, quant, dev):
    """A zeroed accumulator of ``size`` (int32 for int8 stats, else
    int64), or the caller's ``acc`` checked against it."""
    dtype = torch.int32 if quant else torch.int64
    if acc is None:
        return torch.zeros(size, dtype=dtype, device=dev)
    if (tuple(acc.shape) != tuple(size) or acc.dtype != dtype
            or acc.device != dev or not acc.is_contiguous()):
        raise ValueError(f"acc must be a contiguous {tuple(size)} {dtype} "
                         f"tensor on {dev}")
    return acc


def fixed_to_f32(acc: torch.Tensor, scale_exp: torch.Tensor, *, k: int,
                 w: int) -> torch.Tensor:
    """The int64 fixed-point accumulator ``acc`` of kernel 1 (``(rows, K,
    W)``, or ``(rows, K)`` with ``w`` 1) as f32 with the columns' scales
    ``2**-scale_exp[k]``: the kernel's own conversion, launched alone.
    On CPU tensors its plain version, ``(acc * 2**-e).float()`` in f64."""
    if acc.dtype != torch.int64:
        raise ValueError(f"acc must be int64, got {acc.dtype}")
    if acc.device.type == "cpu":
        e = scale_exp.to(torch.float64)
        shape = (1, k, 1) if acc.dim() == 3 else (1, k)
        return (acc.double() * torch.exp2(-e).reshape(shape)).float()
    _inputs_on_card("fixed_to_f32", acc=acc, scale_exp=scale_exp)
    out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    fn = load_library("wave_hist").wave_hist_to_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    rc = fn(acc.data_ptr(), out.data_ptr(), scale_exp.data_ptr(),
            acc.numel(), k, w,
            torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wave_hist_to_f32 launch failed: CUDA error "
                           f"{rc}")
    return out


def _shard_blocks(codes):
    """(offset, rows) of each shard's block of the global rows."""
    out, off = [], 0
    for c in codes:
        out.append((off, int(c.shape[1])))
        off += int(c.shape[1])
    return out


def wave_hist_sharded(codes, leaf_id, ghk, pending, *, g: int, nb: int,
                      k: int, w: int, scale_exp=None, leaf_bound=None,
                      col_rows=None, pod=None) -> torch.Tensor:
    """:func:`wave_hist` of a row-sharded grower (``ops/shard.py``):
    ``codes`` are the shards' ``(G, L_d)`` code blocks, each on its
    shard's device, and ``leaf_id`` (N,) / ``ghk`` (N, K) the global rows
    (shard ``d``'s block starts where the blocks before it end) on the
    reduction device.  Kernel 1 runs once a shard over the shard's rows,
    every launch adding into one accumulator (a shard on another card
    into its own, added onto the reduction device in int64), and bf16 /
    f32 sums are converted once, with the global ``scale_exp``: the result
    is bit-equal to the unsharded launch.  CPU tensors sum each shard's
    plain version in f32 (int32 for int8) in shard order.

    ``pod`` (an ``ops/shard.PodMesh``): ``codes`` are this process's
    local shards and ``leaf_id`` / ``ghk`` its row block.  On the card
    the process's accumulator is summed over the processes (integers:
    staged through pinned host memory, all-reduced by gloo) before the
    one conversion, so the result is bit-equal to single-controller over
    the pod's shards; a pod needs ``scale_exp`` for bf16 / f32 stats (the
    global exponents).  CPU tensors gather every shard's plain partial
    and sum them in global shard order."""
    dev = leaf_id.device
    blocks = _shard_blocks(codes)
    quant = ghk.dtype == torch.int8
    if dev.type == "cpu":
        parts = [wave_hist_reference(
            c, leaf_id[o:o + m].to(c.device), ghk[o:o + m].to(c.device),
            pending.to(c.device), g=g, nb=nb, k=k, w=w).to(dev)
            for c, (o, m) in zip(codes, blocks)]
        if pod is not None:
            parts = pod.gather_shards(parts)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out
    if pod is not None and not quant and scale_exp is None:
        raise ValueError("wave_hist_sharded over a pod needs the global "
                         "scale_exp")
    if not quant:
        scale_exp = _scale_exp_on_card(scale_exp, ghk, ghk.shape[0], k, dev)
    if leaf_bound is None:
        leaf_bound = max(int(pending.max().item()) + 1, 1)
    acc = _accumulator(None, (g * nb, k, w), quant, dev)
    for c, (o, m) in zip(codes, blocks):
        sd = c.device
        tgt = acc if sd == dev else _accumulator(None, acc.shape, quant, sd)
        wave_hist(c, leaf_id[o:o + m].to(sd), ghk[o:o + m].to(sd),
                  pending.to(sd), g=g, nb=nb, k=k, w=w,
                  scale_exp=None if quant else scale_exp.to(sd),
                  leaf_bound=leaf_bound,
                  col_rows=m if col_rows is None else min(col_rows, m),
                  acc=tgt)
        wave_hist_sharded.launches.bump(sd)
        if tgt is not acc:
            acc += tgt.to(dev)
    if pod is not None:
        pod.allreduce_(acc, "wave_hist")
    return acc if quant else fixed_to_f32(acc, scale_exp, k=k, w=w)


def _scale_exp_on_card(scale_exp, ghk, n, k, dev):
    if scale_exp is None:
        scale_exp = hist_scale_exponents(ghk, n)
    if (scale_exp.shape != (k,) or scale_exp.dtype != torch.int32
            or scale_exp.device != dev or not scale_exp.is_contiguous()):
        raise ValueError("scale_exp must be a contiguous (K,) int32 "
                         "tensor on the inputs' device")
    return scale_exp


@functools.lru_cache(maxsize=1024)
def _rows_geometry(m, g, nb, k, quant, sm_count):
    """(gb, splits, smem) of a one-slot list launch: as many groups a CTA
    as its tile fits, and about one CTA a SM, but no more parts of the
    list than 4,096-row pieces (a small window's CTAs would mostly zero
    and flush their tiles)."""
    gb = 1
    while gb < g and _cta_smem(nb, k, 1, gb + 1, quant) <= _SMEM_BUDGET:
        gb += 1
    gb = _balanced(g, gb)
    gtiles = -(-g // gb)
    splits = max(1, min(sm_count // gtiles, -(-max(m, 1) // 4096)))
    return gb, splits, _cta_smem(nb, k, 1, gb, quant)


def _rows_lib():
    fn = load_library("wave_hist").wave_hist_rows_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ll, ll, i, i, i, i, i, i, ll, p]
        fn.restype = ctypes.c_int
    return fn


def wave_hist_rows(binned_t, ghk, rows, *, g: int, nb: int, k: int,
                   scale_exp=None, acc=None) -> torch.Tensor:
    """One slot's histogram ``(G*NB, K)`` over the rows listed in ``rows``
    (1-D int32 indices into the ``n`` columns of ``binned_t`` (G, n) and
    the ``n`` rows of ``ghk`` (n, K)): the host learner's leaf window
    (``rows`` a slice of its partition buffer).  ``binned_t`` may be a
    column slice of a wider codes tensor (the device grower's
    ``(G, n_pad)`` codes): the kernel reads its rows at their pitch
    ``binned_t.stride(0)``.  CUDA tensors launch
    ``csrc/wave_hist.cu`` in its list mode (or raise); CPU tensors take
    :func:`wave_hist_rows_reference`.  ``scale_exp`` as for
    :func:`wave_hist`, for ``len(rows)`` rows (computed here, over every
    row of ``ghk``, when omitted).  ``acc`` as for :func:`wave_hist`."""
    n = _check_rows(binned_t, ghk, rows, g, nb, k)
    m = int(rows.shape[0])
    dev = binned_t.device
    if dev.type == "cpu":
        if acc is not None:
            raise ValueError("acc is a card accumulator; CPU tensors take "
                             "the plain version")
        return wave_hist_rows_reference(binned_t, ghk, rows, g=g, nb=nb, k=k)
    _inputs_on_card("wave_hist_rows", ghk=ghk, rows=rows)
    if binned_t.stride(1) != 1:
        raise ValueError("binned_t's rows must be contiguous")
    quant = ghk.dtype == torch.int8
    if not quant:
        scale_exp = _scale_exp_on_card(scale_exp, ghk, m, k, dev)
    gb, splits, smem = _rows_geometry(m, g, nb, k, quant, _sm_count(dev))
    keep = quant or acc is not None
    acc = _accumulator(acc, (g * nb, k), quant, dev)
    out = acc if keep else torch.empty((g * nb, k), dtype=torch.float32,
                                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _rows_lib()(binned_t.data_ptr(), ghk.data_ptr(), rows.data_ptr(),
                     None if quant else scale_exp.data_ptr(), acc.data_ptr(),
                     None if keep else out.data_ptr(), binned_t.stride(0),
                     m, g, nb, k, gb,
                     splits, _MODE[ghk.dtype], smem, stream)
    if rc != 0:
        raise RuntimeError(f"wave_hist_rows kernel launch failed: CUDA "
                           f"error {rc}")
    wave_hist_rows.launches.bump(dev)
    return out


def wave_hist_rows_sharded(shards, *, nb: int, k: int, scale_exp=None,
                           device=None, reduce: bool = True):
    """Kernel 1's list mode over row- or group-sharded data (the parallel
    learners): ``shards`` are ``(binned_t, ghk, rows)`` triples as
    :func:`wave_hist_rows` takes them (``g`` is each ``binned_t``'s row
    count), each on its shard's device; one launch a shard with rows.

    ``reduce`` (row shards of the data- and voting-parallel learners'
    global histogram): every launch adds into one accumulator (another
    card's into its own, added in int64), converted once with
    ``scale_exp`` (the exponents of the leaf's global row count), on
    ``device`` (default the first shard's): bit-equal to
    :func:`wave_hist_rows` over the concatenated rows.  Otherwise the
    list of each shard's own histogram, each converted with
    ``scale_exp`` (the voting learner's local histograms; the
    feature-parallel learner's group blocks).  CPU tensors take the plain
    version, the reduction summing in shard order."""
    dev = torch.device(device) if device is not None \
        else shards[0][0].device
    quant = shards[0][1].dtype == torch.int8
    on_card = dev.type == "cuda"
    if on_card and not quant and scale_exp is None:
        raise ValueError("the sharded list mode needs the global scale_exp")
    parts, acc = [], None
    for b, gh, r in shards:
        g, sd = int(b.shape[0]), b.device
        if not on_card:
            part = wave_hist_rows_reference(b, gh, r, g=g, nb=nb, k=k)
        else:
            part = acc if reduce and acc is not None and sd == dev \
                else _accumulator(None, (g * nb, k), quant, sd)
            if r.shape[0] and g:
                wave_hist_rows(b, gh, r, g=g, nb=nb, k=k,
                               scale_exp=None if quant else scale_exp.to(sd),
                               acc=part)
                wave_hist_rows_sharded.launches.bump(sd)
        if not reduce:
            parts.append(part if quant or not on_card else fixed_to_f32(
                part, scale_exp.to(sd), k=k, w=1))
        elif acc is None:
            acc = part.to(dev)
        elif part is not acc:
            acc += part.to(dev)
    if not reduce:
        return parts
    return acc if quant or not on_card else fixed_to_f32(acc, scale_exp,
                                                         k=k, w=1)


class DeviceLaunchCount:
    """Launches of a kernel wrapper, counted on the device: right after
    each launch the wrapper enqueues one increment of an int64 counter on
    the launch's device, so a launch captured into a CUDA graph counts
    every time a replay runs it (a Python counter would count the capture
    once).  :meth:`read` synchronizes; :meth:`counter` must have made a
    device's counter before a capture on it (the grower does)."""

    def __init__(self):
        self._counters = {}

    def counter(self, device: torch.device) -> torch.Tensor:
        c = self._counters.get(device)
        if c is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the launch counter of a device must "
                                   "exist before a capture on it")
            c = self._counters[device] = torch.zeros(
                (), dtype=torch.int64, device=device)
        return c

    def bump(self, device: torch.device) -> None:
        self.counter(device).add_(1)

    def read(self) -> int:
        return sum(int(c) for c in self._counters.values())

    def reset(self) -> None:
        for c in self._counters.values():
            c.zero_()


#: kernel launches made through :func:`wave_hist` and
#: :func:`wave_hist_rows`, counted on the device (read by chip_smoke.py)
wave_hist.launches = DeviceLaunchCount()
wave_hist_rows.launches = DeviceLaunchCount()
#: the shard launches of the sharded wrappers (each is also one launch of
#: :func:`wave_hist` or :func:`wave_hist_rows`)
wave_hist_sharded.launches = DeviceLaunchCount()
wave_hist_rows_sharded.launches = DeviceLaunchCount()

#: csrc/wave_hist_v2.cu: output rows per CTA (three warpgroups of 64) and
#: the column tile widths it is compiled for (wgmma N, multiples of 16 up
#: to 192)
_V2_BM = 192
_V2_TILES = (16, 32, 48, 64, 96, 128, 160, 192)


class V2Geometry(NamedTuple):
    """Launch shape of ``csrc/wave_hist_v2.cu``: ``ctiles`` column tiles
    of ``n_tile`` columns (``b_pad`` in all), ``splits`` row splits of
    ``rows_per_split`` rows, and ``grid`` persistent CTAs walking the
    ``items`` = splits x output-row blocks x column tiles work items."""
    n_tile: int
    ctiles: int
    b_pad: int
    splits: int
    rows_per_split: int
    items: int
    grid: int


@functools.lru_cache(maxsize=256)
def _v2_geometry(n, g, nb, k, w, ch, sm_count) -> V2Geometry:
    """Columns: K*W over as few tiles as keep a tile <= 192 wide, each
    rounded up to the next compiled width.  Rows: whole blocks of ``ch``
    rows a split, the fewest splits whose work items fill the card's CTA
    slots (two a SM for tiles <= 32 columns, as the kernel's launch
    bounds say; else one) in rounds at least 90% full (the items are
    about equal)."""
    b = k * w
    ctiles = -(-b // _V2_TILES[-1])
    n_tile = next(t for t in _V2_TILES if t * ctiles >= b)
    slots = sm_count * (2 if n_tile <= 32 else 1)
    units = -(-(g * nb) // _V2_BM) * ctiles
    row_blocks = -(-max(n, 1) // ch)
    best = None
    for s in range(1, min(row_blocks, 64) + 1):
        items = units * s
        fill = items / (slots * -(-items // slots))
        if best is None or fill > best[1] + 1e-9:
            best = (s, fill)
        if fill >= 0.9:
            break
    rows_per_split = -(-row_blocks // best[0]) * ch
    splits = -(-max(n, 1) // rows_per_split)
    items = units * splits
    return V2Geometry(n_tile, ctiles, n_tile * ctiles, splits,
                      rows_per_split, items, min(items, slots))


def _v2_items(geo: V2Geometry, n: int, g: int, nb: int):
    """The work items as the kernel decodes them: yields ``(output rows,
    columns, rows)`` ranges, the columns within ``b_pad``."""
    mblocks = -(-(g * nb) // _V2_BM)
    for item in range(geo.items):
        ct = item % geo.ctiles
        mb = (item // geo.ctiles) % mblocks
        split = item // (geo.ctiles * mblocks)
        r0 = split * geo.rows_per_split
        yield (range(mb * _V2_BM, min(g * nb, mb * _V2_BM + _V2_BM)),
               range(ct * geo.n_tile, ct * geo.n_tile + geo.n_tile),
               range(r0, min(n, r0 + geo.rows_per_split)))


def wave_hist_v2(binned_t, leaf_id, ghk, pending, *, g: int, nb: int, k: int,
                 w: int, ch: int = 4096) -> torch.Tensor:
    """Wave histogram ``(G*NB, K, W)`` f32 by the tensor-core one-hot
    product (``csrc/wave_hist_v2.cu``); bf16 stat columns only.

    ``ch`` is the row block (the TPU kernel's grid step): each work item
    reduces a run of whole blocks of ``ch`` rows, and the partial sums of
    the runs are added in a fixed order, so the result is bit-identical
    from run to run.  It must be a multiple of 128; NB a multiple of 32.
    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`wave_hist_reference`."""
    n = _check(binned_t, leaf_id, ghk, pending, g, nb, k, w)
    if ghk.dtype != torch.bfloat16:
        raise ValueError(f"wave_hist_v2 takes bf16 stat columns only (as "
                         f"the TPU kernel it ports), got {ghk.dtype}; int8 "
                         f"columns go to wave_hist")
    if nb % 32:
        raise ValueError(f"wave_hist_v2 needs NB a multiple of 32, got {nb}")
    if ch <= 0 or ch % 128:
        raise ValueError(f"ch must be a positive multiple of 128, got {ch}")
    dev = binned_t.device
    if dev.type == "cpu":
        return wave_hist_reference(binned_t, leaf_id, ghk, pending, g=g,
                                   nb=nb, k=k, w=w)
    _inputs_on_card("wave_hist_v2", binned_t=binned_t, leaf_id=leaf_id,
                    ghk=ghk, pending=pending)
    if n % 16:
        # the kernel's bulk copies move whole 16-row pieces: pad with rows
        # of leaf -1, which no column selects
        pad = 16 - n % 16
        binned_t = torch.nn.functional.pad(binned_t, (0, pad))
        leaf_id = torch.nn.functional.pad(leaf_id, (0, pad), value=-1)
        ghk = torch.nn.functional.pad(ghk, (0, 0, 0, pad))
        n += pad
    fn = _kernel_v2_lib()
    geo = _v2_geometry(n, g, nb, k, w, ch, _sm_count(dev))
    partial = torch.empty((geo.splits, g * nb, geo.b_pad),
                          dtype=torch.float32, device=dev)
    out = torch.empty((g * nb, k, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(binned_t.data_ptr(), leaf_id.data_ptr(), ghk.data_ptr(),
            pending.data_ptr(), partial.data_ptr(), out.data_ptr(), n, g, nb,
            k, w, geo.n_tile, geo.ctiles, geo.splits, geo.rows_per_split,
            geo.grid, stream)
    if rc != 0:
        raise RuntimeError(f"wave_hist_v2 kernel launch failed: CUDA error "
                           f"{rc}")
    wave_hist_v2.launches += 1
    return out


def _kernel_v2_lib():
    fn = load_library("wave_hist_v2").wave_hist_v2_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, i, i, i, ll, i, p]
        fn.restype = ctypes.c_int
    return fn


#: kernel launches made through :func:`wave_hist_v2` (read by chip_smoke.py)
wave_hist_v2.launches = 0
