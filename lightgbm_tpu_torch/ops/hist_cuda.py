"""The wave histogram: two hand-written Hopper kernels and their plain
version.

Counterpart of ``lightgbm_tpu/ops/hist_pallas.py`` (``wave_hist_pallas``
and ``wave_hist_pallas_v2``).  All compute, for a wave of W pending
leaves::

    out[g*NB + b, k, w] = sum of ghk[r, k] over rows r with
                          binned_t[g, r] == b and leaf_id[r] == pending[w]

returning ``(G*NB, K, W)`` float32 (bf16 stat columns) or int32 (int8 stat
columns), the layout of ``wave_hist_pallas``.  Non-negative ``pending``
entries are distinct leaf ids; a slot whose entry is negative is empty and
stays zero.  (The TPU kernel's equality mask would gather the rows of leaf
-1 there, the bucket padding, whose stats the grower zeroes: same result.)

:func:`wave_hist` launches ``csrc/wave_hist.cu`` for CUDA tensors and takes
the plain version :func:`wave_hist_reference` only for CPU tensors.  The
kernel accumulates bf16 stats in int64 fixed point (one power-of-two scale
per stat column, :func:`hist_scale_exponents`), so its f32 result is the
exactly rounded sum, bit-identical run to run; the plain version sums in
f32 in ``index_add_`` order.  The two therefore agree to f32 summation
error, not bit for bit; int8 stats agree exactly.

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
    """(K,) int32 fixed-point exponents for bf16 stat columns: column k is
    accumulated as ``round(v * 2**e[k])`` in int64.  With ``max|col| <
    2**p`` and ``n_rows <= 2**q``, ``e = 62 - p - q`` keeps every sum of
    ``n_rows`` values below ``2**62``.  Computed on the device (no host
    sync); the grower calls it once per tree."""
    amax = ghk.abs().amax(dim=0).float()
    _, p = torch.frexp(amax)
    q = max(int(n_rows) - 1, 0).bit_length()
    e = (62 - q) - p.to(torch.int32)
    return torch.where(amax > 0, e, torch.zeros_like(e)).contiguous()


def _check(binned_t, leaf_id, ghk, pending, g, nb, k, w):
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
    if ghk.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"ghk must be bf16 or int8 stat columns, got "
                         f"{ghk.dtype}")
    if pending.shape != (w,) or pending.dtype != torch.int32:
        raise ValueError(f"pending must be ({w},) int32, got "
                         f"{tuple(pending.shape)} {pending.dtype}")
    if k not in (3, 4, 5, 6):
        raise ValueError(f"K must be one of 3, 4, 5, 6, got {k}")
    if not 0 < nb <= 256 or w < 1:
        raise ValueError(f"need 0 < NB <= 256 and W >= 1, got NB={nb} W={w}")
    if ghk.dtype == torch.int8 and n > INT8_EXACT_ROWS:
        raise ValueError(f"int8 stats over {n} rows can overflow int32 "
                         f"accumulators (limit {INT8_EXACT_ROWS})")
    devs = {t.device for t in (binned_t, leaf_id, ghk, pending)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    return n


def wave_hist_reference(binned_t, leaf_id, ghk, pending, *, g: int, nb: int,
                        k: int, w: int) -> torch.Tensor:
    """The plain PyTorch version: per slot, select the slot's rows and
    ``index_add_`` their stats into every group's bins, accumulating in
    f32 (bf16 input) or int32 (int8 input)."""
    _check(binned_t, leaf_id, ghk, pending, g, nb, k, w)
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
    """The exact plain version of :func:`wave_hist`'s bf16 arithmetic, in
    torch ops on any device: each stat ``v`` of column ``k`` becomes the
    int64 ``round_half_even(v * 2**scale_exp[k])``, the integers are
    summed with ``index_add_`` into ``(G*NB, K, W)``, and the sums are
    scaled back as ``(acc.double() * 2**-scale_exp).float()``.  Integer
    sums do not depend on their order, so the kernel must equal it bit
    for bit.  A test oracle: nothing on the training path calls it."""
    _check(binned_t, leaf_id, ghk, pending, g, nb, k, w)
    if ghk.dtype != torch.bfloat16:
        raise ValueError(f"the fixed-point reference takes bf16 stat "
                         f"columns, got {ghk.dtype}")
    dev = binned_t.device
    e = scale_exp.to(device=dev, dtype=torch.float64)
    # bf16 * 2**e is exact in f64, so rounding it rounds the true product
    q = torch.round(ghk.double() * torch.exp2(e)).to(torch.int64)
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


def _inputs_on_card(binned_t, leaf_id, ghk, pending, name: str) -> None:
    dev = binned_t.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    for arg, t in (("binned_t", binned_t), ("leaf_id", leaf_id),
                   ("ghk", ghk), ("pending", pending)):
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")


def wave_hist(binned_t, leaf_id, ghk, pending, *, g: int, nb: int, k: int,
              w: int, scale_exp=None, leaf_bound=None) -> torch.Tensor:
    """Wave histogram ``(G*NB, K, W)``; see the module docstring.

    CUDA tensors launch the kernel (and raise if it cannot launch); CPU
    tensors take :func:`wave_hist_reference`.  ``scale_exp`` is the (K,)
    int32 output of :func:`hist_scale_exponents` for bf16 stats;
    ``leaf_bound`` exceeds every pending leaf id (the grower passes
    ``num_leaves``; at most :data:`MAX_LEAF_BOUND`).  Both are computed
    here when omitted, the bound with one host sync."""
    n = _check(binned_t, leaf_id, ghk, pending, g, nb, k, w)
    dev = binned_t.device
    if dev.type == "cpu":
        return wave_hist_reference(binned_t, leaf_id, ghk, pending, g=g,
                                   nb=nb, k=k, w=w)
    _inputs_on_card(binned_t, leaf_id, ghk, pending, "wave_hist")
    if w > MAX_WAVE:
        raise ValueError(f"W must be at most {MAX_WAVE}, got {w}")
    quant = ghk.dtype == torch.int8
    if not quant:
        if scale_exp is None:
            scale_exp = hist_scale_exponents(ghk, n)
        if (scale_exp.shape != (k,) or scale_exp.dtype != torch.int32
                or scale_exp.device != dev or not scale_exp.is_contiguous()):
            raise ValueError("scale_exp must be a contiguous (K,) int32 "
                             "tensor on the inputs' device")
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
    acc = torch.zeros(size, dtype=torch.int32 if quant else torch.int64,
                      device=dev)
    out = acc if quant else torch.empty(size, dtype=torch.float32,
                                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(binned_t.data_ptr(), leaf_id.data_ptr(), ghk.data_ptr(),
            pending.data_ptr(), None if quant else scale_exp.data_ptr(),
            slots.data_ptr(), counts, list_, tile_range, acc.data_ptr(),
            None if quant else out.data_ptr(), n, g, nb, k, w, geo.wt,
            geo.gb, geo.tiles, geo.splits, geo.pre_blocks, geo.pre_rows,
            leaf_bound, int(quant), geo.smem, stream)
    if rc != 0:
        raise RuntimeError(f"wave_hist kernel launch failed: CUDA error {rc}")
    wave_hist.launches.bump(dev)
    return out


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


#: kernel launches made through :func:`wave_hist`, counted on the device
#: (read by chip_smoke.py)
wave_hist.launches = DeviceLaunchCount()

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
    _inputs_on_card(binned_t, leaf_id, ghk, pending, "wave_hist_v2")
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
