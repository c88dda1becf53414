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

import torch

from .build import load_library

#: shared-memory budget of one block's (Gb, NB, K, Wt) tiles
_SMEM_BUDGET = 100 * 1024
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


def _geometry(n, g, nb, k, w, quant, sm_count):
    """Launch shape: (slot tile Wt, groups per block Gb, row tiles, rows
    per block).  Wt is the widest slot tile (<= 16) whose (NB, K, Wt)
    accumulator fits the shared-memory budget, Gb as many groups as then
    fit beside it, and the row tiles give every SM about eight blocks
    (two resident at a time)."""
    cell = 4 if quant else 8
    wt = min(w, 16)
    while wt > 1 and nb * k * wt * cell > _SMEM_BUDGET:
        wt //= 2
    gb = max(1, min(g, _SMEM_BUDGET // (nb * k * wt * cell)))
    tiles = -(-g // gb) * -(-w // wt)
    row_tiles = max(1, min(-(-8 * sm_count // tiles), -(-n // 4096)))
    rows_per_block = -(-max(n, 1) // row_tiles)
    rows_per_block = -(-rows_per_block // 4) * 4
    return wt, gb, -(-max(n, 1) // rows_per_block), rows_per_block


def _kernel_lib():
    lib = load_library("wave_hist")
    fn = lib.wave_hist_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, ll,
                       ll, i, p]
        fn.restype = ctypes.c_int
    return fn


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
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    wt, gb, row_tiles, rpb = _geometry(n, g, nb, k, w, quant, sm_count)
    size = (g * nb, k, w)
    slots = torch.empty((n,), dtype=torch.int16, device=dev)
    acc = torch.zeros(size, dtype=torch.int32 if quant else torch.int64,
                      device=dev)
    out = acc if quant else torch.empty(size, dtype=torch.float32,
                                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(binned_t.data_ptr(), leaf_id.data_ptr(), ghk.data_ptr(),
            pending.data_ptr(), None if quant else scale_exp.data_ptr(),
            slots.data_ptr(), acc.data_ptr(),
            None if quant else out.data_ptr(), n, g, nb, k, w, wt, gb,
            leaf_bound, row_tiles, rpb, int(quant), stream)
    if rc != 0:
        raise RuntimeError(f"wave_hist kernel launch failed: CUDA error {rc}")
    wave_hist.launches += 1
    return out


#: kernel launches made through :func:`wave_hist` (read by chip_smoke.py)
wave_hist.launches = 0

#: csrc/wave_hist_v2.cu tiles: output rows and columns per block, rows
#: staged per step (a row split is a multiple of it)
_V2_BM, _V2_BN, _V2_STAGE = 128, 64, 128


def _v2_geometry(n, g, nb, k, w, ch, sm_count):
    """(b_pad, row splits, rows per split): columns padded to the block
    width; the rows cut into whole blocks of ``ch`` rows, as few per
    split as give every SM about four blocks."""
    b_pad = -(-(k * w) // _V2_BN) * _V2_BN
    tiles = -(-(g * nb) // _V2_BM) * (b_pad // _V2_BN)
    row_blocks = -(-max(n, 1) // ch)
    splits = max(1, min(row_blocks, -(-4 * sm_count // tiles)))
    rows_per_split = -(-row_blocks // splits) * ch
    return b_pad, -(-max(n, 1) // rows_per_split), rows_per_split


def wave_hist_v2(binned_t, leaf_id, ghk, pending, *, g: int, nb: int, k: int,
                 w: int, ch: int = 4096) -> torch.Tensor:
    """Wave histogram ``(G*NB, K, W)`` f32 by the tensor-core one-hot
    product (``csrc/wave_hist_v2.cu``); bf16 stat columns only.

    ``ch`` is the row block (the TPU kernel's grid step): each CUDA block
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
    if ch <= 0 or ch % _V2_STAGE:
        raise ValueError(f"ch must be a positive multiple of {_V2_STAGE}, "
                         f"got {ch}")
    dev = binned_t.device
    if dev.type == "cpu":
        return wave_hist_reference(binned_t, leaf_id, ghk, pending, g=g,
                                   nb=nb, k=k, w=w)
    _inputs_on_card(binned_t, leaf_id, ghk, pending, "wave_hist_v2")
    fn = _kernel_v2_lib()
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    b_pad, splits, rps = _v2_geometry(n, g, nb, k, w, ch, sm_count)
    partial = torch.empty((splits, g * nb, b_pad), dtype=torch.float32,
                          device=dev)
    out = torch.empty((g * nb, k, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(binned_t.data_ptr(), leaf_id.data_ptr(), ghk.data_ptr(),
            pending.data_ptr(), partial.data_ptr(), out.data_ptr(), n, g, nb,
            k, w, b_pad, splits, rps, stream)
    if rc != 0:
        raise RuntimeError(f"wave_hist_v2 kernel launch failed: CUDA error "
                           f"{rc}")
    wave_hist_v2.launches += 1
    return out


def _kernel_v2_lib():
    fn = load_library("wave_hist_v2").wave_hist_v2_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, i, i, ll, p]
        fn.restype = ctypes.c_int
    return fn


#: kernel launches made through :func:`wave_hist_v2` (read by chip_smoke.py)
wave_hist_v2.launches = 0
