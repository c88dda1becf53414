"""Row bucketing, the host learner's leaf-window histogram and the int8
quantization of gradients (``lightgbm_tpu/ops/histogram.py``).

:func:`build_histogram` is one leaf's ``[sum g, sum h, count]`` histogram
over its rows, listed by a window of the host learner's partition buffer,
on the wave kernel's list mode (``ops/hist_cuda.wave_hist_rows``) with
full-f32 stat columns.  The JAX package gathers the window's bins and sums
them in f32 chunks of 8,192 rows (one compiled program a chunk count,
hence its ``num_chunks_for``); the kernel reads the rows in place and sums
the f32 stats exactly in int64 fixed point, so no chunking is needed.
Under ``gpu_use_dp`` the JAX package sums 512-row granules with a Kahan
compensated running total to approach double precision; the fixed-point
sum is exact for every stat bit above the column's scale
(``2**-(62 - p - q)`` for ``max|col| < 2**p`` over ``2**q`` rows), so
``gpu_use_dp`` needs no separate path there.  On the CPU the window takes
the kernel's plain version, an f32 ``index_add_`` in row-list order.

The grower pads its row buffers to a power-of-two bucket so that one set of
buffer shapes serves a whole range of dataset sizes.

``grad_quant_bits=8`` stochastically rounds each tree's gradients and
hessians to int8 against one global scale per column (Shi et al.,
*Quantized Training of Gradient Boosting Decision Trees*, NeurIPS 2022), so
the wave histograms accumulate exactly in int32.  The rounding noise comes
from the port's Threefry (``utils/random.py``), keyed as the JAX package
keys it, so the int8 columns are the JAX package's byte for byte.  Element
``i`` of a Threefry draw depends on ``i`` and the key only, so the noise of
a row does not depend on how far the caller padded the rows.
"""

from __future__ import annotations

import torch

from ..utils import random as trandom
from .hist_cuda import exponents_for_rows, wave_hist_rows

#: int8 quantization range: symmetric [-127, 127] (-128 unused, so
#: negation stays exact)
QUANT_MAX = 127.0


def bucket_size(count: int, minimum: int = 1024) -> int:
    """Smallest power of two >= ``count`` (and >= ``minimum``)."""
    b = minimum
    while b < count:
        b <<= 1
    return b


def stat_columns(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """(N, 3) f32 ``[g, h, 1]`` stat columns of a tree (the count column is
    one: out-of-bag rows are not in the partition's windows)."""
    return torch.stack([grad.float(), hess.float(),
                        torch.ones_like(grad, dtype=torch.float32)], 1)


def build_histogram(binned_t: torch.Tensor, ghk: torch.Tensor,
                    rows: torch.Tensor, nb: int,
                    amax: torch.Tensor) -> torch.Tensor:
    """``(G*nb, 3)`` f32 histogram of the listed ``rows`` (1-D int32, a
    leaf's window of the partition buffer) over the ``(G, N)`` codes and
    the ``(N, 3)`` :func:`stat_columns`.  ``amax`` is the (3,) column
    maxima of ``ghk`` (taken once a tree); the window's fixed-point
    exponents follow from it and the window's length."""
    k = int(ghk.shape[1])
    return wave_hist_rows(binned_t, ghk, rows, g=int(binned_t.shape[0]),
                          nb=nb, k=k,
                          scale_exp=exponents_for_rows(amax, rows.shape[0]))


def slot_pitch(dataset) -> int:
    """Per-group slot pitch of the flat histograms: the smallest power of
    two from 64 covering every group's bins."""
    nb = 64
    for grp in dataset.groups:
        while grp.num_total_bin > nb:
            nb *= 2
    return nb


def quant_scales(grad: torch.Tensor, hess: torch.Tensor, eps: float = 1e-30):
    """() f32 scales mapping max|g| and max|h| onto the int8 range."""
    sg = torch.clamp(grad.abs().max(), min=eps) / QUANT_MAX
    sh = torch.clamp(hess.abs().max(), min=eps) / QUANT_MAX
    return sg, sh


def stochastic_round_with(x: torch.Tensor, scale: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
    """``floor(x / scale + u)`` clipped to +-127, as int8: unbiased for
    ``u`` uniform in [0, 1)."""
    q = torch.floor(x / scale + u)
    return torch.clamp(q, -QUANT_MAX, QUANT_MAX).to(torch.int8)


def stochastic_round_int8(x: torch.Tensor, scale: torch.Tensor,
                          key) -> torch.Tensor:
    """:func:`stochastic_round_with` with the noise drawn from ``key`` at
    ``x``'s shape."""
    u = trandom.uniform(key, tuple(x.shape), device=x.device)
    return stochastic_round_with(x, scale, u)


def quantize_gh(grad: torch.Tensor, hess: torch.Tensor, key):
    """(scale_g, scale_h, g_int8, h_int8) of one tree's gradients; ``key``
    is ``fold_in(PRNGKey(seed), tree_idx)``, split into the g and h
    keys."""
    kg, kh = trandom.split(key)
    return quantize_gh_keys(grad, hess, kg, kh)


def quantize_gh_keys(grad: torch.Tensor, hess: torch.Tensor, kg, kh):
    """:func:`quantize_gh` with the two noise keys given (host pairs or
    ``(2,)`` int64 tensors, as a captured graph reads them)."""
    sg, sh = quant_scales(grad, hess)
    return (sg, sh, stochastic_round_int8(grad, sg, kg),
            stochastic_round_int8(hess, sh, kh))
