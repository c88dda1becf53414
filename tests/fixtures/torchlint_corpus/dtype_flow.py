"""TL111 fixture: int8 quantization dtype-contract breaks.

Planted: an int8 contraction (a function and the ``@`` operator), an
int8 accumulation target, an int8-typed sum, a premature float upcast
of int8 stat columns (also when the int8 values come back from another
function through a tuple), and a float upcast of integer quantized
accumulation state.  Exempt variants: the int32 contraction, the
sanctioned ``.float() * scale`` dequantize, a dequantize helper, and a
suppressed occurrence.
"""

import torch


def stochastic_round_int8(x, scale):
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


def quantize(grad, hess, sg, sh):
    return sg, sh, stochastic_round_int8(grad, sg), \
        stochastic_round_int8(hess, sh)


def histogram_bad(one_hot, stats):
    oh = one_hot.to(torch.int8)
    st = stats.to(torch.int8)
    a = torch.matmul(oh, st)                   # PLANT: TL111
    b = oh @ st                                # PLANT: TL111
    return a, b


def accumulate_bad(idx, stats, n):
    q = stats.to(torch.int8)
    acc = torch.zeros((n, 3), dtype=torch.int8)
    acc.index_add_(0, idx, q)                  # PLANT: TL111
    return acc, q.sum(0, dtype=torch.int8)     # PLANT: TL111


def histogram_good(one_hot, stats, idx, n):
    oh = one_hot.to(torch.int8)
    st = stats.to(torch.int8)
    hist = torch._int_mm(oh, st)
    acc = torch.zeros((n, 3), dtype=torch.int32).index_add_(0, idx, st)
    return hist, acc


def upcast_bad(mask, grad_q):
    m8 = mask.to(torch.int8)
    m8 = m8.float()                            # PLANT: TL111
    return m8 * grad_q


def upcast_through_return_bad(grad, hess, sg, sh):
    _, _, gq, hq = quantize(grad, hess, sg, sh)
    return gq.float() + hq                     # PLANT: TL111


def upcast_scan_state_bad(idx, stats, n):
    q = stats.to(torch.int8)
    sums = torch.zeros((n, 3), dtype=torch.int32).index_add_(0, idx, q)
    totals = sums.cumsum(0)
    return totals.float()                      # PLANT: TL111


def dequantize_good(idx, stats, n, scales):
    q = stats.to(torch.int8)
    sums = torch.zeros((n, 3), dtype=torch.int32).index_add_(0, idx, q)
    # the sanctioned idiom: dequantize ONCE, scale applied immediately
    return sums.float() * scales


def dequantize_sums(sums):
    return sums.float()


def suppressed_variant(mask):
    m8 = mask.to(torch.int8)
    return m8.float()  # torchlint: disable=TL111
