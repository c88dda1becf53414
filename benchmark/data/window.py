"""A window of the fork's cache-admission rows with its 53 dense columns
(``src/test.cpp:125-209``): 50 inter-arrival gaps (0 past the object's
history), round(100 log2 size), round(100 log2 cache bytes available)
and the cost; the label is the OPT-like admission of a next request
whose reuse volume is small.  A torch copy of
``chip_smoke.py::window_shape``, with the objects' popularity drifting
by ``drift`` in log-gap between consecutive windows."""

from __future__ import annotations

import torch

from benchmark.data import generator


def make(n: int, seed: int, stream: int, device, index: int = 0,
           drift: float = 0.0, **_):
    """(x (n, 53) float32, y (n,) float32): window ``index`` of the fork's
    admission rows; its log mean inter-arrival gap is centred at
    ``7 + drift * index``."""
    g = generator(seed, stream, device)
    kw = dict(generator=g, device=device, dtype=torch.float32)
    x = torch.empty((n, 53), device=device, dtype=torch.float32)
    log_mu = 7.0 + drift * index + 2.0 * torch.randn((n,), **kw)
    mu = torch.exp(log_mu)
    hist_len = torch.clamp(torch.trunc(50.0 * (1.0 - log_mu / 14.0)
                                       + 6.0 * torch.randn((n,), **kw)),
                           0, 50)
    gaps = x[:, :50]
    gaps.exponential_(1.0, generator=g)
    gaps.mul_(mu[:, None]).round_().clamp_(min=1.0)
    gaps.masked_fill_(torch.arange(50, device=device)[None, :]
                      >= hist_len[:, None], 0.0)
    size = torch.clamp(torch.exp(9.0 + 1.5 * torch.randn((n,), **kw)),
                       64.0, float(1 << 26))
    avail = torch.rand((n,), **kw) * float(1 << 30)
    x[:, 50] = torch.round(100.0 * torch.log2(size))
    x[:, 51] = torch.where(avail <= 0, 0.0,
                           torch.round(100.0 * torch.log2(
                               torch.clamp(avail, min=1.0))))
    x[:, 52] = 1.0
    volume = torch.empty((n,), device=device, dtype=torch.float32)
    volume.exponential_(1.0, generator=g)
    y = (volume * mu * size < 1.5e8).to(torch.float32)
    return x, y
