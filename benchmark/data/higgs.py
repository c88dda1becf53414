"""Rows with the shape of the UCI HIGGS set (Baldi et al. 2014): 21
low-level kinematic columns (transverse momenta, pseudorapidities,
azimuths, b-tags) and 7 high-level invariant masses, labelled by a fixed
logistic function of a few of them.  A torch copy of
``chip_smoke.py::higgs_shape``."""

from __future__ import annotations

import math

import torch

from benchmark.data import generator


def make(n: int, seed: int, stream: int, device, **_):
    """(x (n, 28) float32, y (n,) float32) with HIGGS's shape."""
    g = generator(seed, stream, device)
    kw = dict(generator=g, device=device, dtype=torch.float32)
    x = torch.empty((n, 28), device=device, dtype=torch.float32)
    kind = [j % 4 for j in range(21)]
    pt = [j for j in range(21) if kind[j] == 0]
    eta = [j for j in range(21) if kind[j] == 1]
    phi = [j for j in range(21) if kind[j] == 2]
    btag = [j for j in range(21) if kind[j] == 3]
    x[:, pt] = torch.exp(0.5 * torch.randn((n, len(pt)), **kw))
    x[:, eta] = 1.1 * torch.randn((n, len(eta)), **kw)
    x[:, phi] = (torch.rand((n, len(phi)), **kw) * 2.0 - 1.0) * math.pi
    u = torch.rand((n, len(btag)), **kw)
    x[:, btag] = torch.where(u < 0.5, 0.0, torch.where(u < 0.8, 1.0, 2.17))
    x[:, 21:] = torch.exp(0.3 * torch.randn((n, 7), **kw))
    z = (1.2 * torch.log(x[:, 0]) - 0.8 * x[:, 1].abs() + 0.6 * x[:, 3]
         + 1.5 * torch.log(x[:, 25]) - 1.0 * torch.log(x[:, 27])
         + 0.4 * torch.sin(x[:, 2]) * x[:, 4] + 0.5 * x[:, 7])
    p = torch.sigmoid((z - z.median()) * 1.5)
    y = (torch.rand((n,), **kw) < p).to(torch.float32)
    return x, y
