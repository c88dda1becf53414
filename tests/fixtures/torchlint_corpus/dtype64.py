"""TL004 fixture: float64 numpy arrays moved to the card with no dtype."""

import numpy as np
import torch


def upload_scores(n, dev):
    a = torch.as_tensor(np.zeros(n), device=dev)  # PLANT: TL004
    rng = np.random.default_rng(0)
    g = rng.standard_normal(n)
    b = torch.from_numpy(g).to(dev)  # PLANT: TL004
    thr = np.asarray([0.5, 1.5], np.float64)
    c = torch.tensor(thr, device="cuda")  # PLANT: TL004
    d = torch.from_numpy(np.ones(n)).cuda()  # PLANT: TL004
    return a, b, c, d


def explicit_dtypes_are_clean(n, dev):
    g = np.random.default_rng(0).standard_normal(n, dtype=np.float32)
    a = torch.as_tensor(g, device=dev)                      # f32 source
    b = torch.as_tensor(np.zeros(n), dtype=torch.float32, device=dev)
    c = torch.from_numpy(np.zeros(n)).to(dev, torch.float32)
    rows = np.asarray([1.0, 2.0], np.float64)
    d = torch.as_tensor(rows, dtype=torch.float64, device=dev)  # meant
    e = torch.as_tensor(np.zeros(n), device="cpu")          # host code
    f = torch.as_tensor(np.asarray(n), device=dev)          # dtype unknown
    return a, b, c, d, e, f
