#!/usr/bin/env python
"""Time the codes pass of binning on the card, whole and by step.

    python scripts/ablate_binning_cuda.py [--rows N] [--reps N]
        [--device cuda|cpu]

Bins ``chip_smoke.higgs_shape(rows, 0)`` (the HIGGS shape, 28 float32
columns, max_bin 255) with ``BinnedDataset.construct_from_device_matrix``
and then times, each as a CUDA-event mean of calls queued behind a sleep
kernel (so the card's time, not the host's enqueue):

* ``codes``: ``_bin_on_device`` whole, beside its bytes bound (each input
  read once, each code written once, at 3.35 TB/s);
* three ways to lay the used columns out as (F, N) rows:
  ``select_transposed`` (``index_select`` on the transposed view: what
  ``_bin_on_device`` does), ``select_rows_transpose`` (``index_select``
  of whole rows, then a transpose copy) and ``transpose`` (the plain
  transpose copy, no selection);
* ``searchsorted``: the batched search of the (F, N) rows among the
  padded bound table.

Every way's (F, N) rows must be equal.  Prints the card's name and power
limit and one JSON line per step.  ``--device cpu --rows 20000``
rehearses the script without a card (no times).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("no card: pass --device cpu to rehearse")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip()
    else:
        card = "cpu (rehearsal: no times)"
    print(card, flush=True)
    x, _ = chip_smoke.higgs_shape(args.rows, 0)
    xd = torch.from_numpy(x).to(dev)
    ds = BinnedDataset.construct_from_device_matrix(
        xd, Config(dict(chip_smoke.TRAIN_BASE)), device=dev)
    feats = [f for g in ds.groups for f in g.feature_indices]
    cols = torch.tensor(feats, dtype=torch.int64, device=dev)
    ways = {
        "select_transposed": lambda: xd.t().index_select(0, cols),
        "select_rows_transpose":
            lambda: xd.index_select(1, cols).t().contiguous(),
        "transpose": lambda: xd.t().contiguous(),
    }
    ref = ways["select_transposed"]()
    for name, fn in ways.items():
        if not torch.equal(fn()[:len(feats)], ref):
            raise SystemExit(f"{name}: rows differ")
    width = max(len(ds.bin_mappers[f].bin_upper_bound) for f in feats)
    table = torch.full((len(feats), width), float("inf"), device=dev)
    for i, f in enumerate(feats):
        b = np.asarray(ds.bin_mappers[f].bin_upper_bound[:-1], np.float32)
        table[i, :len(b)] = torch.from_numpy(b).to(dev)
    steps = {"codes": lambda: ds._bin_on_device(xd), **ways,
             "searchsorted": lambda: torch.searchsorted(
                 table, ref, side="left", out_int32=True)}
    n, f = x.shape
    nbytes = {"codes": x.nbytes + n * ds.num_groups,
              "searchsorted": ref.numel() * 8}
    for name in ways:
        nbytes[name] = 2 * n * len(feats) * 4
    for name, fn in steps.items():
        ms = chip_smoke.time_queued_ms(fn, args.reps) if on_card else None
        bound_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        print(json.dumps(dict(step=name, rows=n, features=f, ms=ms,
                              bound_ms=bound_ms, bytes=nbytes[name],
                              card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
