"""Grow the first trees of a benchmark configuration on the card and write
each tree's digest, so that two checkouts' trees can be compared byte
for byte.

    python3 scripts/trees_sha_cuda.py --root DIR --config higgs \\
        --seed N --trees 40 --out FILE

``--root`` is the checkout whose ``lightgbm_tpu_torch`` grows the trees
and whose ``benchmark/`` makes the rows (``benchmark/data``, from the
seed, as the cell makes them).  ``higgs``: the higgs.train rows, trained
in chunks of 20 (``Booster.update_chunked``, as the cell drives it);
``fork_window``: the first window of fork_window.retrain, binned and
trained for 50 rounds by ``engine.train``.  The output is JSON: the
card, the sha256 of each tree's block of the model text and of the
first ``--trees`` blocks together.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


def tree_blocks(text: str) -> list:
    body = text.split("\nend of trees")[0]
    return ["Tree=" + b for b in body.split("\nTree=")[1:]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--config", choices=("higgs", "fork_window"),
                    required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--trees", type=int, default=40)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import lightgbm_tpu_torch as lt
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    cfg = json.loads((root / "benchmark" / "configs"
                      / f"{args.config}.json").read_text())
    params = dict(cfg["params"], device_type="cuda", verbose=-1)
    n = int(cfg["train_rows"])
    t0 = time.perf_counter()
    if args.config == "higgs":
        from benchmark.data.higgs import make
        x, y = make(n, args.seed, 0, dev)
        ds = lt.Dataset(x, label=y.cpu().numpy(), params=params)
        booster = lt.Booster(params=params, train_set=ds)
        while booster.num_trees() < args.trees:
            booster.update_chunked(20, 20)
    else:
        from benchmark.data.window import make
        x, y = make(n, args.seed, 10, dev, index=0,
                    drift=float(cfg.get("drift", 0.0)))
        ds = lt.Dataset(x, label=y.cpu().numpy(), params=params).construct()
        booster = lt.train(params, ds, num_boost_round=max(args.trees, 50),
                           verbose_eval=False)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    blocks = tree_blocks(booster.model_to_string())[:args.trees]
    if len(blocks) < args.trees:
        raise SystemExit(f"only {len(blocks)} trees grown")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(root=str(root), config=args.config, seed=args.seed,
               trees=args.trees, card=card.strip(), seconds=secs,
               tree_sha256=[hashlib.sha256(b.encode()).hexdigest()
                            for b in blocks],
               sha256=hashlib.sha256("".join(blocks).encode()).hexdigest())
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(config=args.config, seed=args.seed,
                          sha256=out["sha256"], seconds=round(secs, 1))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
