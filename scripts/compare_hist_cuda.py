#!/usr/bin/env python
"""Time the wave-histogram kernels of two checkouts in turns on one card.

    python scripts/compare_hist_cuda.py OLD_ROOT NEW_ROOT [--reps N]

Runs OLD, NEW, NEW, OLD, each in its own process that imports
``lightgbm_tpu_torch`` from that checkout, builds its kernels and times
them with CUDA events at chip_smoke.py's kernel-phase shapes (2M rows,
28 groups, inputs made on the card from fixed seeds, so both checkouts
see the same data).  ``wave_hist`` is timed two ways: called as
chip_smoke.py calls it (the wrapper computes the fixed-point scales on
every call) and as the grower calls it (scales computed once a tree).
Prints one JSON line per shape with both checkouts' mean times and their
ratio, and the card's name and power limit.

Whether a kernel change left the models unchanged is read from
chip_smoke.py instead: run it in both checkouts in one call and compare
the ``model text sha256`` of each training run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CASES = [("wave_hist", 256, 3, 128, False), ("wave_hist", 256, 3, 16, False),
         ("wave_hist", 256, 3, 1, False), ("wave_hist", 64, 3, 128, False),
         ("wave_hist", 64, 3, 16, False), ("wave_hist", 64, 3, 1, False),
         ("wave_hist", 256, 3, 128, True), ("wave_hist", 256, 6, 64, True),
         ("wave_hist", 256, 3, 200, False), ("wave_hist", 256, 3, 33, False),
         ("wave_hist_v2", 64, 3, 128, False),
         ("wave_hist_v2", 256, 3, 128, False),
         ("wave_hist_v2", 64, 3, 42, False), ("wave_hist_v2", 64, 3, 4, False),
         ("wave_hist_v2", 32, 3, 1, False)]
N_ROWS, GROUPS = 2_000_000, 28


def child(root: str, reps: int) -> None:
    sys.path.insert(0, root)
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda
    assert hist_cuda.__file__.startswith(root), hist_cuda.__file__
    dev = torch.device("cuda")

    def time_ms(fn):
        fn()
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {}
    for i, (name, nb, k, w, quant) in enumerate(CASES):
        gen = torch.Generator(device=dev).manual_seed(i)
        n, g = N_ROWS, GROUPS
        bins = torch.randint(0, nb, (g, n), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)
        live = 1 if w == 1 else 2 * w + 1
        leaf = torch.randint(0, live, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        pending = torch.randperm(live, generator=gen, device=dev)[:w] \
            .to(torch.int32).contiguous()
        if quant:
            ghk = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
        else:
            ghk = (torch.randn(n, k, generator=gen, device=dev) * 0.5) \
                .to(torch.bfloat16)
        kw = dict(g=g, nb=nb, k=k, w=w)
        key = f"{name} NB={nb} K={k} W={w}{' int8' if quant else ''}"
        if name == "wave_hist":
            scale = None if quant else hist_cuda.hist_scale_exponents(ghk, n)
            out[key] = {
                "wrapper_ms": time_ms(lambda: hist_cuda.wave_hist(
                    bins, leaf, ghk, pending, leaf_bound=live, **kw)),
                "grower_ms": time_ms(lambda: hist_cuda.wave_hist(
                    bins, leaf, ghk, pending, scale_exp=scale,
                    leaf_bound=live, **kw))}
        else:
            out[key] = {"wrapper_ms": time_ms(lambda: hist_cuda.wave_hist_v2(
                bins, leaf, ghk, pending, **kw))}
        del bins, leaf, ghk
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.old, args.new = os.path.abspath(args.old), os.path.abspath(args.new)
    if args.child:
        child(args.new, args.reps)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        root = getattr(args, which)
        res = subprocess.run([sys.executable, __file__, root, root,
                              "--child", "--reps", str(args.reps)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout[-3000:], res.stderr[-3000:])
            return res.returncode
        runs[which].append(json.loads(res.stdout.strip().splitlines()[-1]))
    for key in runs["old"][0]:
        line = {"case": key, "card": card}
        for how in runs["old"][0][key]:
            old = [r[key][how] for r in runs["old"]]
            new = [r[key][how] for r in runs["new"]]
            line[how] = {"old": old, "new": new,
                         "old_over_new": (sum(old) / sum(new))}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
