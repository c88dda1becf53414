#!/usr/bin/env python
"""Time the packed-forest kernel of two checkouts in turns on one card.

    python scripts/compare_forest_cuda.py OLD_ROOT NEW_ROOT [--reps N]
        [--sweep] [--cases a,b] [--device cpu --scale 0.001]

Runs OLD, NEW, NEW, OLD, each in its own process that imports
``lightgbm_tpu_torch`` (and ``synthetic_forests``) from that checkout,
builds its kernels and times ``serve.packed.forest_predict`` with CUDA
events on forests and query rows made from fixed seeds, so both
checkouts see the same data: a forest of the HIGGS model's shape (10
trees of 255 leaves, 28 f32 columns, 2M rows), and chip_smoke.py's own
inputs for its 500-tree synthetic forest (1M f64 rows), its K=3 slice
(500k rows), the fork harness's serving shape (8 trees of 31 leaves over
53 f64 columns, 2M rows) and the 500-tree forest at 1, 100, 1,000 and
10,000 rows, and a four-tenant fleet (500k f32 rows, f32 and bf16
values).  Each time is the mean
of many launches queued behind a sleep kernel, so that it is the card's
time and not the host's enqueue rate.  Every result is checked bit for
bit against the first checkout's.  Prints the card's name and power limit
and one JSON line per case with both checkouts' times and their ratio.

``--sweep`` times, in the NEW checkout only, each route of the kernel
forced at 1 to 300,000 rows on the synthetic, higgs-shape and fork
forests, the four-tenant fleet, a grid of forests of 8 to 500 trees of
31 or 255 leaves over 28 f32 or 53 f64 columns (the route choice of
``serve/packed.py::choose_route`` is fitted to it), and 22 forests off
that grid (4 to 64 trees, 15 to 255 leaves, up to 300 f64 columns).
``--device cpu --scale 0.001`` rehearses the script without a card (the
plain version, a thousandth of the rows, host-clock times).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

N_FEATURES = 28
SYN = dict(num_iterations=500, num_leaves=63, num_features=N_FEATURES,
           cat_features=(3, 11, 19), max_category=128)
MC = dict(num_iterations=100, num_leaves=31, num_features=N_FEATURES,
          cat_features=(7,), num_model=3)
MC_SLICE = (20, 50)         # chip_smoke.py's: iterations 20 to 69
#: (case, forest, rows, row dtype); forests are made by _forest
CASES = [("higgs_shape", "higgs", 2_000_000, "f32"),
         ("synthetic", "syn", 1_000_000, "f64"),
         ("multiclass_slice", "mc", 500_000, "f64"),
         ("fleet_f32", "fleet_f32", 500_000, "f32"),
         ("fleet_bf16", "fleet_bf16", 500_000, "f32"),
         ("fork_53", "fork", 2_000_000, "f64"),
         ("syn500_r1", "syn", 1, "f64"),
         ("syn500_r100", "syn", 100, "f64"),
         ("syn500_r1000", "syn", 1_000, "f64"),
         ("syn500_r10000", "syn", 10_000, "f64")]
SWEEP_ROWS = (1, 10, 100, 1_000, 3_000, 10_000, 30_000, 100_000, 300_000)
#: grid forests "g{trees}x{leaves}x{columns}": 28 columns are f32 rows
#: (HIGGS), others f64 (53: the fork's); the grid the route choice was
#: fitted to, then shapes between and beyond its points, checked after
#: each refit of the choice
SWEEP_FORESTS = ("syn", "higgs", "fork", "fleet_f32") + tuple(
    f"g{t}x{lv}x{nf}" for t in (8, 32, 128, 500) for lv in (31, 255)
    for nf in (28, 53)) + ("g4x31x28", "g16x31x53", "g64x63x28",
                           "g8x127x53", "g32x31x130", "g32x255x130") + (
    "g4x15x53", "g8x63x53", "g16x63x100", "g64x31x300") + (
    "g4x31x53", "g8x15x40", "g16x31x80", "g8x31x100") + (
    "g8x31x48", "g4x31x40", "g16x15x80", "g8x31x64") + (
    "g8x31x56", "g16x15x72", "g8x63x44", "g8x15x36")
#: categorical columns and query-row seed of each forest's rows: the
#: synthetic, K=3 and fork rows (and forests) are chip_smoke.py's at its
#: default --seed 0
ROWS_OF = {"higgs": ((), 101), "syn": (SYN["cat_features"], 8),
           "mc": (MC["cat_features"], 11), "fleet": (SYN["cat_features"], 104),
           "fork": ((), 15)}


def _forest(name, synthetic):
    if name == "higgs":
        return synthetic.random_forest(1, num_iterations=10, num_leaves=255,
                                       num_features=N_FEATURES)
    if name == "syn":
        return synthetic.random_forest(7, **SYN)
    if name == "mc":
        return synthetic.random_forest(10, **MC)
    if name == "fork":
        # the fork harness: 8 windows' trees of 31 leaves over its 53
        # columns (src/capi/smoke_test.cpp:24-31,86)
        return synthetic.random_forest(14, num_iterations=8, num_leaves=31,
                                       num_features=53)
    if name.startswith("g"):
        t, lv, nf = map(int, name[1:].split("x"))
        return synthetic.random_forest(t * 1000 + lv, num_iterations=t,
                                       num_leaves=lv, num_features=nf)
    raise KeyError(name)


def _sweep_dtype(forest):
    return "f32" if forest in ("higgs", "fleet_f32") or \
        forest.endswith("x28") else "f64"


def time_ms(fn, reps, dev):
    """Mean card time of ``reps`` calls queued behind a sleep kernel (the
    host enqueues them all before the card starts on them)."""
    import time
    import torch
    fn()
    if dev.type == "cpu":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _reps(rows, reps):
    return reps if rows >= 100_000 else 200


def child(root: str, reps: int, cases, sweep: bool, device: str,
          scale: float) -> None:
    sys.path.insert(0, root)
    import torch
    import synthetic_forests as synthetic
    from lightgbm_tpu_torch.serve import fleet, packed
    assert packed.__file__.startswith(root), packed.__file__
    dev = torch.device(device)
    forests, packs, xs = {}, {}, {}

    def pack(name):
        if name not in packs:
            if name.startswith("fleet"):
                gs = [_forest(f, synthetic) for f in ("higgs", "fork",
                                                      "mc", "syn")]
                gs[1] = synthetic.random_forest(
                    14, num_iterations=10, num_leaves=31,
                    num_features=N_FEATURES)
                gs[2] = synthetic.random_forest(
                    15, num_iterations=10, num_leaves=255,
                    num_features=N_FEATURES)
                packs[name] = fleet.pack_fleet(
                    gs, device=dev, value_dtype=name.split("_")[1])[0]
                forests[name] = gs[3]
            else:
                forests[name] = g = _forest(name, synthetic)
                packs[name] = (packed.pack_gbdt(g, *MC_SLICE, device=dev)
                               if name == "mc" else
                               packed.pack_gbdt(g, device=dev))
        return packs[name]

    def rows(forest, n, dtype):
        key = (forest.split("_")[0], dtype)
        if key not in xs or xs[key].shape[0] < n:
            cats, seed = ROWS_OF.get(key[0], ((), 16))
            x = synthetic.query_rows(forests[forest], max(n, 1_000), seed,
                                     cat_features=cats)
            xs[key] = torch.from_numpy(x).to(
                dev, torch.float32 if dtype == "f32" else torch.float64)
        return xs[key][:n]

    def call(pe, x, tid):
        kw = dict(num_model=pe.num_model, max_depth=pe.max_depth)
        if hasattr(pe, "records"):
            kw["records"] = pe.records
        return lambda: packed.forest_predict(pe.tables(), x, tid, **kw)

    out = {}
    for case, forest, n, dtype in CASES:
        if cases and case not in cases:
            continue
        n = max(1, int(n * scale))
        pe = pack(forest)
        x = rows(forest, n, dtype)
        tid = None
        if forest.startswith("fleet"):
            gen = torch.Generator(device=dev).manual_seed(12)
            tid = torch.randint(0, 4, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        run = call(pe, x, tid)
        res = run()
        digest = hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()
        out[case] = {"ms": time_ms(run, _reps(n, reps), dev),
                     "sha256": digest, "rows": n}
        del x, tid, run, res
    if sweep:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        out["sweep"] = []
        for forest in SWEEP_FORESTS:
            pe = pack(forest)
            tables, rec = pe.tables(), pe.records
            m_, t, nn = tables.split_feature.shape
            dtype = _sweep_dtype(forest)
            for n in SWEEP_ROWS:
                x = rows(forest, n, dtype)
                tid = None
                if m_ > 1:
                    gen = torch.Generator(device=dev).manual_seed(12)
                    tid = torch.randint(0, m_, (n,), generator=gen,
                                        device=dev, dtype=torch.int32)
                shape = dict(rows=n, trees=t, nodes=nn, nf=x.shape[1],
                             x_f64=dtype == "f64", leaves=False,
                             num_model=pe.num_model, tenants=m_,
                             sm_count=sms)
                line = {"forest": forest, **shape,
                        "auto": packed.forest_geometry(**shape).route}
                for route in ("rows", "trees"):
                    geo = packed.forest_geometry(**shape, route=route)
                    line[route + "_ms"] = time_ms(
                        lambda: packed.launch_forest(
                            rec, x, tid, geo, num_model=pe.num_model,
                            max_depth=pe.max_depth), _reps(n, reps), dev)
                out["sweep"].append(line)
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cases", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.old, args.new = os.path.abspath(args.old), os.path.abspath(args.new)
    cases = [c for c in args.cases.split(",") if c]
    if args.child:
        child(args.new, args.reps, cases, args.sweep, args.device,
              args.scale)
        return 0
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip()
            if args.device == "cuda" else "cpu rehearsal, no card")
    print(card, flush=True)
    runs = {"old": [], "new": []}
    for i, which in enumerate(("old", "new", "new", "old")):
        root = getattr(args, which)
        cmd = [sys.executable, __file__, root, root, "--child", "--reps",
               str(args.reps), "--cases", args.cases, "--device",
               args.device, "--scale", str(args.scale)]
        if args.sweep and which == "new" and i == 1 \
                and args.device == "cuda":
            cmd.append("--sweep")
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1500)
        if res.returncode:
            print(res.stdout[-3000:], res.stderr[-3000:])
            return res.returncode
        runs[which].append(json.loads(res.stdout.strip().splitlines()[-1]))
    ok = True
    for key in (k for k in runs["old"][0] if k != "sweep"):
        old = [r[key]["ms"] for r in runs["old"]]
        new = [r[key]["ms"] for r in runs["new"]]
        same = len({r[key]["sha256"] for r in runs["old"] + runs["new"]}) == 1
        ok = ok and same
        print(json.dumps({"case": key, "rows": runs["old"][0][key]["rows"],
                          "card": card, "old_ms": old, "new_ms": new,
                          "old_over_new": sum(old) / sum(new),
                          "bit_equal": same}), flush=True)
    for line in runs["new"][0].get("sweep", []):
        print(json.dumps(dict(line, card=card)), flush=True)
    if not ok:
        print("FAIL: the two checkouts' results differ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
