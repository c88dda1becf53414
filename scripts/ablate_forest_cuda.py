#!/usr/bin/env python
"""Time the packed-forest kernel's rows route at other launch geometries.

    python scripts/ablate_forest_cuda.py [--rows-per-block 256,128]
        [--chunks 0,4,16] [--cases synthetic,fork_53] [--reps N]

Times the rows route of ``lightgbm_tpu_torch/csrc/forest_predict.cu`` at
each rows per block and trees a chunk (``serve/packed.py::forest_geometry``'s
launch with that many rows and threads a block and that chunk; chunk 0
keeps the geometry's) on the large cases of
``scripts/compare_forest_cuda.py`` (the same forests and rows).  Each
time is a CUDA-event mean of launches queued behind a sleep kernel; every
geometry's scores must equal the plain version's bit for bit.  Prints the
card's name and power limit and one JSON line per case and geometry.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

LARGE = ("higgs_shape", "synthetic", "multiclass_slice", "fleet_f32",
         "fork_53")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows-per-block", default="256,128")
    ap.add_argument("--chunks", default="0,4,16")
    ap.add_argument("--cases", default=",".join(LARGE))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    import compare_forest_cuda as cf
    import synthetic_forests as synthetic
    from lightgbm_tpu_torch.serve import fleet, packed
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, forest, n, dtype in cf.CASES:
        if case not in args.cases.split(","):
            continue
        if forest.startswith("fleet"):
            gs = [cf._forest("higgs", synthetic)] + [
                synthetic.random_forest(s, num_iterations=10, num_leaves=lv,
                                        num_features=cf.N_FEATURES)
                for s, lv in ((14, 31), (15, 255))] + [
                cf._forest("syn", synthetic)]
            pe = fleet.pack_fleet(gs, device=dev,
                                  value_dtype=forest.split("_")[1])[0]
            g = gs[3]
        else:
            g = cf._forest(forest, synthetic)
            pe = (packed.pack_gbdt(g, *cf.MC_SLICE, device=dev)
                  if forest == "mc" else packed.pack_gbdt(g, device=dev))
        cats, seed = cf.ROWS_OF[forest.split("_")[0]]
        x = torch.from_numpy(synthetic.query_rows(g, n, seed,
                                                  cat_features=cats)).to(
            dev, torch.float32 if dtype == "f32" else torch.float64)
        tid = None
        if forest.startswith("fleet"):
            gen = torch.Generator(device=dev).manual_seed(12)
            tid = torch.randint(0, 4, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        tables, rec = pe.tables(), pe.records
        m_, t, nodes = tables.split_feature.shape
        kw = dict(num_model=pe.num_model, max_depth=pe.max_depth)
        want = packed.forest_predict_reference(tables, x, tid, **kw)
        base = packed.forest_geometry(
            n, t, nodes, x.shape[1], dtype == "f64", False, pe.num_model,
            tenants=m_ if tid is not None else 1, sm_count=sms, route="rows")
        variants = [(int(rb), min(t, int(c)) or base.chunk_trees)
                    for rb in args.rows_per_block.split(",")
                    for c in args.chunks.split(",")]
        for rb, c in dict.fromkeys(variants):
            smem = packed.rows_smem_bytes(
                rb, c, packed.record_words(nodes), x.shape[1],
                8 if dtype == "f64" else 4, pe.num_model, False,
                base.smem_trees, base.stage_rows)
            if smem > packed.SMEM_PER_BLOCK:
                continue
            geo = base._replace(
                rows_per_block=rb, threads=rb, chunk_trees=c,
                smem_bytes=smem,
                grid=packed._cdiv(n, rb) + (m_ if base.group_blocks else 0))
            run = lambda: packed.launch_forest(rec, x, tid, geo, **kw)
            got = run()
            torch.cuda.synchronize()
            equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
            ms = cf.time_ms(run, args.reps, dev)
            print(json.dumps({
                "case": case, "rows": n, "rows_per_block": rb,
                "chunk_trees": c,
                "geometry": (rb, c) == (base.rows_per_block,
                                        base.chunk_trees),
                "smem_bytes": smem, "ms": ms, "bit_equal": equal,
                "card": card}), flush=True)
            if not equal:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
