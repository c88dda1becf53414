#!/usr/bin/env python
"""How much of wave_hist_v2's time its bmat build adds: time the kernel
built whole and built without the bmat build.

    python scripts/ablate_hist_v2.py [--reps N] [--source PATH ...]

Builds ``lightgbm_tpu_torch/csrc/wave_hist_v2.cu`` with nvcc twice, at
once: whole, and from a copy whose bmat build condition is made false
(the leaf-mask x stat tile is never built; the staging, the one-hot
fragments and the products remain).
``--source`` adds the kernel built from another version of that file (the
same C entry point), to compare a candidate with the committed one.  Each
build is timed with CUDA events through ``hist_cuda.wave_hist_v2`` on
chip_smoke.py's kernel-phase inputs (2M rows, 28 groups); the whole build
and every ``--source`` build are held against the plain version first
(the ablated build's result is wrong by design).  Prints the card's name
and power limit, then one JSON line a shape: each build's ms and
``bmat_build_ms``, the whole build's ms less the ablated one's, the time
the bmat build costs beyond what hides behind the products.  Needs one
GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = [dict(nb=256, k=3, w=128), dict(nb=64, k=3, w=128),
          dict(nb=64, k=3, w=42), dict(nb=64, k=3, w=4)]
#: the condition under which a warp builds its share of the bmat tile
BUILD_GUARD = "if (build && i < BUILD_STEPS"
NO_BUILD = "if (false && i < BUILD_STEPS"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--source", action="append", default=[],
                    help="another version of csrc/wave_hist_v2.cu to time")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke
    from lightgbm_tpu_torch.ops import build, hist_cuda
    print(chip_smoke.card_line(), flush=True)
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "wave_hist_v2.cu"
    text = src.read_text()
    if text.count(BUILD_GUARD) != 1:
        print(f"{src} no longer holds the bmat build guard {BUILD_GUARD!r}")
        return 1
    ablated = out_dir / "wave_hist_v2_no_bmat_build.cu"
    ablated.write_text(text.replace(BUILD_GUARD, NO_BUILD))
    builds = [("whole", src), ("no_bmat_build", ablated)]
    builds += [(Path(p).stem, Path(p).resolve()) for p in args.source]
    jobs = {}
    for name, path in builds:
        lib = out_dir / f"libwave_hist_v2_{name}.so"
        cmd = build.nvcc_command("wave_hist_v2", lib)
        cmd[-1] = str(path)
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {name}:\n{log[-3000:]}", flush=True)
            return 1
        for line in log.splitlines():
            if "registers" in line or (
                    "spill" in line and " 0 bytes spill stores" not in line):
                print(f"  nvcc {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(lib))

    dev = torch.device("cuda")
    real_load = hist_cuda.load_library
    try:
        for i, shape in enumerate(SHAPES):
            bins, leaf, ghk, pending = chip_smoke.kernel_case(
                dev, seed=100 + i, quant=False, **shape)
            kw = dict(g=chip_smoke.N_FEATURES, **shape)
            ref = hist_cuda.wave_hist_reference(bins, leaf, ghk, pending, **kw)
            mag = hist_cuda.wave_hist_reference(bins, leaf, ghk.abs(),
                                                pending, **kw)
            line = {"shape": shape, "rows": bins.shape[1], "ms": {}}
            for name, cdll in libs.items():
                hist_cuda.load_library = lambda _name, cdll=cdll: cdll
                run = lambda: hist_cuda.wave_hist_v2(bins, leaf, ghk,
                                                     pending, **kw)
                if name != "no_bmat_build":
                    a = run()
                    if not bool(((a - ref).abs() <= 1e-4 * mag + 1e-6).all()):
                        print(f"{name} disagrees with the plain version at "
                              f"{shape}", flush=True)
                        return 1
                line["ms"][name] = chip_smoke.time_ms(run, args.reps)
            line["bmat_build_ms"] = (line["ms"]["whole"]
                                     - line["ms"]["no_bmat_build"])
            print(json.dumps(line), flush=True)
            del bins, leaf, ghk, pending, ref, mag
            torch.cuda.empty_cache()
    finally:
        hist_cuda.load_library = real_load
    return 0


if __name__ == "__main__":
    sys.exit(main())
