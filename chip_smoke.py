"""On-card smoke run of lightgbm_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N] [--profile]

Needs one NVIDIA GPU and the CUDA toolkit; exits nonzero without them.
Phases, one line each:

1. build   -- compile every CUDA source of the package with nvcc (sm_90a),
              all sources at once;
2. kernel  -- call each kernel's wrapper on card tensors at the shapes its
              path gives it (2M rows; wave_hist_v2 also at the ubench's
              10.5M) and hold the result against the plain PyTorch
              version: int8 byte-equal, bf16 within 1e-4 x (histogram of
              |stats|) + 1e-6 of it (the plain version's f32 atomics and
              the tensor cores sum in other orders) and bit-identical
              across two runs; wave_hist's bf16 results must also equal
              wave_hist_fixed_reference, the exact plain version of its
              fixed-point sums, bit for bit; time kernel, plain version
              and one PyTorch library call (index_put_ with accumulate)
              with CUDA events, and print beside each case's time the
              time of the kernels before their redesign, quoted from
              PERF.md (BEFORE_MS; not measured here); the bound is the
              function's (bytes or adds), and wave_hist_v2's one-hot
              product at the tensor-core peak is reported beside it as
              tc_ms;
3. ubench  -- scripts/ubench_hist_cuda.py's hist3_w42 and pallas2_*
              cases at its default 10.5M rows: the entry point of the
              tensor-core kernel wave_hist_v2, whose launches are counted
              here;
4. train   -- the HIGGS shape (28 features, max_bin 255, learning rate
              0.1) on 2,000,000 synthetic rows made from --seed, binned
              once from the dense matrix and once from a scipy CSR matrix
              (the codes must be equal), then three configurations of
              10 rounds: (a) 255 leaves, from the dense binning; from the
              CSR binning (b) the fork harness's config, 31 leaves,
              feature_fraction 0.8, bagging every 5 rounds at 0.8; (c)
              grad_quant_bits=8 at 255 leaves, run twice.  Every
              wave's histogram must come from wave_hist (launch count ==
              waves); each run checks training AUC and Booster.predict
              of all 2M rows (through forest_predict, whose launches
              are counted) bit for bit against the plain version on the
              card and within 1e-5 of the device training score, and
              prints the sha256 of its model text; (a) the model-text
              round trip; (c) byte-identical model text across its runs;
5. serve   -- csrc/forest_predict.cu, the packed-forest kernel: the higgs
              model over all 2M rows (leaves and scores also against the
              host walk on 200k rows), a synthetic forest of 500 trees
              of up to 63 leaves with deep paths, NaN/zero missing and
              multi-word bitsets over 1M edge-case rows, a K=3
              multiclass slice, and a four-tenant fleet (the three
              trained models and the synthetic one, f32 and bf16 leaf
              values), each bit-equal to the plain version, timed with
              CUDA events beside the plain version and its bound; then
              the fleet's entry point and a PredictionServer (requests
              of 1 to 100,000 rows, a swap from the harness model to the
              int8 one halfway, single-row submits from 4 threads),
              every answer bit-equal to the plain version on the served
              pack and to Booster.predict of the model then current, and
              within 1e-5 of the host walk, with p50/p95 latency per
              size.

Prints the card's name and power limit, a JSON line of kernel
measurements, and last {"ok": true, "device": {...}}.  Full results go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

N_ROWS = 2_000_000          # HIGGS has 10.5M rows; cut to keep the run short
N_FEATURES = 28
ROUNDS = 10
AUC_FLOOR = 0.80            # set from the first card run (PERF.md)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
# H100 SXM float32 rate outside the tensor cores; the kernel's adds (int64
# fixed point, int32 for int8 stats) are counted against it
F32_OPS_PER_S = 67e12
# H100 SXM dense bf16 tensor-core rate: wave_hist_v2's one-hot product
BF16_TC_OPS_PER_S = 989e12
UBENCH_CASES = ("hist3_w42", "pallas2_w42_ch4096", "pallas2_w128_ch4096",
                "pallas2_w4_ch4096")
UBENCH_ROWS = 10_518_528    # the ubench's default 10.5M rows, padded
# ms of each kernel-phase case before the kernels' redesign, quoted from
# PERF.md for the per-case lines only (chip_smoke.py's runs of that tree on
# an H100 80GB HBM3 at 700 W; the W=200, W=33 and NB=32 cases, which that
# tree's chip_smoke.py did not run, from scripts/compare_hist_cuda.py on
# the same card), keyed (kernel, NB, K, W, int8, duplicate ids, rows)
BEFORE_MS = {
    ("wave_hist", 256, 3, 128, False, False, N_ROWS): 3.696,
    ("wave_hist", 256, 3, 16, False, False, N_ROWS): 0.615,
    ("wave_hist", 256, 3, 1, False, False, N_ROWS): 0.344,
    ("wave_hist", 64, 3, 128, False, False, N_ROWS): 2.142,
    ("wave_hist", 64, 3, 16, False, False, N_ROWS): 0.417,
    ("wave_hist", 64, 3, 1, False, False, N_ROWS): 0.303,
    ("wave_hist", 256, 3, 128, True, False, N_ROWS): 1.440,
    ("wave_hist", 256, 6, 64, True, False, N_ROWS): 1.401,
    ("wave_hist", 256, 3, 200, False, False, N_ROWS): 4.896,
    ("wave_hist", 256, 3, 33, False, False, N_ROWS): 1.273,
    ("wave_hist_v2", 64, 3, 128, False, False, N_ROWS): 24.06,
    ("wave_hist_v2", 256, 3, 128, False, False, N_ROWS): 99.27,
    ("wave_hist_v2", 64, 3, 42, False, False, N_ROWS): 8.959,
    ("wave_hist_v2", 64, 3, 4, False, False, N_ROWS): 3.945,
    ("wave_hist_v2", 64, 3, 50, False, True, N_ROWS): 12.00,
    ("wave_hist_v2", 64, 3, 128, False, False, UBENCH_ROWS): 130.96,
    ("wave_hist_v2", 32, 3, 1, False, False, N_ROWS): 2.329,
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def higgs_shape(n: int, seed: int):
    """Synthetic rows with HIGGS's shape: 21 low-level kinematic columns
    (transverse momenta, pseudorapidities, azimuths, b-tags) and 7
    high-level invariant-mass columns; labels from a fixed logistic
    function of a few of them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cols = []
    for j in range(21):
        kind = j % 4
        if kind == 0:
            cols.append(rng.lognormal(0.0, 0.5, n))          # pT
        elif kind == 1:
            cols.append(rng.standard_normal(n) * 1.1)        # eta
        elif kind == 2:
            cols.append(rng.uniform(-np.pi, np.pi, n))       # phi
        else:
            cols.append(rng.choice([0.0, 1.0, 2.17], n,      # b-tag
                                   p=[0.5, 0.3, 0.2]))
    for _ in range(7):
        cols.append(rng.lognormal(0.0, 0.3, n))             # m_jj, m_jjj, ...
    x = np.stack(cols, axis=1).astype(np.float32)
    z = (1.2 * np.log(x[:, 0]) - 0.8 * np.abs(x[:, 1]) + 0.6 * x[:, 3]
         + 1.5 * np.log(x[:, 25]) - 1.0 * np.log(x[:, 27])
         + 0.4 * np.sin(x[:, 2]) * x[:, 4] + 0.5 * x[:, 7])
    p = 1.0 / (1.0 + np.exp(-(z - np.median(z)) * 1.5))
    y = (rng.random(n) < p).astype(np.float32)
    return x, y


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
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


def phase_build():
    from lightgbm_tpu_torch.ops import build
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    started = [(name, *build.start_build(name)) for name in sources]
    logs = {name: build.finish_build(proc, out)
            for name, proc, out in started}
    for name in sources:
        build.load_library(name)
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        func = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                func = line.split("Function properties for")[-1].strip()
            elif "Used" in line or ("spill" in line
                                    and " 0 bytes spill stores" not in line):
                print(f"  nvcc {name} {func[-60:]}: {line.strip()}")
    print(f"phase build: ok {len(sources)} source(s) {sources} "
          f"in {secs:.1f} s", flush=True)
    return secs


def kernel_case(dev, *, nb, k, w, quant, seed, n=N_ROWS, g=N_FEATURES,
                dup=False):
    """Inputs at a training-path shape: w pending leaves out of 2w+1 live
    ones (the root wave: every row in leaf 0), bf16 [g, h, 1] stats or
    int8 quantized ones; ``dup`` draws the pending ids with repeats."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, nb, (g, n), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    live = 1 if w == 1 else 2 * w + 1
    leaf = torch.randint(0, live, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    if dup:
        pending = torch.randint(0, w // 2, (w,), generator=gen, device=dev,
                                dtype=torch.int32)
    else:
        pending = torch.randperm(live, generator=gen, device=dev)[:w] \
            .to(torch.int32).contiguous()
    if quant:
        ghk = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.int8)
    else:
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25
        cols = [grad, hess, torch.ones(n, device=dev)][:k]
        cols += [torch.ones(n, device=dev)] * (k - len(cols))
        ghk = torch.stack(cols, 1).to(torch.bfloat16)
    return bins, leaf, ghk, pending


def library_hist(bins, leaf, ghk, pending, *, g, nb, k, w):
    """Yardstick only (never called by the port): the same histogram as
    one PyTorch call, index_put_ with accumulate on the flattened
    (group, bin, stat, slot) index of every (row, slot) pair whose leaf
    the slot holds.  Returns (thunk, out, rows in the wave)."""
    import torch
    dev = bins.device
    rows, s = torch.nonzero((leaf[:, None] == pending[None, :])
                            & (pending[None, :] >= 0), as_tuple=True)
    b = bins[:, rows].long()                                   # (G, m)
    gi = torch.arange(g, device=dev)[:, None]
    kk = torch.arange(k, device=dev)
    flat = (((gi * nb + b)[:, :, None] * k + kk) * w + s[None, :, None])
    flat = flat.reshape(-1)
    vals = ghk[rows].to(torch.float32 if ghk.dtype == torch.bfloat16
                        else torch.int32)
    vals = vals[None].expand(g, -1, -1).reshape(-1)
    out = torch.zeros(g * nb * k * w, dtype=vals.dtype, device=dev)

    def run():
        out.zero_()
        out.index_put_((flat,), vals, accumulate=True)
    return run, out, int(torch.unique(rows).numel())


def measure_case(name, kernel, dev, c, *, tensor_core=False):
    """Hold ``kernel`` (a wave-histogram wrapper) against the plain version
    at case ``c`` and time kernel, plain version and library call;
    wave_hist's bf16 result must also equal the fixed-point reference bit
    for bit."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda
    g = N_FEATURES
    nb, k, w, quant = c["nb"], c["k"], c["w"], c["quant"]
    bins, leaf, ghk, pending = kernel_case(dev, **c)
    n = bins.shape[1]
    kw = dict(g=g, nb=nb, k=k, w=w)
    run = lambda: kernel(bins, leaf, ghk, pending, **kw)
    a, b = run(), run()
    torch.cuda.synchronize()
    ref = hist_cuda.wave_hist_reference(bins, leaf, ghk, pending, **kw)
    repro = bool(torch.equal(a, b))
    err = float((a.double() - ref.double()).abs().max())
    exact = None
    if quant:
        ok = repro and torch.equal(a, ref)
        tol = "byte-equal"
    else:
        mag = hist_cuda.wave_hist_reference(bins, leaf, ghk.abs(), pending,
                                            **kw)
        ok = repro and bool(((a - ref).abs() <= 1e-4 * mag + 1e-6).all())
        tol = "1e-4*|hist| + 1e-6"
        if name == "wave_hist":
            scale = hist_cuda.hist_scale_exponents(ghk, n)
            exact = bool(torch.equal(
                a.view(torch.int32),
                hist_cuda.wave_hist_fixed_reference(
                    bins, leaf, ghk, pending, scale, **kw).view(torch.int32)))
            ok = ok and exact
            tol += ", bit-equal to wave_hist_fixed_reference"
    ms = time_ms(run, reps=20)
    plain_ms = time_ms(lambda: hist_cuda.wave_hist_reference(
        bins, leaf, ghk, pending, **kw), reps=2, warmup=1)
    lib_run, lib_out, m = library_hist(bins, leaf, ghk, pending, **kw)
    library_ms = time_ms(lib_run, reps=3, warmup=1)
    lib_err = float((lib_out.view(ref.shape).double()
                     - ref.double()).abs().max())
    del lib_run, lib_out
    # the bound is the function's, the same for both kernels: its bytes
    # (bins and leaf ids of every row, the stats of the rows in the wave,
    # the histogram out) and its operations (one add per row in the wave,
    # group and stat)
    bytes_ = n * (g + 4) + m * ghk.element_size() * k + g * nb * k * w * 4
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = m * g * k / F32_OPS_PER_S * 1e3
    # wave_hist_v2's formulation does more work than the function: the
    # dense one-hot product over B columns on the tensor cores
    tc_ms = 2 * n * g * nb * (-(-(k * w) // 8) * 8) / BF16_TC_OPS_PER_S \
        * 1e3 if tensor_core else None
    before_ms = BEFORE_MS[(name, nb, k, w, quant, bool(c.get("dup")), n)]
    r = dict(kernel=name, case=c, rows=n, rows_in_wave=m, repro=repro,
             ok=ok, tolerance=tol, max_abs_err=err, exact=exact, ms=ms,
             before_ms_quoted=before_ms, plain_ms=plain_ms,
             library_ms=library_ms, library_max_abs_err=lib_err,
             bytes_bound_ms=bound_bytes_ms, ops_bound_ms=ops_ms,
             bound_ms=max(bound_bytes_ms, ops_ms),
             bound_by="bytes" if bound_bytes_ms >= ops_ms else "operations",
             tc_ms=tc_ms)
    tc = f", one-hot product at the tensor-core peak {tc_ms:.3f} ms" \
        if tensor_core else ""
    print(f"  kernel {name} {'int8' if quant else 'bf16'} n={n} NB={nb} "
          f"K={k} W={w}{' dup' if c.get('dup') else ''}: ok={ok} "
          f"repro={repro} exact={exact} max_abs_err={err:.3g} kernel "
          f"{ms:.3f} ms (before the redesign, quoted from PERF.md: "
          f"{before_ms:.3f} ms), bound "
          f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}){tc}, plain "
          f"{plain_ms:.2f} ms, library {library_ms:.2f} ms", flush=True)
    del bins, leaf, ghk, pending, a, b, ref
    torch.cuda.empty_cache()
    if not ok:
        fail(f"{name} disagrees with its plain version at {c}")
    return r


def phase_kernels(dev):
    from lightgbm_tpu_torch.ops import hist_cuda
    v1 = [dict(nb=256, k=3, w=128, quant=False),
          dict(nb=256, k=3, w=16, quant=False),
          dict(nb=256, k=3, w=1, quant=False),
          dict(nb=64, k=3, w=128, quant=False),
          dict(nb=64, k=3, w=16, quant=False),
          dict(nb=64, k=3, w=1, quant=False),
          dict(nb=256, k=3, w=128, quant=True),
          dict(nb=256, k=6, w=64, quant=True),
          # a wave past 255 leaves (six slot tiles), and a ragged slot
          # range
          dict(nb=256, k=3, w=200, quant=False),
          dict(nb=256, k=3, w=33, quant=False)]
    v2 = [dict(nb=64, k=3, w=128, quant=False),
          dict(nb=256, k=3, w=128, quant=False),
          dict(nb=64, k=3, w=42, quant=False),
          # 12 columns: one 16-column tile
          dict(nb=64, k=3, w=4, quant=False),
          dict(nb=64, k=3, w=50, quant=False, dup=True),
          # the ubench's own row count (10.5M padded to 32768 rows) and
          # ch=4096: ~1.75M rows a split accumulated in wgmma registers
          dict(nb=64, k=3, w=128, quant=False, n=UBENCH_ROWS),
          # a warpgroup's 64 output rows straddle two groups
          dict(nb=32, k=3, w=1, quant=False)]
    results = {"wave_hist": [], "wave_hist_v2": []}
    for i, c in enumerate(v1):
        results["wave_hist"].append(measure_case(
            "wave_hist", lambda *a, live=2 * c["w"] + 1, **kw:
            hist_cuda.wave_hist(*a, leaf_bound=live, **kw), dev,
            dict(c, seed=i)))
    for i, c in enumerate(v2):
        results["wave_hist_v2"].append(measure_case(
            "wave_hist_v2", hist_cuda.wave_hist_v2, dev,
            dict(c, seed=100 + i), tensor_core=True))
    print(f"phase kernel: ok {len(v1)} + {len(v2)} shapes", flush=True)
    return results


def phase_ubench():
    """scripts/ubench_hist_cuda.py's cases that launch wave_hist_v2, at
    the script's default size, through its own entry point."""
    import importlib.util
    from lightgbm_tpu_torch.ops import hist_cuda
    spec = importlib.util.spec_from_file_location(
        "ubench_hist_cuda", ROOT / "scripts" / "ubench_hist_cuda.py")
    ubench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ubench)
    hist_cuda.wave_hist_v2.launches = 0
    lines = ubench.main(["--cases", ",".join(UBENCH_CASES)])
    launches = hist_cuda.wave_hist_v2.launches
    if launches <= 0 or sorted(r["case"] for r in lines) \
            != sorted(UBENCH_CASES):
        fail(f"ubench ran {[r['case'] for r in lines]} with "
             f"{launches} wave_hist_v2 launches")
    for r in lines:
        if not (r["ms"] > 0):
            fail(f"ubench case {r['case']} timed {r['ms']} ms")
    print(f"phase ubench: ok {len(lines)} cases, wave_hist_v2 launches "
          f"{launches}", flush=True)
    return dict(lines=lines, v2_launches=launches)


#: the kernels of csrc/wave_hist.cu, by the names the profiler reports
HIST_KERNELS = ("wave_hist_list_kernel", "row_slots_kernel",
                "tile_offsets_kernel", "scatter_rows_kernel",
                "fixed_to_f32_kernel")
TRAIN_BASE = {"objective": "binary", "max_bin": 255, "learning_rate": 0.1,
              "wave_plan": "fixed", "verbose": -1}
TRAIN_RUNS = {
    "higgs": {"num_leaves": 255},
    "harness": {"num_leaves": 31, "feature_fraction": 0.8,
                "bagging_freq": 5, "bagging_fraction": 0.8},
    "int8": {"num_leaves": 255, "grad_quant_bits": 8},
}


def auc_of(y, score) -> float:
    from lightgbm_tpu_torch.metrics import AUCMetric

    class _Md:
        label, weights = y, None
    m = AUCMetric(None)
    m.init(_Md, len(y))
    return m.eval(score[None, :], None)[0][1]


def train_run(name, ds, x, y, dev, profile=False):
    """10 rounds of one configuration on the binned Dataset ``ds``; every
    wave's histogram must come from the wave_hist kernel.  ``profile``
    adds a device-time breakdown of one more tree."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.serve import packed
    params = {**TRAIN_BASE, **TRAIN_RUNS[name], "device": dev.type}
    torch.cuda.reset_peak_memory_stats(dev)
    hist_cuda.wave_hist.launches = 0          # count this run only
    t0 = time.perf_counter()
    booster = lt.train(params, ds, num_boost_round=ROUNDS)
    train_s = time.perf_counter() - t0
    launches = hist_cuda.wave_hist.launches
    gb = booster._gbdt
    stats = gb.tree_stats
    waves = sum(s[1] for s in stats)
    syncs = sum(s[2] for s in stats)
    if launches <= 0 or launches != waves:
        fail(f"{name}: kernel launches {launches} != waves {waves}")
    trees = booster.num_trees()
    if trees != ROUNDS:
        fail(f"{name}: expected {ROUNDS} trees, got {trees}")
    score = gb.train_score[0].double().cpu().numpy()
    if not np.isfinite(score).all():
        fail(f"{name}: non-finite training scores")
    auc = auc_of(y, score)
    if auc < AUC_FLOOR:
        fail(f"{name}: training AUC {auc:.4f} below the floor {AUC_FLOOR}")
    packed.forest_predict.launches = 0        # this predict only
    t0 = time.perf_counter()
    raw = booster.predict(x, raw_score=True)
    predict_s = time.perf_counter() - t0
    predict_launches = packed.forest_predict.launches
    if predict_launches <= 0:
        fail(f"{name}: Booster.predict of {len(x)} rows launched no "
             f"forest_predict kernel")
    # the kernel's answer at this run's pack and row count, bit for bit
    # against the plain version on the card
    pe = packed.pack_gbdt(gb, device=dev)
    plain = packed.forest_predict_reference(
        pe.tables(), torch.from_numpy(x).to(dev), num_model=pe.num_model,
        max_depth=pe.max_depth)[0].double().cpu().numpy()
    if not np.array_equal(raw, plain):
        fail(f"{name}: Booster.predict through forest_predict differs from "
             f"the plain version on {int((raw != plain).sum())} rows")
    del pe, plain
    pred_err = float(np.abs(raw - score).max())
    if pred_err > 1e-5:
        fail(f"{name}: predict through forest_predict vs device training "
             f"score: {pred_err:.3g}")
    host_predict_s = None
    if name == "higgs":
        # the host walk, the only route before the kernel, on the same
        # rows in the same run
        gb.config.device_predict = "off"
        t0 = time.perf_counter()
        host_raw = booster.predict(x, raw_score=True)
        host_predict_s = time.perf_counter() - t0
        gb.config.device_predict = "auto"
        host_err = float(np.abs(host_raw - score).max())
        if host_err > 1e-5:
            fail(f"{name}: host predict vs device training score: "
                 f"{host_err:.3g}")
    per_tree = [s[0] for s in stats]
    text_sha = hashlib.sha256(booster.model_to_string().encode()).hexdigest()
    result = dict(params=params, trees=trees, model_text_sha256=text_sha,
                  leaves=[t.num_leaves for t in gb.models], train_s=train_s,
                  s_per_tree=per_tree, waves_per_tree=[s[1] for s in stats],
                  host_syncs_per_tree=[s[2] for s in stats],
                  launches=launches, waves=waves, host_syncs=syncs,
                  auc=auc, predict_s=predict_s,
                  predict_launches=predict_launches,
                  host_predict_s=host_predict_s,
                  predict_vs_score_max_abs=pred_err,
                  peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    host_note = ("" if host_predict_s is None
                 else f"; host walk {host_predict_s:.2f} s")
    print(f"  train {name}: {trees} trees, {train_s:.2f} s "
          f"({np.mean(per_tree[1:]):.4f} s/tree after the first, first "
          f"{per_tree[0]:.3f} s), {waves / trees:.1f} waves/tree, "
          f"{syncs / trees:.1f} host syncs/tree, kernel launches "
          f"{launches} == waves, AUC {auc:.4f}, predict {predict_s:.3f} s "
          f"({predict_launches} forest_predict launch{host_note}; "
          f"bit-equal to the plain version), predict-vs-score "
          f"{pred_err:.2g}, model text sha256 {text_sha}", flush=True)
    if profile:
        result["profile"] = profile_tree(gb)
    return booster, result


def phase_train(dev, seed: int, profile: bool):
    import numpy as np
    import scipy.sparse
    import lightgbm_tpu_torch as lt

    t0 = time.perf_counter()
    x, y = higgs_shape(N_ROWS, seed)
    gen_s = time.perf_counter() - t0
    # binned once from the dense matrix (the HIGGS input) and once from
    # CSR (the harness's input); the two must give the same bin codes
    t0 = time.perf_counter()
    dense = lt.Dataset(x, y, params=dict(TRAIN_BASE)).construct()
    bin_dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(scipy.sparse.csr_matrix(x), y,
                    params=dict(TRAIN_BASE)).construct()
    bin_s = time.perf_counter() - t0
    codes_d, codes_c = dense._handle.binned, ds._handle.binned
    if codes_d.shape != codes_c.shape or codes_d.dtype != codes_c.dtype \
            or not np.array_equal(codes_d, codes_c):
        fail("CSR bin codes differ from the dense matrix's")
    runs = {}

    booster, runs["higgs"] = train_run("higgs", dense, x, y, dev, profile)
    runs["higgs"]["input"] = "dense"
    del dense, codes_d, codes_c
    sub = x[:200_000]
    again = lt.Booster(model_str=booster.model_to_string())
    rt_err = float(np.abs(again.predict(sub) - booster.predict(sub)).max())
    if rt_err > 1e-12:
        fail(f"model text round trip moved predictions by {rt_err:.3g}")
    runs["higgs"]["roundtrip_max_abs"] = rt_err
    models = {"higgs": booster.model_to_string()}
    del booster, again

    booster, runs["harness"] = train_run("harness", ds, x, y, dev, profile)
    gb = booster._gbdt
    runs["harness"]["in_bag_rows"] = int(gb.row_mask.sum())
    runs["harness"]["features_per_tree"] = gb._grower._ff_k
    models["harness"] = booster.model_to_string()
    del booster, gb

    texts = []
    for rep in range(2):
        booster, res = train_run("int8", ds, x, y, dev,
                                 profile and rep == 0)
        texts.append(booster.model_to_string())
        runs[f"int8_run{rep + 1}"] = res
        del booster
    if texts[0] != texts[1]:
        fail("grad_quant_bits=8: two runs gave different model text")
    runs["int8_run2"]["model_text_identical"] = True
    models["int8"] = texts[0]
    result = dict(rows=N_ROWS, features=N_FEATURES, rounds=ROUNDS,
                  data_s=gen_s, binning_dense_s=bin_dense_s,
                  binning_csr_s=bin_s, runs=runs)
    print(f"phase train: ok {len(runs)} runs (higgs from the dense "
          f"matrix; harness, int8 x2 from CSR; int8 model text "
          f"byte-identical across runs), binning dense {bin_dense_s:.1f} s, "
          f"CSR {bin_s:.1f} s (same codes)", flush=True)
    return result, models, x


#: the serve phase's synthetic forest: 500 trees of up to 63 leaves over
#: the HIGGS width, deep paths, three categorical columns of up to 128
#: categories (four bitset words)
SYN = dict(num_iterations=500, num_leaves=63, num_features=N_FEATURES,
           cat_features=(3, 11, 19), max_category=128)
SYN_ROWS = 1_000_000
#: a multiclass forest (K=3) and the iteration slice served from it
MC = dict(num_iterations=100, num_leaves=31, num_features=N_FEATURES,
          cat_features=(7,), num_model=3)
MC_SLICE = (20, 50)
MC_ROWS = 500_000
FLEET_ROWS = 500_000
HOST_ROWS = 200_000         # higgs rows also walked on the host
SYN_HOST_ROWS = 10_000      # synthetic rows (away from thresholds) too
#: the server's request sizes and how many of each
SERVER_REQUESTS = {1: 40, 100: 40, 10_000: 20, 100_000: 6}
SUBMIT_THREADS, SUBMITS_PER_THREAD = 4, 16


def leaf_depths(tables):
    """(M, T, L) int64 depth of every leaf of ``tables`` (0 where no path
    reaches), on their device: the node visits a routed (row, tree) pair
    costs."""
    import numpy as np
    import torch
    lc = tables.left_child.cpu().numpy()
    rc = tables.right_child.cpu().numpy()
    stump = tables.is_stump.cpu().numpy()
    m_, t, n = lc.shape
    out = np.zeros((m_, t, n + 1), np.int64)
    for mi in range(m_):
        for ti in range(t):
            if stump[mi, ti]:
                continue
            stack = [(0, 0)]
            while stack:
                node, d = stack.pop()
                for c in (int(lc[mi, ti, node]), int(rc[mi, ti, node])):
                    if c < 0:
                        out[mi, ti, ~c] = d + 1
                    else:
                        stack.append((c, d + 1))
    return torch.from_numpy(out).to(tables.left_child.device)


def forest_case(name, tables, x, tid, *, num_model, max_depth, reps):
    """Hold forest_predict against its plain version on the card (scores
    and leaves, bit for bit), time both with CUDA events (inputs already
    on the card), and compute the bound: the bytes of the function (query
    rows read once, scores written once, tenant ids, the pack) at the
    memory rate, or three f32 compares a node visit that these rows make
    at the f32 rate, whichever is larger."""
    import torch
    from lightgbm_tpu_torch.serve import packed
    kw = dict(num_model=num_model, max_depth=max_depth)
    run = lambda: packed.forest_predict(tables, x, tid, **kw)
    scores = run()
    leaves = packed.forest_predict(tables, x, tid, leaves=True, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = packed.forest_predict_reference(tables, x, tid, **kw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    ref_leaves = packed.forest_predict_reference(tables, x, tid, leaves=True,
                                                 **kw)
    ok = (torch.equal(scores.view(torch.int32), ref.view(torch.int32))
          and torch.equal(leaves, ref_leaves))
    err = float((scores.double() - ref.double()).abs().max())
    ms = time_ms(run, reps=reps, warmup=1)
    r, t = leaves.shape
    depth = leaf_depths(tables)
    m_idx = (tid.long() if tid is not None
             else torch.zeros(r, dtype=torch.long, device=x.device))
    visits = int(depth[m_idx[:, None], torch.arange(t, device=x.device),
                       leaves.long()].sum())
    bytes_ = (x.numel() * x.element_size() + num_model * r * 4
              + (0 if tid is None else r * 4)
              + sum(a.numel() * a.element_size() for a in tables))
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * visits / F32_OPS_PER_S * 1e3
    res = dict(case=name, rows=r, trees=t, num_model=num_model,
               max_depth=max_depth, x_dtype=str(x.dtype), ok=ok,
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               node_visits=visits, bytes=bytes_, bytes_bound_ms=bytes_ms,
               ops_bound_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=None)
    print(f"  serve {name}: {r} rows x {t} trees (K={num_model}, depth pad "
          f"{max_depth}, {x.dtype}): bit-equal to plain={ok}, kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
          f"{res['bound_ms'] * 1e3:.1f} us ({res['bound_by']}; "
          f"{visits / (r * t):.2f} node visits a pair)", flush=True)
    if not ok:
        fail(f"forest_predict disagrees with its plain version ({name})")
    return res, scores, leaves


def host_walk(models, x64):
    """(rows, trees) leaves and (K, rows)-summed float64 raw values by the
    host Tree walk, and its seconds."""
    import numpy as np
    t0 = time.perf_counter()
    leaves = np.stack([t.predict_leaf(x64) for t in models], axis=1)
    secs = time.perf_counter() - t0
    return leaves, secs


def check_host(name, res, models, num_model, kernel_leaves, kernel_scores,
               x64):
    """The kernel's leaves equal the host walk's, its scores within 1e-5
    of the host's float64 sums."""
    import numpy as np
    host_leaves, secs = host_walk(models, x64)
    nt = len(models)
    leaves_ok = np.array_equal(kernel_leaves[:, :nt], host_leaves)
    raw = np.zeros((num_model, len(x64)))
    for i, tree in enumerate(models):
        raw[i % num_model] += tree.leaf_value[host_leaves[:, i]]
    err = float(np.abs(kernel_scores[:, :len(x64)] - raw).max())
    res.update(host_rows=len(x64), host_walk_s=secs,
               host_leaves_equal=leaves_ok, host_scores_max_abs=err)
    print(f"  serve {name}: host walk of {len(x64)} rows {secs:.2f} s, "
          f"leaves equal={leaves_ok}, scores within {err:.2g}", flush=True)
    if not leaves_ok or err > 1e-5:
        fail(f"{name}: kernel against the host walk: leaves equal "
             f"{leaves_ok}, scores {err:.3g}")


def check_fleet_host(fl, tenants, x, tid_np, res):
    """The fleet's leaves and scores on SYN_HOST_ROWS mixed-tenant HIGGS
    rows against each tenant's host walk over its own rows."""
    import numpy as np
    from lightgbm_tpu_torch.serve import fleet
    from lightgbm_tpu_torch.serve.engine import _as_gbdt
    n = SYN_HOST_ROWS
    x64 = np.ascontiguousarray(x[:n], np.float64)
    tid = tid_np[:n]
    leaves = fleet.fleet_predict_leaves(fl, tid, x64)
    scores = fleet.fleet_predict_scores(fl, tid, x64)[0]
    secs, ok, err = 0.0, True, 0.0
    for m, booster in enumerate(tenants):
        models = _as_gbdt(booster).models
        rows = tid == m
        host, s = host_walk(models, x64[rows])
        secs += s
        ok = ok and np.array_equal(leaves[rows, :len(models)], host)
        raw = sum(t.leaf_value[host[:, i]] for i, t in enumerate(models))
        err = max(err, float(np.abs(scores[rows] - raw).max()))
    res.update(host_rows=n, host_walk_s=secs, host_leaves_equal=ok,
               host_scores_max_abs=err)
    print(f"  serve fleet_f32: host walk of {n} rows over their tenants "
          f"{secs:.2f} s, leaves equal={ok}, scores within {err:.2g}",
          flush=True)
    if not ok or err > 1e-5:
        fail(f"fleet against the host walk: leaves equal {ok}, scores "
             f"{err:.3g}")


class _NoHostWalk:
    """Fails the run if a host Tree walk happens inside the block."""

    def __enter__(self):
        from lightgbm_tpu_torch.tree.tree import Tree
        self._real = Tree.predict

        def refuse(*_a, **_k):
            fail("a serving path walked the host trees with a card present")
        Tree.predict = refuse

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.tree.tree import Tree
        Tree.predict = self._real
        return False


class _Answers:
    """What the server must answer from one generation of its model: the
    plain version on the served pack, converted as the server converts
    (bit for bit); Booster.predict of the same model through the kernel
    (bit for bit); the host walk (within 1e-5)."""

    def __init__(self, dev, models):
        import lightgbm_tpu_torch as lt
        self.dev = dev
        self.kernel = {k: lt.Booster(model_str=models[k], params={
            "device": dev.type, "device_predict": "force"})
            for k in ("harness", "int8")}
        self.host = {k: lt.Booster(model_str=models[k], params={
            "device": dev.type, "device_predict": "off"})
            for k in ("harness", "int8")}
        self.host_max_abs = 0.0
        self.checked_rows = 0

    def check(self, what, name, model, rows, got):
        import numpy as np
        import torch
        from lightgbm_tpu_torch.serve import packed
        pe = model.packed
        plain = packed.forest_predict_reference(
            pe.tables(), torch.from_numpy(np.ascontiguousarray(rows))
            .to(self.dev), num_model=pe.num_model, max_depth=pe.max_depth)
        want = model.convert(plain.cpu().numpy().astype(np.float64), False)
        if not np.array_equal(got, want):
            fail(f"{what}: the server's answer differs from the plain "
                 f"version on the {name} model's served pack")
        if not np.array_equal(got, self.kernel[name].predict(rows)):
            fail(f"{what}: the server's answer differs from Booster.predict "
                 f"of the {name} model")
        err = float(np.abs(got - self.host[name].predict(rows)).max())
        self.host_max_abs = max(self.host_max_abs, err)
        self.checked_rows += len(rows)
        if err > 1e-5:
            fail(f"{what}: the server's answer is {err:.3g} from the host "
                 f"walk of the {name} model")


def serve_server(dev, models, x):
    """PredictionServer on the card: requests of each size in
    SERVER_REQUESTS, a swap from the harness model to the int8 model
    halfway, and single-row submits from several threads; every answer
    is checked by :class:`_Answers` against the model then current, after
    the timed requests, so that the checks' own work (host walks, the
    plain version's many small launches) does not sit between them."""
    import threading
    import numpy as np
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.serve import PredictionServer, packed
    answers = _Answers(dev, models)
    server = PredictionServer(lt.Booster(model_str=models["harness"]),
                              device=dev)
    server.warmup()
    current, model = "harness", server._snapshot()
    launches = 0
    served = []                 # (what, model name, generation, rows, answer)
    lat = {n: [] for n in SERVER_REQUESTS}
    plan = [n for n, reps in SERVER_REQUESTS.items() for _ in range(reps)]
    order = np.random.default_rng(1).permutation(len(plan))
    off = 0
    for i, j in enumerate(order):
        n = plan[j]
        if i == len(plan) // 2:
            server.swap(lt.Booster(model_str=models["int8"]))
            current, model = "int8", server._snapshot()
        rows = x[off:off + n]
        off = (off + n) % (len(x) - max(SERVER_REQUESTS))
        c0 = packed.forest_predict.launches
        with _NoHostWalk():
            t0 = time.perf_counter()
            got = server.predict(rows)
            lat[n].append(time.perf_counter() - t0)
        launches += packed.forest_predict.launches - c0
        served.append((f"request {i} ({n} rows)", current, model, rows, got))
    # single-row submits from several threads, micro-batched
    sub_lat, submitted, errors = [], [], []
    lock = threading.Lock()

    def client(k):
        try:
            for j in range(SUBMITS_PER_THREAD):
                r = (k * SUBMITS_PER_THREAD + j) * 97
                t0 = time.perf_counter()
                out = server.submit(x[r:r + 1]).result(timeout=60)
                with lock:
                    sub_lat.append(time.perf_counter() - t0)
                    submitted.append((r, out))
        except Exception as e:   # noqa: BLE001 -- reported below
            errors.append(repr(e))
    c0 = packed.forest_predict.launches
    with _NoHostWalk():
        with server:
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(SUBMIT_THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
    submit_launches = packed.forest_predict.launches - c0
    launches += submit_launches
    n_sub = SUBMIT_THREADS * SUBMITS_PER_THREAD
    if errors or len(submitted) != n_sub:
        fail(f"submits: {len(submitted)} of {n_sub} answered, errors "
             f"{errors[:3]}")
    submitted.sort(key=lambda a: a[0])
    served.append((f"{n_sub} submits", current, model,
                   x[[r for r, _ in submitted]],
                   np.concatenate([out for _, out in submitted])))
    for args in served:
        answers.check(*args)
    if launches <= 0:
        fail("PredictionServer launched no forest_predict kernel")
    pct = {n: (float(np.percentile(v, 50)) * 1e3,
               float(np.percentile(v, 95)) * 1e3) for n, v in lat.items()}
    sub_pct = (float(np.percentile(sub_lat, 50)) * 1e3,
               float(np.percentile(sub_lat, 95)) * 1e3)
    for n, (p50, p95) in pct.items():
        print(f"  serve server: {n} rows x {len(lat[n])} requests: p50 "
              f"{p50:.3f} ms, p95 {p95:.3f} ms", flush=True)
    print(f"  serve server: {n_sub} single-row submits from "
          f"{SUBMIT_THREADS} threads in {submit_launches} launches: p50 "
          f"{sub_pct[0]:.3f} ms, p95 {sub_pct[1]:.3f} ms; every answer "
          f"bit-equal to the plain version and Booster.predict, within "
          f"{answers.host_max_abs:.2g} of the host walk "
          f"({answers.checked_rows} rows)", flush=True)
    return dict(launches=launches, submit_launches=submit_launches,
                checked_rows=answers.checked_rows,
                host_max_abs=answers.host_max_abs,
                latency_ms={str(n): dict(p50=a, p95=b, requests=len(lat[n]))
                            for n, (a, b) in pct.items()},
                submit_latency_ms=dict(p50=sub_pct[0], p95=sub_pct[1],
                                       requests=n_sub))


def phase_serve(dev, models, x, seed: int):
    """The packed-forest kernel on the card: the trained higgs model over
    every row, a deep synthetic forest over edge-case rows, a multiclass
    slice, a four-tenant fleet (f32 and bf16 leaf values), each held bit
    for bit against the plain version; then the entry points a user
    calls, Booster.predict (train phase), fleet_predict_scores and
    PredictionServer, counted as the kernel's main-path launches."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    import synthetic_forests as synthetic
    from lightgbm_tpu_torch.serve import fleet, packed
    cases = {}
    higgs = lt.Booster(model_str=models["higgs"])._gbdt
    pe = packed.pack_gbdt(higgs, device=dev)
    xd = torch.from_numpy(x).to(dev)
    res, scores, leaves = forest_case(
        "higgs", pe.tables(), xd, None, num_model=1,
        max_depth=pe.max_depth, reps=20)
    check_host("higgs", res, higgs.models, 1,
               leaves[:HOST_ROWS].cpu().numpy(),
               scores[:, :HOST_ROWS].double().cpu().numpy(),
               np.ascontiguousarray(x[:HOST_ROWS], np.float64))
    cases["higgs"] = res
    del scores, leaves

    syn = synthetic.random_forest(seed + 7, **SYN)
    cats = SYN["cat_features"]
    pe = packed.pack_gbdt(syn, device=dev)
    xs = torch.from_numpy(synthetic.query_rows(
        syn, SYN_ROWS, seed + 8, cat_features=cats)).to(dev)
    cases["synthetic"], _, _ = forest_case(
        "synthetic", pe.tables(), xs, None, num_model=1,
        max_depth=pe.max_depth, reps=3)
    xh = synthetic.query_rows(syn, SYN_HOST_ROWS, seed + 9, near=False,
                              cat_features=cats)
    check_host("synthetic", cases["synthetic"], syn.models, 1,
               packed.predict_leaves(pe, xh), packed.predict_scores(pe, xh),
               xh)
    del xs

    mc = synthetic.random_forest(seed + 10, **MC)
    pe = packed.pack_gbdt(mc, *MC_SLICE, device=dev)
    xm = torch.from_numpy(synthetic.query_rows(
        mc, MC_ROWS, seed + 11, cat_features=MC["cat_features"])).to(dev)
    cases["multiclass_slice"], _, _ = forest_case(
        "multiclass_slice", pe.tables(), xm, None, num_model=3,
        max_depth=pe.max_depth, reps=5)
    del xm
    xh = synthetic.query_rows(mc, SYN_HOST_ROWS, seed + 13, near=False,
                              cat_features=MC["cat_features"])
    check_host("multiclass_slice", cases["multiclass_slice"],
               packed.tree_slice(mc.models, 3, *MC_SLICE), 3,
               packed.predict_leaves(pe, xh), packed.predict_scores(pe, xh),
               xh)

    tenants = [lt.Booster(model_str=models[k]) for k in
               ("higgs", "harness", "int8")] + [syn]
    rng = np.random.default_rng(seed + 12)
    tid_np = rng.integers(0, len(tenants), FLEET_ROWS).astype(np.int32)
    tid = torch.from_numpy(tid_np).to(dev)
    xf = xd[:FLEET_ROWS]
    for vdt in ("f32", "bf16"):
        fl, packs = fleet.pack_fleet(tenants, device=dev, value_dtype=vdt)
        cases[f"fleet_{vdt}"], fs, _ = forest_case(
            f"fleet_{vdt}", fl.tables(), xf, tid, num_model=1,
            max_depth=fl.max_depth, reps=3)
        if vdt == "f32":
            check_fleet_host(fl, tenants, x, tid_np, cases["fleet_f32"])
            for m, solo in enumerate(packs):
                rows = tid == m
                got = packed.forest_predict(solo.tables(), xf[rows],
                                            num_model=1,
                                            max_depth=solo.max_depth)
                if not torch.equal(fs[:, rows].view(torch.int32),
                                   got.view(torch.int32)):
                    fail(f"fleet tenant {m} differs from its solo pack")
    # the fleet's entry point, counted as main-path launches
    n = min(100_000, FLEET_ROWS)
    c0 = packed.forest_predict.launches
    with _NoHostWalk():
        t0 = time.perf_counter()
        out = fleet.fleet_predict_scores(fl, tid_np[:n], x[:n])
        fleet_s = time.perf_counter() - t0
    fleet_launches = packed.forest_predict.launches - c0
    if fleet_launches <= 0 or out.shape != (1, n) \
            or not np.isfinite(out).all():
        fail(f"fleet_predict_scores: {fleet_launches} launches, shape "
             f"{out.shape}")
    print(f"  serve fleet entry point: {n} mixed-tenant rows (bf16 leaf "
          f"values) in {fleet_s * 1e3:.1f} ms, {fleet_launches} launch",
          flush=True)
    del xd, xf

    server = serve_server(dev, models, x)
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        fail(f"serve cases failed: {bad}")
    print(f"phase serve: ok {len(cases)} kernel cases bit-equal to the "
          f"plain version; PredictionServer {server['launches']} and "
          f"fleet {fleet_launches} forest_predict launches", flush=True)
    return dict(cases=cases, server=server,
                fleet_entry_launches=fleet_launches, fleet_entry_s=fleet_s)


def profile_tree(gb):
    """Device time by kernel over one more tree (torch.profiler), with the
    run's bagging mask, feature mask and quantization key."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    grower = gb._grower
    grad, hess = gb.objective.get_gradients(gb.train_score)
    gb.bagging(gb.iter)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grower.grow_one_iter(gb.train_score[0].clone(), grad, hess,
                             feature_mask=grower.feature_mask_for(gb.iter),
                             row_mask=gb.row_mask, tree_idx=gb.iter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    # the histogram layer: every kernel of csrc/wave_hist.cu
    hist = [r for r in rows if any(name in r[0] for name in HIST_KERNELS)]
    hist_ms = sum(r[1] for r in hist)
    print(f"  profile: one tree {wall * 1e3:.1f} ms wall, "
          f"{busy:.1f} ms device busy, {hist_ms:.3f} ms in the histogram "
          f"kernels ({sum(r[2] for r in hist)} launches)")
    for key, ms, count in rows[:15]:
        print(f"    {ms:9.3f} ms  {count:6d}x  {key[:90]}")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                hist_kernel_ms=hist_ms,
                top=[dict(kernel=k, ms=m, count=c) for k, m, c in rows[:40]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more tree of each run by kernel")
    args = ap.parse_args()

    if not (ROOT / "lightgbm_tpu_torch" / "csrc").is_dir():
        fail("lightgbm_tpu_torch is not beside this script; run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a GPU")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    build_s = phase_build()
    kernels = phase_kernels(dev)
    ubench = phase_ubench()
    train, models, x = phase_train(dev, args.seed, args.profile)
    serve = phase_serve(dev, models, x, args.seed)
    del x

    # wave_hist's path is training: its launches are those of every run;
    # wave_hist_v2's path is the ubench entry point; forest_predict's is
    # prediction: Booster.predict after each training run, the fleet's
    # entry point and the PredictionServer (not the comparison launches)
    v1_launches = sum(r["launches"] for r in train["runs"].values())
    fp_launches = (sum(r["predict_launches"] for r in train["runs"].values())
                   + serve["fleet_entry_launches"]
                   + serve["server"]["launches"])
    higgs = serve["cases"]["higgs"]
    picks = [("wave_hist", kernels["wave_hist"][0], v1_launches,
              "lightgbm_tpu_torch/csrc/wave_hist.cu",
              "lightgbm_tpu/ops/hist_pallas.py:218"),
             ("wave_hist_v2", kernels["wave_hist_v2"][0],
              ubench["v2_launches"], "lightgbm_tpu_torch/csrc/wave_hist_v2.cu",
              "lightgbm_tpu/ops/hist_pallas.py:162"),
             ("forest_predict", dict(higgs, tc_ms=None), fp_launches,
              "lightgbm_tpu_torch/csrc/forest_predict.cu",
              "lightgbm_tpu/serve/packed.py:323")]
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
        "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"], "tc_ms": c["tc_ms"],
    } for name, c, launches, source, replaces in picks]}
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke.json", "w") as fh:
        json.dump(dict(card=card, kind=kind, build_s=build_s,
                       kernels=kernels, ubench=ubench, train=train,
                       serve=serve,
                       torch=torch.__version__, cuda=torch.version.cuda),
                  fh, indent=1)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONHASHSEED", "0")
    sys.exit(main())
