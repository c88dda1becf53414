"""On-card smoke run of lightgbm_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N] [--profile]

Needs one NVIDIA GPU and the CUDA toolkit; exits nonzero without them.
Phases, one line each:

1. build   -- compile every CUDA source of the package with nvcc (sm_90a),
              all sources at once;
2. kernel  -- call each kernel's wrapper on card tensors at the shapes the
              training path gives it and hold the result against the
              plain PyTorch version: int8 byte-equal, bf16 within
              1e-4 x (histogram of |stats|) + 1e-6 of it (f32 atomics in
              the plain version sum in any order) and bit-identical
              across two runs; time kernel, plain version and one PyTorch
              library call (index_put_ with accumulate) with CUDA events;
3. train   -- the HIGGS shape (28 dense features, max_bin 255, 255
              leaves, learning rate 0.1) on 2,000,000 synthetic rows made
              from --seed, 10 rounds; every wave's histogram must come
              from the kernel (launch count == waves); checks training
              AUC, the model-text round trip and host predict against the
              device training score.

Prints the card's name and power limit, a JSON line of kernel
measurements, and last {"ok": true, "device": {...}}.  Full results go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
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
        for line in log.splitlines():
            if "registers" in line:
                print(f"  nvcc {name}: {line.strip()}")
    print(f"phase build: ok {len(sources)} source(s) {sources} "
          f"in {secs:.1f} s", flush=True)
    return secs


def kernel_case(dev, *, nb, k, w, quant, seed, n=N_ROWS, g=N_FEATURES):
    """Inputs at a training-path shape: w pending leaves out of 2w+1 live
    ones (the root wave: every row in leaf 0), bf16 [g, h, 1] stats or
    int8 quantized ones."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
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
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25
        cols = [grad, hess, torch.ones(n, device=dev)][:k]
        cols += [torch.ones(n, device=dev)] * (k - len(cols))
        ghk = torch.stack(cols, 1).to(torch.bfloat16)
    return bins, leaf, ghk, pending, live


def library_hist(bins, leaf, ghk, pending, *, g, nb, k, w):
    """Yardstick only (never called by the port): the same histogram as
    one PyTorch call, index_put_ with accumulate on the flattened
    (group, bin, stat, slot) index.  Returns (thunk, out)."""
    import torch
    dev = bins.device
    size = max(int(leaf.max()), int(pending.max())) + 1
    slot_of = torch.full((size,), -1, dtype=torch.int64, device=dev)
    slot_of[pending.long()] = torch.arange(w, device=dev)
    slot = slot_of[leaf.long()]
    rows = torch.nonzero(slot >= 0).squeeze(1)
    s = slot[rows]
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
    return run, out, int(rows.numel())


def phase_kernels(dev):
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda
    g = N_FEATURES
    cases = [dict(nb=256, k=3, w=128, quant=False),
             dict(nb=256, k=3, w=16, quant=False),
             dict(nb=256, k=3, w=1, quant=False),
             dict(nb=64, k=3, w=128, quant=False),
             dict(nb=64, k=3, w=16, quant=False),
             dict(nb=64, k=3, w=1, quant=False),
             dict(nb=256, k=3, w=128, quant=True),
             dict(nb=256, k=6, w=64, quant=True)]
    results = []
    for i, c in enumerate(cases):
        nb, k, w, quant = c["nb"], c["k"], c["w"], c["quant"]
        bins, leaf, ghk, pending, live = kernel_case(dev, seed=i, **c)
        kw = dict(g=g, nb=nb, k=k, w=w)
        kern = lambda: hist_cuda.wave_hist(bins, leaf, ghk, pending,
                                           leaf_bound=live, **kw)
        a, b = kern(), kern()
        torch.cuda.synchronize()
        ref = hist_cuda.wave_hist_reference(bins, leaf, ghk, pending, **kw)
        repro = bool(torch.equal(a, b))
        err = float((a.double() - ref.double()).abs().max())
        if quant:
            ok = repro and torch.equal(a, ref)
            tol = "byte-equal"
        else:
            mag = hist_cuda.wave_hist_reference(bins, leaf, ghk.abs(),
                                                pending, **kw)
            ok = repro and bool(((a - ref).abs()
                                 <= 1e-4 * mag + 1e-6).all())
            tol = "1e-4*|hist| + 1e-6"
        ms = time_ms(kern, reps=20)
        plain_ms = time_ms(lambda: hist_cuda.wave_hist_reference(
            bins, leaf, ghk, pending, **kw), reps=2, warmup=1)
        lib_run, lib_out, m = library_hist(bins, leaf, ghk, pending, **kw)
        library_ms = time_ms(lib_run, reps=3, warmup=1)
        lib_err = float((lib_out.view(ref.shape).double()
                         - ref.double()).abs().max())
        del lib_run, lib_out
        n = bins.shape[1]
        stat_bytes = ghk.element_size() * k
        bytes_ = n * (g + 4) + m * stat_bytes + g * nb * k * w * 4
        ops = m * g * k
        bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / F32_OPS_PER_S * 1e3
        r = dict(case=c, rows=n, rows_in_wave=m, repro=repro, ok=ok,
                 tolerance=tol, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, library_max_abs_err=lib_err,
                 bound_ms=max(bound_bytes_ms, bound_ops_ms),
                 bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                 else "operations")
        results.append(r)
        print(f"  kernel wave_hist {'int8' if quant else 'bf16'} NB={nb} "
              f"K={k} W={w}: ok={ok} repro={repro} max_abs_err={err:.3g} "
              f"kernel {ms:.3f} ms, bound {r['bound_ms'] * 1e3:.1f} us "
              f"({r['bound_by']}), plain {plain_ms:.2f} ms, library "
              f"{library_ms:.2f} ms", flush=True)
        del bins, leaf, ghk, pending, a, b, ref
        torch.cuda.empty_cache()
        if not ok:
            fail(f"wave_hist disagrees with its plain version at {c}")
    print(f"phase kernel: ok {len(results)} shapes", flush=True)
    return results


def phase_train(dev, seed: int, profile: bool):
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metrics import AUCMetric
    from lightgbm_tpu_torch.ops import hist_cuda

    t0 = time.perf_counter()
    x, y = higgs_shape(N_ROWS, seed)
    gen_s = time.perf_counter() - t0
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "wave_plan": "fixed",
              "device": dev.type, "verbose": -1}
    t0 = time.perf_counter()
    ds = lt.Dataset(x, y, params=params).construct()
    bin_s = time.perf_counter() - t0

    hist_cuda.wave_hist.launches = 0          # count the main path only
    t0 = time.perf_counter()
    booster = lt.train(params, ds, num_boost_round=ROUNDS)
    train_s = time.perf_counter() - t0
    launches = hist_cuda.wave_hist.launches

    gb = booster._gbdt
    stats = gb.tree_stats
    waves = sum(s[1] for s in stats)
    syncs = sum(s[2] for s in stats)
    if launches <= 0 or launches != waves:
        fail(f"kernel launches {launches} != waves {waves}")
    trees = booster.num_trees()
    if trees != ROUNDS:
        fail(f"expected {ROUNDS} trees, got {trees}")

    score = gb.train_score[0].double().cpu().numpy()
    if not np.isfinite(score).all():
        fail("non-finite training scores")

    class _Md:
        label, weights = y, None
    auc_m = AUCMetric(None)
    auc_m.init(_Md, len(y))
    auc = auc_m.eval(score[None, :], None)[0][1]
    if auc < AUC_FLOOR:
        fail(f"training AUC {auc:.4f} below the floor {AUC_FLOOR}")

    t0 = time.perf_counter()
    raw = booster.predict(x, raw_score=True)
    predict_s = time.perf_counter() - t0
    pred_err = float(np.abs(raw - score).max())
    if pred_err > 1e-5:
        fail(f"host predict_raw vs device training score: {pred_err:.3g}")
    sub = x[:200_000]
    text = booster.model_to_string()
    again = lt.Booster(model_str=text)
    rt_err = float(np.abs(again.predict(sub) - booster.predict(sub)).max())
    if rt_err > 1e-12:
        fail(f"model text round trip moved predictions by {rt_err:.3g}")

    per_tree = [s[0] for s in stats]
    result = dict(rows=N_ROWS, features=N_FEATURES, rounds=ROUNDS,
                  trees=trees, leaves=[t.num_leaves for t in gb.models],
                  data_s=gen_s, binning_s=bin_s, train_s=train_s,
                  s_per_tree=per_tree, waves_per_tree=[s[1] for s in stats],
                  host_syncs_per_tree=[s[2] for s in stats],
                  launches=launches, waves=waves, host_syncs=syncs,
                  auc=auc, predict_s=predict_s,
                  predict_vs_score_max_abs=pred_err,
                  roundtrip_max_abs=rt_err,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9
                  if dev.type == "cuda" else None)
    print(f"phase train: ok {trees} trees, {train_s:.2f} s "
          f"({np.mean(per_tree[1:]):.3f} s/tree after the first, first "
          f"{per_tree[0]:.3f} s), {waves / trees:.1f} waves/tree, "
          f"{syncs / trees:.1f} host syncs/tree, kernel launches "
          f"{launches} == waves, AUC {auc:.4f}, predict-vs-score "
          f"{pred_err:.2g}, binning {bin_s:.1f} s", flush=True)
    if profile:
        result["profile"] = profile_tree(gb)
    return result


def profile_tree(gb):
    """Device time by kernel over one more tree (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    grower = gb._grower
    grad, hess = gb.objective.get_gradients(gb.train_score)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grower.grow_one_iter(gb.train_score[0].clone(), grad, hess)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"  profile: one tree {wall * 1e3:.1f} ms wall, "
          f"{busy:.1f} ms device busy")
    for key, ms, count in rows[:15]:
        print(f"    {ms:9.3f} ms  {count:6d}x  {key[:90]}")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                top=[dict(kernel=k, ms=m, count=c) for k, m, c in rows[:40]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one tree's device time by kernel")
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
    train = phase_train(dev, args.seed, args.profile)

    main_case = kernels[0]                    # full-width bf16 wave, NB=256
    line = {"kernels": [{
        "name": "wave_hist",
        "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/wave_hist.cu",
        "replaces": "lightgbm_tpu/ops/hist_pallas.py:218",
        "launches": train["launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke.json", "w") as fh:
        json.dump(dict(card=card, kind=kind, build_s=build_s,
                       kernels=kernels, train=train,
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
