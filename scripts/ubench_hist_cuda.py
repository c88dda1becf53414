#!/usr/bin/env python
"""Microbenchmarks of the wave-histogram hot path of lightgbm_tpu_torch on
the card: scripts/ubench_hist.py's cases, case for case.

    python scripts/ubench_hist_cuda.py [--rows N] [--groups G] [--nb NB]
        [--iters K] [--cases a,b,...] [--device cuda|cpu]

Each case prints one JSON line: milliseconds per launch, the mean of
``--iters`` launches between two CUDA events after a warm-up launch (the
host clock on ``--device cpu``, which exists only to rehearse the script
at a small ``--rows``).

* ``hist<K>_w<W>``: the port's ``wave_hist`` kernel on K stat columns
  (K=5 is the hi/lo [g_hi, g_lo, h_hi, h_lo, 1] layout) for a wave of W
  pending leaves.  Leaf ids are drawn from [0, 2W) and every launch takes
  W distinct pending ids (the kernel takes one slot per leaf).
* ``pallas2_w<W>_ch<CH>``: ``wave_hist_v2``, the tensor-core one-hot
  product, with row block CH; leaf ids from [0, 64) and pending ids
  ``(arange(W) + i) % 64``, duplicates included, as the JAX cases.
* ``compact_gather_N/<f>``, ``deep_wave_N/4_w25``: gather the rows of a
  few pending leaves into a buffer of N/f rows (torch ops); the deep wave
  then builds their histogram with ``wave_hist``.
* ``apply_unrolled_w25``, ``apply_fused_w25``: the per-row leaf update of
  25 splits, one pass per split or one pass for all (torch ops).
* ``score_update``: the bf16 hi/lo leaf-value gather of the grower.
* ``bw_copy_1GB``: read and write 1 GB, the memory-rate yardstick.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch

from lightgbm_tpu_torch.ops import hist_cuda

CHUNK = 32768


def run_case(name, step, dev, iters, flops=None, bytes_=None):
    """Time ``step(i)`` for i in 0..iters-1 after one warm-up call and
    print the case's JSON line; returns ms per call."""
    step(iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            step(i)
        end.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for i in range(iters):
            step(i)
        ms = (time.perf_counter() - t0) * 1e3 / iters
    rec = {"case": name, "ms": ms, "iters": iters}
    if flops:
        rec["tflops"] = flops / (ms / 1e3) / 1e12
    if bytes_:
        rec["gbps"] = bytes_ / (ms / 1e3) / 1e9
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--groups", type=int, default=28)
    ap.add_argument("--nb", type=int, default=64)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--cases", type=str, default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no GPU: torch.cuda.is_available() is False")
    n = (args.rows + CHUNK - 1) // CHUNK * CHUNK
    g, nb, it = args.groups, args.nb, args.iters
    gen = torch.Generator(device=dev).manual_seed(0)
    binned_t = torch.randint(0, nb, (g, n), generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)
    leaf64 = torch.randint(0, 64, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    grad = torch.randn(n, generator=gen, device=dev)
    hess = torch.rand(n, generator=gen, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"case": "setup", "rows": n, "groups": g, "nb": nb,
                      "device": name}), flush=True)
    want = set(args.cases.split(",")) if args.cases else None
    out = []

    def on(case):
        return want is None or case in want

    bf = torch.bfloat16
    ghi, hhi = grad.to(bf), hess.to(bf)
    one = torch.ones(n, dtype=bf, device=dev)
    gh5 = torch.stack([ghi, (grad - ghi.float()).to(bf), hhi,
                       (hess - hhi.float()).to(bf), one], 1)
    gh3 = torch.stack([ghi, hhi, one], 1)

    for case, ghk, w in [("hist5_w25", gh5, 25), ("hist3_w25", gh3, 25),
                         ("hist3_w42", gh3, 42), ("hist3_w4", gh3, 4),
                         ("hist3_w84", gh3, 84), ("hist3_w126", gh3, 126)]:
        if not on(case):
            continue
        k = ghk.shape[1]
        leaf = torch.randint(0, 2 * w, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        ar = torch.arange(w, device=dev, dtype=torch.int32)
        pends = [((ar + i) % (2 * w)).to(torch.int32).contiguous()
                 for i in range(it + 1)]
        scale = hist_cuda.hist_scale_exponents(ghk, n) \
            if dev.type == "cuda" else None
        out.append(run_case(
            case, lambda i, leaf=leaf, ghk=ghk, w=w, k=k, pends=pends,
            scale=scale: hist_cuda.wave_hist(
                binned_t, leaf, ghk, pends[i], g=g, nb=nb, k=k, w=w,
                scale_exp=scale, leaf_bound=2 * w),
            dev, it, flops=n * g * nb * w * k * 2))

    for case, w, ch in [("pallas2_w42_ch4096", 42, 4096),
                        ("pallas2_w128_ch4096", 128, 4096),
                        ("pallas2_w128_ch2048", 128, 2048),
                        ("pallas2_w4_ch4096", 4, 4096)]:
        if not on(case):
            continue
        ar = torch.arange(w, device=dev, dtype=torch.int32)
        pends = [((ar + i) % 64).to(torch.int32).contiguous()
                 for i in range(it + 1)]
        out.append(run_case(
            case, lambda i, w=w, ch=ch, pends=pends: hist_cuda.wave_hist_v2(
                binned_t, leaf64, gh3, pends[i], g=g, nb=nb, k=3, w=w,
                ch=ch),
            dev, it, flops=n * g * nb * w * 3 * 2))

    # ---- row gather + compact (deep-wave path) -------------------------
    def compact(m, pend):
        mask = torch.isin(leaf64, pend)
        pos = torch.cumsum(mask.int(), 0) - 1
        tgt = torch.where(mask & (pos < m), pos, m).long()
        buf = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        buf[tgt] = torch.arange(n, device=dev)   # rows past m land in m
        return buf[:m]

    pend16 = [torch.arange(16, device=dev, dtype=torch.int32) + i % 48
              for i in range(it + 1)]
    for frac in (4, 16):
        case = f"compact_gather_N/{frac}"
        if not on(case):
            continue
        m = n // frac

        def gather(i, m=m):
            buf = compact(m, pend16[i])
            return binned_t[:, buf], gh3[buf]
        out.append(run_case(case, gather, dev, it,
                            bytes_=n * 5 + m * (g + 6 + 4)))

    if on("deep_wave_N/4_w25"):
        m = n // 4

        def deep(i):
            buf = compact(m, pend16[i])
            sub_b = binned_t[:, buf].contiguous()
            sub_g = gh3[buf].contiguous()
            sub_l = leaf64[buf].contiguous()
            pend = (torch.arange(25, device=dev, dtype=torch.int32) + i) % 64
            return hist_cuda.wave_hist(sub_b, sub_l, sub_g, pend, g=g,
                                       nb=nb, k=3, w=25, leaf_bound=64)
        out.append(run_case("deep_wave_N/4_w25", deep, dev, it,
                            flops=m * g * nb * 25 * 3 * 2))

    # ---- split apply ---------------------------------------------------
    w = 25
    grp = torch.randint(0, g, (w,), generator=gen, device=dev)
    thr = torch.randint(0, nb, (w,), generator=gen, device=dev)
    rdel = torch.randint(1, 64, (w,), generator=gen, device=dev,
                         dtype=torch.int32)

    def apply_unrolled(i):
        upd = torch.zeros(n, dtype=torch.int32, device=dev)
        for j in range(w):
            goes = binned_t[grp[j]].int() > thr[j]
            upd += torch.where((leaf64 == j + i) & goes, rdel[j], 0)
        return (leaf64 + upd) % 64

    def apply_fused(i):
        goes = binned_t[grp].int() > thr[:, None]
        lsel = torch.arange(w, device=dev)[:, None] + i
        upd = (((leaf64[None, :] == lsel) & goes) * rdel[:, None]).sum(0)
        return (leaf64 + upd) % 64

    if on("apply_unrolled_w25"):
        out.append(run_case("apply_unrolled_w25", apply_unrolled, dev, it))
    if on("apply_fused_w25"):
        out.append(run_case("apply_fused_w25", apply_fused, dev, it))

    # ---- score update (the grower's bf16 hi/lo gather) ------------------
    if on("score_update"):
        score = torch.zeros(n, device=dev)
        lid = leaf64.long()

        def score_update(i):
            vals = torch.arange(256, device=dev, dtype=torch.float32) + i
            vhi = vals.to(bf)
            vlo = (vals - vhi.float()).to(bf)
            return score + (vhi.float()[lid] + vlo.float()[lid])
        out.append(run_case("score_update", score_update, dev, it,
                            bytes_=n * (4 + 8 + 4)))

    # ---- memory-rate reference ------------------------------------------
    if on("bw_copy_1GB"):
        big = torch.randn(2 ** 28, generator=gen, device=dev)
        out.append(run_case("bw_copy_1GB",
                            lambda i: big * 1.0000001 + 1e-9 * i, dev, it,
                            bytes_=2 ** 28 * 8))
    return out


if __name__ == "__main__":
    main()
