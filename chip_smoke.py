"""On-card smoke run of lightgbm_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N] [--profile]

Needs one NVIDIA GPU and the CUDA toolkit; exits nonzero without them.
Phases, one line each:

1. build   -- compile every CUDA source of the package with nvcc (sm_90a),
              all sources at once;
2. kernel  -- call each kernel's wrapper on card tensors at the shapes its
              path gives it (2M rows x 28 groups, wave_hist also at the
              lambdarank configuration's 723,412 rows x 136 groups and
              the multiclass phase's 2M rows x 20 groups; wave_hist_v2
              also at the ubench's 10.5M) and hold the result against the plain PyTorch
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
              grad_quant_bits=8 at 255 leaves, run twice.  Each trains
              through engine.train twice: fused (one chunk of 10 trees,
              each one launch of the captured tree graph, no host sync)
              and per-iteration (a callback without the eval-cadence
              mark; one host sync a tree); both must give the same
              model text, at --seed 0 the eager wave loop's sha256
              (EAGER_SHA256); a third booster trains the same chunk with
              each tree's pieces in the plain Python loop on the card
              (nothing captured), and its records, leaves, waves, int8
              scales, scores and model text must equal the fused run's
              bit for bit; wave_hist's launches, counted on the device,
              must equal the trees' waves plus the warm-up waves.
              Prints s/tree three ways, the capture, warm-up and
              instantiate seconds, peak memory after capture, 5 more
              fused chunks (s/tree median and spread, host syncs a
              chunk, a tree graph's launch in host us), for higgs the
              device cost of a stage loop that never enters (--profile:
              device busy by kernel over one fused chunk and one tree,
              quoted only when the trace holds every wave_hist launch,
              against the median unprofiled time of the same work).
              Each run checks
              training AUC and Booster.predict
              of all 2M rows (through forest_predict, whose launches
              are counted) bit for bit against the plain version on the
              card and within 1e-5 of the device training score, and
              prints the sha256 of its model text and its predict_s
              split into pack, upload, kernel, download and the rest
              (host clocks, and CUDA events around the kernel); (a) the
              model-text round trip; (c) byte-identical model text across
              its runs;
5. objectives -- two configurations at full width through engine.train,
              each checked as phase train checks its runs (fused ==
              per-iteration model text, the chunk bit-equal to the plain
              loop on the card, wave_hist launches == tree waves +
              warm-up, Booster.predict bit-equal to forest_predict's
              plain version), with 5 more fused chunks timed:
              (a) regression: L2 (metric l2) on the train phase's dense
              binning of the 2M HIGGS-shape rows, the target the fixed
              signal of higgs_shape's labels plus N(0, 0.5^2) noise
              (regression_target); floors: training l2 after 10 rounds
              below round 1's and below 0.6 var(y);
              (b) lambdarank: MSLR-WEB10K's shape (synth_mslr, a copy of
              bench.py's: 723,412 rows x 136 features over 6,000
              queries, 5 relevance levels), bench.py::run_mslr's settings
              (metric ndcg, eval_at 10, 255 leaves, min_data_in_leaf 20,
              min_sum_hessian_in_leaf 1e-3), a held-out set of 120,000
              rows over 1,000 queries binned against the training mappers
              and evaluated every round of the per-iteration run (its
              host ms printed apart); floors: held-out NDCG@10 after 10
              rounds above round 1's and 0.05 above a seeded random
              score's; the card gradient at the first tree's scores held
              against lambdarank_grad_f64 (float64, one query at a time)
              on 200+ queries of every bucket size, its ms a tree (CUDA
              events) and peak memory printed;
6. data    -- the data-on-the-device path: the 2M training rows uploaded
              and binned on the card (construct_from_device_matrix; codes
              byte-equal to the train phase's host build; the time split
              into sample, find-bins, bundling and codes, the codes also
              by CUDA events beside their bytes bound), 500,000 held-out
              rows binned on the card against the training set's mappers
              (reference=; codes byte-equal to the host's), the higgs
              configuration trained from the card's codes through GBDT
              (model text sha256 equal to the host-binned run's; launches
              == tree waves + warm-up) with the held-out set added
              (add_valid) and evaluated every round (eval_valid), scored tree by tree by
              the binned traversal: its AUC equal to Booster.predict's
              within 1e-6 and its scores within 1e-5 (forest_predict
              launches counted), the traversal's leaves equal to the host
              walk's on 200,000 rows, ms a tree on the card; then
              engine.train with the pair as valid set and early stopping;
7. boosting -- GOSS, DART and RF on the train phase's dense binning (255
              leaves), per-iteration through engine.train and Booster,
              with 500,000 held-out rows binned on the card against the
              training mappers: (a) GOSS (top_rate 0.2, other_rate 0.1,
              30 rounds, a warm-up of 10) twice with the same sha256,
              s/tree of warm-up and sampled trees, iteration 15's in-bag
              rows against top_k + other_k and its selection recomputed
              by the plain goss_partition on the CPU (buffer, count and
              multiplier bit-equal), training AUC >= AUC_FLOOR; int8 GOSS
              20 rounds twice, byte-identical text; (b) DART (drop_rate
              0.1, skip_drop 0.5, max_drop 50, drop_seed 4, 30 rounds,
              the held-out set attached): the drops of each iteration,
              s/iteration split by CUDA events into the drop, the tree and
              the normalization, the traversals counted and one timed over
              the training and the held-out rows, one iteration with drops
              grown under sync debug "error", the held-out and training
              scores equal to Booster.predict within 1e-5 of max|score|;
              (c) RF (bagging 0.8 every round, feature_fraction 0.8, 20
              rounds): predict's held-out binary_logloss within 1e-6 of
              eval_valid's, the average_output line, Booster(model_file=)
              predicting bit-equal, held-out AUC >= RF_AUC_FLOOR; every
              run's wave_hist launches == tree waves + warm-up, every
              predict bit-equal to forest_predict's plain version;
8. serve   -- csrc/forest_predict.cu, the packed-forest kernel: the higgs
              model over all 2M rows (leaves and scores also against the
              host walk on 200k rows), a synthetic forest of 500 trees
              of up to 63 leaves with deep paths, NaN/zero missing and
              multi-word bitsets over 1M edge-case rows, a K=3
              multiclass slice, a four-tenant fleet (the three trained
              models and the synthetic one, f32 and bf16 leaf values),
              and the fork harness's serving shape (8 trees of 31 leaves
              over 53 f64 columns, 2M rows), each bit-equal to the plain
              version, timed with CUDA events (launches queued behind a
              sleep kernel, so the card's time) beside the plain version,
              its bound and, for PR 4's cases, PR 4's time quoted from
              PERF.md (BEFORE_MS; not measured here); the 500-tree forest
              at 1, 100, 1,000 and 10,000 rows on the route the wrapper
              picks and on each route forced (the route crossover); then
              the fleet's entry point, a PredictionServer (requests of 1
              to 100,000 rows, a swap from the harness model to the int8
              one halfway, single-row submits from 4 threads) and a
              second one serving the 500-tree forest (requests of 1 and
              100 rows), every answer bit-equal to the plain version on
              the served pack (the trained models' also to
              Booster.predict and within 1e-5 of the host walk), with
              p50/p95 latency per size and the launches of each kernel
              route on the main path;
9. multiclass -- BASELINE.json's config 4 on an Expedia-shaped set made
              from --seed (expedia_shape: 2M rows, 11 categorical id
              columns of 4 to 60,000 ids, one in one-hot mode, and 9
              numerical ones; 100 hotel clusters; 200,000 held-out rows
              binned against the training mappers): (a) multiclass at 255
              leaves, 5 rounds per-iteration through engine.train with
              the held-out set scored by multi_logloss and multi_error
              every round; wave_hist launches == tree waves + warm-up,
              one host sync an iteration, one more tree grown under sync
              debug mode "error", round 1's 100 trees equal to the plain
              loop's on the card (model text), Booster.predict of the
              held-out rows bit-equal to forest_predict's plain version
              (also timed there as a kernel case) and its softmax within
              1e-5 of the host walk's on 20,000 rows, categorical nodes
              with raw-category bitsets past 4 words; floors: held-out
              multi_logloss after round 5 below round 1's and ln 100,
              multi_error 0.05 below a seeded random score's; prints
              s/iteration, s/tree, waves a tree, binning s, eval_valid
              host ms and peak memory; (b) binary is_booking on the same
              binned columns, 255 leaves, objective_run's checks (fused ==
              per-iteration text, with categorical splits; the chunk
              bit-equal to the plain loop; predict bit-equal to the plain
              version), and under grad_quant_bits=8 twice (byte-identical
              text, each chunk bit-equal to the plain loop).

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
MSLR_ROWS = 723_412         # MSLR-WEB10K's rows, queries and features
MSLR_QUERIES = 6000
MSLR_FEATURES = 136
# ms of each kernel-phase case before the kernels' redesign, quoted from
# PERF.md for the per-case lines only (chip_smoke.py's runs of that tree on
# an H100 80GB HBM3 at 700 W; the W=200, W=33 and NB=32 cases, which that
# tree's chip_smoke.py did not run, from scripts/compare_hist_cuda.py on
# the same card), keyed (kernel, NB, K, W, int8, duplicate ids, rows), all
# at G=28
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
# ms of each serve-phase case in PR 4 (one thread a row, the node tables
# read from L1/L2), quoted from PERF.md: chip_smoke.py's run 2 of that tree
# on an H100 80GB HBM3 at 700 W; the cases PR 4 never ran are timed against
# the parent in one call by scripts/compare_forest_cuda.py
FOREST_BEFORE_MS = {"higgs": 1.106, "synthetic": 12.11,
                    "multiclass_slice": 1.561, "fleet_f32": 6.411,
                    "fleet_bf16": 6.312}


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


def synth_mslr(rows: int, cols: int = 136, n_queries: int = 6000,
               seed: int = 7):
    """MSLR-WEB10K-shaped learning-to-rank rows (a copy of bench.py's
    synth_mslr): ``rows`` documents over ``n_queries`` queries with
    lognormal sizes (sigma 0.7, mean ~120, clipped to 5-1000, then scaled
    to ``rows``), 136 features, and 5 relevance levels from global
    quantiles of a noisy nonlinear utility with a per-query offset.  The
    scaling truncates each size, which leaves bench.py's copy ~0.4% short
    of ``rows`` (720,515 of 723,412); here the first queries take one row
    more each until the sizes sum to ``rows``.  Returns (x float32, y
    float32, query sizes)."""
    import numpy as np
    wrng = np.random.default_rng(20260731)
    w1 = wrng.standard_normal(cols).astype(np.float32) / np.sqrt(cols)
    w2 = wrng.standard_normal(cols).astype(np.float32) / np.sqrt(cols)
    rng = np.random.default_rng(seed)
    sizes = np.clip(rng.lognormal(4.45, 0.7, n_queries).astype(np.int64),
                    5, 1000)
    sizes = np.maximum((sizes * (rows / sizes.sum())).astype(np.int64), 2)
    sizes[:max(rows - int(sizes.sum()), 0)] += 1
    total = int(sizes.sum())
    x = rng.standard_normal((total, cols), dtype=np.float32)
    qoff = np.repeat(rng.standard_normal(n_queries, dtype=np.float32),
                     sizes)
    util = ((x @ w1) + 0.7 * np.abs(x @ w2) + 0.8 * qoff
            + 0.9 * rng.standard_normal(total, dtype=np.float32))
    y = np.digitize(util, np.quantile(util, [0.55, 0.75, 0.90, 0.97])) \
        .astype(np.float32)
    return x, y, sizes


def lambdarank_grad_f64(score, label, qb, label_gain, sigmoid: float,
                        max_position: int, queries=None):
    """The plain version of LambdarankNDCG's gradient: float64 numpy, one
    query at a time, its pairs as the reference's GetGradientsForOneQuery
    forms them (rank_objective.hpp) with the exact sigmoid: documents
    sorted by score (stable), every pair whose labels differ, lambda
    ``-dNDCG * 2/(1+exp(2 sigma delta))`` with ``dNDCG`` divided by
    ``0.01 + |delta|`` when the query's best and worst scores differ, and
    the inverse max DCG at ``max_position``.  Returns (grad, hess, mag) of
    the rows of ``queries`` (default all; others stay 0): ``mag`` is the
    sum of the magnitudes of a row's pair terms, the scale of its
    gradient's rounding (a row's lambdas have both signs, so the gradient
    can be far smaller than what its sum rounds at)."""
    import numpy as np
    score = np.asarray(score, np.float64)
    label = np.asarray(label).astype(np.int64)
    gains = np.asarray(label_gain, np.float64)
    grad, hess, mag = (np.zeros(len(score)) for _ in range(3))
    top = 1.0 / np.log2(np.arange(2, 2 + max_position))
    for q in (range(len(qb) - 1) if queries is None else queries):
        lo, hi = int(qb[q]), int(qb[q + 1])
        n = hi - lo
        ideal = np.sort(label[lo:hi])[::-1][:max_position]
        mdcg = float((gains[ideal] * top[:len(ideal)]).sum())
        inv = 1.0 / mdcg if mdcg > 0 else 0.0
        order = np.argsort(-score[lo:hi], kind="stable")
        ss, gl = score[lo:hi][order], label[lo:hi][order]
        disc = 1.0 / np.log2(np.arange(2, 2 + n))
        delta = ss[:, None] - ss[None, :]
        dndcg = ((gains[gl][:, None] - gains[gl][None, :])
                 * np.abs(disc[:, None] - disc[None, :]) * inv)
        if ss[0] != ss[n - 1]:
            dndcg = dndcg / (0.01 + np.abs(delta))
        sig = 2.0 / (1.0 + np.exp(2.0 * sigmoid * delta))
        pair = gl[:, None] > gl[None, :]
        lam = np.where(pair, -dndcg * sig, 0.0)
        hes = np.where(pair, 2.0 * dndcg * sig * (2.0 - sig), 0.0)
        grad[lo + order] = lam.sum(1) - lam.sum(0)
        hess[lo + order] = hes.sum(1) + hes.sum(0)
        mag[lo + order] = np.abs(lam).sum(1) + np.abs(lam).sum(0)
    return grad, hess, mag


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


def time_queued_ms(fn, reps: int) -> float:
    """Mean card time of ``reps`` calls queued behind a sleep kernel: the
    host enqueues them all before the card starts on them, so a kernel
    shorter than its wrapper's host work is timed, not the enqueue rate."""
    import torch
    fn()
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


def forest_counts():
    """forest_predict's launch count and its count by route."""
    from lightgbm_tpu_torch.serve import packed
    return packed.forest_predict.launches, dict(packed.forest_predict.routes)


def counts_since(before):
    launches, routes = forest_counts()
    return launches - before[0], {k: v - before[1][k]
                                  for k, v in routes.items()}


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
    g = c.get("g", N_FEATURES)
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
    # None for the cases added after the redesign (G=136, G=20)
    before_ms = BEFORE_MS.get((name, nb, k, w, quant, bool(c.get("dup")),
                               n)) if g == N_FEATURES else None
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
    before = ("not run before the redesign" if before_ms is None else
              f"before the redesign, quoted from PERF.md: {before_ms:.3f} "
              f"ms")
    print(f"  kernel {name} {'int8' if quant else 'bf16'} n={n} G={g} "
          f"NB={nb} K={k} W={w}{' dup' if c.get('dup') else ''}: ok={ok} "
          f"repro={repro} exact={exact} max_abs_err={err:.3g} kernel "
          f"{ms:.3f} ms ({before}), bound "
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
          dict(nb=256, k=3, w=33, quant=False),
          # the lambdarank configuration's shape: MSLR-WEB10K's 136
          # feature groups over its 723,412 rows
          dict(nb=256, k=3, w=128, quant=False, g=MSLR_FEATURES,
               n=MSLR_ROWS),
          # the multiclass phase's: the Expedia-shaped set's 20 groups
          # over its 2M rows
          dict(nb=256, k=3, w=128, quant=False, g=EXPEDIA_FEATURES,
               n=EXPEDIA_ROWS)]
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
    # phase objectives: BASELINE.json's L2-regression config on the HIGGS
    # matrix, and bench.py::run_mslr's lambdarank settings
    "regression": {"objective": "regression", "metric": "l2",
                   "num_leaves": 255},
    "lambdarank": {"objective": "lambdarank", "metric": "ndcg",
                   "eval_at": [10], "num_leaves": 255,
                   "min_data_in_leaf": 20, "min_sum_hessian_in_leaf": 1e-3},
}


class PredictSplit:
    """Splits one Booster.predict into its parts, measurement only: host
    clocks (ending in a synchronize) around the pack (the node records
    included), the upload of the query rows, the kernel launch (CUDA
    events too) and the download (with the wrapper's checks), wrapped
    around the package's own functions for the time of the block; the rest
    is the host's numpy work around them."""

    def __enter__(self):
        import torch
        from lightgbm_tpu_torch.serve import packed
        self.real = {f: getattr(packed, f) for f in
                     ("pack_ensemble", "query_tensor", "launch_forest",
                      "predict_scores")}
        self.s = dict(pack=0.0, upload=0.0, kernel=0.0, predict_scores=0.0,
                      kernel_events_ms=0.0)
        real = self.real

        def clocked(name, fn, after=None):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if after:
                    after(out)
                torch.cuda.synchronize()
                self.s[name] += time.perf_counter() - t0
                return out
            return run

        def kernel(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real["launch_forest"](*a, **k)
            end.record()
            torch.cuda.synchronize()
            self.s["kernel_events_ms"] += start.elapsed_time(end)
            return out
        packed.pack_ensemble = clocked("pack", real["pack_ensemble"],
                                       lambda pe: pe.records)
        packed.query_tensor = clocked("upload", real["query_tensor"])
        packed.launch_forest = clocked("kernel", kernel)
        packed.predict_scores = clocked("predict_scores",
                                        real["predict_scores"])
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.serve import packed
        for name, fn in self.real.items():
            setattr(packed, name, fn)
        return False

    def split(self, total_s: float) -> dict:
        s = self.s
        download = s["predict_scores"] - s["upload"] - s["kernel"]
        return dict(pack_s=s["pack"], upload_s=s["upload"],
                    kernel_s=s["kernel"],
                    kernel_ms_events=s["kernel_events_ms"],
                    download_s=download,
                    other_s=total_s - s["pack"] - s["predict_scores"])


def auc_of(y, score) -> float:
    from lightgbm_tpu_torch.metrics import AUCMetric

    class _Md:
        label, weights = y, None
    m = AUCMetric(None)
    m.init(_Md, len(y))
    return m.eval(score[None, :], None)[0][1]


#: model text sha256 of each training configuration at --seed 0 from the
#: eager wave loop (chip_smoke.py on an H100 80GB HBM3 at 700 W before the
#: trees were captured); the captured tree must keep every split, so every
#: text, on both paths
EAGER_SHA256 = {
    "higgs":
        "ef39698fcaafab3854b57e741e10d0641782052c8613388029d3ee03f8d7652e",
    "harness":
        "a6018d29ed36751a338dfc4d284379a036f65c4f066306c4724b84eecc28a0c4",
    "int8":
        "b7bbd432e452ceecd9cb79b96fdfe66cbc0bf0a1de06f477db89c23ef306fb5d",
}
#: repeated fused chunks of the higgs configuration timed after its run
FUSED_REPEATS = 5


def _per_iteration(env):
    """A user callback without the eval_cadence_only mark: engine.train
    then drives one iteration at a time (the per-iteration path), with
    the same params, so the same model text."""


def train_path(name, ds, dev, path, seed, valid=None):
    """``engine.train`` of one configuration on one path ("fused": one
    chunk of ROUNDS trees; "per_iteration"): the booster and what the run
    counted.  wave_hist's launches, counted on the device, must equal the
    waves of the run's trees (each tree's own count) plus the warm-up
    waves before the capture.  ``valid`` (per-iteration only: a valid set
    makes engine.train evaluate, so stop, every iteration) is evaluated
    every round into the result's ``evals``."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda
    params = {**TRAIN_BASE, **TRAIN_RUNS[name], "device": dev.type}
    torch.cuda.reset_peak_memory_stats(dev)
    hist_cuda.wave_hist.launches.reset()          # count this run only
    torch.cuda.synchronize(dev)
    evals = {}
    t0 = time.perf_counter()
    booster = lt.train(params, ds, num_boost_round=ROUNDS,
                       callbacks=None if path == "fused"
                       else [_per_iteration],
                       valid_sets=None if valid is None else [valid],
                       evals_result=evals)
    text = booster.model_to_string()
    train_s = time.perf_counter() - t0
    gb = booster._gbdt
    grower = gb._grower
    launches = hist_cuda.wave_hist.launches.read()
    stats = gb.tree_stats
    waves = sum(s[2] for s in stats)
    syncs = [s[3] for s in stats]
    cap = dict(grower.capture_stats)
    if launches <= 0 or launches != waves + cap["warmup_waves"]:
        fail(f"{name} {path}: wave_hist launches {launches} (device "
             f"counter) != tree waves {waves} + warm-up "
             f"{cap['warmup_waves']}")
    chunks = [s[1] for s in stats]
    want = [ROUNDS] if path == "fused" else [1] * ROUNDS
    if chunks != want:
        fail(f"{name} {path}: dispatches of {chunks} trees, expected {want}")
    if path == "fused" and syncs != [0]:
        fail(f"{name}: the fused chunk made {syncs} host syncs")
    if path == "per_iteration" and syncs != [1] * ROUNDS:
        fail(f"{name}: per-iteration host syncs {syncs}, one a tree "
             f"expected")
    sha = hashlib.sha256(text.encode()).hexdigest()
    if seed == 0 and name in EAGER_SHA256 and sha != EAGER_SHA256[name]:
        fail(f"{name} {path}: model text sha256 {sha}, the eager wave "
             f"loop's {EAGER_SHA256[name]}")
    score = gb.train_score[0].double().cpu().numpy()
    if not np.isfinite(score).all():
        fail(f"{name} {path}: non-finite training scores")
    res = dict(path=path, train_s=train_s, s_per_tree=train_s / ROUNDS,
               model_text_sha256=sha, launches=launches, waves=waves,
               waves_per_tree=waves / ROUNDS, host_syncs=syncs,
               dispatch_s=[s[0] for s in stats], capture=cap,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               reserved_gb=torch.cuda.memory_reserved(dev) / 1e9,
               evals=evals)
    return booster, score, res


CHUNK_FIELDS = ("rec_i", "rec_f", "nl", "waves", "qscales", "rec_c")


def plain_chunk(name, ds, dev, booster):
    """The plain version of the fused path on the card, at the main path's
    inputs: a new booster on the same Dataset trains its chunk of ROUNDS
    trees with each tree's pieces run by the Python loop that reads the
    control words (``DeviceGrower._run_pieces``: a host read a wave,
    nothing captured).  The chunk's records (split records, leaves, waves,
    int8 scales, categorical bin sets), the training scores and the model text must equal the
    fused run's bit for bit.  Returns the loop's seconds a tree."""
    import torch
    import lightgbm_tpu_torch as lt
    params = {**TRAIN_BASE, **TRAIN_RUNS[name], "device": dev.type}
    plain = lt.Booster(params, ds)
    grower = plain._gbdt._grower
    grower._graph = lambda sample: None       # capture nothing
    grower._run_tree = grower._run_pieces     # the loop, not the graph
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    plain.update_chunked(ROUNDS, chunk=ROUNDS)
    torch.cuda.synchronize(dev)
    plain_s = (time.perf_counter() - t0) / ROUNDS
    if grower._composed or grower._graphs is not None:
        fail(f"{name}: the plain loop captured a graph")
    got = booster._gbdt._last_chunk_stack.host()
    want = plain._gbdt._last_chunk_stack.host()
    for field, a, b in zip(CHUNK_FIELDS, got, want):
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            fail(f"{name}: the captured chunk's {field} differs from the "
                 f"plain loop's on the card")
    a, b = booster._gbdt.train_score[0], plain._gbdt.train_score[0]
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        fail(f"{name}: the captured chunk's training scores differ from "
             f"the plain loop's on {int((a != b).sum())} rows")
    if plain.model_to_string() != booster.model_to_string():
        fail(f"{name}: the plain loop's model text differs from the "
             f"captured chunk's")
    return plain_s


def time_fused_chunks(booster, dev):
    """FUSED_REPEATS fused chunks of ROUNDS trees on a trained booster
    after one untimed chunk (its first captures the fused graphs), each
    timed on the host clock to a synchronize (s/tree), with the host time
    until the dispatch returned and the waves its trees took, and the
    launch of one composed tree graph alone (host us)."""
    import torch
    gb = booster._gbdt
    gb.train_chunked(ROUNDS, chunk=ROUNDS)
    per_tree, dispatch, syncs = [], [], []
    for _ in range(FUSED_REPEATS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        gb.train_chunked(ROUNDS, chunk=ROUNDS)
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
        per_tree.append((time.perf_counter() - t0) / ROUNDS)
        dispatch.append((t1 - t0) / ROUNDS)
        syncs.append(gb._stats[-1][3])
    waves = [s[2] / s[1] for s in gb.tree_stats[-FUSED_REPEATS:]]
    graph = gb._grower._graph(False)
    gb._grower._st.ctl[3:4].zero_()           # chunk slots 0..ROUNDS-1
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        graph.launch()
    launch_us = (time.perf_counter() - t0) / ROUNDS * 1e6
    torch.cuda.synchronize(dev)
    return dict(s_per_tree=per_tree, dispatch_s_per_tree=dispatch,
                waves_per_tree=waves, host_syncs_per_chunk=syncs,
                launch_host_us=launch_us)


def skipped_loop_cost(grower, dev):
    """Device ms of a stage loop whose condition is false at entry: the
    grower's start and finish pieces composed with its stage loops at
    limit 0 (they never enter), against the two pieces alone, queued
    behind a sleep kernel; per loop."""
    from lightgbm_tpu_torch.ops import graphs
    p = grower._graphs
    ctl = grower._st.ctl
    n = len(p["waves"])
    looped = graphs.compose([(p["start"], None)]
                            + [(w, 0) for w in p["waves"]]
                            + [(p["finish"], None)], ctl)
    plain = graphs.compose([(p["start"], None), (p["finish"], None)], ctl)
    slot = ctl[3:4]

    def run(graph):
        # every launch writes chunk slot 0 (the finish piece)
        def once():
            slot.zero_()
            graph.launch()
        return once
    ms_loops = time_queued_ms(run(looped), reps=20)
    ms_plain = time_queued_ms(run(plain), reps=20)
    looped.close()
    plain.close()
    return dict(stages=n, with_loops_ms=ms_loops, without_ms=ms_plain,
                per_skipped_loop_us=(ms_loops - ms_plain) / n * 1e3)


def predict_checked(name, booster, x, score, dev, bar=1e-5,
                    keep_raw=False) -> dict:
    """``Booster.predict`` of every training row (raw scores), timed and
    split (PredictSplit): it must launch forest_predict (counted), equal
    the kernel's plain version on the card bit for bit (an averaged
    model's sums divided by its iterations, as predict divides them) and
    the device score ``score`` of the same rows within ``bar``.
    ``keep_raw`` returns the predictions too, under "raw"."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.serve import packed
    packed.forest_predict.launches = 0        # this predict only
    packed.forest_predict.routes = {k: 0 for k in packed.forest_predict.routes}
    with PredictSplit() as clocks:
        t0 = time.perf_counter()
        raw = booster.predict(x, raw_score=True)
        predict_s = time.perf_counter() - t0
    split = clocks.split(predict_s)
    predict_launches = packed.forest_predict.launches
    predict_routes = dict(packed.forest_predict.routes)
    if predict_launches <= 0:
        fail(f"{name}: Booster.predict of {len(x)} rows launched no "
             f"forest_predict kernel")
    # the kernel's answer at this run's pack and row count, bit for bit
    # against the plain version on the card
    pe = packed.pack_gbdt(booster._gbdt, device=dev)
    plain_pred = packed.forest_predict_reference(
        pe.tables(), torch.from_numpy(x).to(dev), num_model=pe.num_model,
        max_depth=pe.max_depth)[0].double().cpu().numpy()
    if booster._gbdt.average_output:
        plain_pred = plain_pred / booster._gbdt.num_iterations()
    if not np.array_equal(raw, plain_pred):
        fail(f"{name}: Booster.predict through forest_predict differs from "
             f"the plain version on {int((raw != plain_pred).sum())} rows")
    del pe, plain_pred
    pred_err = float(np.abs(raw - score).max())
    if pred_err > bar:
        fail(f"{name}: predict through forest_predict vs device "
             f"score: {pred_err:.3g} (bar {bar:.3g})")
    out = dict(predict_s=predict_s, predict_split=split,
               predict_launches=predict_launches,
               predict_routes=predict_routes,
               predict_vs_score_max_abs=pred_err)
    if keep_raw:
        out["raw"] = raw
    return out


def train_run(name, ds, x, y, dev, seed, profile=False):
    """10 rounds of one configuration on the binned Dataset ``ds``,
    through engine.train's fused path (one chunk of 10 captured trees)
    and its per-iteration path: both must give the same model text (at
    --seed 0 the eager wave loop's), the fused chunk must equal the plain
    loop of its pieces on the card bit for bit, and every wave's
    histogram must come from the wave_hist kernel.  The fused booster's
    predictions are checked.  ``profile`` adds a device-time breakdown of
    one per-iteration tree and of one fused chunk."""
    import numpy as np
    from lightgbm_tpu_torch.ops import hist_cuda
    booster, score, fused = train_path(name, ds, dev, "fused", seed)
    spare, _, plain = train_path(name, ds, dev, "per_iteration", seed)
    if plain["model_text_sha256"] != fused["model_text_sha256"]:
        fail(f"{name}: the per-iteration model text "
             f"{plain['model_text_sha256']} differs from the fused "
             f"{fused['model_text_sha256']}")
    loop_s = plain_chunk(name, ds, dev, booster)
    gb = booster._gbdt
    trees = booster.num_trees()
    if trees != ROUNDS:
        fail(f"{name}: expected {ROUNDS} trees, got {trees}")
    auc = auc_of(y, score)
    if auc < AUC_FLOOR:
        fail(f"{name}: training AUC {auc:.4f} below the floor {AUC_FLOOR}")
    pred = predict_checked(name, booster, x, score, dev)
    predict_s, split = pred["predict_s"], pred["predict_split"]
    predict_launches = pred["predict_launches"]
    predict_routes = pred["predict_routes"]
    pred_err = pred["predict_vs_score_max_abs"]
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
    per_iter = plain["dispatch_s"]
    result = dict(params={**TRAIN_BASE, **TRAIN_RUNS[name]}, trees=trees,
                  model_text=booster.model_to_string(),
                  model_text_sha256=fused["model_text_sha256"],
                  leaves=[t.num_leaves for t in gb.models],
                  fused=fused, per_iteration=plain,
                  plain_loop_s_per_tree=loop_s,
                  launches=fused["launches"] + plain["launches"],
                  auc=auc, predict_s=predict_s, predict_split=split,
                  predict_launches=predict_launches,
                  predict_routes=predict_routes,
                  host_predict_s=host_predict_s,
                  predict_vs_score_max_abs=pred_err)
    cap = fused["capture"]
    host_note = ("" if host_predict_s is None
                 else f"; host walk {host_predict_s:.2f} s")
    eager_note = " == the eager loop's" if seed == 0 else ""
    print(f"  train {name}: {trees} trees, fused {fused['train_s']:.3f} s "
          f"(one chunk, {fused['host_syncs'][0]} host syncs, capture "
          f"included: warm-up {cap['warmup_s']:.3f} + capture "
          f"{cap['capture_s']:.3f} + instantiate {cap['instantiate_s']:.3f}"
          f" s for {cap['graphs']} composed graph(s)), per-iteration "
          f"{plain['train_s']:.3f} s ({np.mean(per_iter[1:]):.4f} s/tree "
          f"after the first, 1 host sync a tree); "
          f"{fused['waves_per_tree']:.1f} waves/tree, wave_hist launches "
          f"{fused['launches']} + {plain['launches']} == tree waves + "
          f"warm-up {cap['warmup_waves']} each; peak memory "
          f"{fused['peak_mem_gb']:.2f} GB after capture "
          f"({fused['reserved_gb']:.2f} GB reserved); AUC {auc:.4f}; the "
          f"chunk == the plain loop of its pieces on the card bit for bit "
          f"(records, leaves, waves, scales, scores; {loop_s:.4f} s/tree); "
          f"model text sha256 {fused['model_text_sha256']} on both paths"
          f"{eager_note}", flush=True)
    print(f"  train {name}: predict {predict_s:.4f} s ({predict_launches} "
          f"forest_predict launch, routes {predict_routes}{host_note}; "
          f"bit-equal to the plain version), predict-vs-score "
          f"{pred_err:.2g}; predict_s = pack {split['pack_s']:.4f} + upload "
          f"{split['upload_s']:.4f} + kernel {split['kernel_s']:.4f} (events "
          f"{split['kernel_ms_events']:.3f} ms) + download "
          f"{split['download_s']:.4f} + rest {split['other_s']:.4f} s",
          flush=True)
    # after the checks: more fused chunks, timed, on the per-iteration
    # run's booster (the same model; the checked booster keeps its trees)
    gbs = spare._gbdt
    timing = time_fused_chunks(spare, dev)
    result["fused_repeats"] = timing
    st = sorted(timing["s_per_tree"])
    pi = sorted(per_iter[1:])
    skip_note = ""
    if name == "higgs":
        skip = result["skipped_loop"] = skipped_loop_cost(gbs._grower, dev)
        skip_note = (f"; a stage loop that never enters "
                     f"{skip['per_skipped_loop_us']:.2f} us of device time "
                     f"({skip['stages']} stages)")
    print(f"  train {name}: {FUSED_REPEATS} more fused chunks of {ROUNDS}: "
          f"s/tree median {st[len(st) // 2]:.5f} (min {st[0]:.5f}, max "
          f"{st[-1]:.5f}); per-iteration trees 2-{ROUNDS}: median "
          f"{pi[len(pi) // 2]:.5f} (min {pi[0]:.5f}, max {pi[-1]:.5f}); "
          f"a fused dispatch returns after "
          f"{np.median(timing['dispatch_s_per_tree']) * 1e3:.3f} ms a tree, "
          f"waves a tree {timing['waves_per_tree']}, "
          f"host syncs a chunk {timing['host_syncs_per_chunk']}, one tree "
          f"graph's launch {timing['launch_host_us']:.1f} us of host"
          f"{skip_note}", flush=True)
    if profile:
        hist_cuda.wave_hist.launches.reset()      # this chunk only
        prof = result["profile_chunk"] = profile_ops(
            f"{name}: one fused chunk of {ROUNDS} trees",
            lambda: gbs.train_chunked(ROUNDS, chunk=ROUNDS), waves=True)
        if prof["complete"]:
            print(f"  profile {name}: "
                  f"{unprofiled_idle('a fused chunk', prof, st, ROUNDS)}",
                  flush=True)
        result["profile"] = profile_tree(gb, pi)
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

    booster, runs["higgs"] = train_run("higgs", dense, x, y, dev, seed,
                                       profile)
    runs["higgs"]["input"] = "dense"
    del codes_d, codes_c
    sub = x[:200_000]
    models = {"higgs": runs["higgs"].pop("model_text")}
    again = lt.Booster(model_str=models["higgs"])
    rt_err = float(np.abs(again.predict(sub) - booster.predict(sub)).max())
    if rt_err > 1e-12:
        fail(f"model text round trip moved predictions by {rt_err:.3g}")
    runs["higgs"]["roundtrip_max_abs"] = rt_err
    del booster, again

    booster, runs["harness"] = train_run("harness", ds, x, y, dev, seed,
                                         profile)
    gb = booster._gbdt
    runs["harness"]["in_bag_rows"] = int(gb.row_mask.sum())
    runs["harness"]["features_per_tree"] = gb._grower._ff_k
    models["harness"] = runs["harness"].pop("model_text")
    del booster, gb

    texts = []
    for rep in range(2):
        booster, res = train_run("int8", ds, x, y, dev, seed,
                                 profile and rep == 0)
        texts.append(res.pop("model_text"))
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
    return result, models, x, y, dense._handle


#: the lambdarank configuration's held-out set (bench.py::run_mslr's), and
#: how many queries of each bucket size its gradient is checked on
MSLR_VALID_ROWS = 120_000
MSLR_VALID_QUERIES = 1000
GRAD_QUERIES_PER_BUCKET = 40
GRAD_QUERIES_MIN = 200


def regression_target(x, seed: int):
    """The regression configuration's continuous target: the fixed signal
    of higgs_shape's labels (before their logistic draw) plus N(0, 0.5^2)
    noise from ``seed + 2``, so var(y) = var(signal) + 0.25."""
    import numpy as np
    rng = np.random.default_rng(seed + 2)
    z = (1.2 * np.log(x[:, 0]) - 0.8 * np.abs(x[:, 1]) + 0.6 * x[:, 3]
         + 1.5 * np.log(x[:, 25]) - 1.0 * np.log(x[:, 27])
         + 0.4 * np.sin(x[:, 2]) * x[:, 4] + 0.5 * x[:, 7])
    return (z + 0.5 * rng.standard_normal(len(z))).astype(np.float32)


def objective_run(name, ds, x, dev, seed, valid=None, profile=False):
    """One new objective's 10 rounds, checked as train_run checks the
    binary ones: fused and per-iteration model texts equal, the fused
    chunk bit-equal to the plain loop of its pieces on the card, wave_hist
    launches == tree waves + warm-up (train_path), Booster.predict through
    forest_predict bit-equal to its plain version; then 5 more fused
    chunks timed.  ``valid`` is evaluated every round of the
    per-iteration run.  ``profile`` adds the device time by kernel of one
    more tree of the fused booster (its gradient outside the trace)."""
    import numpy as np
    booster, score, fused = train_path(name, ds, dev, "fused", seed)
    spare, _, per = train_path(name, ds, dev, "per_iteration", seed,
                               valid=valid)
    if per["model_text_sha256"] != fused["model_text_sha256"]:
        fail(f"{name}: the per-iteration model text "
             f"{per['model_text_sha256']} differs from the fused "
             f"{fused['model_text_sha256']}")
    loop_s = plain_chunk(name, ds, dev, booster)
    if booster.num_trees() != ROUNDS:
        fail(f"{name}: expected {ROUNDS} trees, got {booster.num_trees()}")
    pred = predict_checked(name, booster, x, score, dev)
    eval_ms = None
    if valid is not None:
        # the validation metric's host work alone: no tree to catch up
        t0 = time.perf_counter()
        spare._gbdt.eval_valid()
        eval_ms = (time.perf_counter() - t0) * 1e3
    pi = sorted(per["dispatch_s"][1:])
    # before the timed chunks: a trace taken right after graph replays
    # held a wave_hist launch more than the device counted
    prof = profile_tree(booster._gbdt, pi) if profile else None
    timing = time_fused_chunks(spare, dev)
    st = sorted(timing["s_per_tree"])
    cap = fused["capture"]
    res = dict(params={**TRAIN_BASE, **TRAIN_RUNS[name]}, trees=ROUNDS,
               model_text_sha256=fused["model_text_sha256"],
               leaves=[t.num_leaves for t in booster._gbdt.models],
               fused=fused, per_iteration=per, plain_loop_s_per_tree=loop_s,
               launches=fused["launches"] + per["launches"],
               fused_repeats=timing, eval_valid_host_ms=eval_ms,
               profile=prof, **pred)
    print(f"  {name}: {ROUNDS} trees, fused {fused['train_s']:.3f} s (one "
          f"chunk, {fused['host_syncs'][0]} host syncs, capture included: "
          f"warm-up {cap['warmup_s']:.3f} + capture {cap['capture_s']:.3f} "
          f"+ instantiate {cap['instantiate_s']:.3f} s), per-iteration "
          f"{per['train_s']:.3f} s; {fused['waves_per_tree']:.1f} "
          f"waves/tree, wave_hist launches {fused['launches']} + "
          f"{per['launches']} == tree waves + warm-up {cap['warmup_waves']} "
          f"each; peak memory {fused['peak_mem_gb']:.2f} GB after capture; "
          f"the chunk == the plain loop of its pieces on the card bit for "
          f"bit ({loop_s:.4f} s/tree); model text sha256 "
          f"{fused['model_text_sha256']} on both paths", flush=True)
    print(f"  {name}: s/tree fused median {st[len(st) // 2]:.5f} (min "
          f"{st[0]:.5f}, max {st[-1]:.5f}) over {FUSED_REPEATS} chunks, "
          f"per-iteration trees 2-{ROUNDS} median {pi[len(pi) // 2]:.5f} "
          f"(min {pi[0]:.5f}, max {pi[-1]:.5f}); waves a tree "
          f"{timing['waves_per_tree']}; predict {pred['predict_s']:.4f} s "
          f"({pred['predict_launches']} forest_predict launch, bit-equal to "
          f"the plain version, predict-vs-score "
          f"{pred['predict_vs_score_max_abs']:.2g})"
          + ("" if eval_ms is None else
             f"; eval_valid {eval_ms:.1f} ms of host a round"), flush=True)
    return booster, res


def rank_grad_check(booster, x, y, sizes, dev):
    """Lambdarank's gradient on the card at the first tree's scores (its
    Booster.predict with num_iteration=1, as float32), held against the
    float64 plain version (lambdarank_grad_f64) on GRAD_QUERIES_PER_BUCKET
    queries of every bucket size (at least GRAD_QUERIES_MIN) at rtol 1e-4
    / atol 1e-6: a gradient's rtol of the sum of its pair terms'
    magnitudes (its lambdas have both signs), a hessian's of itself.
    Times the gradient with CUDA events (outside any capture) and reads
    its peak memory."""
    import numpy as np
    import torch
    obj = booster._gbdt.objective
    raw1 = booster.predict(x, num_iteration=1, raw_score=True) \
        .astype(np.float32)
    score = torch.from_numpy(raw1).to(dev)
    fn, args = obj.device_grad()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    g, h = fn(score, args)
    torch.cuda.synchronize(dev)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    grad_ms = time_ms(lambda: fn(score, args), reps=5, warmup=1)
    g, h = g.cpu().numpy(), h.cpu().numpy()
    qb = np.concatenate([[0], np.cumsum(sizes)])
    lengths = np.diff(qb)
    pads = np.maximum(8, 1 << np.ceil(np.log2(np.maximum(lengths, 1)))
                      .astype(np.int64))
    picked = [np.flatnonzero(pads == p)[:GRAD_QUERIES_PER_BUCKET]
              for p in sorted(set(pads.tolist()))]
    queries = np.concatenate(picked)
    if len(queries) < GRAD_QUERIES_MIN:
        rest = np.setdiff1d(np.arange(len(lengths)), queries)
        queries = np.concatenate([queries,
                                  rest[:GRAD_QUERIES_MIN - len(queries)]])
    fg, fh, mag = lambdarank_grad_f64(raw1, y, qb, obj.label_gain,
                                      obj.sigmoid, obj.max_position,
                                      queries=queries)
    rows = np.concatenate([np.arange(qb[q], qb[q + 1]) for q in queries])
    g_err = np.abs(g[rows] - fg[rows])
    h_err = np.abs(h[rows] - fh[rows])
    ok = bool((g_err <= 1e-4 * mag[rows] + 1e-6).all()
              and (h_err <= 1e-4 * np.abs(fh[rows]) + 1e-6).all())
    res = dict(queries=int(len(queries)), rows=int(len(rows)),
               bucket_sizes={int(p): list(v) for p, v in
                             obj.bucket_sizes.items()},
               max_abs_err_grad=float(g_err.max()),
               max_abs_err_hess=float(h_err.max()),
               max_rel_err_hess=float((h_err / np.maximum(
                   np.abs(fh[rows]), 1e-30)).max()),
               grad_ms=grad_ms, peak_gb=peak_gb, ok=ok,
               tolerance="grad 1e-4 * sum|pair terms| + 1e-6, "
                         "hess 1e-4 * |hess| + 1e-6")
    print(f"  lambdarank gradient: {grad_ms:.2f} ms a tree (CUDA events, "
          f"{len(obj.bucket_sizes)} buckets {sorted(obj.bucket_sizes)}), "
          f"peak {peak_gb:.2f} GB above its inputs; against the float64 "
          f"plain version on {len(queries)} queries ({len(rows)} rows, "
          f"every bucket size): max abs err grad "
          f"{res['max_abs_err_grad']:.3g}, hess {res['max_abs_err_hess']:.3g}"
          f" (rel {res['max_rel_err_hess']:.3g}); ok={ok}", flush=True)
    if not ok:
        fail("lambdarank's card gradient disagrees with the float64 plain "
             "version")
    return res


def phase_objectives(dev, seed: int, x, dense, profile: bool):
    """The regression and lambdarank configurations at full width through
    engine.train (objective_run's checks), with their quality floors:
    regression's training l2 after 10 rounds below that after 1 round and
    below 0.6 var(y); lambdarank's held-out NDCG@10 after 10 rounds above
    that after 1 round and 0.05 above a seeded random score's."""
    import copy
    import numpy as np
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.data.dataset import Metadata
    from lightgbm_tpu_torch.metrics import NDCGMetric
    from lightgbm_tpu_torch.config import Config
    runs = {}

    # regression: the train phase's dense binning of the HIGGS matrix with
    # a continuous target
    y = regression_target(x, seed)
    handle = copy.copy(dense)
    handle.metadata = Metadata(handle.num_data)
    handle.metadata.set_label(y)
    ds = lt.Dataset(None, params=dict(TRAIN_BASE))
    ds._handle = handle
    booster, res = objective_run("regression", ds, x, dev, seed,
                                 profile=profile)
    raw1 = booster.predict(x, num_iteration=1, raw_score=True)
    l2_1 = float(np.mean((raw1 - y) ** 2))
    (_, metric, l2_10, _), = booster.eval_train()
    var = float(np.var(y.astype(np.float64)))
    res.update(l2_round1=l2_1, l2_round10=l2_10, var_y=var)
    print(f"  regression: training l2 after 1 round {l2_1:.4f}, after "
          f"{ROUNDS} {l2_10:.4f} ({metric}; var(y) {var:.4f}, floor "
          f"{0.6 * var:.4f})", flush=True)
    if metric != "l2" or not (l2_10 < l2_1 and l2_10 < 0.6 * var):
        fail(f"regression: training l2 {l2_10:.4f} after {ROUNDS} rounds "
             f"misses its floors (round 1 {l2_1:.4f}, 0.6 var(y) "
             f"{0.6 * var:.4f})")
    runs["regression"] = res
    del booster, ds, handle

    # lambdarank: MSLR-WEB10K's shape, a held-out set binned against the
    # training mappers
    t0 = time.perf_counter()
    xr, yr, sizes = synth_mslr(MSLR_ROWS, n_queries=MSLR_QUERIES,
                               seed=seed + 7)
    xv, yv, sv = synth_mslr(MSLR_VALID_ROWS, n_queries=MSLR_VALID_QUERIES,
                            seed=seed + 1234)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(xr, yr, group=sizes, params=dict(TRAIN_BASE)).construct()
    valid = ds.create_valid(xv, yv, group=sv).construct()
    bin_s = time.perf_counter() - t0
    groups = ds._handle.num_groups
    print(f"  lambdarank: {len(yr)} rows x {xr.shape[1]} features "
          f"({groups} groups), {len(sizes)} queries (sizes {sizes.min()}-"
          f"{sizes.max()}, mean {sizes.mean():.1f}); held-out {len(yv)} "
          f"rows, {len(sv)} queries; made in {gen_s:.1f} s, binned on the "
          f"host in {bin_s:.1f} s", flush=True)
    if groups != MSLR_FEATURES:
        fail(f"lambdarank: {groups} feature groups, expected "
             f"{MSLR_FEATURES}")
    booster, res = objective_run("lambdarank", ds, xr, dev, seed,
                                 valid=valid, profile=profile)
    ndcg = res["per_iteration"]["evals"]["valid_0"]["ndcg@10"]
    rng = np.random.default_rng(seed + 9)
    m = NDCGMetric(Config({"eval_at": [10]}))
    m.init(valid._handle.metadata, len(yv))
    (_, rand), = m.eval(rng.standard_normal((1, len(yv))), None)
    res.update(ndcg10_by_round=ndcg, ndcg10_random=rand,
               grad=rank_grad_check(booster, xr, yr, sizes, dev),
               gen_s=gen_s, binning_s=bin_s)
    print(f"  lambdarank: held-out NDCG@10 after 1 round {ndcg[0]:.4f}, "
          f"after {ROUNDS} {ndcg[-1]:.4f}; a random score's {rand:.4f}",
          flush=True)
    if not (ndcg[-1] > ndcg[0] and ndcg[-1] > rand + 0.05):
        fail(f"lambdarank: held-out NDCG@10 {ndcg[-1]:.4f} misses its "
             f"floors (round 1 {ndcg[0]:.4f}, random {rand:.4f} + 0.05)")
    runs["lambdarank"] = res
    print(f"phase objectives: ok regression (2M x 28) and lambdarank "
          f"({len(yr)} x {xr.shape[1]}, {len(sizes)} queries) at 255 "
          f"leaves, fused == per-iteration == the plain loop", flush=True)
    return dict(runs=runs)


#: the multiclass phase: an Expedia-shaped set (the Kaggle "Expedia Hotel
#: Recommendations" train.csv's columns; its tens of millions of rows cut
#: to 2M, past which the port refuses without striped stat columns), 100
#: hotel clusters, 5 rounds
EXPEDIA_ROWS = 2_000_000
EXPEDIA_VALID_ROWS = 200_000
EXPEDIA_CLASSES = 100
#: categorical id columns and the cardinality the generator gives each,
#: with Zipf-like frequencies.  The mapper keeps categories until 99% of
#: the sampled rows are covered (and at least max_bin of them), and a
#: feature group holds at most 256 bins, so the columns past 255 ids draw
#: from a steeper Zipf-Mandelbrot law whose 255 most frequent ids hold
#: over 99% of the rows (EXPEDIA_STEEP)
EXPEDIA_CATEGORICAL = {
    "site_name": 53, "posa_continent": 4, "user_location_country": 239,
    "user_location_region": 1_000, "user_location_city": 50_000,
    "channel": 11, "srch_destination_id": 60_000,
    "srch_destination_type_id": 8, "hotel_continent": 7,
    "hotel_country": 210, "hotel_market": 2_100}
EXPEDIA_STEEP = (2.6, 10.0)   # p(rank k) ~ (k + 10)^-2.6 past 255 ids
EXPEDIA_NUMERICAL = ("orig_destination_distance", "is_mobile", "is_package",
                     "srch_adults_cnt", "srch_children_cnt", "srch_rm_cnt",
                     "cnt", "nights", "days_ahead")
EXPEDIA_FEATURES = len(EXPEDIA_CATEGORICAL) + len(EXPEDIA_NUMERICAL)
MC_ROUNDS = 5
#: held-out rows also walked on the host (float64) for the softmax check
MC_HOST_ROWS = 20_000
MC_BASE = {"objective": "multiclass", "num_class": EXPEDIA_CLASSES,
           "metric": "multi_logloss,multi_error", "num_leaves": 255,
           "max_bin": 255, "learning_rate": 0.1, "wave_plan": "fixed",
           "verbose": -1}
#: run (b): binary is_booking on the same columns, fused and per-iteration
TRAIN_RUNS["expedia_binary"] = {"num_leaves": 255}
TRAIN_RUNS["expedia_int8"] = {"num_leaves": 255, "grad_quant_bits": 8}


def _zipf_ids(rng, n: int, card: int):
    """``n`` ids in [0, card) over a random order of the ids, with
    Zipf(1.1) frequencies up to 255 ids, else EXPEDIA_STEEP's."""
    import numpy as np
    s, q = (1.1, 0.0) if card <= 255 else EXPEDIA_STEEP
    p = 1.0 / (np.arange(1, card + 1) + q) ** s
    cdf = np.cumsum(p / p.sum())
    rank = np.minimum(np.searchsorted(cdf, rng.random(n)), card - 1)
    return rng.permutation(card)[rank]


def expedia_shape(n: int, seed: int):
    """(x (n, 20) float64, hotel_cluster (n,), is_booking (n,)): the
    Expedia Hotel Recommendations train.csv's columns (11 categorical ids
    first, in EXPEDIA_CATEGORICAL's order, then EXPEDIA_NUMERICAL; a third
    of the distances NaN).  The cluster is drawn from a softmax of fixed
    per-(hotel_market, srch_destination_type_id) preferences (each market
    favours a few clusters), hotel_continent's, and distance and package
    effects, with Gumbel noise; is_booking from a fixed logistic function.
    The tables are fixed (seed 1234), the rows come from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cols = {name: _zipf_ids(rng, n, card)
            for name, card in EXPEDIA_CATEGORICAL.items()}
    dist = rng.lognormal(6.0, 1.5, n)
    dist[rng.random(n) < 1 / 3] = np.nan
    num = {"orig_destination_distance": dist,
           "is_mobile": (rng.random(n) < 0.13).astype(float),
           "is_package": (rng.random(n) < 0.25).astype(float),
           "srch_adults_cnt": np.minimum(1 + rng.poisson(0.9, n), 9),
           "srch_children_cnt": np.minimum(rng.poisson(0.35, n), 9),
           "srch_rm_cnt": np.minimum(1 + rng.poisson(0.1, n), 8),
           "cnt": rng.geometric(0.6, n),
           "nights": 1 + rng.poisson(2.5, n),
           "days_ahead": np.round(rng.exponential(40.0, n))}
    x = np.stack([cols[k] for k in EXPEDIA_CATEGORICAL]
                 + [num[k] for k in EXPEDIA_NUMERICAL], axis=1) \
        .astype(np.float64)
    fixed = np.random.default_rng(1234)
    k = EXPEDIA_CLASSES
    market = fixed.normal(0.0, 0.5, (EXPEDIA_CATEGORICAL["hotel_market"], k))
    fav = fixed.integers(0, k, (len(market), 4))
    np.put_along_axis(market, fav, fixed.uniform(2.5, 4.0, fav.shape), 1)
    dtype_pref = fixed.normal(0.0, 1.0, (8, k))
    cont_pref = fixed.normal(0.0, 0.7, (7, k))
    w_dist, w_pkg = fixed.normal(0.0, 0.6, k), fixed.normal(0.0, 0.8, k)
    site_b = fixed.normal(0.0, 0.4, EXPEDIA_CATEGORICAL["site_name"])
    chan_b = fixed.normal(0.0, 0.3, EXPEDIA_CATEGORICAL["channel"])
    ld = np.log1p(np.nan_to_num(dist, nan=np.exp(6.0)))
    zd = (ld - 6.0) / 1.5
    y = np.empty(n, np.int64)
    for lo in range(0, n, 200_000):
        hi = min(n, lo + 200_000)
        logit = (market[cols["hotel_market"][lo:hi]]
                 + dtype_pref[cols["srch_destination_type_id"][lo:hi]]
                 + cont_pref[cols["hotel_continent"][lo:hi]]
                 + np.outer(zd[lo:hi], w_dist)
                 + np.outer(num["is_package"][lo:hi], w_pkg))
        y[lo:hi] = np.argmax(logit + rng.gumbel(size=logit.shape), axis=1)
    zb = (-2.4 + 0.9 * num["is_package"] - 0.4 * num["is_mobile"]
          + site_b[cols["site_name"]] + chan_b[cols["channel"]]
          - 0.25 * np.log1p(num["days_ahead"])
          + 0.3 * (num["srch_rm_cnt"] > 1) + 0.2 * zd)
    booking = (rng.random(n) < 1.0 / (1.0 + np.exp(-zb))).astype(np.float64)
    return x, y.astype(np.float64), booking


def multiclass_round1_plain(ds, dev, booster):
    """Round 1 of run (a) grown again by a new booster whose trees run
    their pieces in the plain Python loop on the card (a host read a
    wave, nothing captured): its K trees' model text must equal the first
    K trees of the captured run's.  Returns the loop's seconds a tree."""
    import torch
    import lightgbm_tpu_torch as lt
    plain = lt.Booster({**MC_BASE, "device": dev.type}, ds)
    grower = plain._gbdt._grower
    grower._graph = lambda sample: None       # capture nothing
    grower._run_tree = grower._run_pieces     # the loop, not the graph
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    plain.update()
    torch.cuda.synchronize(dev)
    loop_s = (time.perf_counter() - t0) / EXPEDIA_CLASSES
    if grower._composed or grower._graphs is not None:
        fail("multiclass: the plain loop captured a graph")
    plain._gbdt._flush_pending()
    k = EXPEDIA_CLASSES
    got = [t.to_string() for t in booster._gbdt.models[:k]]
    want = [t.to_string() for t in plain._gbdt.models[:k]]
    bad = [i for i in range(k) if got[i] != want[i]]
    if bad:
        fail(f"multiclass: round 1's captured trees {bad[:10]} differ from "
             f"the plain loop's on the card")
    return loop_s


def multiclass_predict_checked(booster, xv, dev):
    """Booster.predict of the held-out rows (raw (N, K)) through
    forest_predict (counted), bit-equal to the kernel's plain version on
    the card, and its softmax within 1e-5 of the host walk's float64 one
    on MC_HOST_ROWS rows; forest_case times the kernel at this pack and
    row count (long raw-category bitsets)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.serve import packed
    packed.forest_predict.launches = 0        # this predict only
    packed.forest_predict.routes = {k: 0 for k in packed.forest_predict.routes}
    t0 = time.perf_counter()
    raw = booster.predict(xv, raw_score=True)
    predict_s = time.perf_counter() - t0
    launches = packed.forest_predict.launches
    routes = dict(packed.forest_predict.routes)
    if launches <= 0:
        fail("multiclass: Booster.predict of the held-out rows launched no "
             "forest_predict kernel")
    pe = packed.pack_gbdt(booster._gbdt, device=dev)
    xd = torch.from_numpy(xv).to(dev)
    plain = packed.forest_predict_reference(
        pe.tables(), xd, num_model=pe.num_model,
        max_depth=pe.max_depth).double().cpu().numpy().T
    if not np.array_equal(raw, plain):
        fail(f"multiclass: Booster.predict through forest_predict differs "
             f"from the plain version on {int((raw != plain).sum())} "
             f"values")
    gb = booster._gbdt
    gb.config.device_predict = "off"
    t0 = time.perf_counter()
    host = booster.predict(xv[:MC_HOST_ROWS])
    host_s = time.perf_counter() - t0
    gb.config.device_predict = "auto"
    prob = gb.objective.convert_output(raw[:MC_HOST_ROWS].T).T
    host_err = float(np.abs(prob - host).max())
    if host_err > 1e-5:
        fail(f"multiclass: predict's softmax vs the host walk's float64 "
             f"one: {host_err:.3g}")
    case, _, _ = forest_case("expedia_multiclass", pe, xd, None, reps=5)
    words = [int(np.diff(t.cat_boundaries).max()) for t in gb.models
             if t.num_cat > 0]
    del pe, xd, plain
    torch.cuda.empty_cache()
    return dict(predict_s=predict_s, predict_launches=launches,
                predict_routes=routes, host_walk_rows=MC_HOST_ROWS,
                host_walk_s=host_s, softmax_vs_host_max_abs=host_err,
                forest_case=case,
                categorical_nodes=sum(t.num_cat for t in gb.models),
                longest_bitset_words=max(words) if words else 0)


def multiclass_run(ds, valid, xv, yv, dev, seed, profile):
    """Run (a): objective=multiclass, 100 classes, 255 leaves, MC_ROUNDS
    rounds per-iteration through engine.train with the held-out set
    scored by multi_logloss and multi_error every round."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metrics import create_metrics
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import hist_cuda
    k = EXPEDIA_CLASSES
    torch.cuda.reset_peak_memory_stats(dev)
    hist_cuda.wave_hist.launches.reset()          # this run only
    torch.cuda.synchronize(dev)
    evals = {}
    t0 = time.perf_counter()
    booster = lt.train({**MC_BASE, "device": dev.type}, ds, MC_ROUNDS,
                       valid_sets=[valid], evals_result=evals)
    torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    gb = booster._gbdt
    grower = gb._grower
    launches = hist_cuda.wave_hist.launches.read()
    stats = gb.tree_stats
    waves = sum(s[2] for s in stats)
    cap = dict(grower.capture_stats)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if launches <= 0 or launches != waves + cap["warmup_waves"]:
        fail(f"multiclass: wave_hist launches {launches} (device counter) "
             f"!= tree waves {waves} + warm-up {cap['warmup_waves']}")
    if [s[1] for s in stats] != [k] * MC_ROUNDS:
        fail(f"multiclass: trees an iteration {[s[1] for s in stats]}, "
             f"expected {k} each")
    if [s[3] for s in stats] != [1] * MC_ROUNDS:
        fail(f"multiclass: host syncs an iteration {[s[3] for s in stats]},"
             f" expected 1 each")
    if booster.num_trees() != k * MC_ROUNDS:
        fail(f"multiclass: {booster.num_trees()} trees, expected "
             f"{k * MC_ROUNDS}")
    # one more tree of class 0 under sync debug mode "error": the
    # membership state and the bitset routing capture with no host sync
    grad, hess = gb.objective.get_gradients(gb.train_score)
    score0 = gb.train_score[0].clone()
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        grower.grow_one_iter(score0, grad[0], hess[0],
                             feature_mask=grower.feature_mask_for(0),
                             tree_idx=0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    del grad, hess, score0
    loop_s = multiclass_round1_plain(ds, dev, booster)
    # eval_valid's host work alone (no tree to catch up): the (K, N)
    # scores' copy and both metrics
    t0 = time.perf_counter()
    gb.eval_valid()
    eval_ms = (time.perf_counter() - t0) * 1e3
    loss = evals["valid_0"]["multi_logloss"]
    err = evals["valid_0"]["multi_error"]
    rng = np.random.default_rng(seed + 9)
    m = create_metrics(Config({"metric": "multi_error"}))[0]
    m.init(valid._handle.metadata, len(yv))
    (_, rand_err), = m.eval(rng.standard_normal((k, len(yv))), None)
    pred = multiclass_predict_checked(booster, xv, dev)
    it_s = sorted(s[0] for s in stats[1:])
    res = dict(params=dict(MC_BASE), rounds=MC_ROUNDS, classes=k,
               train_s=train_s, s_per_iteration=[s[0] for s in stats],
               s_per_tree_median=it_s[len(it_s) // 2] / k,
               waves=waves, waves_per_tree=waves / (k * MC_ROUNDS),
               launches=launches, capture=cap, peak_mem_gb=peak_gb,
               host_syncs=[s[3] for s in stats],
               plain_loop_s_per_tree=loop_s, eval_valid_host_ms=eval_ms,
               multi_logloss=loss, multi_error=err,
               multi_error_random=rand_err, **pred)
    print(f"  multiclass: {k} classes x {MC_ROUNDS} rounds = "
          f"{booster.num_trees()} trees in {train_s:.2f} s (capture "
          f"included: warm-up {cap['warmup_s']:.3f} + capture "
          f"{cap['capture_s']:.3f} + instantiate {cap['instantiate_s']:.3f}"
          f" s); s/iteration {[round(s[0], 3) for s in stats]}, s/tree "
          f"{res['s_per_tree_median']:.5f} (iterations 2-{MC_ROUNDS}, "
          f"median); {res['waves_per_tree']:.2f} waves a tree; wave_hist "
          f"launches {launches} == tree waves + warm-up "
          f"{cap['warmup_waves']}; 1 host sync an iteration; a tree "
          f"grown under sync debug mode \"error\"; peak memory "
          f"{peak_gb:.2f} GB; round 1's {k} trees == the plain loop's on "
          f"the card ({loop_s:.4f} s/tree)", flush=True)
    print(f"  multiclass: held-out multi_logloss by round "
          f"{[round(v, 4) for v in loss]} (ln {k} = {np.log(k):.4f}), "
          f"multi_error {[round(v, 4) for v in err]} (a random score's "
          f"{rand_err:.4f}); eval_valid {eval_ms:.1f} ms of host; predict "
          f"of {len(xv)} rows {pred['predict_s']:.3f} s "
          f"({pred['predict_launches']} forest_predict launch, bit-equal to "
          f"the plain version; softmax within {pred['softmax_vs_host_max_abs']:.2g}"
          f" of the host walk's on {MC_HOST_ROWS} rows, "
          f"{pred['host_walk_s']:.2f} s); {pred['categorical_nodes']} "
          f"categorical nodes, the longest raw-category bitset "
          f"{pred['longest_bitset_words']} words", flush=True)
    if not (loss[-1] < loss[0] and loss[-1] < np.log(k)):
        fail(f"multiclass: held-out multi_logloss {loss[-1]:.4f} after "
             f"{MC_ROUNDS} rounds misses its floors (round 1 {loss[0]:.4f},"
             f" ln {k} {np.log(k):.4f})")
    if not err[-1] <= rand_err - 0.05:
        fail(f"multiclass: held-out multi_error {err[-1]:.4f} misses its "
             f"floor (a random score's {rand_err:.4f} - 0.05)")
    if pred["longest_bitset_words"] <= 4:
        fail(f"multiclass: the longest raw-category bitset has "
             f"{pred['longest_bitset_words']} words, not past the serve "
             f"phase's 4")
    if profile:
        res["profile"] = profile_tree(gb, [s / k for s in it_s])
    return res


def phase_multiclass(dev, seed: int, profile: bool):
    """BASELINE.json's config 4 on the Expedia-shaped set: run (a)
    multiclass (multiclass_run) and run (b) binary is_booking on the same
    binned columns, 10 rounds fused and per-iteration (objective_run's
    checks: the texts equal, the chunk bit-equal to the plain loop,
    categorical splits in the model) and under grad_quant_bits=8 twice
    (byte-identical text, the chunk bit-equal to the plain loop)."""
    import copy
    import numpy as np
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.data.dataset import Metadata
    t0 = time.perf_counter()
    x, y, booking = expedia_shape(EXPEDIA_ROWS, seed + 11)
    xv, yv, _ = expedia_shape(EXPEDIA_VALID_ROWS, seed + 12)
    gen_s = time.perf_counter() - t0
    cats = list(range(len(EXPEDIA_CATEGORICAL)))
    t0 = time.perf_counter()
    ds = lt.Dataset(x, y, categorical_feature=cats,
                    params=dict(MC_BASE)).construct()
    valid = ds.create_valid(xv, yv).construct()
    bin_s = time.perf_counter() - t0
    h = ds._handle
    nbin = [int(h.bin_mappers[f].num_bin) for f in cats]
    if h.num_groups != EXPEDIA_FEATURES:
        fail(f"multiclass: {h.num_groups} feature groups, expected "
             f"{EXPEDIA_FEATURES} (the kernel phase's case)")
    onehot = [f for f, b in zip(cats, nbin)
              if b <= int(MC_BASE.get("max_cat_to_onehot", 4))]
    if not onehot or len(onehot) == len(cats):
        fail(f"multiclass: categorical bins {nbin}: both scan modes must "
             f"run")
    print(f"  multiclass: Expedia-shaped {len(y)} rows x {x.shape[1]} "
          f"columns ({len(cats)} categorical, bins {nbin}), "
          f"{EXPEDIA_CLASSES} classes; held-out {len(yv)} rows; made in "
          f"{gen_s:.1f} s, binned on the host in {bin_s:.1f} s", flush=True)
    runs = {"multiclass": multiclass_run(ds, valid, xv, yv, dev, seed,
                                         profile)}
    runs["multiclass"].update(gen_s=gen_s, binning_s=bin_s,
                              categorical_bins=nbin)
    del valid, xv, yv

    # run (b): is_booking on the same binned columns
    handle = copy.copy(h)
    handle.metadata = Metadata(handle.num_data)
    handle.metadata.set_label(booking)
    bds = lt.Dataset(None, params=dict(TRAIN_BASE))
    bds._handle = handle
    booster, res = objective_run("expedia_binary", bds, x, dev, seed)
    text = booster.model_to_string()
    if "cat_threshold=" not in text:
        fail("expedia_binary: the model has no categorical split")
    res["categorical_nodes"] = sum(t.num_cat for t in booster._gbdt.models)
    runs["expedia_binary"] = res
    del booster
    shas = []
    for rep in range(2):
        booster, _, r = train_path("expedia_int8", bds, dev, "fused", seed)
        r["plain_loop_s_per_tree"] = plain_chunk("expedia_int8", bds, dev,
                                                 booster)
        shas.append(r["model_text_sha256"])
        runs[f"expedia_int8_run{rep + 1}"] = r
        del booster
    if shas[0] != shas[1]:
        fail("expedia_int8: two runs gave different model text")
    print(f"  expedia_int8: two fused runs, model text sha256 {shas[0]} "
          f"both; each chunk == the plain loop's on the card", flush=True)
    print(f"phase multiclass: ok (a) {EXPEDIA_CLASSES} classes x "
          f"{MC_ROUNDS} rounds at 255 leaves on {len(y)} rows, (b) "
          f"categorical binary fused == per-iteration == the plain loop, "
          f"int8 byte-identical", flush=True)
    launches = (runs["multiclass"]["launches"]
                + runs["expedia_binary"]["launches"]
                + sum(runs[f"expedia_int8_run{i}"]["launches"]
                      for i in (1, 2)))
    fp_launches = (runs["multiclass"]["predict_launches"]
                   + runs["expedia_binary"]["predict_launches"])
    fp_routes = {r: (runs["multiclass"]["predict_routes"][r]
                     + runs["expedia_binary"]["predict_routes"][r])
                 for r in runs["multiclass"]["predict_routes"]}
    return dict(rows=EXPEDIA_ROWS, valid_rows=EXPEDIA_VALID_ROWS,
                runs=runs, launches=launches, predict_launches=fp_launches,
                predict_routes=fp_routes)


#: the data phase's held-out rows (binned on the card against the training
#: set's mappers), and how many of them the traversal is also walked for on
#: the host
VALID_ROWS = 500_000
VALID_HOST_ROWS = 200_000


class BinSplit:
    """Splits one construct_from_device_matrix into bin finding, bundling
    and codes, measurement only: host clocks (ending in a synchronize)
    around the dataset's own methods, wrapped for the time of the block;
    the rest is drawing and gathering the sample (and the lookups)."""

    NAMES = ("_find_bins", "_bundle_features", "_bin_on_device")

    def __enter__(self):
        import torch
        from lightgbm_tpu_torch.data.dataset import BinnedDataset
        self.real = {f: getattr(BinnedDataset, f) for f in self.NAMES}
        self.s = dict.fromkeys(self.NAMES, 0.0)

        def clocked(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                self.s[name] += time.perf_counter() - t0
                return out
            return run
        for name, fn in self.real.items():
            setattr(BinnedDataset, name, clocked(name, fn))
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.data.dataset import BinnedDataset
        for name, fn in self.real.items():
            setattr(BinnedDataset, name, fn)
        return False

    def split(self, total_s: float) -> dict:
        s = self.s
        return dict(sample_s=total_s - sum(s.values()),
                    find_bins_s=s["_find_bins"],
                    bundle_s=s["_bundle_features"],
                    codes_s=s["_bin_on_device"])


def phase_data(dev, seed: int, dense, x, y, train, profile: bool):
    """The JAX package's data-on-the-device path (bench.py's main path):
    the training rows uploaded and binned on the card, codes byte-equal to
    the host build ``dense``; the higgs configuration trained from them
    through GBDT (the same model text as the host-binned run) with a
    held-out set binned on the card against the training set's mappers
    (codes byte-equal to the host's), scored tree by tree by the binned
    traversal and evaluated every iteration; its AUC against
    Booster.predict's; then engine.train with the pair as its valid set
    and early stopping.  ``profile`` adds the device time by kernel of the
    codes and of the validation scoring."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.ops import hist_cuda, traverse
    from lightgbm_tpu_torch.serve import packed

    cfg = Config(dict(TRAIN_BASE))
    t0 = time.perf_counter()
    x_dev = torch.from_numpy(x).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    with BinSplit() as clocks:
        t0 = time.perf_counter()
        ds = BinnedDataset.construct_from_device_matrix(x_dev, cfg)
        torch.cuda.synchronize()
        bin_s = time.perf_counter() - t0
    split = clocks.split(bin_s)
    if not ds.device_binned or ds.binned.device != x_dev.device:
        fail("construct_from_device_matrix left its codes off the card")
    codes = ds.binned.cpu().numpy()
    if codes.shape != dense.binned.shape \
            or not np.array_equal(codes, dense.binned):
        fail(f"codes binned on the card differ from the host build's on "
             f"{int((codes != dense.binned).sum())} cells")
    del codes
    codes_ms = time_ms(lambda: ds._bin_on_device(x_dev), reps=5)
    codes_bytes = x.size * 4 + x.shape[0] * ds.num_groups
    codes_bound_ms = codes_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  data codes: {x.shape[0]} x {x.shape[1]} f32 -> "
          f"{ds.num_groups} groups on the card, byte-equal to the host "
          f"build; upload {upload_s:.3f} s; construct_from_device_matrix "
          f"{bin_s:.3f} s = sample {split['sample_s']:.3f} + find-bins "
          f"{split['find_bins_s']:.3f} + bundling {split['bundle_s']:.3f} "
          f"+ codes {split['codes_s']:.4f} s; codes {codes_ms:.3f} ms "
          f"(CUDA events) against a {codes_bound_ms * 1e3:.1f} us bound "
          f"({codes_bytes / 1e6:.0f} MB at 3.35 TB/s); host "
          f"construct_from_matrix {train['binning_dense_s']:.2f} s",
          flush=True)

    # held-out rows, binned on the card with the training set's mappers
    xv, yv = higgs_shape(VALID_ROWS, seed + 1)
    xv_dev = torch.from_numpy(xv).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vds = BinnedDataset.construct_from_device_matrix(xv_dev, cfg,
                                                     reference=ds)
    torch.cuda.synchronize()
    ref_bin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_v = BinnedDataset.construct_from_matrix(xv, cfg, reference=dense)
    host_ref_s = time.perf_counter() - t0
    if not np.array_equal(vds.binned.cpu().numpy(), host_v.binned):
        fail("validation codes binned on the card with reference= differ "
             "from the host construct_from_matrix(reference=)")
    del host_v
    ds.metadata.set_label(y)
    vds.metadata.set_label(yv)

    # the higgs configuration from the card's codes, validated each round
    params = {**TRAIN_BASE, **TRAIN_RUNS["higgs"], "device": dev.type}
    hist_cuda.wave_hist.launches.reset()      # this run only
    gb = GBDT(Config(params))
    gb.init_train(ds)
    gb.add_valid(vds, "valid")
    eval_s = []
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        if gb.train_one_iter():
            fail("training from the card's codes stopped early")
        t1 = time.perf_counter()
        records = gb.eval_valid()
        eval_s.append(time.perf_counter() - t1)
    train_s = time.perf_counter() - t0
    launches = hist_cuda.wave_hist.launches.read()
    waves = sum(s[2] for s in gb.tree_stats) \
        + gb._grower.capture_stats["warmup_waves"]
    if launches <= 0 or launches != waves:
        fail(f"data: kernel launches {launches} != tree waves + warm-up "
             f"{waves}")
    booster = lt.Booster.from_gbdt(gb, params)
    text_sha = hashlib.sha256(booster.model_to_string().encode()).hexdigest()
    want_sha = train["runs"]["higgs"]["model_text_sha256"]
    if text_sha != want_sha:
        fail(f"the model trained from the card's codes has text sha256 "
             f"{text_sha}, the host-binned higgs run {want_sha}")
    vs = gb.valid_sets[0]
    vscore = vs.score[0].double().cpu().numpy()
    if vscore.shape != (VALID_ROWS,) or not np.isfinite(vscore).all():
        fail("validation scores are not finite")
    auc_valid = auc_of(yv, vscore)
    packed.forest_predict.launches = 0        # this predict only
    packed.forest_predict.routes = {k: 0 for k in packed.forest_predict.routes}
    raw = booster.predict(xv, raw_score=True)
    predict_launches = packed.forest_predict.launches
    predict_routes = dict(packed.forest_predict.routes)
    if predict_launches <= 0:
        fail("Booster.predict of the validation rows launched no "
             "forest_predict kernel")
    auc_pred = auc_of(yv, raw)
    score_err = float(np.abs(vscore - raw).max())
    if abs(auc_valid - auc_pred) > 1e-6:
        fail(f"validation AUC {auc_valid:.8f} from the binned traversal, "
             f"{auc_pred:.8f} from Booster.predict")
    if score_err > 1e-5:
        fail(f"validation scores vs Booster.predict: {score_err:.3g}")
    dts = [traverse.device_tree(t, ds, gb.config.num_leaves, dev)
           for t in gb.models]
    sub = vds.binned[:VALID_HOST_ROWS]
    for i, (tree, dt) in enumerate(zip(gb.models, dts)):
        leaves = traverse.traverse(sub, dt).cpu().numpy()
        if not np.array_equal(leaves,
                              tree.predict_leaf(xv[:VALID_HOST_ROWS])):
            fail(f"tree {i}: the binned traversal's leaves differ from the "
                 f"host walk's")
    score0 = torch.zeros(VALID_ROWS, device=dev)

    def score_all():
        s = score0
        for dt in dts:
            s = traverse.add_tree_score(s, vs.binned, dt, 1.0)
        return s
    tree_ms = time_queued_ms(score_all, reps=1) / len(dts)
    depths = [dt.depth for dt in dts]
    profiles = None
    if profile:
        profiles = dict(
            codes=profile_ops("codes", lambda: ds._bin_on_device(x_dev)),
            valid_scoring=profile_ops(
                f"validation scoring, {len(dts)} trees", score_all))
    print(f"  data train: higgs from the card's codes, {ROUNDS} trees in "
          f"{train_s:.2f} s, kernel launches {launches} == tree waves + "
          f"warm-up, model "
          f"text sha256 {text_sha} (== the host-binned run); valid "
          f"{VALID_ROWS} rows binned on the card with reference= in "
          f"{ref_bin_s:.3f} s (host {host_ref_s:.2f} s, same codes); "
          f"scoring {tree_ms:.3f} ms a tree on the card (queued, depths "
          f"{min(depths)}-{max(depths)}), eval_valid {np.mean(eval_s) * 1e3:.1f} "
          f"ms host; AUC {auc_valid:.6f} == Booster.predict's "
          f"{auc_pred:.6f} ({predict_launches} forest_predict launch), "
          f"scores within {score_err:.2g}; leaves == host walk on "
          f"{VALID_HOST_ROWS} rows; {records[0][1]} {records[0][2]:.6f}",
          flush=True)
    del booster, gb, vs, dts, sub, score0

    # engine.train with the pair as its valid set and early stopping
    hist_cuda.wave_hist.launches.reset()
    tr = lt.Dataset(x_dev, y, params=dict(TRAIN_BASE))
    va = tr.create_valid(xv_dev, yv)
    evals = {}
    t0 = time.perf_counter()
    eng = lt.train({**params, "metric": ["binary_logloss", "auc"]}, tr,
                   ROUNDS, valid_sets=[va], early_stopping_rounds=3,
                   evals_result=evals, verbose_eval=False)
    engine_s = time.perf_counter() - t0
    eng_launches = hist_cuda.wave_hist.launches.read()
    eng_waves = sum(s[2] for s in eng._gbdt.tree_stats) \
        + eng._gbdt._grower.capture_stats["warmup_waves"]
    if eng_launches <= 0 or eng_launches != eng_waves:
        fail(f"engine.train: kernel launches {eng_launches} != tree waves "
             f"+ warm-up {eng_waves}")
    aucs = evals.get("valid_0", {}).get("auc", [])
    if not aucs or not 1 <= eng.best_iteration <= len(aucs):
        fail(f"engine.train filled evals_result {list(evals)} and "
             f"best_iteration {eng.best_iteration}")
    if len(aucs) == ROUNDS and abs(aucs[-1] - auc_valid) > 1e-9:
        fail(f"engine.train's last validation AUC {aucs[-1]:.8f} differs "
             f"from GBDT's {auc_valid:.8f}")
    print(f"  data engine.train: {len(aucs)} rounds in {engine_s:.2f} s "
          f"(binning included), best_iteration {eng.best_iteration}, valid "
          f"AUC {aucs[eng.best_iteration - 1]:.6f}, kernel launches "
          f"{eng_launches} == tree waves + warm-up", flush=True)
    best = eng.best_iteration
    del eng, tr, va, x_dev, xv_dev
    print(f"phase data: ok (codes and validation codes byte-equal to the "
          f"host's, model text sha256 unchanged, validation AUC equal to "
          f"Booster.predict's)", flush=True)
    return dict(rows=x.shape[0], upload_s=upload_s, bin_s=bin_s,
                bin_split=split, codes_ms=codes_ms,
                codes_bound_ms=codes_bound_ms, codes_bytes=codes_bytes,
                host_bin_s=train["binning_dense_s"], valid_rows=VALID_ROWS,
                valid_ref_bin_s=ref_bin_s, valid_host_ref_bin_s=host_ref_s,
                train_s=train_s, launches=launches, waves=waves,
                model_text_sha256=text_sha, valid_auc=auc_valid,
                predict_auc=auc_pred, valid_vs_predict_max_abs=score_err,
                predict_launches=predict_launches,
                predict_routes=predict_routes, eval_valid_s=eval_s,
                score_ms_per_tree=tree_ms, tree_depths=depths,
                engine_s=engine_s, engine_launches=eng_launches,
                engine_rounds=len(aucs), engine_best_iteration=best,
                engine_evals=evals, profile=profiles)


#: phase boosting: GOSS, DART and RF on the train phase's dense HIGGS
#: binning (2M x 28, max_bin 255, binary, 255 leaves), with VALID_ROWS
#: held-out rows binned on the card against the training mappers
BOOST_BASE = {**TRAIN_BASE, "num_leaves": 255}
BOOST_RUNS = {
    "goss": {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1},
    "goss_int8": {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1,
                  "grad_quant_bits": 8},
    "dart": {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.5,
             "max_drop": 50, "drop_seed": 4},
    "rf": {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.8,
           "feature_fraction": 0.8, "metric": ["binary_logloss", "auc"]},
}
BOOST_ROUNDS = {"goss": 30, "goss_int8": 20, "dart": 30, "rf": 20}
#: the GOSS iteration whose selection is recomputed on the CPU (the
#: warm-up at learning rate 0.1 covers iterations 0-9)
GOSS_CHECK_ITER = 15
#: the RF's held-out AUC floor, fixed before its first card run (PERF.md)
RF_AUC_FLOOR = 0.78
#: training rows DART's training score is held against predict on
DART_TRAIN_ROWS = 200_000


def dataset_of(handle, reference=None):
    """A user's ``lt.Dataset`` over an already binned BinnedDataset (its
    labels set), so that engine.train and Booster take it as they take
    any Dataset, without binning it again."""
    import lightgbm_tpu_torch as lt
    d = lt.Dataset(None, reference=reference)
    d._handle = handle
    return d


def boost_launches_ok(name, gb, launches, rounds):
    """wave_hist launches == the trees' waves + the warm-up's; one tree
    and one host sync an iteration."""
    stats = gb.tree_stats
    waves = sum(s[2] for s in stats)
    warm = gb._grower.capture_stats["warmup_waves"]
    if launches <= 0 or launches != waves + warm:
        fail(f"boosting {name}: wave_hist launches {launches} != tree "
             f"waves {waves} + warm-up {warm}")
    if [s[1] for s in stats] != [1] * rounds \
            or [s[3] for s in stats] != [1] * rounds:
        fail(f"boosting {name}: dispatches {[s[1] for s in stats]} and "
             f"host syncs {[s[3] for s in stats]}, one each an iteration "
             f"expected")
    return waves


def boost_run(name, train, dev, valid=None):
    """engine.train of one boosting configuration: the booster and what
    the run counted (every tree per-iteration: GOSS, DART and RF never
    fuse)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda
    params = {**BOOST_BASE, **BOOST_RUNS[name], "device": dev.type}
    rounds = BOOST_ROUNDS[name]
    evals = {}
    hist_cuda.wave_hist.launches.reset()      # this run only
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    booster = lt.train(params, train, num_boost_round=rounds,
                       valid_sets=None if valid is None else [valid],
                       evals_result=evals, verbose_eval=False)
    text = booster.model_to_string()
    train_s = time.perf_counter() - t0
    gb = booster._gbdt
    if gb.fused_eligible() or booster.num_trees() != rounds:
        fail(f"boosting {name}: {booster.num_trees()} trees, fused "
             f"eligible {gb.fused_eligible()}")
    launches = hist_cuda.wave_hist.launches.read()
    waves = boost_launches_ok(name, gb, launches, rounds)
    return booster, text, dict(
        params={**BOOST_BASE, **BOOST_RUNS[name]}, rounds=rounds,
        train_s=train_s, launches=launches, waves=waves,
        waves_per_tree=waves / rounds,
        s_per_iteration=[s[0] for s in gb.tree_stats],
        capture=dict(gb._grower.capture_stats), evals=evals,
        model_text_sha256=hashlib.sha256(text.encode()).hexdigest())


def _median(v):
    v = sorted(v)
    return v[len(v) // 2] if v else None


def boost_goss(train, x, y, dev):
    """GOSS twice (the same sha256), its iteration-15 selection recomputed
    by the plain goss_partition on the CPU, training AUC and predict; the
    int8 GOSS twice, byte-identical."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.boosting import goss as goss_mod
    from lightgbm_tpu_torch.ops.bagging import goss_counts, goss_partition
    warm = int(1.0 / BOOST_BASE["learning_rate"])
    real, calls, seen = goss_mod.goss_row_mask, [], {}

    def spy(key, score, n_pad, num_data, top, other):
        out = real(key, score, n_pad, num_data, top, other)
        if warm + len(calls) == GOSS_CHECK_ITER:
            seen.update(key=key, score=score.clone(), n_pad=n_pad,
                        mask=out[0].clone(), mult=out[1].clone())
        calls.append(1)
        return out
    goss_mod.goss_row_mask = spy
    try:
        booster, text, res = boost_run("goss", train, dev)
    finally:
        goss_mod.goss_row_mask = real
    gb = booster._gbdt
    rounds = BOOST_ROUNDS["goss"]
    if len(calls) != rounds - warm or not seen:
        fail(f"goss: {len(calls)} selections in {rounds} rounds, "
             f"{rounds - warm} expected after a warm-up of {warm}")
    n = gb.num_data
    top_k, other_k = goss_counts(n, 0.2, 0.1)
    in_bag = int(seen["mask"].sum())
    args = (seen["n_pad"], n, 0.2, 0.1)
    card = goss_partition(seen["key"], seen["score"], *args)
    cpu = goss_partition(seen["key"], seen["score"].cpu(), *args)
    for what, a, b in zip(("buffer", "count", "multiplier"), card, cpu):
        if not torch.equal(a.cpu(), b):
            fail(f"goss: iteration {GOSS_CHECK_ITER}'s {what} on the card "
                 f"differs from the plain goss_partition on the CPU")
    used = torch.zeros(seen["n_pad"], device=dev)
    used[card[0][:int(card[1])].long()] = 1.0
    if not torch.equal(used[:n], seen["mask"]) or \
            not torch.equal(card[2][:n], seen["mult"]) or in_bag != int(card[1]):
        fail("goss: the grower's row mask is not goss_partition's selection")
    # the selection alone at iteration 15's scores: as the per-iteration
    # path runs it (host enqueue included) and queued (card time)
    select = lambda: real(seen["key"], seen["score"], *args)
    sel_ms = time_ms(select, reps=5)
    sel_card_ms = time_queued_ms(select, reps=5)
    score = gb.train_score[0].double().cpu().numpy()
    auc = auc_of(y, score)
    if auc < AUC_FLOOR:
        fail(f"goss: training AUC {auc:.4f} below the floor {AUC_FLOOR}")
    pred = predict_checked("goss", booster, x, score, dev)
    secs = res["s_per_iteration"]
    waves = [s[2] for s in gb.tree_stats]
    res.update(auc=auc, top_k=top_k, other_k=other_k,
               in_bag_iter15=in_bag, multiplier=float(
                   seen["mult"].max()),
               warmup_s_per_tree=_median(secs[1:warm]),
               sampled_s_per_tree=_median(secs[warm:]),
               warmup_waves_per_tree=float(np.mean(waves[1:warm])),
               sampled_waves_per_tree=float(np.mean(waves[warm:])),
               selection_ms=sel_ms, selection_card_ms=sel_card_ms, **pred)
    del booster, gb, seen, card, cpu, used
    again, text2, res2 = boost_run("goss", train, dev)
    if text2 != text:
        fail(f"goss: two runs gave model text sha256 "
             f"{res['model_text_sha256']} and {res2['model_text_sha256']}")
    del again
    res["rerun"] = res2
    print(f"  boosting goss: {rounds} trees in {res['train_s']:.2f} s, "
          f"s/tree warm-up trees 2-{warm} median "
          f"{res['warmup_s_per_tree']:.5f}, sampled trees {warm + 1}-"
          f"{rounds} median {res['sampled_s_per_tree']:.5f} (waves a tree "
          f"{res['warmup_waves_per_tree']:.2f} / "
          f"{res['sampled_waves_per_tree']:.2f}; the selection alone "
          f"{sel_ms:.3f} ms, card time {sel_card_ms:.3f} ms); "
          f"{res['waves_per_tree']:.1f} waves/tree, wave_hist launches "
          f"{res['launches']} == tree waves + warm-up; iteration "
          f"{GOSS_CHECK_ITER} in-bag {in_bag} rows against top_k + "
          f"other_k = {top_k} + {other_k} = {top_k + other_k} "
          f"(multiplier {res['multiplier']:.6f}), its buffer, count and "
          f"multiplier on the card bit-equal to the plain goss_partition "
          f"on the CPU; AUC {auc:.4f}; predict {pred['predict_s']:.4f} s "
          f"bit-equal to the plain version; model text sha256 "
          f"{res['model_text_sha256']} on both runs", flush=True)
    texts, int8 = [], []
    for _ in range(2):
        b, t, r = boost_run("goss_int8", train, dev)
        texts.append(t)
        int8.append(r)
        del b
    if texts[0] != texts[1]:
        fail("goss grad_quant_bits=8: two runs gave different model text")
    print(f"  boosting goss_int8: {BOOST_ROUNDS['goss_int8']} trees twice "
          f"in {int8[0]['train_s']:.2f} / {int8[1]['train_s']:.2f} s, "
          f"byte-identical text (sha256 {int8[0]['model_text_sha256']}), "
          f"s/tree median {_median(int8[0]['s_per_iteration'][1:]):.5f}, "
          f"wave_hist launches {int8[0]['launches']} + "
          f"{int8[1]['launches']} == tree waves + warm-up", flush=True)
    return res, int8


def boost_dart(train, valid, x, xv, dev):
    """DART with the held-out set attached, one Booster.update an
    iteration: each iteration's drops, its time split by CUDA events into
    the drop (replay, catch-up, the dropped trees out of the training
    score), the tree and the normalization, the traversals counted; one
    iteration with drops grown under sync debug "error"; the held-out and
    training scores against Booster.predict within 1e-5 of max|score|."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda, traverse
    params = {**BOOST_BASE, **BOOST_RUNS["dart"], "device": dev.type}
    rounds = BOOST_ROUNDS["dart"]
    booster = lt.Booster(params, train)
    booster.add_valid(valid, "valid")
    gb = booster._gbdt
    marks = {}

    def timed(fn, a, b):
        def run(*args, **kw):
            marks[a] = torch.cuda.Event(enable_timing=True)
            marks[a].record()
            out = fn(*args, **kw)
            marks[b] = torch.cuda.Event(enable_timing=True)
            marks[b].record()
            return out
        return run
    guarded = []
    real_grow = gb._grow_trees

    def grow(*args):
        if guarded or not gb.drop_index:
            return real_grow(*args)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real_grow(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        guarded.append(gb.iter)
        return out
    gb._dropping_trees = timed(gb._dropping_trees, "d0", "d1")
    gb._normalize = timed(gb._normalize, "n0", "n1")
    gb._grow_trees = grow
    hist_cuda.wave_hist.launches.reset()
    iters = []
    t_all = time.perf_counter()
    for it in range(rounds):
        marks.clear()
        tr0 = gb.traversals
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if booster.update():
            fail(f"dart: training stopped at iteration {it}")
        torch.cuda.synchronize(dev)
        host_s = time.perf_counter() - t0
        iters.append(dict(
            drops=list(gb.drop_index), host_s=host_s,
            traversals=gb.traversals - tr0,
            drop_ms=marks["d0"].elapsed_time(marks["d1"]),
            tree_ms=marks["d1"].elapsed_time(marks["n0"]),
            normalize_ms=marks["n0"].elapsed_time(marks["n1"])))
    train_s = time.perf_counter() - t_all
    del gb._dropping_trees, gb._normalize, gb._grow_trees
    if not guarded:
        fail("dart: no iteration dropped a tree")
    launches = hist_cuda.wave_hist.launches.read()
    waves = boost_launches_ok("dart", gb, launches, rounds)
    booster.eval_valid()
    vscore = gb.valid_sets[0].score[0].double().cpu().numpy()
    tscore = gb.train_score[0, :DART_TRAIN_ROWS].double().cpu().numpy()
    scale = float(max(np.abs(vscore).max(), np.abs(tscore).max()))
    bar = 1e-5 * scale
    pv = predict_checked("dart held-out", booster, xv, vscore, dev, bar=bar)
    pt = predict_checked("dart training", booster, x[:DART_TRAIN_ROWS],
                         tscore, dev, bar=bar)
    # one traversal of the deepest tree: the training rows in the
    # grower's (G, n_pad) layout, and the held-out rows
    tree = max(gb.models, key=traverse.tree_depth)
    dt = traverse.device_tree(tree, gb.train_set, gb.config.num_leaves, dev)
    codes = gb._grower.binned_t[:, :gb.num_data]
    s_train = gb.train_score[0].clone()
    s_valid = gb.valid_sets[0].score[0].clone()
    trav_train_ms = time_queued_ms(lambda: traverse.add_tree_score(
        s_train, codes, dt, 1.0, groups_major=True), reps=5)
    trav_valid_ms = time_queued_ms(lambda: traverse.add_tree_score(
        s_valid, gb.valid_sets[0].binned, dt, 1.0), reps=5)
    dropped = sum(len(i["drops"]) for i in iters)
    with_drops = [i for i in iters if i["drops"]]
    res = dict(params={**BOOST_BASE, **BOOST_RUNS["dart"]}, rounds=rounds,
               train_s=train_s, launches=launches, waves=waves,
               waves_per_tree=waves / rounds, iterations=iters,
               dropped_trees=dropped, traversals=gb.traversals,
               sync_guarded_iteration=guarded[0],
               valid_vs_predict_max_abs=pv["predict_vs_score_max_abs"],
               train_vs_predict_max_abs=pt["predict_vs_score_max_abs"],
               bar=bar, traversal_train_ms=trav_train_ms,
               traversal_valid_ms=trav_valid_ms, deepest_tree=dt.depth,
               predict_launches=pv["predict_launches"]
               + pt["predict_launches"],
               predict_routes={k: pv["predict_routes"][k]
                               + pt["predict_routes"][k]
                               for k in pv["predict_routes"]},
               model_text_sha256=hashlib.sha256(
                   booster.model_to_string().encode()).hexdigest())
    print(f"  boosting dart: drops by iteration "
          f"{[i['drops'] for i in iters]}", flush=True)
    print(f"  boosting dart: {rounds} iterations in {train_s:.2f} s, "
          f"{dropped} dropped trees over {len(with_drops)} iterations, "
          f"{gb.traversals} traversals; s/iteration median "
          f"{_median([i['host_s'] for i in iters]):.5f} (with drops "
          f"{_median([i['host_s'] for i in with_drops]):.5f}); CUDA events "
          f"a drop iteration: drop {_median([i['drop_ms'] for i in with_drops]):.2f}"
          f" + tree {_median([i['tree_ms'] for i in with_drops]):.2f} + "
          f"normalize {_median([i['normalize_ms'] for i in with_drops]):.2f}"
          f" ms, tree alone {_median([i['tree_ms'] for i in iters if not i['drops']]):.2f}"
          f" ms; one traversal of a depth-{dt.depth} tree "
          f"{trav_train_ms:.3f} ms over the {gb.num_data} training rows "
          f"(G, n_pad) and {trav_valid_ms:.3f} ms over the "
          f"{len(xv)} held-out rows; iteration {guarded[0]}'s trees grown "
          f"under sync debug \"error\"; wave_hist launches {launches} == "
          f"tree waves + warm-up; held-out and training scores == "
          f"Booster.predict within {pv['predict_vs_score_max_abs']:.2g} "
          f"and {pt['predict_vs_score_max_abs']:.2g} (bar {bar:.2g})",
          flush=True)
    return res


def boost_rf(train, valid, xv, yv, dev, tmp):
    """RF through engine.train with the held-out set: predict's
    binary_logloss against eval_valid's, the average_output line, the
    model_file round trip bit-equal, the held-out AUC floor."""
    import numpy as np
    import lightgbm_tpu_torch as lt
    booster, text, res = boost_run("rf", train, dev, valid=valid)
    gb = booster._gbdt
    rounds = BOOST_ROUNDS["rf"]
    vscore = gb.valid_sets[0].score[0].double().cpu().numpy() / rounds
    pred = predict_checked("rf", booster, xv, vscore, dev, keep_raw=True)
    p = pred.pop("raw")
    eps = 1e-15
    pc = np.clip(p, eps, 1 - eps)
    logloss = float(-np.mean(yv * np.log(pc) + (1 - yv) * np.log(1 - pc)))
    want = res["evals"]["valid_0"]["binary_logloss"][-1]
    if abs(logloss - want) > 1e-6:
        fail(f"rf: Booster.predict's held-out binary_logloss {logloss:.8f}, "
             f"eval_valid's {want:.8f}")
    if "\naverage_output\n" not in text:
        fail("rf: the model text has no average_output line")
    auc = auc_of(yv, p)
    if auc < RF_AUC_FLOOR:
        fail(f"rf: held-out AUC {auc:.4f} below the floor {RF_AUC_FLOOR}")
    path = tmp / "rf_model.txt"
    booster.save_model(str(path))
    loaded = lt.Booster(model_file=str(path), params={"device": dev.type})
    again = predict_checked("rf loaded", loaded, xv, vscore, dev,
                            keep_raw=True)
    if not np.array_equal(again.pop("raw"), p):
        fail("rf: the model loaded through Booster(model_file=) predicts "
             "other values")
    res.update(auc_valid=auc, logloss_predict=logloss, logloss_eval=want,
               predict_launches=pred["predict_launches"]
               + again["predict_launches"],
               predict_routes={k: pred["predict_routes"][k]
                               + again["predict_routes"][k]
                               for k in pred["predict_routes"]},
               predict_s=pred["predict_s"])
    print(f"  boosting rf: {rounds} trees in {res['train_s']:.2f} s, s/tree "
          f"median {_median(res['s_per_iteration'][1:]):.5f}, "
          f"{res['waves_per_tree']:.1f} waves/tree, wave_hist launches "
          f"{res['launches']} == tree waves + warm-up; held-out AUC "
          f"{auc:.4f} (floor {RF_AUC_FLOOR}), binary_logloss "
          f"{logloss:.6f} from predict == eval_valid's {want:.6f}; "
          f"average_output in the text; Booster(model_file=) predicts "
          f"bit-equal; both predicts bit-equal to the plain version",
          flush=True)
    return res


def phase_boosting(dev, seed: int, dense, x, y):
    """GOSS, DART and RF through engine.train and Booster on the card,
    on the train phase's dense binning of the 2M HIGGS-shape rows, with
    VALID_ROWS held-out rows (higgs_shape(VALID_ROWS, seed + 1)) binned on
    the card against its mappers."""
    import tempfile
    OUT_DIR.mkdir(exist_ok=True)
    import numpy as np
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    t0 = time.perf_counter()
    xv, yv = higgs_shape(VALID_ROWS, seed + 1)
    vds = BinnedDataset.construct_from_device_matrix(
        torch.from_numpy(xv).to(dev), Config(dict(TRAIN_BASE)),
        reference=dense)
    vds.metadata.set_label(yv)
    valid_s = time.perf_counter() - t0
    train = dataset_of(dense)
    valid = dataset_of(vds, reference=train)
    goss, int8 = boost_goss(train, x, y, dev)
    dart = boost_dart(train, valid, x, xv, dev)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        rf = boost_rf(train, valid, xv, yv, dev, Path(tmp))
    runs = dict(goss=goss, goss_int8=int8, dart=dart, rf=rf)
    launches = (goss["launches"] + goss["rerun"]["launches"]
                + sum(r["launches"] for r in int8) + dart["launches"]
                + rf["launches"])
    routes = {k: goss["predict_routes"][k] + dart["predict_routes"][k]
              + rf["predict_routes"][k] for k in goss["predict_routes"]}
    print(f"phase boosting: ok (goss, goss_int8 x2, dart, rf; valid "
          f"binned in {valid_s:.2f} s; wave_hist launches {launches}, "
          f"forest_predict launches {sum(routes.values())})", flush=True)
    return dict(runs=runs, valid_rows=VALID_ROWS, valid_bin_s=valid_s,
                launches=launches,
                predict_launches=sum(routes.values()),
                predict_routes=routes)


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
#: the fork harness's serving shape: trees of its config (8 windows of
#: retraining, 31 leaves) over its rows (HISTFEATURES + 3 = 53 columns,
#: src/capi/smoke_test.cpp:24-31,86), 2M f64 rows
FORK = dict(num_iterations=8, num_leaves=31, num_features=53)
FORK_ROWS = 2_000_000
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


def forest_bound(tables, x, tid, leaves, num_model):
    """The least time the card could take to route ``x`` through
    ``tables``: the bytes of the function (query rows read once, scores
    written once, tenant ids, the pack) at the memory rate, or three f32
    compares a node visit that these rows make (from their ``leaves``) at
    the f32 rate, whichever is larger."""
    import torch
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
    return dict(node_visits=visits, bytes=bytes_, bytes_bound_ms=bytes_ms,
                ops_bound_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def forest_case(name, pack, x, tid, *, reps):
    """Hold forest_predict against its plain version on the card (scores
    and leaves, bit for bit), time both with CUDA events (inputs already
    on the card; the kernel's launches queued behind a sleep kernel), and
    compute its bound (:func:`forest_bound`).  ``pack`` is a
    PackedEnsemble or PackedFleet."""
    import torch
    from lightgbm_tpu_torch.serve import packed
    tables = pack.tables()
    num_model, max_depth = pack.num_model, pack.max_depth
    kw = dict(num_model=num_model, max_depth=max_depth)
    run = lambda: packed.forest_predict(tables, x, tid, records=pack.records,
                                        **kw)
    before = forest_counts()
    scores = run()
    route = [k for k, v in counts_since(before)[1].items() if v][0]
    leaves = packed.forest_predict(tables, x, tid, leaves=True,
                                   records=pack.records, **kw)
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
    ms = time_queued_ms(run, reps=reps)
    r, t = leaves.shape
    m_, _, n = tables.split_feature.shape
    geo = packed.forest_geometry(
        r, t, n, x.shape[1], x.dtype == torch.float64, False, num_model,
        tenants=m_ if tid is not None else 1,
        sm_count=torch.cuda.get_device_properties(x.device)
        .multi_processor_count)
    bound = forest_bound(tables, x, tid, leaves, num_model)
    before_ms = FOREST_BEFORE_MS.get(name)
    visits = bound["node_visits"]
    res = dict(case=name, rows=r, trees=t, num_model=num_model,
               max_depth=max_depth, x_dtype=str(x.dtype), ok=ok,
               max_abs_err=err, ms=ms, before_ms_quoted=before_ms,
               plain_ms=plain_ms, route=route, geometry=geo._asdict(),
               **bound, visits_per_s=visits / (ms * 1e-3), library_ms=None)
    quoted = ("" if before_ms is None else
              f" (PR 4, quoted from PERF.md: {before_ms:.3f} ms)")
    print(f"  serve {name}: {r} rows x {t} trees (K={num_model}, depth pad "
          f"{max_depth}, {x.shape[1]} {x.dtype} columns): bit-equal to "
          f"plain={ok}, route {route} (rows/block {geo.rows_per_block}, "
          f"chunk {geo.chunk_trees} trees, trees in shared memory "
          f"{geo.smem_trees}, rows staged {geo.stage_rows}, tenant grouping "
          f"{bool(geo.group_blocks)}, {geo.smem_bytes} B), kernel "
          f"{ms:.3f} ms{quoted}, plain {plain_ms:.1f} ms, bound "
          f"{res['bound_ms'] * 1e3:.1f} us ({res['bound_by']}; "
          f"{visits / (r * t):.2f} node visits a pair, "
          f"{res['visits_per_s']:.3g} visits/s)", flush=True)
    if not ok:
        fail(f"forest_predict disagrees with its plain version ({name})")
    return res, scores, leaves


#: the 500-tree forest's small batches: rows, and launches timed of each
SMALL_ROWS = {1: 500, 100: 500, 1_000: 200, 10_000: 50}


def small_batches(pe, xs):
    """The 500-tree forest at SMALL_ROWS rows: the route the wrapper picks
    and each route forced, each bit-equal to the plain version (scores and
    leaves), each timed (the route crossover)."""
    import torch
    from lightgbm_tpu_torch.serve import packed
    tables, rec = pe.tables(), pe.records
    _, t, n = tables.split_feature.shape
    kw = dict(num_model=pe.num_model, max_depth=pe.max_depth)
    sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
    out = []
    for rows, reps in SMALL_ROWS.items():
        x = xs[:rows]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = packed.forest_predict_reference(tables, x, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        want_leaves = packed.forest_predict_reference(tables, x, leaves=True,
                                                      **kw)
        line = dict(rows=rows, plain_ms=plain_ms,
                    **forest_bound(tables, x, None, want_leaves,
                                   pe.num_model))
        for route in ("auto", "rows", "trees"):
            geo = packed.forest_geometry(
                rows, t, n, x.shape[1], True, False, pe.num_model,
                sm_count=sms, route=None if route == "auto" else route)
            if route == "auto":
                line["route"] = geo.route
                run = lambda: packed.forest_predict(tables, x, records=rec,
                                                    **kw)
            else:
                run = lambda geo=geo: packed.launch_forest(rec, x, None, geo,
                                                           **kw)
            got = run()
            leaves_geo = packed.forest_geometry(
                rows, t, n, x.shape[1], True, True, pe.num_model,
                sm_count=sms, route=geo.route)
            got_leaves = packed.launch_forest(rec, x, None, leaves_geo,
                                              leaves=True, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got.view(torch.int32), want.view(torch.int32))
                    and torch.equal(got_leaves, want_leaves)):
                fail(f"forest_predict route {route} at {rows} rows differs "
                     f"from the plain version")
            line[f"{route}_ms"] = time_queued_ms(run, reps)
        out.append(line)
        print(f"  serve 500 trees x {rows} rows: route {line['route']} "
              f"{line['auto_ms'] * 1e3:.1f} us; forced: rows "
              f"{line['rows_ms'] * 1e3:.1f} us, trees "
              f"{line['trees_ms'] * 1e3:.1f} us (bit-equal to the plain "
              f"version, scores and leaves); plain {plain_ms:.1f} ms, bound "
              f"{line['bound_ms'] * 1e3:.2f} us ({line['bound_by']})",
              flush=True)
    return out


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
    before = forest_counts()    # the main path: requests and submits
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
        with _NoHostWalk():
            t0 = time.perf_counter()
            got = server.predict(rows)
            lat[n].append(time.perf_counter() - t0)
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
    launches, routes = counts_since(before)
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
          f"({answers.checked_rows} rows); launches by route {routes}",
          flush=True)
    return dict(launches=launches, routes=routes,
                submit_launches=submit_launches,
                checked_rows=answers.checked_rows,
                host_max_abs=answers.host_max_abs,
                latency_ms={str(n): dict(p50=a, p95=b, requests=len(lat[n]))
                            for n, (a, b) in pct.items()},
                submit_latency_ms=dict(p50=sub_pct[0], p95=sub_pct[1],
                                       requests=n_sub))


#: requests of each size to the server of the 500-tree forest
SYN_SERVER_REQUESTS = {1: 40, 100: 40}


def serve_server_syn(dev, syn, seed: int):
    """A PredictionServer over the 500-tree synthetic forest: requests of
    1 and 100 rows (the harness's per-request scoring against a forest of
    hundreds of trees), timed, then each answer held bit for bit against
    the plain version on the served pack."""
    import numpy as np
    import torch
    import synthetic_forests as synthetic
    from lightgbm_tpu_torch.serve import PredictionServer, packed
    server = PredictionServer(syn, device=dev)
    server.warmup()
    model = server._snapshot()
    pe = model.packed
    x = synthetic.query_rows(syn, sum(n * k for n, k in
                                      SYN_SERVER_REQUESTS.items()),
                             seed, cat_features=SYN["cat_features"])
    plan = [n for n, k in SYN_SERVER_REQUESTS.items() for _ in range(k)]
    order = np.random.default_rng(2).permutation(len(plan))
    lat = {n: [] for n in SYN_SERVER_REQUESTS}
    served, off = [], 0
    before = forest_counts()
    for j in order:
        n = plan[j]
        rows = x[off:off + n]
        off += n
        with _NoHostWalk():
            t0 = time.perf_counter()
            got = server.predict(rows)
            lat[n].append(time.perf_counter() - t0)
        served.append((rows, got))
    launches, routes = counts_since(before)
    for rows, got in served:
        plain = packed.forest_predict_reference(
            pe.tables(), torch.from_numpy(rows).to(dev), num_model=1,
            max_depth=pe.max_depth)
        if not np.array_equal(got, model.convert(
                plain.cpu().numpy().astype(np.float64), False)):
            fail("the 500-tree server's answer differs from the plain "
                 "version on the served pack")
    pct = {n: (float(np.percentile(v, 50)) * 1e3,
               float(np.percentile(v, 95)) * 1e3) for n, v in lat.items()}
    for n, (p50, p95) in pct.items():
        print(f"  serve 500-tree server: {n} rows x {len(lat[n])} requests: "
              f"p50 {p50:.3f} ms, p95 {p95:.3f} ms", flush=True)
    print(f"  serve 500-tree server: {len(served)} answers bit-equal to the "
          f"plain version on the served pack; launches by route {routes}",
          flush=True)
    return dict(launches=launches, routes=routes,
                latency_ms={str(n): dict(p50=a, p95=b, requests=len(lat[n]))
                            for n, (a, b) in pct.items()})


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
    res, scores, leaves = forest_case("higgs", pe, xd, None, reps=20)
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
    cases["synthetic"], _, _ = forest_case("synthetic", pe, xs, None, reps=5)
    xh = synthetic.query_rows(syn, SYN_HOST_ROWS, seed + 9, near=False,
                              cat_features=cats)
    check_host("synthetic", cases["synthetic"], syn.models, 1,
               packed.predict_leaves(pe, xh), packed.predict_scores(pe, xh),
               xh)
    small = small_batches(pe, xs)
    del xs

    mc = synthetic.random_forest(seed + 10, **MC)
    pe = packed.pack_gbdt(mc, *MC_SLICE, device=dev)
    xm = torch.from_numpy(synthetic.query_rows(
        mc, MC_ROWS, seed + 11, cat_features=MC["cat_features"])).to(dev)
    cases["multiclass_slice"], _, _ = forest_case("multiclass_slice", pe, xm,
                                                  None, reps=5)
    del xm
    xh = synthetic.query_rows(mc, SYN_HOST_ROWS, seed + 13, near=False,
                              cat_features=MC["cat_features"])
    check_host("multiclass_slice", cases["multiclass_slice"],
               packed.tree_slice(mc.models, 3, *MC_SLICE), 3,
               packed.predict_leaves(pe, xh), packed.predict_scores(pe, xh),
               xh)

    # the fork harness's serving shape: its config's trees (8 windows, 31
    # leaves) over its 53-column rows (src/capi/smoke_test.cpp:24-31,86)
    fork = synthetic.random_forest(seed + 14, **FORK)
    pe = packed.pack_gbdt(fork, device=dev)
    xk = torch.from_numpy(synthetic.query_rows(fork, FORK_ROWS,
                                               seed + 15)).to(dev)
    cases["fork_53"], _, _ = forest_case("fork_53", pe, xk, None, reps=10)
    geo = cases["fork_53"]["geometry"]
    if not (geo["stage_rows"] and (geo["smem_trees"]
                                   or geo["route"] == "trees")):
        fail("the fork's 53-column rows were not staged in shared memory")
    xh = synthetic.query_rows(fork, SYN_HOST_ROWS, seed + 16, near=False)
    check_host("fork_53", cases["fork_53"], fork.models, 1,
               packed.predict_leaves(pe, xh), packed.predict_scores(pe, xh),
               xh)
    del xk

    tenants = [lt.Booster(model_str=models[k]) for k in
               ("higgs", "harness", "int8")] + [syn]
    rng = np.random.default_rng(seed + 12)
    tid_np = rng.integers(0, len(tenants), FLEET_ROWS).astype(np.int32)
    tid = torch.from_numpy(tid_np).to(dev)
    xf = xd[:FLEET_ROWS]
    for vdt in ("f32", "bf16"):
        fl, packs = fleet.pack_fleet(tenants, device=dev, value_dtype=vdt)
        cases[f"fleet_{vdt}"], fs, _ = forest_case(f"fleet_{vdt}", fl, xf,
                                                   tid, reps=5)
        if vdt == "f32":
            check_fleet_host(fl, tenants, x, tid_np, cases["fleet_f32"])
            for m, solo in enumerate(packs):
                rows = tid == m
                got = packed.forest_predict(solo.tables(), xf[rows],
                                            num_model=1,
                                            max_depth=solo.max_depth,
                                            records=solo.records)
                if not torch.equal(fs[:, rows].view(torch.int32),
                                   got.view(torch.int32)):
                    fail(f"fleet tenant {m} differs from its solo pack")
    # the fleet's entry point, counted as main-path launches
    n = min(100_000, FLEET_ROWS)
    before = forest_counts()
    with _NoHostWalk():
        t0 = time.perf_counter()
        out = fleet.fleet_predict_scores(fl, tid_np[:n], x[:n])
        fleet_s = time.perf_counter() - t0
    fleet_launches, fleet_routes = counts_since(before)
    if fleet_launches <= 0 or out.shape != (1, n) \
            or not np.isfinite(out).all():
        fail(f"fleet_predict_scores: {fleet_launches} launches, shape "
             f"{out.shape}")
    print(f"  serve fleet entry point: {n} mixed-tenant rows (bf16 leaf "
          f"values) in {fleet_s * 1e3:.1f} ms, {fleet_launches} launch, "
          f"routes {fleet_routes}", flush=True)
    del xd, xf

    server = serve_server(dev, models, x)
    server_syn = serve_server_syn(dev, syn, seed + 17)
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        fail(f"serve cases failed: {bad}")
    routes = {k: fleet_routes[k] + server["routes"][k]
              + server_syn["routes"][k] for k in fleet_routes}
    print(f"phase serve: ok {len(cases)} kernel cases bit-equal to the "
          f"plain version; PredictionServers {server['launches']} + "
          f"{server_syn['launches']} and fleet {fleet_launches} "
          f"forest_predict launches, by route {routes}", flush=True)
    return dict(cases=cases, small_batches=small, server=server,
                server_syn=server_syn, fleet_entry_launches=fleet_launches,
                fleet_entry_routes=fleet_routes, fleet_entry_s=fleet_s)


def device_time(fn):
    """Wall ms of one call of ``fn``, its device time by kernel, (name,
    ms, launches) largest first (torch.profiler), and the CUDA-event span
    of the call on the stream (ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, rows, start.elapsed_time(end)


def wave_hist_in_trace(rows) -> int:
    """Launches of csrc/wave_hist.cu's histogram kernel in a trace."""
    return sum(r[2] for r in rows if "wave_hist_list_kernel" in r[0])


def profile_ops(label, fn, waves=False):
    """Print and return the device time by kernel of one call of ``fn``,
    busy against the call's CUDA-event span.  ``waves``: the call trains
    (the wave_hist counter was reset before it), and its busy time is
    quoted only from a trace that holds every wave_hist launch."""
    wall, rows, span = device_time(fn)
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    complete = not waves or trace_complete(label, wave_hist_in_trace(rows))
    if complete:
        print(f"  profile {label}: {wall * 1e3:.2f} ms wall, {span:.2f} ms "
              f"CUDA-event span, {busy:.3f} ms device busy in {launches} "
              f"launches (device idle {1 - busy / span:.1%} of the span, "
              f"the profiler's stretch included)")
    for key, ms, count in rows[:8]:
        print(f"    {ms:9.3f} ms  {count:6d}x  {key[:90]}")
    return dict(wall_ms=wall * 1e3, span_ms=span, complete=complete,
                device_busy_ms=busy if complete else None, launches=launches,
                top=[dict(kernel=k, ms=m, count=c) for k, m, c in rows[:20]])


def unprofiled_idle(what, prof, times_s, trees) -> str:
    """The device busy time of a complete trace against the median
    unprofiled time of the same work.  The profiler stretches the traced
    call (its own span overstates the idle share) and its kernels too (a
    harness chunk's traced busy time exceeded the unprofiled chunk's
    time), so the share is a lower bound on the idle share, and is not
    resolved when the busy time is the longer."""
    wall = sorted(times_s)[len(times_s) // 2] * trees * 1e3
    busy = prof["device_busy_ms"]
    idle = (f"idle at least {1 - busy / wall:.1%}" if busy < wall
            else "idle not resolved: the trace's busy time is the longer")
    return (f"{what}: device busy {busy:.2f} ms in the trace against "
            f"{wall:.2f} ms, the median unprofiled time ({idle}), "
            f"{prof['launches'] / trees:.0f} kernels a tree")


def trace_complete(label, seen: int) -> bool:
    """Whether a trace holds every wave_hist launch its call made (the
    device counter, reset before the call): a trace of graph replays can
    miss kernels, and then its busy time is not quoted."""
    from lightgbm_tpu_torch.ops import hist_cuda
    want = hist_cuda.wave_hist.launches.read()
    if seen != want:
        print(f"  profile {label}: the trace holds {seen} of the "
              f"{want} wave_hist launches the device counted; its busy "
              f"time and idle share are not quoted", flush=True)
    return seen == want


def profile_tree(gb, per_tree_s):
    """Device time by kernel over one more tree (torch.profiler), with the
    run's bagging mask, feature mask and quantization key; busy and idle
    only from a complete trace, idle also against ``per_tree_s``, the
    unprofiled per-iteration trees' seconds."""
    from lightgbm_tpu_torch.ops import hist_cuda
    grower = gb._grower
    # class 0's tree (a multiclass objective's gradients are (K, N))
    grad, hess = (t.reshape(-1, t.shape[-1])[0] for t in
                  gb.objective.get_gradients(gb.train_score))
    gb.bagging(gb.iter)
    hist_cuda.wave_hist.launches.reset()
    wall, rows, span = device_time(lambda: grower.grow_one_iter(
        gb.train_score[0].clone(), grad, hess,
        feature_mask=grower.feature_mask_for(gb.iter),
        row_mask=gb.row_mask, tree_idx=gb.iter))
    complete = trace_complete("one tree", wave_hist_in_trace(rows))
    busy = sum(r[1] for r in rows)
    # the histogram layer: every kernel of csrc/wave_hist.cu
    hist = [r for r in rows if any(name in r[0] for name in HIST_KERNELS)]
    hist_ms = sum(r[1] for r in hist)
    res = dict(wall_ms=wall * 1e3, span_ms=span, complete=complete,
               device_busy_ms=busy if complete else None,
               launches=sum(r[2] for r in rows), hist_kernel_ms=hist_ms,
               top=[dict(kernel=k, ms=m, count=c) for k, m, c in rows[:40]])
    if complete:
        print(f"  profile: one tree {wall * 1e3:.1f} ms wall, {span:.2f} ms "
              f"CUDA-event span under the profiler, {busy:.2f} ms device "
              f"busy, {hist_ms:.3f} ms in the histogram kernels "
              f"({sum(r[2] for r in hist)} launches); "
              f"{unprofiled_idle('a tree', res, per_tree_s, 1)}")
    for key, ms, count in rows[:15]:
        print(f"    {ms:9.3f} ms  {count:6d}x  {key[:90]}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more tree of each run, the "
                    "codes and the validation scoring by kernel")
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
    train, models, x, y, dense = phase_train(dev, args.seed, args.profile)
    objectives = phase_objectives(dev, args.seed, x, dense, args.profile)
    data = phase_data(dev, args.seed, dense, x, y, train, args.profile)
    boosting = phase_boosting(dev, args.seed, dense, x, y)
    del dense, y
    serve = phase_serve(dev, models, x, args.seed)
    del x
    multiclass = phase_multiclass(dev, args.seed, args.profile)

    # wave_hist's path is training: its launches are those of every run
    # (the data phase's two and the boosting phase's six included); wave_hist_v2's path is the ubench
    # entry point; forest_predict's is prediction: Booster.predict after
    # each training run and of the validation rows, the fleet's entry
    # point and the two PredictionServers (not the comparison launches),
    # and both of its routes must have run there
    obj_runs = objectives["runs"].values()
    v1_launches = (sum(r["launches"] for r in train["runs"].values())
                   + sum(r["launches"] for r in obj_runs)
                   + data["launches"] + data["engine_launches"]
                   + boosting["launches"] + multiclass["launches"])
    fp_launches = (sum(r["predict_launches"] for r in train["runs"].values())
                   + sum(r["predict_launches"] for r in obj_runs)
                   + data["predict_launches"]
                   + boosting["predict_launches"]
                   + serve["fleet_entry_launches"]
                   + serve["server"]["launches"]
                   + serve["server_syn"]["launches"]
                   + multiclass["predict_launches"])
    fp_routes = {k: (sum(r["predict_routes"][k]
                         for r in train["runs"].values())
                     + sum(r["predict_routes"][k] for r in obj_runs)
                     + data["predict_routes"][k]
                     + boosting["predict_routes"][k]
                     + serve["fleet_entry_routes"][k]
                     + serve["server"]["routes"][k]
                     + serve["server_syn"]["routes"][k]
                     + multiclass["predict_routes"][k])
                 for k in serve["fleet_entry_routes"]}
    if min(fp_routes.values()) <= 0:
        fail(f"a forest_predict route never ran on the main path: "
             f"{fp_routes}")
    print(f"forest_predict on the main path: {fp_launches} launches, by "
          f"route {fp_routes}", flush=True)
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
    line["kernels"][2]["launches_by_route"] = fp_routes
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke.json", "w") as fh:
        json.dump(dict(card=card, kind=kind, build_s=build_s,
                       kernels=kernels, ubench=ubench, train=train,
                       objectives=objectives, data=data,
                       boosting=boosting, serve=serve,
                       multiclass=multiclass,
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
