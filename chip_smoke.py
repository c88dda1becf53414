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
              tc_ms (past LIBRARY_SORT_TERMS terms the library call is one
              index_add_: index_put_'s sort would not fit the card); wave_hist
              also in the layouts past COUNT_SPLIT_ROWS at the fork's
              window (20M x 53: striped K=4 bf16 at W=96 and 30, striped
              int8 K=6 at W=64 and 30, gpu_use_dp's K=6 at W=30; W=30 is
              the window's 31 leaves') and gpu_use_dp's K=5 (W=76) and
              K=6 (W=64) bf16 at 2M x 28, and its one-slot list mode
              (wave_hist_rows, the host learner's window histogram) with
              f32 stats over a ragged window of 1,234,567 rows of a
              permuted 2M-row buffer and over the 34,603,008-row root
              window (its rows in order, and in a random order),
              bit-equal to wave_hist_rows_fixed_reference;
3. ubench  -- scripts/ubench_hist_cuda.py's hist3_w42 and pallas2_*
              cases at its default 10.5M rows: the entry point of the
              tensor-core kernel wave_hist_v2, whose launches are counted
              here;
   clock   -- the device clock's stamp kernel (csrc/obs_clock.cu) on card
              tensors, each mode against the plain stamp on the same
              table (the same cells change; other rows and slots outside
              the table untouched; OPEN_TREE zeroes hist_ns), an
              OPEN/CLOSE pair against CUDA events around one kernel, and
              a stamp's time in a CUDA graph; its launches on the main
              path (every phase after it) are counted on the device;
   routing -- the wave's row routing (csrc/split_rows.cu) through one
              tree's waves at each benchmark cell's shape (higgs: 2^24
              padded rows, 10.5M real, 28 groups, 255 leaves, W=96;
              fork: 20M rows, 53 groups, 31 leaves, W=30), the legacy
              stage plan's widths, random leaves, features and
              thresholds: bit-equal to the plain version at every wave,
              each wave timed beside its bytes' bound and the plain
              version's time; its launches counted on the device, on the
              main path too, where every run of the train, boosting,
              window20m and multiclass phases must launch it once a wave;
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
              must equal the trees' waves plus the warm-up waves, as
              must split_rows's, and the device clock's stamps four a
              tree and two a wave.
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
8. pipeline -- the fork's retrain-every-window loop (RetrainPipeline) at
              the harness's shape (examples/cache_admission.py,
              src/test.cpp): a Zipf(0.8) trace over 200,000 objects made
              from --seed, 4 windows of 1,000,000 requests, OPT labels
              and the 53 CSR features (50 inter-arrival gaps, log2 size,
              cache bytes available, cost), each window trained on its
              last 500,000 rows with the fork's configuration (binary,
              max_bin 255, 31 leaves, 50 iterations fused in chunks of 25,
              feature_fraction 0.8, bagging every 5 at 0.8,
              min_data_in_leaf 50, min_sum_hessian 5.0) and, from window 1
              on, scored first by the previous model over all its
              1,000,000 rows through the server: (b) pipelined fresh, the
              features derived in its prep thread, a prober thread asking
              the server for 1-1,000 rows throughout; (a) a serial loop of
              fresh GBDTs with reference= binning against window 0, every
              window's sha256 equal to (b)'s; (c) warm with 10 more
              iterations a window, the card's leaf ids equal to the host
              walk of 100,000 rows for every copied tree and the refit
              scores summed from them equal to predict's within 1e-6 of
              max|score|; (d) (b) with a checkpoint directory and the
              fault pipeline.prep:at=2, resumed to (b)'s final sha256.
              Fails unless every prober request succeeded, one inside a
              later window's training, every swap of (b) kept its pads,
              the held-out AUC of (b) clears PIPE_AUC_FLOOR and each
              run's wave_hist launches equal its trees' waves plus
              warm-up.  Prints per window prep, stall, train, eval and
              swap seconds, drift, rebinned, CUDA-graph captures and
              their seconds, s/tree and host syncs; per run the overlap
              fraction, one window's featurization and host-binning
              seconds and the quality on the next window; the obs
              snapshot's pipeline.* counters; writes run (b)'s Chrome
              trace to chiprun_out/pipeline_b_trace.json.  Telemetry is
              on in this phase only;
9. serve   -- csrc/forest_predict.cu, the packed-forest kernel: the higgs
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
10. multiclass -- BASELINE.json's config 4 on an Expedia-shaped set made
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
              text, each chunk bit-equal to the plain loop);
11. window20m -- the fork's window at its real size (after boosting):
              20,000,000 x 53 rows in the harness's column distributions
              (window_shape, from --seed; a 2,000,000-row held-out tail),
              binned on the card (construct_from_device_matrix), trained
              with the fork's configuration (50 iterations, chunks of 25):
              bf16 fused and per-iteration (the same sha256; striped K=4
              counts, W=30, the exact 20M-row pad), int8 (K=6, the f32
              fallback scan past INT32_SCAN_ROWS) and gpu_use_dp (K=6),
              every tree's leaf counts equal to its bag's rows, launches ==
              waves + warm-up, held-out AUC >= WIN_AUC_FLOOR; then
              gpu_use_dp's K=5 on the train phase's 2M x 28 binning;
12. host_learner -- the host tree learner on the card (after window20m)
              on the train phase's 2M x 28 binning, 63 leaves, 5 rounds:
              monotone constraints on 3 columns (predictions monotone
              along a sweep of each), a depth-2 forced-split JSON (every
              tree starts with it), regression_l1, quantile (alpha 0.9)
              and mape on regression_target (the training metric falls),
              and a custom fobj (binary logloss); each through
              forest_predict (bit-equal to its plain version) and within
              1e-5 of the host walk; then 34,603,008 x 28 rows (the train
              phase's 2M repeated on the card) binned on the card, 3
              trees of 31 leaves: the route
              logs why the host learner trains, every tree's leaf counts
              sum to the rows.

13. capi   -- the C ABI on the card (after pipeline): src/capi_cuda/ built
              with its Makefile (liblgbm_tpu_torch.so against the
              unchanged include/lightgbm_tpu/c_api.h; a failed build fails
              the run); the unchanged src/capi/smoke_test.cpp linked to it
              run as a subprocess (no device in its parameters: the card),
              twice with one LGBM_TPU_COMPILE_CACHE directory, the second
              run's LGBM_WarmupTrain building 0 libraries; then
              window_harness (src/capi_cuda/window_harness.cpp) over
              CAPI_WINDOWS windows of 1,000,000 rows of the harness's 53
              columns (window_shape, zeros dropped, written as raw CSR
              arrays to a temporary directory): warm-up, then per training
              window DatasetCreateFromCSR (window 0 the reference of the
              rest), SetField, BoosterCreate, UpdateChunked (the fork's
              parameters, chunks of 25), ServeCreate/ServeSwap,
              BoosterPredictForCSR and ServePredictForCSR of the next
              window, serve p50 at 1 and 100,000 rows, SaveModel and
              BoosterFree, a two-tenant fleet on the last; the same
              windows trained in this process through engine.train with
              the grower cache on and off: every window's trees (the
              model text before its parameters block) with one sha256 in
              all three runs, the ABI's predictions equal to
              Booster.predict of the same rows within 1e-12, windows 1-2
              capturing nothing and each taking the cached grower (a
              grow.cache_hits a window, in the harness's metrics file
              too), held-out AUC >= WIN_AUC_FLOOR, and the harness's
              wave_hist, forest_predict and capture counts above 0.
              Prints per window DatasetCreate s, train s, ms a tree,
              captures, predict s, serve p50, the ABI's train s against
              the in-process run's, and peak card memory with the cache
              on.  The harness's processes (LGBM_TPU_COMPILE_CACHE set:
              a plan store) measure the wave-stage plan once under
              wave_plan=auto (2M rows); the in-process runs adopt the
              plan they kept, so all three grow under one plan;
14. api    -- the rest of the training API (after capi) at the HIGGS
              shape: the 2M x 28 rows binned once on the card and kept
              raw (free_raw_data=False), 255 leaves, max_bin 255: (1)
              5 rounds, save_model, then engine.train(init_model=path)
              5 more (10 iterations, the first 5 trees' text byte-equal
              to the saved model's, held-out AUC on 500,000 rows at
              least the first model's; the init score's forest_predict
              launches); (2) learning_rates=0.1*0.9**i for 10 rounds per
              iteration (each tree's shrinkage its rate; the training
              score against predict_raw of the training rows, under
              1e-4), then a reset to 0.05 and a fused chunk (its trees'
              shrinkage 0.05, the score again), a reset of
              min_data_in_leaf refused by name, and a refused booster's
              grower adopted by a new booster with the trees of
              grower_cache=false; (3) cv, 3 folds, 5 rounds, AUC mean
              >= AUC_FLOOR; (4) LGBMClassifier(n_estimators=10,
              num_leaves=255): its trees byte-equal to engine.train's
              with the params it passes, predict_proba[:, 1] equal to
              Booster.predict; (5) a pickled booster's predictions
              byte-equal; (6) wave_plan=profiled: kernel 1 timed at
              every candidate width on the real codes (median and
              spread of PROBE_REPS launches), the fit, its
              residuals, the derived plan (installed and kept in the
              store), s/tree of fused chunks against the fixed ladder's,
              training AUC >= AUC_FLOOR, a second booster and a fresh
              process adopting the plan with 0 profiles, and
              wave_plan=auto with a fresh store measuring once and
              keeping its verdict (the derived plan only past the 2%
              bar at the probes' worst case).
15. soak   -- the fleet chaos soak (after api; soak/): (1) the main soak,
              the fork's model (53 CSR columns, 31 leaves, max_bin 255, 50
              iterations, no bagging) on 4 tenants and 2 replicas, 3
              windows a tenant of 500,000 requests (the pipeline
              phase's trace, halved: 200,000 objects, 250,000 sampled
              rows, a 2^30-byte cache), the JAX default's chaos (1 kill, 1 poison
              batch, 1 dead peer, 1 clock skew, 0 device deaths), the
              exporter on (stream and prom files, the scrape endpoint on
              a free port read once): the verdict ok with chip_pending
              false and every gate passing (throughput included: 1.5 x
              the fork's 125.4 s per 20M rows), 0 fallback requests, the
              exporter dropping and failing nothing, every stream line
              and the exposition schema-valid, the killed tenant's final
              model text equal to its unfaulted replay's; prints each
              gate, train_s_per_1M_sampled_rows, request p50/p95, the
              kernels' launches, peak card memory and seconds; (2) the
              forced-fail soak (2 tenants, 2 windows, 250,000 sampled
              rows, a persistent device death): the verdict fails exactly
              availability and slo, fallback requests > 0, their answers
              within 1e-12 of the host walk of the tenants' final texts;
              (3) a PredictionServer over the higgs model with
              serve.dispatch:n=3 and a 0.2 s re-probe: three host answers
              (within rtol 1e-5, atol 1e-6 of the kernel's), degraded,
              then the re-probe launches forest_predict, observes
              serve.degraded_time and sets serve.degraded back to 0; (4)
              DeviceGrower.profile_phases on a higgs grower (2M x 28, 255
              leaves): each phase's CUDA-event ms, its counted cost,
              achieved bytes/s and roofline shares, and the attribution
              report against the train phase's per-iteration s/tree: the
              uncapped ratio of phase ms x waves to the measured tree
              (printed, not gated; every probe runs at the full width).

16. stream -- (after host_learner) a HIGGS-shaped CSV of 500,000 rows
              from --seed: load_text_two_round with the whole file
              sampled (codes and mappers byte-equal to the matrix in
              memory binned by construct_from_matrix), round one and two
              timed at the default sample, task=train two_round=true
              through the CLI's entry point on the card (10 rounds, 255
              leaves, kernel 1's launches counted, training AUC >=
              AUC_FLOOR), task=predict through the CLI's chunked
              run_predict on the card (the file equal to Booster.predict
              of the rows written with %g).
17. shard  -- the device grower over four shards of the card (GBDT.mesh,
              data_sharding=single_controller) on the train phase's codes,
              the higgs, int8 and harness configurations, 10 fused trees
              each: the model text sha256 equal to the unsharded run's,
              kernel 1 four launches a wave, one wave's reduced
              histograms bit-equal to the unsharded launch (the grower's
              regime and f32), fused s/tree sharded and unsharded;
              wave_hist_sharded at the shard's shape bit-equal and timed.
18. parallel -- the data-, feature- and voting-parallel learners over four
              workers of the card through create_tree_learner and the
              boosting loop (5 rounds, 31 leaves, 2M x 28 binned by
              construct_pre_partitioned over four row blocks): feature
              and data trees byte-equal to the serial learner's, voting
              (top_k 28) equal or its first parting split named, voting
              top_k 5 training AUC >= AUC_FLOOR, allreduce bytes a tree
              and s/tree of each; wave_hist_rows_sharded at the data
              learner's shape bit-equal and timed.

19. pod    -- (after stream, on its CSV) the multi-controller pod: one
              process a host (scripts/pod_cuda.py, gloo over localhost),
              every leg over four shards of the card (shard_devices =
              4 // hosts): a single-controller baseline in this process;
              (its first POD_ROWS = 50,000 rows, cut for time: every host
              parses the whole file in each of the run's five loads)
              (a) 4 processes through load_text_multihost and the API,
              higgs, int8 and harness, 10 rounds each; (b) 2 processes
              through the CLI (task=train two_round=true
              data_sharding=multi_controller), higgs; (c) 2 processes,
              int8 at 31 leaves, the last host killed before it acks the
              iteration-4 snapshot, then a fresh pod that refuses it,
              resumes iteration 2 and trains to 6: every rank's model
              text sha256 the baseline's, kernel 1 one launch a wave a
              shard, the reduction one a wave; one JSON line a leg with
              s/tree, launches, the reduction's bytes and ms a wave, the
              bring-up and load seconds and the card; wave_hist_sharded
              at the pod's shape bit-equal and timed.

Between phases the grower cache (ops/grow.py) is emptied, so each phase
holds only its own growers' card memory.  After every phase the script
fails if a server answered a request from the host walk, except the soak
phase's two injected-fault runs.

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
    # on both streams: a caller that keeps only the end of one still sees
    # which check failed
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def clear_growers(dev) -> None:
    """Empty the grower cache (ops/grow.py) and return its card memory."""
    import torch
    from lightgbm_tpu_torch import compile_cache
    compile_cache.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


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
                dup=False, striped=False):
    """Inputs at a training-path shape: w pending leaves out of 2w+1 live
    ones (the root wave: every row in leaf 0), bf16 [g, h, 1] stats
    (K=4: two count columns; K=5: g and h twice; K=6: both) or int8
    quantized ones; ``dup`` draws the pending ids with repeats;
    ``striped`` (int8 K=6) zeroes each column pair's stripe outside its
    half of the rows, as the grower's striped layout does."""
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
        if striped:
            first = (torch.arange(n, device=dev) < n // 2).to(torch.int8)
            ghk[:, 0::2] *= first[:, None]
            ghk[:, 1::2] *= (1 - first)[:, None]
    elif k > 3:
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25
        one = torch.ones(n, device=dev)
        cols = [grad, grad * 2 ** -9] if k in (5, 6) else [grad]
        cols += [hess, hess * 2 ** -9] if k in (5, 6) else [hess]
        cols += [one, one] if k in (4, 6) else [one]
        ghk = torch.stack(cols, 1).to(torch.bfloat16)
    else:
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25
        cols = [grad, hess, torch.ones(n, device=dev)][:k]
        cols += [torch.ones(n, device=dev)] * (k - len(cols))
        ghk = torch.stack(cols, 1).to(torch.bfloat16)
    return bins, leaf, ghk, pending


#: above this many (group, row, stat) terms the library yardstick is one
#: index_add_ of (G*m, K) rows into a (G*NB*W, K) table: index_put_'s
#: accumulate path sorts its indices and would not fit the card's memory
#: at the 20M-row cases
LIBRARY_SORT_TERMS = 1 << 30


def library_hist(bins, leaf, ghk, pending, *, g, nb, k, w):
    """Yardstick only (never called by the port): the same histogram as
    one PyTorch call, index_put_ with accumulate on the flattened
    (group, bin, stat, slot) index of every (row, slot) pair whose leaf
    the slot holds (past LIBRARY_SORT_TERMS, index_add_ of each pair's K
    stats into its (group, bin, slot) row).  Returns (thunk, out in the
    (G*NB, K, W) layout, rows in the wave, the call's name)."""
    import torch
    dev = bins.device
    rows, s = torch.nonzero((leaf[:, None] == pending[None, :])
                            & (pending[None, :] >= 0), as_tuple=True)
    acc = torch.float32 if ghk.dtype == torch.bfloat16 else torch.int32
    if g * rows.numel() * k > LIBRARY_SORT_TERMS:
        idx = bins[:, rows].long()                             # (G, m)
        idx += (torch.arange(g, device=dev) * nb)[:, None]
        idx *= w
        idx += s[None, :]
        idx = idx.reshape(-1)
        m = int(torch.unique(rows).numel())
        src = ghk[rows].to(acc)[None].expand(g, -1, -1).reshape(-1, k)
        del rows, s
        table = torch.zeros((g * nb * w, k), dtype=acc, device=dev)

        def run_add():
            table.zero_()
            table.index_add_(0, idx, src)
        return run_add, table.view(g * nb, w, k).permute(0, 2, 1), m, \
            "index_add_"
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
    return run, out.view(g * nb, k, w), int(torch.unique(rows).numel()), \
        "index_put_"


def measure_case(name, kernel, dev, c, *, tensor_core=False):
    """Hold ``kernel`` (a wave-histogram wrapper) against the plain version
    at case ``c`` and time kernel, plain version and library call;
    wave_hist's bf16 result must also equal the fixed-point reference bit
    for bit."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda
    g = c.get("g", N_FEATURES)
    nb, k, w, quant = c["nb"], c["k"], c["w"], c["quant"]
    bins, leaf, ghk, pending = kernel_case(
        dev, **{key: v for key, v in c.items() if key != "mode"})
    torch.cuda.synchronize()
    n = bins.shape[1]
    kw = dict(g=g, nb=nb, k=k, w=w)
    if c.get("striped"):
        kw_k = dict(kw, col_rows=n - n // 2)
    else:
        kw_k = kw
    run = lambda: kernel(bins, leaf, ghk, pending, **kw_k)
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
    lib_run, lib_out, m, lib_call = library_hist(bins, leaf, ghk, pending,
                                                 **kw)
    library_ms = time_ms(lib_run, reps=3, warmup=1)
    lib_err = float((lib_out.double() - ref.double()).abs().max())
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
                               n)) if g == N_FEATURES and not c.get(
                                   "striped") and k in (3, 6) else None
    r = dict(kernel=name, case=c, rows=n, rows_in_wave=m, repro=repro,
             ok=ok, tolerance=tol, max_abs_err=err, exact=exact, ms=ms,
             before_ms_quoted=before_ms, plain_ms=plain_ms,
             library_ms=library_ms, library_max_abs_err=lib_err,
             library_call=lib_call, mode=c.get("mode"),
             bytes_bound_ms=bound_bytes_ms, ops_bound_ms=ops_ms,
             bound_ms=max(bound_bytes_ms, ops_ms),
             bound_by="bytes" if bound_bytes_ms >= ops_ms else "operations",
             tc_ms=tc_ms)
    tc = f", one-hot product at the tensor-core peak {tc_ms:.3f} ms" \
        if tensor_core else ""
    before = ("not run before the redesign" if before_ms is None else
              f"before the redesign, quoted from PERF.md: {before_ms:.3f} "
              f"ms")
    print(f"  kernel {name} {c.get('mode') or ''} "
          f"{'int8' if quant else 'bf16'} n={n} G={g} "
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
               n=EXPEDIA_ROWS),
          # the layouts past COUNT_SPLIT_ROWS at the fork's window (20M x
          # 53): striped counts (K=4) and striped int8 (K=6), at their
          # full widths at 255 leaves (W=96, W=64) and at the width the
          # window's 31 leaves give them (W=30), gpu_use_dp's K=6 there too
          dict(nb=256, k=4, w=96, quant=False, g=WIN_COLS, n=WIN_ROWS,
               mode="k4_bf16_20m_w96"),
          dict(nb=256, k=6, w=64, quant=True, g=WIN_COLS, n=WIN_ROWS,
               striped=True, mode="k6_int8_20m_w64"),
          dict(nb=256, k=4, w=30, quant=False, g=WIN_COLS, n=WIN_ROWS,
               mode="k4_bf16_20m"),
          dict(nb=256, k=6, w=30, quant=True, g=WIN_COLS, n=WIN_ROWS,
               striped=True, mode="k6_int8_20m"),
          dict(nb=256, k=6, w=30, quant=False, g=WIN_COLS, n=WIN_ROWS,
               mode="k6_bf16_20m"),
          # gpu_use_dp's hi/lo columns at 2M x 28: K=5 (W=76) and, with
          # striped counts, K=6 (W=64)
          dict(nb=256, k=5, w=76, quant=False, mode="k5_bf16"),
          dict(nb=256, k=6, w=64, quant=False, mode="k6_bf16_w64")]
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
    results = {"wave_hist": [], "wave_hist_v2": [], "wave_hist_rows": []}
    for i, c in enumerate(v1):
        results["wave_hist"].append(measure_case(
            "wave_hist", lambda *a, live=2 * c["w"] + 1, **kw:
            hist_cuda.wave_hist(*a, leaf_bound=live, **kw), dev,
            dict(c, seed=i)))
    for i, c in enumerate(v2):
        results["wave_hist_v2"].append(measure_case(
            "wave_hist_v2", hist_cuda.wave_hist_v2, dev,
            dict(c, seed=100 + i), tensor_core=True))
    # the host learner's one-slot list mode, f32 stats: a ragged leaf
    # window of a permuted row buffer at 2M x 28; the 34.6M-row route's
    # root window, whose list is the rows in order, and the same rows
    # listed in a random order (a deep window's worst case)
    for i, (name, n, m, permuted) in enumerate((
            ("f32_2m", N_ROWS, 1_234_567, True),
            ("f32_34.6m", HOST_ROUTE_ROWS, HOST_ROUTE_ROWS, False),
            ("f32_34.6m_permuted", HOST_ROUTE_ROWS, HOST_ROUTE_ROWS,
             True))):
        results["wave_hist_rows"].append(dict(
            measure_rows_case(dev, n, m, 200 + i, permuted=permuted),
            name=name))
    print(f"phase kernel: ok {len(v1)} + {len(v2)} + "
          f"{len(results['wave_hist_rows'])} shapes", flush=True)
    return results


def measure_rows_case(dev, n, m, seed, g=N_FEATURES, nb=256, permuted=True):
    """The one-slot list mode (wave_hist_rows) over ``m`` rows listed at a
    ragged offset of a permuted ``n``-row buffer (``permuted`` False: the
    rows in order, as a root window lists them), f32 [g, h, 1] stats:
    bit-equal to wave_hist_rows_fixed_reference, within 1e-4 of the |stat|
    histogram of the f32 plain version, bit-identical across two runs;
    kernel, plain version and one index_add_ timed."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda
    k = 3
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, nb, (g, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    grad = torch.randn(n, generator=gen, device=dev) * 0.5
    hess = torch.rand(n, generator=gen, device=dev) * 0.25
    ghk = torch.stack([grad, hess, torch.ones(n, device=dev)], 1)
    del grad, hess
    off = (n - m) // 3
    buf = torch.randperm(n, generator=gen, device=dev) if permuted \
        else torch.arange(n, device=dev)
    rows = buf.to(torch.int32)[off:off + m]
    scale = hist_cuda.exponents_for_rows(ghk.abs().amax(0), m)
    kw = dict(g=g, nb=nb, k=k)
    run = lambda: hist_cuda.wave_hist_rows(bins, ghk, rows, scale_exp=scale,
                                           **kw)
    a, b = run(), run()
    torch.cuda.synchronize()
    repro = bool(torch.equal(a, b))
    exact = bool(torch.equal(a.view(torch.int32),
                             hist_cuda.wave_hist_rows_fixed_reference(
                                 bins, ghk, rows, scale, **kw)
                             .view(torch.int32)))
    ref = hist_cuda.wave_hist_rows_reference(bins, ghk, rows, **kw)
    mag = hist_cuda.wave_hist_rows_reference(bins, ghk.abs(), rows, **kw)
    err = float((a.double() - ref.double()).abs().max())
    ok = repro and exact and bool(((a - ref).abs() <= 1e-4 * mag
                                   + 1e-6).all())
    ms = time_ms(run, reps=20)
    plain_ms = time_ms(lambda: hist_cuda.wave_hist_rows_reference(
        bins, ghk, rows, **kw), reps=2, warmup=1)
    r64 = rows.long()
    idx = bins[:, r64].long()
    idx += (torch.arange(g, device=dev) * nb)[:, None]
    idx = idx.reshape(-1)
    src = ghk[r64][None].expand(g, -1, -1).reshape(-1, k)
    table = torch.zeros((g * nb, k), device=dev)

    def lib():
        table.zero_()
        table.index_add_(0, idx, src)
    library_ms = time_ms(lib, reps=3, warmup=1)
    lib_err = float((table.double() - ref.double()).abs().max())
    del idx, src, table, r64
    # bytes: the list, each listed row's bins and stats, the histogram
    # out; operations: one add a listed row, group and stat
    bytes_ = m * (4 + g + k * 4) + g * nb * k * 4
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = m * g * k / F32_OPS_PER_S * 1e3
    r = dict(kernel="wave_hist_rows", mode="f32_rows", rows=n,
             rows_in_wave=m, case=dict(n=n, m=m, g=g, nb=nb, k=k,
                                       permuted=permuted),
             repro=repro, ok=ok, exact=exact,
             tolerance="bit-equal to wave_hist_rows_fixed_reference; "
             "1e-4*|hist| + 1e-6 of the f32 plain version",
             max_abs_err=err, ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, library_max_abs_err=lib_err,
             library_call="index_add_", bytes_bound_ms=bound_bytes_ms,
             ops_bound_ms=ops_ms, bound_ms=max(bound_bytes_ms, ops_ms),
             bound_by="bytes" if bound_bytes_ms >= ops_ms else "operations",
             tc_ms=None)
    print(f"  kernel wave_hist_rows f32 n={n} m={m} "
          f"{'permuted' if permuted else 'in order'} G={g} NB={nb} K={k}: "
          f"ok={ok} repro={repro} exact={exact} max_abs_err={err:.3g} "
          f"kernel {ms:.3f} ms, bound {r['bound_ms'] * 1e3:.1f} us "
          f"({r['bound_by']}), plain {plain_ms:.2f} ms, library "
          f"{library_ms:.2f} ms", flush=True)
    del bins, ghk, buf, rows, a, b, ref, mag
    torch.cuda.empty_cache()
    if not ok:
        fail(f"wave_hist_rows disagrees with its plain version at n={n} "
             f"m={m}")
    return r


def card_stamps(dev) -> int:
    """The device clock's stamps made on the card ``dev`` so far (its
    device counter; the plain stamps on the CPU are counted apart)."""
    from lightgbm_tpu_torch.ops import clock
    return int(clock.stamp.launches.counter(dev))


#: how far the growth of an OPEN/CLOSE stamp pair's interval, from a short
#: kernel between them to a long one, may read from the growth of the
#: CUDA-event interval around the same launches (medians), microseconds
CLOCK_TOL_US = 1.0
#: the most the event interval may exceed the stamped one (the two stamp
#: launches' own edges, eager launches queued on a busy card),
#: microseconds
CLOCK_EDGE_US = 8.0


def phase_clock(dev):
    """The device clock's stamp kernel (csrc/obs_clock.cu,
    ``ops/clock.stamp``) on card tensors.  Each mode (SET of every field,
    OPEN_TREE, OPEN and CLOSE of the kernel-1 sum) is held against the
    plain stamp (the CPU path of ``ops/clock.stamp``) on the same table
    and control words, at slots inside and outside the table: the same
    cells change, other rows and out-of-range slots are left alone, and
    OPEN_TREE zeroes ``hist_ns``.  Stamps in order read in order.  An
    OPEN/CLOSE pair around a sleep kernel queued on a busy card: its
    interval grows from a short kernel to a long one as the CUDA-event
    interval around the same launches does, within CLOCK_TOL_US, and
    reads at most CLOCK_EDGE_US below it (the stamps' own launch edges).
    An empty pair inside a CUDA graph (what the stamps add to a wave's
    ``hist_ns``), and the stamp's time in a CUDA graph (1000 stamps a
    replay) beside the plain stamp's and its bytes' bound; the device
    counter must count every stamp, the graphs' replays too."""
    import torch
    from lightgbm_tpu_torch.ops import clock
    t_phase = time.perf_counter()
    counted0 = card_stamps(dev)
    stamps = 0
    cap = 4
    gen = torch.Generator().manual_seed(21)
    base = torch.randint(1, 1 << 40, (cap, len(clock.FIELDS)),
                         generator=gen, dtype=torch.int64)
    modes = [(f, clock.SET) for f in range(len(clock.FIELDS))] + [
        (clock.START, clock.OPEN_TREE), (clock.HIST, clock.OPEN),
        (clock.HIST, clock.CLOSE)]
    cases = 0
    for slot in (-1, 0, 2, cap - 1, cap, 1 << 20):
        for field, mode in modes:
            ctl = torch.tensor([3, 1, 2, slot], dtype=torch.int32)
            plain = base.clone()
            clock.stamp(plain, ctl, field, mode)
            card = base.to(dev)
            clock.stamp(card, ctl.to(dev), field, mode)
            stamps += 1
            got = card.cpu()
            if not torch.equal(got != base, plain != base):
                fail(f"obs_clock_stamp slot {slot} field {field} mode "
                     f"{mode}: cells changed on the card "
                     f"{(got != base).nonzero().tolist()}, by the plain "
                     f"stamp {(plain != base).nonzero().tolist()}")
            if mode == clock.OPEN_TREE and 0 <= slot < cap \
                    and int(got[slot, clock.HIST]) != 0:
                fail(f"obs_clock_stamp OPEN_TREE left hist_ns "
                     f"{int(got[slot, clock.HIST])} at slot {slot}")
            cases += 1
    table = torch.zeros((1, len(clock.FIELDS)), dtype=torch.int64,
                        device=dev)
    ctl = torch.zeros(4, dtype=torch.int32, device=dev)
    for f in (clock.START, clock.WAVES_START, clock.WAVES_END, clock.END):
        clock.stamp(table, ctl, f)
        stamps += 1
    row = table[0].tolist()
    if not 0 < row[0] <= row[1] <= row[2] <= row[3]:
        fail(f"obs_clock_stamp: stamps in order read {row[:4]}")
    # an OPEN/CLOSE pair around a kernel against CUDA events around the
    # same three launches, queued behind a sleep so no host gap lies
    # between them: the event interval exceeds the stamped one by the
    # stamps' launch edges, the same for a short and a long kernel
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    diffs_us, pairs = {}, {}
    for cycles in (200_000, 2_000_000):
        for _ in range(8):
            table.zero_()
            torch.cuda._sleep(20_000_000)
            e0.record()
            clock.stamp(table, ctl, clock.HIST, clock.OPEN)
            torch.cuda._sleep(cycles)
            clock.stamp(table, ctl, clock.HIST, clock.CLOSE)
            e1.record()
            torch.cuda.synchronize(dev)
            stamps += 2
            ev_us = e0.elapsed_time(e1) * 1e3
            st_us = int(table[0, clock.HIST]) * 1e-3
            pairs.setdefault(cycles, []).append((ev_us, st_us))
            diffs_us.setdefault(cycles, []).append(ev_us - st_us)

    def med(v):
        return sorted(v)[len(v) // 2]
    short, long_ = (med(diffs_us[c]) for c in sorted(diffs_us))
    grow_ev = med([e for e, _ in pairs[2_000_000]]) \
        - med([e for e, _ in pairs[200_000]])
    grow_st = med([t for _, t in pairs[2_000_000]]) \
        - med([t for _, t in pairs[200_000]])
    if not (abs(grow_ev - grow_st) <= CLOCK_TOL_US
            and 0.0 <= short <= CLOCK_EDGE_US
            and 0.0 <= long_ <= CLOCK_EDGE_US):
        fail(f"obs_clock_stamp: from a short kernel to a long one the "
             f"stamped interval grew {grow_st:.2f} us, the events' "
             f"{grow_ev:.2f} us; the events exceed the stamps by "
             f"{short:.2f} / {long_:.2f} us (medians; all {diffs_us})")
    # an empty OPEN/CLOSE pair inside a CUDA graph: what the stamps add to
    # hist_ns a wave
    table.zero_()
    pair = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        with torch.cuda.graph(pair, stream=side):
            clock.stamp(table, ctl, clock.HIST, clock.OPEN)
            clock.stamp(table, ctl, clock.HIST, clock.CLOSE)
    torch.cuda.current_stream(dev).wait_stream(side)
    table.zero_()
    n_pair = 20
    for _ in range(n_pair):
        pair.replay()
    torch.cuda.synchronize(dev)
    stamps += 2 * n_pair
    empty_us = int(table[0, clock.HIST]) * 1e-3 / n_pair
    del pair
    # the stamp's time inside a CUDA graph, as the grower's pieces run it
    n_graph = 1000
    g = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        with torch.cuda.graph(g, stream=side):
            for _ in range(n_graph):
                clock.stamp(table, ctl, clock.END)
    torch.cuda.current_stream(dev).wait_stream(side)
    reps = 10
    ms = time_ms(g.replay, reps=reps, warmup=2) / n_graph
    stamps += n_graph * (reps + 2)
    del g
    cpu_table = table.cpu()
    cpu_ctl = ctl.cpu()
    t0 = time.perf_counter()
    for _ in range(10_000):
        clock.stamp(cpu_table, cpu_ctl, clock.END)
    plain_ms = (time.perf_counter() - t0) / 10_000 * 1e3
    counted = card_stamps(dev) - counted0
    if counted != stamps:
        fail(f"obs_clock_stamp: the device counter counted {counted} "
             f"stamps, {stamps} were launched")
    # bytes: the slot word, a read-modify-write of up to two int64 fields
    # and of the counter
    bytes_ = 4 + 2 * 16 + 16
    bound_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    err_us = abs(grow_ev - grow_st)
    r = dict(kernel="obs_clock_stamp", ok=True, cases=cases,
             interval_diff_us={str(c): v for c, v in diffs_us.items()},
             edge_us=[short, long_], growth_us=[grow_st, grow_ev],
             empty_pair_in_graph_us=empty_us,
             tolerance=f"the same cells as the plain stamp; a stamped "
             f"interval grows with the kernel between its stamps as the "
             f"CUDA-event interval does, within {CLOCK_TOL_US} us, and "
             f"reads at most {CLOCK_EDGE_US} us below it",
             max_abs_err=err_us * 1e-3,
             max_abs_err_unit="ms: the stamped interval's growth against "
             "the CUDA events'", ms=ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by="bytes", library_ms=None,
             tc_ms=None, stamps_counted=counted,
             seconds=time.perf_counter() - t_phase)
    print(f"phase clock: ok {cases} mode cases against the plain stamp; "
          f"a stamped interval grew {grow_st:.2f} us with the kernel "
          f"between, the CUDA events' {grow_ev:.2f} us; events exceed the "
          f"stamps by {short:.2f} / {long_:.2f} us (eager launch edges); an "
          f"empty pair in a graph {empty_us:.3f} us; a stamp in a graph "
          f"{ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us; {counted} "
          f"stamps counted", flush=True)
    return r


#: csrc/split_rows.cu's cases at the benchmark's shapes: (name, padded
#: rows, real rows, groups, leaves, widest wave): higgs.train's 2^24-row
#: bucket over 10.5M rows at 255 leaves (K=4: W=96) and fork_window's
#: 20M exact rows of 53 groups at 31 leaves (W=30)
ROUTING_CASES = (("higgs", 1 << 24, 10_500_000, 28, 255, 96),
                 ("fork", 20_000_000, 20_000_000, 53, 31, 30))


def routing_tree(dev, name, n, real, g, leaves, width, seed):
    """One tree's waves of the row routing at one shape: the rows start in
    leaf 0 (pad rows -1) and each wave of the legacy stage plan's widths
    (K=4) splits min(width, leaves, budget) random leaves on random
    features of a one-feature-a-group table (default bin 0 or not, every
    missing type).  At each wave the kernel routes exactly as the plain
    version (bit-equal); it is timed with every right child equal to its
    parent (the same reads and writes, the state unchanged), the plain
    version likewise.  The bound: each row's leaf id read, a code byte a
    routed row and a leaf id written a moved row, at 3.35 TB/s."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import routing
    from lightgbm_tpu_torch.ops.stage_plan import legacy_stage_plan
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, 256, (g, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    db = rng.choice([0, 0, 3, 40], g)
    nb = np.full(g, 256)
    feat = torch.tensor(np.stack([np.arange(g), np.zeros(g, int),
                                  nb - (db == 0), db, nb, np.arange(g) % 3],
                                 1), dtype=torch.int32, device=dev)
    leaf = torch.where(torch.arange(n, device=dev) < real, 0, -1) \
        .to(torch.int32)
    stages = legacy_stage_plan(leaves, width, 4)
    nl, waves = 1, []
    for ws, cap in stages:
        limit = leaves if cap is None else cap
        while nl < limit:
            k = min(ws, nl, leaves - nl)
            lsel = np.zeros(ws, np.int64)
            lsel[:k] = rng.permutation(nl)[:k]
            sel = np.arange(ws) < k
            f = rng.integers(0, g, ws).astype(np.int64)
            thr = rng.integers(0, 255, ws).astype(np.int64)
            dl = rng.random(ws) < 0.5
            r_ids = np.where(sel, nl + np.arange(ws), 0).astype(np.int64)
            t = lambda a: torch.from_numpy(a).to(dev)
            args = [codes, feat, t(sel), t(lsel), t(r_ids), t(f), t(thr),
                    t(dl)]
            same = list(args)
            same[4] = t(lsel)
            want = routing.split_rows_reference(leaf, *args,
                                                num_leaves=leaves)
            routed = int(torch.isin(leaf, t(lsel[:k]).to(torch.int32))
                         .sum())
            moved = int((want != leaf).sum())
            ms = time_ms(lambda: routing.split_rows(
                leaf, *same, num_leaves=leaves), reps=20)
            plain_ms = time_ms(lambda: routing.split_rows_reference(
                leaf, *same, num_leaves=leaves), reps=3, warmup=1)
            routing.split_rows(leaf, *args, num_leaves=leaves)
            torch.cuda.synchronize(dev)
            if not torch.equal(leaf, want):
                fail(f"split_rows {name} wave {len(waves)}: "
                     f"{int((leaf != want).sum())} rows differ from the "
                     f"plain version")
            bound_ms = (4 * n + routed + 4 * moved) / HBM_BYTES_PER_S * 1e3
            waves.append(dict(width=ws, lanes=k, routed=routed, moved=moved,
                              ms=ms, plain_ms=plain_ms, bound_ms=bound_ms))
            nl += k
    del codes, leaf, want
    torch.cuda.empty_cache()
    return waves


def phase_routing(dev):
    """The wave's row routing (csrc/split_rows.cu, ``ops/routing.py``) at
    the benchmark cells' shapes, a tree's waves each (ROUTING_CASES):
    bit-equal to the plain version at every wave, timed beside its bound
    and the plain version's time; the kernel's launches counted on the
    device."""
    from lightgbm_tpu_torch.ops import routing
    t_phase = time.perf_counter()
    before = routing.split_rows.launches.read()
    cases = {}
    for i, (name, n, real, g, leaves, width) in enumerate(ROUTING_CASES):
        waves = routing_tree(dev, name, n, real, g, leaves, width, 300 + i)
        k = len(waves)
        c = dict(rows=n, real_rows=real, groups=g, leaves=leaves,
                 width=width, waves=waves,
                 ms=sum(w["ms"] for w in waves) / k,
                 plain_ms=sum(w["plain_ms"] for w in waves) / k,
                 bound_ms=sum(w["bound_ms"] for w in waves) / k,
                 bound_by="bytes", max_abs_err=0.0, library_ms=None,
                 tc_ms=None)
        cases[name] = c
        print(f"  kernel split_rows {name} n={n} ({real} real) G={g} "
              f"L={leaves} W={width}: {k} waves bit-equal to the plain "
              f"version; a wave {c['ms'] * 1e3:.1f} us (by wave "
              f"{[round(w['ms'] * 1e3, 1) for w in waves]}), bound "
              f"{c['bound_ms'] * 1e3:.1f} us (bytes), plain "
              f"{c['plain_ms']:.3f} ms", flush=True)
    launches = routing.split_rows.launches.read() - before
    # a wave: 22 launches timed (two of them warm-up), one routing
    want = 23 * sum(len(c["waves"]) for c in cases.values())
    if launches != want:
        fail(f"split_rows: the device counter counted {launches} "
             f"launches, {want} were made")
    print(f"phase routing: ok {len(cases)} shapes, {launches} launches "
          f"counted, {time.perf_counter() - t_phase:.1f} s", flush=True)
    return cases


def routing_launches_ok(name, before, waves) -> int:
    """split_rows launches since ``before`` (its device counter) == the
    waves the run's growers ran (one launch a wave, warm-up included)."""
    from lightgbm_tpu_torch.ops import routing
    got = routing.split_rows.launches.read() - before
    if got != waves:
        fail(f"{name}: split_rows launches {got} (device counter) != "
             f"waves {waves}")
    return got


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
#: rows of the higgs run's prediction also walked on the host (cut from
#: the 2M to keep the script under 900 s)
HOST_PREDICT_ROWS = 500_000


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
    from lightgbm_tpu_torch.ops import clock, hist_cuda, routing
    params = {**TRAIN_BASE, **TRAIN_RUNS[name], "device": dev.type}
    torch.cuda.reset_peak_memory_stats(dev)
    hist_cuda.wave_hist.launches.reset()          # count this run only
    torch.cuda.synchronize(dev)
    stamps0 = card_stamps(dev)
    routing0 = routing.split_rows.launches.read()
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
    routing_launches_ok(f"{name} {path}", routing0, launches)
    # the device clock: four stamps a tree and two a wave (kernel 1's
    # call), the warm-up's tree before the captures too
    stamps = card_stamps(dev) - stamps0
    warmups = cap["warmup_waves"] // len(grower._stages)
    want_stamps = 4 * (len(gb.models) + warmups) + 2 * launches
    if stamps != want_stamps:
        fail(f"{name} {path}: {stamps} device-clock stamps (device "
             f"counter) != 4 x ({len(gb.models)} trees + {warmups} "
             f"warm-ups) + 2 x {launches} waves")
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
               clock_stamps=stamps,
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
    clear_growers(dev)      # a new grower: nothing captured in it yet
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
        # the host walk, the only route before the kernel, in the same
        # run, on the first HOST_PREDICT_ROWS rows (the script's time)
        gb.config.device_predict = "off"
        t0 = time.perf_counter()
        host_raw = booster.predict(x[:HOST_PREDICT_ROWS], raw_score=True)
        host_predict_s = time.perf_counter() - t0
        gb.config.device_predict = "auto"
        host_err = float(np.abs(host_raw - score[:HOST_PREDICT_ROWS]).max())
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


#: the fork's retrain window at its own size (PAPERS.md: a 20M-row window
#: every retrain): the harness's 53 columns, a 2M-row held-out tail
WIN_ROWS = 20_000_000
WIN_TAIL = 2_000_000
WIN_COLS = 53
WIN_ROUNDS = 50
WIN_CHUNK = 25
#: held-out AUC floor of the 20M-row window's model, fixed in PERF.md
#: before the first card run
WIN_AUC_FLOOR = 0.70
#: the row count at which the JAX package leaves its device grower
#: (2 * COUNT_SPLIT_ROWS) and a bit more: the host learner's route
HOST_ROUTE_ROWS = (1 << 25) + (1 << 20)
HOST_ROUNDS = 5
HOST_ROUTE_ROUNDS = 3
#: training AUC floor of path B's binary runs (63 leaves, 5 rounds),
#: fixed in PERF.md before the first card run
HOST_AUC_FLOOR = 0.75
HOST_WALK_ROWS = 100_000


def window_shape(n: int, seed: int, chunk: int = 1 << 20):
    """A window of the fork's cache-admission rows with the harness's 53
    dense columns (src/test.cpp:125-209): 50 inter-arrival gaps (0 past
    the object's history), round(100 log2 size), round(100 log2 cache
    bytes available) and the cost.  Each row's object has a lognormal
    mean inter-arrival gap; its history length falls with that gap; the
    label is the OPT-like admission of a next request whose reuse volume
    (next gap x size) is small.  Made from ``seed`` in chunks of rows
    (float32, (n, 53)); labels (n,) float32."""
    import numpy as np
    x = np.zeros((n, WIN_COLS), np.float32)
    y = np.zeros(n, np.float32)
    for c0 in range(0, n, chunk):
        rng = np.random.default_rng([seed, c0 // chunk])
        m = min(chunk, n - c0)
        log_mu = rng.normal(7.0, 2.0, m)
        mu = np.exp(log_mu)
        hist_len = np.clip((50 * (1.0 - log_mu / 14.0)
                            + rng.normal(0, 6, m)).astype(np.int64), 0, 50)
        gaps = np.maximum(np.round(rng.exponential(1.0, (m, 50))
                                   * mu[:, None]), 1.0)
        gaps[np.arange(50)[None, :] >= hist_len[:, None]] = 0.0
        size = np.clip(rng.lognormal(9.0, 1.5, m), 64, 1 << 26)
        avail = rng.uniform(0.0, float(1 << 30), m)
        x[c0:c0 + m, :50] = gaps
        x[c0:c0 + m, 50] = np.round(100.0 * np.log2(size))
        x[c0:c0 + m, 51] = np.where(avail <= 0, 0.0,
                                    np.round(100.0 * np.log2(
                                        np.maximum(avail, 1.0))))
        x[c0:c0 + m, 52] = 1.0
        volume = rng.exponential(1.0, m) * mu * size
        y[c0:c0 + m] = volume < 1.5e8
    return x, y


def window_run(name, ds, dev, params, path, rounds):
    """``engine.train`` of one configuration on the window on one path
    ("fused": chunks of ``fused_chunk``; "per_iteration": a callback
    without the eval-cadence mark): the booster and what the run
    counted.  wave_hist's launches (device counter) must equal the trees'
    waves plus the warm-up's."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda, routing
    torch.cuda.reset_peak_memory_stats(dev)
    hist_cuda.wave_hist.launches.reset()          # this run only
    torch.cuda.synchronize(dev)
    routing0 = routing.split_rows.launches.read()
    params = {k: v for k, v in params.items() if k != "num_iterations"}
    t0 = time.perf_counter()
    booster = lt.train({**params, "device": dev.type}, ds,
                       num_boost_round=rounds,
                       callbacks=None if path == "fused"
                       else [_per_iteration], verbose_eval=False)
    text = booster.model_to_string()
    torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    gb = booster._gbdt
    grower = gb._grower
    launches = hist_cuda.wave_hist.launches.read()
    stats = gb.tree_stats
    waves = sum(st[2] for st in stats)
    cap = dict(grower.capture_stats)
    if launches <= 0 or launches != waves + cap["warmup_waves"]:
        fail(f"window {name} {path}: wave_hist launches {launches} != "
             f"tree waves {waves} + warm-up {cap['warmup_waves']}")
    routing_launches_ok(f"window {name} {path}", routing0, launches)
    chunk = int(params["fused_chunk"])
    want = [chunk] * (rounds // chunk) if path == "fused" \
        else [1] * rounds
    if [st[1] for st in stats] != want:
        fail(f"window {name} {path}: dispatches {[st[1] for st in stats]},"
             f" expected {want}")
    res = dict(path=path, train_s=train_s, s_per_tree=train_s / rounds,
               dispatch_s=[st[0] for st in stats],
               host_syncs=[st[3] for st in stats], launches=launches,
               waves=waves, waves_per_tree=waves / rounds, capture=cap,
               hist_cols=grower.hist_cols, wave_width=grower.wave_width,
               int_scan=grower.int_scan, striped=grower.striped,
               n_pad=grower.n_pad,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               model_text_sha256=hashlib.sha256(text.encode()).hexdigest())
    return booster, res


def check_leaf_counts(name, booster):
    """Every tree's leaf counts sum to the rows in its bag exactly (counts
    past 2^24 rows: the striped columns and the int8 f32 fallback)."""
    gb = booster._gbdt
    gb._flush_pending()
    freq = gb.bag_freq if gb.need_bagging else 0
    bags = {}
    for it, tree in enumerate(gb.models):
        if tree.num_leaves <= 1:
            continue
        r = it - it % freq if freq else -1
        if r not in bags:
            bags[r] = int(gb._grower.bag_mask_at(r).sum()) if freq \
                else gb.num_data
        total = int(tree.leaf_count[:tree.num_leaves].sum())
        if total != bags[r]:
            fail(f"window {name}: tree {it}'s leaf counts sum to {total}, "
                 f"its bag holds {bags[r]} rows")
    return len(bags)


def phase_window20m(dev, seed: int, dense):
    """Path A: the fork's 20M-row window (see the module docstring)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset, Metadata
    t0 = time.perf_counter()
    x_all, y_all = window_shape(WIN_ROWS + WIN_TAIL, seed + 11)
    gen_s = time.perf_counter() - t0
    x, y = x_all[:WIN_ROWS], y_all[:WIN_ROWS]
    xt, yt = x_all[WIN_ROWS:], y_all[WIN_ROWS:]
    base = {**PIPE_BASE, "num_iterations": WIN_ROUNDS,
            "fused_chunk": WIN_CHUNK}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    x_dev = torch.from_numpy(x).to(dev)
    torch.cuda.synchronize(dev)
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    handle = BinnedDataset.construct_from_device_matrix(
        x_dev, Config({**base, "device": dev.type}))
    torch.cuda.synchronize(dev)
    bin_s = time.perf_counter() - t0
    bin_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del x_dev
    torch.cuda.empty_cache()
    handle.metadata = Metadata(handle.num_data)
    handle.metadata.set_label(y)
    ds = dataset_of(handle)
    print(f"  window20m: {WIN_ROWS} x {WIN_COLS} made in {gen_s:.1f} s, "
          f"uploaded in {upload_s:.2f} s, binned on the card in "
          f"{bin_s:.2f} s (peak {bin_peak:.2f} GB), "
          f"{handle.num_groups} groups", flush=True)
    runs = {}
    boosters = {}
    for name, extra, path in (("bf16", {}, "fused"),
                              ("bf16", {}, "per_iteration"),
                              ("int8", {"grad_quant_bits": 8}, "fused"),
                              ("dp", {"gpu_use_dp": True}, "fused")):
        booster, res = window_run(name, ds, dev, {**base, **extra}, path,
                                  WIN_ROUNDS)
        res["bags_checked"] = check_leaf_counts(name, booster)
        key = f"{name}_{path}"
        runs[key] = res
        print(f"  window20m {key}: s/tree {res['s_per_tree']:.4f} "
              f"(dispatches {[round(v, 3) for v in res['dispatch_s']][:4]}"
              f"...), waves/tree {res['waves_per_tree']:.2f}, hist_cols "
              f"{res['hist_cols']}, W {res['wave_width']}, int_scan "
              f"{res['int_scan']}, n_pad {res['n_pad']}, peak "
              f"{res['peak_mem_gb']:.2f} GB, captures "
              f"{res['capture']['graphs']} ({res['capture']['capture_s']:.2f}"
              f" s), leaf counts exact over {res['bags_checked']} bags, "
              f"sha256 {res['model_text_sha256'][:16]}", flush=True)
        if path == "per_iteration":
            del booster
        else:
            boosters[name] = booster
    if runs["bf16_fused"]["model_text_sha256"] \
            != runs["bf16_per_iteration"]["model_text_sha256"]:
        fail("window20m: fused and per-iteration model texts differ")
    want = {"bf16_fused": (4, False), "int8_fused": (6, False),
            "dp_fused": (6, False)}
    for key, (k, int_scan) in want.items():
        if runs[key]["hist_cols"] != k or runs[key]["int_scan"] != int_scan:
            fail(f"window20m {key}: hist_cols {runs[key]['hist_cols']} "
                 f"int_scan {runs[key]['int_scan']}, expected {k} "
                 f"{int_scan}")
    if runs["bf16_fused"]["n_pad"] != WIN_ROWS:
        fail(f"window20m: row pad {runs['bf16_fused']['n_pad']}, the exact "
             f"rows {WIN_ROWS} expected")
    launches = sum(r["launches"] for r in runs.values())
    launches_by_mode = {"k4_bf16_20m": runs["bf16_fused"]["launches"]
                        + runs["bf16_per_iteration"]["launches"],
                        "k6_int8_20m": runs["int8_fused"]["launches"],
                        "k6_bf16_20m": runs["dp_fused"]["launches"]}
    predict_launches = 0
    routes = None
    for name, booster in boosters.items():
        before = forest_counts()
        t0 = time.perf_counter()
        pred = booster.predict(xt, raw_score=True)
        runs[f"{name}_fused"]["predict_tail_s"] = time.perf_counter() - t0
        n_l, r_l = counts_since(before)
        predict_launches += n_l
        routes = r_l if routes is None else {
            k: routes[k] + r_l[k] for k in routes}
        if not np.isfinite(pred).all() or pred.shape != (WIN_TAIL,):
            fail(f"window20m {name}: held-out predictions not finite "
                 f"({pred.shape})")
        auc = auc_of(yt, pred)
        runs[f"{name}_fused"]["heldout_auc"] = auc
        print(f"  window20m {name}: held-out AUC on the {WIN_TAIL}-row "
              f"tail {auc:.4f} (floor {WIN_AUC_FLOOR})", flush=True)
        if auc < WIN_AUC_FLOOR:
            fail(f"window20m {name}: held-out AUC {auc:.4f} below "
                 f"{WIN_AUC_FLOOR}")
    del boosters, ds, handle
    torch.cuda.empty_cache()
    # gpu_use_dp's K=5 (W=76) at the train phase's 2M x 28 binning
    booster, res = window_run("dp_2m", dataset_of(dense), dev,
                              {**TRAIN_BASE, "num_leaves": 255,
                               "gpu_use_dp": True, "fused_chunk": ROUNDS},
                              "fused", ROUNDS)
    if (res["hist_cols"], res["wave_width"]) != (5, 76):
        fail(f"window20m dp_2m: hist_cols {res['hist_cols']} W "
             f"{res['wave_width']}, expected 5 and 76")
    runs["dp_2m_fused"] = res
    launches += res["launches"]
    launches_by_mode["k5_bf16"] = res["launches"]
    print(f"  window20m dp_2m (gpu_use_dp at 2M x 28): s/tree "
          f"{res['s_per_tree']:.4f}, hist_cols 5, W 76", flush=True)
    del booster
    print(f"phase window20m: ok {WIN_ROWS} rows, bf16 fused == "
          f"per-iteration (sha256), int8 K=6 on the f32 fallback scan, "
          f"gpu_use_dp K=6 and K=5, every tree's leaf counts exact",
          flush=True)
    return dict(rows=WIN_ROWS, cols=WIN_COLS, tail=WIN_TAIL,
                data_s=gen_s, upload_s=upload_s, binning_s=bin_s,
                binning_peak_gb=bin_peak, runs=runs, launches=launches,
                launches_by_mode=launches_by_mode,
                predict_launches=predict_launches, predict_routes=routes)


HOST_RUNS = {
    "monotone": {"objective": "binary"},
    "forced": {"objective": "binary"},
    "l1": {"objective": "regression_l1", "metric": "l1"},
    "quantile": {"objective": "quantile", "alpha": 0.9,
                 "metric": "quantile"},
    "mape": {"objective": "mape", "metric": "mape"},
    "fobj": {},
}
#: path B's monotone constraints: the pT and m_jj columns that raise the
#: labels' signal up, the m_jjj column that lowers it
HOST_MONOTONE = {0: 1, 25: 1, 27: -1}
HOST_BASE = {"max_bin": 255, "learning_rate": 0.1, "num_leaves": 63,
             "min_data_in_leaf": 20}
HOST_FORCED = {"feature": 25, "threshold": 1.0,
               "left": {"feature": 0, "threshold": 1.0},
               "right": {"feature": 27, "threshold": 1.0}}


def host_run(name, ds, dev, params, rounds, fobj=None, valid=None):
    """engine.train on the host learner: the booster and its counts (the
    window kernel's launches, counted on the device, must be > 0 and
    wave_hist must not launch)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda
    hist_cuda.wave_hist.launches.reset()
    hist_cuda.wave_hist_rows.launches.reset()
    torch.cuda.synchronize(dev)
    evals = {}
    t0 = time.perf_counter()
    booster = lt.train({**params, "device": dev.type}, ds,
                       num_boost_round=rounds, fobj=fobj,
                       valid_sets=valid, evals_result=evals,
                       verbose_eval=False)
    torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    gb = booster._gbdt
    launches = hist_cuda.wave_hist_rows.launches.read()
    if gb.learner is None or gb._grower is not None:
        fail(f"host_learner {name}: did not train on the host learner")
    if launches <= 0 or hist_cuda.wave_hist.launches.read() != 0:
        fail(f"host_learner {name}: wave_hist_rows launches {launches}, "
             f"wave_hist {hist_cuda.wave_hist.launches.read()}")
    if booster.num_trees() != rounds * gb.num_model:
        fail(f"host_learner {name}: {booster.num_trees()} trees")
    return booster, dict(train_s=train_s, s_per_tree=train_s / rounds,
                         launches=launches, evals=evals,
                         leaves=[t.num_leaves for t in gb.models])


def host_checked(name, booster, x, dev):
    """Booster.predict through forest_predict (bit-equal to its plain
    version, within 1e-5 of the training scores) and within 1e-9 of the
    host walk on HOST_WALK_ROWS rows."""
    import numpy as np
    gb = booster._gbdt
    score = gb.train_score[0].double().cpu().numpy()
    res = predict_checked(f"host_learner {name}", booster, x, score, dev,
                          keep_raw=True)
    raw = res.pop("raw")
    sub = np.ascontiguousarray(x[:HOST_WALK_ROWS], np.float64)
    walk = gb._predict_raw_host(sub, 0, gb.num_iterations(), None)[0]
    err = float(np.abs(walk - raw[:HOST_WALK_ROWS]).max())
    if err > 1e-5:
        fail(f"host_learner {name}: predict vs the host walk {err:.3g}")
    res["host_walk_max_abs"] = err
    return res, raw


def phase_host_learner(dev, seed: int, dense, x, y, tmp):
    """Path B: the host learner on the card (see the module docstring)."""
    import logging
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset, Metadata
    forced_path = os.path.join(tmp, "forced_splits.json")
    with open(forced_path, "w") as fh:
        json.dump(HOST_FORCED, fh)
    y_reg = regression_target(x, seed)
    runs, launches = {}, 0
    predict_launches, routes = 0, None
    for name, extra in HOST_RUNS.items():
        params = {**HOST_BASE, **extra}
        label = y_reg if name in ("l1", "quantile", "mape") else y
        fobj = None
        if name == "forced":
            params["forcedsplits_filename"] = forced_path
        if name == "fobj":
            def fobj(preds, _ds, y=y):
                p = 1.0 / (1.0 + np.exp(-preds))
                return (p - y).astype(np.float32), \
                    (p * (1.0 - p)).astype(np.float32)
        # the train phase's binning, with this run's labels and (the
        # dataset carries them) monotone constraints
        handle = BinnedDataset.__new__(BinnedDataset)
        handle.__dict__.update(dense.__dict__)
        handle.metadata = Metadata(dense.num_data)
        handle.metadata.set_label(label)
        if name == "monotone":
            handle.monotone_constraints = np.asarray(
                [HOST_MONOTONE.get(f, 0) for f in dense.used_features],
                np.int32)
        ds = dataset_of(handle)
        valid = [ds] if name in ("l1", "quantile", "mape") else None
        booster, res = host_run(name, ds, dev, params, HOST_ROUNDS, fobj,
                                valid)
        launches += res["launches"]
        pres, raw = host_checked(name, booster, x, dev)
        res.update(pres)
        predict_launches += res["predict_launches"]
        r_l = res["predict_routes"]
        routes = r_l if routes is None else {k: routes[k] + r_l[k]
                                             for k in routes}
        gb = booster._gbdt
        if name in ("monotone", "forced", "fobj"):
            res["train_auc"] = auc_of(y, raw)
            if res["train_auc"] < HOST_AUC_FLOOR:
                fail(f"host_learner {name}: training AUC "
                     f"{res['train_auc']:.4f} below {HOST_AUC_FLOOR}")
        if name == "monotone":
            rng = np.random.default_rng(seed + 5)
            probe = x[rng.choice(len(x), 1000, replace=False)].astype(
                np.float64)
            worst = 0.0
            for f, sign in HOST_MONOTONE.items():
                grid = np.quantile(x[:, f], np.linspace(0.001, 0.999, 64))
                rows = np.repeat(probe, len(grid), axis=0)
                rows[:, f] = np.tile(grid, len(probe))
                pr = gb._predict_raw_host(rows, 0, gb.num_iterations(),
                                          None)[0].reshape(len(probe), -1)
                step = sign * np.diff(pr, axis=1)
                worst = min(worst, float(step.min()))
            res["monotone_worst_step"] = worst
            if worst < -1e-9:
                fail(f"host_learner monotone: predictions move against a "
                     f"constraint by {worst:.3g}")
        if name == "forced":
            for i, tree in enumerate(gb.models):
                left, right = int(tree.left_child[0]), int(tree.right_child[0])
                if (int(tree.split_feature[0]) != 25 or left < 0
                        or right < 0
                        or int(tree.split_feature[left]) != 0
                        or int(tree.split_feature[right]) != 27
                        or abs(float(tree.threshold[0]) - 1.0) > 0.05):
                    fail(f"host_learner forced: tree {i} does not start "
                         f"with the forced splits")
        if name in ("l1", "quantile", "mape"):
            curve = next(iter(res["evals"]["valid_0"].values()))
            res["metric_curve"] = curve
            if not curve[-1] < curve[0]:
                fail(f"host_learner {name}: training metric {curve} did "
                     f"not fall")
            if name == "quantile":
                res["coverage"] = float((y_reg <= raw).mean())
        print(f"  host_learner {name}: s/tree {res['s_per_tree']:.3f}, "
              f"leaves {res['leaves']}, window-kernel launches "
              f"{res['launches']}, predict vs host walk "
              f"{res['host_walk_max_abs']:.2g}"
              + (f", training AUC {res['train_auc']:.4f}"
                 if "train_auc" in res else "")
              + (f", metric {res['metric_curve'][0]:.4f} -> "
                 f"{res['metric_curve'][-1]:.4f}"
                 if "metric_curve" in res else "")
              + (f", coverage {res['coverage']:.3f}"
                 if "coverage" in res else ""), flush=True)
        runs[name] = res
        del booster
    # the route at 2^25 + 2^20 rows: the device grower's row bound passed,
    # the host learner trains, and says why.  The rows are the train
    # phase's, repeated on the card (a fresh sample of this size took ~50 s
    # of host time a run; what the route checks holds on any rows)
    t0 = time.perf_counter()
    reps = -(-HOST_ROUTE_ROWS // len(x))
    yr = np.tile(y, reps)[:HOST_ROUTE_ROWS]
    x_dev = torch.from_numpy(x).to(dev).repeat(reps, 1)[:HOST_ROUTE_ROWS]
    torch.cuda.synchronize(dev)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    handle = BinnedDataset.construct_from_device_matrix(
        x_dev, Config({**TRAIN_BASE, "device": dev.type}))
    torch.cuda.synchronize(dev)
    bin_s = time.perf_counter() - t0
    del x_dev
    torch.cuda.empty_cache()
    handle.metadata = Metadata(handle.num_data)
    handle.metadata.set_label(yr)

    class _Capture(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())
    cap = _Capture()
    logger = logging.getLogger("lightgbm_tpu_torch")
    old_level = logger.level
    logger.addHandler(cap)
    logger.setLevel(logging.INFO)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        booster, res = host_run("route", dataset_of(handle), dev,
                                {**TRAIN_BASE, "num_leaves": 31,
                                 "verbose": 1}, HOST_ROUTE_ROUNDS)
    finally:
        logger.removeHandler(cap)
        logger.setLevel(old_level)
    why = [m for m in cap.lines if m.startswith("Using the host tree")]
    if not why or "rows >= 2 * COUNT_SPLIT_ROWS" not in why[0]:
        fail(f"host_learner route: no route reason logged ({why})")
    route_launches = res["launches"]
    launches += route_launches
    gb = booster._gbdt
    for i, tree in enumerate(gb.models):
        total = int(tree.leaf_count[:tree.num_leaves].sum())
        if total != HOST_ROUTE_ROWS:
            fail(f"host_learner route: tree {i}'s leaf counts sum to "
                 f"{total}, not {HOST_ROUTE_ROWS}")
    score = gb.train_score[0]
    if not bool(torch.isfinite(score).all()):
        fail("host_learner route: non-finite training scores")
    res.update(rows=HOST_ROUTE_ROWS, data_s=gen_s, binning_s=bin_s,
               reason=why[0],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               train_auc_sample=auc_of(yr[:2_000_000],
                                       score[:2_000_000].double().cpu()
                                       .numpy()))
    runs["route"] = res
    print(f"  host_learner route: {HOST_ROUTE_ROWS} x {N_FEATURES} repeated "
          f"on the card in "
          f"{gen_s:.1f} s, binned on the card in {bin_s:.1f} s; "
          f"'{why[0]}'; s/tree {res['s_per_tree']:.3f}, leaves "
          f"{res['leaves']}, window-kernel launches {res['launches']}, "
          f"leaf counts sum to the rows, peak {res['peak_mem_gb']:.2f} GB",
          flush=True)
    del booster, handle, yr
    torch.cuda.empty_cache()
    print(f"phase host_learner: ok {len(runs)} runs on the host learner "
          f"(monotone, forced, L1, quantile, mape, fobj, "
          f"{HOST_ROUTE_ROWS} rows)", flush=True)
    return dict(runs=runs, launches=launches,
                launches_by_case={"f32_2m": launches - route_launches,
                                  "f32_34.6m": route_launches},
                predict_launches=predict_launches, predict_routes=routes)


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
    clear_growers(dev)      # a new grower: nothing captured in it yet
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
    from lightgbm_tpu_torch.ops import hist_cuda, routing
    k = EXPEDIA_CLASSES
    torch.cuda.reset_peak_memory_stats(dev)
    hist_cuda.wave_hist.launches.reset()          # this run only
    torch.cuda.synchronize(dev)
    routing0 = routing.split_rows.launches.read()
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
    routing_launches_ok("multiclass", routing0, launches)
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
    from lightgbm_tpu_torch.ops import hist_cuda, routing
    params = {**BOOST_BASE, **BOOST_RUNS[name], "device": dev.type}
    rounds = BOOST_ROUNDS[name]
    evals = {}
    hist_cuda.wave_hist.launches.reset()      # this run only
    torch.cuda.synchronize(dev)
    routing0 = routing.split_rows.launches.read()
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
    routing_launches_ok(f"boosting {name}", routing0, launches)
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


# ---------------------------------------------------------------------------
# phase pipeline: the fork's retrain-every-window loop (RetrainPipeline)
# ---------------------------------------------------------------------------

#: the fork harness's trace and windows (examples/cache_admission.py's
#: defaults, src/test.cpp's shape): a Zipf(0.8) stream over 200,000
#: objects, windows of 1,000,000 requests, each trained on its last
#: 500,000 (sampling=1) and, from window 1 on, scored first with the
#: previous model over all its rows
PIPE_OBJECTS = 200_000
PIPE_WINDOW = 1_000_000
PIPE_WINDOWS = 4
PIPE_SAMPLE = 500_000
PIPE_CACHE_SIZE = 1 << 30
PIPE_CUTOFF = 0.5
HISTFEATURES = 50               # inter-arrival gaps; + log2 size, avail, cost
PIPE_COLS = HISTFEATURES + 3
#: the fork's exact training configuration (cache_admission.py:55-62,
#: src/test.cpp:66-87), 50 iterations fused in chunks of 25
PIPE_BASE = {"boosting": "gbdt", "objective": "binary", "max_bin": 255,
             "num_iterations": 50, "learning_rate": 0.1, "num_leaves": 31,
             "feature_fraction": 0.8, "bagging_freq": 5,
             "bagging_fraction": 0.8, "min_data_in_leaf": 50,
             "min_sum_hessian_in_leaf": 5.0, "fused_chunk": 25,
             "verbosity": -1}
PIPE_CHUNK = 25
PIPE_WARM_ITERATIONS = 10
#: held-out AUC floor of a window's model on the next window's requests,
#: fixed in PERF.md from a CPU rehearsal before the first card run
PIPE_AUC_FLOOR = 0.70
#: rows of each warm window the card's leaf ids are walked on the host
PIPE_HOST_ROWS = 100_000
PIPE_FAULT = "pipeline.prep:at=2"


class _Prober:
    """A thread that asks the server for 1 to 1,000 rows at a time until
    stopped, recording each request's host interval and outcome.
    ``rows()`` gives the request rows once the server has a model."""

    def __init__(self, server, rows, seed: int):
        import threading
        import numpy as np
        self.server, self.rows = server, rows
        self.rng = np.random.default_rng(seed)
        self.log, self.errors = [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chip-smoke-prober")

    def _loop(self):
        import numpy as np
        while not self._stop.is_set():
            if self.server._model is None:
                time.sleep(0.005)
                continue
            n = int(self.rng.integers(1, 1001))
            t0 = time.perf_counter()
            try:
                out = np.asarray(self.server.predict(self.rows()[:n]))
                ok = out.shape == (n,) and bool(np.isfinite(out).all())
            except Exception as e:                   # noqa: BLE001
                self.errors.append(repr(e))
                ok = False
            self.log.append((t0, time.perf_counter(), n, ok))
            time.sleep(0.002)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)
        return False


def pipeline_waves(boosters):
    """Trees' waves plus warm-up waves over the fresh growers of a run."""
    return sum(sum(s[2] for s in g.tree_stats)
               + g._grower.capture_stats["warmup_waves"] for g in boosters)


def pipeline_window_rows(res):
    """One window's printed numbers."""
    g = res.booster
    stats = g.tree_stats
    trees = sum(s[1] for s in stats)
    return dict(window=res.window, policy=res.policy,
                prep_s=res.prep_s, stall_s=res.stall_s,
                train_s=res.train_s, eval_s=res.eval_s, swap_s=res.swap_s,
                drift=res.drift, rebinned=res.rebinned,
                captures=res.captures, capture_s=res.capture_s,
                trees_grown=trees,
                s_per_tree=(sum(s[0] for s in stats) / trees
                            if trees else None),
                host_syncs=sum(s[3] for s in stats),
                swap_same_shape=res.swap_same_shape,
                num_trees=res.num_trees, metrics=res.eval_metrics,
                meta=res.meta)


def pipeline_eval(pred, pw):
    """The model's quality on the next window's requests: AUC of the
    admission labels and the fork's fp/fn rates at the cutoff."""
    import numpy as np
    label = np.asarray(pw.eval_label, np.float64)
    pred = np.asarray(pred, np.float64)
    return {"auc": auc_of(label, pred),
            "fp": float(((label < PIPE_CUTOFF)
                         & (pred >= PIPE_CUTOFF)).mean()),
            "fn": float(((label >= PIPE_CUTOFF)
                         & (pred < PIPE_CUTOFF)).mean())}


def phase_pipeline(dev, seed: int):
    """RetrainPipeline on the card at the harness's shape: (b) the
    pipelined fresh run with a prober, featurizing in its prep; (a) the
    serial loop of fresh GBDTs with reference= binning on the same
    windows; (c) the warm policy; (d) (b) checkpointed, killed at window
    2's prep and resumed."""
    import shutil
    import numpy as np
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.boosting.gbdt import GBDT, scores_from_leaves
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.pipeline import (PipelineError, PreppedWindow,
                                             RetrainPipeline,
                                             densify_csr_rows)
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.soak.workload import (calculate_opt,
                                                  csr_row_subset,
                                                  derive_features,
                                                  synth_trace)
    params = {**PIPE_BASE, "device": dev.type}
    cfg = Config(params)
    t0 = time.perf_counter()
    ids, sizes, costs = synth_trace(PIPE_WINDOW * PIPE_WINDOWS,
                                    PIPE_OBJECTS, seed)
    trace_s = time.perf_counter() - t0
    windows, feat_s = {}, {}

    def featurize(w):
        t = time.perf_counter()
        lo, hi = w * PIPE_WINDOW, (w + 1) * PIPE_WINDOW
        to_cache, _ = calculate_opt(ids[lo:hi], sizes[lo:hi],
                                    PIPE_CACHE_SIZE, PIPE_WINDOW)
        # sampling 0: every request of the window is a row
        label, indptr, indices, data = derive_features(
            ids[lo:hi], sizes[lo:hi], costs[lo:hi], to_cache,
            PIPE_CACHE_SIZE, PIPE_WINDOW, 0, None)
        keep = np.arange(PIPE_WINDOW) >= PIPE_WINDOW - PIPE_SAMPLE
        tr = csr_row_subset(indptr, indices, data, keep)
        windows[w] = PreppedWindow(
            label=label[keep], csr=tr + (PIPE_COLS,),
            eval_label=label if w > 0 else None,
            eval_csr=(indptr, indices, data, PIPE_COLS) if w > 0 else None)
        feat_s[w] = time.perf_counter() - t
        return windows[w]

    def cached(w):
        return windows[w]

    def counted(run):
        """(results, wave_hist launches, forest launches, forest routes,
        seconds) of ``run()``, the counts reset just before it."""
        hist_cuda.wave_hist.launches.reset()
        before = forest_counts()
        t = time.perf_counter()
        out = run()
        secs = time.perf_counter() - t
        fl, fr = counts_since(before)
        return out, hist_cuda.wave_hist.launches.read(), fl, fr, secs

    obs.configure(enabled=True)
    kw = dict(num_iterations=PIPE_BASE["num_iterations"], chunk=PIPE_CHUNK,
              rebin_on_drift=False)
    out = {}
    launches_total, fl_total, routes_total = 0, 0, None

    def add(wl, fl, fr):
        nonlocal launches_total, fl_total, routes_total
        launches_total += wl
        fl_total += fl
        routes_total = fr if routes_total is None else {
            k: routes_total[k] + v for k, v in fr.items()}

    # (b) pipelined fresh run, featurizing in its prep, probed throughout
    obs.reset()
    pipe_b = RetrainPipeline(params, window_policy="fresh", **kw)
    rows0 = None

    def prep_b(w):
        nonlocal rows0
        pw = featurize(w)
        if rows0 is None:
            rows0 = densify_csr_rows(pw.csr, 0, 1000)
        return pw

    def run_b():
        with _Prober(pipe_b.server, lambda: rows0, seed) as pr:
            res = pipe_b.run(range(PIPE_WINDOWS), prep_b,
                             eval_fn=pipeline_eval)
        return res, pr

    (res_b, prober), wl, fl, fr, secs = counted(run_b)
    add(wl, fl, fr)
    waves = pipeline_waves(r.booster for r in res_b)
    if wl <= 0 or wl != waves:
        fail(f"pipeline (b): wave_hist launches {wl} != tree waves + "
             f"warm-up {waves}")
    trace_path = OUT_DIR / "pipeline_b_trace.json"
    OUT_DIR.mkdir(exist_ok=True)
    obs.dump_trace(str(trace_path))
    snap_b = obs.snapshot()
    pipe_counters = {k: v for k, v in snap_b["counters"].items()
                     if k.startswith("pipeline.")}
    pipe_timings = {k: v for k, v in snap_b["timings"].items()
                    if k.startswith("pipeline.")}
    sha_b = [hashlib.sha256(r.booster.model_to_string().encode())
             .hexdigest() for r in res_b]
    if prober.errors or not prober.log \
            or not all(ok for *_, ok in prober.log):
        fail(f"pipeline (b): prober requests failed: "
             f"{prober.errors[:3]} ({len(prober.log)} requests)")
    inside = sum(1 for a, b, _, _ in prober.log for r in res_b[1:]
                 if r.train_span[0] <= a and b <= r.train_span[1])
    if inside <= 0:
        fail("pipeline (b): no prober request inside a later window's "
             "training")
    same = [r.swap_same_shape for r in res_b[1:]]
    if not all(same):
        fail(f"pipeline (b): swap_same_shape {same}")
    aucs = [r.eval_metrics["auc"] for r in res_b[1:]]
    if min(aucs) < PIPE_AUC_FLOOR:
        fail(f"pipeline (b): held-out AUC {aucs} below {PIPE_AUC_FLOOR}")
    bin_s = [r.prep_s - feat_s[r.window] for r in res_b]
    out["b"] = dict(
        seconds=secs, launches=wl, waves=waves, forest_launches=fl,
        forest_routes=fr, overlap_fraction=pipe_b.overlap_fraction,
        windows=[pipeline_window_rows(r) for r in res_b],
        featurize_s=[feat_s[w] for w in range(PIPE_WINDOWS)],
        host_bin_s=bin_s, sha256=sha_b,
        rows=[r.rows for r in res_b],
        prober=dict(requests=len(prober.log), inside_training=inside,
                    p50_ms=1e3 * _median([b - a for a, b, _, _
                                          in prober.log])),
        pipeline_counters=pipe_counters, pipeline_timings=pipe_timings,
        captures=snap_b["captures"], trace=str(trace_path))
    del res_b

    # (a) the serial loop on the same windows
    def run_a():
        ref, res = None, []
        for w in range(PIPE_WINDOWS):
            pw = windows[w]
            t = time.perf_counter()
            ds = BinnedDataset.construct_from_csr(*pw.csr, cfg,
                                                  reference=ref)
            ds.metadata.set_label(pw.label)
            ref = ref or ds
            b = time.perf_counter()
            g = GBDT(cfg)
            g.init_train(ds)
            g.train_chunked(PIPE_BASE["num_iterations"], chunk=PIPE_CHUNK)
            text = g.model_to_string()
            res.append((g, hashlib.sha256(text.encode()).hexdigest(),
                        b - t, time.perf_counter() - b))
        return res

    res_a, wl, fl, fr, secs = counted(run_a)
    add(wl, fl, fr)
    waves = pipeline_waves(g for g, *_ in res_a)
    if wl <= 0 or wl != waves:
        fail(f"pipeline (a): wave_hist launches {wl} != tree waves + "
             f"warm-up {waves}")
    sha_a = [s for _, s, _, _ in res_a]
    if sha_a != sha_b:
        fail(f"pipeline: serial loop sha256 {sha_a} != pipelined {sha_b}")
    out["a"] = dict(seconds=secs, launches=wl, sha256=sha_a,
                    bin_s=[b for _, _, b, _ in res_a],
                    train_s=[t for _, _, _, t in res_a])
    del res_a

    # (c) the warm policy
    obs.reset()
    pipe_c = RetrainPipeline(params, window_policy="warm",
                             warm_iterations=PIPE_WARM_ITERATIONS, **kw)
    seen = {}

    def on_c(res):
        seen[res.window] = pipe_c.last_leaf_ids if res.policy == "warm" \
            else None

    res_c, wl, fl, fr, secs = counted(
        lambda: pipe_c.run(range(PIPE_WINDOWS), cached,
                           eval_fn=pipeline_eval, on_window=on_c))
    add(wl, fl, fr)
    waves = pipeline_waves(r.booster for r in res_c)
    if wl <= 0 or wl != waves:
        fail(f"pipeline (c): wave_hist launches {wl} != tree waves + "
             f"warm-up {waves}")
    checked = []
    for r in res_c[1:]:
        if r.policy != "warm":
            fail(f"pipeline (c): window {r.window} ran {r.policy}")
        ids_w = seen[r.window]
        copied = res_c[r.window - 1].booster.models
        xr = densify_csr_rows(windows[r.window].csr, 0, PIPE_HOST_ROWS)
        for tree, got in zip(copied, ids_w):
            if tree.num_leaves > 1 and not np.array_equal(
                    got[:PIPE_HOST_ROWS], tree.predict_leaf(xr)):
                fail(f"pipeline (c): window {r.window}: the card's leaf "
                     f"ids differ from the host walk")
        g = r.booster
        refit = lt.Booster.from_gbdt(g)
        mode = g.config.device_predict
        g.config.device_predict = "off"
        raw = refit.predict(xr, raw_score=True,
                            num_iteration=len(ids_w))
        g.config.device_predict = mode
        summed = scores_from_leaves(g.models[:len(ids_w)],
                                    [None if i is None
                                     else i[:PIPE_HOST_ROWS]
                                     for i in ids_w], 1,
                                    len(xr))[0]
        err = float(np.abs(summed - raw).max())
        if err > 1e-6 * float(np.abs(raw).max()):
            fail(f"pipeline (c): window {r.window}: refit scores from the "
                 f"leaf ids differ from predict by {err}")
        checked.append(dict(window=r.window, trees=len(ids_w),
                            max_abs_err=err))
    out["c"] = dict(seconds=secs, launches=wl, forest_launches=fl,
                    overlap_fraction=pipe_c.overlap_fraction,
                    windows=[pipeline_window_rows(r) for r in res_c],
                    refit_checks=checked,
                    refit_timings=obs.snapshot()["timings"].get(
                        "pipeline.refit"))
    del res_c, pipe_c

    # (d) (b) checkpointed, killed at window 2's prep, resumed
    ckpt = OUT_DIR / "pipeline_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)

    def run_d():
        pipe = RetrainPipeline(params, window_policy="fresh",
                               checkpoint_dir=str(ckpt), **kw)
        faults.configure(PIPE_FAULT)
        try:
            pipe.run(range(PIPE_WINDOWS), cached, eval_fn=pipeline_eval)
        except PipelineError as e:
            killed = (e.window, [r.window for r in e.results])
        else:
            fail("pipeline (d): the injected prep fault did not fire")
        finally:
            faults.clear()
        pipe.server = None
        resumed = RetrainPipeline.resume(str(ckpt), params,
                                         window_policy="fresh", **kw)
        served = resumed.server.predict(rows0[:100])
        res = resumed.run(range(PIPE_WINDOWS), cached,
                          eval_fn=pipeline_eval)
        return killed, served, res

    (killed, served, res_d), wl, fl, fr, secs = counted(run_d)
    add(wl, fl, fr)
    sha_d = hashlib.sha256(res_d[-1].booster.model_to_string().encode()) \
        .hexdigest()
    if killed != (2, [0, 1]) or [r.window for r in res_d] != [2, 3]:
        fail(f"pipeline (d): killed at {killed}, resumed windows "
             f"{[r.window for r in res_d]}")
    if sha_d != sha_b[-1]:
        fail(f"pipeline (d): resumed final sha256 {sha_d} != (b)'s "
             f"{sha_b[-1]}")
    if not np.isfinite(served).all():
        fail("pipeline (d): the resumed server's answers are not finite")
    out["d"] = dict(seconds=secs, launches=wl, killed_at=killed[0],
                    sha256=sha_d,
                    windows=[pipeline_window_rows(r) for r in res_d])
    shutil.rmtree(ckpt, ignore_errors=True)
    del res_d
    obs.configure(enabled=False)
    obs.reset()

    for run in ("b", "c"):
        for row in out[run]["windows"]:
            print(f"pipeline ({run}) window {row['window']} "
                  f"{row['policy']}: prep_s {row['prep_s']:.3f} stall_s "
                  f"{row['stall_s']:.3f} train_s {row['train_s']:.3f} "
                  f"eval_s {row['eval_s']:.3f} swap_s {row['swap_s']:.4f} "
                  f"drift {row['drift']} rebinned {row['rebinned']} "
                  f"captures {row['captures']} ({row['capture_s']:.3f} s) "
                  f"s/tree {row['s_per_tree']:.5f} host syncs "
                  f"{row['host_syncs']} metrics {row['metrics']}",
                  flush=True)
    b = out["b"]
    print(f"pipeline (b): overlap {b['overlap_fraction']}; one window's "
          f"featurization {b['featurize_s'][1]:.2f} s and host binning "
          f"{b['host_bin_s'][1]:.2f} s; prober {b['prober']}; AUC on the "
          f"next window {[w['metrics']['auc'] for w in b['windows'][1:]]}"
          f"; (c) overlap {out['c']['overlap_fraction']}", flush=True)
    print(f"pipeline counters {b['pipeline_counters']}", flush=True)
    print(f"phase pipeline: ok ((a) == (b) sha256 every window, (d) "
          f"resumed to (b)'s {sha_b[-1][:16]}; wave_hist launches "
          f"{launches_total}, forest_predict launches {fl_total}; trace "
          f"{b['trace']}; {trace_s:.1f} s of trace synthesis)", flush=True)
    return dict(runs=out, launches=launches_total,
                predict_launches=fl_total, predict_routes=routes_total,
                windows=PIPE_WINDOWS, window=PIPE_WINDOW,
                sample=PIPE_SAMPLE, trace_s=trace_s)



#: cut from 2M (and the fork's 20M) to keep the script under 900 s: the
#: ABI bins CSR on the host, ~10 s a 2M-row window
CAPI_ROWS = 1_000_000
CAPI_WINDOWS = 4            # three trained windows and the next one scored
#: the fork's training parameters (examples/cache_admission.py:57), in
#: chunks of 25 (:66) as window_harness.cpp trains them
CAPI_PARAMS = {"boosting": "gbdt", "objective": "binary", "max_bin": 255,
               "num_iterations": 50, "learning_rate": 0.1,
               "num_leaves": 31, "tree_learner": "serial",
               "feature_fraction": 0.8, "bagging_freq": 5,
               "bagging_fraction": 0.8, "min_data_in_leaf": 50,
               "min_sum_hessian_in_leaf": 5.0, "fused_chunk": 25,
               "verbosity": -1}
CAPI_BUILD = ROOT / "src" / "capi_cuda" / "build"


def trees_sha256(text: str) -> str:
    """sha256 of a model text before its parameters block (which records
    grower_cache and how the run was driven)."""
    return hashlib.sha256(text.split("\nparameters:\n")[0].encode()) \
        .hexdigest()


def run_native(cmd, env, cwd, timeout):
    """Run a native driver; echo its lines; fail unless it exits 0."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        print(f"  | {line}", flush=True)
    if res.returncode != 0:
        print(res.stderr[-4000:], flush=True)
        fail(f"capi: {Path(cmd[0]).name} exited {res.returncode}")
    return res.stdout, secs


def metric_counts(path) -> dict:
    """The launch gauges and capture/cache counters of a native run's
    metrics file."""
    snap = json.loads(Path(path).read_text())
    g, c = snap.get("gauges", {}), snap.get("counters", {})
    return dict(
        wave_hist=int(g.get("hist_cuda.wave_hist.launches", 0)),
        forest_predict=int(g.get("packed.forest_predict.launches", 0)),
        routes={r: int(g.get(f"packed.forest_predict.routes.{r}", 0))
                for r in ("rows", "trees")},
        captures=int(c.get("capture.total", 0)),
        cache_hits=int(c.get("grow.cache_hits", 0)),
        cache_misses=int(c.get("grow.cache_misses", 0)),
        peak_bytes=(snap.get("device_memory") or {}).get(
            "peak_bytes_in_use"))


def phase_capi(dev, seed: int):
    """The native ABI on the card (the module docstring's phase 13)."""
    import tempfile
    import numpy as np
    import scipy.sparse as sp
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.obs import capture_track
    from lightgbm_tpu_torch.ops import grow, hist_cuda
    from lightgbm_tpu_torch.serve import packed
    out = {}
    t0 = time.perf_counter()
    res = subprocess.run(["make", "-C", str(CAPI_BUILD.parent),
                          f"BUILD={CAPI_BUILD}", f"PY={sys.executable}"],
                         capture_output=True, text=True)
    out["build_s"] = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
        fail("capi: the native ABI (src/capi_cuda) did not build")
    print(f"capi: built liblgbm_tpu_torch.so, smoke_test and "
          f"window_harness in {out['build_s']:.1f} s", flush=True)
    launches = dict(wave_hist=0, forest_predict=0,
                    routes={"rows": 0, "trees": 0})

    def add(counts):
        launches["wave_hist"] += counts["wave_hist"]
        launches["forest_predict"] += counts["forest_predict"]
        for r in launches["routes"]:
            launches["routes"][r] += counts["routes"][r]

    with tempfile.TemporaryDirectory(prefix="capi_") as tmp:
        tmp = Path(tmp)
        base_env = dict(os.environ, LGBM_TPU_PYROOT=str(ROOT),
                        LGBM_TPU_COMPILE_CACHE=str(tmp / "kernels"))
        # (1) the unchanged harness, twice with one build directory
        smoke = []
        for run in (1, 2):
            env = dict(base_env,
                       LGBM_TPU_METRICS=str(tmp / f"smoke{run}.json"))
            stdout, secs = run_native([str(CAPI_BUILD / "smoke_test")],
                                      env, str(tmp), 600)
            built = [int(line.split("(")[1].split()[0]) for line in
                     stdout.splitlines() if line.startswith("warmup:")]
            counts = metric_counts(tmp / f"smoke{run}.json")
            add(counts)
            smoke.append(dict(seconds=secs, warmup_built=built,
                              counts=counts))
            print(f"capi: smoke_test run {run} passed in {secs:.1f} s "
                  f"(warm-up built {built} libraries; {counts})",
                  flush=True)
        if smoke[1]["warmup_built"] != [0, 0]:
            fail(f"capi: the second smoke_test run's warm-up built "
                 f"{smoke[1]['warmup_built']} libraries, 0 expected")
        out["smoke"] = smoke

        # (2) the windows, written as raw CSR arrays
        t0 = time.perf_counter()
        windows = []
        for k in range(CAPI_WINDOWS):
            x, y = window_shape(CAPI_ROWS, seed + 40 + k)
            csr = sp.csr_matrix(x)
            del x
            csr.indptr.astype(np.int64).tofile(tmp / f"w{k}_indptr.i64")
            csr.indices.astype(np.int32).tofile(tmp / f"w{k}_indices.i32")
            csr.data.astype(np.float32).tofile(tmp / f"w{k}_data.f32")
            y.astype(np.float32).tofile(tmp / f"w{k}_label.f32")
            windows.append((csr, y))
        out["windows_s"] = time.perf_counter() - t0
        nnz = [int(c.nnz) for c, _ in windows]
        print(f"capi: {CAPI_WINDOWS} windows of {CAPI_ROWS} x {WIN_COLS} "
              f"({nnz} nonzeros) in {out['windows_s']:.1f} s", flush=True)

        # (3) the fork's loop through the native ABI
        env = dict(base_env, LGBM_TPU_METRICS=str(tmp / "harness.json"))
        stdout, secs = run_native([str(CAPI_BUILD / "window_harness"),
                                   str(tmp), str(CAPI_WINDOWS)], env,
                                  str(tmp), 1200)
        rows = [json.loads(line.split(" ", 1)[1]) for line in
                stdout.splitlines() if line.startswith("WINDOW ")]
        warm = json.loads(next(line for line in stdout.splitlines()
                               if line.startswith("WARMUP ")
                               ).split(" ", 1)[1])
        per_window = [metric_counts(tmp / f"metrics_w{k}.json")
                      for k in range(CAPI_WINDOWS - 1)]
        final = metric_counts(tmp / "harness.json")
        add(final)
        native_sha = [trees_sha256((tmp / f"model_w{k}.txt").read_text())
                      for k in range(CAPI_WINDOWS - 1)]
        native_pred = [np.fromfile(tmp / f"pred_w{k}.f64")
                       for k in range(CAPI_WINDOWS - 1)]
        native_served = [np.fromfile(tmp / f"serve_w{k}.f64")
                         for k in range(CAPI_WINDOWS - 1)]
        # the wave-stage plans the harness measured (wave_plan=auto with
        # a store): the in-process runs adopt them from a store of their
        # own, so the three runs grow under one plan
        plans = {f.name: f.read_bytes() for f in
                 (tmp / "kernels" / "stage_plans").glob("plan_*.json")}
    # window 0's count includes the warm-up's captures
    caps = [per_window[0]["captures"]] + [
        b["captures"] - a["captures"]
        for a, b in zip(per_window, per_window[1:])]
    hits = [per_window[0]["cache_hits"]] + [
        b["cache_hits"] - a["cache_hits"]
        for a, b in zip(per_window, per_window[1:])]
    out["native"] = dict(seconds=secs, warmup=warm, windows=rows,
                         captures=caps, cache_hits=hits, counts=final,
                         sha256=native_sha)
    if min(final["wave_hist"], final["forest_predict"],
           final["captures"]) <= 0:
        fail(f"capi: the harness's metrics show no card work: {final}")
    if caps[1:] != [0] * (CAPI_WINDOWS - 2) or \
            hits[1:] != [1] * (CAPI_WINDOWS - 2):
        fail(f"capi: native windows captured {caps} and took the cached "
             f"grower {hits} times; windows 1-2 must capture nothing and "
             f"hit once each")

    # (4) the same windows in this process, the grower cache on and off
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops import stage_plan
    clear_growers(dev)
    torch.cuda.init()
    store = Path(tempfile.mkdtemp(prefix="capi_plans_"))
    (store / "stage_plans").mkdir()
    for name, blob in plans.items():
        (store / "stage_plans" / name).write_bytes(blob)
    build_dir = build.BUILD_DIR
    loads0 = grow.PLAN_COUNTS["persisted_loads"]
    datasets = []
    for k, (csr, y) in enumerate(windows[:-1]):
        t0 = time.perf_counter()
        ds = lt.Dataset(csr, label=y, params={**CAPI_PARAMS,
                                              "device": dev.type},
                        reference=datasets[0] if datasets else None)
        ds.construct()
        datasets.append(ds)
        rows[k]["inprocess_dataset_s"] = time.perf_counter() - t0
    inproc = {}
    for cache in (True, False):
        params = {**CAPI_PARAMS, "device": dev.type, "grower_cache": cache,
                  "compile_cache_dir": str(store)}
        torch.cuda.reset_peak_memory_stats(dev)
        hist_cuda.wave_hist.launches.reset()
        fp0 = packed.forest_predict.launches
        routes0 = dict(packed.forest_predict.routes)
        runs = []
        for k, ds in enumerate(datasets):
            c0 = capture_track.COUNTS["captures"]
            h0 = grow.GROWER_CACHE_COUNTS["hits"]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            b = lt.train(params, ds, num_boost_round=CAPI_PARAMS[
                "num_iterations"])
            torch.cuda.synchronize(dev)
            train_s = time.perf_counter() - t0
            run = dict(train_s=train_s, ms_per_tree=1e3 * train_s /
                       CAPI_PARAMS["num_iterations"],
                       captures=capture_track.COUNTS["captures"] - c0,
                       cache_hit=grow.GROWER_CACHE_COUNTS["hits"] - h0,
                       sha256=trees_sha256(b.model_to_string()))
            if cache:
                # the ABI's predictions against Booster.predict of the same
                # rows (the trees of the cache-off run are the same)
                nxt, ynext = windows[k + 1]
                dense = nxt.toarray().astype(np.float64)
                t0 = time.perf_counter()
                pred = b.predict(dense)
                run.update(
                    predict_s=time.perf_counter() - t0,
                    pred_err=float(np.abs(pred - native_pred[k]).max()),
                    served_err=float(np.abs(native_served[k]
                                            - native_pred[k]).max()),
                    auc=auc_of(ynext, pred))
                del dense
            runs.append(run)
            del b
        inproc[cache] = dict(
            windows=runs, peak_mem_gb=torch.cuda.max_memory_allocated(dev)
            / 1e9, launches=hist_cuda.wave_hist.launches.read(),
            predict_launches=packed.forest_predict.launches - fp0,
            predict_routes={r: packed.forest_predict.routes[r] - routes0[r]
                            for r in routes0})
        launches["wave_hist"] += inproc[cache]["launches"]
        launches["forest_predict"] += inproc[cache]["predict_launches"]
        for r in launches["routes"]:
            launches["routes"][r] += inproc[cache]["predict_routes"][r]
    sig = grow.plan_signature(datasets[0]._handle, lt.Config(params), dev)
    out["plan"] = dict(stored=len(plans),
                       loads=grow.PLAN_COUNTS["persisted_loads"] - loads0,
                       digest=stage_plan.plan_digest(
                           stage_plan.cached_plan(sig)
                           or grow.default_stage_plan(CAPI_ROWS,
                                                      lt.Config(params))))
    # back to the package's build directory for later phases (the
    # in-process boosters' compile_cache_dir moved it process-wide)
    build.BUILD_DIR = build_dir
    stage_plan.forget_plan(sig)
    import shutil
    shutil.rmtree(store, ignore_errors=True)
    print(f"capi: {len(plans)} stage plan(s) kept by the harness, "
          f"{out['plan']['loads']} adopted in process, plan "
          f"{out['plan']['digest']}", flush=True)
    del datasets, windows
    clear_growers(dev)
    on, off = inproc[True]["windows"], inproc[False]["windows"]
    for k in range(CAPI_WINDOWS - 1):
        shas = {native_sha[k], on[k]["sha256"], off[k]["sha256"]}
        if len(shas) != 1:
            fail(f"capi window {k}: trees sha256 native {native_sha[k]}, "
                 f"in-process {on[k]['sha256']}, grower_cache=false "
                 f"{off[k]['sha256']}")
        if on[k]["pred_err"] > 1e-12:
            fail(f"capi window {k}: the ABI's predictions differ from "
                 f"Booster.predict by {on[k]['pred_err']}")
        if on[k]["auc"] < WIN_AUC_FLOOR:
            fail(f"capi window {k}: held-out AUC {on[k]['auc']:.4f} < "
                 f"{WIN_AUC_FLOOR}")
    if [r["captures"] for r in on[1:]] != [0] * (CAPI_WINDOWS - 2) or \
            [r["cache_hit"] for r in on[1:]] != [1] * (CAPI_WINDOWS - 2):
        fail(f"capi in-process: captures {[r['captures'] for r in on]}, "
             f"cache hits {[r['cache_hit'] for r in on]}")
    for k, row in enumerate(rows):
        abi_s = row["booster_create_s"] + row["train_s"]
        row["abi_overhead"] = abi_s / on[k]["train_s"] - 1.0
        print(f"capi window {k}: DatasetCreate {row['dataset_s']:.2f} s "
              f"(in-process {row['inprocess_dataset_s']:.2f} s), train "
              f"{row['train_s']:.3f} s ({1e3 * row['train_s'] / 50:.2f} ms "
              f"a tree; create {row['booster_create_s']:.3f} s; "
              f"in-process {on[k]['train_s']:.3f} s, cache off "
              f"{off[k]['train_s']:.3f} s; ABI overhead "
              f"{100 * row['abi_overhead']:.1f}%), captures {caps[k]} "
              f"(in-process {on[k]['captures']}, cache off "
              f"{off[k]['captures']}), predict {row['predict_s']:.3f} s, "
              f"serve all {row['serve_predict_s']:.3f} s, serve p50 "
              f"{row['serve_p50_ms_1']:.3f} ms at 1 row and "
              f"{row['serve_p50_ms_big']:.2f} ms at {row['serve_big_rows']}"
              f", AUC "
              f"{on[k]['auc']:.4f}, trees sha256 {native_sha[k][:16]}",
              flush=True)
    out["windows"] = rows
    out["inprocess"] = {"cache_on": inproc[True], "cache_off": inproc[False]}
    out["launches"] = launches
    print(f"capi: peak card memory {inproc[True]['peak_mem_gb']:.2f} GB "
          f"with the grower cache on, {inproc[False]['peak_mem_gb']:.2f} "
          f"GB off (in-process); the harness's "
          f"{(final['peak_bytes'] or 0) / 1e9:.2f} GB", flush=True)
    print(f"phase capi: ok (3 runs, one sha256 a window; warm-up built "
          f"{warm['train_built']} + {warm['serve_built']} libraries; "
          f"launches {launches})", flush=True)
    return out



#: the api phase: the train phase's HIGGS shape at 255 leaves, binned once
#: on the card and kept raw for continued training
API_BASE = {**TRAIN_BASE, "num_leaves": 255}
API_ROUNDS = 5
API_SCHEDULE = [0.1 * 0.9 ** i for i in range(10)]
API_VALID_ROWS = 500_000
#: fused chunks of ROUNDS trees timed under each stage plan (median)
API_PLAN_CHUNKS = 3


def tree_blocks(text: str) -> list:
    """The ``Tree=`` blocks of a model text."""
    return ["Tree=" + b for b in
            text.split("end of trees")[0].split("Tree=")[1:]]


def shrinkages(text: str) -> list:
    return [float(line.split("=", 1)[1]) for line in text.splitlines()
            if line.startswith("shrinkage=")]


def refused(booster, reset: dict, name: str) -> str:
    """The message of ``booster.reset_parameter(reset)``, which must
    raise naming ``name``."""
    from lightgbm_tpu_torch.utils.log import LightGBMError
    try:
        booster.reset_parameter(reset)
    except LightGBMError as e:
        if name not in str(e):
            fail(f"api: a refused reset does not name {name}: {e}")
        return str(e)
    fail(f"api: reset_parameter({reset}) on the device grower was taken")


def plan_chunks(booster, y, dev):
    """(training AUC after a first fused chunk of ROUNDS trees, s a tree of
    API_PLAN_CHUNKS more chunks on the host clock to a synchronize)."""
    import torch
    gb = booster._gbdt
    gb.train_chunked(ROUNDS, chunk=ROUNDS)
    auc = auc_of(y, gb.train_score[0].cpu().numpy())
    times = []
    for _ in range(API_PLAN_CHUNKS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        gb.train_chunked(ROUNDS, chunk=ROUNDS)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) / ROUNDS)
    return auc, times


def phase_api(dev, seed: int, x, y):
    """The rest of the training API on the card (the module docstring's
    phase 14)."""
    import pickle
    import shutil
    import tempfile
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import build, grow, hist_cuda
    from lightgbm_tpu_torch.ops import stage_plan as sp
    t_phase = time.perf_counter()
    out = {}
    wh0 = hist_cuda.wave_hist.launches.read()
    fp0 = forest_counts()
    xv, yv = higgs_shape(API_VALID_ROWS, seed + 1)
    params = dict(API_BASE)
    t0 = time.perf_counter()
    xt = torch.from_numpy(x).to(dev)
    ds = lt.Dataset(xt, y, params=dict(params),
                    free_raw_data=False).construct()
    torch.cuda.synchronize(dev)
    out["binning_s"] = time.perf_counter() - t0
    if ds.raw is not xt:
        fail("api: the Dataset did not keep its raw rows")

    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        tmp = Path(tmp)
        # (1) continued training from a saved model
        b1 = lt.train(params, ds, API_ROUNDS, verbose_eval=False)
        first = tmp / "first.txt"
        b1.save_model(str(first))
        auc1 = auc_of(yv, b1.predict(xv))
        del b1
        before = forest_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        b2 = lt.train(params, ds, API_ROUNDS, init_model=str(first),
                      verbose_eval=False)
        torch.cuda.synchronize(dev)
        cont_s = time.perf_counter() - t0
        init_launches, init_routes = counts_since(before)
        text2 = b2.model_to_string()
        auc2 = auc_of(yv, b2.predict(xv))
        head_equal = tree_blocks(text2)[:API_ROUNDS] \
            == tree_blocks(first.read_text())
        out["continued"] = dict(
            iterations=b2.current_iteration(), auc_first=auc1,
            auc_continued=auc2, head_equal=head_equal, train_s=cont_s,
            init_score_launches=init_launches,
            init_score_routes=init_routes)
        print(f"api (1) continued training: {b2.current_iteration()} "
              f"iterations, the first {API_ROUNDS} trees byte-equal to the "
              f"saved model's: {head_equal}; held-out AUC {auc1:.4f} -> "
              f"{auc2:.4f}; the init score's forest_predict launches "
              f"{init_launches} {init_routes}; {cont_s:.2f} s", flush=True)
        if b2.current_iteration() != 2 * API_ROUNDS or not head_equal \
                or auc2 < auc1 or init_launches < 1:
            fail(f"api: continued training {out['continued']}")
        ds._handle.metadata.set_init_score(None)
        del b2

        # (2) a learning-rate schedule, a reset between fused chunks, a
        # refused reset and the grower it leaves
        t0 = time.perf_counter()
        bs = lt.train(params, ds, len(API_SCHEDULE),
                      learning_rates=lambda i: 0.1 * 0.9 ** i,
                      verbose_eval=False)
        torch.cuda.synchronize(dev)
        sched_s = time.perf_counter() - t0
        gb = bs._gbdt
        shr = shrinkages(bs.model_to_string())
        # tree 0 carries the boost-from-average bias, which sets its
        # shrinkage to 1 (the reference's AddBias)
        shr_ok = shr[1:] == API_SCHEDULE[1:] \
            and shr[0] in (API_SCHEDULE[0], 1.0)
        err = float(np.abs(gb.train_score[0].double().cpu().numpy()
                           - gb.predict_raw(xt)[0]).max())
        bs.reset_parameter({"learning_rate": 0.05})
        bs.update_chunked(ROUNDS, chunk=ROUNDS)
        shr2 = shrinkages(bs.model_to_string())[len(API_SCHEDULE):]
        err2 = float(np.abs(gb.train_score[0].double().cpu().numpy()
                            - gb.predict_raw(xt)[0]).max())
        msg = refused(bs, {"min_data_in_leaf": 1000}, "min_data_in_leaf")
        del bs, gb
        clear_growers(dev)
        a = lt.Booster(params, ds)
        a.update_chunked(ROUNDS, chunk=ROUNDS)
        refused(a, {"lambda_l2": 10.0}, "lambda_l2")
        grower_a = a._gbdt._grower
        del a
        h0 = grow.GROWER_CACHE_COUNTS["hits"]
        bb = lt.train(params, ds, ROUNDS, verbose_eval=False)
        took = bb._gbdt._grower is grower_a \
            and grow.GROWER_CACHE_COUNTS["hits"] == h0 + 1
        sha_b = trees_sha256(bb.model_to_string())
        del bb, grower_a
        bc = lt.train({**params, "grower_cache": False}, ds, ROUNDS,
                      verbose_eval=False)
        sha_c = trees_sha256(bc.model_to_string())
        del bc
        out["schedule"] = dict(shrinkage=shr, score_err=err,
                               fused_shrinkage=shr2, fused_score_err=err2,
                               train_s=sched_s, refused=msg,
                               cache_took_grower=took,
                               cache_sha256=[sha_b, sha_c])
        print(f"api (2) learning_rates: {len(API_SCHEDULE)} trees per "
              f"iteration in {sched_s:.2f} s, shrinkage {shr} (as "
              f"scheduled: {shr_ok}), |train score - predict_raw| "
              f"{err:.3g}; after a reset to 0.05 a fused chunk's shrinkage "
              f"{sorted(set(shr2))}, {err2:.3g}; refused: {msg!r}; a "
              f"refused booster's grower taken by the next: {took}, trees "
              f"sha256 cache on / off {sha_b[:16]} / {sha_c[:16]}",
              flush=True)
        if not shr_ok or shr2 != [0.05] * ROUNDS or err >= 1e-4 \
                or err2 >= 1e-4 or not took or sha_b != sha_c:
            fail(f"api: learning-rate schedule {out['schedule']}")
        clear_growers(dev)

        # (3) cv
        t0 = time.perf_counter()
        res = lt.cv({**params, "metric": "auc"}, ds,
                    num_boost_round=API_ROUNDS, nfold=3, stratified=False)
        torch.cuda.synchronize(dev)
        out["cv"] = dict(res, seconds=time.perf_counter() - t0)
        print(f"api (3) cv, 3 folds: auc-mean {res['auc-mean']}, auc-stdv "
              f"{res['auc-stdv']} in {out['cv']['seconds']:.2f} s",
              flush=True)
        if len(res["auc-mean"]) != API_ROUNDS \
                or res["auc-mean"][-1] < AUC_FLOOR:
            fail(f"api: cv {res}")
        clear_growers(dev)

        # (4) the classifier against engine.train with its params
        t0 = time.perf_counter()
        clf = lt.LGBMClassifier(n_estimators=2 * ROUNDS, num_leaves=255,
                                device=dev.type)
        clf.fit(xt, y)
        torch.cuda.synchronize(dev)
        fit_s = time.perf_counter() - t0
        y_enc = np.unique(y, return_inverse=True)[1]
        ref = lt.train(clf._get_lgb_params(), lt.Dataset(xt, y_enc),
                       2 * ROUNDS, verbose_eval=False)
        sha_clf = trees_sha256(clf.booster_.model_to_string())
        sha_ref = trees_sha256(ref.model_to_string())
        t0 = time.perf_counter()
        proba = clf.predict_proba(x)[:, 1]
        proba_s = time.perf_counter() - t0
        pred = ref.predict(x)
        # (5) pickling
        again = pickle.loads(pickle.dumps(ref))
        pred_again = again.predict(x)
        out["sklearn"] = dict(fit_s=fit_s, predict_proba_s=proba_s,
                              sha256=[sha_clf, sha_ref],
                              proba_equal=bool(np.array_equal(proba, pred)),
                              auc=auc_of(y, pred))
        out["pickle"] = dict(
            equal=bool(np.array_equal(pred_again, pred)),
            device=str(again._gbdt.config.device_type))
        print(f"api (4) LGBMClassifier: fit {fit_s:.2f} s, trees sha256 "
              f"{sha_clf[:16]} (engine.train {sha_ref[:16]}), "
              f"predict_proba[:, 1] equal to Booster.predict: "
              f"{out['sklearn']['proba_equal']} ({proba_s:.2f} s); (5) a "
              f"pickled booster predicts byte-equal: "
              f"{out['pickle']['equal']}", flush=True)
        if sha_clf != sha_ref or not out["sklearn"]["proba_equal"] \
                or not out["pickle"]["equal"]:
            fail(f"api: estimator / pickle {out['sklearn']} "
                 f"{out['pickle']}")
        del clf, ref, again
        clear_growers(dev)

        # (6) the profiled stage plan, kept beside a warm kernel directory
        store = tmp / "plans"
        store.mkdir()
        for lib in build.BUILD_DIR.glob("lib*.so"):
            shutil.copy(lib, store)
        build_dir = build.BUILD_DIR
        pp = {**params, "wave_plan": "profiled",
              "compile_cache_dir": str(store)}
        prof0 = grow.PLAN_COUNTS["profiles"]
        wh = hist_cuda.wave_hist.launches.read()
        bp = lt.Booster(pp, ds)
        probes = hist_cuda.wave_hist.launches.read() - wh
        prof = bp._gbdt.plan_profile
        g = bp._gbdt._grower
        sig, plan = g.signature, list(g.stage_plan)
        kept = sp.load_plan(sig, sp.store_dir(bp._gbdt.config)) == plan
        auc_p, t_plan = plan_chunks(bp, y, dev)
        bl = lt.Booster({**params, "wave_plan": "fixed"}, ds)
        legacy = list(bl._gbdt._grower.stage_plan)
        auc_l, t_legacy = plan_chunks(bl, y, dev)
        del bp, bl, g
        p1 = grow.PLAN_COUNTS["profiles"]
        bq = lt.Booster(pp, ds)
        second = dict(profiles=grow.PLAN_COUNTS["profiles"] - p1,
                      source=bq._gbdt._grower.plan_source,
                      plan=list(bq._gbdt._grower.stage_plan))
        del bq
        code = (
            "import json, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import torch, chip_smoke, lightgbm_tpu_torch as lt\n"
            "from lightgbm_tpu_torch.ops import grow\n"
            f"x, y = chip_smoke.higgs_shape({len(y)}, {seed})\n"
            f"ds = lt.Dataset(torch.from_numpy(x).to({str(dev)!r}), y, "
            f"params={params!r})\n"
            f"b = lt.Booster({pp!r}, ds)\n"
            "b.update()\n"
            "g = b._gbdt._grower\n"
            "print('ADOPT ' + json.dumps(dict(source=g.plan_source, "
            "plan=g.stage_plan, counts=grow.PLAN_COUNTS, "
            "trees=b.num_trees())))\n")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                             capture_output=True, text=True, timeout=600)
        fresh_s = time.perf_counter() - t0
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("ADOPT ")]
        if res.returncode != 0 or not line:
            print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
            fail("api: the fresh process did not adopt the stored plan")
        fresh = json.loads(line[0].split(" ", 1)[1])
        fresh["seconds"] = fresh_s
        # wave_plan=auto with a fresh store: measure once, keep the verdict
        store2 = tmp / "plans2"
        store2.mkdir()
        sp.forget_plan(sig, sp.store_dir(lt.Config(pp)))
        clear_growers(dev)
        p2 = grow.PLAN_COUNTS["profiles"]
        ba = lt.Booster({**params, "wave_plan": "auto",
                         "compile_cache_dir": str(store2)}, ds)
        auto = ba._gbdt.plan_profile
        if auto is None:
            fail("api: wave_plan=auto with a store measured nothing")
        auto_plan = list(ba._gbdt._grower.stage_plan)
        auto_kept = sp.load_plan(sig, str(store2 / "stage_plans")) \
            == auto_plan
        auto_profiles = grow.PLAN_COUNTS["profiles"] - p2
        del ba
        build.BUILD_DIR = build_dir
        sp.forget_plan(sig)
        clear_growers(dev)
    med = lambda v: sorted(v)[len(v) // 2]
    out["plan"] = dict(
        stage_ms=prof["stage_ms"], spread_ms=prof["spread_ms"],
        fixed_ms=prof["fixed_ms"],
        col_ms=prof["col_ms"], residual_ms=prof["residual_ms"],
        plan=plan, legacy=legacy, digest=sp.plan_digest(plan),
        installed=prof["installed"], probe_launches=probes, kept=kept,
        s_per_tree=t_plan, legacy_s_per_tree=t_legacy, auc=auc_p,
        legacy_auc=auc_l, second_booster=second, fresh_process=fresh,
        auto=dict(profiles=auto_profiles, installed=auto["installed"],
                  plan=auto_plan, digest=sp.plan_digest(auto_plan),
                  stage_ms=auto["stage_ms"], spread_ms=auto["spread_ms"],
                  kept=auto_kept))
    widths = sorted(prof["stage_ms"])
    print(f"api (6) wave_plan=profiled: kernel 1 ms by width "
          f"{prof['stage_ms']}, spread {prof['spread_ms']} ({probes} "
          f"launches); fit fixed "
          f"{prof['fixed_ms']} ms + {prof['col_ms']} ms a column, "
          f"residuals {prof['residual_ms']}; plan {plan} (digest "
          f"{sp.plan_digest(plan)}, installed {prof['installed']}, kept "
          f"{kept}; legacy {legacy}); s/tree fused median "
          f"{med(t_plan):.5f} {t_plan} against the legacy ladder's "
          f"{med(t_legacy):.5f} {t_legacy}; training AUC {auc_p:.4f} "
          f"(legacy {auc_l:.4f}); a second booster: {second}; a fresh "
          f"process: {fresh}; auto with a fresh store: "
          f"{auto_profiles} profile (ms {auto['stage_ms']}, spread "
          f"{auto['spread_ms']}), installed {auto['installed']}, plan "
          f"{auto_plan}, kept {auto_kept}", flush=True)
    fresh_counts = fresh["counts"]
    if (not prof["profiled"] or widths != [4, 8, 16, 32, 64, 128]
            or probes != (grow.PROBE_REPS + 1) * len(widths) or not kept
            or auc_p < AUC_FLOOR or second["profiles"] != 0
            or second["plan"] != plan or fresh["source"] != "persisted"
            or fresh_counts["profiles"] != 0
            or [tuple(p) for p in fresh["plan"]] != plan
            or auto_profiles != 1 or not auto_kept
            or auto["installed"] != (auto_plan != legacy)):
        fail(f"api: stage plan {out['plan']}")
    out["launches"] = hist_cuda.wave_hist.launches.read() - wh0
    out["predict_launches"], out["predict_routes"] = counts_since(fp0)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase api: ok in {out['seconds']:.1f} s (binning on the card "
          f"{out['binning_s']:.2f} s; wave_hist launches "
          f"{out['launches']}, forest_predict {out['predict_launches']} "
          f"{out['predict_routes']})", flush=True)
    return out


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


#: the soak phase (15): the fork's model (53 CSR columns, 31 leaves,
#: max_bin 255, 50 iterations: examples/cache_admission.py's TRAIN_PARAMS
#: without bagging, which the byte-identical resume forbids), four tenants
#: on two replicas, three windows a tenant of the pipeline phase's trace,
#: its requests and sampled rows both halved to keep the script within
#: its time (the tenants' host prep sets the soak's length)
SOAK_TENANTS = 4
SOAK_REPLICAS = 2
SOAK_WINDOWS = 3
SOAK_REQUESTS = PIPE_WINDOW // 2
SOAK_SAMPLE = PIPE_SAMPLE // 2
#: the forced-fail soak's depth (its chaos adds a persistent device death)
SOAK_FAIL_TENANTS = 2
SOAK_FAIL_WINDOWS = 2
SOAK_FAIL_SAMPLE = 250_000
#: the degrade cycle's re-probe interval and request rows
DEGRADE_REPROBE_S = 0.2
DEGRADE_ROWS = 10_000
#: profile_phases' launches a phase
PROFILE_REPS = 20
#: process-wide host-walk answers already accounted for (the two
#: injected-fault runs of the soak phase); any other is a failure
_FALLBACK_SEEN = [0]
#: the wall clock at the script's start and at the last phase's check
_PHASE_CLOCK = [time.perf_counter()] * 2


def fallback_total() -> int:
    from lightgbm_tpu_torch.serve import engine
    return sum(engine.FALLBACK_COUNTS.values())


def check_no_fallback(phase: str) -> None:
    """Fail when a request since the last check was answered by the host
    walk (a server degraded) outside the soak phase's injected faults."""
    now = fallback_total()
    if now != _FALLBACK_SEEN[0]:
        fail(f"phase {phase}: {now - _FALLBACK_SEEN[0]} requests answered "
             f"by the host walk (a server degraded)")
    now_s = time.perf_counter()
    print(f"  wall {phase}: {now_s - _PHASE_CLOCK[1]:.1f} s since the last "
          f"check, {now_s - _PHASE_CLOCK[0]:.1f} s in all", flush=True)
    _PHASE_CLOCK[1] = now_s


def _validator():
    """scripts/validate_metrics.py (standard library only), the schema
    checks of the stream lines, the exposition text and the verdict."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_validate_metrics",
        ROOT / "scripts" / "validate_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _soak_scenario(seed: int, **kw):
    from lightgbm_tpu_torch.soak import SoakScenario
    base = dict(tenants=SOAK_TENANTS, replicas=SOAK_REPLICAS,
                windows=SOAK_WINDOWS, requests_per_window=SOAK_REQUESTS,
                objects=PIPE_OBJECTS, sample_rows=SOAK_SAMPLE,
                cache_size=PIPE_CACHE_SIZE, num_leaves=31, max_bin=255,
                num_iterations=50, seed=7 + seed)
    base.update(kw)
    return SoakScenario(**base).validate()


def soak_windows(drv) -> list:
    """Each tenant window's training: its seconds and captures, and what
    ran beside it on the host, as the mean number over its wall span of
    the other tenants' trainings and of prep walks (the feature
    derivation, pure Python) of any tenant."""
    trains = [(int(m), r) for m, rs in drv._window_log.items() for r in rs]
    out = []
    for i, (m, r) in enumerate(trains):
        a, b = r["train_span"]
        span = max(b - a, 1e-9)

        def beside(lo, hi):
            return max(0.0, min(b, hi) - max(a, lo))
        other = sum(beside(*r2["train_span"])
                    for j, (_, r2) in enumerate(trains) if j != i) / span
        preps = sum(beside(lo, hi) for _, _, lo, hi in drv.prep_spans) \
            / span
        out.append(dict(tenant=m, window=r["window"], train_s=r["train_s"],
                        captures=r["captures"], capture_s=r["capture_s"],
                        rows=r["rows_trained"], other_trainings=round(other, 2),
                        prep_walks=round(preps, 2)))
    return out


def _run_soak(name, sc, dev, tmp, vm):
    """One soak on the card with the exporter on (stream and prom files,
    the scrape endpoint on a free port, read once): the driver, its
    verdict and what the run counted, kernels' launches from 0."""
    import urllib.request
    import torch
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs.state import STATE
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.serve import packed
    from lightgbm_tpu_torch.soak import SoakDriver, build_verdict
    work = Path(tmp) / name
    prom = Path(tmp) / f"{name}.prom"
    obs.reset()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    hist_cuda.wave_hist.launches.reset()
    packed.forest_predict.launches = 0
    for k in packed.forest_predict.routes:
        packed.forest_predict.routes[k] = 0
    import gc
    gc_s = [0.0, 0, 0.0]     # seconds, collections, the last start

    def gc_clock(phase, info):
        if phase == "start":
            gc_s[2] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[2]
            gc_s[1] += 1
    gc.callbacks.append(gc_clock)
    t0 = time.perf_counter()
    try:
        drv = SoakDriver(sc, workdir=str(work), device=dev.type,
                         prom_path=str(prom), http_port=0)
        outcome = drv.run()
    finally:
        gc.callbacks.remove(gc_clock)
    secs = time.perf_counter() - t0
    wave_launches = hist_cuda.wave_hist.launches.read()
    fp_launches, fp_routes = forest_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    timings = obs.registry().snapshot()["timings"]
    exp = STATE.exporter
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{exp.http_port}/metrics",
        timeout=10).read().decode()
    exp.stop()
    STATE.exporter = None
    verdict = build_verdict(outcome)
    lines = [json.loads(ln) for ln in open(outcome["stream_path"])]
    bad = [e for doc in lines for e in vm.validate_stream_line(doc)]
    bad += vm.validate_prometheus(body) + vm.validate_prometheus(
        prom.read_text())
    if not lines or bad:
        fail(f"soak {name}: {len(lines)} stream lines, schema errors "
             f"{bad[:5]}")
    lat = {k: timings.get(k) for k in ("serve.fleet.request_latency",
                                       "serve.fleet.predict")}
    return dict(driver=drv, verdict=verdict, seconds=secs,
                wave_hist_launches=wave_launches,
                forest_launches=fp_launches, forest_routes=fp_routes,
                peak_gb=peak_gb, stream_lines=len(lines),
                scrape_bytes=len(body), latency=lat,
                windows=soak_windows(drv), gc_s=gc_s[0], gc_runs=gc_s[1])


def _gate_line(name, g, slo) -> str:
    """One gate's value; the slo gate with each objective's observation."""
    keep = {k: v for k, v in g.items()
            if k not in ("per_tenant", "tenants", "windows_trained",
                         "windows_expected", "tenant_errors")}
    if name == "slo":
        keep["objectives"] = {o["name"]: [o["observed"], o["comparator"],
                                          o["target"], o["ok"]]
                              for o in slo.get("objectives", [])}
    return f"{name}={json.dumps(keep, sort_keys=True, default=str)}"


def phase_soak(dev, seed: int, train, models, x, y):
    """The fleet chaos soak on the card (the module docstring's phase
    15)."""
    import tempfile
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.obs import profile as obs_profile
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.robust.retry import CircuitBreaker
    from lightgbm_tpu_torch.serve import PredictionServer, engine
    t_phase = time.perf_counter()
    vm = _validator()
    out = {}
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        # (1) the main soak
        sc = _soak_scenario(seed)
        fb0 = fallback_total()
        run = _run_soak("main", sc, dev, tmp, vm)
        v = run["verdict"]
        drv = run["driver"]
        gates = v["gates"]
        counters = v["counters"]
        tp = gates["throughput"]
        ident = gates["resume_byte_identity"]
        killed = [r["tenant"] for r in ident["tenants"]]
        for name, g in gates.items():
            print(f"soak (1) gate {_gate_line(name, g, v['slo'])}",
                  flush=True)
        fails = [n for n, g in gates.items() if not g["ok"]]
        # chip_pending is false exactly when the soak trained on the card
        if not v["ok"] or fails or v["chip_pending"] != (dev.type != "cuda"):
            fail(f"soak (1): verdict ok={v['ok']} chip_pending="
                 f"{v['chip_pending']}, failing gates {fails}")
        if counters.get("serve.fleet.fallback_requests", 0) \
                or fallback_total() != fb0:
            fail("soak (1): requests answered by the host walk")
        export = gates["export"]["stats"]
        if export.get("dropped", 0) or export.get("write_errors", 0):
            fail(f"soak (1): exporter {export}")
        if not killed or not all(r["byte_identical"]
                                 for r in ident["tenants"]):
            fail(f"soak (1): resume byte identity {ident}")
        if run["wave_hist_launches"] <= 0 or run["forest_launches"] <= 0:
            fail(f"soak (1): kernel launches wave_hist "
                 f"{run['wave_hist_launches']}, forest_predict "
                 f"{run['forest_launches']}")
        texts = {m: hashlib.sha256(drv._final_models[m].encode())
                 .hexdigest() for m in killed}
        req = run["latency"]["serve.fleet.request_latency"] or {}
        pred = run["latency"]["serve.fleet.predict"] or {}
        out["main"] = dict(
            scenario=sc.to_json(), gates=gates, ok=v["ok"],
            chip_pending=v["chip_pending"], load=v["load"],
            kills=v["kills"], counters=counters,
            seconds=run["seconds"], peak_gb=run["peak_gb"],
            wave_hist_launches=run["wave_hist_launches"],
            forest_launches=run["forest_launches"],
            forest_routes=run["forest_routes"],
            stream_lines=run["stream_lines"],
            scrape_bytes=run["scrape_bytes"], latency=run["latency"],
            killed_final_sha256=texts,
            timeline_digest=v["timeline_digest"],
            windows=run["windows"], gc_s=run["gc_s"])
        for w in run["windows"]:
            print(f"soak (1) window {json.dumps(w, sort_keys=True)}",
                  flush=True)
        print(f"soak (1) main: {sc.tenants} tenants x {sc.windows} windows "
              f"of {sc.requests_per_window} requests ({sc.sample_rows} "
              f"sampled rows, 53 columns, {sc.num_leaves} leaves, max_bin "
              f"{sc.max_bin}, {sc.num_iterations} iterations), "
              f"{sc.replicas} replicas: verdict ok, chip_pending "
              f"{str(v['chip_pending']).lower()}, "
              f"train_s_per_1M_sampled_rows "
              f"{tp['train_s_per_1M_sampled_rows']} (gate "
              f"{tp['reference_s_per_1M'] * 1.5:.3f}); requests p50 "
              f"{req.get('p50_s', 0) * 1e3:.3f} ms p95 "
              f"{req.get('p95_s', 0) * 1e3:.3f} ms ({req.get('count')} "
              f"requests), fleet predict p50 "
              f"{pred.get('p50_s', 0) * 1e3:.3f} ms p95 "
              f"{pred.get('p95_s', 0) * 1e3:.3f} ms; launches wave_hist "
              f"{run['wave_hist_launches']}, forest_predict "
              f"{run['forest_launches']} {run['forest_routes']}; 0 "
              f"fallback requests, exporter {export}, "
              f"{run['stream_lines']} stream lines schema-valid, scrape "
              f"{run['scrape_bytes']} bytes; killed tenant(s) {killed} "
              f"final text == the unfaulted replay's (sha256 {texts}); "
              f"peak card memory {run['peak_gb']:.2f} GB; garbage "
              f"collection {run['gc_s']:.3f} s in {run['gc_runs']} runs; "
              f"{run['seconds']:.1f} s", flush=True)
        del drv, run

        # (2) the forced-fail soak: a persistent device death
        sc2 = _soak_scenario(
            seed, tenants=SOAK_FAIL_TENANTS, windows=SOAK_FAIL_WINDOWS,
            sample_rows=SOAK_FAIL_SAMPLE,
            requests_per_window=2 * SOAK_FAIL_SAMPLE, device_deaths=1,
            device_death_burst=3, device_death_persist=True)
        fb0 = engine.FALLBACK_COUNTS["fleet"]
        run2 = _run_soak("fail", sc2, dev, tmp, vm)
        v2, drv2 = run2["verdict"], run2["driver"]
        fails2 = sorted(n for n, g in v2["gates"].items() if not g["ok"])
        fb2 = v2["counters"].get("serve.fleet.fallback_requests", 0)
        for name in fails2:
            print(f"soak (2) gate "
                  f"{_gate_line(name, v2['gates'][name], v2['slo'])}",
                  flush=True)
        if v2["ok"] or fails2 != ["availability", "slo"] or fb2 <= 0 \
                or engine.FALLBACK_COUNTS["fleet"] - fb0 != fb2:
            fail(f"soak (2): verdict ok={v2['ok']}, failing gates "
                 f"{fails2} (want availability, slo), fallback requests "
                 f"{fb2}")
        # the fallback answers against the host walk of the same trees,
        # loaded from the tenants' final model texts
        faults.configure("serve.fleet.dispatch:persist")
        worst = 0.0
        try:
            for m in range(sc2.tenants):
                q = sc2.query_block(m)
                got = drv2.fleet.predict(m, q, raw_score=True)
                ref = np.zeros(len(q))
                for t in GBDT.load_model_from_string(
                        drv2._final_models[m]).models:
                    ref += t.predict(q)
                worst = max(worst, float(np.abs(got - ref).max()))
        finally:
            faults.clear()
        if worst > 1e-12:
            fail(f"soak (2): fallback answers differ from the host walk "
                 f"by {worst:.3g}")
        avail = v2["gates"]["availability"]
        out["fail"] = dict(
            scenario=sc2.to_json(), failing_gates=fails2,
            fallback_requests=fb2, availability=avail,
            fallback_vs_host_max_abs=worst, seconds=run2["seconds"],
            wave_hist_launches=run2["wave_hist_launches"],
            forest_launches=run2["forest_launches"],
            forest_routes=run2["forest_routes"], counters=v2["counters"])
        print(f"soak (2) forced fail ({sc2.tenants} tenants x "
              f"{sc2.windows} windows, {sc2.sample_rows} sampled rows, a "
              f"persistent device death after {sc2.device_death_burst}"
              f"-failure bursts): verdict failed exactly {fails2}, "
              f"availability {avail['observed']} (dark fraction "
              f"{avail['dark_fraction']}), {fb2} fallback requests, their "
              f"answers within {worst:.2g} of the host walk of the final "
              f"texts (bar 1e-12); launches wave_hist "
              f"{run2['wave_hist_launches']}, forest_predict "
              f"{run2['forest_launches']}; {run2['seconds']:.1f} s",
              flush=True)
        del drv2, run2
    obs.configure(enabled=False)
    obs.reset()

    # (3) one degrade cycle on PredictionServer, the higgs model
    srv = PredictionServer(lt.Booster(model_str=models["higgs"]),
                           device=dev, breaker=CircuitBreaker(
                               failure_threshold=3,
                               reprobe_interval_s=DEGRADE_REPROBE_S))
    srv.warmup()
    q = x[:DEGRADE_ROWS]
    obs.configure(enabled=True)
    obs.reset()
    fb0 = engine.FALLBACK_COUNTS["server"]
    faults.configure("serve.dispatch:n=3")
    try:
        before = forest_counts()
        host = [srv.predict(q, raw_score=True) for _ in range(3)]
        dark_launches, _ = counts_since(before)
        degraded = srv.degraded
        time.sleep(DEGRADE_REPROBE_S * 1.25)
        before = forest_counts()
        dev_ans = srv.predict(q, raw_score=True)
        cyc_launches, cyc_routes = counts_since(before)
    finally:
        faults.clear()
    reg = obs.registry()
    dtime = reg.timing("serve.degraded_time")
    gauge = reg.gauge("serve.degraded")
    fb = engine.FALLBACK_COUNTS["server"] - fb0
    host_err = max(float(np.abs(h - dev_ans).max()) for h in host)
    host_ok = all(np.allclose(h, dev_ans, rtol=1e-5, atol=1e-6)
                  for h in host)
    obs.configure(enabled=False)
    obs.reset()
    if not (degraded and fb == 3 and dark_launches == 0 and host_ok
            and cyc_launches == 1 and dtime is not None
            and dtime.count == 1 and gauge == 0 and not srv.degraded):
        fail(f"soak (3) degrade cycle: degraded after 3 failures "
             f"{degraded}, fallback answers {fb}, launches while dark "
             f"{dark_launches}, host within rtol 1e-5 atol 1e-6 {host_ok} "
             f"({host_err:.3g}), launches after the re-probe "
             f"{cyc_launches}, degraded_time {dtime}, gauge {gauge}")
    out["degrade"] = dict(fallback_answers=fb, host_vs_kernel_max_abs=host_err,
                          probe_launches=cyc_launches,
                          probe_routes=cyc_routes,
                          degraded_time_s=dtime.to_dict()["total_s"])
    print(f"soak (3) degrade cycle: serve.dispatch:n=3 -> 3 host answers "
          f"(0 launches), degraded; host vs kernel {host_err:.2g} (rtol "
          f"1e-5, atol 1e-6); after {DEGRADE_REPROBE_S} s the re-probe "
          f"launched forest_predict once {cyc_routes}, serve.degraded_time "
          f"{dtime.to_dict()['total_s']:.3f} s, serve.degraded gauge 0",
          flush=True)
    del srv
    _FALLBACK_SEEN[0] = fallback_total()

    # (4) profile_phases on the higgs grower, against the train phase's
    # per-iteration s/tree
    params = {**TRAIN_BASE, **TRAIN_RUNS["higgs"], "device": dev.type}
    xt = torch.from_numpy(x).to(dev)
    ds = lt.Dataset(xt, y, params=dict(params)).construct()
    hist_cuda.wave_hist.launches.reset()
    bst = lt.train(params, ds, 1, verbose_eval=False)
    grower = bst._gbdt._grower
    obs.configure(enabled=True, profile_attribution=True)
    rng = np.random.default_rng(seed)
    grad = rng.standard_normal(N_ROWS).astype(np.float32)
    hess = np.abs(grad) + np.float32(0.1)
    res = grower.profile_phases(grad, hess, reps=PROFILE_REPS)
    prof_launches = hist_cuda.wave_hist.launches.read()
    obs.configure(enabled=False, profile_attribution=False)
    obs.reset()
    hi = train["runs"]["higgs"]["per_iteration"]
    s_tree = float(np.median(hi["dispatch_s"][1:]))
    waves = float(hi["waves_per_tree"])
    phases = {k: res[k] for k in obs_profile.PHASES}
    report = obs_profile.attribution_report(
        s_tree * 1e3, {k: v * waves for k, v in phases.items()},
        res["costs"])
    roof = {}
    for k, ms in phases.items():
        c = res["costs"][k]
        bps = c["bytes_accessed"] / (ms * 1e-3) if ms > 0 else None
        ops = c["flops"] / (ms * 1e-3) if ms > 0 else None
        roof[k] = dict(ms=ms, cost=c, bytes_per_s=bps,
                       bytes_share=None if bps is None
                       else bps / HBM_BYTES_PER_S,
                       ops_share=None if ops is None
                       else ops / F32_OPS_PER_S)
        print(f"soak (4) profile_phases {k}: {ms:.4f} ms (CUDA events, "
              f"mean of {PROFILE_REPS}, dispatch floor "
              f"{res['dispatch_floor']:.4f} ms off), "
              f"{c['bytes_accessed'] / 1e6:.2f} MB and "
              f"{c['flops'] / 1e6:.2f} M ops counted: "
              + ("not timed" if bps is None else
                 f"{bps / 1e9:.1f} GB/s = {bps / HBM_BYTES_PER_S:.2%} of "
                 f"3.35 TB/s, {ops / F32_OPS_PER_S:.3%} of 67 TFLOP/s"),
              flush=True)
    print(f"soak (4) attribution: phase ms x waves / measured tree = "
          f"{report['attributed_ratio']} (uncapped; printed, not gated): "
          f"{report['attributed_ms']} ms attributed against "
          f"{s_tree * 1e3:.3f} ms a tree per iteration (train phase, "
          f"higgs) at {waves:.2f} waves a tree, every probe at the full "
          f"width; wave_hist launches {prof_launches} (1 round + the "
          f"probes)", flush=True)
    out["profile"] = dict(phases_ms=phases,
                          dispatch_floor_ms=res["dispatch_floor"],
                          report=report, roofline=roof,
                          s_per_tree=s_tree, waves_per_tree=waves,
                          wave_hist_launches=prof_launches)
    del bst, grower, ds, xt
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = (out["main"]["wave_hist_launches"]
                       + out["fail"]["wave_hist_launches"] + prof_launches)
    out["predict_launches"] = (out["main"]["forest_launches"]
                               + out["fail"]["forest_launches"]
                               + out["degrade"]["probe_launches"])
    out["predict_routes"] = {
        k: (out["main"]["forest_routes"][k] + out["fail"]["forest_routes"][k]
            + out["degrade"]["probe_routes"][k])
        for k in out["main"]["forest_routes"]}
    print(f"phase soak: ok in {out['seconds']:.1f} s", flush=True)
    return out


#: the stream phase's CSV: HIGGS's shape, 500,000 rows
STREAM_ROWS = 500_000
STREAM_BASE = {**TRAIN_BASE, "num_leaves": 255}
#: the shard and parallel phases' mesh: four shards of the one card
SHARDS = 4
SHARD_RUNS = ("higgs", "int8", "harness")
#: learning rate 0.3: five rounds of 31 leaves at 0.1 leave even the serial
#: learner below AUC_FLOOR on this data (0.7917 on 300,000 rows)
PAR_BASE = {"objective": "binary", "max_bin": 255, "learning_rate": 0.3,
            "num_leaves": 31, "verbose": -1, "device_growth": "off"}
PAR_ROUNDS = 5
PAR_SAMPLE = 200_000        # construct_pre_partitioned's sample a shard
PAR_KINDS = ("data", "feature", "voting")


def stream_sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def phase_stream(dev, seed: int, tmp):
    """Phase stream: the two-round load and the CLI on a HIGGS-shaped CSV
    of STREAM_ROWS rows (written here, the values rounded to 4 decimals
    and printed with 4, so the file holds the matrix exactly): (1) load_text_two_round with the whole
    file sampled, codes and mappers byte-equal to Dataset on the matrix
    in memory; (2) at the default 200,000-row sample, round one, round
    two; (3) task=train two_round=true through the CLI's entry point
    (cli.main, in this process) on the card, 10 rounds, kernel 1's
    launches counted; (4) task=predict through the CLI's chunked
    run_predict, the file equal to Booster.predict of the same rows
    written with %g."""
    import io
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import stream_loader
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.ops import hist_cuda
    t0 = time.perf_counter()
    x, y = higgs_shape(STREAM_ROWS, seed + 2)
    x64 = np.round(x.astype(np.float64), 4)
    path = os.path.join(tmp, "higgs_stream.csv")
    np.savetxt(path, np.column_stack([y, x64]), delimiter=",", fmt="%.4f")
    write_s = time.perf_counter() - t0
    del x
    params = {**STREAM_BASE, "device": dev.type}

    # (1) the whole file sampled: the in-memory construction's codes
    full = Config({**params, "bin_construct_sample_cnt": STREAM_ROWS})
    t0 = time.perf_counter()
    sds, label = stream_loader.load_text_two_round(path, full)
    load_full_s = time.perf_counter() - t0
    mem = BinnedDataset.construct_from_matrix(x64, full)
    state = lambda ds: [repr(sorted(m.to_state().items()))
                        for m in ds.bin_mappers]
    if not np.array_equal(sds.binned, mem.binned) \
            or state(sds) != state(mem):
        fail("stream: two-round codes or mappers differ from the "
             "in-memory Dataset's")
    if not np.array_equal(label, y.astype(np.float64)):
        fail("stream: two-round labels differ from the file's")
    del mem, sds

    # (2) the default sample, each round timed
    cfg = Config(params)
    fmt = stream_loader._Format(path, cfg)
    t0 = time.perf_counter()
    sample, n_total, num_cols = stream_loader._round_one(path, fmt, cfg)
    t1 = time.perf_counter()
    ds = BinnedDataset.construct_streaming_begin(sample, n_total, num_cols,
                                                 cfg)
    t2 = time.perf_counter()
    stream_loader._round_two(path, fmt, ds, num_cols, n_total)
    t3 = time.perf_counter()
    rounds = dict(round_one_s=t1 - t0, bins_s=t2 - t1, round_two_s=t3 - t2)
    if n_total != STREAM_ROWS or len(sample) != min(
            STREAM_ROWS, cfg.bin_construct_sample_cnt):
        fail(f"stream: round one counted {n_total} rows, sampled "
             f"{len(sample)}")
    del ds, sample

    # (3) the CLI trains on the card from the streamed file
    model = os.path.join(tmp, "stream_model.txt")
    argv = ["task=train", f"data={path}", "two_round=true",
            f"device={dev.type}", f"output_model={model}",
            f"num_iterations={ROUNDS}", "verbosity=-1"] + \
        [f"{k}={v}" for k, v in STREAM_BASE.items() if k != "verbose"]
    hist_cuda.wave_hist.launches.reset()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        fail("stream: the CLI's two_round training exited non-zero")
    torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    launches = hist_cuda.wave_hist.launches.read()
    if launches <= 0:
        fail("stream: the CLI's training launched kernel 1 no time")
    text = Path(model).read_text()
    auc = auc_of(y, lt.Booster(model_str=text).predict(x64))
    if auc < AUC_FLOOR:
        fail(f"stream: training AUC {auc:.4f} < {AUC_FLOOR}")

    # (4) the chunked prediction, against Booster.predict of the rows
    out = os.path.join(tmp, "stream_pred.txt")
    before = forest_counts()
    t0 = time.perf_counter()
    if cli.main(["task=predict", f"data={path}", f"input_model={model}",
                 f"output_result={out}", f"device={dev.type}",
                 "device_predict_min_rows=1", "verbosity=-1"]) != 0:
        fail("stream: the CLI's prediction exited non-zero")
    predict_s = time.perf_counter() - t0
    fp_launches, fp_routes = counts_since(before)
    booster = lt.Booster(model_str=text,
                         params={"device": dev.type,
                                 "device_predict_min_rows": 1})
    want = io.StringIO()
    np.savetxt(want, np.asarray(booster.predict(x64)).reshape(-1, 1),
               delimiter="\t", fmt="%g")
    if Path(out).read_text() != want.getvalue():
        fail("stream: the CLI's chunked predictions differ from "
             "Booster.predict's")
    r = dict(rows=STREAM_ROWS, write_s=write_s,
             load_full_sample_s=load_full_s, **rounds, cli_train_s=train_s,
             s_per_tree=train_s / ROUNDS, predict_s=predict_s, auc=auc,
             launches=launches, predict_launches=fp_launches,
             predict_routes=fp_routes, model_sha256=trees_sha256(text))
    print(f"phase stream: ok {STREAM_ROWS} rows (file written in "
          f"{write_s:.1f} s; the whole file sampled: codes and mappers "
          f"equal to the in-memory Dataset's, {load_full_s:.1f} s); "
          f"round one {r['round_one_s']:.2f} s, bins {r['bins_s']:.2f} s, "
          f"round two {r['round_two_s']:.2f} s; CLI train {train_s:.2f} s "
          f"({r['s_per_tree']:.4f} s/tree with both rounds, {launches} "
          f"wave_hist launches), AUC {auc:.4f}; CLI predict "
          f"{predict_s:.2f} s, equal to Booster.predict at %g", flush=True)
    return r


def shard_wave_check(grower, dev):
    """One wave of a trained sharded grower's state: the shards' reduced
    histograms against the unsharded kernel-1 launch over the same
    leaves, in the grower's regime and in f32: bit-equal."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda
    st = grower._st
    w = grower.wave_width
    pending = torch.arange(w, dtype=torch.int32, device=dev)
    kw = dict(g=grower.num_groups, nb=grower.nb, k=grower.hist_cols, w=w,
              leaf_bound=grower.num_leaves)
    regimes = [(st.gh, None if grower.quant_bits else st.scale_exp)]
    gh32 = st.gh.float().contiguous()
    regimes.append((gh32, hist_cuda.hist_scale_exponents(
        gh32, grower.exp_rows)))
    for gh, scale in regimes:
        a = hist_cuda.wave_hist_sharded(grower._shard_codes, st.leaf_id, gh,
                                        pending, scale_exp=scale, **kw)
        b = hist_cuda.wave_hist(grower.binned_t, st.leaf_id, gh, pending,
                                scale_exp=scale, **kw)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"shard: a wave's reduced histogram ({gh.dtype}) differs "
                 f"from the unsharded launch")
    return [str(gh.dtype) for gh, _ in regimes]


def measure_sharded_case(dev, seed, n=N_ROWS, mode="sharded"):
    """wave_hist_sharded at the shard phase's shape (the pod phase's:
    ``n`` rows, ``mode`` "pod"): n x 28 rows in SHARDS row blocks of
    shard_local_rows, NB=256, K=3 bf16, W=128: bit-equal to the unsharded
    launch and to wave_hist_fixed_reference; kernel, plain version and one
    index_put_ timed."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import hist_cuda, shard
    g, nb, k, w = N_FEATURES, 256, 3, 128
    bins, leaf, ghk, pending = kernel_case(dev, nb=nb, k=k, w=w, quant=False,
                                           seed=seed, n=n)
    n = bins.shape[1]
    local = shard.shard_local_rows(n, SHARDS, Config({}))
    codes = [bins[:, a:a + local].contiguous() for a in range(0, n, local)]
    kw = dict(g=g, nb=nb, k=k, w=w, leaf_bound=2 * w + 1)
    scale = hist_cuda.hist_scale_exponents(ghk, n)
    run = lambda: hist_cuda.wave_hist_sharded(codes, leaf, ghk, pending,
                                              scale_exp=scale, **kw)
    a = run()
    whole = hist_cuda.wave_hist(bins, leaf, ghk, pending, scale_exp=scale,
                                **kw)
    exact = bool(torch.equal(a.view(torch.int32), whole.view(torch.int32))
                 and torch.equal(a.view(torch.int32),
                                 hist_cuda.wave_hist_fixed_reference(
                                     bins, leaf, ghk, pending, scale, g=g,
                                     nb=nb, k=k, w=w).view(torch.int32)))
    kw_p = dict(g=g, nb=nb, k=k, w=w)
    ref = hist_cuda.wave_hist_reference(bins, leaf, ghk, pending, **kw_p)
    err = float((a.double() - ref.double()).abs().max())
    ms = time_ms(run, reps=20)
    plain_ms = time_ms(lambda: hist_cuda.wave_hist_reference(
        bins, leaf, ghk, pending, **kw_p), reps=2, warmup=1)
    lib_run, _, m, lib_call = library_hist(bins, leaf, ghk, pending, **kw_p)
    library_ms = time_ms(lib_run, reps=3, warmup=1)
    bytes_ = n * (g + 4) + m * ghk.element_size() * k + g * nb * k * w * 4
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = m * g * k / F32_OPS_PER_S * 1e3
    r = dict(kernel="wave_hist", mode=mode, shards=len(codes),
             rows=n, local_rows=local, rows_in_wave=m, exact=exact, ok=exact,
             tolerance="bit-equal to the unsharded launch and to "
             "wave_hist_fixed_reference", max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
             library_call=lib_call, bytes_bound_ms=bound_bytes_ms,
             ops_bound_ms=ops_ms, bound_ms=max(bound_bytes_ms, ops_ms),
             bound_by="bytes" if bound_bytes_ms >= ops_ms else "operations",
             tc_ms=None)
    print(f"  kernel wave_hist {mode} bf16 n={n} in {len(codes)} shards of "
          f"{local} G={g} NB={nb} K={k} W={w}: exact={exact} max_abs_err="
          f"{err:.3g} kernel {ms:.3f} ms, bound {r['bound_ms'] * 1e3:.1f} "
          f"us ({r['bound_by']}), plain {plain_ms:.2f} ms, library "
          f"{library_ms:.2f} ms", flush=True)
    del bins, leaf, ghk, pending, codes, a, whole, ref, lib_run
    torch.cuda.empty_cache()
    if not exact:
        fail("wave_hist_sharded differs from the unsharded kernel 1")
    return r


def phase_shard(dev, seed: int, dense):
    """Phase shard: the device grower over SHARDS shards of the card
    (``GBDT.mesh``, data_sharding=single_controller) on the train phase's
    2M x 28 codes, the higgs, int8 and harness configurations, ROUNDS
    fused trees each, sharded and unsharded: the model texts' sha256
    must be equal; then one more fused chunk of each timed (s/tree), the
    shard launches (SHARDS a wave, the warm-up waves included) and one
    wave's reduced histograms bit-equal to the unsharded launch."""
    import torch
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import hist_cuda
    mesh = [dev] * SHARDS
    runs, launches_all, sharded_launches = {}, 0, 0
    case = measure_sharded_case(dev, seed=400)
    for name in SHARD_RUNS:
        out = {}
        for label, m in (("unsharded", None), ("sharded", mesh)):
            clear_growers(dev)
            cfg = Config({**TRAIN_BASE, **TRAIN_RUNS[name],
                          "data_sharding": "single_controller",
                          "device": dev.type})
            gb = create_boosting(cfg)
            gb.mesh = m
            hist_cuda.wave_hist.launches.reset()
            hist_cuda.wave_hist_sharded.launches.reset()
            gb.init_train(dense)
            if (gb._grower.mesh is not None) != (m is not None):
                fail(f"shard: {name} {label} grower mesh "
                     f"{gb._grower.mesh}")
            gb.train_chunked(ROUNDS, chunk=ROUNDS)
            torch.cuda.synchronize(dev)
            text = gb.model_to_string()
            waves = sum(int(s[2]) for s in gb.tree_stats)
            warm = gb._grower.capture_stats["warmup_waves"]
            t0 = time.perf_counter()
            gb.train_chunked(ROUNDS, chunk=ROUNDS)
            torch.cuda.synchronize(dev)
            s_tree = (time.perf_counter() - t0) / ROUNDS
            waves_all = sum(int(s[2]) for s in gb.tree_stats)
            v1 = hist_cuda.wave_hist.launches.read()
            sh = hist_cuda.wave_hist_sharded.launches.read()
            launches_all += v1
            res = dict(sha256=trees_sha256(text), s_per_tree=s_tree,
                       waves_first_chunk=waves, waves=waves_all,
                       warmup_waves=warm, wave_hist_launches=v1,
                       shard_launches=sh)
            if m is not None:
                if sh != SHARDS * (waves_all + warm) or v1 != sh:
                    fail(f"shard: {name}: {sh} shard launches, {v1} kernel "
                         f"1 launches for {waves_all} waves + {warm} "
                         f"warm-up ({SHARDS} shards)")
                sharded_launches += sh
                res["launches_per_wave"] = sh / (waves_all + warm)
                res["wave_check"] = shard_wave_check(gb._grower, dev)
            out[label] = res
            del gb
        if out["sharded"]["sha256"] != out["unsharded"]["sha256"]:
            fail(f"shard: {name}: sharded model text "
                 f"{out['sharded']['sha256'][:12]} != unsharded "
                 f"{out['unsharded']['sha256'][:12]}")
        runs[name] = out
        print(f"  shard {name}: model text sha256 "
              f"{out['sharded']['sha256'][:16]} sharded == unsharded; "
              f"fused s/tree sharded {out['sharded']['s_per_tree']:.4f} "
              f"against unsharded {out['unsharded']['s_per_tree']:.4f}; "
              f"kernel 1 {out['sharded']['launches_per_wave']:.0f} "
              f"launches a wave; a wave's reduced histograms bit-equal "
              f"({', '.join(out['sharded']['wave_check'])})", flush=True)
    clear_growers(dev)
    print(f"phase shard: ok {len(runs)} configurations over {SHARDS} "
          f"shards of {dev}, every sha256 equal to the unsharded run's",
          flush=True)
    return dict(runs=runs, case=case, launches=launches_all,
                sharded_launches=sharded_launches)


def measure_parallel_rows_case(dev, seed, n=N_ROWS, m=1_234_567):
    """wave_hist_rows_sharded at the parallel phase's shape: a ragged leaf
    window of m permuted rows of 2M x 28, f32 stats, split over SHARDS
    row shards as the data-parallel learner splits them: bit-equal to one
    launch over the window and to wave_hist_rows_fixed_reference;
    kernel, plain version and one index_add_ timed."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.ops.histogram import bucket_size
    g, nb, k = N_FEATURES, 256, 3
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, nb, (g, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    ghk = torch.stack([torch.randn(n, generator=gen, device=dev) * 0.5,
                       torch.rand(n, generator=gen, device=dev) * 0.25,
                       torch.ones(n, device=dev)], 1)
    rows = torch.randperm(n, generator=gen, device=dev).to(
        torch.int32)[(n - m) // 3:(n - m) // 3 + m]
    local = bucket_size(-(-n // SHARDS))
    shards = []
    for lo in range(0, n, local):
        hi = min(n, lo + local)
        mine = rows[(rows >= lo) & (rows < hi)] - lo
        shards.append((bins[:, lo:hi].contiguous(), ghk[lo:hi], mine))
    scale = hist_cuda.exponents_for_rows(ghk.abs().amax(0), m)
    kw = dict(g=g, nb=nb, k=k)
    run = lambda: hist_cuda.wave_hist_rows_sharded(shards, nb=nb, k=k,
                                                   scale_exp=scale)
    a = run()
    whole = hist_cuda.wave_hist_rows(bins, ghk, rows, scale_exp=scale, **kw)
    exact = bool(torch.equal(a.view(torch.int32), whole.view(torch.int32))
                 and torch.equal(a.view(torch.int32),
                                 hist_cuda.wave_hist_rows_fixed_reference(
                                     bins, ghk, rows, scale, **kw)
                                 .view(torch.int32)))
    ref = hist_cuda.wave_hist_rows_reference(bins, ghk, rows, **kw)
    err = float((a.double() - ref.double()).abs().max())
    ms = time_ms(run, reps=20)
    plain_ms = time_ms(lambda: hist_cuda.wave_hist_rows_reference(
        bins, ghk, rows, **kw), reps=2, warmup=1)
    r64 = rows.long()
    idx = bins[:, r64].long()
    idx += (torch.arange(g, device=dev) * nb)[:, None]
    idx = idx.reshape(-1)
    src = ghk[r64][None].expand(g, -1, -1).reshape(-1, k)
    table = torch.zeros((g * nb, k), device=dev)

    def lib():
        table.zero_()
        table.index_add_(0, idx, src)
    library_ms = time_ms(lib, reps=3, warmup=1)
    bytes_ = m * (4 + g + k * 4) + g * nb * k * 4
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = m * g * k / F32_OPS_PER_S * 1e3
    r = dict(kernel="wave_hist_rows", mode="parallel", shards=len(shards),
             rows=n, rows_in_wave=m, exact=exact, ok=exact,
             tolerance="bit-equal to one launch over the window and to "
             "wave_hist_rows_fixed_reference", max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
             library_call="index_add_", bytes_bound_ms=bound_bytes_ms,
             ops_bound_ms=ops_ms, bound_ms=max(bound_bytes_ms, ops_ms),
             bound_by="bytes" if bound_bytes_ms >= ops_ms else "operations",
             tc_ms=None)
    print(f"  kernel wave_hist_rows parallel f32 n={n} m={m} in "
          f"{len(shards)} row shards G={g} NB={nb} K={k}: exact={exact} "
          f"max_abs_err={err:.3g} kernel {ms:.3f} ms, bound "
          f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), plain "
          f"{plain_ms:.2f} ms, library {library_ms:.2f} ms", flush=True)
    del bins, ghk, rows, shards, a, whole, ref, idx, src, table, r64
    torch.cuda.empty_cache()
    if not exact:
        fail("wave_hist_rows_sharded differs from one list-mode launch")
    return r


def first_parting(a: str, b: str):
    """(tree, node, gain in a) of the first split where two model texts
    part (node and gain None: the same splits, other values), or None when
    their trees are equal."""
    ta = a.split("\nparameters:\n")[0].split("Tree=")[1:]
    tb = b.split("\nparameters:\n")[0].split("Tree=")[1:]
    field = lambda t, k: t.split(f"\n{k}=")[1].split("\n")[0].split()
    for i, (x, y) in enumerate(zip(ta, tb)):
        if x == y:
            continue
        for key in ("split_feature", "threshold", "left_child",
                    "right_child"):
            fx, fy = field(x, key), field(y, key)
            for j, (u, v) in enumerate(zip(fx, fy)):
                if u != v:
                    return i, j, float(field(x, "split_gain")[j])
        return i, None, None
    return None


def phase_parallel(dev, seed: int, x, y):
    """Phase parallel: the data-, feature- and voting-parallel learners
    over SHARDS workers of the card (``GBDT.mesh``, through
    create_tree_learner and the boosting loop), PAR_ROUNDS rounds of 31
    leaves on 2M x 28 binned by construct_pre_partitioned over SHARDS row
    blocks, against the serial host learner on the same dataset: the
    feature- and data-parallel trees byte-equal (the data-parallel
    histograms reduce in fixed point), voting with top_k covering every
    feature equal or its first parting split named; voting with top_k 5
    at training AUC >= AUC_FLOOR; the comm log's bytes a tree and s/tree
    of each."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.distributed import construct_pre_partitioned
    from lightgbm_tpu_torch.ops import hist_cuda
    case = measure_parallel_rows_case(dev, seed=500)
    t0 = time.perf_counter()
    ds, offsets = construct_pre_partitioned(
        np.array_split(x, SHARDS), Config(PAR_BASE),
        sample_per_shard=PAR_SAMPLE)
    ds.metadata.set_label(y)
    bin_s = time.perf_counter() - t0
    mesh = [dev] * SHARDS

    def run(kind, extra=None):
        clear_growers(dev)
        cfg = Config({**PAR_BASE, "tree_learner": kind, "device": dev.type,
                      "num_machines": 1 if kind == "serial" else SHARDS,
                      **(extra or {})})
        gb = create_boosting(cfg)
        gb.mesh = None if kind == "serial" else mesh
        gb.init_train(ds)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for _ in range(PAR_ROUNDS):
            gb.train_one_iter()
        torch.cuda.synchronize(dev)
        s_tree = (time.perf_counter() - t) / PAR_ROUNDS
        net = getattr(gb.learner, "net", None)
        comm = 0 if net is None else sum(b for v, b in net.comm_log
                                        if v == "allreduce")
        return gb, dict(s_per_tree=s_tree, learner=type(gb.learner).__name__,
                        allreduce_bytes_per_tree=comm / PAR_ROUNDS)

    serial, sres = run("serial")
    sres["auc"] = auc_of(y, serial.train_score[0].cpu().numpy())
    stext = serial.model_to_string().split("\nparameters:\n")[0]
    runs = {"serial": sres}
    del serial
    hist_cuda.wave_hist_rows_sharded.launches.reset()
    for kind in PAR_KINDS:
        extra = {"top_k": N_FEATURES} if kind == "voting" else None
        gb, res = run(kind, extra)
        text = gb.model_to_string().split("\nparameters:\n")[0]
        part = first_parting(stext, text)
        res["equal_to_serial"] = part is None
        if part is not None:
            res["first_parting"] = dict(tree=part[0], node=part[1],
                                        gain=part[2])
            if kind != "voting":
                fail(f"parallel: {kind}-parallel trees part from the "
                     f"serial learner's at tree {part[0]} node {part[1]} "
                     f"(gain {part[2]})")
        runs[kind] = res
        del gb
    launches = hist_cuda.wave_hist_rows_sharded.launches.read()
    gb, res = run("voting", {"top_k": 5})
    res["auc"] = auc_of(y, gb.train_score[0].cpu().numpy())
    if res["auc"] < AUC_FLOOR:
        fail(f"parallel: voting top_k 5 training AUC {res['auc']:.4f} < "
             f"{AUC_FLOOR}")
    runs["voting_top5"] = res
    del gb
    clear_growers(dev)
    if launches <= 0:
        fail("parallel: the list mode's sharded wrapper never launched")
    vt = runs["voting"]
    fp = vt.get("first_parting")
    parting = ("byte-equal" if fp is None else
               f"the same splits, values part in tree {fp['tree']}"
               if fp["node"] is None else
               f"part at tree {fp['tree']} split {fp['node']} (gain "
               f"{fp['gain']})")
    print(f"phase parallel: ok {SHARDS} workers on {dev}, "
          f"construct_pre_partitioned {bin_s:.1f} s; trees against the "
          f"serial learner: feature and data byte-equal, voting (top_k "
          f"{N_FEATURES}) {parting}; allreduce bytes a tree data "
          f"{runs['data']['allreduce_bytes_per_tree']:.0f} against voting "
          f"{runs['voting']['allreduce_bytes_per_tree']:.0f} (top_k 5: "
          f"{res['allreduce_bytes_per_tree']:.0f}); s/tree serial "
          f"{sres['s_per_tree']:.3f}, data {runs['data']['s_per_tree']:.3f}"
          f", feature {runs['feature']['s_per_tree']:.3f}, voting "
          f"{runs['voting']['s_per_tree']:.3f}; training AUC voting top_k "
          f"5 {res['auc']:.4f}, serial {sres['auc']:.4f}; {launches} "
          f"sharded list-mode launches",
          flush=True)
    return dict(runs=runs, case=case, binning_s=bin_s, launches=launches,
                offsets=[int(o) for o in offsets])


#: the pod phase: scripts/pod_cuda.py as every host, the stream phase's CSV
#: (its first POD_ROWS rows: each host parses every row of it, five loads a
#: run, ~12 s each at 500,000, ~4 at 100,000), the configurations of the
#: shard phase and the kill leg's (int8, 31 leaves, POD_KILL_ROUNDS rounds)
POD_ROWS = 50_000
POD_ROUNDS = ROUNDS
POD_KILL_ROUNDS = 6
POD_RUNS = {**{n: TRAIN_RUNS[n] for n in SHARD_RUNS},
            "kill": {"num_leaves": 31, "grad_quant_bits": 8}}
#: the hosts' socket policy: peers retry for round one's ~5 s on host 0;
#: the kill leg's short one bounds host 0's wait for the dead host's ack
#: (10 s)
POD_NET = {"network_timeout": 30, "network_retries": 20}
POD_NET_KILL = {"network_timeout": 1, "network_retries": 10}
POD_LEG_TIMEOUT = 300
POD_SCRIPT = ROOT / "scripts" / "pod_cuda.py"


def run_pod_leg(leg, hosts, csv, outdir, expected_exits=None,
                device="cuda"):
    """Launch scripts/pod_cuda.py ``hosts`` times (ranks 0..hosts-1, a free
    localhost port) and return each rank's report (None for the kill
    leg's victim); any other exit, or a leg past POD_LEG_TIMEOUT, fails
    the run (every process is stopped first)."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(hosts):
        log = open(os.path.join(outdir, f"{leg}_r{rank}.log"), "w")
        procs.append((rank, log, subprocess.Popen(
            [sys.executable, str(POD_SCRIPT), "--leg", leg, "--rank",
             str(rank), "--hosts", str(hosts), "--port", str(port),
             "--csv", csv, "--outdir", outdir, "--device", device],
            stdout=log,
            stderr=subprocess.STDOUT, cwd=str(ROOT))))
    deadline = time.monotonic() + POD_LEG_TIMEOUT
    exits = {}
    try:
        for rank, _, proc in procs:
            try:
                exits[rank] = proc.wait(timeout=max(
                    deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                exits[rank] = None
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    expected = expected_exits or {}
    for rank, code in exits.items():
        if code != expected.get(rank, 0):
            tail = Path(outdir, f"{leg}_r{rank}.log").read_text()[-3000:]
            fail(f"pod: leg {leg} rank {rank} of {hosts} exited {code} "
                 f"(timeout {POD_LEG_TIMEOUT} s if None):\n{tail}")
    out = []
    for rank in range(hosts):
        path = Path(outdir, f"{leg}_r{rank}.json")
        out.append(json.loads(path.read_text()) if path.exists() else None)
    return out


def phase_pod(dev, seed: int, tmp, csv):
    """Phase pod: the multi-controller pod on the card, one process a host
    (scripts/pod_cuda.py), every leg over the same four shards of the
    card (``shard_devices = 4 // hosts``), on the stream phase's CSV (its
    first POD_ROWS rows).
    Baseline: single-controller over four shards in this process, from
    load_text_two_round, each configuration's model text sha256.  Legs:
    (a) 4 processes, load_text_multihost once, 10 rounds each of higgs,
    int8 and harness: every rank's sha256 the baseline's; (b) 2
    processes through the CLI (task=train two_round=true
    data_sharding=multi_controller), higgs: the baseline's sha256; (c) 2
    processes, int8 at 31 leaves, snapshots at iterations 2 and 4, the
    last rank dying before it acks 4: iteration 2 committed, 4 not, host
    0's error naming host 1; a fresh pod refuses the uncommitted
    snapshot, resumes the committed one and ends on its own straight
    run's sha256, the baseline's.  Prints one line a leg: s/tree, kernel 1
    launches, the reduction's bytes and ms a wave (CUDA events around the
    host copies, the host clock around the gloo all-reduce), bring-up and
    load seconds, the card."""
    import torch
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data import stream_loader
    from lightgbm_tpu_torch.ops import hist_cuda
    t_phase = time.perf_counter()
    if POD_ROWS < STREAM_ROWS:
        head = os.path.join(tmp, "higgs_pod.csv")
        with open(csv) as src, open(head, "w") as dst:
            for _ in range(POD_ROWS):
                dst.write(src.readline())
        csv = head
    case = measure_sharded_case(dev, seed=401, n=POD_ROWS, mode="pod")
    # the baseline: single-controller, four shards of the card
    clear_growers(dev)
    t0 = time.perf_counter()
    ds, _ = stream_loader.load_text_two_round(csv, Config(
        {**TRAIN_BASE, "device": dev.type}))
    base_load_s = time.perf_counter() - t0
    base, base_launches = {}, 0
    for name, rounds in [(n, POD_ROUNDS) for n in SHARD_RUNS] + [
            ("kill", POD_KILL_ROUNDS)]:
        hist_cuda.wave_hist.launches.reset()
        gb = create_boosting(Config({**TRAIN_BASE, **POD_RUNS[name],
                                     "data_sharding": "single_controller",
                                     "device": dev.type}))
        gb.mesh = [dev] * SHARDS
        gb.init_train(ds)
        gb.train_chunked(rounds, chunk=rounds)
        base[name] = dict(sha256=trees_sha256(gb.model_to_string()))
        if name != "kill":
            # a second chunk timed (the first captures the tree's graph)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            gb.train_chunked(rounds, chunk=rounds)
            torch.cuda.synchronize(dev)
            base[name]["s_per_tree"] = (time.perf_counter() - t0) / rounds
        base_launches += hist_cuda.wave_hist.launches.read()
        gb.release_grower()
        del gb
    del ds
    clear_growers(dev)
    legs, worker_launches = {}, 0
    outdir = os.path.join(tmp, "pod")
    os.makedirs(outdir, exist_ok=True)

    # (a) 4 processes through the Python API
    t0 = time.perf_counter()
    reps = run_pod_leg("api", 4, csv, outdir, device=dev.type)
    legs["api"] = dict(seconds=time.perf_counter() - t0, ranks=reps)
    for rep in reps:
        for name in SHARD_RUNS:
            r = rep["runs"][name]
            if r["sha256"] != base[name]["sha256"]:
                fail(f"pod: leg a rank {rep['rank']} {name} sha256 "
                     f"{r['sha256'][:12]} != single-controller "
                     f"{base[name]['sha256'][:12]}")
            # (a CPU rehearsal's plain version counts no launch)
            if dev.type == "cuda" and (r["launches"] != r["waves"]
                                       or r["reductions"] != r["waves"]):
                fail(f"pod: leg a rank {rep['rank']} {name}: "
                     f"{r['launches']} kernel 1 launches, "
                     f"{r['reductions']} reductions for {r['waves']} waves "
                     f"(one shard a host)")
            worker_launches += r["launches"]
    r0 = reps[0]
    for name in SHARD_RUNS:
        r = r0["runs"][name]
        print("  pod " + json.dumps(dict(
            leg="a", hosts=4, config=name, s_per_tree=r["s_per_tree"],
            single_controller_s_per_tree=base[name]["s_per_tree"],
            kernel1_launches_rank0=r["launches"],
            reduce_bytes_per_wave=r["reduce_bytes_per_wave"],
            reduce_copy_ms_per_wave=r["reduce_copy_ms_per_wave"],
            reduce_allreduce_ms_per_wave=r["reduce_allreduce_ms_per_wave"],
            gather_ms_per_tree=r["gather_ms_per_tree"],
            setup_s=r0["setup_s"], load_s=r0["load_s"],
            card=r0["card"])), flush=True)

    # (b) 2 processes through the CLI
    t0 = time.perf_counter()
    reps = run_pod_leg("cli", 2, csv, outdir, device=dev.type)
    legs["cli"] = dict(seconds=time.perf_counter() - t0, ranks=reps)
    for rep in reps:
        if rep["sha256"] != base["higgs"]["sha256"]:
            fail(f"pod: leg b (CLI) rank {rep['rank']} sha256 "
                 f"{rep['sha256'][:12]} != single-controller "
                 f"{base['higgs']['sha256'][:12]}")
        if dev.type == "cuda" and rep["launches"] != 2 * rep["reductions"]:
            fail(f"pod: leg b rank {rep['rank']}: {rep['launches']} kernel "
                 f"1 launches for {rep['reductions']} reductions (two "
                 f"shards a host)")
        worker_launches += rep["launches"]
    r0 = reps[0]
    print("  pod " + json.dumps(dict(
        leg="b", hosts=2, config="higgs (CLI)", s_per_tree=r0["s_per_tree"],
        cli_train_s=r0["train_s"], kernel1_launches_rank0=r0["launches"],
        reduce_bytes_per_wave=r0["reduce_bytes_per_wave"],
        reduce_copy_ms_per_wave=r0["reduce_copy_ms_per_wave"],
        reduce_allreduce_ms_per_wave=r0["reduce_allreduce_ms_per_wave"],
        gather_ms_per_tree=r0["gather_ms_per_tree"], load_s=r0["load_s"],
        card=r0["card"])), flush=True)

    # (c) kill the last host before it acks iteration 4, then resume
    kill_dir = os.path.join(outdir, "kill")
    os.makedirs(kill_dir, exist_ok=True)
    t0 = time.perf_counter()
    reps_a = run_pod_leg("killA", 2, csv, kill_dir,
                         expected_exits={1: 17}, device=dev.type)
    a0 = reps_a[0]
    if not a0["commit2"] or a0["commit4"]:
        fail(f"pod: leg c commit markers: iteration 2 {a0['commit2']}, "
             f"iteration 4 {a0['commit4']} (want True, False)")
    if "no ack from host(s) [1]" not in (a0["ack_timeout_error"] or ""):
        fail(f"pod: leg c host 0's error does not name host 1: "
             f"{a0['ack_timeout_error']!r}")
    reps_b = run_pod_leg("killB", 2, csv, kill_dir, device=dev.type)
    legs["kill"] = dict(seconds=time.perf_counter() - t0, ranks_a=reps_a,
                        ranks_b=reps_b)
    for rep in reps_b:
        if "no pod commit marker" not in (rep["uncommitted_refused"] or ""):
            fail(f"pod: leg c rank {rep['rank']} resumed the uncommitted "
                 f"iteration-4 snapshot")
        if not rep["resumed_sha256"] == rep["straight_sha256"] == \
                base["kill"]["sha256"]:
            fail(f"pod: leg c rank {rep['rank']}: resumed "
                 f"{rep['resumed_sha256'][:12]}, straight "
                 f"{rep['straight_sha256'][:12]}, single-controller "
                 f"{base['kill']['sha256'][:12]}")
    print("  pod " + json.dumps(dict(
        leg="c", hosts=2, config="int8, 31 leaves",
        ack_wait_s=a0["ack_wait_s"], error=a0["ack_timeout_error"][:90],
        setup_s=reps_b[0]["setup_s"], load_s=reps_b[0]["load_s"],
        card=reps_b[0]["card"])), flush=True)
    out = dict(rows=POD_ROWS, base=base, base_load_s=base_load_s, legs=legs,
               case=case, worker_launches=worker_launches,
               launches=base_launches + worker_launches,
               seconds=time.perf_counter() - t_phase)
    print(f"phase pod: ok legs a (4 processes, API), b (2, CLI) and c (2, "
          f"kill and resume) equal to single-controller over {SHARDS} "
          f"shards of {dev} on {POD_ROWS} rows; kernel 1 launches in the "
          f"hosts {worker_launches}; {out['seconds']:.1f} s", flush=True)
    return out


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
    clock_case = phase_clock(dev)
    routing_cases = phase_routing(dev)
    from lightgbm_tpu_torch.ops import clock, routing
    clock.stamp.launches.reset()                  # the main path's stamps
    routing.split_rows.launches.reset()           # and row routings
    train, models, x, y, dense = phase_train(dev, args.seed, args.profile)
    check_no_fallback("train")
    clear_growers(dev)
    objectives = phase_objectives(dev, args.seed, x, dense, args.profile)
    check_no_fallback("objectives")
    clear_growers(dev)
    data = phase_data(dev, args.seed, dense, x, y, train, args.profile)
    check_no_fallback("data")
    clear_growers(dev)
    boosting = phase_boosting(dev, args.seed, dense, x, y)
    check_no_fallback("boosting")
    clear_growers(dev)
    routing0 = routing.split_rows.launches.read()
    window = phase_window20m(dev, args.seed, dense)
    window_routing = routing.split_rows.launches.read() - routing0
    check_no_fallback("window20m")
    clear_growers(dev)
    import tempfile
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        host = phase_host_learner(dev, args.seed, dense, x, y, tmp)
    check_no_fallback("host_learner")
    clear_growers(dev)
    with tempfile.TemporaryDirectory() as tmp:
        stream = phase_stream(dev, args.seed, tmp)
        check_no_fallback("stream")
        clear_growers(dev)
        pod = phase_pod(dev, args.seed, tmp,
                        os.path.join(tmp, "higgs_stream.csv"))
    check_no_fallback("pod")
    clear_growers(dev)
    shard = phase_shard(dev, args.seed, dense)
    check_no_fallback("shard")
    parallel = phase_parallel(dev, args.seed, x, y)
    check_no_fallback("parallel")
    del dense
    pipeline = phase_pipeline(dev, args.seed)
    check_no_fallback("pipeline")
    clear_growers(dev)
    capi = phase_capi(dev, args.seed)
    check_no_fallback("capi")
    clear_growers(dev)
    api = phase_api(dev, args.seed, x, y)
    check_no_fallback("api")
    clear_growers(dev)
    soak = phase_soak(dev, args.seed, train, models, x, y)
    check_no_fallback("soak")
    clear_growers(dev)
    del y
    serve = phase_serve(dev, models, x, args.seed)
    check_no_fallback("serve")
    del x
    multiclass = phase_multiclass(dev, args.seed, args.profile)
    check_no_fallback("multiclass")

    # wave_hist's path is training: its launches are those of every run
    # at K=3 (the pod phase's baseline and its hosts' processes too; the
    # data phase's two, the boosting phase's six, the
    # pipeline phase's windows and the capi phase's, in its native
    # subprocesses too, the api phase's trees and stage-plan probes and
    # the soak phase's windows, replays and probes included; window20m's
    # layouts are counted
    # in their own wave_hist:<mode> rows); wave_hist_v2's path is the ubench
    # entry point; forest_predict's is prediction: Booster.predict after
    # each training run and of the validation rows, the fleet's entry
    # point, the two PredictionServers, the pipeline's server (its
    # evaluations, swaps' warm-up and prober; not the comparison launches)
    # and the capi phase's (its native drivers' servers, fleet and
    # Booster predictions, and the in-process Booster.predict), the api
    # phase's (init scores and predictions), the soak phase's (its fleets'
    # tenant route and the degrade cycle's re-probe), and both of
    # its routes must have run there
    obj_runs = objectives["runs"].values()
    v1_launches = (sum(r["launches"] for r in train["runs"].values())
                   + sum(r["launches"] for r in obj_runs)
                   + data["launches"] + data["engine_launches"]
                   + boosting["launches"] + pipeline["launches"]
                   + capi["launches"]["wave_hist"]
                   + api["launches"] + soak["launches"]
                   + multiclass["launches"] + stream["launches"]
                   + shard["launches"] + pod["launches"])
    fp_launches = (sum(r["predict_launches"] for r in train["runs"].values())
                   + sum(r["predict_launches"] for r in obj_runs)
                   + data["predict_launches"]
                   + boosting["predict_launches"]
                   + window["predict_launches"]
                   + host["predict_launches"]
                   + pipeline["predict_launches"]
                   + capi["launches"]["forest_predict"]
                   + api["predict_launches"]
                   + soak["predict_launches"]
                   + serve["fleet_entry_launches"]
                   + serve["server"]["launches"]
                   + serve["server_syn"]["launches"]
                   + multiclass["predict_launches"]
                   + stream["predict_launches"])
    fp_routes = {k: (sum(r["predict_routes"][k]
                         for r in train["runs"].values())
                     + sum(r["predict_routes"][k] for r in obj_runs)
                     + data["predict_routes"][k]
                     + boosting["predict_routes"][k]
                     + window["predict_routes"][k]
                     + host["predict_routes"][k]
                     + pipeline["predict_routes"][k]
                     + capi["launches"]["routes"][k]
                     + api["predict_routes"][k]
                     + soak["predict_routes"][k]
                     + serve["fleet_entry_routes"][k]
                     + serve["server"]["routes"][k]
                     + serve["server_syn"]["routes"][k]
                     + multiclass["predict_routes"][k]
                     + stream["predict_routes"][k])
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
    # kernel 1's layouts and modes on this slice's paths: each mode's case
    # at the main path's shape beside the launches the mode made there
    # (the cases at other widths are in chip_smoke.json)
    wave_src = "lightgbm_tpu_torch/csrc/wave_hist.cu"
    wave_tpu = "lightgbm_tpu/ops/hist_pallas.py:218"
    by_mode = {c["mode"]: c for c in kernels["wave_hist"] if c.get("mode")}
    for mode, n_launch in window["launches_by_mode"].items():
        picks.append((f"wave_hist:{mode}", dict(by_mode[mode]), n_launch,
                      wave_src, wave_tpu))
    rows_cases = {c["name"]: c for c in kernels["wave_hist_rows"]}
    for key, n_launch in host["launches_by_case"].items():
        picks.append((f"wave_hist_rows:{key}", rows_cases[key], n_launch,
                      wave_src, wave_tpu))
    # the shard phase's per-shard launches and the parallel learners'
    # list-mode launches, each beside its case at the shard's shape
    picks.append(("wave_hist:sharded", shard["case"],
                  shard["sharded_launches"], wave_src, wave_tpu))
    picks.append(("wave_hist_rows:parallel", parallel["case"],
                  parallel["launches"], wave_src, wave_tpu))
    # the pod phase's hosts' own launches (2 and 4 processes over four
    # shards of the card), beside the sharded case at the pod's shape
    picks.append(("wave_hist:pod", pod["case"], pod["worker_launches"],
                  wave_src, wave_tpu))
    # the device clock's stamps on the main path (this process's growers:
    # every tree and wave of its training phases)
    picks.append(("obs_clock_stamp", clock_case, card_stamps(dev),
                  "lightgbm_tpu_torch/csrc/obs_clock.cu", None))
    # the wave's row routing: the main path's launches (this process's
    # growers, one a wave) beside the higgs case, the window20m phase's
    # beside the fork's
    route_src = "lightgbm_tpu_torch/csrc/split_rows.cu"
    route_xla = "lightgbm_tpu/ops/grow.py:869"
    picks.append(("split_rows", routing_cases["higgs"],
                  routing.split_rows.launches.read(), route_src, route_xla))
    picks.append(("split_rows:fork", routing_cases["fork"], window_routing,
                  route_src, route_xla))
    for name, _, n_launch, _, _ in picks:
        if n_launch <= 0:
            fail(f"{name} never launched on the main path")
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
                       kernels=kernels, ubench=ubench, clock=clock_case,
                       routing=routing_cases,
                       train=train,
                       objectives=objectives, data=data,
                       boosting=boosting, window20m=window,
                       host_learner=host, pipeline=pipeline,
                       capi=capi, api=api, soak=soak, serve=serve,
                       multiclass=multiclass, stream=stream, shard=shard,
                       parallel=parallel, pod=pod,
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
