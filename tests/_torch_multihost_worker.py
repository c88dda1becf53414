"""One pod host of the port's multi-controller tests
(tests/test_torch_multihost_pod.py): the counterpart of
``tests/_multihost_worker.py`` for ``lightgbm_tpu_torch``.

The test launches ``hosts`` copies with ranks 0..hosts-1 against a free
localhost port; each process runs ``4 // hosts`` CPU shards
(``shard_devices``), so every leg (2 or 4 processes) grows over the same
4-shard mesh as the in-process single-controller baseline.  Each process
loads the shared CSV with ``load_text_multihost`` (host 0 finds the bins,
every host bins its own row block), trains, prints one JSON line and
mirrors it to ``<outdir>/<scenario>_r<rank>.json``.  Torch runs on one
thread (``OMP_NUM_THREADS=1``, ``torch.set_num_threads(1)``).

Usage: python _torch_multihost_worker.py <scenario> <rank> <hosts> <port>
           <outdir> [device]
Scenarios: train | bf16 | bagff | killA | killB | deadcoord | cudahist
(``device`` cpu by default; the card tests of tests/test_torch_cuda.py
pass cuda.  ``cudahist``: kernel 1 over this host's two shards of seeded
inputs, reduced across the pod, in bf16, f32 and int8, saved as
``cudahist_r<rank>.pt``.)
"""

import json
import os
import socket
import subprocess
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")

TOTAL_SHARDS = 4
ROWS = 2500
FEATURES = 8
#: the JAX worker's BASE (tests/_multihost_worker.py), on the CPU
BASE = {
    "objective": "binary", "verbosity": -1, "device_growth": "on",
    "num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 5,
    "seed": 20260804, "wave_plan": "fixed", "grad_quant_bits": 8,
    "two_round": True, "device": "cpu",
}
BF16 = {"grad_quant_bits": 0}
BAGFF = {"bagging_fraction": 0.7, "bagging_freq": 2,
         "feature_fraction": 0.75}
SCENARIO_EXTRA = {"train": {}, "bf16": BF16, "bagff": BAGFF,
                  "killA": {}, "killB": {}}
CSV_NAME = "pod_train.csv"
CKPT2 = "pod_ck_iter2.txt"
CKPT4 = "pod_ck_iter4.txt"
#: killA's victim exits with this code (the intentional death)
KILLED_EXIT = 17
ITERS, CHUNK = 6, 2


def data_path(outdir):
    return os.path.join(outdir, CSV_NAME)


def write_csv(outdir):
    """The JAX worker's label-first CSV (the same bytes: the same
    reservoir sample, the same mappers on every loader path)."""
    import numpy as np
    rng = np.random.default_rng(11)
    x = rng.standard_normal((ROWS, FEATURES)).astype(np.float32)
    y = (x[:, 0] + np.abs(x[:, 1]) > 0.5).astype(np.float32)
    path = data_path(outdir)
    with open(path, "w") as fh:
        for i in range(ROWS):
            fh.write(",".join([repr(float(y[i]))]
                              + [repr(float(v)) for v in x[i]]) + "\n")
    return path


def trees_of(model_str):
    """The model text without its parameters echo (host_rank differs per
    host)."""
    return model_str.split("\nparameters:", 1)[0]


#: the device of this process's shards (argv[6])
DEVICE = ["cpu"]


def params(rank, hosts, port, extra=None):
    """A pod host's parameters (``hosts`` > 1), or the single-controller
    baseline's over TOTAL_SHARDS shards (``hosts`` 1)."""
    p = dict(BASE, device=DEVICE[0])
    if hosts > 1:
        p.update({"data_sharding": "multi_controller",
                  "coordinator_address": f"127.0.0.1:{port}",
                  "num_hosts": hosts, "host_rank": rank,
                  "shard_devices": TOTAL_SHARDS // hosts,
                  "network_timeout": 2, "network_retries": 5})
    else:
        p.update({"data_sharding": "single_controller",
                  "shard_devices": TOTAL_SHARDS})
    p.update(extra or {})
    return p


def load(p, csv):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.stream_loader import (load_text_multihost,
                                                       load_text_two_round)
    cfg = Config(p)
    if p.get("data_sharding") == "multi_controller":
        ds, _ = load_text_multihost(csv, cfg)
    else:
        ds, _ = load_text_two_round(csv, cfg)
    return cfg, ds


def boost(cfg, ds, mesh=None):
    from lightgbm_tpu_torch.boosting import create_boosting
    bst = create_boosting(cfg)
    bst.mesh = mesh
    bst.init_train(ds)
    return bst


def train(cfg, ds, iters=ITERS, chunk=CHUNK, mesh=None):
    bst = boost(cfg, ds, mesh)
    bst.train_chunked(iters, chunk=chunk)
    bst._flush_pending()
    return bst


# ---------------------------------------------------------------------------
# the launching side (tests/test_torch_multihost_pod.py,
# tests/test_torch_cuda.py)
def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_pod(scenario, hosts, outdir, timeout=120, expected_exits=None,
            device="cpu"):
    """Launch ``hosts`` ranks, wait for all, return each rank's JSON
    report (None for a rank that wrote none: killA's victim)."""
    outdir = str(outdir)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(hosts):
        log = open(os.path.join(outdir, f"{scenario}_r{rank}.log"), "w")
        procs.append((rank, log, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, str(rank),
             str(hosts), str(port), outdir, device], stdout=log,
            stderr=subprocess.STDOUT, env=env)))
    deadline = time.monotonic() + timeout
    exits = {}
    try:
        for rank, _, proc in procs:
            exits[rank] = proc.wait(timeout=max(deadline - time.monotonic(),
                                                1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"pod scenario {scenario} ({hosts} hosts) "
                             f"timed out after {timeout}s; see "
                             f"{outdir}/{scenario}_r*.log")
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    expected = expected_exits or {}
    for rank, code in exits.items():
        assert code == expected.get(rank, 0), \
            (f"{scenario} rank {rank} exited {code}; see "
             f"{outdir}/{scenario}_r{rank}.log")
    reports = []
    for rank in range(hosts):
        path = os.path.join(outdir, f"{scenario}_r{rank}.json")
        reports.append(json.load(open(path)) if os.path.exists(path)
                       else None)
    return reports


# ---------------------------------------------------------------------------
# the host side
def scenario_train(rank, hosts, port, outdir, extra=None):
    """6 iterations, chunks of 2: the trees, the layout digest, the
    shard.hosts and ingest.rows_per_s gauges and the reductions."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.pipeline.bins import reference_layout_digest
    from lightgbm_tpu_torch.utils.log import LightGBMError
    obs.configure(enabled=True)
    cfg, ds = load(params(rank, hosts, port, extra), data_path(outdir))
    bst = train(cfg, ds)
    gauges = obs.registry().snapshot()["gauges"]
    pod = bst._grower.pod
    out = {"trees": trees_of(bst.model_to_string()),
           "layout_digest": reference_layout_digest(ds),
           "row_span": list(ds.host_row_span),
           "hosts_gauge": gauges.get("shard.hosts"),
           "ingest_rows_per_s": gauges.get("ingest.rows_per_s"),
           "comm": pod.comm_summary()}
    # what needs every row's codes, or a per-host timing, is refused
    for name, fn in (("rollback", bst.rollback_one_iter),
                     ("profile", bst._grower.profile_stage_plan)):
        try:
            fn()
            out[f"{name}_refused"] = None
        except LightGBMError as e:
            out[f"{name}_refused"] = str(e)
    return out


def scenario_kill_a(rank, hosts, port, outdir):
    """The iteration-2 snapshot commits on every host, then the last rank
    dies before acking iteration 4: host 0 times out naming it and writes
    no commit marker."""
    from lightgbm_tpu_torch.robust.checkpoint import has_pod_commit
    from lightgbm_tpu_torch.utils.log import LightGBMError
    cfg, ds = load(params(rank, hosts, port), data_path(outdir))
    ck2 = os.path.join(outdir, CKPT2)
    ck4 = os.path.join(outdir, CKPT4)
    bst = boost(cfg, ds)
    bst.train_chunked(2, chunk=CHUNK)
    bst.save_checkpoint(ck2)
    bst.train_chunked(2, chunk=CHUNK)
    victim = hosts - 1
    if rank == victim:
        os._exit(KILLED_EXIT)
    err = None
    try:
        bst.save_checkpoint(ck4)
    except LightGBMError as e:
        err = str(e)
    return {"commit2": has_pod_commit(ck2), "commit4": has_pod_commit(ck4),
            "victim": victim, "ack_timeout_error": err}


def scenario_kill_b(rank, hosts, port, outdir):
    """A fresh pod refuses the uncommitted iteration-4 snapshot, resumes
    the committed iteration-2 one and ends on the straight run's
    trees."""
    from lightgbm_tpu_torch.robust.checkpoint import has_pod_commit
    from lightgbm_tpu_torch.utils.log import LightGBMError
    cfg, ds = load(params(rank, hosts, port), data_path(outdir))
    ck2 = os.path.join(outdir, CKPT2)
    ck4 = os.path.join(outdir, CKPT4)
    out = {"commit2": has_pod_commit(ck2), "commit4": has_pod_commit(ck4)}
    bst = boost(cfg, ds)
    try:
        bst.resume_from_checkpoint(ck4)
        out["uncommitted_refused"] = None
    except LightGBMError as e:
        out["uncommitted_refused"] = str(e)
    bst.resume_from_checkpoint(ck2)
    bst.train_chunked(ITERS - 2, chunk=CHUNK)
    bst._flush_pending()
    out["trees"] = trees_of(bst.model_to_string())
    return out


def scenario_deadcoord(rank, hosts, port, outdir):
    """A rank whose coordinator never answers raises the bounded probe
    error."""
    import time
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops.shard import multihost_setup
    from lightgbm_tpu_torch.utils.log import LightGBMError
    cfg = Config(params(1, 2, port, {"network_timeout": 1,
                                     "network_retries": 3}))
    t0 = time.perf_counter()
    try:
        multihost_setup(cfg)
        err = None
    except LightGBMError as e:
        err = str(e)
    return {"failfast_error": err, "elapsed_s": time.perf_counter() - t0}


HIST_SHAPE = dict(n=60_001, g=6, nb=256, k=3, w=37)


def hist_inputs(dev, dtype):
    """Seeded inputs of the cudahist scenario, the same in every
    process."""
    import torch
    n, g, nb, k, w = (HIST_SHAPE[c] for c in "n g nb k w".split())
    gen = torch.Generator(device=dev).manual_seed(5)
    bins = torch.randint(0, nb, (g, n), device=dev, dtype=torch.uint8,
                         generator=gen)
    leaf = torch.randint(-1, w + 1, (n,), device=dev, dtype=torch.int32,
                         generator=gen)
    if dtype == torch.int8:
        ghk = torch.randint(-127, 128, (n, k), device=dev, dtype=torch.int8,
                            generator=gen)
    else:
        ghk = (torch.randn((n, k), device=dev, generator=gen)
               * 3.0).to(dtype)
    return bins, leaf, ghk, torch.arange(w, dtype=torch.int32, device=dev)


def scenario_cudahist(rank, hosts, port, outdir):
    """Kernel 1 over this host's TOTAL_SHARDS // hosts shards of the
    seeded rows, the accumulators all-reduced across the pod."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import hist_cuda, shard
    cfg = Config(params(rank, hosts, port))
    shard.multihost_setup(cfg)
    dev = torch.device(DEVICE[0])
    local = TOTAL_SHARDS // hosts
    pod = shard.make_pod_mesh([dev] * local)
    out = {}
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        bins, leaf, ghk, pending = hist_inputs(dev, dtype)
        n = bins.shape[1]
        m = -(-n // TOTAL_SHARDS)
        lo, hi = shard.process_row_span(pod, m)
        hi_real = min(hi, n)
        codes = [bins[:, a:min(a + m, hi_real)].contiguous()
                 for a in range(lo, hi_real, m)]
        scale = None if dtype == torch.int8 else \
            hist_cuda.hist_scale_exponents(ghk, n)
        before = hist_cuda.wave_hist_sharded.launches.read()
        got = hist_cuda.wave_hist_sharded(
            codes, leaf[lo:hi_real], ghk[lo:hi_real], pending,
            g=HIST_SHAPE["g"], nb=HIST_SHAPE["nb"], k=HIST_SHAPE["k"],
            w=HIST_SHAPE["w"], scale_exp=scale,
            leaf_bound=HIST_SHAPE["w"] + 1, pod=pod)
        out[str(dtype)] = dict(
            hist=got.cpu(),
            launches=hist_cuda.wave_hist_sharded.launches.read() - before)
    torch.save(out, os.path.join(outdir, f"cudahist_r{rank}.pt"))
    return {"comm": pod.comm_summary()}


def main():
    scenario = sys.argv[1]
    rank, hosts = int(sys.argv[2]), int(sys.argv[3])
    port, outdir = int(sys.argv[4]), sys.argv[5]
    if len(sys.argv) > 6:
        DEVICE[0] = sys.argv[6]
    sys.path.insert(0, os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    import torch
    torch.set_num_threads(1)
    if scenario == "deadcoord":
        out = scenario_deadcoord(rank, hosts, port, outdir)
    elif scenario == "killA":
        out = scenario_kill_a(rank, hosts, port, outdir)
    elif scenario == "killB":
        out = scenario_kill_b(rank, hosts, port, outdir)
    elif scenario == "cudahist":
        out = scenario_cudahist(rank, hosts, port, outdir)
    elif scenario in SCENARIO_EXTRA:
        out = scenario_train(rank, hosts, port, outdir,
                             SCENARIO_EXTRA[scenario])
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    out["scenario"] = scenario
    out["rank"] = rank
    print(json.dumps(out), flush=True)
    path = os.path.join(outdir, f"{scenario}_r{rank}.json")
    with open(path + ".tmp", "w") as fh:
        json.dump(out, fh)
    os.replace(path + ".tmp", path)
    if scenario == "killA":
        # skip the process group's teardown, which waits on the dead
        # victim; the result is on disk
        os._exit(0)
    from lightgbm_tpu_torch.ops.shard import multihost_shutdown
    multihost_shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
