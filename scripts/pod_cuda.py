"""The multi-controller pod on the card: one process a host.

    python scripts/pod_cuda.py [--seed N] [--rows R]
    python scripts/pod_cuda.py --leg LEG --rank R --hosts N --port P
                               --csv PATH --outdir DIR [--device cpu]

With no ``--leg`` it runs ``chip_smoke.phase_pod`` alone: it builds the
kernels, writes the stream phase's HIGGS-shaped CSV (``--rows``, default
``chip_smoke.STREAM_ROWS``) and drives every leg of the phase, with every
check of the full script; the results go to ``chiprun_out/pod_cuda.json``.

With ``--leg`` it is one pod host, as ``chip_smoke.phase_pod`` launches it
N times (ranks 0..N-1, a free localhost coordinator port,
``shard_devices = 4 // N`` shards of the card each, so every leg grows over
the same four shards):

* ``api``: ``load_text_multihost`` once, then ``chip_smoke.POD_ROUNDS``
  fused rounds (the per-piece loop on a pod) of each of the higgs, int8
  and harness configurations (``chip_smoke.TRAIN_RUNS``);
* ``cli``: ``task=train two_round=true data_sharding=multi_controller``
  through the CLI's entry point, the higgs configuration;
* ``killA``: int8, 31 leaves; a snapshot at iteration 2, two more
  iterations, then the last rank exits before it acks iteration 4;
* ``killB``: a fresh pod refuses the iteration-4 snapshot, resumes the
  iteration-2 one and trains to iteration 6, then trains the same
  configuration straight for 6 iterations.

Each host prints one JSON line (and writes ``<outdir>/<leg>_r<rank>.json``):
each model text's sha256 (before its parameters), s/tree (host clock to
a synchronize), kernel 1's launches in this process (its device counter),
the reduction's bytes and ms a wave (CUDA events around the host copies,
the host clock around the gloo all-reduce), the score gathers, the
bring-up and load seconds, and the card's name and power limit.
``--device cpu`` runs a host on the CPU (a rehearsal of the legs' code:
the plain versions, no card numbers).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: killA's victim exits with this code (the intentional death)
KILLED_EXIT = 17
#: the hosts' device (``--device``)
DEVICE = ["cuda"]


def _sync():
    import torch
    if DEVICE[0] == "cuda":
        torch.cuda.synchronize()


def pod_params(name, rank, hosts, port, extra=None):
    """A pod host's parameters of a chip_smoke configuration."""
    import chip_smoke as cs
    p = {**cs.TRAIN_BASE, **cs.POD_RUNS[name], "device": DEVICE[0],
         "data_sharding": "multi_controller",
         "coordinator_address": f"127.0.0.1:{port}", "num_hosts": hosts,
         "host_rank": rank, "shard_devices": cs.SHARDS // hosts}
    p.update(cs.POD_NET_KILL if name == "kill" else cs.POD_NET)
    p.update(extra or {})
    return p


def comm_of(pod, waves=None) -> dict:
    """The pod's reductions a wave and score gathers a tree (``waves``:
    the trees' waves, when known)."""
    c = pod.comm_summary(reset=True)
    red = c.get("wave_hist", dict(calls=0, bytes=0, copy_ms=0.0,
                                  collective_ms=0.0))
    calls = max(red["calls"], 1)
    gat = c.get("gather_rows", dict(calls=0, bytes=0, copy_ms=0.0,
                                    collective_ms=0.0))
    return dict(reductions=red["calls"], waves=waves,
                reduce_bytes_per_wave=red["bytes"] / calls,
                reduce_copy_ms_per_wave=red["copy_ms"] / calls,
                reduce_allreduce_ms_per_wave=red["collective_ms"] / calls,
                gathers=gat["calls"],
                gather_ms_per_tree=(gat["copy_ms"] + gat["collective_ms"])
                / max(gat["calls"], 1),
                refit=c.get("refit", {}).get("calls", 0))


def _setup_and_load(cfg, csv):
    """(dataset, setup s, load s): the bring-up, then the pod's load."""
    from lightgbm_tpu_torch.data.stream_loader import load_text_multihost
    from lightgbm_tpu_torch.ops import shard
    t0 = time.perf_counter()
    shard.multihost_setup(cfg)
    t1 = time.perf_counter()
    ds, _ = load_text_multihost(csv, cfg)
    return ds, t1 - t0, time.perf_counter() - t1


def _train(cfg, ds, rounds):
    """(booster, s/tree, waves) of ``rounds`` fused rounds on the pod."""
    from lightgbm_tpu_torch.boosting import create_boosting
    gb = create_boosting(cfg)
    gb.init_train(ds)
    _sync()
    t0 = time.perf_counter()
    gb.train_chunked(rounds, chunk=rounds)
    _sync()
    s_tree = (time.perf_counter() - t0) / rounds
    waves = sum(int(s[2]) for s in gb.tree_stats)
    return gb, s_tree, waves


def leg_api(rank, hosts, port, csv, outdir):
    import chip_smoke as cs
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import hist_cuda
    cfg = Config(pod_params("higgs", rank, hosts, port))
    ds, setup_s, load_s = _setup_and_load(cfg, csv)
    runs = {}
    for name in cs.SHARD_RUNS:
        hist_cuda.wave_hist.launches.reset()
        gb, s_tree, waves = _train(
            Config(pod_params(name, rank, hosts, port)), ds, cs.POD_ROUNDS)
        pod = gb._grower.pod
        runs[name] = dict(sha256=cs.trees_sha256(gb.model_to_string()),
                          s_per_tree=s_tree,
                          launches=hist_cuda.wave_hist.launches.read(),
                          **comm_of(pod, waves))
        gb.release_grower()
    return dict(setup_s=setup_s, load_s=load_s,
                row_span=list(ds.host_row_span), runs=runs)


def leg_cli(rank, hosts, port, csv, outdir):
    """The CLI's training; the pod mesh it builds and the load it runs
    are timed and read through wrappers around the package's functions
    (measurement only)."""
    import chip_smoke as cs
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.data import stream_loader
    from lightgbm_tpu_torch.ops import hist_cuda, shard
    meshes, load_s = [], []
    real_mesh, real_load = shard.make_pod_mesh, \
        stream_loader.load_text_multihost

    def mesh(*a, **k):
        meshes.append(real_mesh(*a, **k))
        return meshes[-1]

    def load(*a, **k):
        t0 = time.perf_counter()
        out = real_load(*a, **k)
        load_s.append(time.perf_counter() - t0)
        return out
    shard.make_pod_mesh, stream_loader.load_text_multihost = mesh, load
    model = os.path.join(outdir, f"cli_model_r{rank}.txt")
    p = pod_params("higgs", rank, hosts, port)
    argv = ["task=train", f"data={csv}", "two_round=true",
            f"output_model={model}", f"num_iterations={cs.POD_ROUNDS}",
            "verbosity=-1"] + [f"{k}={v}" for k, v in p.items()
                               if k != "verbose"]
    hist_cuda.wave_hist.launches.reset()
    t0 = time.perf_counter()
    try:
        if cli.main(argv) != 0:
            raise RuntimeError("the CLI's training exited non-zero")
    finally:
        shard.make_pod_mesh, stream_loader.load_text_multihost = \
            real_mesh, real_load
    _sync()
    total_s = time.perf_counter() - t0
    text = Path(model).read_text()
    return dict(train_s=total_s, load_s=sum(load_s),
                s_per_tree=(total_s - sum(load_s)) / cs.POD_ROUNDS,
                sha256=cs.trees_sha256(text),
                launches=hist_cuda.wave_hist.launches.read(),
                **comm_of(meshes[-1]))


def leg_kill_a(rank, hosts, port, csv, outdir):
    import chip_smoke as cs
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.robust.checkpoint import has_pod_commit
    from lightgbm_tpu_torch.utils.log import LightGBMError
    cfg = Config(pod_params("kill", rank, hosts, port))
    ds, setup_s, load_s = _setup_and_load(cfg, csv)
    ck2, ck4 = (os.path.join(outdir, f"pod_ck_iter{i}.txt") for i in (2, 4))
    gb = create_boosting(cfg)
    gb.init_train(ds)
    gb.train_chunked(2, chunk=2)
    gb.save_checkpoint(ck2)
    gb.train_chunked(2, chunk=2)
    if rank == hosts - 1:
        os._exit(KILLED_EXIT)
    t0 = time.perf_counter()
    err = None
    try:
        gb.save_checkpoint(ck4)
    except LightGBMError as e:
        err = str(e)
    return dict(setup_s=setup_s, load_s=load_s, commit2=has_pod_commit(ck2),
                commit4=has_pod_commit(ck4), victim=hosts - 1,
                ack_timeout_error=err, ack_wait_s=time.perf_counter() - t0,
                rounds=cs.POD_KILL_ROUNDS)


def leg_kill_b(rank, hosts, port, csv, outdir):
    import chip_smoke as cs
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.robust.checkpoint import has_pod_commit
    from lightgbm_tpu_torch.utils.log import LightGBMError
    cfg = Config(pod_params("kill", rank, hosts, port))
    ds, setup_s, load_s = _setup_and_load(cfg, csv)
    ck2, ck4 = (os.path.join(outdir, f"pod_ck_iter{i}.txt") for i in (2, 4))
    out = dict(setup_s=setup_s, load_s=load_s, commit2=has_pod_commit(ck2),
               commit4=has_pod_commit(ck4))
    gb = create_boosting(cfg)
    gb.init_train(ds)
    try:
        gb.resume_from_checkpoint(ck4)
        out["uncommitted_refused"] = None
    except LightGBMError as e:
        out["uncommitted_refused"] = str(e)
    gb.resume_from_checkpoint(ck2)
    gb.train_chunked(cs.POD_KILL_ROUNDS - 2, chunk=2)
    out["resumed_sha256"] = cs.trees_sha256(gb.model_to_string())
    gb.release_grower()
    straight, _, _ = _train(cfg, ds, cs.POD_KILL_ROUNDS)
    out["straight_sha256"] = cs.trees_sha256(straight.model_to_string())
    return out


LEGS = {"api": leg_api, "cli": leg_cli, "killA": leg_kill_a,
        "killB": leg_kill_b}


def host_main(args) -> int:
    import torch
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops import shard
    DEVICE[0] = args.device
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("pod_cuda.py: torch.cuda.is_available() is False")
    out = LEGS[args.leg](args.rank, args.hosts, args.port, args.csv,
                         args.outdir)
    out.update(leg=args.leg, rank=args.rank, hosts=args.hosts,
               card=cs.card_line() if args.device == "cuda" else "cpu")
    print(json.dumps(out), flush=True)
    path = os.path.join(args.outdir, f"{args.leg}_r{args.rank}.json")
    with open(path + ".tmp", "w") as fh:
        json.dump(out, fh)
    os.replace(path + ".tmp", path)
    if args.leg == "killA":
        # skip the process group's teardown, which waits on the victim
        os._exit(0)
    shard.multihost_shutdown()
    return 0


def alone_main(args) -> int:
    """chip_smoke's pod phase alone: the build, the CSV, the phase."""
    import tempfile
    import numpy as np
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this run needs a GPU")
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    cs.phase_build()
    cs.OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        x, y = cs.higgs_shape(args.rows, args.seed + 2)
        path = os.path.join(tmp, "higgs_stream.csv")
        np.savetxt(path, np.column_stack([y, np.round(
            x.astype(np.float64), 4)]), delimiter=",", fmt="%.4f")
        del x, y
        res = cs.phase_pod(dev, args.seed, tmp, path)
    with open(cs.OUT_DIR / "pod_cuda.json", "w") as fh:
        json.dump(res, fh, indent=1)
    print(cs.card_line())
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--leg", choices=sorted(LEGS))
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--csv", default="")
    ap.add_argument("--outdir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.leg:
        return host_main(args)
    if not args.rows:
        import chip_smoke as cs
        args.rows = cs.STREAM_ROWS
    return alone_main(args)


if __name__ == "__main__":
    sys.exit(main())
