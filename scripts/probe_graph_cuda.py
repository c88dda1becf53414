"""Measure the two ways a data-dependent wave loop can live in a CUDA graph.

    python scripts/probe_graph_cuda.py [--mb 32]

Needs a GPU.  Prints the torch/CUDA versions and, for each layout, what
decides between them for ``ops/grow.py``'s captured tree:

* **IF-gated waves** (PyTorch's ``CUDAGraph.begin_capture_to_if_node``):
  every unrolled wave is captured inside an IF node.  Measured: device
  memory after capturing N bodies that each allocate ``--mb`` MB of
  temporaries (does the private pool reuse a body's freed blocks for the
  next body?), and the replay time of 255 skipped IF bodies of 20 small
  kernels each, against a graph without them (flat layout), and of the
  same bodies nested (wave k+1 inside wave k's body).
* **WHILE nodes** (``csrc/graph_loop.cu`` through ``ops/graphs.py``): a
  PyTorch-captured body composed into a WHILE loop that runs until the
  device control words say stop.  Measured: the count of iterations run
  (must equal the limit, or the iteration that sets ``done``), the device
  time a loop iteration adds beyond its body, the cost of a loop whose
  condition is false at entry, and memory after building loops around a
  body with ``--mb`` MB of temporaries.

Every time is CUDA events around 20 replays after a warm-up; the card's
name and power limit are printed with them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def events_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def if_memory(n_bodies, mb, dev):
    """MB of the private pool after capturing ``n_bodies`` IF bodies that
    each allocate ``mb`` MB of temporaries."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    acc = torch.zeros((), device=dev)
    pred = torch.ones((), dtype=torch.bool, device=dev)
    elems = mb * (1 << 20) // 4
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n_bodies):
            g.begin_capture_to_if_node(pred)
            tmp = torch.full((elems,), 1.0, device=dev)
            acc.add_((tmp * 2).sum())
            del tmp
            g.end_capture_to_conditional_node()
    g.replay()
    torch.cuda.synchronize()
    out = (torch.cuda.memory_reserved(dev) - base) / 2**20
    ok = float(acc) == 2.0 * elems * n_bodies
    del g
    return out, ok


def small_body(x):
    for _ in range(20):
        x.mul_(1.0001)


def if_skipped(nested, dev, n=255):
    """Replay ms of a graph with ``n`` skipped IF bodies of 20 small kernels
    (flat, or each inside the previous) and of the graph without them."""
    import torch
    x = torch.ones(1024, device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    small_body(x)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        x.add_(1.0)
        depth = 0
        for _ in range(n):
            g.begin_capture_to_if_node(pred)
            small_body(x)
            if nested:
                depth += 1
            else:
                g.end_capture_to_conditional_node()
        for _ in range(depth):
            g.end_capture_to_conditional_node()
        x.add_(1.0)
    g0 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g0):
        x.add_(1.0)
        x.add_(1.0)
    return events_ms(g.replay), events_ms(g0.replay)


def while_checks(mb, dev):
    import torch
    from lightgbm_tpu_torch.ops import graphs
    ctl = torch.zeros(4, dtype=torch.int32, device=dev)
    buf = torch.ones(mb * (1 << 20) // 4, device=dev)
    acc = torch.zeros((), device=dev)
    out = torch.zeros(4, dtype=torch.int32, device=dev)
    stop_at = torch.full((), 1 << 30, dtype=torch.int32, device=dev)

    def prologue():
        ctl.zero_()

    def body():
        tmp = buf * 2.0                      # mb MB of temporaries
        acc.add_(tmp[:16].sum())
        ctl[0] += 1
        ctl[1] = (ctl[0] >= stop_at).to(torch.int32)

    def tiny_body():
        ctl[0] += 1

    def epilogue():
        out.copy_(ctl)

    cap = graphs.GraphSet(dev)
    for fn in (prologue, body, tiny_body, epilogue):
        fn()                                  # warm up eagerly
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(dev)
    p, b, tb, e = (cap.capture(fn) for fn in (prologue, body, tiny_body,
                                             epilogue))
    after_capture = torch.cuda.memory_reserved(dev)
    res = {"capture_MB": (after_capture - before) / 2**20}
    loop = graphs.compose([(p, None), (b, 10), (b, 25), (e, None)], ctl)
    res["compose_MB"] = (torch.cuda.memory_reserved(dev) - after_capture) \
        / 2**20
    loop.launch()
    torch.cuda.synchronize()
    res["iterations_to_limit"] = int(out[0])          # expect 25
    stop_at.fill_(7)
    loop.launch()
    torch.cuda.synchronize()
    res["iterations_to_done"] = int(out[0])            # expect 7
    stop_at.fill_(1 << 30)
    # overhead a loop iteration adds: 1000 iterations of a one-kernel body
    # against 1000 launches of that body's graph
    long = graphs.compose([(p, None), (tb, 1000), (e, None)], ctl)
    res["loop_1000_ms"] = events_ms(long.launch, reps=5)
    plain = cap.capture(lambda: [tiny_body() for _ in range(1000)])
    res["unrolled_1000_ms"] = events_ms(plain.replay, reps=5)
    # loops whose condition is false at entry: 5 of them, against none
    ctl_done = graphs.compose([(p, None)] + [(tb, 0)] * 5 + [(e, None)],
                              ctl)
    none = graphs.compose([(p, None), (e, None)], ctl)
    res["five_skipped_loops_ms"] = events_ms(ctl_done.launch)
    res["no_loops_ms"] = events_ms(none.launch)
    import time
    t0 = time.perf_counter()
    for _ in range(100):
        none.launch()
    res["launch_host_us"] = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    for g in (loop, long, ctl_done, none):
        g.close()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=int, default=32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no GPU")
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
               if_api=hasattr(torch.cuda.CUDAGraph,
                              "begin_capture_to_if_node"),
               raw_graph=hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"))
    try:
        torch.cuda.CUDAGraph(keep_graph=True)
        res["keep_graph"] = True
    except TypeError:
        res["keep_graph"] = False
    print(json.dumps(res), flush=True)
    if res["if_api"]:
        for n in (4, 32):
            try:
                res[f"if_{n}_bodies_MB"] = if_memory(n, args.mb, dev)
            except Exception as e:                      # noqa: BLE001
                res[f"if_{n}_bodies_MB"] = repr(e)
            print(f"if {n} bodies: {res[f'if_{n}_bodies_MB']}", flush=True)
        for nested in (False, True):
            key = "if_nested_255" if nested else "if_flat_255"
            try:
                res[key] = if_skipped(nested, dev)
            except Exception as e:                      # noqa: BLE001
                res[key] = repr(e)
            print(f"{key} (skipped ms, without ms): {res[key]}", flush=True)
    res["while"] = while_checks(args.mb, dev)
    print(f"while: {res['while']}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
