"""Run one benchmark cell once and print its result as the last line of
standard output.

    python3 -m benchmark.run --workload higgs.train --seed 7 \\
        --seconds 51 --trace 0

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<mix>.json``, whose ``loop`` names the loop in
``benchmark/loops``); its limits are ``benchmark/limits/<cell>.json``,
and each per-layer metric is read by ``benchmark/metrics/<metric>.py``.
With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics from a profiled stretch.  The
run's other output goes to standard error and to
``bench_out/<cell>.<seed>.<trace>/`` in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
#: every build and kernel cache of the program, at fixed paths inside
#: the checkout: only a cell's first run in a checkout builds
CACHE_ENV = {
    "LGBM_TPU_COMPILE_CACHE": BUILD / "lightgbm_tpu_torch",
    "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
    "TRITON_CACHE_DIR": BUILD / "triton",
    "CUDA_CACHE_PATH": BUILD / "nv_compute_cache",
}
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")


def set_env() -> None:
    for k, v in CACHE_ENV.items():
        os.environ[k] = str(v)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``lightgbm_tpu_torch`` is not ``lightgbm_tpu``)."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Ctx:
    def __init__(self, spec, cell, seed, device, out_dir, sizes=None,
                 mix_overrides=None, control=False):
        self.spec = spec
        self.cell = cell
        self.cfg = spec.config(cell["config"], sizes)
        self.mix = {**spec.mix(cell["traffic"]), **(mix_overrides or {})}
        self.seed = int(seed)
        self.device = device
        self.out_dir = out_dir
        #: run the cell's control in the program's place (``loops``)
        self.control = bool(control)
        self.log = log


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run(workload: str, seed: int, seconds: float, trace: bool,
        device_name: str = "cuda", out_root: Path = ROOT / "bench_out",
        sizes=None, mix_overrides=None, control: bool = False,
        root: Path = ROOT,
        t_start: float = None) -> dict:
    """One run of ``workload``; returns the result object (its checks
    under ``checks``)."""
    import torch
    from . import spec as spec_mod
    from .trace import Profiler
    t_start = T_START if t_start is None else t_start
    spec = spec_mod.Spec(root)
    cell = spec.workload(workload)
    device = torch.device(device_name)
    out_dir = Path(out_root) / f"{workload}.{seed}.{int(trace)}"
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = Ctx(spec, cell, seed, device, out_dir, sizes, mix_overrides,
              control)
    loop = spec.loop(ctx.mix["loop"])(ctx)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    loop.setup()
    loop.sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    result_metrics = {}
    breakdown = None
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu",
                "count": 1}
    if not trace:
        e2e = loop.window(float(seconds))
        e2e["setup_s"] = setup_s
        for m in spec.end_to_end(workload):
            if m["name"] not in e2e:
                raise RuntimeError(f"the loop gave no {m['name']}")
            result_metrics[m["name"]] = {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
    else:
        facts = loop.traced(Profiler(out_dir))
        tr = facts["trace"]
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        breakdown = tr.breakdown()
        facts["power_line"] = card_line() if device.type == "cuda" else "cpu"
        for m in spec.per_layer(workload):
            # a reader that finds nothing to read returns None, and the
            # metric is left out of the line
            v = spec.metric(m["name"])(facts)
            if v is not None:
                v = float(v)
                log(f"metric {m['name']}: {v!r}")
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            else:
                log(f"metric {m['name']}: nothing to read")
        (out_dir / "facts.json").write_text(json.dumps(
            {k: v for k, v in facts.items()
             if isinstance(v, (int, float, str, list)) and k != "trees"},
            default=str, indent=1))
    if device.type == "cuda":
        dev_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    else:
        dev_info["memory_peak_bytes"] = 0
    t_check = time.perf_counter()
    loop.release()
    values = loop.check()
    log(f"check {time.perf_counter() - t_check:.3f} s")
    limits = spec.limits(workload)
    checks = []
    for name, value in values:
        if name not in limits:
            raise RuntimeError(f"no limit for check {name!r} of {workload}")
        if limits[name] is None:
            log(f"logged, not compared: {name} {float(value)!r}")
            continue
        checks.append((name, float(value), float(limits[name])))
    correct = all(v <= lim for _, v, lim in checks)
    bad = forbidden_modules(list(sys.modules))
    result = {"correct": correct, "attempted": loop.attempted,
              "failed": loop.failed, "metrics": result_metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    result["_forbidden"] = bad
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_env()
    from . import spec as spec_mod
    spec = spec_mod.Spec(ROOT)
    cell = spec.workload(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"card: {card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    res = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = res.pop("_forbidden")
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 4
    log(f"correct: {res['correct']}")
    for name, c in res["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
