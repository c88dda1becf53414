"""chip_smoke.py's soak phase alone on the card.

    python scripts/soak_cuda.py [--seed N] [--arms A,B,...] [--arms-only]
                                [--diagnose]

Builds the kernels, trains the HIGGS shape's 255-leaf model per iteration
(10 rounds on 2,000,000 rows binned on the card: the degrade cycle's
model, and the per-iteration s/tree and waves a tree the attribution
report reads), then runs ``chip_smoke.phase_soak``: the main soak, the
forced-fail soak, the degrade cycle and ``profile_phases``, with every
check of the full script.  Prints the card's name and power limit; the
results go to ``chiprun_out/soak_cuda.json``.  A few minutes of card
time, where the full ``chip_smoke.py`` takes about a quarter of an hour.

``--arms`` first runs the phase's main soak once an arm, in order, each
under the interpreter's thread switch interval it names (``default``:
Python's 5 ms, or seconds such as ``0.001``), and prints each run's
gates, request latencies, throughput figure, garbage collection time and
its windows' training beside what else ran (``chip_smoke.soak_windows``):
a comparison of the arms within one call.  ``--arms-only`` skips the
phase after them.  ``--diagnose`` also times, in each arm, the
pipelines' stages on the host clock with each call's thread CPU seconds
(``time.thread_time``): training, the prep's feature derivation and its
binning, swaps, checkpoints; and a probe thread's lateness after 5 ms
sleeps, the wait for the interpreter lock (GIL) beside each training.
For each training it prints wall and CPU seconds, the probe's mean
lateness over its span and the seconds of each other stage beside it.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class StageClock:
    """Host-clock spans of the pipelines' stages and a GIL probe, from
    ``install()`` to ``remove()`` (the ``--diagnose`` of an arm)."""

    STAGES = (("pipeline.core", "RetrainPipeline", "_train_window", "train"),
              ("soak.scenario", "SoakScenario", "window_payload", "walk"),
              ("pipeline.bins", "BinMapperCache", "dataset_for", "bin"),
              ("pipeline.core", "RetrainPipeline", "_swap", "swap"),
              ("pipeline.core", "RetrainPipeline", "_save_checkpoint",
               "ckpt"))
    SLEEP_S = 0.005

    def __init__(self):
        self.t0 = time.perf_counter()
        self.spans = []         # (stage, thread, start, end, cpu s)
        self.late = []          # (time, lateness s)
        self._orig = []
        self._stop = threading.Event()
        self._thread = None

    def _wrap(self, cls, name, stage):
        orig = getattr(cls, name)
        clock = self

        def timed(*a, **k):
            s, c = time.perf_counter(), time.thread_time()
            try:
                return orig(*a, **k)
            finally:
                clock.spans.append((stage, threading.current_thread().name,
                                    s - clock.t0,
                                    time.perf_counter() - clock.t0,
                                    time.thread_time() - c))
        setattr(cls, name, timed)
        self._orig.append((cls, name, orig))

    def _tick(self):
        while not self._stop.is_set():
            a = time.perf_counter()
            time.sleep(self.SLEEP_S)
            b = time.perf_counter()
            self.late.append((b - self.t0, b - a - self.SLEEP_S))

    def install(self):
        import importlib
        for mod, cls, name, stage in self.STAGES:
            m = importlib.import_module(f"lightgbm_tpu_torch.{mod}")
            self._wrap(getattr(m, cls), name, stage)
        self._thread = threading.Thread(target=self._tick, daemon=True)
        self._thread.start()

    def remove(self):
        self._stop.set()
        self._thread.join(timeout=5)
        for cls, name, orig in reversed(self._orig):
            setattr(cls, name, orig)

    def report(self) -> list:
        """One record a training: wall and CPU s, the GIL probe's mean
        lateness (ms) over it, and the seconds of every other stage's
        calls (any thread but its own) beside it."""
        out = []
        trains = [sp for sp in self.spans if sp[0] == "train"]
        for stage, thread, a, b, cpu in trains:
            late = [v for t, v in self.late if a <= t <= b]
            beside = {}
            for st2, th2, lo, hi, _ in self.spans:
                ov = max(0.0, min(b, hi) - max(a, lo))
                if th2 != thread and ov > 0:
                    beside[st2] = round(beside.get(st2, 0.0) + ov, 3)
            out.append(dict(thread=thread, start_s=round(a, 3),
                            wall_s=round(b - a, 3), cpu_s=round(cpu, 3),
                            gil_late_ms=round(1e3 * sum(late) / len(late), 3)
                            if late else None,
                            beside_s=beside))
        return out


def run_arms(dev, seed: int, arms, diagnose: bool = False) -> list:
    """The phase's main soak once an arm (see the module docstring)."""
    import tempfile
    import chip_smoke as cs
    from lightgbm_tpu_torch import obs
    default = sys.getswitchinterval()
    out = []
    vm = cs._validator()
    cs.OUT_DIR.mkdir(exist_ok=True)
    for i, arm in enumerate(arms):
        interval = default if arm == "default" else float(arm)
        clock = StageClock() if diagnose else None
        sys.setswitchinterval(interval)
        try:
            if clock is not None:
                clock.install()
            with tempfile.TemporaryDirectory(dir=cs.OUT_DIR) as tmp:
                run = cs._run_soak(f"arm{i}", cs._soak_scenario(seed), dev,
                                   tmp, vm)
        finally:
            if clock is not None:
                clock.remove()
            sys.setswitchinterval(default)
        v = run["verdict"]
        slo = {o["name"]: o["observed"]
               for o in v["slo"].get("objectives", [])}
        req = run["latency"]["serve.fleet.request_latency"] or {}
        rec = dict(arm=arm, switch_interval_s=interval, ok=v["ok"],
                   failing=sorted(n for n, g in v["gates"].items()
                                  if not g["ok"]),
                   slo=slo,
                   train_s_per_1M_sampled_rows=v["gates"]["throughput"][
                       "train_s_per_1M_sampled_rows"],
                   request_p50_ms=req.get("p50_s", 0) * 1e3,
                   request_p95_ms=req.get("p95_s", 0) * 1e3,
                   fallback_requests=v["counters"].get(
                       "serve.fleet.fallback_requests", 0),
                   seconds=run["seconds"], gc_s=run["gc_s"],
                   gc_runs=run["gc_runs"],
                   wave_hist_launches=run["wave_hist_launches"],
                   forest_launches=run["forest_launches"],
                   windows=run["windows"])
        for w in run["windows"]:
            print(f"arm {i} ({arm}) window {json.dumps(w, sort_keys=True)}",
                  flush=True)
        if clock is not None:
            rec["trainings"] = clock.report()
            rec["gil_late_ms_mean"] = (
                1e3 * sum(v for _, v in clock.late) / len(clock.late)
                if clock.late else None)
            for t in rec["trainings"]:
                print(f"arm {i} ({arm}) training "
                      f"{json.dumps(t, sort_keys=True)}", flush=True)
        print(f"arm {i} ({arm}): " + json.dumps(
            {k: v for k, v in rec.items()
             if k not in ("windows", "trainings")},
            sort_keys=True, default=str), flush=True)
        out.append(rec)
        obs.configure(enabled=False)
        obs.reset()
        cs.clear_growers(dev)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arms", default="",
                    help="switch intervals of main-soak runs before the "
                         "phase, comma-separated ('default' or seconds)")
    ap.add_argument("--arms-only", action="store_true")
    ap.add_argument("--diagnose", action="store_true")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    import lightgbm_tpu_torch as lt
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this run needs a GPU")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cs.phase_build()
    arms = run_arms(dev, args.seed,
                    [a for a in args.arms.split(",") if a], args.diagnose)
    if args.arms_only:
        cs.OUT_DIR.mkdir(exist_ok=True)
        with open(cs.OUT_DIR / "soak_cuda.json", "w") as fh:
            json.dump(dict(card=card, arms=arms), fh, indent=1, default=str)
        print(card)
        return 0
    x, y = cs.higgs_shape(cs.N_ROWS, args.seed)
    params = {**cs.TRAIN_BASE, **cs.TRAIN_RUNS["higgs"]}
    ds = lt.Dataset(torch.from_numpy(x).to(dev), y, params=dict(params))
    booster, _, res = cs.train_path("higgs", ds.construct(), dev,
                                    "per_iteration", args.seed)
    models = {"higgs": booster.model_to_string()}
    del booster, ds
    cs.clear_growers(dev)
    train = {"runs": {"higgs": {"per_iteration": res}}}
    out = cs.phase_soak(dev, args.seed, train, models, x, y)
    cs.check_no_fallback("soak")
    cs.OUT_DIR.mkdir(exist_ok=True)
    with open(cs.OUT_DIR / "soak_cuda.json", "w") as fh:
        json.dump(dict(card=card, arms=arms, soak=out), fh, indent=1,
                  default=str)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
