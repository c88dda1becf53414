"""Rehearse chip_smoke.py's soak phase on the CPU.

    python scripts/rehearse_soak_cuda.py

Runs ``chip_smoke.phase_soak`` without a card at small sizes: the main
soak and the forced-fail soak at 4,096-request windows (1,024 sampled
rows, 512 objects, a 4 MiB cache; 8 iterations of 15 leaves, max_bin 63,
so that four tenants train in seconds on the CPU), the degrade cycle and
``profile_phases`` on 20,000 HIGGS-shaped rows (63 leaves), after two
of ``scripts/soak_cuda.py``'s switch-interval arms.
``torch.cuda``'s synchronize and memory calls are stubbed and the
kernels' launch counters count calls of their wrappers (on the CPU the
wrappers take their plain versions).  It catches wrong paths, shapes and
checks before a card run; it measures nothing.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class _Counter:
    """A launch counter with DeviceLaunchCount's interface."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0

    def read(self):
        return self.n

    def counter(self, device):
        return None


def main() -> int:
    import torch
    torch.set_num_threads(1)
    import chip_smoke as cs
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import grow, hist_cuda
    from lightgbm_tpu_torch.serve import fleet as fleet_mod
    from lightgbm_tpu_torch.serve import packed

    for name in ("synchronize", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    waves = _Counter()
    hist_cuda.wave_hist.launches = waves
    orig_hist = grow.wave_hist

    def counted_hist(*a, **kw):
        waves.n += 1
        return orig_hist(*a, **kw)
    grow.wave_hist = counted_hist
    orig_fp = packed.forest_predict

    def counted_fp(*a, **kw):
        counted_fp.launches += 1
        counted_fp.routes["rows"] += 1
        return orig_fp(*a, **kw)
    counted_fp.launches = 0
    counted_fp.routes = {"rows": 0, "trees": 0}
    packed.forest_predict = counted_fp
    fleet_mod.forest_predict = counted_fp

    cs.PIPE_OBJECTS = 512
    cs.PIPE_CACHE_SIZE = 1 << 22
    cs.SOAK_REQUESTS = 4096
    cs.SOAK_SAMPLE = 1024
    cs.SOAK_FAIL_SAMPLE = 1024
    cs.N_ROWS = 20_000
    cs.DEGRADE_ROWS = 2_000
    cs.PROFILE_REPS = 2
    scenario = cs._soak_scenario
    cs._soak_scenario = lambda seed, **kw: scenario(
        seed, **{"num_iterations": 8, "num_leaves": 15, "max_bin": 63,
                 **kw})
    cs.TRAIN_RUNS = {**cs.TRAIN_RUNS,
                     "higgs": {**cs.TRAIN_RUNS["higgs"], "num_leaves": 63}}
    x, y = cs.higgs_shape(cs.N_ROWS, 0)
    bst = lt.train({**cs.TRAIN_BASE, "num_leaves": 15, "device": "cpu",
                    "verbose": -1}, lt.Dataset(x, y), 5)
    models = {"higgs": bst.model_to_string()}
    train = {"runs": {"higgs": {"per_iteration": {
        "dispatch_s": [0.02] * 10, "waves_per_tree": 8.0}}}}
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "scripts"))
    import soak_cuda
    arms = soak_cuda.run_arms(torch.device("cpu"), 0, ["default", "0.001"],
                              diagnose=True)
    print(f"rehearsal: {len(arms)} arms of scripts/soak_cuda.py ok in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = cs.phase_soak(torch.device("cpu"), 0, train, models, x, y)
    print(f"rehearsal: phase_soak ok in {time.perf_counter() - t0:.1f} s; "
          f"launches {out['launches']}, predict launches "
          f"{out['predict_launches']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
