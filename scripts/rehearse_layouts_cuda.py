"""Rehearse chip_smoke.py's layout and host-learner work on the CPU.

    python scripts/rehearse_layouts_cuda.py

Runs, at small sizes and without a card, what chip_smoke.py adds for the
device grower's striped and hi/lo layouts and for the host tree learner:
the kernel phase's new cases (wave_hist at K=4/5/6 and striped int8 K=6,
wave_hist_rows with f32 stats; the kernels simulated by their exact
plain versions), the ``window20m`` phase (a 20,000-row window,
COUNT_SPLIT_ROWS lowered to 12,000 and INT32_SCAN_ROWS to 15,000 so the
striped layouts, the exact-rows pad and the f32 fallback scan engage)
and the ``host_learner`` phase (6,000 HIGGS-shaped rows, a 30,000-row
route).  ``torch.cuda``'s synchronize and memory calls are stubbed, the
kernels' launch counters count calls of their wrappers, and
``predict_checked`` predicts on the CPU (where no forest kernel
launches).  It catches wrong paths, shapes and checks before a card run;
it measures nothing.
"""

from __future__ import annotations

import sys
import tempfile
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

    def bump(self, device):
        self.n += 1


def _counted(fn, counter):
    def run(*a, **kw):
        counter.n += 1
        return fn(*a, **kw)
    return run


def main() -> int:
    import numpy as np
    import torch
    torch.set_num_threads(4)
    import chip_smoke as cs
    import lightgbm_tpu_torch as lt
    import lightgbm_tpu_torch.ops.grow as grow
    from lightgbm_tpu_torch.ops import hist_cuda
    from lightgbm_tpu_torch.ops import histogram, routing

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0

    def host_ms(fn, reps, warmup=2):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    cs.time_ms = host_ms

    waves, windows = _Counter(), _Counter()
    wave, rows = hist_cuda.wave_hist, hist_cuda.wave_hist_rows
    grow.wave_hist = _counted(wave, waves)
    histogram.wave_hist_rows = _counted(rows, windows)
    hist_cuda.wave_hist.launches = waves
    hist_cuda.wave_hist_rows.launches = windows
    routes = _Counter()
    grow.split_rows = _counted(routing.split_rows, routes)
    routing.split_rows.launches = routes
    dev = torch.device("cpu")

    # the kernel cases, each kernel simulated by its exact plain version
    def exact_wave(b, leaf, ghk, pending, *, g, nb, k, w, scale_exp=None,
                   leaf_bound=None, col_rows=None):
        hist_cuda._check(b, leaf, ghk, pending, g, nb, k, w, col_rows)
        if ghk.dtype == torch.int8:
            return hist_cuda.wave_hist_reference(b, leaf, ghk, pending, g=g,
                                                 nb=nb, k=k, w=w)
        if scale_exp is None:
            scale_exp = hist_cuda.hist_scale_exponents(ghk, b.shape[1])
        return hist_cuda.wave_hist_fixed_reference(b, leaf, ghk, pending,
                                                   scale_exp, g=g, nb=nb,
                                                   k=k, w=w)

    def exact_rows(b, ghk, r, *, g, nb, k, scale_exp=None):
        return hist_cuda.wave_hist_rows_fixed_reference(b, ghk, r, scale_exp,
                                                        g=g, nb=nb, k=k)
    hist_cuda.wave_hist, hist_cuda.wave_hist_rows = exact_wave, exact_rows
    for i, c in enumerate((
            dict(nb=256, k=4, w=96, quant=False, g=5, n=30_000,
                 mode="k4_bf16_20m"),
            dict(nb=256, k=6, w=64, quant=True, g=5, n=30_000, striped=True,
                 mode="k6_int8_20m"),
            dict(nb=256, k=5, w=76, quant=False, g=4, n=20_000,
                 mode="k5_bf16"),
            dict(nb=256, k=6, w=64, quant=False, g=4, n=20_000,
                 mode="k6_bf16_w64"))):
        cs.measure_case("wave_hist", exact_wave, dev, dict(c, seed=i))
    cs.measure_rows_case(dev, 40_000, 12_345, 9, g=5)
    cs.measure_rows_case(dev, 40_000, 40_000, 10, g=5, permuted=False)
    hist_cuda.wave_hist, hist_cuda.wave_hist_rows = wave, rows

    def predict_on_cpu(name, booster, x, score, dev, bar=1e-5,
                       keep_raw=False):
        raw = booster.predict(x, raw_score=True)
        err = float(np.abs(raw - score).max())
        if err > bar:
            cs.fail(f"{name}: predict vs score {err:.3g}")
        out = dict(predict_launches=1, predict_routes={"rows": 1,
                                                       "trees": 0},
                   predict_vs_score_max_abs=err)
        if keep_raw:
            out["raw"] = raw
        return out
    cs.predict_checked = predict_on_cpu

    grow.COUNT_SPLIT_ROWS = 12_000
    grow.INT32_SCAN_ROWS = 15_000
    cs.WIN_ROWS, cs.WIN_TAIL, cs.WIN_ROUNDS, cs.WIN_CHUNK = 20_000, 5_000, \
        4, 2
    cs.HOST_ROUTE_ROWS, cs.HOST_WALK_ROWS = 30_000, 2_000
    cs.ROUNDS = 2
    small = {"device_predict_min_rows": 1_000}
    cs.TRAIN_BASE = {**cs.TRAIN_BASE, **small}
    cs.PIPE_BASE = {**cs.PIPE_BASE, **small}
    cs.HOST_BASE = {**cs.HOST_BASE, **small}
    x, y = cs.higgs_shape(6_000, 0)
    dense = lt.Dataset(x, y, params=dict(cs.TRAIN_BASE)).construct()._handle
    t0 = time.perf_counter()
    window = cs.phase_window20m(dev, 0, dense)
    with tempfile.TemporaryDirectory() as tmp:
        host = cs.phase_host_learner(dev, 0, dense, x, y, tmp)
    print(f"rehearsal: ok in {time.perf_counter() - t0:.1f} s; window "
          f"launches by mode {window['launches_by_mode']}, host-learner "
          f"window launches {host['launches_by_case']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
