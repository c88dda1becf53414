"""Rehearse chip_smoke.py's ``pipeline`` phase on the CPU at a small size.

    python scripts/rehearse_pipeline_cuda.py [--window 20000]
        [--objects 4000] [--threads 4]

Runs ``chip_smoke.phase_pipeline`` on ``device: cpu`` with windows of
``--window`` requests over ``--objects`` objects (each trained on its last
half), every check of the phase but the AUC floor, and prints the phase's
lines.  ``csrc/wave_hist.cu`` has no CPU mode, so its launch counter is
replaced by a count of the grower's waves (``_piece_wave`` calls, which
the card's counter equals there with the warm-up).  Its seconds say
nothing of the card; its held-out AUCs set the phase's floor.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class _WaveCount:
    """Stands in for ``hist_cuda.wave_hist.launches`` on the CPU."""

    n = 0

    def reset(self):
        _WaveCount.n = 0

    def read(self):
        return _WaveCount.n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--window", type=int, default=20_000)
    ap.add_argument("--objects", type=int, default=4_000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(args.threads)
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops import grow, hist_cuda
    cs.PIPE_OBJECTS = args.objects
    cs.PIPE_WINDOW = args.window
    cs.PIPE_SAMPLE = args.window // 2
    cs.PIPE_HOST_ROWS = min(5_000, args.window // 2)
    cs.PIPE_AUC_FLOOR = 0.0
    cs.OUT_DIR = Path(tempfile.mkdtemp(prefix="rehearse_pipeline_"))
    hist_cuda.wave_hist.launches = _WaveCount()
    real = grow.DeviceGrower._piece_wave

    def counted(self, ws):
        _WaveCount.n += 1
        return real(self, ws)

    grow.DeviceGrower._piece_wave = counted
    t = time.perf_counter()
    cs.phase_pipeline(torch.device("cpu"), args.seed)
    print(f"rehearsal took {time.perf_counter() - t:.1f} s on the CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main())
