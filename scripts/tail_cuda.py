"""chip_smoke.py's last long-running phases, repeated, on the card.

    python scripts/tail_cuda.py [--seed N] [--burners B]

Builds the kernels and runs the train phase (the models and rows the
later phases read), then runs the pipeline, capi, api and soak phases
twice: once alone, then beside ``B`` (default 6) processes that each
spin one CPU core, to look for checks that fail only on a loaded host.
A failed check does not stop the run: each phase prints
``TAIL <round> <phase> ok=<bool> <seconds>``, and the last line lists
them all.  Prints the card's name and power limit.  About 13 minutes of
card time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--burners", type=int, default=6)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this run needs a GPU")
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    print(cs.card_line(), flush=True)
    cs.phase_build()
    train, models, x, y, dense = cs.phase_train(dev, args.seed, False)
    del dense
    cs.clear_growers(dev)
    seed = args.seed
    phases = (("pipeline", lambda: cs.phase_pipeline(dev, seed)),
              ("capi", lambda: cs.phase_capi(dev, seed)),
              ("api", lambda: cs.phase_api(dev, seed, x, y)),
              ("soak", lambda: cs.phase_soak(dev, seed, train, models,
                                             x, y)))
    results = []
    for rnd, n_burn in (("alone", 0), ("burners", args.burners)):
        burners = [subprocess.Popen([sys.executable, "-c",
                                     "while True: pass"])
                   for _ in range(n_burn)]
        try:
            for name, run in phases:
                t0 = time.perf_counter()
                try:
                    run()
                    ok = True
                except SystemExit:
                    # chip_smoke.fail: its message is already printed
                    ok = False
                # the next phase starts from a clean fallback count
                cs._FALLBACK_SEEN[0] = cs.fallback_total()
                cs.clear_growers(dev)
                secs = time.perf_counter() - t0
                results.append(dict(round=rnd, phase=name, ok=ok,
                                    seconds=round(secs, 1)))
                print(f"TAIL {rnd} {name} ok={ok} {secs:.1f} s",
                      flush=True)
        finally:
            for proc in burners:
                proc.kill()
                proc.wait()
    print(cs.card_line())
    print("TAIL RESULTS " + json.dumps(results), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
