"""Readings for the limits: the checks of sound runs and of the control
on many seeds, in one process (set-up is paid per seed, the build once).

    python3 -m benchmark.control --workload higgs.train \\
        --seeds 11,12,13 --seconds 6 [--control | --fault half]

Each seed prints one JSON line ``{"seed", "control", "fault", "correct",
"checks", "metrics"}``.  The control is the program's int8 gradient path
(``benchmark/loops``); ``--fault`` plants one of ``benchmark/faults.py``'s
faults in the program instead.  ``--seconds`` has to hold the chunk or
window that the seed draws to be judged.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from . import faults, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.set_env()
    for seed in (int(s) for s in args.seeds.split(",")):
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            res = run.run(args.workload, seed, args.seconds, False,
                          control=args.control)
        print(json.dumps({"seed": seed, "control": args.control,
                          "fault": args.fault,
                          "correct": res["correct"],
                          "checks": res["checks"],
                          "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
