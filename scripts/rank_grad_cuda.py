"""The program's lambdarank gradient against the benchmark's plain
reference at the ranking cell's full size, on the card, from the
program's own training scores.

    python3 scripts/rank_grad_cuda.py --seed N [--chunks 3] [--out FILE]

Sets up ``mslr.train`` as the benchmark does (its rows, queries and
booster, from the seed), trains ``--chunks`` fused chunks, and at the
start of each takes the program's training scores of every row.  On
those scores it compares the program's gradient (the booster's
objective, the function its fused trees capture) with the reference's
(``benchmark/reference/objectives/lambdarank.py``, float64) at the
tolerance of ``tests/test_torch_rank.py``: each row's gradient within
1e-4 of the sum of its pair terms' magnitudes plus 1e-6, its hessian
within 1e-4 of itself plus 1e-6.  Prints one JSON line a chunk: the
largest reading of each against its tolerance (pass at <= 1), the rows
outside it, and the program's gradient's time called eagerly (CUDA
events, mean of 5).  Exits 1 if a row is outside.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    run.set_env()
    import torch
    from benchmark.spec import Spec
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    spec = Spec(ROOT)
    cell = spec.workload("mslr.train")
    out_dir = ROOT / "bench_out" / f"rank_grad.{args.seed}"
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = run.Ctx(spec, cell, args.seed, dev, out_dir)
    loop = spec.loop(ctx.mix["loop"])(ctx)
    loop.setup()
    obj = loop.booster._gbdt.objective
    ref = loop.objective()
    lines, bad = [], 0
    for chunk in range(args.chunks):
        score = loop.booster._gbdt.train_score[0].clone()
        tg, th = (a.double() for a in obj.get_gradients(score[None, :]))
        fg, fh, mag = ref.terms(score, loop.y)
        rg = ((tg - fg).abs() / (1e-4 * mag + 1e-6))
        rh = ((th - fh).abs() / (1e-4 * fh.abs() + 1e-6))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            obj.get_gradients(score[None, :])
        end.record()
        torch.cuda.synchronize(dev)
        line = dict(chunk=chunk, trees=loop.booster.num_trees(),
                    rows=int(score.numel()),
                    grad_reading=float(rg.max()),
                    grad_rows_outside=int((rg > 1).sum()),
                    hess_reading=float(rh.max()),
                    hess_rows_outside=int((rh > 1).sum()),
                    grad_abs_max=float(fg.abs().max()),
                    eager_grad_ms=start.elapsed_time(end) / 5)
        bad += line["grad_rows_outside"] + line["hess_rows_outside"]
        print(json.dumps(line), flush=True)
        lines.append(line)
        loop.step()
    if args.out:
        Path(args.out).write_text(json.dumps(
            dict(card=run.card_line(), seed=args.seed, chunks=lines),
            indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
