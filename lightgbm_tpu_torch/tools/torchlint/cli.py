"""torchlint command line:
``python -m lightgbm_tpu_torch.tools.torchlint [paths]``.

Exit codes: 0 clean (every finding baselined or none), 1 new findings,
2 usage/parse errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter
from typing import List, Optional

from . import baseline as baseline_mod
from .core import analyze_paths
from .rules import RULE_DOCS, RULE_EXPLAIN


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="torchlint",
        description="Repo-aware static analysis for host-sync, graph "
                    "recapture, dtype, graph-key, lock-discipline and "
                    "determinism hazards in the PyTorch/CUDA port.")
    p.add_argument("paths", nargs="*", default=["lightgbm_tpu_torch"],
                   help="files/directories to analyze "
                        "(default: lightgbm_tpu_torch)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline JSON of accepted findings (default: "
                        "the package's committed baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline; report every finding")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings as the baseline and "
                        "exit 0 (with --select, entries of unselected "
                        "rules are preserved from the existing baseline)")
    p.add_argument("--select", default=None, metavar="CODES",
                   help="comma-separated rule codes to run "
                        "(e.g. TL001,TL005); the baseline is filtered "
                        "to the selected rules")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--statistics", action="store_true",
                   help="print per-rule counts")
    p.add_argument("--list-rules", action="store_true",
                   help="list rule codes and exit")
    p.add_argument("--explain", default=None, metavar="RULE",
                   help="print a rule's full documentation and exit")
    p.add_argument("--root", default=None, metavar="DIR",
                   help="directory finding paths are reported relative "
                        "to (default: cwd)")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="incremental cache directory (content-hash "
                        "keyed; unchanged files/tree replay without "
                        "re-analysis), e.g. .torchlint_cache")
    p.add_argument("--no-cache", action="store_true",
                   help="ignore --cache-dir; always analyze cold")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for code, doc in RULE_DOCS.items():
            print(f"{code}  {doc}")
        return 0

    if args.explain:
        code = args.explain.strip().upper()
        doc = RULE_EXPLAIN.get(code)
        if doc is None:
            print(f"torchlint: unknown rule {code!r} (see --list-rules)",
                  file=sys.stderr)
            return 2
        print(f"{code} — {RULE_DOCS[code]}\n\n{doc}")
        return 0

    select = None
    if args.select:
        select = {c.strip().upper() for c in args.select.split(",")}
        unknown = select - set(RULE_DOCS)
        if unknown:
            print(f"torchlint: unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    cache_dir = None if args.no_cache else args.cache_dir
    result = analyze_paths(args.paths, root=args.root, select=select,
                           cache_dir=cache_dir)
    if result.errors:
        for path, msg in result.errors:
            print(f"{path}: error: {msg}", file=sys.stderr)
        return 2

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline \
            and os.path.exists(baseline_mod.DEFAULT_BASELINE):
        baseline_path = baseline_mod.DEFAULT_BASELINE

    if args.write_baseline:
        out = baseline_path or baseline_mod.DEFAULT_BASELINE
        preserved = {}
        if select is not None and os.path.exists(out):
            # a rule-filtered run only holds the selected findings:
            # carry every other rule's accepted entries over unchanged
            # instead of silently erasing them
            try:
                loaded = baseline_mod.load(out)
            except (OSError, ValueError, KeyError) as e:
                print(f"torchlint: cannot read baseline {out}: {e}",
                      file=sys.stderr)
                return 2
            preserved = {k: n for k, n in loaded.items()
                         if k[1] not in select}
        baseline_mod.write(out, result.findings, extra=preserved)
        kept = f" (+{sum(preserved.values())} preserved)" \
            if preserved else ""
        print(f"torchlint: wrote {len(result.findings)} finding(s){kept} "
              f"to {out}")
        return 0

    accepted = {}
    if baseline_path and not args.no_baseline:
        try:
            accepted = baseline_mod.load(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"torchlint: cannot read baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
        if select is not None:
            # a filtered run must only be judged against the selected
            # rules' entries — the others would all read as stale
            accepted = {k: n for k, n in accepted.items()
                        if k[1] in select}
    new, stale = baseline_mod.apply(result.findings, accepted)

    if args.format == "json":
        print(json.dumps({
            "files_scanned": result.files_scanned,
            "total": len(result.findings),
            "new": [f.to_dict() for f in new],
            "baselined": len(result.findings) - len(new),
            "suppressed": len(result.suppressed),
            "cache": {"hits": result.cache_hits,
                      "misses": result.cache_misses,
                      "warm": result.from_cache},
            "stale_baseline_entries": [
                {"file": k[0], "rule": k[1], "snippet": k[2], "count": n}
                for k, n in stale],
        }, indent=1))
    else:
        for f in new:
            print(f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}")
        if args.statistics and result.findings:
            counts = Counter(f.rule for f in result.findings)
            for code in sorted(counts):
                print(f"{code}: {counts[code]} total")
        summary = (f"torchlint: {result.files_scanned} file(s), "
                   f"{len(result.findings)} finding(s): {len(new)} new, "
                   f"{len(result.findings) - len(new)} baselined, "
                   f"{len(result.suppressed)} suppressed")
        if cache_dir is not None:
            summary += (" [cache: warm]" if result.from_cache else
                        f" [cache: {result.cache_hits} hit(s), "
                        f"{result.cache_misses} miss(es)]")
        if stale:
            summary += (f"; {sum(n for _, n in stale)} stale baseline "
                        "entr(ies) — regenerate with --write-baseline")
        print(summary)

    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
