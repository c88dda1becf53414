"""Baseline: accepted pre-existing findings that don't block CI.

The committed ``lightgbm_tpu_torch/tools/torchlint/baseline.json``
records each accepted finding as ``(file, rule, normalized source
line)`` with a count: line numbers are deliberately NOT part of the
key, so unrelated edits that shift lines don't invalidate the baseline,
while any *new* occurrence of a flagged pattern (even in a baselined
file) is reported.  Regenerate with ``python -m
lightgbm_tpu_torch.tools.torchlint <paths> --write-baseline``.  It is
empty and stays so: a finding is repaired, or suppressed inline with
its reason where the code is right by design (docs/PortStaticAnalysis.md).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from .context import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")

Key = Tuple[str, str, str]   # (file, rule, snippet)


def finding_key(f: Finding) -> Key:
    return (f.path, f.rule, f.snippet)


def load(path: str) -> Dict[Key, int]:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {doc.get('version')!r} in "
            f"{path} (expected {BASELINE_VERSION})")
    out: Dict[Key, int] = {}
    for e in doc.get("entries", []):
        key = (e["file"], e["rule"], e["snippet"])
        out[key] = out.get(key, 0) + int(e.get("count", 1))
    return out


def dump(findings: Sequence[Finding],
         extra: Optional[Dict[Key, int]] = None) -> Dict:
    counts = Counter(finding_key(f) for f in findings)
    for k, n in (extra or {}).items():
        counts[k] += n
    entries = [{"file": k[0], "rule": k[1], "snippet": k[2], "count": n}
               for k, n in sorted(counts.items())]
    return {"version": BASELINE_VERSION, "tool": "torchlint",
            "entries": entries}


def write(path: str, findings: Sequence[Finding],
          extra: Optional[Dict[Key, int]] = None) -> None:
    """Write ``findings`` (plus ``extra`` pre-counted entries — used by
    ``--select --write-baseline`` to preserve unselected rules) as the
    baseline."""
    with open(path, "w") as fh:
        json.dump(dump(findings, extra), fh, indent=1, sort_keys=False)
        fh.write("\n")


def apply(findings: Sequence[Finding], baseline: Dict[Key, int]) \
        -> Tuple[List[Finding], List[Tuple[Key, int]]]:
    """Split ``findings`` against the baseline.

    Returns ``(new_findings, stale_entries)``: per key the first
    ``baseline[key]`` occurrences (in line order) are accepted, the rest
    are new; stale entries are baseline keys whose budget exceeds what
    the tree still contains (candidates for regeneration)."""
    remaining = dict(baseline)
    new: List[Finding] = []
    for f in sorted(findings, key=Finding.sort_key):
        k = finding_key(f)
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
        else:
            new.append(f)
    stale = [(k, n) for k, n in sorted(remaining.items()) if n > 0]
    return new, stale
