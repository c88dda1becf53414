"""On-disk incremental cache: skip re-analysis of unchanged files.

With the TL1xx project rules a cold torchlint run parses the whole
package and builds the symbol/call graphs.  The cache makes the common
case — nothing changed — nearly free, keyed so it can never serve stale
results:

* ``tool_hash``: sha256 over every source file of the torchlint package
  itself.  Editing any rule invalidates everything.
* per-file entries keyed by the file's content sha256: findings of the
  per-file (TL0xx) rules, replayable without re-parsing.
* one project entry keyed by the *tree hash* (sha256 over the sorted
  (relpath, file sha) list): findings of the cross-module TL1xx rules.
  Any content change re-runs the project rules — their findings can
  legitimately move between files, so per-file reuse would be unsound.

The cache file lives under ``<cache dir>/cache.json`` (``--cache-dir``,
e.g. ``.torchlint_cache``) and is written atomically (temp + rename); a
corrupt/missing/mismatched cache means a cold run, never an error.
``--select`` runs may *read* (findings are filtered per rule afterwards)
but never write, so a filtered run can't poison the full-run cache.
"""

from __future__ import annotations

import hashlib
import json
import os
import posixpath
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .context import Finding

CACHE_VERSION = 2
CACHE_FILENAME = "cache.json"
DEFAULT_CACHE_DIR = ".torchlint_cache"


def file_sha(src: str) -> str:
    return hashlib.sha256(src.encode("utf-8", "replace")).hexdigest()


def tree_sha(file_hashes: Sequence[Tuple[str, str]]) -> str:
    h = hashlib.sha256()
    for rel, sha in sorted(file_hashes):
        h.update(rel.encode())
        h.update(b"\0")
        h.update(sha.encode())
        h.update(b"\n")
    return h.hexdigest()


#: ``# torchlint: abi-header=...`` / ``abi-impl=...`` directives name
#: non-Python inputs (C header / .cpp) that project rules read.  Paths
#: are relative to the *directive-carrying file*, so a fixture corpus
#: copied elsewhere keeps resolving its own sibling header.
EXTRA_INPUT_DIRECTIVE_RE = re.compile(
    r"#\s*torchlint:\s*abi-(?:header|impl)\s*=\s*(\S+)")


def resolve_extra_path(relpath: str, target: str) -> str:
    """Normalize a directive ``target`` against its declaring file."""
    return posixpath.normpath(
        posixpath.join(posixpath.dirname(relpath.replace("\\", "/")),
                       target))


def scan_extra_inputs(sources: Sequence[Tuple[str, str]],
                      root) -> Dict[str, Optional[str]]:
    """Collect ``abi-*`` directive targets from ``(relpath, src)`` pairs.

    Returns normalized-relpath -> file text, or ``None`` when the
    target is missing/unreadable (the rules then stay silent for it,
    but the sentinel still feeds the tree hash so creating the file
    later invalidates the project cache).
    """
    out: Dict[str, Optional[str]] = {}
    for rel, src in sources:
        for m in EXTRA_INPUT_DIRECTIVE_RE.finditer(src):
            key = resolve_extra_path(rel, m.group(1))
            if key in out:
                continue
            path = (key if os.path.isabs(key)
                    else os.path.join(str(root), key))
            try:
                with open(path, encoding="utf-8") as fh:
                    out[key] = fh.read()
            except OSError:
                out[key] = None
    return out


def extra_input_hashes(extra: Dict[str, Optional[str]]) \
        -> List[Tuple[str, str]]:
    """Hash pairs for the tree key: C inputs invalidate like sources."""
    return [("extra::" + rel,
             file_sha(text) if text is not None else "<missing>")
            for rel, text in extra.items()]


def tool_hash() -> str:
    """sha256 of the analyzer's own sources (this package)."""
    root = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            p = os.path.join(dirpath, fn)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as fh:
                h.update(hashlib.sha256(fh.read()).digest())
    return h.hexdigest()


def _finding_to_dict(f: Finding) -> Dict:
    return f.to_dict()


def _finding_from_dict(d: Dict) -> Finding:
    return Finding(d["rule"], d["file"], int(d["line"]), int(d["col"]),
                   d["message"], d["snippet"])


class LintCache:
    """Loaded cache state plus the entries for the next write."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, CACHE_FILENAME)
        self._tool = tool_hash()
        self._old: Dict = {}
        self.files: Dict[str, Dict] = {}
        self.project: Optional[Dict] = None
        self.hits = 0
        self.misses = 0
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
            if doc.get("version") == CACHE_VERSION \
                    and doc.get("tool_hash") == self._tool:
                self._old = doc
        except (OSError, ValueError):
            self._old = {}

    # -- per-file (TL0xx) ------------------------------------------------
    def lookup_file(self, rel: str, sha: str) \
            -> Optional[Tuple[List[Finding], List[Finding]]]:
        e = self._old.get("files", {}).get(rel)
        if e is None or e.get("sha") != sha:
            self.misses += 1
            return None
        self.hits += 1
        return ([_finding_from_dict(d) for d in e.get("findings", [])],
                [_finding_from_dict(d) for d in e.get("suppressed", [])])

    def store_file(self, rel: str, sha: str, findings: List[Finding],
                   suppressed: List[Finding]) -> None:
        self.files[rel] = {
            "sha": sha,
            "findings": [_finding_to_dict(f) for f in findings],
            "suppressed": [_finding_to_dict(f) for f in suppressed],
        }

    # -- project (TL1xx) -------------------------------------------------
    def lookup_project(self, tree: str) \
            -> Optional[Tuple[List[Finding], List[Finding]]]:
        e = self._old.get("project")
        if not e or e.get("tree_sha") != tree:
            return None
        return ([_finding_from_dict(d) for d in e.get("findings", [])],
                [_finding_from_dict(d) for d in e.get("suppressed", [])])

    def store_project(self, tree: str, findings: List[Finding],
                      suppressed: List[Finding]) -> None:
        self.project = {
            "tree_sha": tree,
            "findings": [_finding_to_dict(f) for f in findings],
            "suppressed": [_finding_to_dict(f) for f in suppressed],
        }

    # --------------------------------------------------------------------
    def write(self) -> None:
        doc = {"version": CACHE_VERSION, "tool": "torchlint",
               "tool_hash": self._tool, "files": self.files,
               "project": self.project}
        os.makedirs(self.directory, exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, self.path)
