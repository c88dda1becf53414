"""torchlint core: walk files, run rules, apply inline suppressions.

Pure static analysis — files are parsed with :mod:`ast`, never
imported, so the analyzer is fast and safe to run on code whose
dependencies are absent.  Two rule tiers run here:

* per-file rules (TL0xx) see one :class:`FileContext` at a time and
  are cached per file-content hash;
* project rules (TL1xx) see the whole-repo
  :class:`~.project.ProjectContext` (symbol table, import/call graph)
  and are cached against the tree hash — any content change re-runs
  them, because a cross-module finding can move between files.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from .cache import (LintCache, extra_input_hashes, file_sha,
                    scan_extra_inputs, tree_sha)
from .context import FileContext, Finding
from .rules import FILE_RULES, PROJECT_RULES

EXCLUDED_DIRS = {"__pycache__", ".git", ".venv", "build", "dist",
                 ".torchlint_cache"}


class AnalysisResult:
    """Findings plus bookkeeping from one analyzer run."""

    __slots__ = ("findings", "suppressed", "files_scanned", "errors",
                 "cache_hits", "cache_misses", "from_cache")

    def __init__(self):
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []
        self.files_scanned: int = 0
        self.errors: List[Tuple[str, str]] = []   # (path, message)
        self.cache_hits: int = 0
        self.cache_misses: int = 0
        self.from_cache: bool = False


def iter_python_files(paths: Sequence[str]) -> Iterable[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_file():
            if p.suffix == ".py":
                yield p
        elif p.is_dir():
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in EXCLUDED_DIRS)
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield Path(dirpath) / fn


def _run_file_rules(ctx: FileContext, select: Optional[Set[str]],
                    findings: List[Finding],
                    suppressed: List[Finding]) -> None:
    for code, rule in FILE_RULES.items():
        if select is not None and code not in select:
            continue
        for finding in rule.check(ctx):
            if ctx.is_suppressed(finding.rule, finding.line):
                suppressed.append(finding)
            else:
                findings.append(finding)


def _run_project_rules(contexts: Sequence[FileContext],
                       select: Optional[Set[str]],
                       findings: List[Finding],
                       suppressed: List[Finding],
                       root: Optional[str] = None,
                       extra_files=None) -> None:
    from .project import ProjectContext
    if not any(select is None or code in select
               for code in PROJECT_RULES):
        return
    project = ProjectContext(contexts, root=root, extra_files=extra_files)
    ctx_by_path = {c.relpath: c for c in contexts}
    for code, rule in PROJECT_RULES.items():
        if select is not None and code not in select:
            continue
        for finding in rule.check_project(project):
            ctx = ctx_by_path.get(finding.path)
            if ctx is not None \
                    and ctx.is_suppressed(finding.rule, finding.line):
                suppressed.append(finding)
            else:
                findings.append(finding)


def analyze_source(src: str, relpath: str,
                   select: Optional[Set[str]] = None,
                   result: Optional[AnalysisResult] = None,
                   project_rules: bool = True) \
        -> AnalysisResult:
    """Run all (or ``select``ed) rules over one source string.  Project
    rules see a single-file project (their intra-module checks still
    apply)."""
    result = result if result is not None else AnalysisResult()
    try:
        ctx = FileContext(src, relpath)
    except SyntaxError as e:
        result.errors.append((relpath, f"syntax error: {e.msg} "
                              f"(line {e.lineno})"))
        return result
    result.files_scanned += 1
    _run_file_rules(ctx, select, result.findings, result.suppressed)
    if project_rules:
        _run_project_rules([ctx], select, result.findings,
                           result.suppressed)
    result.findings.sort(key=Finding.sort_key)
    return result


def analyze_paths(paths: Sequence[str], root: Optional[str] = None,
                  select: Optional[Set[str]] = None,
                  cache_dir: Optional[str] = None) -> AnalysisResult:
    """Analyze every ``.py`` file under ``paths``.  Finding paths are
    reported relative to ``root`` (default: cwd) when possible, so the
    baseline is position-independent.  With ``cache_dir``, unchanged
    files (per-file rules) and an unchanged tree (project rules) replay
    cached findings without re-parsing; ``--select`` runs filter the
    cached full-run results and never write."""
    rootp = Path(root) if root is not None else Path.cwd()
    result = AnalysisResult()

    sources: List[Tuple[str, str]] = []          # (relpath, src)
    for path in iter_python_files(paths):
        try:
            rel = path.resolve().relative_to(rootp.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        try:
            src = path.read_text(encoding="utf-8")
        except OSError as e:
            result.errors.append((rel, str(e)))
            continue
        sources.append((rel, src))

    cache = LintCache(cache_dir) if cache_dir is not None else None
    hashes = [(rel, file_sha(src)) for rel, src in sources]
    # non-Python inputs named by abi-* directives (C header / .cpp)
    # content-hash into the tree key: a header edit invalidates the
    # project tier even though no .py file changed
    extra = scan_extra_inputs(sources, rootp)
    tree = tree_sha(hashes + extra_input_hashes(extra))

    def keep(fs: Iterable[Finding]) -> List[Finding]:
        if select is None:
            return list(fs)
        return [f for f in fs if f.rule in select]

    contexts: List[FileContext] = []
    need_project = any(select is None or code in select
                       for code in PROJECT_RULES)
    project_cached = None
    if cache is not None and need_project:
        project_cached = cache.lookup_project(tree)
    parse_all = need_project and project_cached is None

    all_cached = True
    for (rel, src), (_, sha) in zip(sources, hashes):
        cached = cache.lookup_file(rel, sha) if cache is not None else None
        if cached is not None and not parse_all:
            result.files_scanned += 1
            result.findings.extend(keep(cached[0]))
            result.suppressed.extend(keep(cached[1]))
            continue
        try:
            ctx = FileContext(src, rel)
        except SyntaxError as e:
            result.errors.append((rel, f"syntax error: {e.msg} "
                                  f"(line {e.lineno})"))
            all_cached = False
            continue
        contexts.append(ctx)
        result.files_scanned += 1
        if cached is not None:
            # file unchanged but the tree changed: replay the per-file
            # findings, keep the context for the project rules
            result.findings.extend(keep(cached[0]))
            result.suppressed.extend(keep(cached[1]))
            continue
        all_cached = False
        f_new: List[Finding] = []
        s_new: List[Finding] = []
        # a --select run never writes the cache, so there is no reason
        # to pay for the unselected rules on a miss
        _run_file_rules(ctx, select, f_new, s_new)
        if cache is not None and select is None:
            # cache the FULL per-file result so later --select runs
            # can filter it
            cache.store_file(rel, sha, f_new, s_new)
        result.findings.extend(keep(f_new))
        result.suppressed.extend(keep(s_new))

    if need_project:
        if project_cached is not None:
            result.findings.extend(keep(project_cached[0]))
            result.suppressed.extend(keep(project_cached[1]))
        else:
            pf: List[Finding] = []
            ps: List[Finding] = []
            _run_project_rules(
                contexts, select, pf, ps, root=str(rootp),
                extra_files={k: v for k, v in extra.items()
                             if v is not None})
            if cache is not None and select is None \
                    and not result.errors:
                cache.store_project(tree, pf, ps)
            result.findings.extend(keep(pf))
            result.suppressed.extend(keep(ps))

    if cache is not None:
        result.cache_hits = cache.hits
        result.cache_misses = cache.misses
        result.from_cache = all_cached and (project_cached is not None
                                            or not need_project)
        if select is None and not result.errors:
            # carry over untouched entries so a partial-path run does
            # not evict other files — but drop entries whose file no
            # longer exists, or deletions/renames would accumulate in
            # cache.json forever
            dirty = bool(cache.files) or cache.project is not None
            for rel, entry in cache._old.get("files", {}).items():
                if rel in cache.files:
                    continue
                if (rootp / rel).is_file():
                    cache.files[rel] = entry
                else:
                    dirty = True
            if cache.project is None:
                cache.project = cache._old.get("project")
            if dirty:
                # a fully-warm run changed nothing: stay read-only
                cache.write()

    result.findings.sort(key=Finding.sort_key)
    result.suppressed.sort(key=Finding.sort_key)
    return result
