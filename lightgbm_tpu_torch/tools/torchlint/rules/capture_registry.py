"""TL003 — captures and kernel builds invisible to the capture telemetry.

``obs/capture_track.py`` attributes every CUDA-graph capture (and every
kernel library built and loaded) to a name and a signature, the way the
JAX package's ``obs/jit_track.py`` attributes XLA compiles: the
per-window capture counts of the retrain pipeline and the warm-up report
read it.  A capture or a library load whose function never reaches
``capture_track.record`` happens silently, and the telemetry
under-counts.  Sites:

- a graph capture: ``torch.cuda.CUDAGraph(...)``,
  ``torch.cuda.make_graphed_callables(...)``, ``GraphSet.capture(fn)``;
- a kernel-library load: ``ctypes.CDLL(...)``,
  ``ctypes.cdll.LoadLibrary(...)``, ``torch.ops.load_library(...)``,
  ``torch.utils.cpp_extension.load(...)`` / ``load_inline(...)``.

A site is tracked when its function, or a same-file function it calls
(transitively), calls ``capture_track.record``.  A graph capture whose
graph the function returns (``GraphSet.capture`` itself) hands the
tracking to its callers: their ``.capture(fn)`` calls are sites in turn.
A library load is never delegated that way: the loader records it.

The torch analog of jaxlint's JL003 (a ``jax.jit`` callable not wrapped
with ``obs.track_jit``).  Suppress a capture that happens once by
construction (a probe script's, a test's) with ``# torchlint:
disable=TL003`` and the reason.
"""

from __future__ import annotations

import ast
from typing import Dict, Optional, Set

from ..context import FileContext, dotted_name
from .recapture import _statement_of, is_capture_site

CODE = "TL003"
SHORT = ("CUDA-graph capture or kernel-library load whose function never "
         "reaches capture_track.record (invisible to the capture "
         "telemetry)")

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOADERS = ("ctypes.CDLL", "ctypes.cdll.LoadLibrary", "ctypes.PyDLL")
_TORCH_LOADERS = ("load_library", "load", "load_inline")


def _is_load_site(ctx: FileContext, node: ast.Call) -> bool:
    d = dotted_name(node.func)
    if d is None:
        return False
    if d in _LOADERS:
        return True
    parts = d.split(".")
    return parts[0] in ctx.torch_aliases and parts[-1] in _TORCH_LOADERS \
        and ("ops" in parts or "cpp_extension" in parts)


def _record_names(ctx: FileContext) -> Set[str]:
    """Dotted names that call ``capture_track.record`` in this file."""
    out = {"capture_track.record"}
    for node in ctx.nodes:
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[-1] == "capture_track":
            for a in node.names:
                if a.name == "record":
                    out.add(a.asname or "record")
    return out


def _recording_functions(ctx: FileContext) -> Set[int]:
    """ids of the functions that reach ``capture_track.record``: calling
    it, or calling (by bare name or ``self.``) a same-file function that
    does."""
    names = _record_names(ctx)
    funcs = [n for n in ctx.nodes if isinstance(n, _FUNCS)]
    by_name: Dict[str, list] = {}
    for fn in funcs:
        by_name.setdefault(fn.name, []).append(fn)

    def callees(fn) -> Set[str]:
        out = set()
        for sub in ctx.walk(fn):
            if isinstance(sub, ast.Call):
                d = dotted_name(sub.func)
                if d is not None:
                    out.add(d)
        return out

    calls = {id(fn): callees(fn) for fn in funcs}
    reach = {id(fn) for fn in funcs
             if any(d in names or d.endswith(".capture_track.record")
                    for d in calls[id(fn)])}
    changed = True
    while changed:
        changed = False
        for fn in funcs:
            if id(fn) in reach:
                continue
            for d in calls[id(fn)]:
                parts = d.split(".")
                tail = parts[-1] if (len(parts) == 1 or parts[0] == "self"
                                     and len(parts) == 2) else None
                if tail and any(id(g) in reach
                                for g in by_name.get(tail, ())):
                    reach.add(id(fn))
                    changed = True
                    break
    return reach


def _returned(ctx: FileContext, node: ast.AST) -> bool:
    """The capture's graph is the function's return value (directly or
    through a local name)."""
    stmt = _statement_of(ctx, node)
    if isinstance(stmt, ast.Return):
        return True
    if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)):
        return False
    name = stmt.targets[0].id
    fn = ctx.enclosing_function(node)
    return fn is not None and any(
        isinstance(r, ast.Return) and r.value is not None
        and any(isinstance(n, ast.Name) and n.id == name
                for n in ast.walk(r.value))
        for r in ctx.walk(fn))


def check(ctx: FileContext):
    recording: Optional[Set[int]] = None
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        capture = is_capture_site(ctx, node)
        if not capture and not _is_load_site(ctx, node):
            continue
        if recording is None:
            recording = _recording_functions(ctx)
        fn = ctx.enclosing_function(node)
        if fn is not None and id(fn) in recording:
            continue
        if capture and fn is not None and _returned(ctx, node):
            continue
        what = "CUDA-graph capture" if capture else "kernel-library load"
        yield ctx.make_finding(
            CODE, node,
            f"{what} whose function never reaches capture_track.record: "
            "it is invisible to the capture telemetry (obs/"
            "capture_track.py); record it with its name and signature")
