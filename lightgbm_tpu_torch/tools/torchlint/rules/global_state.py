"""TL006 — unguarded mutation of module-level state.

The boosting loop, sklearn wrapper, C-API embed path and the user's
own threads can all reach module-level registries concurrently —
``obs/registry.py`` had to grow a lock for exactly this reason.  This
rule finds module-level mutable containers (dict/list/set literals or
``dict()``/``defaultdict()``/… constructors) and ``global``-rebound
names, then flags any mutation from inside a function that is not
under a ``with <...lock...>:`` block:

- ``NAME.append/add/update/pop/…(…)``
- ``NAME[...] = …`` / ``NAME[...] += …``
- ``global NAME`` followed by an assignment to ``NAME``

The lock heuristic is textual: any ``with`` context expression whose
dotted name contains "lock" (``_LOCK``, ``self._lock``,
``registry.lock()``) guards its body.  Single-threaded-by-construction
mutations can carry ``# torchlint: disable=TL006`` with a comment saying
why.  Same rule as jaxlint's JL006: the process-wide counters of the port
(``ops/grow.py``'s ``GROWER_CACHE_COUNTS`` / ``PLAN_COUNTS``,
``ops/build.py``'s and ``obs/capture_track.py``'s ``COUNTS``) are bumped
under a module lock for this reason.
"""

from __future__ import annotations

import ast
from typing import Dict

from ..context import FileContext, dotted_name

CODE = "TL006"
SHORT = ("module-level mutable state mutated outside a lock "
         "(thread-unsafe under the multi-threaded C-API/callback paths)")

_MUTABLE_CONSTRUCTORS = ("dict", "list", "set", "bytearray", "deque",
                         "defaultdict", "OrderedDict", "Counter")
_MUTATORS = ("append", "add", "update", "pop", "popitem", "setdefault",
             "clear", "extend", "insert", "remove", "discard",
             "appendleft", "popleft", "sort")


def _module_mutables(ctx: FileContext) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for stmt in ctx.tree.body:
        targets = []
        value = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            if isinstance(value, (ast.Dict, ast.List, ast.Set,
                                  ast.DictComp, ast.ListComp,
                                  ast.SetComp)):
                out[t.id] = stmt.lineno
            elif isinstance(value, ast.Call):
                d = dotted_name(value.func)
                if d is not None \
                        and d.split(".")[-1] in _MUTABLE_CONSTRUCTORS:
                    out[t.id] = stmt.lineno
    return out


def _under_lock(ctx: FileContext, node: ast.AST) -> bool:
    for a in ctx.ancestors(node):
        if isinstance(a, ast.With):
            for item in a.items:
                expr = item.context_expr
                d = dotted_name(expr.func if isinstance(expr, ast.Call)
                                else expr)
                if d is not None and "lock" in d.lower():
                    return True
    return False


def check(ctx: FileContext):
    mutables = _module_mutables(ctx)

    for fn in ctx.nodes:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        global_names = set()
        for stmt in fn.body:
            if isinstance(stmt, ast.Global):
                global_names.update(stmt.names)

        for node in ctx.walk(fn):
            # NAME.append(...) etc. on a module-level container
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in mutables \
                    and node.func.attr in _MUTATORS \
                    and not _under_lock(ctx, node):
                yield ctx.make_finding(
                    CODE, node,
                    f"mutation of module-level `{node.func.value.id}` "
                    f"(.{node.func.attr}) outside a lock; guard with a "
                    "module lock or move the state into an instance "
                    "(obs/registry.py pattern)")
            # NAME[...] = ... / NAME[...] += ...
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in mutables \
                            and not _under_lock(ctx, node):
                        yield ctx.make_finding(
                            CODE, node,
                            f"item assignment on module-level "
                            f"`{t.value.id}` outside a lock; guard with "
                            "a module lock or move the state into an "
                            "instance")
                    elif isinstance(t, ast.Name) and t.id in global_names \
                            and not _under_lock(ctx, node):
                        yield ctx.make_finding(
                            CODE, node,
                            f"`global {t.id}` rebound outside a lock is "
                            "a read-modify-write race under the "
                            "multi-threaded C-API path; guard it or use "
                            "a thread-safe holder")
