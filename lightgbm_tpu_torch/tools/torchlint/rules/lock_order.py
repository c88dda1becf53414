"""TL121 — lock discipline across the threaded subsystems.

The pipeline prep thread, the serve micro-batch workers, the
stream-loader reader, the soak's tenant threads and the breaker re-probe
all run concurrently with the main training thread, and the locks they
touch live in different modules (``serve/engine.py``,
``pipeline/core.py``, ``robust/*``, ``c_api.py``, ``ops/grow.py``).
TL006's per-file name heuristic cannot see either of the two real
hazards:

1. **Lock-order inversion**: function A acquires lock L1 and (possibly
   through project calls) lock L2 while holding it; function B acquires
   them in the other order — a classic cross-thread deadlock.  The rule
   builds a project-wide lock-acquisition-order graph (lock identity =
   ``module:Class.attr`` for ``self._lock``-style locks,
   ``module:NAME`` for module-level locks) with an edge L1→L2 for every
   "L2 acquired while L1 is held", including acquisitions inside
   transitively called project functions, and flags every edge that
   participates in a cycle.
2. **Thread-shared state without a lock**: from every thread entry
   point (a ``target=`` handed to ``threading.Thread``) the rule walks
   the call graph; a reachable mutation of *another module's*
   module-level mutable container (invisible to TL006's single-file
   view), or a bare ``self.<attr> = ...`` write inside the entry
   function of a class that owns a lock, is flagged unless it happens
   under a ``with <...lock...>:`` block.

Queues, events and thread-local state are the sanctioned lock-free
channels; anything else shared between threads takes the owning lock or
a written ``# torchlint: disable=TL121`` justification.  Same rule as
jaxlint's JL121.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..context import dotted_name
from ..project import FuncKey, ProjectContext
from .global_state import _MUTATORS, _module_mutables, _under_lock

CODE = "TL121"
SHORT = ("lock-order inversion or thread-reachable shared-state "
         "mutation outside a lock (cross-module deadlock/race)")

PROJECT_RULE = True

LockId = str


def _lock_id(project: ProjectContext, fi, expr: ast.AST) \
        -> Optional[LockId]:
    """Stable identity for a lock context expression, or None when the
    expression is not lock-like."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    d = dotted_name(expr)
    if d is None or "lock" not in d.lower():
        return None
    parts = d.split(".")
    if parts[0] == "self" and fi is not None and fi.class_name:
        return f"{fi.module}:{fi.class_name}.{'.'.join(parts[1:])}"
    if len(parts) == 1:
        r = project.resolve_symbol(fi.module, parts[0]) \
            if fi is not None else None
        if r is not None:
            return f"{r[0]}:{r[1]}"
        return f"{fi.module if fi else '?'}:{d}"
    m2 = project.resolve_module(fi.module, parts[0]) \
        if fi is not None else None
    if m2 is not None:
        return f"{m2}:{'.'.join(parts[1:])}"
    return f"{fi.module if fi else '?'}:{d}"


def _direct_locks(project: ProjectContext) \
        -> Dict[FuncKey, List[Tuple[LockId, ast.With]]]:
    out: Dict[FuncKey, List[Tuple[LockId, ast.With]]] = {}
    for key, fi in project.functions.items():
        acquired = []
        for node in project.ctx_for[fi.module].walk(fi.node):
            if not isinstance(node, ast.With):
                continue
            if project.enclosing_function(fi.module, node) is not fi:
                continue
            for item in node.items:
                lid = _lock_id(project, fi, item.context_expr)
                if lid is not None:
                    acquired.append((lid, node))
        out[key] = acquired
    return out


def _locks_reachable(project: ProjectContext,
                     direct: Dict[FuncKey, List[Tuple[LockId, ast.With]]]
                     ) -> Dict[FuncKey, Set[LockId]]:
    """Fixpoint: locks a call into each function may end up acquiring."""
    out = {k: {lid for lid, _ in v} for k, v in direct.items()}
    changed = True
    while changed:
        changed = False
        for key in project.functions:
            agg = set(out.get(key, set()))
            for callee in project.calls.get(key, ()):
                agg |= out.get(callee, set())
            if agg != out.get(key, set()):
                out[key] = agg
                changed = True
    return out


def _order_edges(project: ProjectContext):
    """(outer_lock, inner_lock, site_module, site_node) for every
    "inner acquired while outer held" relation in the project."""
    direct = _direct_locks(project)
    reach = _locks_reachable(project, direct)
    edges: List[Tuple[LockId, LockId, str, ast.AST]] = []
    for key, fi in project.functions.items():
        # `with A_LOCK, B_LOCK:` acquires left-to-right — each earlier
        # item orders before every later one
        seen_with = set()
        for lid, with_node in direct.get(key, ()):
            if id(with_node) not in seen_with:
                seen_with.add(id(with_node))
                ids = [_lock_id(project, fi, it.context_expr)
                       for it in with_node.items]
                ids = [i for i in ids if i is not None]
                for a in range(len(ids)):
                    for b in range(a + 1, len(ids)):
                        if ids[a] != ids[b]:
                            edges.append((ids[a], ids[b], fi.module,
                                          with_node))
        for lid, with_node in direct.get(key, ()):
            for node in project.ctx_for[fi.module].walk(with_node):
                if node is with_node:
                    continue
                if isinstance(node, ast.With):
                    inner_fi = project.enclosing_function(fi.module, node)
                    if inner_fi is not fi:
                        continue
                    for item in node.items:
                        lid2 = _lock_id(project, fi, item.context_expr)
                        if lid2 is not None and lid2 != lid:
                            edges.append((lid, lid2, fi.module, node))
                elif isinstance(node, ast.Call):
                    if project.enclosing_function(fi.module, node) \
                            is not fi:
                        continue
                    for callee in project.resolve_call(fi, node):
                        for lid2 in reach.get(callee, ()):
                            if lid2 != lid:
                                edges.append((lid, lid2, fi.module,
                                              node))
    return edges


def _cycle_edges(edges) -> Set[Tuple[LockId, LockId]]:
    """Edges participating in any cycle of the lock-order graph (edges
    inside one strongly connected component with >1 node, plus
    self-loops)."""
    graph: Dict[LockId, Set[LockId]] = {}
    for a, b, _, _ in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())

    # Tarjan SCC, iterative
    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    on: Set[LockId] = set()
    comp: Dict[LockId, int] = {}
    stack: List[LockId] = []
    counter = [0]
    ncomp = [0]

    def strongconnect(v0):
        work = [(v0, iter(sorted(graph[v0])))]
        index[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on.add(v0)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                elif w in on:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp[w] = ncomp[0]
                    if w == v:
                        break
                ncomp[0] += 1

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    comp_sizes: Dict[int, int] = {}
    for c in comp.values():
        comp_sizes[c] = comp_sizes.get(c, 0) + 1
    bad: Set[Tuple[LockId, LockId]] = set()
    for a, b, _, _ in edges:
        if a == b or (comp.get(a) == comp.get(b)
                      and comp_sizes.get(comp.get(a), 0) > 1):
            bad.add((a, b))
    return bad


def _thread_entry_points(project: ProjectContext) -> Set[FuncKey]:
    out: Set[FuncKey] = set()
    for mname, mod in project.modules.items():
        ctx = mod.ctx
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if d is None or d.split(".")[-1] != "Thread":
                continue
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                r = project._callable_ref(mname, ctx, kw.value)
                if r is not None:
                    out.add(r)
                elif isinstance(kw.value, ast.Name):
                    # a nested `def worker()` in the enclosing function
                    fi = project.enclosing_function(mname, node)
                    if fi is not None:
                        k = (mname,
                             f"{fi.qualname}.<locals>.{kw.value.id}")
                        if k in project.functions:
                            out.add(k)
    return out


def check_project(project: ProjectContext):
    # (1) lock-order inversions
    edges = _order_edges(project)
    bad = _cycle_edges(edges)
    seen: Set[Tuple[LockId, LockId, str, int]] = set()
    for a, b, mname, node in edges:
        if (a, b) not in bad:
            continue
        ctx = project.ctx_for[mname]
        key = (a, b, mname, getattr(node, "lineno", 0))
        if key in seen:
            continue
        seen.add(key)
        yield ctx.make_finding(
            CODE, node,
            f"lock-order inversion: `{b}` can be acquired here while "
            f"`{a}` is held, but elsewhere the opposite order occurs — "
            "establish one global order or release the outer lock first "
            "(deadlock risk across threads)")

    # (2) thread-reachable unguarded mutation
    entries = _thread_entry_points(project)
    reachable = project.reachable_from(entries)
    for key in sorted(reachable):
        fi = project.functions[key]
        ctx = project.ctx_for[fi.module]
        for node in project.ctx_for[fi.module].walk(fi.node):
            if project.enclosing_function(fi.module, node) is not fi:
                continue
            # cross-module container mutation: other.STATE[...] = x /
            # other.STATE.append(x) — invisible to TL006's file view
            tgt = None
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                tgt = node.func.value
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                ts = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in ts:
                    if isinstance(t, ast.Subscript):
                        tgt = t.value
            if tgt is not None and isinstance(tgt, ast.Attribute) \
                    and isinstance(tgt.value, ast.Name):
                m2 = project.resolve_module(fi.module, tgt.value.id)
                if m2 is not None and m2 != fi.module \
                        and tgt.attr in _module_mutables(
                            project.ctx_for[m2]) \
                        and not _under_lock(ctx, node):
                    yield ctx.make_finding(
                        CODE, node,
                        f"thread-reachable mutation of "
                        f"`{m2}.{tgt.attr}` outside a lock (reached "
                        "from a threading.Thread target): guard it "
                        "with the owning module's lock")
            # bare-Name mutation of a same-module mutable is TL006's
            # finding already; not re-reported here

    # (2b) self-attribute writes inside the thread entry itself
    for key in sorted(entries):
        fi = project.functions[key]
        if fi.class_name is None:
            continue
        ctx = project.ctx_for[fi.module]
        cls_node = project.modules[fi.module].classes.get(fi.class_name)
        if cls_node is None or not _class_has_lock(cls_node):
            continue
        for node in project.ctx_for[fi.module].walk(fi.node):
            if not isinstance(node, ast.Assign):
                continue
            if project.enclosing_function(fi.module, node) is not fi:
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" \
                        and not _under_lock(ctx, node):
                    yield ctx.make_finding(
                        CODE, node,
                        f"`self.{t.attr}` written in a thread entry "
                        f"point while {fi.class_name} owns a lock: "
                        "other threads read this attribute — take the "
                        "lock (or use a Queue/Event)")


def _class_has_lock(cls_node: ast.ClassDef) -> bool:
    for node in ast.walk(cls_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) \
                        and "lock" in t.attr.lower():
                    return True
    return False
