"""TL141 — thread/queue concurrency-graph hazards.

The threaded subsystems (``pipeline/core.py``, ``serve/engine.py``,
``serve/fleet.py``, ``obs/export.py``, ``data/stream_loader.py``) talk
through queues and hand trace context across thread boundaries by
convention.  This rule builds a project-wide thread/queue graph — every
``threading.Thread(target=...)`` spawn resolved to its entry function,
every ``queue.Queue(...)`` bound to the local / ``self.<attr>`` name it
is assigned to — and flags three hazards no per-file rule can see:

1. **Span without a SpanContext handoff** (the causal-chain invariant): a
   spawned thread whose transitive closure opens ``obs.span(...)`` but
   never activates a captured context — no ``tracing.set_current(...)``
   call, no ``span``/``span_event`` with an explicit ``trace_id=`` /
   ``parent_id=``, and no context-like entry parameter.  Such spans
   start fresh traces, severing the causal chain the exporters stitch.
2. **Unbounded blocking in a dispatch scope**: ``Queue.get`` with no
   ``timeout``/``block=False`` (hangs forever when the producer dies),
   ``Queue.put`` on a *bounded* queue with no timeout (deadlocks when
   the consumer dies; puts on unbounded queues never block and are
   exempt), and bare ``lock.acquire()`` calls outside a ``with`` and
   without a timeout — all checked in functions reachable from a
   thread entry point or a thread-spawning dispatch function.
3. **Join under a lock the target needs**: ``t.join()`` executed while
   holding a lock that the joined thread's transitive closure also
   acquires — the join can never return (composes with TL121's lock
   graph).

Sanctioned escapes: hand the context explicitly
(``tracing.set_current(captured)`` or ``trace_id=`` kwargs), give every
blocking call a timeout and handle the Empty/Full, and join threads
only after releasing their locks — or write a justified
``# torchlint: disable=TL141``.  Same rule as jaxlint's JL141: the
servers' drain workers (``serve/engine.py``, ``serve/fleet.py``) hand the
submitter's context over with each queued request and parent their
``serve.request`` / ``serve.fleet.request`` events under it.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..context import dotted_name
from ..project import FuncInfo, FuncKey, ProjectContext
from .lock_order import _direct_locks, _locks_reachable

CODE = "TL141"
SHORT = ("spawned thread opens spans without a SpanContext handoff, "
         "blocks without a timeout in a dispatch scope, or joins a "
         "thread while holding a lock its target acquires")

PROJECT_RULE = True

_SPAN_OWNERS = {"obs", "tracing"}
_EVIDENCE_KWARGS = {"trace_id", "parent_id"}
_QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue"}


def _spawn_sites(project: ProjectContext) \
        -> List[Tuple[FuncKey, str, ast.Call]]:
    """(entry key, spawning module, spawn call node) per resolved
    ``threading.Thread(target=...)``."""
    out: List[Tuple[FuncKey, str, ast.Call]] = []
    for mname in sorted(project.modules):
        ctx = project.modules[mname].ctx
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if d is None or d.split(".")[-1] != "Thread":
                continue
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                r = _target_key(project, mname, ctx, node, kw.value)
                if r is not None:
                    out.append((r, mname, node))
    return out


def _target_key(project: ProjectContext, mname: str, ctx, spawn: ast.Call,
                value: ast.AST) -> Optional[FuncKey]:
    r = project._callable_ref(mname, ctx, value)
    if r is not None:
        return r
    if isinstance(value, ast.Name):
        # a nested `def worker()` in the function doing the spawning
        fi = project.enclosing_function(mname, spawn)
        if fi is not None:
            k = (mname, f"{fi.qualname}.<locals>.{value.id}")
            if k in project.functions:
                return k
    return None


# -- (1) span-without-handoff -----------------------------------------

def _trace_facts(project: ProjectContext, fi: FuncInfo) \
        -> Tuple[bool, bool]:
    """(opens spans, shows handoff evidence) for one function body."""
    spans = evidence = False
    for node in project.own_nodes(fi):
        if not isinstance(node, ast.Call):
            continue
        d = dotted_name(node.func)
        if d is None:
            continue
        parts = d.split(".")
        last = parts[-1]
        if last == "set_current":
            evidence = True
        elif last in ("span", "span_event") and len(parts) >= 2 \
                and parts[-2] in _SPAN_OWNERS:
            if last == "span":
                spans = True
            if any(kw.arg in _EVIDENCE_KWARGS for kw in node.keywords):
                evidence = True
    return spans, evidence


def _has_ctx_param(fi: FuncInfo) -> bool:
    a = fi.node.args
    names = [p.arg for p in list(a.posonlyargs) + list(a.args)
             + list(a.kwonlyargs)]
    return any(n != "self" and (n == "context" or n.endswith("ctx"))
               for n in names)


# -- (2) queue / lock bookkeeping -------------------------------------

def _queue_bounded(call: ast.Call) -> bool:
    """True when the queue is definitely or possibly bounded (a
    ``put`` can block); ``Queue()`` / ``Queue(0)`` never block."""
    val: Optional[ast.AST] = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "maxsize":
            val = kw.value
    if val is None:
        return False
    if isinstance(val, ast.Constant) and isinstance(val.value, int):
        return val.value > 0
    return True


def _known_queues(project: ProjectContext):
    """Queues by assignment: per-function locals and per-class
    ``self.<attr>``s, each mapped to a bounded? flag."""
    locs: Dict[FuncKey, Dict[str, bool]] = {}
    attrs: Dict[Tuple[str, str], Dict[str, bool]] = {}
    for key in sorted(project.functions):
        fi = project.functions[key]
        for node in project.own_nodes(fi):
            tgt, val = _assign_parts(node)
            if not isinstance(val, ast.Call):
                continue
            d = dotted_name(val.func)
            if d is None or d.split(".")[-1] not in _QUEUE_CTORS:
                continue
            bounded = _queue_bounded(val)
            if isinstance(tgt, ast.Name):
                locs.setdefault(key, {})[tgt.id] = bounded
            elif isinstance(tgt, ast.Attribute) \
                    and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id == "self" and fi.class_name:
                attrs.setdefault((fi.module, fi.class_name),
                                 {})[tgt.attr] = bounded
    return locs, attrs


def _assign_parts(node: ast.AST):
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        return node.targets[0], node.value
    if isinstance(node, ast.AnnAssign) and node.value is not None:
        return node.target, node.value
    return None, None


def _lookup_scoped(project: ProjectContext, fi: FuncInfo, name: str,
                   locs: Dict[FuncKey, Dict[str, object]]):
    """Resolve ``name`` through the lexical chain of enclosing
    functions (a nested ``drain()`` reads its parent's queue)."""
    cur: Optional[FuncInfo] = fi
    while cur is not None:
        got = locs.get(cur.key, {}).get(name)
        if got is not None:
            return got
        up = cur.qualname.rsplit(".<locals>.", 1)
        cur = project.functions.get((cur.module, up[0])) \
            if len(up) == 2 else None
    return None


def _receiver_queue(project: ProjectContext, fi: FuncInfo,
                    expr: ast.AST, locs, attrs) -> Optional[bool]:
    if isinstance(expr, ast.Name):
        return _lookup_scoped(project, fi, expr.id, locs)
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self" and fi.class_name:
        return attrs.get((fi.module, fi.class_name), {}).get(expr.attr)
    return None


def _blocking_forever(call: ast.Call, n_leading: int) -> bool:
    """True when a get/put/acquire call has neither a timeout nor a
    non-blocking flag.  ``n_leading`` = payload args before the
    block/timeout pair (1 for ``put(item, ...)``, 0 otherwise)."""
    args = call.args
    if len(args) > n_leading + 1:
        return False                      # positional timeout
    if len(args) == n_leading + 1:
        blk = args[n_leading]
        if isinstance(blk, ast.Constant) and blk.value is False:
            return False                  # positional block=False
    for kw in call.keywords:
        if kw.arg == "timeout":
            return False
        if kw.arg in ("block", "blocking") \
                and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return False
    return True


# -- (3) thread variables ---------------------------------------------

def _known_threads(project: ProjectContext):
    """Thread objects by assignment, mapped to their entry FuncKey."""
    locs: Dict[FuncKey, Dict[str, FuncKey]] = {}
    attrs: Dict[Tuple[str, str], Dict[str, FuncKey]] = {}
    for key in sorted(project.functions):
        fi = project.functions[key]
        ctx = project.ctx_for[fi.module]
        for node in project.own_nodes(fi):
            tgt, val = _assign_parts(node)
            if not isinstance(val, ast.Call):
                continue
            d = dotted_name(val.func)
            if d is None or d.split(".")[-1] != "Thread":
                continue
            entry = None
            for kw in val.keywords:
                if kw.arg == "target":
                    entry = _target_key(project, fi.module, ctx, val,
                                        kw.value)
            if entry is None:
                continue
            if isinstance(tgt, ast.Name):
                locs.setdefault(key, {})[tgt.id] = entry
            elif isinstance(tgt, ast.Attribute) \
                    and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id == "self" and fi.class_name:
                attrs.setdefault((fi.module, fi.class_name),
                                 {})[tgt.attr] = entry
    return locs, attrs


def check_project(project: ProjectContext):
    spawns = _spawn_sites(project)
    if not spawns:
        return
    entries = sorted({e for e, _, _ in spawns})

    # (1) spans opened on a spawned thread with no context handoff
    facts: Dict[FuncKey, Tuple[bool, bool]] = {}
    for entry, mname, node in spawns:
        closure = sorted(project.reachable_from([entry]))
        spans = evidence = False
        for k in closure:
            if k not in facts:
                facts[k] = _trace_facts(project, project.functions[k])
            s, ev = facts[k]
            spans = spans or s
            evidence = evidence or ev
        if spans and not evidence \
                and not _has_ctx_param(project.functions[entry]):
            ctx = project.ctx_for[mname]
            yield ctx.make_finding(
                CODE, node,
                f"thread entry `{entry[1]}` opens obs.span(...) but "
                "never receives the spawner's SpanContext — its spans "
                "start a fresh trace, severing the causal chain: "
                "capture the context before spawning and activate it "
                "with tracing.set_current(...) on the thread (or pass "
                "trace_id=/parent_id= explicitly)")

    # (2) blocking-forever calls in dispatch scopes
    spawners = sorted({project.enclosing_function(m, n).key
                       for _, m, n in spawns
                       if project.enclosing_function(m, n) is not None})
    qlocs, qattrs = _known_queues(project)
    scope = sorted(project.reachable_from(entries + spawners))
    for k in scope:
        fi = project.functions[k]
        ctx = project.ctx_for[fi.module]
        for node in project.own_nodes(fi):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            if attr in ("put", "get"):
                bounded = _receiver_queue(project, fi, node.func.value,
                                          qlocs, qattrs)
                if bounded is None:
                    continue
                if attr == "put" and not bounded:
                    continue      # puts on unbounded queues never block
                if _blocking_forever(node, 1 if attr == "put" else 0):
                    yield ctx.make_finding(
                        CODE, node,
                        f"`{attr}` on a queue with no timeout in a "
                        "thread dispatch scope: if the peer thread "
                        "dies this blocks forever — use "
                        f"`{attr}(..., timeout=...)`, handle "
                        "queue.Empty/Full, and check the peer is "
                        "still alive")
            elif attr == "acquire":
                d = dotted_name(node.func.value)
                if d is None or "lock" not in d.lower():
                    continue
                if _blocking_forever(node, 0):
                    yield ctx.make_finding(
                        CODE, node,
                        "bare `.acquire()` with no timeout in a "
                        "thread dispatch scope: use `with lock:` or "
                        "`acquire(timeout=...)` so a wedged peer "
                        "cannot hang the dispatcher forever")

    # (3) join while holding a lock the target's closure acquires
    tlocs, tattrs = _known_threads(project)
    direct = _direct_locks(project)
    lock_reach = _locks_reachable(project, direct)
    for k in sorted(project.functions):
        fi = project.functions[k]
        ctx = project.ctx_for[fi.module]
        for lid, with_node in direct.get(k, ()):
            for node in ctx.walk(with_node):
                if not isinstance(node, ast.Call) \
                        or not isinstance(node.func, ast.Attribute) \
                        or node.func.attr != "join":
                    continue
                if project.enclosing_function(fi.module, node) is not fi:
                    continue
                entry = _receiver_queue(project, fi, node.func.value,
                                        tlocs, tattrs)
                if entry is None:
                    continue
                if lid in lock_reach.get(entry, set()):
                    yield ctx.make_finding(
                        CODE, node,
                        f"`join()` on the `{entry[1]}` thread while "
                        f"holding `{lid}`, a lock that thread also "
                        "acquires: the join can never return — "
                        "release the lock before joining")
