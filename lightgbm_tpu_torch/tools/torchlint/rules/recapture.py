"""TL002 — CUDA-graph recapture hazards.

The port's counterpart of an XLA compile is a CUDA-graph capture: a
tree's pieces are captured once per grower (``ops/grow.py::_build_graph``
through ``ops/graphs.py::GraphSet.capture``) and the composed graph is
replayed for every later tree.  A capture that is redone on every call
turns "training" into "capturing" (the capture telemetry,
``obs/capture_track.py``, counts exactly this), and a captured body that
branches in Python on a device value either fails the capture (a host
read is not permitted while the stream captures) or bakes in the branch
taken at capture time.  Two statically visible hazard shapes:

1. **Captured and dropped**: a ``torch.cuda.CUDAGraph(...)``, a
   ``torch.cuda.make_graphed_callables(...)`` or a
   ``GraphSet.capture(fn)`` whose graph never leaves the function that
   captured it: not stored on an attribute or into a container, not
   passed on, not returned.  Each call captures anew; hold the graph in
   a cache keyed by what shapes it (``grower_key``) and replay it.
2. **Python branch on a device value inside a captured body**: an
   ``if``/``while``/conditional expression/``assert`` whose test reads a
   tensor's value (a ``torch.``-rooted expression, a name assigned from
   one, ``.item()``, or a scalar read ``int(x[i])`` of a non-numpy
   value) inside a function handed to a capture (``X.capture(fn)``,
   ``make_graphed_callables``, resolved within the file, through
   ``functools.partial`` and same-file calls) or a ``with
   torch.cuda.graph(...)`` block.  Use ``torch.where``, a masked update
   or a device control word (``ops/graphs.py``'s WHILE nodes read one).

The torch analog of jaxlint's JL002 (a jit signature that churns, a
Python branch on a traced value, ``jax.jit(f)(x)`` per call).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..context import FileContext, dotted_name, unwrap_partial
from ..project import is_capture_method_call, is_graph_context
from .host_sync import _tensor_source

CODE = "TL002"
SHORT = ("graph recapture: a CUDA graph captured and dropped per call, "
         "or a Python branch on a device value inside a captured body")

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def is_capture_site(ctx: FileContext, node: ast.AST) -> bool:
    """A call that captures a CUDA graph."""
    return isinstance(node, ast.Call) and (
        ctx.is_torch_call(node, "CUDAGraph", "make_graphed_callables")
        or is_capture_method_call(node))


def _statement_of(ctx: FileContext, node: ast.AST) -> ast.AST:
    cur = node
    while not isinstance(cur, ast.stmt):
        cur = ctx.parent(cur)
    return cur


def _passed_on(ctx: FileContext, node: ast.AST, stmt: ast.AST) -> bool:
    """``node`` is (inside) an argument of a call other than
    ``torch.cuda.graph(...)`` within ``stmt``: handed to a container or
    another function."""
    cur = node
    while cur is not stmt:
        parent = ctx.parent(cur)
        if isinstance(parent, ast.Call) and cur is not parent.func \
                and not is_graph_context(ctx, parent):
            return True
        cur = parent
    return False


def _kept(ctx: FileContext, node: ast.AST,
          seen: Optional[Set[str]] = None) -> bool:
    """Whether the value of expression ``node`` outlives its function:
    stored on an attribute or into a subscript, passed on, returned."""
    seen = set() if seen is None else seen
    parent = ctx.parent(node)
    if isinstance(parent, ast.Attribute) or (
            isinstance(parent, ast.Call) and parent.func is node):
        return False    # used on the spot (`.replay()`, called): dropped
    stmt = _statement_of(ctx, node)
    if _passed_on(ctx, node, stmt):
        return True
    if isinstance(stmt, ast.Return) or (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, (ast.Yield, ast.YieldFrom))):
        return True
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, ast.AnnAssign):
        targets = [stmt.target]
    names = []
    for t in targets:
        if isinstance(t, (ast.Attribute, ast.Subscript)):
            return True
        if isinstance(t, ast.Name) and t.id not in seen:
            names.append(t.id)
    seen.update(names)
    fn = ctx.enclosing_function(node)
    if fn is None or not names:
        return False
    # a local: kept when any later use of the name keeps it
    for sub in ctx.walk(fn):
        if isinstance(sub, ast.Name) and sub.id in names \
                and isinstance(sub.ctx, ast.Load) \
                and ctx.enclosing_function(sub) is fn \
                and _kept(ctx, sub, seen):
            return True
    return False


def _captured_bodies(ctx: FileContext) -> List[ast.AST]:
    """Function bodies and ``with torch.cuda.graph`` blocks that run under
    a capture, resolved within this file (same-file calls followed)."""
    classes: Dict[int, ast.ClassDef] = {}
    methods: Dict[tuple, ast.AST] = {}
    top: Dict[str, ast.AST] = {}
    for node in ctx.nodes:
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt, _FUNCS):
                    methods[(node.name, stmt.name)] = stmt
                    classes[id(stmt)] = node
    for stmt in ctx.tree.body:
        if isinstance(stmt, _FUNCS):
            top[stmt.name] = stmt

    def ref(node: ast.AST, site: ast.AST) -> Optional[ast.AST]:
        d = dotted_name(unwrap_partial(node))
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] == "self" and len(parts) == 2:
            fn = ctx.enclosing_function(site)
            while fn is not None and id(fn) not in classes:
                fn = ctx.enclosing_function(fn)
            if fn is not None:
                return methods.get((classes[id(fn)].name, parts[1]))
            return None
        if len(parts) == 1:
            return top.get(parts[0])
        return None

    bodies: List[ast.AST] = []
    stack: List[ast.AST] = []
    for node in ctx.nodes:
        if isinstance(node, ast.With) and any(
                is_graph_context(ctx, it.context_expr) for it in node.items):
            bodies.append(node)
            stack.extend(n for n in ctx.walk(node) if isinstance(n, ast.Call))
        elif isinstance(node, ast.Call) and node.args and (
                is_capture_method_call(node)
                or ctx.is_torch_call(node, "make_graphed_callables")):
            fn = ref(node.args[0], node)
            if fn is not None:
                bodies.append(fn)
    seen: Set[int] = {id(b) for b in bodies}
    work = [b for b in bodies if isinstance(b, _FUNCS)]
    while work or stack:
        if work:
            fn = work.pop()
            stack.extend(n for n in ctx.walk(fn) if isinstance(n, ast.Call))
            continue
        call = stack.pop()
        callee = ref(call.func, call)
        if callee is not None and id(callee) not in seen:
            seen.add(id(callee))
            bodies.append(callee)
            work.append(callee)
    return bodies


def _device_test(ctx: FileContext, test: ast.AST) -> bool:
    if _tensor_source(ctx, test, ctx.tensor_names(test)):
        return True
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == "item" and not sub.args \
                and not ctx.is_numpy_expr(sub.func.value):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id in ("int", "float", "bool") \
                and len(sub.args) == 1 \
                and isinstance(sub.args[0], ast.Subscript) \
                and not ctx.is_numpy_expr(sub.args[0].value) \
                and not (isinstance(sub.args[0].value, ast.Attribute)
                         and sub.args[0].value.attr in ("shape", "stride")):
            return True
    return False


def check(ctx: FileContext):
    # (1) captured and dropped
    for node in ctx.nodes:
        if is_capture_site(ctx, node) and not _kept(ctx, node):
            yield ctx.make_finding(
                CODE, node,
                "a CUDA graph captured here never leaves this function: "
                "every call captures anew; keep the graph (on the owner or "
                "in a cache keyed by what shapes it) and replay it")

    # (2) Python branch on a device value inside a captured body
    reported: Set[int] = set()
    for body in _captured_bodies(ctx):
        for sub in ctx.walk(body):
            if isinstance(sub, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                if id(sub) in reported or not _device_test(ctx, sub.test):
                    continue
                reported.add(id(sub))
                kind = {ast.If: "if", ast.While: "while",
                        ast.IfExp: "conditional expression",
                        ast.Assert: "assert"}[type(sub)]
                yield ctx.make_finding(
                    CODE, sub,
                    f"Python `{kind}` on a device value inside a captured "
                    "body: the host read fails the capture or bakes in the "
                    "branch taken at capture time; use torch.where, a "
                    "masked update or a device control word")
