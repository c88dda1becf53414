"""TL111 — int8 quantization dtype contract, project-wide.

The ``grad_quant_bits=8`` path is only exact (and only byte-equal to the
JAX package's) while the data stays integer from quantization to the one
dequantize point in the gain and leaf-value math: the stochastic
rounding of ``ops/histogram.py::quantize_gh_keys`` makes int8 stat
columns, kernel 1 accumulates them in int32, the scan of
``ops/split.py`` runs on int32 prefix sums, the refit sums base-128
digits in integers, and ONE ``.float() * scale`` ends the integer
region.  Per-function dtype dataflow (``.to(torch.int8)``,
``.char()``, constructors' ``dtype=``, ``.sum``/``index_add_``
accumulators, and the int8 results of project functions such as
``quantize_gh_keys``, through tuple unpacking) drives two checks:

1. **int8 reduced without a wide accumulator**: a contraction
   (``torch.matmul``/``mm``/``bmm``/``einsum``/``tensordot``/``dot``/
   ``@``) over an int8 operand (torch keeps int8 and wraps; use
   ``torch._int_mm`` or cast to int32 first), a ``sum``/``cumsum`` of an
   int8 value with an 8- or 16-bit ``dtype=``, or an ``index_add_``/
   ``scatter_add_``/``index_put_(..., accumulate=True)`` into an int8
   target.
2. **Premature float upcast**: ``.float()``/``.half()``/
   ``.bfloat16()``/``.double()``/``.to(<float dtype>)`` of an int8
   value, or of int32/int64 *quantized accumulation state* (an int8
   value reduced into a wide integer, and values derived from it),
   UNLESS it is the sanctioned dequantize idiom (an immediate multiply
   or divide by a ``*scale*``-named value) or lives in a function whose
   name mentions ``dequant``.

The torch analog of jaxlint's JL111 (an int8 ``einsum`` without
``preferred_element_type``, an f32 ``astype`` upstream of the scan).
Its third check, f64 constants under disabled x64, has no torch
counterpart: torch keeps f64 (TL004 covers that side).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..context import FileContext, chain_root, dotted_name
from ..project import FuncKey, ProjectContext

CODE = "TL111"
SHORT = ("int8 dtype-contract break: int8 reduced without an int32/int64 "
         "accumulator, or quantized state upcast to a float before the "
         "dequantize point")

PROJECT_RULE = True

_INT8 = "int8"
_INTQ = "intq"           # wide integer quantized accumulation state
_WIDE = "wide"           # int32/int64 (not derived from int8)
_FLOAT = "float"
_CONTRACTIONS = ("matmul", "mm", "bmm", "einsum", "tensordot", "dot",
                 "mv", "inner", "linear")
_ACCUMULATE = ("index_add_", "scatter_add_", "index_add", "scatter_add")
_UPCAST_METHODS = ("float", "half", "bfloat16", "double")
_FLOAT_DTYPES = ("float32", "float", "float16", "half", "bfloat16",
                 "float64", "double")
_SCALE_HINT = ("scale", "qscale", "dequant")
_SHAPE_KEEPING = ("reshape", "view", "transpose", "t", "contiguous",
                  "squeeze", "unsqueeze", "flatten", "clone", "permute",
                  "expand", "narrow", "index_select", "gather", "abs",
                  "neg", "clamp", "clamp_", "masked_fill", "roll", "flip")


def _dtype_tag(ctx: FileContext, node: ast.AST) -> Optional[str]:
    """Tag of a dtype expression: ``torch.int8`` -> int8, wide ints ->
    wide, floats -> float."""
    d = dotted_name(node)
    if d is None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            d = node.value
        else:
            return None
    tail = d.split(".")[-1]
    if tail in ("int8", "char"):
        return _INT8
    if tail in ("int32", "int64", "int", "long"):
        return _WIDE
    if tail in _FLOAT_DTYPES:
        return _FLOAT
    return None


def _kw(node: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


class _Env:
    """Per-scope inferred tags, line-aware: a use at line L sees the
    binding in effect BEFORE L (``m8 = m8.float()`` must see the int8
    ``m8`` on its right-hand side)."""

    def __init__(self):
        self.bindings: Dict[str, List[Tuple[int, Optional[str]]]] = {}

    def bind(self, name: str, line: int, tag: Optional[str]) -> None:
        self.bindings.setdefault(name, []).append((line, tag))

    def get(self, name: str, line: int) -> Optional[str]:
        best = None
        for bl, tag in self.bindings.get(name, ()):
            if bl < line:
                best = tag
        return best


class _Flow:
    """Tag inference over one scope, with project return summaries."""

    def __init__(self, project: ProjectContext, ctx: FileContext, fi,
                 returns: Dict[FuncKey, list]):
        self.project = project
        self.ctx = ctx
        self.fi = fi
        self.returns = returns
        self.env = _Env()

    def infer(self, node: ast.AST, line: int) -> Optional[str]:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, line)
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                          ast.Name) \
                and node.value.id == "self":
            return self.env.get(f"self.{node.attr}", line)
        if isinstance(node, ast.Subscript):
            return self.infer(node.value, line)
        if isinstance(node, ast.BinOp):
            lt = self.infer(node.left, line)
            rt = self.infer(node.right, line)
            if isinstance(node.op, ast.MatMult) and _INT8 in (lt, rt):
                return _INT8
            if lt == rt:
                return lt
            pair = {lt, rt}
            if _FLOAT in pair:
                return _FLOAT
            if _INTQ in pair:
                return _INTQ
            if None in pair:
                t = lt or rt
                # int arithmetic with an unknown (likely scalar) operand
                # keeps the known integer tag
                return t if t in (_INT8, _INTQ, _WIDE) else None
            return _WIDE
        if isinstance(node, ast.UnaryOp):
            return self.infer(node.operand, line)
        if isinstance(node, ast.Call):
            return self._call(node, line)
        return None

    def _call(self, node: ast.Call, line: int) -> Optional[str]:
        ctx = self.ctx
        func = node.func
        if isinstance(func, ast.Attribute):
            attr = func.attr
            if attr == "to" or attr == "type":
                dt = _kw(node, "dtype")
                for a in node.args:
                    if dt is None and _dtype_tag(ctx, a) is not None:
                        dt = a
                if dt is not None:
                    tag = _dtype_tag(ctx, dt)
                    if tag == _WIDE and self.infer(func.value, line) == _INTQ:
                        return _INTQ    # widening keeps quantized state
                    return tag
                return self.infer(func.value, line)
            if attr == "char":
                return _INT8
            if attr in ("int", "long"):
                base = self.infer(func.value, line)
                return _INTQ if base == _INTQ else _WIDE
            if attr in _UPCAST_METHODS:
                return _FLOAT
            if attr in ("sum", "cumsum"):
                base = self.infer(func.value, line)
                dt = _kw(node, "dtype")
                if dt is not None and _dtype_tag(ctx, dt) == _FLOAT:
                    return _FLOAT
                if base == _INT8:
                    return _INT8 if dt is not None \
                        and _dtype_tag(ctx, dt) == _INT8 else _INTQ
                return base
            if attr in _ACCUMULATE or (attr in ("index_put_", "index_put")
                                       and _kw(node, "accumulate")):
                base = self.infer(func.value, line)
                src = [self.infer(a, line) for a in node.args]
                if base in (_WIDE, _INTQ) and (_INT8 in src
                                               or _INTQ in src):
                    return _INTQ
                return base
            if attr in _SHAPE_KEEPING:
                return self.infer(func.value, line)
        d = dotted_name(func)
        if d is None:
            return None
        parts = d.split(".")
        tail = parts[-1]
        if parts[0] in ctx.torch_aliases:
            if tail in _CONTRACTIONS:
                ops = [self.infer(a, line) for a in node.args]
                if _INT8 in ops:
                    return _INT8
                return _INTQ if _INTQ in ops else None
            if tail == "_int_mm":
                return _INTQ
            if tail in ("sum", "cumsum") and node.args:
                base = self.infer(node.args[0], line)
                dt = _kw(node, "dtype")
                if base == _INT8:
                    return _INT8 if dt is not None \
                        and _dtype_tag(ctx, dt) == _INT8 else _INTQ
                return base
            if tail in ("stack", "cat") and node.args \
                    and isinstance(node.args[0], (ast.List, ast.Tuple)):
                tags = {self.infer(e, line) for e in node.args[0].elts}
                return tags.pop() if len(tags) == 1 else None
            if tail == "where" and len(node.args) == 3:
                a = self.infer(node.args[1], line)
                b = self.infer(node.args[2], line)
                return a if a == b else None
            dt = _kw(node, "dtype")
            if dt is not None:
                return _dtype_tag(ctx, dt)
            return None
        # a project function's int8 / quantized result
        for callee in sorted(self.project.resolve_call(self.fi, node)
                             if self.fi is not None else ()):
            got = self.returns.get(callee)
            if got and got[0] is not None and not isinstance(got[0], list):
                return got[0]
        return None

    def tuple_tags(self, node: ast.Call) -> Optional[list]:
        """Element tags of a project function's tuple result."""
        if self.fi is None:
            return None
        for callee in sorted(self.project.resolve_call(self.fi, node)):
            got = self.returns.get(callee)
            if got and isinstance(got[0], list):
                return got[0]
        return None

    def run(self, body: ast.AST) -> None:
        """Bind the scope's assignments in source order."""
        assigns = [n for n in _scope_walk(body)
                   if isinstance(n, ast.Assign) and len(n.targets) == 1]
        assigns.sort(key=lambda n: (n.lineno, n.col_offset))
        for a in assigns:
            t = a.targets[0]
            if isinstance(t, ast.Tuple) and isinstance(a.value, ast.Call):
                tags = self.tuple_tags(a.value)
                if tags and len(tags) == len(t.elts):
                    for e, tag in zip(t.elts, tags):
                        if isinstance(e, ast.Name) and tag is not None:
                            self.env.bind(e.id, a.lineno, tag)
                continue
            tag = self.infer(a.value, a.lineno)
            if isinstance(t, ast.Name):
                self.env.bind(t.id, a.lineno, tag)
            elif isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                self.env.bind(f"self.{t.attr}", a.lineno, tag)

    def return_tag(self, body: ast.AST):
        """Tag of the scope's return value (a list of element tags for a
        tuple), from its last ``return``."""
        rets = [n for n in _scope_walk(body)
                if isinstance(n, ast.Return) and n.value is not None]
        if not rets:
            return None
        r = max(rets, key=lambda n: n.lineno)
        line = r.lineno + 1
        if isinstance(r.value, ast.Tuple):
            tags = [self.infer(e, line) for e in r.value.elts]
            return tags if any(t in (_INT8, _INTQ) for t in tags) else None
        tag = self.infer(r.value, line)
        return tag if tag in (_INT8, _INTQ) else None


def _scope_walk(root: ast.AST):
    """Walk ``root`` without descending into nested function scopes."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scale_multiplied(ctx: FileContext, node: ast.AST) -> bool:
    """The upcast result is immediately multiplied or divided by a value
    whose source text mentions a scale: the dequantize idiom."""
    parent = ctx.parent(node)
    if not (isinstance(parent, ast.BinOp)
            and isinstance(parent.op, (ast.Mult, ast.Div))):
        return False
    other = parent.right if parent.left is node else parent.left
    try:
        text = ast.unparse(other).lower()
    except Exception:   # noqa: BLE001 -- best effort
        return False
    return any(h in text for h in _SCALE_HINT)


def _upcast_of(ctx: FileContext, node: ast.Call) -> Optional[ast.AST]:
    """The value ``node`` upcasts to a float, if it is an upcast."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _UPCAST_METHODS and not node.args:
        return func.value
    if func.attr in ("to", "type"):
        dt = _kw(node, "dtype") or next(
            (a for a in node.args if _dtype_tag(ctx, a) is not None), None)
        if dt is not None and _dtype_tag(ctx, dt) == _FLOAT:
            return func.value
    return None


def _check_scope(flow: _Flow, name: str, body: ast.AST):
    ctx = flow.ctx
    dequant_fn = "dequant" in name.lower()
    for node in _scope_walk(body):
        line = getattr(node, "lineno", 0)
        # (1a) int8 contraction (a function or the @ operator)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            if _INT8 in (flow.infer(node.left, line),
                         flow.infer(node.right, line)):
                yield ctx.make_finding(
                    CODE, node,
                    "`@` over an int8 operand: torch keeps int8 and wraps; "
                    "use torch._int_mm or cast to int32 first")
            continue
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        d = dotted_name(func)
        tail = d.split(".")[-1] if d else None
        if d is not None and chain_root(func) in ctx.torch_aliases \
                and tail in _CONTRACTIONS \
                and _INT8 in [flow.infer(a, line) for a in node.args]:
            yield ctx.make_finding(
                CODE, node,
                f"`{tail}` over an int8 operand: torch keeps int8 and "
                "wraps; use torch._int_mm or cast to int32 first, so the "
                "sums stay exact")
        if isinstance(func, ast.Attribute):
            # (1b) narrow-dtype sum of int8
            if func.attr in ("sum", "cumsum"):
                dt = _kw(node, "dtype")
                if dt is not None and _dtype_tag(ctx, dt) == _INT8 \
                        and flow.infer(func.value, line) == _INT8:
                    yield ctx.make_finding(
                        CODE, node,
                        f"`.{func.attr}(dtype=int8)` of int8 values wraps; "
                        "accumulate in int32 or int64")
            # (1c) accumulation into an int8 target
            if (func.attr in _ACCUMULATE
                    or (func.attr == "index_put_"
                        and _kw(node, "accumulate") is not None)) \
                    and flow.infer(func.value, line) == _INT8:
                yield ctx.make_finding(
                    CODE, node,
                    f"`{func.attr}` accumulates into an int8 tensor: the "
                    "sums wrap past 127; accumulate into int32 or int64")
        # (2) premature float upcast of quantized state
        src = _upcast_of(ctx, node)
        if src is not None and not dequant_fn:
            tag = flow.infer(src, line)
            if tag in (_INT8, _INTQ) and not _scale_multiplied(ctx, node):
                kind = ("int8-quantized value" if tag == _INT8
                        else "integer quantized accumulation state")
                yield ctx.make_finding(
                    CODE, node,
                    f"float upcast of {kind} outside the dequantize point: "
                    "keep the sums and the scan integer and dequantize "
                    "once at the gain/leaf-value math "
                    "(`.float() * scale`)")


#: identifiers without which a scope can hold no int8 or quantized value
_MARKERS = frozenset({"int8", "char", "_int_mm"})


def _identifiers(nodes) -> set:
    out = set()
    for node in nodes:
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.Constant) and node.value == "int8":
            out.add("int8")
    return out


def _relevant(idents: set, returns: Dict[FuncKey, list],
              project: ProjectContext) -> bool:
    """A scope can carry a tag only when it names int8 or calls a
    function whose result is tagged."""
    if idents & _MARKERS:
        return True
    return any(project.functions[k].name in idents for k in returns)


def _return_summaries(project: ProjectContext,
                      idents: Dict[FuncKey, set]) -> Dict[FuncKey, list]:
    """Fixpoint of the int8/quantized return tags of project functions."""
    returns: Dict[FuncKey, list] = {}
    for _ in range(3):
        changed = False
        for key in sorted(project.functions):
            if not _relevant(idents[key], returns, project):
                continue
            fi = project.functions[key]
            flow = _Flow(project, project.ctx_for[fi.module], fi, returns)
            flow.run(fi.node)
            tag = flow.return_tag(fi.node)
            if tag is not None and returns.get(key) != [tag]:
                returns[key] = [tag]
                changed = True
        if not changed:
            break
    return returns


def check_project(project: ProjectContext):
    idents = {key: _identifiers(project.own_nodes(fi))
              for key, fi in project.functions.items()}
    returns = _return_summaries(project, idents)
    for mname in sorted(project.modules):
        ctx = project.modules[mname].ctx
        if not ctx.torch_aliases:
            continue
        if _relevant(_identifiers(project.module_level_nodes(mname)),
                     returns, project):
            flow = _Flow(project, ctx, None, returns)
            flow.run(ctx.tree)
            yield from _check_scope(flow, "<module>", ctx.tree)
        for key in sorted(project.functions):
            fi = project.functions[key]
            if fi.module != mname \
                    or not _relevant(idents[key], returns, project):
                continue
            flow = _Flow(project, ctx, fi, returns)
            flow.run(fi.node)
            yield from _check_scope(flow, fi.name, fi.node)
