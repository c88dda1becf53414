"""TL004 — a float64 host array moved to the card with no explicit dtype.

numpy computes in float64 by default (``np.zeros(n)``,
``np.asarray(list_of_floats)``, ``rng.standard_normal(n)``), and torch
keeps a numpy array's dtype when it moves: ``torch.as_tensor(x,
device=dev)`` of such an array is a float64 tensor on the card.  The
card's f64 rate is a fraction of its f32 rate, every buffer doubles, and
a kernel or a captured graph built for f32 meets an f64 tensor.  Where
f64 on the card is meant (the forest kernel's f64 rows, the exact
reductions), say so: ``dtype=torch.float64``.  Flagged, in device code:

- ``torch.as_tensor(x, device=...)`` / ``torch.tensor(x, device=...)``
  with no ``dtype``;
- ``torch.from_numpy(x).to(dev)`` / ``torch.as_tensor(x).to(dev)`` /
  ``.cuda()`` with no dtype in the ``.to(...)`` call;

where ``x`` is known to be float64: a numpy constructor or draw without
a ``dtype`` (``zeros``/``ones``/``empty``/``full``/``linspace``,
``standard_normal``/``normal``/``uniform``/``random`` of numpy's
generators), one with an f64 dtype (``np.float64``, ``"float64"``,
``float``), ``.astype(np.float64)``, ``np.float64(...)``, or a local
name every binding of which is one of those.  A move to ``"cpu"`` is
host code and exempt.

The torch analog of jaxlint's JL004 (float64 handed to ``jnp.``
constructors under disabled x64: silently truncated there, silently
kept here).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from ..context import FileContext, chain_root, dotted_name

CODE = "TL004"
SHORT = ("float64 numpy array moved to the card with no explicit dtype "
         "(an f64 tensor where f32 was meant)")

_F64_DEFAULT_CTORS = ("zeros", "ones", "empty", "full", "linspace",
                      "zeros_like", "ones_like", "full_like", "empty_like")
_F64_DRAWS = ("standard_normal", "normal", "uniform", "random", "rand",
              "randn", "exponential")
_DTYPE_CTORS = ("asarray", "array", "ascontiguousarray", "arange")


def _is_f64_dtype(ctx: FileContext, node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value in ("float64", "f8",
                                                         "double"):
        return True
    if isinstance(node, ast.Name) and node.id == "float":
        return True
    if isinstance(node, ast.Attribute) and node.attr in ("float64",
                                                         "double"):
        return chain_root(node) in ctx.numpy_aliases
    return False


def _dtype_arg(node: ast.Call, pos: int) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == "dtype":
            return kw.value
    return node.args[pos] if len(node.args) > pos else None


class _F64:
    """Float64-ness of numpy expressions in one scope."""

    def __init__(self, ctx: FileContext, scope: ast.AST):
        self.ctx = ctx
        self.rng_names = set()
        bindings: Dict[str, List[ast.AST]] = {}
        for n in ctx.walk(scope):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        bindings.setdefault(t.id, []).append(n.value)
                    else:
                        for e in ast.walk(t):
                            if isinstance(e, ast.Name):
                                bindings.setdefault(e.id, []).append(None)
            else:
                for t in _other_targets(n):
                    for e in ast.walk(t):
                        if isinstance(e, ast.Name):
                            bindings.setdefault(e.id, []).append(None)
                        elif isinstance(e, ast.arg):
                            bindings.setdefault(e.arg, []).append(None)
        for name, values in bindings.items():
            if values and all(v is not None and self._is_rng(v)
                              for v in values):
                self.rng_names.add(name)
        self.names = set()
        for _ in range(2):
            for name, values in bindings.items():
                if values and all(v is not None and self.is_f64(v)
                                  for v in values):
                    self.names.add(name)

    def _is_rng(self, node: ast.AST) -> bool:
        d = dotted_name(node.func) if isinstance(node, ast.Call) else None
        return d is not None and d.split(".")[0] in self.ctx.numpy_aliases \
            and d.split(".")[-1] in ("default_rng", "RandomState")

    def is_f64(self, node: ast.AST) -> bool:
        ctx = self.ctx
        if isinstance(node, ast.Name):
            return node.id in self.names
        if not isinstance(node, ast.Call):
            return False
        func = node.func
        d = dotted_name(func)
        if isinstance(func, ast.Attribute) and func.attr == "astype" \
                and node.args:
            return _is_f64_dtype(ctx, node.args[0])
        if d is None:
            # np.random.default_rng(s).standard_normal(n)
            return isinstance(func, ast.Attribute) \
                and func.attr in _F64_DRAWS \
                and isinstance(func.value, ast.Call) \
                and self._is_rng(func.value) \
                and _dtype_arg(node, 99) is None
        parts = d.split(".")
        root, tail = parts[0], parts[-1]
        if root in ctx.numpy_aliases:
            if tail in ("float64", "double"):
                return True
            if tail in _F64_DEFAULT_CTORS:
                dt = _dtype_arg(node, 2 if tail in ("full", "full_like")
                                else 1)
                if tail.endswith("_like"):
                    return dt is not None and _is_f64_dtype(ctx, dt)
                return dt is None or _is_f64_dtype(ctx, dt)
            if tail in _DTYPE_CTORS:
                dt = _dtype_arg(node, 1 if tail != "arange" else 99)
                return dt is not None and _is_f64_dtype(ctx, dt)
            if len(parts) == 3 and parts[1] == "random" \
                    and tail in _F64_DRAWS:
                return _dtype_arg(node, 99) is None
            return False
        if root in self.rng_names and len(parts) == 2 \
                and tail in _F64_DRAWS:
            return _dtype_arg(node, 99) is None
        return False


def _other_targets(n: ast.AST) -> List[ast.AST]:
    """What a non-``Assign`` binding statement binds: loop, ``with``,
    augmented and annotated targets, parameters."""
    if isinstance(n, (ast.AugAssign, ast.AnnAssign, ast.For,
                      ast.comprehension)):
        return [n.target]
    if isinstance(n, ast.With):
        return [it.optional_vars for it in n.items
                if it.optional_vars is not None]
    if isinstance(n, ast.arguments):
        return list(n.posonlyargs) + list(n.args) + list(n.kwonlyargs)
    return []


def _device_arg(node: ast.Call) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def _host_device(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _to_has_dtype(ctx: FileContext, call: ast.Call) -> bool:
    """``.to(...)`` names a dtype (a ``torch.<dtype>`` positional or a
    ``dtype=`` keyword)."""
    if any(kw.arg == "dtype" for kw in call.keywords):
        return True
    for a in call.args:
        d = dotted_name(a)
        if d is not None and d.split(".")[0] in ctx.torch_aliases \
                and d.split(".")[-1] not in ("device",):
            return True
    return False


def _moved_source(ctx: FileContext, node: ast.Call) -> Optional[ast.AST]:
    """The numpy array ``node`` moves to the card without a dtype, if
    any."""
    if ctx.is_torch_call(node, "as_tensor", "tensor") and node.args:
        dev = _device_arg(node)
        if dev is not None and not _host_device(dev) \
                and _dtype_arg(node, 99) is None:
            return node.args[0]
        return None
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in ("to", "cuda"):
        inner = func.value
        if not (isinstance(inner, ast.Call) and inner.args
                and ctx.is_torch_call(inner, "from_numpy", "as_tensor")
                and _dtype_arg(inner, 99) is None):
            return None
        if func.attr == "to":
            if not node.args and not any(kw.arg == "device"
                                         for kw in node.keywords):
                return None
            if _to_has_dtype(ctx, node) or (node.args
                                            and _host_device(node.args[0])):
                return None
        return inner.args[0]
    return None


def check(ctx: FileContext):
    if not ctx.torch_aliases or not ctx.numpy_aliases:
        return
    scopes: Dict[int, _F64] = {}
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        src = _moved_source(ctx, node)
        if src is None:
            continue
        scope = ctx.enclosing_scope(node)
        f64 = scopes.get(id(scope))
        if f64 is None:
            f64 = scopes[id(scope)] = _F64(ctx, scope)
        if f64.is_f64(src):
            yield ctx.make_finding(
                CODE, node,
                "a float64 numpy array moved to the card with no dtype "
                "becomes a float64 tensor (half the f32 rate, twice the "
                "bytes); pass dtype=torch.float32, or dtype=torch.float64 "
                "where f64 on the card is meant")
