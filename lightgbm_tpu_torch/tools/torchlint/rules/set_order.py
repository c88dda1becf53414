"""TL005 — iteration order of a ``set`` leaking into output.

Python sets iterate in hash order: stable within one process, but
different across runs (PYTHONHASHSEED for strings) and across
insertion histories.  Where the iteration order affects output —
callback execution order, serialized lists, score accumulation order —
the result is nondeterministic: the callback-dedupe bug class (a
``set()`` of callbacks run in hash order) that ``engine.py`` avoids with
an ordered dedupe.  Same rule as jaxlint's JL005.  Flagged
order-sensitive consumers:

- ``for x in <set>:`` and comprehension iteration over a set
- ``list(<set>)``, ``tuple(<set>)``, ``enumerate(<set>)``,
  ``iter(<set>)``, ``reversed(<set>)``, ``", ".join(<set>)``

Membership tests, ``len``/``sum``/``min``/``max``/``any``/``all`` and
``sorted(<set>)`` are order-insensitive and exempt.  A "set" is a set
literal/comprehension, a ``set(...)``/``frozenset(...)`` call, or a name
locally assigned from one.
"""

from __future__ import annotations

import ast

from ..context import FileContext

CODE = "TL005"
SHORT = ("iteration over a set where order affects output "
         "(nondeterministic across runs); sort or use an ordered "
         "container")

_ORDER_SENSITIVE_FUNCS = ("list", "tuple", "enumerate", "iter", "reversed")


def _is_set_expr(ctx: FileContext, node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.Name):
        return node.id in ctx.set_names(node)
    return False


def _finding(ctx: FileContext, node: ast.AST, how: str):
    return ctx.make_finding(
        CODE, node,
        f"{how} iterates a set in hash order — nondeterministic across "
        "runs when the order reaches the output; use sorted(...), a "
        "list-based dedupe, or an insertion-ordered dict")


def check(ctx: FileContext):
    for node in ctx.nodes:
        if isinstance(node, ast.For):
            if _is_set_expr(ctx, node.iter):
                yield _finding(ctx, node.iter, "`for` loop")
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if _is_set_expr(ctx, gen.iter):
                    yield _finding(ctx, gen.iter, "comprehension")
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) \
                    and node.func.id in _ORDER_SENSITIVE_FUNCS \
                    and node.args and _is_set_expr(ctx, node.args[0]):
                yield _finding(ctx, node.args[0],
                               f"{node.func.id}(...)")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join" and node.args \
                    and _is_set_expr(ctx, node.args[0]):
                yield _finding(ctx, node.args[0], "str.join(...)")
