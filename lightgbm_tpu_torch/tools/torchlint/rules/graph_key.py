"""TL101 — graph-key completeness around ``grower_key`` / ``plan_signature``.

A cached grower's captured CUDA graphs (``ops/grow.py::acquire_grower``)
and the stage plans kept in the process and on disk
(``ops/stage_plan.py``) are reused under a key.  The reuse is correct
only while the key covers EVERYTHING that shapes what the grower
captures, and nothing that is merely written into a buffer at launch:

* a layout bound such as ``INT32_SCAN_ROWS`` left out of
  ``plan_signature`` would hand a grower captured under one scan to a
  booster that needs the other; and
* ``learning_rate`` hashed into the key would make every
  ``reset_parameter``/learning-rate schedule step miss the cache and
  capture anew, although the captured tree reads it from a buffer
  (``st.lr.fill_(...)`` before each launch).

A "signature module" is a module that defines ``grower_key`` or
``plan_signature``, or calls ``capture_track.signature_of(...)`` (the
capture telemetry's signature).  Three checks, driven by the project
symbol table:

1. **Missing capture-shaping constant**: a module-level ``UPPER_CASE``
   constant of a signature module compared (or ``min``/``max``-ed)
   against a shape-carrying value (``num_data``, ``n_pad``, ``rows``,
   ``num_leaves``, ...) selects what is captured, so it must appear in
   the key functions (or the ``signature_of`` arguments).  A compare
   that only refuses (its ``if`` body raises or appends a message) and a
   host bookkeeping bound (``len(cache) > MAX``) are exempt: they never
   select a layout.  Modules without a signature site (the forest
   kernel's per-call launch geometry in ``serve/packed.py``) cache
   nothing under a key and are not checked.
2. **Excluded param read under a capture**: a config attribute listed in
   the key's exclusion sets (the string sets the key functions hand to
   ``_config_digest``, e.g. ``_NON_CAPTURE_PARAMS``) must never be read
   inside a captured region (a function handed to ``GraphSet.capture``,
   what it calls, or a ``with torch.cuda.graph(...)`` block): the graph
   would bake in a value the key does not cover.
3. **Launch-time param in the key**: a config attribute converted with
   ``float(...)`` and written into a device buffer (``.fill_``,
   ``.copy_``, an item assignment) is a launch-time input; it must be in
   the exclusion sets, or each change of it misses the grower cache.

The torch analog of jaxlint's JL101 (``programs_signature`` and its
``_NON_TRACE_PARAMS``).  Over-keying a genuinely shape-selecting
constant is always safe (it only costs cache hits), so the fix for
check 1 is to add the constant to the signature; for check 3, to extend
the exclusion set.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ..context import FileContext, dotted_name
from ..project import ProjectContext

CODE = "TL101"
SHORT = ("graph-key completeness: capture-shaping constants missing from "
         "grower_key/plan_signature, or launch-time values hashed into it")

PROJECT_RULE = True

_SIGNATURE_FN_NAMES = ("grower_key", "plan_signature")
_CONST_RE = re.compile(r"^_?[A-Z][A-Z0-9_]*$")
_SHAPE_HINT_RE = re.compile(
    r"num_data|n_pad|num_valid|rows|bucket|num_features|num_groups|"
    r"frontier|\bshape\b|num_leaves|length|\bnb\b|hist_cols")
_BUFFER_WRITES = ("fill_", "copy_", "index_fill_", "index_copy_",
                  "masked_fill_")


def _expr_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:   # noqa: BLE001 -- best effort
        return ""


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_signature_of(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = dotted_name(node.func)
    return d is not None and d.split(".")[-1] == "signature_of"


def _signature_sites(project: ProjectContext) \
        -> Dict[str, List[Tuple[str, ast.AST, list]]]:
    """module -> [(label, node, same-module helper nodes)] of its key
    functions and ``signature_of`` calls."""
    out: Dict[str, List[Tuple[str, ast.AST, list]]] = {}
    for fi in project.functions.values():
        if fi.name in _SIGNATURE_FN_NAMES:
            helpers = [project.functions[c].node
                       for c in sorted(project.calls.get(fi.key, ()))
                       if c[0] == fi.module]
            out.setdefault(fi.module, []).append((fi.name, fi.node,
                                                  helpers))
    for mname, mod in project.modules.items():
        for node in mod.ctx.nodes:
            if _is_signature_of(node):
                out.setdefault(mname, []).append(("signature_of", node, []))
    return out


def _refusal(ctx: FileContext, compare: ast.AST) -> bool:
    """The compare is an ``if`` test whose body only refuses: raises, or
    appends a message to a list of refusals."""
    parent = ctx.parent(compare)
    while isinstance(parent, (ast.BoolOp, ast.UnaryOp)):
        parent = ctx.parent(parent)
    if isinstance(parent, ast.Assert):
        return True
    if not isinstance(parent, ast.If):
        return False
    for stmt in parent.body:
        if isinstance(stmt, ast.Raise):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) \
                and isinstance(stmt.value.func, ast.Attribute) \
                and stmt.value.func.attr == "append" \
                and all(isinstance(a, (ast.JoinedStr, ast.Constant))
                        for a in stmt.value.args):
            continue
        return False
    return True


def _shape_compared_constants(ctx: FileContext, mod_consts: Set[str],
                              skip_nodes: List[ast.AST]) \
        -> Dict[str, List[ast.AST]]:
    """Constants used as a direct comparand/min/max operand against a
    shape-carrying expression; every usage node per constant."""
    out: Dict[str, List[ast.AST]] = {}

    def direct_operand_names(node: ast.AST) -> Set[str]:
        # names reachable through arithmetic only (no subscripts/calls)
        if isinstance(node, ast.Name):
            return {node.id}
        if isinstance(node, ast.BinOp):
            return direct_operand_names(node.left) \
                | direct_operand_names(node.right)
        if isinstance(node, ast.UnaryOp):
            return direct_operand_names(node.operand)
        return set()

    def consider(const_sides: List[ast.AST], other_sides: List[ast.AST],
                 site: ast.AST):
        other_text = " ".join(_expr_text(o) for o in other_sides)
        if not _SHAPE_HINT_RE.search(other_text):
            return
        for side in const_sides:
            for name in direct_operand_names(side):
                if name in mod_consts:
                    out.setdefault(name, []).append(site)

    for node in ctx.nodes:
        if any(ctx.is_ancestor(s, node) or s is node for s in skip_nodes):
            continue
        if isinstance(node, ast.Compare):
            if _refusal(ctx, node):
                continue
            sides = [node.left] + list(node.comparators)
            for i, side in enumerate(sides):
                consider([side], sides[:i] + sides[i + 1:], node)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Name) \
                and node.func.id in ("min", "max") and len(node.args) >= 2:
            for i, a in enumerate(node.args):
                consider([a], list(node.args[:i] + node.args[i + 1:]),
                         node)
    return out


def _string_set(mod, value: ast.AST, depth: int = 0) -> Optional[Set[str]]:
    """Members of a module-level set of parameter names: a tuple/list/set
    literal of strings, ``frozenset``/``set``/``tuple`` of one, unions
    and differences of such, or the name of another."""
    if depth > 8:
        return None
    if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
        out = set()
        for e in value.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            out.add(e.value)
        return out or None
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
            and value.func.id in ("frozenset", "set", "tuple") \
            and len(value.args) == 1:
        return _string_set(mod, value.args[0], depth + 1)
    if isinstance(value, ast.BinOp) and isinstance(value.op, (ast.BitOr,
                                                              ast.Sub)):
        a = _string_set(mod, value.left, depth + 1)
        b = _string_set(mod, value.right, depth + 1)
        if a is None or b is None:
            return None
        return a | b if isinstance(value.op, ast.BitOr) else a - b
    if isinstance(value, ast.Name) and value.id in mod.assigns:
        return _string_set(mod, mod.assigns[value.id], depth + 1)
    return None


def _exclusions(mod, sites) -> Tuple[List[str], Set[str]]:
    """(names, members) of the parameter-name sets the key functions (or
    their same-module helpers, defaults included) refer to."""
    names: List[str] = []
    members: Set[str] = set()
    for _label, node, helpers in sites:
        for n in [node] + helpers:
            for name in sorted(_names_in(n)):
                if name in names or name not in mod.assigns \
                        or not _CONST_RE.match(name):
                    continue
                got = _string_set(mod, mod.assigns[name])
                if got:
                    names.append(name)
                    members |= got
    return names, members


def _config_attr_reads(ctx: FileContext,
                       tree: ast.AST) -> List[ast.Attribute]:
    """``config.X`` / ``cfg.X`` / ``self.config.X`` attribute reads
    (method calls like ``config.to_dict()`` are not reads)."""
    out = []
    for node in ctx.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        parent = ctx.parent(node)
        if isinstance(parent, ast.Call) and parent.func is node:
            continue
        base = dotted_name(node.value)
        if base is not None and base.split(".")[-1] in ("config", "cfg"):
            out.append(node)
    return out


def _is_float_conversion(value: ast.AST) -> bool:
    """``float(config.X)`` / ``np.float32(config.X)``: the idiom for a
    numeric hyperparameter consumed at launch time.  ``int(config.X)``
    conversions are structural (shapes, counts) and belong in the key."""
    if not isinstance(value, ast.Call):
        return False
    d = dotted_name(value.func)
    return d is not None and d.split(".")[-1] in ("float", "float32",
                                                  "float64", "double")


def _target_name(t: ast.AST) -> Optional[str]:
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self":
        return t.attr
    return None


def _launch_time_params(project: ProjectContext, mod) -> Dict[str, ast.AST]:
    """Config attrs that flow, through ``float(...)`` into a local or
    self-attr, into a buffer write (``.fill_``/``.copy_``/item
    assignment) outside any captured region: values a captured graph
    reads from memory at launch (a write inside a captured body bakes
    its value into the graph: that value shapes the capture and is
    keyed).  Returns attr -> read site."""
    ctx = mod.ctx
    origins: Dict[str, Tuple[str, ast.AST]] = {}
    for node in ctx.nodes:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and _is_float_conversion(node.value):
            tname = _target_name(node.targets[0])
            reads = _config_attr_reads(ctx, node.value)
            if tname is not None and len(reads) == 1 \
                    and tname not in origins:
                origins[tname] = (reads[0].attr, reads[0])
    if not origins:
        return {}
    out: Dict[str, ast.AST] = {}

    def note(expr: ast.AST):
        for leaf in ast.walk(expr):
            name = None
            if isinstance(leaf, ast.Name):
                name = leaf.id
            elif isinstance(leaf, ast.Attribute) \
                    and isinstance(leaf.value, ast.Name) \
                    and leaf.value.id == "self":
                name = leaf.attr
            if name in origins:
                attr, site = origins[name]
                out.setdefault(attr, site)

    for node in ctx.nodes:
        if isinstance(node, (ast.Call, ast.Assign)) \
                and project.is_captured_node(mod.name, node):
            continue
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in _BUFFER_WRITES:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                note(arg)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Subscript) for t in node.targets):
            note(node.value)
    return out


def check_project(project: ProjectContext):
    sites_by_module = _signature_sites(project)
    for mname in sorted(sites_by_module):
        sites = sites_by_module[mname]
        mod = project.modules[mname]
        ctx = mod.ctx
        key_names: Set[str] = set()
        skip: List[ast.AST] = []
        for _label, node, helpers in sites:
            key_names |= _names_in(node)
            skip.append(node)
            for h in helpers:
                key_names |= _names_in(h)
                skip.append(h)
        labels = "/".join(sorted({lbl for lbl, _, _ in sites}))

        # (1) shape-compared constants must be in the key
        mod_consts = {n for n in mod.assigns if _CONST_RE.match(n)
                      and not isinstance(mod.assigns[n],
                                         (ast.Tuple, ast.List, ast.Set,
                                          ast.Dict))}
        for name, found in sorted(
                _shape_compared_constants(ctx, mod_consts, skip).items()):
            if name in key_names:
                continue
            for site in sorted(found, key=lambda s: (s.lineno,
                                                     s.col_offset)):
                yield ctx.make_finding(
                    CODE, site,
                    f"capture-shaping constant `{name}` is compared "
                    f"against a shape here but never flows into "
                    f"`{labels}`; add it to the key (over-keying is "
                    "always safe) or a grower captured under another "
                    "value will be reused")

        excl_names, excl = _exclusions(mod, sites)
        if not excl:
            continue
        excl_label = "/".join(excl_names)

        # (2) excluded params must not be read under a capture
        for mname2 in sorted(project.modules):
            ctx2 = project.modules[mname2].ctx
            for read in _config_attr_reads(ctx2, ctx2.tree):
                if read.attr in excl \
                        and project.is_captured_node(mname2, read):
                    yield ctx2.make_finding(
                        CODE, read,
                        f"config attribute `{read.attr}` is excluded "
                        f"from the graph key ({excl_label} in {mname}) "
                        "but read inside a captured region: the graph "
                        "bakes in a value the key does not cover; key it "
                        "or write it into a buffer before each launch")

        # (3) launch-time params must be excluded from the key
        for attr, site in sorted(_launch_time_params(project, mod).items()):
            if attr in excl:
                continue
            yield ctx.make_finding(
                CODE, site,
                f"config attribute `{attr}` is written into a device "
                "buffer at launch time but still hashes into the graph "
                f"key; add it to {excl_label} or every change of it "
                "misses the grower cache")
