"""TL151 — cross-language C-ABI parity.

The C ABI exists in four places that only convention keeps in sync:
the declarations in ``include/lightgbm_tpu/c_api.h``, the embedded-
interpreter glue in ``src/capi_cuda/lgbm_capi.cpp``, the Python
compatibility layer ``lightgbm_tpu_torch/c_api.py`` and the adapter
table in ``lightgbm_tpu_torch/capi_embed.py``.  A drifted arity or a swapped
parameter corrupts buffers at the language boundary, where no test
stack trace points at the cause.

A Python module opts in with directives whose paths are relative to
the directive-carrying file::

    # torchlint: abi-header=../include/lightgbm_tpu/c_api.h
    # torchlint: abi-impl=../src/capi_cuda/lgbm_capi.cpp

A tolerant C declaration scanner (comment-stripping + paren/template
balancing, no compiler needed) extracts every ``LGBM_*`` declaration
from the header and every definition plus
``Py_BuildValue``/``call_adapter`` pair from the ``.cpp``.  Checks:

* **header <-> Python bindings** (a module with ``abi-header`` that
  defines ``LGBM_*`` functions): every header declaration must have a
  Python ``def`` of the same name and arity (extra Python-only compat
  entry points are allowed).
* **header <-> cpp** (a module carrying both directives): every header
  declaration must be defined in the ``.cpp`` and vice versa.
* **cpp <-> adapter table**: every ``call_adapter("name", ...)`` in
  the ``.cpp`` must resolve to a module-level function of that name,
  and the paired ``Py_BuildValue`` format must carry exactly as many
  values as the adapter has parameters.
* **adapter <-> header**: every forwarded ``_call(C.LGBM_X, ...)``
  must pass the header's arity for ``LGBM_X``, and the adapter
  parameters must be forwarded in header order (a swap reads the
  wrong buffer as the wrong scalar).

Directives whose target file is missing are inert (the tree hash still
records the absence, so creating the file invalidates the cache); a
single-source run (no project root) never reports.  Same rule as
jaxlint's JL151, over the port's four surfaces.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from ..cache import resolve_extra_path
from ..context import FileContext, dotted_name
from ..project import ProjectContext

CODE = "TL151"
SHORT = ("C-ABI surfaces out of sync: header/cpp/bindings/adapter "
         "entry-point, arity, or parameter-order divergence")

PROJECT_RULE = True

_DIRECTIVE_RE = re.compile(
    r"#\s*torchlint:\s*abi-(header|impl)\s*=\s*(\S+)")
_BUILDVALUE_RE = re.compile(r'Py_BuildValue\s*\(\s*"([^"]*)"')
_ADAPTER_RE = re.compile(r'call_adapter\s*\(\s*"(\w+)"')
_NAME_RE = re.compile(r"\bLGBM_(\w+)\s*\(")


def _strip_c_comments(text: str) -> str:
    """Blank out // and /* */ comments, preserving newlines and string
    literals (the adapter names live in strings)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:min(j + 1, n)])
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i)
            j = n - 2 if j < 0 else j
            seg = text[i:j + 2]
            out.append("".join(ch if ch == "\n" else " " for ch in seg))
            i = j + 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _split_params(params: str) -> int:
    """Top-level comma count -> C parameter arity; handles template
    commas (``unordered_map<string, string>``) and ``(void)``."""
    depth = 0
    parts, cur = [], []
    for ch in params:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    parts = [p.strip() for p in parts]
    parts = [p for p in parts if p and p != "void"]
    return len(parts)


def _scan_c(text: str, want_defs: bool) -> Dict[str, int]:
    """``LGBM_*`` name -> arity.  ``want_defs`` keeps only entries
    followed by ``{`` (function definitions); otherwise only ``;``
    -terminated declarations."""
    t = _strip_c_comments(text)
    out: Dict[str, int] = {}
    for m in _NAME_RE.finditer(t):
        depth, j = 1, m.end()
        while j < len(t) and depth:
            if t[j] == "(":
                depth += 1
            elif t[j] == ")":
                depth -= 1
            j += 1
        if depth:
            continue
        k = j
        while k < len(t) and t[k] in " \t\r\n":
            k += 1
        is_def = k < len(t) and t[k] == "{"
        if is_def != want_defs:
            continue
        out["LGBM_" + m.group(1)] = _split_params(t[m.end():j - 1])
    return out


def _adapter_calls(text: str) -> List[Tuple[str, Optional[int]]]:
    """(adapter name, paired Py_BuildValue value count) in cpp order.
    Pairing is sequential: each ``call_adapter`` consumes the nearest
    preceding unconsumed ``Py_BuildValue``."""
    t = _strip_c_comments(text)
    events = [(m.start(), "fmt", m.group(1))
              for m in _BUILDVALUE_RE.finditer(t)]
    events += [(m.start(), "call", m.group(1))
               for m in _ADAPTER_RE.finditer(t)]
    out: List[Tuple[str, Optional[int]]] = []
    pending: Optional[int] = None
    for _, kind, val in sorted(events):
        if kind == "fmt":
            pending = sum(1 for ch in val if ch.isalpha())
        else:
            out.append((val, pending))
            pending = None
    return out


def _directives(ctx: FileContext) -> Dict[str, Tuple[str, int]]:
    """kind -> (normalized relpath, directive line) for one module."""
    out: Dict[str, Tuple[str, int]] = {}
    for i, line in enumerate(ctx.lines, start=1):
        m = _DIRECTIVE_RE.search(line)
        if m and m.group(1) not in out:
            out[m.group(1)] = (resolve_extra_path(ctx.relpath,
                                                  m.group(2)), i)
    return out


def _at_line(line: int) -> ast.AST:
    return ast.Pass(lineno=line, col_offset=0)


def _py_arity(fn: ast.AST) -> int:
    a = fn.args
    return len(a.posonlyargs) + len(a.args)


def _module_defs(project: ProjectContext, mname: str) \
        -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for (m, qual), fi in sorted(project.functions.items()):
        if m == mname and qual == fi.name and fi.class_name is None:
            out[fi.name] = fi.node
    return out


def _forwarded_calls(project: ProjectContext, mname: str):
    """(adapter FuncInfo, call node, LGBM name, n forwarded args,
    forwarded param indices) for each ``_call(C.LGBM_X, ...)``."""
    for key in sorted(project.functions):
        fi = project.functions[key]
        if fi.module != mname:
            continue
        params = [p.arg for p in fi.node.args.posonlyargs
                  + fi.node.args.args]
        for node in project.own_nodes(fi):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Name) \
                    or node.func.id != "_call" or not node.args:
                continue
            d = dotted_name(node.args[0])
            if d is None:
                continue
            cname = d.split(".")[-1]
            if not cname.startswith("LGBM_"):
                continue
            indices: List[int] = []
            for arg in node.args[1:]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Name) and sub.id in params:
                        indices.append(params.index(sub.id))
                        break
            yield fi, node, cname, len(node.args) - 1, indices


def check_project(project: ProjectContext):
    if project.root is None and not project.extra_files:
        return
    for mname in sorted(project.modules):
        ctx = project.modules[mname].ctx
        dirs = _directives(ctx)
        if not dirs:
            continue
        header_decls = None
        if "header" in dirs:
            text = project.extra_files.get(dirs["header"][0])
            if text is not None:
                header_decls = _scan_c(text, want_defs=False)
        impl_defs = impl_adapters = None
        if "impl" in dirs:
            text = project.extra_files.get(dirs["impl"][0])
            if text is not None:
                impl_defs = _scan_c(text, want_defs=True)
                impl_adapters = _adapter_calls(text)

        defs = _module_defs(project, mname)
        lgbm_defs = {n: f for n, f in defs.items()
                     if n.startswith("LGBM_")}

        # header <-> Python bindings
        if header_decls is not None and lgbm_defs:
            hline = dirs["header"][1]
            for name in sorted(header_decls):
                if name not in lgbm_defs:
                    yield ctx.make_finding(
                        CODE, _at_line(hline),
                        f"`{name}` is declared in "
                        f"`{dirs['header'][0]}` but has no binding in "
                        "this module: add the entry point or drop the "
                        "declaration")
                elif _py_arity(lgbm_defs[name]) != header_decls[name]:
                    yield ctx.make_finding(
                        CODE, lgbm_defs[name],
                        f"`{name}` takes {_py_arity(lgbm_defs[name])} "
                        f"parameters here but the header declares "
                        f"{header_decls[name]}: the native caller and "
                        "this binding disagree on the calling "
                        "convention")

        # header <-> cpp definitions
        if header_decls is not None and impl_defs is not None:
            hline = dirs["impl"][1]
            for name in sorted(header_decls):
                if name not in impl_defs:
                    yield ctx.make_finding(
                        CODE, _at_line(hline),
                        f"`{name}` is declared in "
                        f"`{dirs['header'][0]}` but never defined in "
                        f"`{dirs['impl'][0]}`: the symbol will not "
                        "link")
            for name in sorted(impl_defs):
                if name not in header_decls:
                    yield ctx.make_finding(
                        CODE, _at_line(hline),
                        f"`{name}` is defined in `{dirs['impl'][0]}` "
                        "but not declared in the header: callers "
                        "cannot see it — declare it or remove the "
                        "definition")
                elif impl_defs[name] != header_decls[name]:
                    yield ctx.make_finding(
                        CODE, _at_line(hline),
                        f"`{name}` is defined with {impl_defs[name]} "
                        f"parameters in `{dirs['impl'][0]}` but "
                        f"declared with {header_decls[name]} in the "
                        "header")

        # cpp call_adapter <-> adapter table in this module
        if impl_adapters is not None:
            iline = dirs["impl"][1]
            for name, fmt_count in impl_adapters:
                if name not in defs:
                    yield ctx.make_finding(
                        CODE, _at_line(iline),
                        f"`{dirs['impl'][0]}` calls adapter "
                        f"`{name}` which this module does not define: "
                        "the embedded call will fail at runtime")
                    continue
                arity = _py_arity(defs[name])
                if fmt_count is not None and fmt_count != arity:
                    yield ctx.make_finding(
                        CODE, defs[name],
                        f"adapter `{name}` takes {arity} parameters "
                        f"but `{dirs['impl'][0]}` builds "
                        f"{fmt_count} values for it: the tuple will "
                        "not unpack")

        # adapter forwarding <-> header arity and parameter order
        if impl_adapters is not None and header_decls is not None:
            for fi, node, cname, n_args, indices in \
                    _forwarded_calls(project, mname):
                if cname not in header_decls:
                    continue      # python-only compat entry point
                if n_args != header_decls[cname]:
                    yield ctx.make_finding(
                        CODE, node,
                        f"`{fi.name}` forwards {n_args} arguments to "
                        f"`{cname}` but the header declares "
                        f"{header_decls[cname]} parameters")
                elif any(b <= a for a, b in zip(indices, indices[1:])):
                    yield ctx.make_finding(
                        CODE, node,
                        f"`{fi.name}` forwards its parameters to "
                        f"`{cname}` out of declaration order: a "
                        "swapped position reinterprets the caller's "
                        "buffers — forward in header order")
