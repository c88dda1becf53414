"""Whole-repo analysis context: symbol table, import and call graphs.

The port's load-bearing contracts are cross-module: a constant defined in
``ops/hist_cuda.py`` shapes a graph captured in ``ops/grow.py``; a lock
acquired in ``serve/engine.py`` is ordered against one in
``robust/retry.py``; a wall-clock read in one function reaches a
checkpoint writer three calls away.  :class:`ProjectContext` builds the
shared machinery the TL1xx rule families need on top of the per-file
:class:`FileContext`s:

* a **module table** keyed by dotted module name (derived from the
  relative path), with each module's top-level constants, functions,
  classes/methods and import-alias table (relative imports resolved);
* a **call graph** over ``(module, qualname)`` function keys, resolving
  bare names, ``self.method``, imported modules/symbols, and locals
  assigned from project-class constructors;
* the **captured-region set**: functions whose bodies run under a CUDA
  graph capture (handed to ``GraphSet.capture`` or
  ``torch.cuda.make_graphed_callables``, called inside a ``with
  torch.cuda.graph(...)`` block, nested inside either) closed
  transitively over the call graph;
* **reachability** helpers used by the lock-discipline and determinism
  rules.

Like the per-file layer, everything here is pure ``ast``: analyzed code
is never imported.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .context import FileContext, dotted_name, unwrap_partial

FuncKey = Tuple[str, str]          # (module dotted name, qualname)


class FuncInfo:
    """One function or method in the project."""

    __slots__ = ("module", "qualname", "node", "class_name")

    def __init__(self, module: str, qualname: str,
                 node: ast.AST, class_name: Optional[str]):
        self.module = module
        self.qualname = qualname
        self.node = node
        self.class_name = class_name

    @property
    def key(self) -> FuncKey:
        return (self.module, self.qualname)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


class ModuleInfo:
    """Symbol table of one analyzed module."""

    def __init__(self, name: str, ctx: FileContext):
        self.name = name
        self.ctx = ctx
        #: top-level NAME = <expr> assignments (constants, tables)
        self.assigns: Dict[str, ast.AST] = {}
        #: local alias -> (module dotted name, symbol-or-None)
        self.imports: Dict[str, Tuple[str, Optional[str]]] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.assigns[t.id] = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                    and isinstance(stmt.target, ast.Name):
                self.assigns[stmt.target.id] = stmt.value
            elif isinstance(stmt, ast.ClassDef):
                self.classes[stmt.name] = stmt
        self._collect_imports()

    def _collect_imports(self):
        pkg_parts = self.name.split(".")[:-1]
        for node in self.ctx.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = \
                        (a.name, None)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                    mod = ".".join(base + ([node.module]
                                           if node.module else []))
                else:
                    mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.imports[a.asname or a.name] = (mod, a.name)


def module_name_for(relpath: str) -> str:
    p = relpath.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[:-len("/__init__")]
    return p.replace("/", ".")


class ProjectContext:
    """Cross-module view over a set of :class:`FileContext`s."""

    def __init__(self, contexts: Iterable[FileContext],
                 root: Optional[str] = None,
                 extra_files: Optional[Dict[str, str]] = None):
        #: analysis root (str path) when the run has one; single-source
        #: runs (``analyze_source``) leave it ``None`` and rules that
        #: need sibling non-Python inputs stay silent.
        self.root = root
        #: root-relative path -> text for non-Python inputs pulled in by
        #: ``# torchlint: abi-*`` directives (C headers, .cpp sources).
        self.extra_files: Dict[str, str] = dict(extra_files or {})
        self.modules: Dict[str, ModuleInfo] = {}
        self.ctx_for: Dict[str, FileContext] = {}
        for ctx in contexts:
            name = module_name_for(ctx.relpath)
            self.modules[name] = ModuleInfo(name, ctx)
            self.ctx_for[name] = ctx
        self.functions: Dict[FuncKey, FuncInfo] = {}
        self._collect_functions()
        #: function key -> resolved callee keys
        self.calls: Dict[FuncKey, Set[FuncKey]] = {}
        #: per function: locals assigned from project-class constructors,
        #: plus self-attrs assigned that way anywhere in the class
        self._instance_types: Dict[FuncKey, Dict[str, Tuple[str, str]]] = {}
        self._self_attr_types: Dict[Tuple[str, str],
                                    Dict[str, Tuple[str, str]]] = {}
        self._collect_instance_types()
        self._build_call_graph()
        #: ``with torch.cuda.graph(...)`` blocks, per module
        self.graph_blocks: Dict[str, List[ast.With]] = {}
        self.captured: Set[FuncKey] = self._captured_closure()

    # ------------------------------------------------------------------
    def _collect_functions(self):
        self._node_func: Dict[int, FuncInfo] = {}

        def visit(mname, body, prefix: str, class_name: Optional[str]):
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    q = f"{prefix}{stmt.name}"
                    fi = FuncInfo(mname, q, stmt, class_name)
                    self.functions[(mname, q)] = fi
                    self._node_func[id(stmt)] = fi
                    visit(mname, stmt.body, f"{q}.<locals>.", class_name)
                elif isinstance(stmt, ast.ClassDef):
                    visit(mname, stmt.body, f"{stmt.name}.", stmt.name)

        for mname, mod in self.modules.items():
            visit(mname, mod.ctx.tree.body, "", None)

    def enclosing_function(self, module: str, node: ast.AST) \
            -> Optional[FuncInfo]:
        ctx = self.ctx_for.get(module)
        if ctx is None:
            return None
        chain: List[ast.AST] = [node] + list(ctx.ancestors(node))
        for n in chain:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return self._node_func.get(id(n))
        return None

    # ------------------------------------------------------------------
    def resolve_module(self, module: str, alias: str) -> Optional[str]:
        """Project module a bare name refers to in ``module``, if any."""
        mod = self.modules.get(module)
        if mod is None:
            return None
        tgt = mod.imports.get(alias)
        if tgt is None:
            return None
        full, sym = tgt
        if sym is None:
            return full if full in self.modules else None
        # `from pkg import mod` where pkg.mod is a project module
        cand = f"{full}.{sym}" if full else sym
        return cand if cand in self.modules else None

    def resolve_symbol(self, module: str, name: str) \
            -> Optional[Tuple[str, str]]:
        """(defining module, symbol) for a bare name used in ``module``."""
        mod = self.modules.get(module)
        if mod is None:
            return None
        if name in mod.assigns or (module, name) in self.functions \
                or name in mod.classes:
            return (module, name)
        tgt = mod.imports.get(name)
        if tgt is not None:
            full, sym = tgt
            if sym is not None and full in self.modules:
                return (full, sym)
        return None

    # ------------------------------------------------------------------
    def _collect_instance_types(self):
        """Map locals / self-attrs assigned from project-class calls."""
        for key, fi in self.functions.items():
            local: Dict[str, Tuple[str, str]] = {}
            for node in self.ctx_for[fi.module].walk(fi.node):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.value, ast.Call)):
                    continue
                cls = self._class_of_call(fi.module, node.value)
                if cls is None:
                    continue
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    local[t.id] = cls
                elif isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" and fi.class_name:
                    self._self_attr_types.setdefault(
                        (fi.module, fi.class_name), {})[t.attr] = cls
            self._instance_types[key] = local

    def _class_of_call(self, module: str, call: ast.Call) \
            -> Optional[Tuple[str, str]]:
        d = dotted_name(call.func)
        if d is None:
            return None
        parts = d.split(".")
        if len(parts) == 1:
            r = self.resolve_symbol(module, parts[0])
            if r is not None and parts[0][:1].isupper() \
                    and r[1] in self.modules[r[0]].classes:
                return r
        elif len(parts) == 2:
            m2 = self.resolve_module(module, parts[0])
            if m2 is not None and parts[1] in self.modules[m2].classes:
                return (m2, parts[1])
        return None

    # ------------------------------------------------------------------
    def resolve_call(self, fi: FuncInfo, call: ast.Call) -> Set[FuncKey]:
        """Project functions a call site may invoke (best effort)."""
        out: Set[FuncKey] = set()
        func = call.func
        if isinstance(func, ast.Name):
            r = self.resolve_symbol(fi.module, func.id)
            if r is not None:
                if r in self.functions:
                    out.add(r)
                elif r[1] in self.modules[r[0]].classes:
                    init = (r[0], f"{r[1]}.__init__")
                    if init in self.functions:
                        out.add(init)
            # nested function defined in an enclosing scope
            for k in ((fi.module, f"{fi.qualname}.<locals>.{func.id}"),):
                if k in self.functions:
                    out.add(k)
            return out
        d = dotted_name(func)
        if d is None:
            return out
        parts = d.split(".")
        if parts[0] == "self" and fi.class_name is not None \
                and len(parts) == 2:
            k = (fi.module, f"{fi.class_name}.{parts[1]}")
            if k in self.functions:
                out.add(k)
            return out
        if parts[0] == "self" and fi.class_name is not None \
                and len(parts) == 3:
            # self.<attr>.<meth> where attr's class is known
            attrs = self._self_attr_types.get((fi.module, fi.class_name),
                                              {})
            cls = attrs.get(parts[1])
            if cls is not None:
                k = (cls[0], f"{cls[1]}.{parts[2]}")
                if k in self.functions:
                    out.add(k)
            return out
        if len(parts) == 2:
            # local var of a known project class
            cls = self._instance_types.get(fi.key, {}).get(parts[0])
            if cls is not None:
                k = (cls[0], f"{cls[1]}.{parts[1]}")
                if k in self.functions:
                    out.add(k)
                return out
            m2 = self.resolve_module(fi.module, parts[0])
            if m2 is not None:
                k = (m2, parts[1])
                if k in self.functions:
                    out.add(k)
                elif parts[1] in self.modules[m2].classes:
                    init = (m2, f"{parts[1]}.__init__")
                    if init in self.functions:
                        out.add(init)
            return out
        return out

    def _build_call_graph(self):
        for key, fi in self.functions.items():
            callees: Set[FuncKey] = set()
            for node in self.ctx_for[fi.module].walk(fi.node):
                if isinstance(node, ast.Call):
                    sub = self.enclosing_function(fi.module, node)
                    if sub is not None and sub.key != key:
                        continue        # belongs to a nested function
                    callees |= self.resolve_call(fi, node)
            self.calls[key] = callees

    def reachable_from(self, roots: Iterable[FuncKey]) -> Set[FuncKey]:
        seen: Set[FuncKey] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            k = stack.pop()
            if k in seen:
                continue
            seen.add(k)
            stack.extend(self.calls.get(k, ()))
        return seen

    # ------------------------------------------------------------------
    def capture_roots(self) -> Set[FuncKey]:
        """Functions handed to a CUDA-graph capture: ``X.capture(fn)``
        (``ops/graphs.py::GraphSet.capture``; ``functools.partial``
        unwrapped), ``torch.cuda.make_graphed_callables(fn, ...)``, and
        the project functions called inside a ``with
        torch.cuda.graph(...)`` block."""
        roots: Set[FuncKey] = set()
        for mname, mod in self.modules.items():
            ctx = mod.ctx
            blocks = self.graph_blocks.setdefault(mname, [])
            for node in ctx.nodes:
                if isinstance(node, ast.With) and any(
                        is_graph_context(ctx, it.context_expr)
                        for it in node.items):
                    blocks.append(node)
                    fi = self.enclosing_function(mname, node)
                    if fi is None:
                        continue
                    for stmt in node.body:
                        for sub in ctx.walk(stmt):
                            if isinstance(sub, ast.Call):
                                roots |= self.resolve_call(fi, sub)
                elif isinstance(node, ast.Call) and node.args and (
                        is_capture_method_call(node)
                        or ctx.is_torch_call(node,
                                             "make_graphed_callables")):
                    r = self._callable_ref(mname, ctx,
                                           unwrap_partial(node.args[0]))
                    if r is not None:
                        roots.add(r)
        return roots

    def _callable_ref(self, module: str, ctx: FileContext,
                      node: ast.AST) -> Optional[FuncKey]:
        """FuncKey a Name/Attribute/partial argument refers to."""
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d is not None and d.split(".")[-1] == "partial" \
                    and node.args:
                return self._callable_ref(module, ctx, node.args[0])
            return None
        d = dotted_name(node)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] == "self" and len(parts) == 2:
            ctx2 = self.ctx_for.get(module)
            fi0 = self.enclosing_function(module, node) \
                if ctx2 is not None else None
            if fi0 is not None and fi0.class_name is not None:
                k = (module, f"{fi0.class_name}.{parts[1]}")
                if k in self.functions:
                    return k
            for fi in self.functions.values():
                if fi.module == module and fi.name == parts[1] \
                        and fi.class_name is not None:
                    return fi.key
            return None
        if len(parts) == 1:
            # a nested def referenced from its enclosing scope
            fi0 = self.enclosing_function(module, node)
            while fi0 is not None:
                k = (module, f"{fi0.qualname}.<locals>.{parts[0]}")
                if k in self.functions:
                    return k
                up = fi0.qualname.rsplit(".<locals>.", 1)
                fi0 = self.functions.get((module, up[0])) \
                    if len(up) == 2 else None
        r = self.resolve_symbol(module, parts[0])
        if r is None:
            return None
        if len(parts) == 1:
            return r if r in self.functions else None
        k = (r[0], ".".join([r[1]] + parts[1:])) \
            if r[1] not in self.modules else None
        return k if k in self.functions else None

    def _captured_closure(self) -> Set[FuncKey]:
        """Capture roots, their nested defs, and everything they
        (transitively) call."""
        roots: Set[FuncKey] = set(self.capture_roots())
        # nested defs inside a captured function body are captured too
        for key in list(roots):
            prefix = key[1] + ".<locals>."
            for k2 in self.functions:
                if k2[0] == key[0] and k2[1].startswith(prefix):
                    roots.add(k2)
        return self.reachable_from(roots)

    def is_captured_node(self, module: str, node: ast.AST) -> bool:
        """Whether ``node`` runs under a capture: in a captured function,
        or lexically inside a ``with torch.cuda.graph(...)`` block."""
        fi = self.enclosing_function(module, node)
        if fi is not None and fi.key in self.captured:
            return True
        ctx = self.ctx_for[module]
        return any(ctx.is_ancestor(b, node)
                   for b in self.graph_blocks.get(module, ()))

    # ------------------------------------------------------------------
    def own_nodes(self, fi: FuncInfo) -> List[ast.AST]:
        """Nodes lexically inside ``fi`` but NOT inside a nested
        function — each function's own scope, computed once per module
        with a single DFS (the taint fixpoint re-reads these a lot)."""
        if not hasattr(self, "_scope_nodes"):
            self._scope_nodes: Dict[FuncKey, List[ast.AST]] = {}
            self._module_nodes: Dict[str, List[ast.AST]] = {}
            for mname, mod in self.modules.items():
                top: List[ast.AST] = []
                self._module_nodes[mname] = top

                def dfs(node, owner_key):
                    for child in ast.iter_child_nodes(node):
                        child_owner = owner_key
                        if isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)):
                            fi2 = self._node_func.get(id(child))
                            child_owner = fi2.key if fi2 is not None \
                                else owner_key
                        if child_owner is None:
                            top.append(child)
                        else:
                            self._scope_nodes.setdefault(
                                child_owner, []).append(child)
                        dfs(child, child_owner)
                dfs(mod.ctx.tree, None)
        return self._scope_nodes.get(fi.key, [])

    def module_level_nodes(self, module: str) -> List[ast.AST]:
        """Nodes outside any function in ``module`` (class bodies
        included)."""
        if not hasattr(self, "_module_nodes"):
            for fi in self.functions.values():
                self.own_nodes(fi)
                break
            if not hasattr(self, "_module_nodes"):
                self._module_nodes = {}
                for mname, mod in self.modules.items():
                    self._module_nodes[mname] = [
                        n for n in mod.ctx.nodes
                        if self.enclosing_function(mname, n) is None]
        return self._module_nodes.get(module, [])


def is_graph_context(ctx: FileContext, expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` as a ``with`` context expression."""
    return isinstance(expr, ast.Call) and ctx.is_torch_call(expr, "graph")


def is_capture_method_call(node: ast.Call) -> bool:
    """``<graph set>.capture(fn, ...)``: a ``capture`` method handed a
    callable (``tracing.capture()`` takes none)."""
    return isinstance(node.func, ast.Attribute) \
        and node.func.attr == "capture" and bool(node.args) \
        and dotted_name(node.func.value) != "tracing"
