"""Shared per-file analysis context for the torchlint rules.

One :class:`FileContext` is built per analyzed file: the parsed AST with
parent links, the import alias tables (``numpy``, ``torch`` and the torch
submodules bound as ``F`` & co, under whatever names the module bound
them to), per-scope dataflow of names assigned from ``torch.``-rooted
expressions (probable tensors) and from ``np.``-rooted ones (host arrays),
loop-nesting queries with comprehension-aware semantics, inline
suppression comments, and the hot-path classification that scopes TL001.

The context is pure ``ast``: no imports of the analyzed code are ever
executed, so the analyzer runs on files with unimportable dependencies
and never pays torch's start-up cost per file.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set

#: modules whose loops are the retrain-every-window hot path (the training
#: loop, the tree learners, the C ABI's embedded calls and the pipeline's
#: window loop); TL001 only fires here.  A module can opt in from outside
#: this list with a ``# torchlint: hot-path`` marker comment anywhere in
#: the file.
HOT_PATH_SUFFIXES = (
    "lightgbm_tpu_torch/boosting/gbdt.py",
    "lightgbm_tpu_torch/tree/learner.py",
    "lightgbm_tpu_torch/engine.py",
    "lightgbm_tpu_torch/capi_embed.py",
    "lightgbm_tpu_torch/ops/grow.py",
    "lightgbm_tpu_torch/pipeline/core.py",
)

HOT_MARKER = "torchlint: hot-path"

_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*(disable|disable-next)\s*=\s*"
    r"(all|[A-Za-z]{2}\d{3}(?:\s*,\s*[A-Za-z]{2}\d{3})*)")

_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.Module)


class Finding:
    """One rule violation at a source location."""

    __slots__ = ("rule", "path", "line", "col", "message", "snippet")

    def __init__(self, rule: str, path: str, line: int, col: int,
                 message: str, snippet: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.message = message
        self.snippet = snippet

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "file": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet}

    def __repr__(self):
        return (f"Finding({self.rule} {self.path}:{self.line}:{self.col} "
                f"{self.message!r})")


def normalize_snippet(line: str, width: int = 200) -> str:
    """Whitespace-collapsed source line: the line-number-independent
    baseline key, stable across pure line moves."""
    return " ".join(line.split())[:width]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def chain_root(node: ast.AST) -> Optional[str]:
    """Base Name id of a Call/Attribute/Subscript chain, else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def unwrap_partial(node: ast.AST) -> ast.AST:
    """``f`` of ``functools.partial(f, ...)`` (nested partials too)."""
    while isinstance(node, ast.Call) and node.args:
        d = dotted_name(node.func)
        if d is None or d.split(".")[-1] != "partial":
            break
        node = node.args[0]
    return node


class FileContext:
    """Everything the rule modules need to know about one source file."""

    def __init__(self, src: str, relpath: str):
        self.src = src
        self.relpath = relpath.replace("\\", "/")
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=relpath)
        #: every node of the file, in ``ast.walk`` order
        self.nodes: List[ast.AST] = list(ast.walk(self.tree))
        self._walks: Dict[int, List[ast.AST]] = {id(self.tree): self.nodes}
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in self.nodes:
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.numpy_aliases: Set[str] = set()
        #: names bound to ``torch`` or one of its submodules
        #: (``import torch.nn.functional as F``)
        self.torch_aliases: Set[str] = set()
        self._collect_imports()
        self.is_hot = (HOT_MARKER in src
                       or any(self.relpath.endswith(s)
                              for s in HOT_PATH_SUFFIXES))
        self.suppressions: Dict[int, Set[str]] = {}
        self._collect_suppressions()
        self._tensor_cache: Dict[int, Set[str]] = {}
        self._numpy_cache: Dict[int, Set[str]] = {}
        self._set_cache: Dict[int, Set[str]] = {}

    # ------------------------------------------------------------------
    def _collect_imports(self):
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    top = a.name.split(".")[0]
                    bound = a.asname or top
                    if a.name == "numpy":
                        self.numpy_aliases.add(bound)
                    elif top == "torch":
                        self.torch_aliases.add(bound)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.split(".")[0] == "torch" \
                    and not node.level:
                for a in node.names:
                    # `from torch import nn` / `from torch.nn import
                    # functional as F`: submodules; classes and functions
                    # (`from torch import Tensor`) are not roots
                    if a.name[:1].islower():
                        self.torch_aliases.add(a.asname or a.name)

    def _collect_suppressions(self):
        for i, line in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            codes = {c.strip().upper() for c in m.group(2).split(",")}
            target = i if m.group(1) == "disable" else i + 1
            self.suppressions.setdefault(target, set()).update(codes)

    def is_suppressed(self, rule: str, line: int) -> bool:
        codes = self.suppressions.get(line)
        return bool(codes) and (rule in codes or "ALL" in codes)

    # ------------------------------------------------------------------
    def walk(self, node: ast.AST) -> List[ast.AST]:
        """``list(ast.walk(node))`` for a node of this file, computed once
        (the rules walk the same function bodies many times)."""
        got = self._walks.get(id(node))
        if got is None:
            got = self._walks[id(node)] = list(ast.walk(node))
        return got

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        p = self.parents.get(node)
        while p is not None:
            yield p
            p = self.parents.get(p)

    def is_ancestor(self, maybe_ancestor: ast.AST, node: ast.AST) -> bool:
        return any(a is maybe_ancestor for a in self.ancestors(node))

    def enclosing_scope(self, node: ast.AST) -> ast.AST:
        for a in self.ancestors(node):
            if isinstance(a, _SCOPES):
                return a
        return self.tree

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a
        return None

    def loop_depth(self, node: ast.AST) -> int:
        """Number of enclosing loops whose BODY re-evaluates ``node``
        each iteration, up to the nearest function boundary.  A ``for``
        statement's iterable and a comprehension's FIRST source iterable
        are evaluated once, so they don't count."""
        depth = 0
        child = node
        for p in self.ancestors(node):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                break
            if isinstance(p, ast.For):
                if child is not p.iter:
                    depth += 1
            elif isinstance(p, ast.While):
                depth += 1
            elif isinstance(p, _COMPREHENSIONS):
                if not (p.generators and child is p.generators[0].iter):
                    depth += 1
            child = p
        return depth

    # ------------------------------------------------------------------
    def rooted_in(self, node: ast.AST, roots: Set[str]) -> bool:
        r = chain_root(node)
        return r is not None and r in roots

    def _scope_names(self, node: ast.AST, roots: Set[str],
                     cache: Dict[int, Set[str]]) -> Set[str]:
        scope = self.enclosing_scope(node)
        cached = cache.get(id(scope))
        if cached is not None:
            return cached
        names: Set[str] = set()
        for n in self.walk(scope):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and self.rooted_in(n.value, roots):
                names.add(n.targets[0].id)
        cache[id(scope)] = names
        return names

    def tensor_names(self, node: ast.AST) -> Set[str]:
        """Names in ``node``'s scope assigned from ``torch.``-rooted
        expressions: a cheap local dataflow for "this is (probably) a
        tensor"."""
        return self._scope_names(node, self.torch_aliases,
                                 self._tensor_cache)

    def numpy_names(self, node: ast.AST) -> Set[str]:
        """Names in ``node``'s scope assigned from ``np.``-rooted
        expressions: host arrays and numpy scalars."""
        return self._scope_names(node, self.numpy_aliases,
                                 self._numpy_cache)

    def is_numpy_expr(self, node: ast.AST) -> bool:
        """``node``'s chain is rooted in numpy or in a local numpy name
        (and not in a tensor name: a name bound both ways is unknown)."""
        root = chain_root(node)
        if root is None:
            return False
        if root in self.numpy_aliases:
            return True
        return root in self.numpy_names(node) \
            and root not in self.tensor_names(node)

    def set_names(self, node: ast.AST) -> Set[str]:
        """Names in ``node``'s scope assigned from set expressions."""
        scope = self.enclosing_scope(node)
        cached = self._set_cache.get(id(scope))
        if cached is not None:
            return cached
        names: Set[str] = set()
        for n in self.walk(scope):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                v = n.value
                if isinstance(v, (ast.Set, ast.SetComp)) or (
                        isinstance(v, ast.Call)
                        and isinstance(v.func, ast.Name)
                        and v.func.id in ("set", "frozenset")):
                    names.add(n.targets[0].id)
        self._set_cache[id(scope)] = names
        return names

    # ------------------------------------------------------------------
    def is_torch_call(self, node: ast.AST, *tails: str) -> bool:
        """``torch.<...>.<tail>(...)`` for one of ``tails`` (the chain
        rooted in a torch alias)."""
        if not isinstance(node, ast.Call):
            return False
        d = dotted_name(node.func)
        return d is not None and d.split(".")[0] in self.torch_aliases \
            and d.split(".")[-1] in tails

    def make_finding(self, rule: str, node: ast.AST, message: str) \
            -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = normalize_snippet(self.lines[line - 1]) \
            if 0 < line <= len(self.lines) else ""
        return Finding(rule, self.relpath, line, col, message, snippet)
