"""TL161 — fault-site registry coverage.

The chaos harness (``robust/faults.py``) can only break what the code
arms: every injection point names a site string that must exist in the
``KNOWN_SITES`` registry, and the registry in turn promises each entry
is wired into real code.  Both directions drift silently — a typo'd
site never fires, a removed call leaves a dead registry entry, and a
new background worker that never passes near a fault site ships
outside the chaos harness entirely (the composed soak, ``soak/``,
assumes otherwise).  Same rule as jaxlint's JL161.

The rule activates when some project module assigns a top-level
``KNOWN_SITES`` tuple/list of string literals (``robust/faults.py`` in
this repo); with no registry in view — single-file runs, the analyzer
scanning itself — it stays silent.  A *use* is any call that passes a
string literal for a parameter named ``site``: keyword form
(``with_retries(fn, site="net.connect")``) is recognized anywhere,
positional form (``faults.check("io.read")``, ``_netop(sock,
"net.send", ...)``) wherever the call graph resolves the callee.
Checks:

1. every used site string must exist in ``KNOWN_SITES`` — an unknown
   site arms nothing;
2. every ``KNOWN_SITES`` entry must be used somewhere — dead entries
   make chaos specs silently vacuous;
3. every ``threading.Thread`` entry point must reach at least one
   fault site through its transitive call closure, so each background
   worker can be exercised by the harness.

Escapes: register the site, delete the dead entry, or justify with
``# torchlint: disable=TL161`` on the spawn/def line.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..project import FuncKey, ProjectContext
from .lock_order import _thread_entry_points

CODE = "TL161"
SHORT = ("fault-site string not in KNOWN_SITES, dead registry entry, "
         "or thread worker unreachable from every fault site")

PROJECT_RULE = True

_REGISTRY_NAME = "KNOWN_SITES"


def _registry(project: ProjectContext) \
        -> List[Tuple[str, ast.AST, Set[str]]]:
    """(module, assign value node, site strings) per registry module."""
    out = []
    for mname in sorted(project.modules):
        val = project.modules[mname].assigns.get(_REGISTRY_NAME)
        if not isinstance(val, (ast.Tuple, ast.List)) or not val.elts:
            continue
        sites: Set[str] = set()
        ok = True
        for e in val.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                sites.add(e.value)
            else:
                ok = False
        if ok:
            out.append((mname, val, sites))
    return out


def _site_of_call(project: ProjectContext, mname: str,
                  node: ast.Call) -> Optional[str]:
    for kw in node.keywords:
        if kw.arg == "site" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    fi = project.enclosing_function(mname, node)
    if fi is None:
        return None
    for callee in sorted(project.resolve_call(fi, node)):
        tfi = project.functions[callee]
        params = [p.arg for p in tfi.node.args.posonlyargs
                  + tfi.node.args.args]
        if params and params[0] == "self":
            params = params[1:]
        if "site" not in params:
            continue
        idx = params.index("site")
        if idx < len(node.args):
            a = node.args[idx]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
    return None


def _site_uses(project: ProjectContext) \
        -> List[Tuple[str, str, ast.Call]]:
    uses: List[Tuple[str, str, ast.Call]] = []
    for mname in sorted(project.modules):
        ctx = project.modules[mname].ctx
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            s = _site_of_call(project, mname, node)
            if s is not None:
                uses.append((s, mname, node))
    return uses


def check_project(project: ProjectContext):
    registries = _registry(project)
    if not registries:
        return
    sites: Set[str] = set()
    for _, _, s in registries:
        sites |= s
    uses = _site_uses(project)

    # (1) used site strings must be registered
    for s, mname, node in uses:
        if s not in sites:
            ctx = project.ctx_for[mname]
            yield ctx.make_finding(
                CODE, node,
                f"fault site `{s}` is not in {_REGISTRY_NAME}: the "
                "chaos harness can never arm it — register the site "
                "or fix the typo")

    # (2) registered sites must be used
    used = {s for s, _, _ in uses}
    for mname, val, s in registries:
        ctx = project.ctx_for[mname]
        for dead in sorted(s - used):
            yield ctx.make_finding(
                CODE, val,
                f"{_REGISTRY_NAME} entry `{dead}` is wired into no "
                "with_retries/breaker/fault-check call: a chaos spec "
                "naming it is silently vacuous — delete the entry or "
                "arm the site in code")

    # (3) every thread worker must pass near some fault site
    use_keys: Set[FuncKey] = set()
    for _, mname, node in uses:
        fi = project.enclosing_function(mname, node)
        if fi is not None:
            use_keys.add(fi.key)
    for entry in sorted(_thread_entry_points(project)):
        closure = project.reachable_from([entry])
        if closure & use_keys:
            continue
        fi = project.functions[entry]
        ctx = project.ctx_for[fi.module]
        yield ctx.make_finding(
            CODE, fi.node,
            f"thread worker `{fi.qualname}` is reachable from no "
            "fault site or breaker: the chaos harness cannot "
            "exercise this background thread — arm a site on its "
            "path (faults.check/with_retries) or justify the "
            "exemption")
