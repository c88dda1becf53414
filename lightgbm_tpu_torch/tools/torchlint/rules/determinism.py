"""TL131 — nondeterminism taint reaching model/checkpoint/digest bytes.

Byte-identical trees across fused/per-iteration/resume and
process-stable ``plan_digest``/``plan_signature``/``grower_key`` keys
are load-bearing contracts (the tests and the card run diff model
strings and their sha256 across runs).  They
die quietly when a nondeterministic value sneaks into anything that is
serialized or hashed: a wall-clock read in a checkpoint payload, an
unseeded ``np.random`` or ``torch.rand`` draw feeding leaf values, a
set's hash order
deciding serialization order.  This rule runs a small taint analysis
over the project call graph:

**Sources** — ``time.time/time_ns/monotonic/perf_counter``,
``datetime.now/utcnow/today``, unseeded RNGs (``np.random.<draw>`` on
the global state, ``np.random.default_rng()`` / ``RandomState()`` with
no seed, stdlib ``random.<draw>``, ``uuid.uuid1/uuid4``,
``os.urandom``, ``secrets.*``, ``torch.seed()``, and torch draws on
the global generator: ``torch.rand/randn/randint/randperm/normal/...``
with no ``generator=``), and order-unstable collection reads
(``list``/``tuple``/iteration over a set — hash order).  Seeded
constructors (``default_rng(seed)``, ``RandomState(seed)``,
``Random(seed)``), draws from an explicit ``generator=`` and the port's
``utils/random.py`` (counter-based keys from ``PRNGKey(seed)`` and
``fold_in``) are deterministic and exempt.

**Propagation** — through assignments within a function; through calls:
a function whose return value is taint-derived taints its call sites,
and a tainted argument taints the callee's parameter (summaries are
computed to a fixpoint over the project call graph, so taint crosses
module boundaries).

**Sinks** — arguments of the serialization/keying functions the
contracts depend on: ``plan_digest``/``save_plan``/``cache_plan``,
``plan_signature``/``grower_key``/``_config_digest``, the checkpoint
writers
(``save_pipeline_checkpoint``/``save_train_state``/
``atomic_write_text``/``atomic_write_bytes``/``save_checkpoint``), and
``model_to_string``/``save_model`` arguments.

Telemetry is deliberately NOT a sink — obs timings/span payloads are
allowed to carry wall-clock values.  Same rule as jaxlint's JL131, with
the torch sources and the port's key functions added.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..context import FileContext, dotted_name
from ..project import FuncKey, ProjectContext

CODE = "TL131"
SHORT = ("nondeterministic value (wall-clock / unseeded RNG / set "
         "order) flows into model, checkpoint or digest bytes")

PROJECT_RULE = True

_CLOCK_FNS = {"time", "time_ns", "monotonic", "monotonic_ns",
              "perf_counter", "perf_counter_ns", "process_time", "clock"}
_DATETIME_FNS = {"now", "utcnow", "today"}
_RANDOM_DRAWS = {"random", "randint", "randrange", "uniform", "normal",
                 "rand", "randn", "choice", "shuffle", "sample",
                 "bytes", "standard_normal", "permutation", "getrandbits"}
_SEEDED_CTORS = {"default_rng", "RandomState", "Random", "Generator",
                 "SeedSequence", "PRNGKey"}

#: torch draws on the process-global generator (unless ``generator=``)
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial", "poisson", "rand_like",
                "randn_like", "randint_like"}

SINKS = {"plan_digest", "save_plan", "cache_plan", "plan_signature",
         "grower_key", "_config_digest", "save_pipeline_checkpoint",
         "save_train_state", "atomic_write_text", "atomic_write_bytes",
         "save_checkpoint", "model_to_string", "save_model", "dump_model"}


def _is_source(ctx: FileContext, node: ast.AST) -> Optional[str]:
    """Short description when ``node`` is a taint source call/expr."""
    if not isinstance(node, ast.Call):
        return None
    d = dotted_name(node.func)
    if d is None:
        # list(<set>) etc. handled by caller via _unordered_read
        return None
    parts = d.split(".")
    tail = parts[-1]
    root = parts[0]
    if root == "time" and tail in _CLOCK_FNS:
        return f"wall-clock `{d}()`"
    if tail in _DATETIME_FNS and ("datetime" in parts or "date" in parts):
        return f"wall-clock `{d}()`"
    if tail in ("uuid1", "uuid4"):
        return f"`{d}()`"
    if d in ("os.urandom",) or root == "secrets":
        return f"entropy `{d}()`"
    if root in ctx.numpy_aliases and len(parts) >= 2 \
            and parts[1] == "random":
        if tail in _SEEDED_CTORS:
            return None if node.args else \
                f"unseeded `{d}()` (global entropy)"
        if tail in _RANDOM_DRAWS or tail == "seed":
            return f"global-state `{d}(...)` (no fold_in-derived key)"
        return None
    if root in ctx.torch_aliases:
        if tail == "seed":
            return f"entropy `{d}()`"
        if tail in _TORCH_DRAWS \
                and not any(kw.arg == "generator" for kw in node.keywords):
            return f"global-generator `{d}(...)` (no seeded generator)"
        return None
    if root == "random" and len(parts) == 2:
        if tail in _SEEDED_CTORS:
            return None if node.args else f"unseeded `{d}()`"
        if tail in _RANDOM_DRAWS:
            return f"global-state `{d}(...)`"
    return None


def _is_set_like(ctx: FileContext, node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.Name):
        return node.id in ctx.set_names(node)
    return False


def _unordered_read(ctx: FileContext, node: ast.AST) -> bool:
    """list/tuple(<set>) — hash-order materialization (sorted() is the
    deterministic spelling and is exempt)."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "tuple")
            and node.args and _is_set_like(ctx, node.args[0]))


_PARAM_TAINT = "tainted parameter"


class _Summary:
    __slots__ = ("returns_tainted", "sink_params", "return_reason")

    def __init__(self):
        self.returns_tainted = False
        self.return_reason: Optional[str] = None
        #: param names whose taint reaches a sink inside this function
        self.sink_params: Set[str] = set()


def _function_pass(project: ProjectContext, fi,
                   summaries: Dict[FuncKey, _Summary],
                   tainted_params: Set[str],
                   report: Optional[list]) -> _Summary:
    """One abstract-interpretation pass over ``fi``.  With ``report``
    set, sink hits are appended as (node, reason) pairs."""
    ctx = project.ctx_for[fi.module]
    # parameter taint carries its provenance ("tainted parameter:<p>")
    # so an alias (`m = meta`) still attributes a sink hit to `meta`
    env: Dict[str, str] = {p: f"{_PARAM_TAINT}:{p}"
                           for p in tainted_params}
    out = _Summary()

    def expr_taint(node: ast.AST) -> Optional[str]:
        for sub in ast.walk(node):
            src = _is_source(ctx, sub)
            if src is not None:
                return src
            if _unordered_read(ctx, sub):
                return "set hash-order materialization"
            if isinstance(sub, ast.Name) and sub.id in env:
                return env[sub.id]
            if isinstance(sub, ast.Call):
                for callee in project.resolve_call(fi, sub):
                    s = summaries.get(callee)
                    if s is not None and s.returns_tainted:
                        return s.return_reason or "tainted call result"
        return None

    def note_sink_hit(arg: ast.AST, sink_name: str, reason: str):
        """A tainted expression meets a sink: report it (report mode)
        or attribute it to the responsible parameters (summary mode)."""
        if reason.startswith(_PARAM_TAINT):
            out.sink_params.add(reason.split(":", 1)[1])
        elif report is not None:
            report.append((node, sink_name, reason))

    own_scope = project.own_nodes(fi)
    stmts = [n for n in own_scope if isinstance(n, (ast.Assign,
                                                    ast.AugAssign))]
    stmts.sort(key=lambda n: (n.lineno, n.col_offset))
    for _ in range(2):
        for node in stmts:
            reason = expr_taint(node.value)
            if reason is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    env[t.id] = reason

    for node in own_scope:
        if isinstance(node, ast.Return) and node.value is not None:
            reason = expr_taint(node.value)
            if reason is not None \
                    and not reason.startswith(_PARAM_TAINT):
                out.returns_tainted = True
                out.return_reason = reason
        if not isinstance(node, ast.Call):
            continue
        d = dotted_name(node.func)
        tail = d.split(".")[-1] if d else None
        if tail in SINKS:
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                reason = expr_taint(a)
                if reason is not None:
                    note_sink_hit(a, tail, reason)
        # taint crossing into a callee that forwards it to a sink
        for callee in project.resolve_call(fi, node):
            s = summaries.get(callee)
            if s is None or not s.sink_params:
                continue
            cfi = project.functions[callee]
            params = [a.arg for a in cfi.node.args.args]
            # method calls pass the receiver implicitly: align
            # positional args past `self`/`cls`
            off = 1 if (params and params[0] in ("self", "cls")
                        and isinstance(node.func, ast.Attribute)) else 0
            pos_args = [(params[i + off] if i + off < len(params)
                         else None, a)
                        for i, a in enumerate(node.args)]
            kw_args = [(kw.arg, kw.value) for kw in node.keywords]
            for pname, a in pos_args + kw_args:
                if pname not in s.sink_params:
                    continue
                reason = expr_taint(a)
                if reason is not None:
                    note_sink_hit(a, cfi.name, reason)
    return out


def _param_sink_summary(project: ProjectContext, fi,
                        summaries: Dict[FuncKey, _Summary]) -> Set[str]:
    """Params of ``fi`` whose taint would reach a sink."""
    params = {a.arg for a in fi.node.args.args} - {"self", "cls"}
    if not params:
        return set()
    s = _function_pass(project, fi, summaries, params, report=None)
    return s.sink_params


def _relevant(project: ProjectContext) -> Set[FuncKey]:
    """Functions whose pass can yield a taint, a sink hit or a summary:
    those holding a source, a set materialization or a sink call, and
    (transitively) their callers.  Every other function's pass is empty,
    so it is skipped."""
    out: Set[FuncKey] = set()
    for key, fi in project.functions.items():
        ctx = project.ctx_for[fi.module]
        for node in project.own_nodes(fi):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if (d is not None and d.split(".")[-1] in SINKS) \
                    or _is_source(ctx, node) is not None \
                    or _unordered_read(ctx, node):
                out.add(key)
                break
    callers: Dict[FuncKey, Set[FuncKey]] = {}
    for caller, callees in project.calls.items():
        for c in callees:
            callers.setdefault(c, set()).add(caller)
    stack = list(out)
    while stack:
        for c in callers.get(stack.pop(), ()):
            if c not in out:
                out.add(c)
                stack.append(c)
    return out


def check_project(project: ProjectContext):
    summaries: Dict[FuncKey, _Summary] = {}
    relevant = _relevant(project)
    # fixpoint over return-taint and param-to-sink summaries
    for _ in range(3):
        changed = False
        for key, fi in project.functions.items():
            if key not in relevant:
                continue
            s = _function_pass(project, fi, summaries, set(), report=None)
            s.sink_params = _param_sink_summary(project, fi, summaries)
            prev = summaries.get(key)
            if prev is None or prev.returns_tainted != s.returns_tainted \
                    or prev.sink_params != s.sink_params:
                changed = True
            summaries[key] = s
        if not changed:
            break

    findings: List[Tuple[ast.AST, str, str, str]] = []
    for _key, fi in sorted(project.functions.items()):
        if _key not in relevant:
            continue
        report: list = []
        _function_pass(project, fi, summaries, set(), report=report)
        for node, sink, reason in report:
            findings.append((node, sink, reason, fi.module))
    # module-level statements (outside any function) get a light pass
    for mname, mod in sorted(project.modules.items()):
        ctx = mod.ctx
        for node in project.module_level_nodes(mname):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            tail = d.split(".")[-1] if d else None
            if tail not in SINKS:
                continue
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(a):
                    src = _is_source(ctx, sub)
                    if src is None and _unordered_read(ctx, sub):
                        src = "set hash-order materialization"
                    if src is not None:
                        findings.append((node, tail, src, mname))

    seen = set()
    for node, sink, reason, mname in findings:
        ctx = project.ctx_for[mname]
        dk = (mname, getattr(node, "lineno", 0), sink, reason)
        if dk in seen:
            continue
        seen.add(dk)
        yield ctx.make_finding(
            CODE, node,
            f"{reason} reaches `{sink}(...)`: model bytes, checkpoint "
            "payloads and cache digests must be identical across runs — "
            "derive the value from seeds/fold_in, sort the collection, "
            "or keep it out of the serialized payload")
