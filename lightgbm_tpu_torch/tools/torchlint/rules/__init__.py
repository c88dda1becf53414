"""Rule registry: TLxxx code -> rule module.

Each rule module exposes ``CODE``, ``SHORT`` and either ``check(ctx)``
(per-file, TL0xx) or ``check_project(project)`` with ``PROJECT_RULE =
True`` (cross-module dataflow, TL1xx).  Each code is ``TL`` plus the
number of the jaxlint rule it mirrors.  Registration is explicit (no
import-time magic) so the set of shipped rules is grep-able here.
"""

from __future__ import annotations

from . import (abi_parity, capture_registry, concurrency, determinism,
               dtype_drift, dtype_flow, fault_coverage, global_state,
               graph_key, host_sync, lock_order, recapture, set_order)

_MODULES = (host_sync, recapture, capture_registry, dtype_drift, set_order,
            global_state, graph_key, dtype_flow, lock_order, determinism,
            concurrency, abi_parity, fault_coverage)

#: code -> rule module, in code order
RULES = {m.CODE: m for m in _MODULES}

#: code -> per-file rule module (checked one file at a time)
FILE_RULES = {c: m for c, m in RULES.items()
              if not getattr(m, "PROJECT_RULE", False)}

#: code -> project rule module (needs the whole-repo symbol table)
PROJECT_RULES = {c: m for c, m in RULES.items()
                 if getattr(m, "PROJECT_RULE", False)}

#: code -> one-line description (CLI --list-rules, docs)
RULE_DOCS = {m.CODE: m.SHORT for m in _MODULES}

#: code -> full rule documentation (CLI --explain)
RULE_EXPLAIN = {m.CODE: (m.__doc__ or m.SHORT).strip() for m in _MODULES}
