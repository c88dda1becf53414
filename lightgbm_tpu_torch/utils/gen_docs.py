"""Render ``docs/PortParameters.md`` from the port's parameter schema.

Counterpart of ``lightgbm_tpu/utils/gen_docs.py`` (the port keeps its own
copy): the single source of truth is
``lightgbm_tpu_torch.params.PARAM_SCHEMA``; this module renders it with
the same sections, ordering and formatting as the JAX package's
``docs/Parameters.md``, and marks the parameters of
:data:`~lightgbm_tpu_torch.params.IGNORED_PARAMS`, which the port
accepts and ignores.  ``tests/test_torch_gen_docs.py`` asserts the
committed file is not stale.

Usage: ``python -m lightgbm_tpu_torch.utils.gen_docs [output_path]``
"""

from __future__ import annotations

import sys

from ..params import IGNORED_PARAMS, PARAM_SCHEMA

DEFAULT_PATH = "docs/PortParameters.md"

_SECTION_TITLES = {
    "core": "Core Parameters",
    "learning": "Learning Control Parameters",
    "io": "IO Parameters",
    "objective": "Objective Parameters",
    "metric": "Metric Parameters",
    "network": "Network Parameters",
    "device": "Device Parameters",
}
_SECTION_ORDER = ("core", "learning", "io", "objective", "metric",
                  "network", "device")
_IGNORED_NOTE = ("accepted and ignored by the port: it steers only the "
                 "JAX package's TPU programs (`Config` logs a warning when "
                 "it is set)")


def _fmt_default(p) -> str:
    v = p.default
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"' if v else '""'
    if isinstance(v, (list, tuple)):
        return '""' if not v else ",".join(str(x) for x in v)
    return str(v)


def _fmt_type(p) -> str:
    t = p.type
    if t is bool:
        return "bool"
    if t is int:
        return "int"
    if t is float:
        return "double"
    if t is list:
        return "multi-value string"
    return "string"


def render() -> str:
    out = ["# Parameters of the PyTorch/CUDA port", "",
           "Generated from `lightgbm_tpu_torch/params.py` "
           "(`python -m lightgbm_tpu_torch.utils.gen_docs "
           f"{DEFAULT_PATH}`). "
           "Do not edit by hand — the port's schema is the single source "
           "of truth for its parser, its alias table, and this document. "
           "It holds the JAX package's parameters (`docs/Parameters.md`) "
           "with their names, aliases, types, checks and defaults, but "
           "`device_type`, which defaults to `cuda` here; the parameters "
           "marked below are accepted and ignored.", ""]
    for section in _SECTION_ORDER:
        params = [p for p in PARAM_SCHEMA if p.section == section]
        if not params:
            continue
        out.append(f"## {_SECTION_TITLES[section]}")
        out.append("")
        for p in params:
            head = (f"- `{p.name}` : {_fmt_type(p)}, "
                    f"default = `{_fmt_default(p)}`")
            if p.check:
                head += f", constraint: `{p.check}`"
            out.append(head)
            for alias in p.aliases:
                out.append(f"  - alias: `{alias}`")
            if p.desc:
                out.append(f"  - {p.desc}")
            if p.name in IGNORED_PARAMS:
                out.append(f"  - {_IGNORED_NOTE}")
        out.append("")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else DEFAULT_PATH
    text = render()
    with open(path, "w") as fh:
        fh.write(text)
    print(f"wrote {path} ({text.count(chr(10))} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
