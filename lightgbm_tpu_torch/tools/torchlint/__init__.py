"""torchlint: repo-aware static analysis for the PyTorch/CUDA port.

The port's counterpart of ``lightgbm_tpu/tools/jaxlint`` (its own copy:
the port imports nothing of the JAX package).  Each rule is ``TL`` plus
the number of the jaxlint rule it mirrors; docs/PortStaticAnalysis.md
has a bad/good example for each and says where it departs from its
twin.

Per-file rules:

- **TL001** host-device sync inside hot-path loops
- **TL002** CUDA-graph recapture hazards
- **TL003** captures and kernel loads not recorded by
  ``obs/capture_track.py``
- **TL004** a float64 numpy array moved to the card with no dtype
- **TL005** set iteration order leaking into output
- **TL006** unguarded mutation of module-level state

Cross-module dataflow rules (whole-repo symbol table + call graph,
``project.py``):

- **TL101** graph-key completeness around ``grower_key`` /
  ``plan_signature``
- **TL111** int8 quantization dtype-contract flow
- **TL121** lock-order inversions and thread-shared state
- **TL131** determinism taint into model/checkpoint/digest bytes
- **TL141** thread/queue concurrency graph (span context handoff,
  unbounded blocking, join under a lock)
- **TL151** C-ABI parity across header, C++ glue, bindings and adapters
- **TL161** fault-site registry coverage

CLI: ``python -m lightgbm_tpu_torch.tools.torchlint [paths]`` (default
``lightgbm_tpu_torch``).  Inline suppression: ``# torchlint:
disable=TL001`` (same line) or ``# torchlint: disable-next=TL001``
(next line), each with its reason.  Accepted findings would live in the
committed ``baseline.json`` beside this file; it is empty.
"""

from .baseline import DEFAULT_BASELINE, apply, dump, finding_key, load, write
from .context import FileContext, Finding
from .core import AnalysisResult, analyze_paths, analyze_source
from .rules import RULE_DOCS, RULES

__all__ = [
    "AnalysisResult", "DEFAULT_BASELINE", "FileContext", "Finding",
    "RULES", "RULE_DOCS", "analyze_paths", "analyze_source", "apply",
    "dump", "finding_key", "load", "write",
]
