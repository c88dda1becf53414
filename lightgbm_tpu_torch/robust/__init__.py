"""Fault tolerance (counterpart of ``lightgbm_tpu/robust/``).

* :mod:`~lightgbm_tpu_torch.robust.faults` — deterministic, seed-keyed
  fault injection at named sites (armed via ``LGBM_TPU_FAULTS`` or the
  ``fault_spec`` param), so every failure mode below is testable without
  hardware;
* :mod:`~lightgbm_tpu_torch.robust.retry` — the shared
  :func:`~lightgbm_tpu_torch.robust.retry.with_retries` policy wrapper
  (capped exponential backoff, deterministic jitter) and the
  :class:`~lightgbm_tpu_torch.robust.retry.CircuitBreaker`;
* :mod:`~lightgbm_tpu_torch.robust.checkpoint` — atomic
  (write-temp-then-rename) training snapshots and pipeline window
  checkpoints, which ``pipeline.core.RetrainPipeline`` resumes from.

Not ported: the pod-slice checkpoint commit protocol (multi-host
training) and the server's degrade-to-host path.
"""

from . import faults  # noqa: F401  (site API: robust.faults.check(...))
from .checkpoint import (atomic_replace_from, atomic_write_bytes,
                         atomic_write_text, has_pipeline_checkpoint,
                         latest_snapshot, load_pipeline_checkpoint,
                         load_train_state, save_pipeline_checkpoint,
                         save_train_state)
from .faults import (InjectedFault, InjectedOSError, InjectedTimeout,
                     parse_fault_spec)
from .retry import (CircuitBreaker, RetryError, RetryPolicy,
                    backoff_delay, transient_dispatch_errors,
                    with_retries)

__all__ = [
    "faults", "InjectedFault", "InjectedOSError", "InjectedTimeout",
    "parse_fault_spec", "RetryPolicy", "RetryError", "with_retries",
    "backoff_delay", "CircuitBreaker", "transient_dispatch_errors",
    "atomic_write_bytes", "atomic_write_text", "atomic_replace_from",
    "save_train_state", "load_train_state", "latest_snapshot",
    "save_pipeline_checkpoint", "load_pipeline_checkpoint",
    "has_pipeline_checkpoint",
]
