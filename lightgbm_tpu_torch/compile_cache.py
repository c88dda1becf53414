"""The persistent build cache: built kernels shared across processes.

Counterpart of ``lightgbm_tpu/compile_cache.py``.  The JAX package keeps
XLA's compiled executables in an on-disk cache so that a restarted
process does not compile again.  The port compiles no program per shape:
what persists across processes is the kernel libraries ``ops/build.py``
builds with ``nvcc``, one per source, named by the source's digest.
``compile_cache_dir`` (or ``LGBM_TPU_COMPILE_CACHE``) names the directory
where they are built and found, so a restarted harness that points at the
same directory builds nothing.  Within a process the captured CUDA graphs
persist across boosters in the grower cache (``ops/grow.py``,
``grower_cache``); :func:`clear` drops it.

:func:`counters` reports libraries built fresh ("misses") and libraries
found built ("hits"), the names the JAX package's counters use, and the
CUDA-graph captures of the process (the grower cache counts its own hits
and misses, ``ops/grow.py::GROWER_CACHE_COUNTS``).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional

from .obs import capture_track
from .ops import build, grow

ENV_VAR = build.ENV_VAR
_LOCK = threading.Lock()


def cache_dir() -> Optional[str]:
    """The directory the kernel libraries are built into and found in."""
    return str(build.BUILD_DIR)


def configure(cache_dir: Optional[str]) -> Optional[str]:
    """Build and find the kernel libraries in ``cache_dir`` (created if
    missing).  Falsy values ("", "0", "false", "off") leave the directory
    as it is and return None.  Libraries already loaded by this process
    stay loaded."""
    if cache_dir is None or str(cache_dir).lower() in build._FALSY:
        return None
    path = Path(os.path.expanduser(str(cache_dir)))
    path.mkdir(parents=True, exist_ok=True)
    with _LOCK:
        build.BUILD_DIR = path
    return str(path)


def configure_from_env() -> Optional[str]:
    return configure(os.environ.get(ENV_VAR))


def configure_from_config(cfg) -> Optional[str]:
    """``compile_cache_dir`` of ``cfg``, else ``LGBM_TPU_COMPILE_CACHE``."""
    d = str(getattr(cfg, "compile_cache_dir", "") or "")
    if d:
        return configure(d)
    return configure_from_env()


def counters() -> dict:
    """Kernel libraries built fresh (``misses``) and found built
    (``hits``) by this process, and its CUDA-graph captures."""
    return {"misses": build.COUNTS["built"], "hits": build.COUNTS["found"],
            "captures": capture_track.COUNTS["captures"]}


def clear() -> int:
    """Drop the cached growers and their device buffers (the counterpart
    of clearing the JAX package's in-process program cache); returns how
    many were dropped."""
    return grow.clear_grower_cache()
