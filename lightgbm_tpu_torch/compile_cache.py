"""The persistent build cache: built kernels shared across processes.

Counterpart of ``lightgbm_tpu/compile_cache.py``.  The JAX package keeps
XLA's compiled executables in an on-disk cache so that a restarted
process does not compile again.  The port compiles no program per shape:
what persists across processes is the kernel libraries ``ops/build.py``
builds with ``nvcc``, one per source, named by the source's digest.
``compile_cache_dir`` (or ``LGBM_TPU_COMPILE_CACHE``) names the directory
where they are built and found, so a restarted harness that points at the
same directory builds nothing.  Beside them, in ``stage_plans/``, lie the
wave-stage plans ``wave_plan=profiled`` (or ``auto``) measured
(``ops/stage_plan.py``, :func:`artifact_dir`), so a fresh process adopts a
plan without measuring.  Within a process the captured CUDA graphs
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


def config_dir(cfg) -> Optional[str]:
    """The directory ``cfg`` names: ``compile_cache_dir``, else
    ``LGBM_TPU_COMPILE_CACHE``; None when neither names one (falsy values
    as in :func:`configure`)."""
    d = str(getattr(cfg, "compile_cache_dir", "") or "") \
        or os.environ.get(ENV_VAR, "")
    if not d or d.lower() in build._FALSY:
        return None
    return os.path.expanduser(d)


def artifact_dir(name: str, cfg) -> Optional[str]:
    """``<the compile cache directory cfg names>/<name>``, where small
    artifacts that share the kernel libraries' life lie (``stage_plans``:
    profiled wave-stage plans); not created here.  None when ``cfg``
    names no directory.  It follows the booster's own config, never the
    process-wide kernel directory an earlier booster may have moved
    (:func:`configure`)."""
    d = config_dir(cfg)
    return None if d is None else os.path.join(d, name)


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
    """Build and find the kernel libraries in the directory ``cfg`` names
    (:func:`config_dir`).  The kernel directory is process-wide, as the
    JAX package's cache is: it stays where the last config that named one
    put it."""
    return configure(config_dir(cfg))


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
