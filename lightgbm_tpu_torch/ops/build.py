"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``lightgbm_tpu_torch/csrc/`` is compiled at first use into
:data:`BUILD_DIR` (a shared library with a plain C interface, for
``sm_90a``), under a name that carries the digest of the source, so an
edited source is never served a stale library.  :data:`BUILD_DIR` is
``build/lightgbm_tpu_torch/`` beside the package, or the directory that
``LGBM_TPU_COMPILE_CACHE`` (or ``compile_cache.configure``) names: the
libraries are what a later process finds built.  :data:`COUNTS` holds the
libraries this process built and those it found built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..obs import capture_track

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = CSRC.parent.parent / "build" / "lightgbm_tpu_torch"
ENV_VAR = "LGBM_TPU_COMPILE_CACHE"
_FALSY = ("", "0", "false", "no", "off")
BUILD_DIR = (Path(os.environ[ENV_VAR]).expanduser()
             if os.environ.get(ENV_VAR, "").lower() not in _FALSY
             else DEFAULT_BUILD_DIR)
#: libraries built by this process ("built") and found already built
#: ("found"), counted under :data:`_COUNTS_LOCK`
COUNTS = {"built": 0, "found": 0}
_COUNTS_LOCK = threading.Lock()
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded.  The servers raise
    it where they are built or warmed and never answer it from the host
    walk: a kernel that does not build is a broken install, not a device
    fault."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA toolkit is needed to "
                           "build the package's kernels")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def start_build(name: str):
    """Start ``nvcc`` for one source; returns ``(Popen or None, path)``
    (None when the library is already built).  Lets a caller compile
    several sources at once."""
    out = library_path(name)
    if out.exists():
        with _COUNTS_LOCK:
            COUNTS["found"] += 1
        return None, out
    with _COUNTS_LOCK:
        COUNTS["built"] += 1
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.lgbm_tmp = tmp
    return proc, out


def finish_build(proc, out: Path) -> str:
    """Wait for a build from :func:`start_build`; returns nvcc's output
    (register and shared-memory use per kernel) and raises on failure."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed ({proc.returncode}) for "
                               f"{out.name}:\n{log}")
    os.replace(proc.lgbm_tmp, out)
    return log


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.  The first load in
    a process is recorded in the capture telemetry as ``build.<name>``
    (``obs/capture_track.py``), keyed by the library's file name and
    whether this call built it: the port's counterpart of the kernel
    compiles inside the JAX package's tracked XLA compiles."""
    t0 = time.perf_counter()
    proc, out = start_build(name)
    finish_build(proc, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise KernelBuildError(f"cannot load {out}: {e}") from e
    capture_track.record(f"build.{name}", capture_track.signature_of(
        (out.name, "found" if proc is None else "built")), t0,
        time.perf_counter() - t0)
    return lib
