"""Virtual file IO: scheme-dispatched readers/writers.

Counterpart of ``lightgbm_tpu/utils/file_io.py``.  The reference abstracts
its file access behind ``VirtualFileReader`` / ``VirtualFileWriter`` so
local files and HDFS share one interface (``src/io/file_io.cpp:13,54``;
HDFS behind ``USE_HDFS``).  Here it is a small scheme registry:

* plain paths and ``file://`` open locally;
* ``*.gz`` paths transparently decompress (text mode) — the practical
  equivalent of the reference's seekable binary streams for the text
  loaders here;
* other schemes (``hdfs://``, ``gs://``, ``s3://``) dispatch through
  ``register_scheme`` so an embedder can plug a filesystem in without
  touching the loaders.  Without a registered handler they raise a
  clear error instead of a bare ``FileNotFoundError``.

Every text ingest path (the parsers, config files) opens files through
:func:`open_text`.
"""

from __future__ import annotations

import gzip
import os
import threading
from typing import Callable, Dict, IO

from .log import LightGBMError

# scheme -> callable(path, mode) -> file object
_SCHEMES: Dict[str, Callable[[str, str], IO]] = {}
_schemes_lock = threading.Lock()


def register_scheme(scheme: str, opener: Callable[[str, str], IO]) -> None:
    """Plug a filesystem in (the USE_HDFS analog): ``opener(path, mode)``
    receives the FULL path including the scheme prefix."""
    with _schemes_lock:
        _SCHEMES[scheme.rstrip(":/")] = opener


def _scheme_of(path: str) -> str:
    head, sep, _ = path.partition("://")
    return head if sep and "/" not in head else ""


def open_text(path: str, mode: str = "r") -> IO:
    """Open a text stream for any supported path form."""
    scheme = _scheme_of(path)
    if scheme in ("", "file"):
        local = path[len("file://"):] if scheme == "file" else path
        if "r" in mode and not os.path.exists(local):
            raise LightGBMError(f"could not open data file {path}")
        if local.endswith(".gz"):
            return gzip.open(local, mode if "t" in mode else mode + "t")
        return open(local, mode)
    opener = _SCHEMES.get(scheme)
    if opener is None:
        raise LightGBMError(
            f"no filesystem registered for scheme {scheme}:// "
            f"(use lightgbm_tpu_torch.utils.file_io.register_scheme)")
    return opener(path, mode)


def exists(path: str) -> bool:
    scheme = _scheme_of(path)
    if scheme in ("", "file"):
        local = path[len("file://"):] if scheme == "file" else path
        return os.path.exists(local)
    try:
        fh = open_text(path)
    except Exception:   # noqa: BLE001 — any failure means "not readable"
        return False
    fh.close()
    return True
