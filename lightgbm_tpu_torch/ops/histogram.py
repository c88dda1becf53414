"""Row bucketing (the part of ``lightgbm_tpu/ops/histogram.py`` the port
needs).  The grower pads its row buffers to a power-of-two bucket so that
one set of buffer shapes serves a whole range of dataset sizes."""

from __future__ import annotations


def bucket_size(count: int, minimum: int = 1024) -> int:
    """Smallest power of two >= ``count`` (and >= ``minimum``)."""
    b = minimum
    while b < count:
        b <<= 1
    return b
