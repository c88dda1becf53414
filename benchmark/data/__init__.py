"""The benchmark's inputs, made on the card from the seed.

A configuration's ``data`` names its generator, the file
``benchmark/data/<data>.py`` (found by ``Spec.generator``), whose
``make(n, seed, stream, device, **kw)`` returns ``(x (n, F) float32,
y (n,) float32)`` on ``device``, made in a few large calls on
:func:`generator`'s ``torch.Generator`` of that device, so the same seed
gives the same rows and every seed the same sizes.
"""

from __future__ import annotations

import torch

#: the seed of stream ``k`` of a run: distinct streams for the training
#: rows and each window
_STREAM_MULT = 1_000_003


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed`` (any
    whole number; folded into 63 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * _STREAM_MULT + int(stream)) % (1 << 63))
    return g
