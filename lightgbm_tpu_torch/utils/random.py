"""Random numbers: the host RNG helpers and jax's Threefry in torch.

``make_rng``/``derive_seeds`` copy ``lightgbm_tpu/utils/random.py``: numpy
Generators seeded deterministically, so the bin-construction sample and the
sub-seeds a master ``seed`` derives are the JAX package's bit for bit.

The rest is the explicit generator of the port's sampling draws (bagging
masks, feature_fraction masks, quantization noise).  It reproduces the bits
of ``jax.random`` under the default Threefry-2x32 implementation with
``jax_threefry_partitionable`` on (the counters of an n-element draw are the
iota ``(i >> 32, i & 0xFFFFFFFF)``), so every draw equals the JAX package's
for the same seed and tree index, on the CPU and on the card alike:

* a key is a pair of 32-bit words, held as two Python ints on the host
  or, for the draws a captured CUDA graph replays with new keys, as a
  ``(2,)`` int64 tensor on the draw's device (:func:`key_tensor`): the
  graph reads the key from a buffer the host refills, so it is not baked
  into the captured kernels;
* ``PRNGKey(seed)`` = ``(seed >> 32, seed & 0xFFFFFFFF)`` of a 32-bit seed;
* ``fold_in(key, d)`` = both words of ``threefry2x32(key, (0, d))``;
* ``split(key, num)[i]`` = both words of ``threefry2x32(key, (0, i))``;
* ``uniform(key, shape)`` = the xor of the two words of
  ``threefry2x32(key, (i >> 32, i))`` at flat index ``i``, its top 23 bits
  as a float32 mantissa in [1, 2), minus 1.

Element ``i`` of a draw depends on ``i`` and the key only, never on the
draw's length (tests/test_torch_random.py pins it).  The 32-bit arithmetic
runs in int64 masked with ``0xFFFFFFFF``: torch's uint32 lacks most
arithmetic kernels.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def make_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.uint64(seed & 0xFFFFFFFFFFFFFFFF))


def derive_seeds(master_seed: int):
    """Derive sub-seeds for each consumer from one master seed.

    Mirrors the reference Config behaviour where ``seed`` overrides
    data_random_seed / feature_fraction_seed / bagging_seed / drop_seed
    deterministically.
    """
    ss = np.random.SeedSequence(master_seed)
    children = ss.spawn(5)
    names = ("data", "feature_fraction", "bagging", "drop", "objective")
    return {n: int(c.generate_state(1)[0]) for n, c in zip(names, children)}


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def _rounds(ks, x0, x1):
    """The 20 rounds over counter words ``x0``, ``x1`` (int64 tensors or
    Python ints) under the key schedule ``ks``."""
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & MASK32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & MASK32
    return x0, x1


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11; jax's
    ``threefry2x32_p``) of the counter words ``x0``, ``x1`` (int64 tensors
    holding uint32 values) under ``key``; returns the two output words as
    int64 tensors on the counters' device.  ``key`` is a pair of Python
    ints or a ``(2,)`` int64 tensor on the counters' device; both give the
    same bits."""
    if isinstance(key, torch.Tensor):
        k0, k1 = key[0] & MASK32, key[1] & MASK32
    else:
        k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    return _rounds((k0, k1, k0 ^ k1 ^ 0x1BD11BDA), x0, x1)


def _words(key: Key, counter: int) -> Key:
    """Both output words of the counter ``(0, counter)``, in Python ints
    (the host derives every per-tree key this way)."""
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    return _rounds((k0, k1, k0 ^ k1 ^ 0x1BD11BDA), 0,
                   int(counter) & MASK32)


def key_tensor(key: Key, device=None) -> torch.Tensor:
    """A host key as the ``(2,)`` int64 tensor form."""
    return torch.tensor([int(key[0]), int(key[1])], dtype=torch.int64,
                        device=device)


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey`` of a seed in [0, 2**32) (the JAX package
    masks every sampling seed to 31 bits)."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return (0, seed)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: a new key from ``key`` and a 32-bit int."""
    return _words(key, data)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split``: ``num`` new keys."""
    return [_words(key, i) for i in range(int(num))]


def random_bits(key, shape, device=None) -> torch.Tensor:
    """32 random bits per element (int64 tensor holding uint32 values);
    ``key`` as in :func:`threefry2x32` (a tensor key sets the device)."""
    if isinstance(key, torch.Tensor):
        device = key.device
    shape = tuple(int(s) for s in (shape if isinstance(shape, (tuple, list))
                                   else (shape,)))
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(key, i >> 32, i & MASK32)
    return (a ^ b).reshape(shape)


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1); ``key`` a
    host pair or a ``(2,)`` int64 tensor."""
    bits = random_bits(key, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0
