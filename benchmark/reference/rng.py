"""The sampling draws a configuration with bagging or feature_fraction
states, worked out again: Threefry-2x32 with 20 rounds (Salmon et al.,
SC'11), under the key schedule of ``jax.random`` with partitionable
counters, as the port's sampling documents it.

* the bag of bagging round ``it`` (every ``bagging_freq`` iterations):
  rows whose float32 uniform under ``PRNGKey((bagging_seed + it) &
  0x7FFFFFFF)``, drawn over the smallest power of two >= max(rows, 1024),
  is below ``float32(bagging_fraction)``;
* the features of tree ``t``: the ``ceil(nf * feature_fraction)``
  smallest of ``nf`` uniforms under ``fold_in(PRNGKey(feature_fraction_
  seed), t)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry(k0: int, k1: int, x0, x1):
    """The two output words of counters ``(x0, x1)`` (ints or int64
    tensors holding uint32 values) under key ``(k0, k1)``."""
    ks = (k0 & M32, k1 & M32, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for step in range(5):
        for r in _ROT[step % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & M32
    return x0, x1


def fold_in(key, d: int):
    return threefry(key[0], key[1], 0, int(d) & M32)


def prng_key(seed: int):
    return (0, int(seed) & M32)


def uniform(key, n: int, device) -> torch.Tensor:
    """(n,) float32 uniforms in [0, 1): the xor of both words at counter
    ``(i >> 32, i)``, its top 23 bits as a mantissa."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry(key[0], key[1], i >> 32, i & M32)
    mant = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def bag(it: int, num_data: int, fraction: float, seed: int,
        device) -> torch.Tensor:
    """(num_data,) bool in-bag rows of the round starting at ``it``."""
    pad = 1024
    while pad < num_data:
        pad <<= 1
    u = uniform(prng_key((seed + it) & 0x7FFFFFFF), pad, device)
    return u[:num_data] < float(np.float32(fraction))


def features(tree: int, nf: int, fraction: float, seed: int,
             device) -> torch.Tensor:
    """(nf,) bool features tree ``tree`` may split on."""
    k = max(1, int(math.ceil(nf * fraction)))
    u = uniform(fold_in(prng_key(seed & 0x7FFFFFFF), tree), nf, device)
    return u <= torch.sort(u).values[k - 1]
