"""Deterministic host-side RNG helpers (copy of ``lightgbm_tpu/utils/random.py``).

numpy Generators seeded deterministically: the bin-construction sample and
the sub-seeds a master ``seed`` derives are the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np


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
