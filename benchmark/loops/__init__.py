"""The traffic loops.  A traffic mix (``traffic/<mix>.json``) names its
``loop`` and holds its parameters; the loop drives the program through
its public entry points:

* ``fused_train``: one booster trained chunk after chunk by
  ``Booster.update_chunked`` (``engine.train``'s fused driving);
* ``retrain_windows``: a fresh ``Dataset`` (bins found anew) and a fresh
  booster by ``engine.train`` for every window, cycling through windows
  made in set-up.

Each loop is a class ``Loop`` with ``setup()``, ``window(seconds)``,
``traced(profiler)``, ``release()`` and ``check()``; see :class:`Base`.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import numpy as np


class Base:
    """A run's loop.  ``ctx`` carries the cell, its configuration and
    mix, the seed, the device, the run's directory and a logger.

    The control (``ctx.control``) is the program's own lower-precision
    path where it has one: ``CONTROL_PARAMS`` switch it on."""

    #: the program's int8 gradient path: the step below the bf16
    #: gradient columns the configurations state
    CONTROL_PARAMS = {"grad_quant_bits": 8}

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.mix = ctx.mix
        self.attempted = 0
        self.failed = 0

    # the program's parameters: the configuration's, on the run's device
    def params(self, **extra) -> dict:
        p = dict(self.cfg["params"])
        if self.ctx.control:
            p.update(self.CONTROL_PARAMS)
        p.update(extra)
        p["device_type"] = self.ctx.device.type
        p["verbose"] = -1
        return p

    def rows(self, stream: int, n: int, **kw):
        """``n`` rows and labels of the configuration's generator, stream
        ``stream`` of the run's seed, on the run's device."""
        make = self.ctx.spec.generator(self.cfg["data"])
        return make(int(n), self.ctx.seed, stream, self.ctx.device, **kw)

    def judge_params(self) -> dict:
        """What the reference needs: the program's parameters and the
        configuration's ``reference`` settings."""
        return {**self.cfg["params"], **self.cfg["reference"]}

    def objective(self):
        return self.ctx.spec.objective(self.cfg["params"]["objective"])

    def draw(self, among: int) -> int:
        """An index below ``among`` drawn from the seed."""
        return int(np.random.default_rng(self.ctx.seed % (1 << 63))
                   .integers(max(int(among), 1)))

    def sync(self) -> None:
        import torch
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def setup(self) -> None:
        raise NotImplementedError

    def window(self, seconds: float) -> Dict[str, float]:
        raise NotImplementedError

    def traced(self, profiler) -> dict:
        raise NotImplementedError

    def release(self) -> None:
        """Drop the program's state (what ``check`` judges was copied off
        it first) and return its card memory."""
        import torch
        from lightgbm_tpu_torch import compile_cache
        self.drop()
        compile_cache.clear()
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def drop(self) -> None:
        raise NotImplementedError

    def check(self) -> List[Tuple[str, float]]:
        raise NotImplementedError


def tree_counts(tree) -> Tuple[int, List[int], List[int]]:
    """(bagged rows at the root, the bagged rows of each leaf, those of
    the smaller child of each split) of one of the program's trees."""
    nl = int(tree.num_leaves)
    leaves = [int(c) for c in tree.leaf_count[:nl]]
    if nl <= 1:
        return leaves[0] if leaves else 0, leaves, []

    def count(c):
        return int(tree.leaf_count[~c]) if c < 0 else int(tree.internal_count[c])

    smaller = [min(count(int(tree.left_child[i])), count(int(tree.right_child[i])))
               for i in range(nl - 1)]
    return int(tree.internal_count[0]), leaves, smaller


def plain_trees(models) -> list:
    """Copies of the program's trees (in memory, as the timed path holds
    them) as the reference's plain arrays."""
    from ..reference.forest import Tree
    return [Tree(int(t.num_leaves),
                 **{k: np.array(getattr(t, k), copy=True)
                    for k in Tree.FIELDS})
            for t in models]
