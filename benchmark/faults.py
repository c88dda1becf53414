"""Faults planted in the program, in this process, to see the comparison
that decides ``correct`` fail: the readings that bound the limits from
above, and the fault tests of ``benchmark/tests``.

* ``unchanged``: a step that returns its state unchanged: no tree is
  trained and the scores stay;
* ``half``: half of the batch left out, the mean taken over the rest:
  the gradients of the second half of the rows are dropped and the first
  half's doubled;
* ``altered``: an answer altered where it is produced: the score update
  adds every leaf value 1% too large.

There is one chip a cell, so no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def _patch(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield old
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``fault`` in the program for the body's duration."""
    from lightgbm_tpu_torch import basic
    from lightgbm_tpu_torch.boosting import gbdt
    from lightgbm_tpu_torch.objectives import binary
    from lightgbm_tpu_torch.ops import grow
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}; have {FAULTS}")
    if fault == "unchanged":
        with _patch(basic.Booster, "update_chunked",
                    lambda self, n, chunk=None: False), \
                _patch(basic.Booster, "update",
                       lambda self, train_set=None, fobj=None: False), \
                _patch(gbdt.GBDT, "train_chunked",
                       lambda self, n, chunk=20, **kw: False):
            yield
        return
    if fault == "half":
        orig_g = binary._binary_device_grad

        def grad(score, args):
            g, h = orig_g(score, args)
            keep = (torch.arange(g.shape[-1], device=g.device)
                    < g.shape[-1] // 2).to(g.dtype)
            return g * keep * 2.0, h * keep * 2.0

        with _patch(binary, "_binary_device_grad", grad):
            yield
        return
    orig_s = grow.DeviceGrower._add_leaf_scores

    def add(self, score, leaf_vals, leaf_id):
        return orig_s(self, score, leaf_vals * 1.01, leaf_id)

    with _patch(grow.DeviceGrower, "_add_leaf_scores", add):
        yield
