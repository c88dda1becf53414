"""The device clock of the grower's trees.

Every tree the device grower grows records six int64 values in
nanoseconds into the row of its chunk slot (``ctl[3]``) of a
``(capacity, 6)`` table beside the chunk's records
(``DeviceGrower._ensure_state``: ``out_clock``):

* ``start``: before the tree's first piece;
* ``waves_start``: at the end of the start piece, before the first wave;
* ``waves_end``: at the start of the finish piece, after the last wave;
* ``end``: at the end of the finish piece;
* ``hist_ns``: the sum over the tree's waves of the time of the
  grower's kernel-1 call (``DeviceGrower._wave_hist``), stamped just
  before and just after it;
* ``grad_ns``: the objective's gradient in a fused tree's sample piece
  (``DeviceGrower._piece_sample``), stamped just before and just after
  it; 0 on a tree that is not fused (its gradients come from the host).

On the card one one-thread kernel (``csrc/obs_clock.cu``,
``obs_clock_stamp``) reads ``%globaltimer``; it is captured into the
pieces like any other launch, so it runs inside the composed graph's
WHILE nodes too.  On the CPU the plain loop stamps
``time.perf_counter_ns()``.  The stamps are always on: they read nothing
back, and the table reaches the host with the records' own copy
(``boosting/gbdt.py``), as each host ``Tree``'s ``device_clock``.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import torch

from .build import load_library
from .hist_cuda import DeviceLaunchCount

FIELDS = ("start", "waves_start", "waves_end", "end", "hist_ns", "grad_ns")
START, WAVES_START, WAVES_END, END, HIST, GRAD = range(len(FIELDS))
#: stamp modes: set the field; set it and zero the sums (a tree's first
#: stamp); open an interval of a sum (field -= now); close it
#: (field += now)
SET, OPEN_TREE, OPEN, CLOSE = range(4)


class DeviceClock(NamedTuple):
    """One tree's stamps, in nanoseconds of one clock (the card's
    ``%globaltimer``, or ``perf_counter_ns`` on the CPU)."""
    start: int
    waves_start: int
    waves_end: int
    end: int
    hist_ns: int
    grad_ns: int

    @classmethod
    def from_row(cls, row) -> "DeviceClock":
        return cls(*(int(v) for v in row))


def _launcher():
    fn = load_library("obs_clock").obs_clock_stamp_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p, p]
        fn.restype = i
    return fn


def stamp(clock: torch.Tensor, ctl: torch.Tensor, field: int,
          mode: int = SET) -> None:
    """Stamp ``field`` of the row ``ctl[3]`` of ``clock`` (a contiguous
    ``(capacity, 6)`` int64 table) by ``mode``; a slot outside the table
    is left alone.  On the card: one kernel launch on the current stream
    (captured when a capture is running), which also counts itself in
    :attr:`stamp.launches`; on the CPU: the host clock, counted there."""
    count = stamp.launches.counter(clock.device)
    if clock.device.type == "cpu":
        count.add_(1)
        t = int(ctl[3])
        if not 0 <= t < clock.shape[0]:
            return
        now = time.perf_counter_ns()
        if mode == OPEN:
            clock[t, field] -= now
        elif mode == CLOSE:
            clock[t, field] += now
        else:
            clock[t, field] = now
            if mode == OPEN_TREE:
                clock[t, HIST] = 0
                clock[t, GRAD] = 0
        return
    rc = _launcher()(clock.data_ptr(), ctl.data_ptr(), int(clock.shape[0]),
                     int(field), int(mode), count.data_ptr(),
                     torch.cuda.current_stream(clock.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"obs_clock_stamp launch failed: CUDA error {rc}")


#: the stamps made, counted on their device (a replayed graph's too; read
#: by chip_smoke.py)
stamp.launches = DeviceLaunchCount()
