"""Capture pieces of work as CUDA graphs and compose them with WHILE loops.

The JAX package compiles a whole tree, or a chunk of trees, into one XLA
program (``jax.jit`` of ``lax.while_loop``s and a ``lax.scan``); the
number of waves a tree takes is decided on the device.  Here each piece
of a tree (see ``ops/grow.py``: its prologue, one wave of each stage, its
epilogue) is captured once by PyTorch (:meth:`GraphSet.capture`, a kept
``torch.cuda.CUDAGraph``), and :func:`compose` joins the pieces into one
executable graph in which a stage's wave graph is the body of a
conditional WHILE node (``csrc/graph_loop.cu``).  A loop runs while the
grower's control words on the device say ``not done and nl < limit``, so
a launch of the composed graph reads nothing back on the host.

All pieces of a :class:`GraphSet` share one memory pool: they replay in
one order, one at a time, and hand each other data only through tensors
allocated outside any capture.  Capture or launch failures raise; there
is no eager fallback on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .build import load_library


def _lib():
    lib = load_library("graph_loop")
    if lib.loop_graph_build.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.loop_graph_build.argtypes = [i, p, p, p, p, p]
        lib.loop_graph_build.restype = i
        lib.loop_graph_launch.argtypes = [p, p]
        lib.loop_graph_launch.restype = i
        lib.loop_graph_destroy.argtypes = [p, p]
        lib.loop_graph_destroy.restype = i
    return lib


class GraphSet:
    """Captured pieces on one device, sharing one private memory pool.
    Keeps every captured graph (and so its memory) alive."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs: List[torch.cuda.CUDAGraph] = []

    def capture(self, fn) -> torch.cuda.CUDAGraph:
        """Capture ``fn()`` (tensor work on ``device``; no host reads) into
        a kept graph of this set."""
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.device(self.device), torch.cuda.graph(
                g, pool=self.pool, stream=self.stream,
                capture_error_mode="thread_local"):
            fn()
        self.graphs.append(g)
        return g


class ComposedGraph:
    """An instantiated graph from :func:`compose`; :meth:`launch` runs it
    on the current stream without synchronizing."""

    def __init__(self, exec_handle: int, graph_handle: int, pieces,
                 device: torch.device):
        self._exec, self._graph = exec_handle, graph_handle
        self._pieces = pieces           # the torch graphs it was built from
        self.device = device

    def launch(self) -> None:
        if self._exec is None:
            raise RuntimeError("launch of a closed composed graph")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = _lib().loop_graph_launch(self._exec, stream)
        if rc != 0:
            raise RuntimeError(f"composed graph launch failed: CUDA error "
                               f"{rc}")

    def close(self) -> None:
        if self._exec is not None:
            _lib().loop_graph_destroy(self._exec, self._graph)
            self._exec = self._graph = None

    def __del__(self):
        try:
            self.close()
        except Exception:                                # noqa: BLE001
            pass


def compose(steps: Sequence[Tuple[torch.cuda.CUDAGraph, Optional[int]]],
            ctl: torch.Tensor) -> ComposedGraph:
    """One executable graph running ``steps`` in order: ``(graph, None)``
    once, ``(graph, limit)`` as a WHILE loop while ``ctl[1] == 0 and
    ctl[0] < limit`` (``ctl``: contiguous int32 control words on the
    device; the condition is evaluated before the first iteration and
    after each)."""
    if ctl.dtype != torch.int32 or ctl.device.type != "cuda" \
            or not ctl.is_contiguous() or ctl.numel() < 2:
        raise ValueError("ctl must be a contiguous int32 CUDA tensor of at "
                         "least 2 words")
    n = len(steps)
    raws = (ctypes.c_void_p * n)(*[g.raw_cuda_graph() for g, _ in steps])
    limits = (ctypes.c_int * n)(*[-1 if lim is None else int(lim)
                                  for _, lim in steps])
    exec_h, graph_h = ctypes.c_void_p(), ctypes.c_void_p()
    with torch.cuda.device(ctl.device):
        rc = _lib().loop_graph_build(n, raws, limits, ctl.data_ptr(),
                                     ctypes.byref(exec_h),
                                     ctypes.byref(graph_h))
    if rc != 0:
        raise RuntimeError(f"building the composed graph failed: CUDA error "
                           f"{rc}")
    return ComposedGraph(exec_h.value, graph_h.value,
                         [g for g, _ in steps], ctl.device)
