"""The collective verbs over a one-axis mesh of devices, in one process
(counterpart of ``lightgbm_tpu/parallel/network.py``, its in-process half).

A mesh is a list of ``torch.device`` workers (several may name one card;
the JAX package's one-axis ``Mesh``).  A sharded value is a list of
tensors, one a worker, each on its worker's device; the reference's five
verbs (``include/LightGBM/network.h:86-296``) take such lists:
``allreduce`` sums them onto the first worker and hands every worker the
sum, ``reduce_scatter`` gives worker ``d`` its block of the sum,
``all_gather`` stacks them, ``allreduce_max``/``allreduce_min`` and
``argmax_allreduce`` (the SplitInfo max-reduce, ties to the smaller id).
:meth:`Network.run_sharded` is the counterpart of ``shard_map``: a loop
over the workers that applies a function to each worker's tensors.  One
process sees every worker's values, so the host-level scalar syncs
(``sync_up_by_min/max/mean``) are identities, as in the JAX package's
single-controller program.

Each verb logs its payload's bytes in ``comm_log`` as the JAX verb does at
trace time, one entry a collective: the learners' communication volumes
compare one for one with the JAX package's.

The socket half of the JAX module (``connect_with_retries``,
``send_bytes``/``recv_bytes``, ``broadcast_blob``,
``network_policy_from_config``) is the multi-controller plane, one process
a host over ``torch.distributed``; this package does not have it yet, and
:func:`broadcast_blob` refuses it by name.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

from ..utils.log import LightGBMError, log_info


def make_mesh(num_machines: int, devices: Optional[Sequence] = None
              ) -> List[torch.device]:
    """One-axis mesh over the first ``num_machines`` of ``devices``
    (default the process's cards)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if num_machines > len(devices):
        raise LightGBMError(
            f"num_machines={num_machines} exceeds available devices "
            f"({len(devices)}); reduce num_machines or pass a mesh")
    return devices[:num_machines]


def _nbytes(x) -> int:
    return int(x.numel() * x.element_size()) \
        if isinstance(x, torch.Tensor) else 0


class Network:
    """A one-axis mesh and the collective verbs over per-worker lists."""

    def __init__(self, mesh: Optional[Sequence] = None,
                 num_machines: int = 1, devices=None):
        self.mesh = [torch.device(d) for d in mesh] if mesh is not None \
            else make_mesh(num_machines, devices)
        if not self.mesh:
            raise LightGBMError("Network needs at least one worker")
        #: (verb, payload bytes) of every collective, in order
        self.comm_log: list = []

    def _log(self, verb: str, x) -> None:
        self.comm_log.append((verb, _nbytes(x)))

    def reset_comm_log(self) -> None:
        self.comm_log = []

    @property
    def num_machines(self) -> int:
        return len(self.mesh)

    def _check(self, xs) -> None:
        if len(xs) != self.num_machines:
            raise LightGBMError(f"a sharded value has {len(xs)} parts, the "
                                f"mesh {self.num_machines} workers")

    def _spread(self, x) -> list:
        return [x.to(d) for d in self.mesh]

    def _reduce(self, xs, op):
        self._check(xs)
        dev = self.mesh[0]
        out = xs[0].to(dev)
        for x in xs[1:]:
            out = op(out, x.to(dev))
        return out

    # -- the verbs (Network::Allreduce etc.) --------------------------------
    def allreduce(self, xs) -> list:
        """Sum-allreduce (``HistogramBinEntry::SumReducer``), summed in
        worker order onto the first worker."""
        self._log("allreduce", xs[0])
        return self._spread(self._reduce(xs, torch.add))

    def reduce_scatter(self, xs) -> list:
        """Sum, then worker ``d`` keeps block ``d`` of the leading axis
        (``Network::ReduceScatter``)."""
        self._log("reduce_scatter", xs[0])
        total = self._reduce(xs, torch.add)
        return [b.to(d) for b, d in zip(
            torch.chunk(total, self.num_machines, dim=0), self.mesh)]

    def all_gather(self, xs) -> list:
        """Stack along a fresh leading axis, on every worker
        (``Network::Allgather``)."""
        self._log("all_gather", xs[0])
        self._check(xs)
        return self._spread(torch.stack([x.to(self.mesh[0]) for x in xs]))

    def allreduce_max(self, xs) -> list:
        self._log("allreduce_max", xs[0])
        return self._spread(self._reduce(xs, torch.maximum))

    def allreduce_min(self, xs) -> list:
        self._log("allreduce_min", xs[0])
        return self._spread(self._reduce(xs, torch.minimum))

    def argmax_allreduce(self, keys, payloads, tie_ids):
        """The payload of the worker whose ``key`` is largest, ties to the
        smaller ``tie_id`` (the SplitInfo max-reduce,
        ``parallel_tree_learner.h:183-207``): returns (the payload as f32
        on every worker, each worker's owner flag).  ``payloads`` is a
        list (one entry a worker) of tensors or of tuples of tensors."""
        self._log("argmax_allreduce:key", keys[0])
        self._log("argmax_allreduce:tie", tie_ids[0])
        kmax = self._reduce(keys, torch.maximum)
        tid = [torch.where(k.to(kmax.device) == kmax, t.to(kmax.device),
                           torch.iinfo(torch.int32).max)
               for k, t in zip(keys, tie_ids)]
        tmin = functools.reduce(torch.minimum, tid)
        owner = [(k.to(kmax.device) == kmax) & (t.to(kmax.device) == tmin)
                 for k, t in zip(keys, tie_ids)]

        def sel(parts):
            self._log("argmax_allreduce:payload", parts[0])
            dev = self.mesh[0]
            total = sum(torch.where(o, p.to(dev).float(),
                                    torch.zeros((), device=dev))
                        for o, p in zip(owner, parts))
            return self._spread(total)

        first = payloads[0]
        if isinstance(first, (tuple, list)):
            picked = tuple(sel([p[i] for p in payloads])
                           for i in range(len(first)))
            out = [tuple(v[d] for v in picked)
                   for d in range(self.num_machines)]
        else:
            out = sel(payloads)
        return out, [o.to(d) for o, d in zip(owner, self.mesh)]

    # -- placement ------------------------------------------------------------
    def shard_rows(self, x) -> list:
        """A ``(D * k, ...)`` tensor as D contiguous ``k``-row blocks, block
        ``d`` on worker ``d`` (the pre-partitioned layout, ``dataset.h:
        82``)."""
        if x.shape[0] % self.num_machines:
            raise LightGBMError(f"{x.shape[0]} rows do not split evenly "
                                f"over {self.num_machines} workers")
        return [b.contiguous().to(d) for b, d in zip(
            torch.chunk(x, self.num_machines, dim=0), self.mesh)]

    def replicate(self, x) -> list:
        return self._spread(x)

    # -- host-level scalar syncs (network.h:165-257) ---------------------------
    # one process sees every worker's scalars: identities, as in the JAX
    # package's single-controller program
    def sync_up_by_min(self, v):
        return v

    def sync_up_by_max(self, v):
        return v

    def sync_up_by_mean(self, v):
        return v

    def global_sum(self, x):
        """Sum of a sharded value (a list) or of a tensor's leading
        axis."""
        if isinstance(x, (list, tuple)):
            return self._reduce(list(x), torch.add)
        return x.sum(dim=0)

    # -- the sharded runner ------------------------------------------------------
    def run_sharded(self, fn):
        """``fn`` applied to each worker's tensors in worker order (the
        counterpart of ``shard_map``): an argument that is a list (a
        sharded value) gives each call its worker's part, any other is
        passed whole to every call.  Returns the per-worker results as a
        list; the collectives act on such lists between calls."""
        def run(*args):
            out = []
            for d in range(self.num_machines):
                part = [a[d] if isinstance(a, list) else a for a in args]
                out.append(fn(*part))
            return out
        return run


def broadcast_blob(payload, *, address: str, num_hosts: int, rank: int,
                   config=None) -> bytes:
    """The pod slice's rank-0 blob broadcast over sockets: refused by name
    (the multi-controller plane is not ported yet)."""
    raise LightGBMError("not ported to lightgbm_tpu_torch yet: "
                        "broadcast_blob (the socket network of the "
                        "multi-controller plane)")


@functools.lru_cache(maxsize=8)
def _default_network(num_machines: int) -> Network:
    log_info(f"Initializing the collective mesh with {num_machines} "
             f"worker(s)")
    return Network(num_machines=num_machines)


def create_network(config, mesh: Optional[Sequence] = None) -> Network:
    """The network of a config: ``num_machines`` workers over the
    process's cards, or an explicit ``mesh`` (the
    ``LGBM_NetworkInitWithFunctions`` analog)."""
    if mesh is not None:
        return Network(mesh=mesh)
    return _default_network(int(config.num_machines))
