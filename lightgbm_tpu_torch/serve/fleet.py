"""Multi-tenant model fleet: M packed ensembles stacked on a model axis.

Counterpart of the data plane of ``lightgbm_tpu/serve/fleet.py``
(``PackedFleet``, ``stack_packs``, ``pack_fleet``, ``_fleet_write``,
``fleet_predict_scores`` / ``fleet_predict_leaves``).  M same-family
boosters become one ``(M, T, N)`` tensor family, and one launch of the
packed-forest kernel (``serve/packed.forest_predict``) serves any batch of
``(tenant id, row)`` pairs: each row routes exactly as its tenant's solo
pack would, because both go through the same kernel.  A tenant swap is an
index copy into the model axis (:func:`write_tenant`).  The opt-in
``value_dtype="bf16"`` variant halves the leaf table; routing stays exact,
only the leaf values quantize.

:class:`FleetServer` serves a fleet to threads: per-row tenant ids,
tenant hot swaps that other tenants never wait on (an index copy, no
recapture: the kernel compiles nothing per shape), micro-batching queues
with one worker a replica, and warm-up.  Replicas wrap round onto the
one card, as the JAX package wraps them onto its devices: each has its
own queue, worker and circuit breaker over the one fleet, so a replica
degrades on its own.  On the card every replica launches, and every swap
writes, on one high-priority serving stream apart from the default
stream that training uses, so a request never queues behind a retrain's
kernels; one launch lock orders the launches against a swap's in-place
write (the uploads and read-backs run outside it: the one stream keeps
them in order).  Under ``host_fallback`` (on by
default) the ``serve.fleet.dispatch`` injected fault is answered by each
tenant's host walk over its served slice, loudly as in
``serve/engine.py``: ``serve.fleet.fallback_requests`` counts every such
answer, a trip is logged and sets ``serve.fleet.replica_degraded.<r>``
and ``serve.fleet.degraded_replicas`` (anchored at 0 when the fleet is
built, so the SLO's dark fraction integrates from a healthy start), and
``serve.fleet.degraded_time`` takes each dark period.  A real launch
error (a CUDA error, a kernel library that does not build) raises as
``serve.fleet.failed`` and never degrades.  :class:`TenantHandle` is one
tenant behind the ``PredictionServer`` surface.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from concurrent.futures import Future
from queue import Empty, Queue
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..config import resolve_device
from ..obs import tracing
from ..robust import faults
from ..robust.retry import CircuitBreaker
from ..utils.log import LightGBMError, log_warning
from .engine import (ModelMeta, _as_gbdt, count_fallback, host_slice,
                     require_kernel, row_bucket)
from .packed import (ARRAY_FIELDS, ForestRecords, ForestTables,
                     PackedEnsemble, forest_predict, forest_records,
                     pack_ensemble, query_tensor)

__all__ = ["PackedFleet", "stack_packs", "pack_fleet", "write_tenant",
           "fleet_predict_scores", "fleet_predict_leaves", "FleetServer",
           "TenantHandle"]

#: accepted ``value_dtype`` spellings -> torch dtype of the leaf table
_VALUE_DTYPES = {"f32": torch.float32, "float32": torch.float32,
                 "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def _value_dtype(name: str):
    try:
        return _VALUE_DTYPES[str(name).lower()]
    except KeyError:
        raise LightGBMError(
            f"unknown fleet value_dtype {name!r}; expected one of "
            f"{sorted(set(_VALUE_DTYPES))}") from None


@dataclasses.dataclass(frozen=True)
class PackedFleet:
    """M stacked :class:`~.packed.PackedEnsemble` tenants: every tensor is
    the solo layout with a leading model axis.  Tenants whose solo pads
    are smaller than the fleet's are padded up (padding trees are stumps
    with leaf value 0, padded nodes are unreachable), which leaves each
    tenant's results unchanged."""

    split_feature: torch.Tensor
    threshold_hi: torch.Tensor
    threshold_lo: torch.Tensor
    decision_type: torch.Tensor
    left_child: torch.Tensor
    right_child: torch.Tensor
    cat_start: torch.Tensor
    cat_len: torch.Tensor
    cat_words: torch.Tensor
    leaf_value: torch.Tensor
    is_stump: torch.Tensor
    num_tenants: int = 1
    num_model: int = 1
    max_depth: int = 0
    num_features: int = 1
    value_dtype: str = "f32"

    @property
    def device(self) -> torch.device:
        return self.split_feature.device

    @property
    def tree_pad(self) -> int:
        return int(self.split_feature.shape[1])

    @property
    def node_pad(self) -> int:
        return int(self.split_feature.shape[2])

    @property
    def word_pad(self) -> int:
        return int(self.cat_words.shape[1])

    def shape_signature(self) -> tuple:
        return (tuple(self.split_feature.shape),
                tuple(self.leaf_value.shape), tuple(self.cat_words.shape),
                self.num_model, self.max_depth, self.num_features,
                self.value_dtype)

    def fits(self, pe: PackedEnsemble) -> bool:
        """Can ``pe`` be written into this fleet without growing a pad?"""
        return (pe.split_feature.shape[0] <= self.tree_pad
                and pe.split_feature.shape[1] <= self.node_pad
                and pe.cat_words.shape[0] <= self.word_pad
                and pe.max_depth <= self.max_depth
                and pe.num_model == self.num_model
                and pe.num_features == self.num_features)

    def tables(self) -> ForestTables:
        return ForestTables(*(getattr(self, f) for f in ARRAY_FIELDS))

    @functools.cached_property
    def records(self) -> ForestRecords:
        """The kernel's node records of every tenant (built on first use,
        rewritten tenant by tenant by :func:`write_tenant`)."""
        return forest_records(self.tables())


def _bits(a: torch.Tensor) -> torch.Tensor:
    """uint32 tensors as their int32 bits (a view), others as they are."""
    return a.view(torch.int32) if a.dtype == torch.uint32 else a


def _padded_tenant_arrays(pe: PackedEnsemble, t_pad: int, n_pad: int,
                          w_pad: int, leaf_dtype) -> Tuple:
    """The solo pack's tensors padded up to the fleet pads, in
    ``ARRAY_FIELDS`` order, without the model axis; the words as their
    int32 bits."""
    dt = int(t_pad) - int(pe.split_feature.shape[0])
    dn = int(n_pad) - int(pe.split_feature.shape[1])
    dw = int(w_pad) - int(pe.cat_words.shape[0])
    if min(dt, dn, dw) < 0:
        raise LightGBMError("packed ensemble exceeds the fleet pads")
    pad = torch.nn.functional.pad

    def pad2(a, fill=0):
        return pad(a, (0, dn, 0, dt), value=fill)

    # uint32 and bool lack pad kernels on some backends: pad their bits
    words = pad(_bits(pe.cat_words), (0, dw))
    stump = pad(pe.is_stump.to(torch.uint8), (0, dt), value=1).bool()
    return (
        pad2(pe.split_feature), pad2(pe.threshold_hi),
        pad2(pe.threshold_lo), pad2(pe.decision_type),
        pad2(pe.left_child, -1), pad2(pe.right_child, -1),
        pad2(pe.cat_start), pad2(pe.cat_len), words,
        pad2(pe.leaf_value).to(leaf_dtype), stump,
    )


def stack_packs(packs: Sequence[PackedEnsemble],
                value_dtype: str = "f32") -> PackedFleet:
    """Stack solo packs (equal ``num_model`` and ``num_features``, one
    device) into one :class:`PackedFleet`, every tenant padded to the
    fleet-wide max of each pad."""
    if not packs:
        raise LightGBMError("stack_packs needs at least one tenant")
    k = packs[0].num_model
    nf = packs[0].num_features
    for i, pe in enumerate(packs):
        if pe.num_model != k or pe.num_features != nf:
            raise LightGBMError(
                f"tenant {i} has num_model={pe.num_model}/num_features="
                f"{pe.num_features}; the fleet requires ({k}, {nf}): "
                f"pack every tenant with the same num_features")
    t_pad = max(int(pe.split_feature.shape[0]) for pe in packs)
    n_pad = max(int(pe.split_feature.shape[1]) for pe in packs)
    w_pad = max(int(pe.cat_words.shape[0]) for pe in packs)
    depth = max(int(pe.max_depth) for pe in packs)
    dtype = _value_dtype(value_dtype)
    cols = [torch.stack(col) for col in zip(*[
        _padded_tenant_arrays(pe, t_pad, n_pad, w_pad, dtype)
        for pe in packs])]
    i = ARRAY_FIELDS.index("cat_words")
    cols[i] = cols[i].view(torch.uint32)
    return PackedFleet(*cols, num_tenants=len(packs), num_model=k,
                       max_depth=depth, num_features=nf,
                       value_dtype=str(value_dtype).lower())


def pack_fleet(boosters: Sequence, num_features: Optional[int] = None,
               start_iteration: int = 0, num_iteration: int = -1,
               value_dtype: str = "f32", device="cuda"
               ) -> Tuple[PackedFleet, List[PackedEnsemble]]:
    """Pack M boosters (``Booster``, ``GBDT`` or model-file path each) into
    a fleet on ``device``.  ``num_features`` defaults to the max over the
    tenants.  Returns the fleet and the per-tenant solo packs."""
    gbdts = [_as_gbdt(b) for b in boosters]
    for g in gbdts:
        g._flush_pending()
    nf = int(num_features) if num_features else \
        max(g.max_feature_idx + 1 for g in gbdts)
    # a fleet seeded from one booster passes it M times: pack it once
    packed_by_id = {}
    packs = []
    for g in gbdts:
        pe = packed_by_id.get(id(g))
        if pe is None:
            pe = pack_ensemble(g.models, g.num_model,
                               start_iteration=start_iteration,
                               num_iteration=num_iteration,
                               num_features=nf, device=device)
            packed_by_id[id(g)] = pe
        packs.append(pe)
    return stack_packs(packs, value_dtype), packs


def _fleet_write(fl: PackedFleet, row: PackedFleet, idx: int) -> PackedFleet:
    """Index-copy one tenant (``row``: a one-tenant fleet at ``fl``'s
    pads) into ``fl``'s model axis at ``idx``, in place; returns ``fl``.
    On the card the copies are ordered on the current stream with the
    launches around them.  Node records already built are rewritten for
    the tenant the same way."""
    for f in ARRAY_FIELDS:
        _bits(getattr(fl, f))[idx].copy_(_bits(getattr(row, f))[0])
    if "records" in fl.__dict__:
        for f in ("blob", "cat", "live"):
            getattr(fl.records, f)[idx].copy_(getattr(row.records, f)[0])
    return fl


def write_tenant(fl: PackedFleet, idx: int, pe: PackedEnsemble
                 ) -> PackedFleet:
    """Swap tenant ``idx`` of ``fl`` for the pack ``pe`` by an index copy
    (in place).  ``pe`` must fit the fleet's pads (:meth:`PackedFleet.fits`);
    a pack that does not is re-stacked with :func:`stack_packs`."""
    m = int(idx)
    if not 0 <= m < fl.num_tenants:
        raise LightGBMError(
            f"tenant_id {m} out of range [0, {fl.num_tenants})")
    if not fl.fits(pe):
        raise LightGBMError(
            f"tenant pack {pe.shape_signature()} does not fit the fleet's "
            f"pads {fl.shape_signature()}; re-stack with stack_packs")
    row = PackedFleet(
        *(a.to(fl.device)[None] for a in _padded_tenant_arrays(
            pe, fl.tree_pad, fl.node_pad, fl.word_pad,
            _value_dtype(fl.value_dtype))),
        num_tenants=1, num_model=fl.num_model, max_depth=fl.max_depth,
        num_features=fl.num_features, value_dtype=fl.value_dtype)
    return _fleet_write(fl, row, m)


def _tenant_tensor(fl: PackedFleet, tenant_ids, rows: int) -> torch.Tensor:
    """The (rows,) int32 tenant ids on the fleet's device (a scalar
    broadcasts), checked to lie in [0, M): the kernel reads the tables
    at them unchecked."""
    tid = np.asarray(tenant_ids, np.int32)
    if tid.ndim == 0:
        tid = np.full(rows, int(tid), np.int32)
    if tid.shape != (rows,):
        raise LightGBMError(
            f"tenant_ids shape {tid.shape} does not match {rows} rows")
    if rows and (tid.min() < 0 or tid.max() >= fl.num_tenants):
        raise LightGBMError(
            f"tenant_ids must be in [0, {fl.num_tenants}); got "
            f"[{tid.min()}, {tid.max()}]")
    return torch.from_numpy(np.array(tid, np.int32)).to(fl.device)


def fleet_predict_scores(fl: PackedFleet, tenant_ids, data,
                         lock=None) -> np.ndarray:
    """Raw scores (num_model, rows) float64 for a mixed-tenant batch: one
    kernel launch however many tenants the batch touches.  ``lock`` (a
    context manager) is held around the launch alone, not the uploads or
    the read-back: a server orders launches against its swaps' writes
    with it."""
    n = int(data.shape[0])
    if n == 0:
        return np.zeros((fl.num_model, 0), np.float64)
    tid = _tenant_tensor(fl, tenant_ids, n)
    x = query_tensor(data, fl.num_features, fl.device)
    with lock if lock is not None else contextlib.nullcontext():
        out = forest_predict(fl.tables(), x, tid, num_model=fl.num_model,
                             max_depth=fl.max_depth, records=fl.records)
    return out.cpu().numpy().astype(np.float64)


def fleet_predict_leaves(fl: PackedFleet, tenant_ids, data) -> np.ndarray:
    """Leaf index (rows, tree_pad) int32 for a mixed-tenant batch; columns
    past a tenant's real tree count are padding."""
    n = int(data.shape[0])
    if n == 0:
        return np.zeros((0, fl.tree_pad), np.int32)
    tid = _tenant_tensor(fl, tenant_ids, n)
    x = query_tensor(data, fl.num_features, fl.device)
    return forest_predict(fl.tables(), x, tid, num_model=fl.num_model,
                          max_depth=fl.max_depth, leaves=True,
                          records=fl.records).cpu().numpy()


class _FleetGen:
    """One immutable generation: the fleet and each tenant's
    :class:`ModelMeta`."""

    __slots__ = ("fleet", "metas", "packs")

    def __init__(self, fleet: PackedFleet, metas, packs):
        self.fleet, self.metas, self.packs = fleet, tuple(metas), list(packs)


class _Replica:
    """One serving replica on the card: a micro-batch queue, its worker
    and its own circuit breaker (degradation is per replica)."""

    __slots__ = ("index", "queue", "worker", "breaker")

    def __init__(self, index: int, breaker: CircuitBreaker):
        self.index = index
        self.queue: Queue = Queue()
        self.worker: Optional[threading.Thread] = None
        self.breaker = breaker


class FleetServer:
    """Thread-safe multi-tenant hot-swap predictor over a
    :class:`PackedFleet` on ``device`` (``cuda`` by default, which raises
    without a card; ``lightgbm_tpu/serve/fleet.py::FleetServer``).

    ``boosters`` seed the M tenants (each a ``Booster``, ``GBDT`` or model
    path; a cold fleet repeats one booster and ``swap_tenant``s later).
    ``replicas`` request queues with a worker each (0: one), round-robin,
    all on the one card.  ``value_dtype="bf16"``: the quantized leaf
    values.  ``num_iteration``/``start_iteration`` select the served
    slice on every swap.  ``host_fallback`` (default on) answers a failing
    launch from the tenants' host walks; ``breaker_factory(replica)``
    makes each replica's breaker (default: 3 consecutive failures trip
    it, re-probe every 2 s)."""

    def __init__(self, boosters: Sequence, *, num_iteration: int = -1,
                 start_iteration: int = 0, min_bucket: int = 128,
                 replicas: int = 1, max_batch: int = 8192,
                 max_wait_ms: float = 2.0, host_fallback: bool = True,
                 value_dtype: str = "f32",
                 num_features: Optional[int] = None, device="cuda",
                 breaker_factory=None):
        if not boosters:
            raise LightGBMError("FleetServer needs at least one tenant")
        self.device = resolve_device(str(device))
        require_kernel(self.device)
        self.host_fallback = bool(host_fallback)
        self.num_iteration = int(num_iteration)
        self.start_iteration = int(start_iteration)
        self.min_bucket = int(min_bucket)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.value_dtype = str(value_dtype).lower()
        _value_dtype(self.value_dtype)
        n_rep = int(replicas) or 1
        if n_rep < 1:
            raise LightGBMError(f"replicas must be >= 1, got {replicas}")
        if breaker_factory is None:
            breaker_factory = lambda i: CircuitBreaker(  # noqa: E731
                failure_threshold=3, reprobe_interval_s=2.0)
        # on the card the replicas' launches and the swaps' writes go on
        # one high-priority stream, so a request never queues behind the
        # training work of the threads that retrain the tenants (on the
        # default stream) and its blocks go first; the launch lock orders
        # the launches against a swap's in-place write
        self._replicas = [_Replica(i, breaker_factory(i))
                          for i in range(n_rep)]
        self._stream = (torch.cuda.Stream(self.device, priority=-1)
                        if self.device.type == "cuda" else None)
        self._lock = threading.Lock()        # the generation pointer
        self._swap_lock = threading.Lock()   # one swap at a time
        self._launch_lock = threading.Lock()  # launches against writes
        self._stopping = threading.Event()
        self._rr = 0
        gbdts = [_as_gbdt(b) for b in boosters]
        fleet, packs = pack_fleet(
            gbdts, num_features=num_features,
            start_iteration=self.start_iteration,
            num_iteration=self.num_iteration,
            value_dtype=self.value_dtype, device=self.device)
        self._gen = _FleetGen(fleet, [self._meta_for(g, pe)
                                      for g, pe in zip(gbdts, packs)], packs)
        obs.set_gauge("serve.fleet.tenants", fleet.num_tenants)
        obs.set_gauge("serve.fleet.replicas", n_rep)
        # the rolling timeline starts at 0 dark replicas: without it a
        # first trip mid-window would integrate as a whole-window outage
        # in the SLO's dark fraction (obs/slo.py)
        obs.set_gauge("serve.fleet.degraded_replicas", 0)

    def _meta_for(self, gbdt, pe: PackedEnsemble) -> ModelMeta:
        host_trees = (host_slice(gbdt, self.start_iteration,
                                 self.num_iteration)
                      if self.host_fallback else None)
        return ModelMeta(gbdt, pe.num_iterations, host_trees, pe.num_model)

    def _snapshot(self) -> _FleetGen:
        with self._lock:
            return self._gen

    @property
    def fleet(self) -> PackedFleet:
        return self._snapshot().fleet

    @property
    def num_tenants(self) -> int:
        return self._snapshot().fleet.num_tenants

    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    def degraded_replicas(self) -> List[int]:
        """Indices of the replicas whose breaker is open."""
        return [r.index for r in self._replicas
                if r.breaker.state == "open"]

    def tenant(self, tenant_id: int) -> "TenantHandle":
        """One tenant behind the ``PredictionServer`` surface."""
        return TenantHandle(self, tenant_id)

    # -- tenant hot swap ------------------------------------------------
    def swap_tenant(self, tenant_id: int, booster) -> bool:
        """Replace ONE tenant.  A pack that fits the fleet's pads is
        index-copied into its row (the other tenants keep serving, nothing
        is captured or compiled); one that does not re-stacks the fleet
        into a new generation.  Returns whether it fit."""
        m = int(tenant_id)
        gbdt = _as_gbdt(booster)
        with obs.span("serve.fleet.swap", cat="serve", tenant=m), \
                self._swap_lock, torch.cuda.stream(self._stream):
            gen = self._snapshot()
            fl = gen.fleet
            if not 0 <= m < fl.num_tenants:
                raise LightGBMError(
                    f"tenant_id {m} out of range [0, {fl.num_tenants})")
            gbdt._flush_pending()
            pe = pack_ensemble(gbdt.models, gbdt.num_model,
                               start_iteration=self.start_iteration,
                               num_iteration=self.num_iteration,
                               num_features=fl.num_features,
                               device=self.device)
            if pe.num_model != fl.num_model:
                raise LightGBMError(
                    f"tenant {m} booster has num_model={pe.num_model}; "
                    f"the fleet serves num_model={fl.num_model}")
            packs = list(gen.packs)
            packs[m] = pe
            fits = fl.fits(pe)
            metas = list(gen.metas)
            metas[m] = self._meta_for(gbdt, pe)
            # inside the swap span: this tenant's requests link back to
            # the training window above it (obs/tracing.py)
            metas[m].train_ctx = tracing.capture()
            if not fits:
                fl = stack_packs(packs, self.value_dtype)
                self._sync_swap()
            with self._launch_lock:
                if fits:
                    # in place: no launch reads the fleet while it is
                    # written, and the write is done before the next one
                    write_tenant(fl, m, pe)
                    self._sync_swap()
                with self._lock:
                    self._gen = _FleetGen(fl, metas, packs)
        obs.inc("serve.fleet.swaps")
        obs.inc(f"serve.fleet.tenant.{m}.swaps")
        if not fits:
            obs.inc("serve.fleet.swap_shape_changes")
        return fits

    def _sync_swap(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    # -- warm-up --------------------------------------------------------
    def warmup(self, row_buckets: Optional[Sequence[int]] = None
               ) -> List[int]:
        """Score a batch of zeros for tenant 0 at each row bucket
        (``None``: 128, 1,024 and 8,192 rows), building the kernel's
        library first; returns the buckets scored."""
        if row_buckets is None:
            row_buckets = [128, 1024, 8192]
        fl = self._snapshot().fleet
        done: List[int] = []
        for rows in row_buckets:
            b = row_bucket(int(rows), self.min_bucket)
            if b in done:
                continue
            with obs.span("serve.fleet.warmup", cat="serve", rows=b):
                fleet_predict_scores(fl, 0, np.zeros((b, fl.num_features)))
            done.append(b)
        return done

    # -- prediction -----------------------------------------------------
    def _pick_replica(self) -> _Replica:
        with self._lock:
            i = self._rr
            self._rr = (i + 1) % len(self._replicas)
        return self._replicas[i]

    def _host_raw(self, gen: _FleetGen, tid: np.ndarray,
                  data: np.ndarray) -> np.ndarray:
        """(K, rows) float64 by each tenant's host walk (the per-replica
        degrade path)."""
        out = np.zeros((gen.fleet.num_model, data.shape[0]), np.float64)
        for m in np.unique(tid):
            rows = np.nonzero(tid == m)[0]
            out[:, rows] = gen.metas[int(m)].host_raw(data[rows])
        return out

    def _score_batch(self, rep: _Replica, gen: _FleetGen, tid: np.ndarray,
                     data: np.ndarray) -> np.ndarray:
        """(K, rows) raw scores on one replica with per-replica
        degradation: the kernel when the replica's breaker allows it, the
        host walk when the injected dispatch fault fires or the breaker is
        open.  Input errors are refused by :meth:`predict` before this; a
        real launch error (a CUDA error, a kernel that does not build)
        raises and never degrades."""
        err: Optional[BaseException] = None
        if rep.breaker.allow():
            try:
                faults.check("serve.fleet.dispatch")
                # the current generation's tables: the launch is queued
                # under the launch lock, so it reads them before or after a
                # swap's in-place write, never between its copies (one
                # serving stream orders the rest)
                with torch.cuda.stream(self._stream):
                    raw = fleet_predict_scores(self._snapshot().fleet, tid,
                                               data, lock=self._launch_lock)
            except faults.InjectedFault as e:
                err = e
            except Exception:
                # a real launch error is the card's or the code's: raised,
                # never answered from the host
                obs.inc("serve.fleet.failed")
                raise
            else:
                dark = rep.breaker.record_success()
                if dark is not None:
                    obs.observe("serve.fleet.degraded_time", dark)
                    self._record_degraded(rep, 0)
                    log_warning(f"fleet replica {rep.index}: device path "
                                f"recovered after {dark:.3f} s degraded")
                obs.inc("serve.fleet.ok")
                return raw
        if not self.host_fallback:
            obs.inc("serve.fleet.failed")
            if err is not None:
                raise err
            raise LightGBMError(
                f"fleet replica {rep.index}: device path unavailable "
                f"(circuit open) and host fallback is disabled")
        out = self._host_raw(gen, tid, data)
        if err is not None:
            obs.inc("serve.fleet.device_failures")
            if rep.breaker.record_failure():
                self._record_degraded(rep, 1)
                log_warning(
                    f"fleet replica {rep.index}: device dispatch failing "
                    f"({err!r}); circuit open, serving the host walk, "
                    f"re-probing every {rep.breaker.reprobe_interval_s:g} "
                    f"s")
        obs.inc("serve.fleet.fallback_requests")
        count_fallback("fleet")
        return out

    def _record_degraded(self, rep: _Replica, value: int) -> None:
        obs.set_gauge(f"serve.fleet.replica_degraded.{rep.index}", value)
        obs.set_gauge("serve.fleet.degraded_replicas",
                      len(self.degraded_replicas()))

    def _convert(self, gen: _FleetGen, tid: np.ndarray, raw: np.ndarray,
                 raw_score: bool) -> np.ndarray:
        """Each tenant's rows converted as its solo server converts
        them."""
        k = gen.fleet.num_model
        tenants = np.unique(tid)
        if len(tenants) == 1:
            return gen.metas[int(tenants[0])].convert(raw, raw_score)
        out = np.empty(raw.shape[1] if k == 1 else (raw.shape[1], k),
                       np.float64)
        for m in tenants:
            rows = np.nonzero(tid == m)[0]
            out[rows] = gen.metas[int(m)].convert(raw[:, rows], raw_score)
        return out

    def predict(self, tenant_ids, data, raw_score: bool = False,
                replica: Optional[int] = None) -> np.ndarray:
        """Score a mixed-tenant batch in one kernel launch on one replica
        (round-robin unless ``replica`` pins it), each row answered as its
        tenant's solo server would: (rows,), or (rows, num_model) for
        multiclass.  A failing launch degrades to the host walk under
        ``host_fallback`` (:meth:`_score_batch`), else raises."""
        data = np.atleast_2d(np.asarray(data))
        n = int(data.shape[0])
        gen = self._snapshot()
        fl = gen.fleet
        tid = np.asarray(tenant_ids, np.int32)
        if tid.ndim == 0:
            tid = np.full(n, int(tid), np.int32)
        if tid.shape != (n,):
            obs.inc("serve.fleet.input_errors")
            raise LightGBMError(
                f"tenant_ids shape {tid.shape} does not match {n} rows")
        if n and (tid.min() < 0 or tid.max() >= fl.num_tenants):
            obs.inc("serve.fleet.input_errors")
            raise LightGBMError(
                f"tenant_ids must be in [0, {fl.num_tenants}); got "
                f"[{tid.min()}, {tid.max()}]")
        if data.shape[1] < fl.num_features:
            obs.inc("serve.fleet.input_errors")
            raise LightGBMError(
                f"query data has {data.shape[1]} features but the fleet "
                f"needs {fl.num_features}")
        rep = (self._replicas[int(replica)] if replica is not None
               else self._pick_replica())
        with obs.span("serve.fleet.predict", cat="serve", rows=n,
                      replica=rep.index) as sp:
            if n and tracing.enabled() and int(tid.min()) == int(tid.max()):
                # one tenant: link to the window that trained its model
                ctx = gen.metas[int(tid[0])].train_ctx
                if ctx is not None:
                    sp.set(tenant=int(tid[0]), model_trace_id=ctx.trace_id,
                           model_span_id=ctx.span_id)
            raw = self._score_batch(rep, gen, tid, data)
            out = self._convert(gen, tid, raw, raw_score)
        obs.inc("serve.fleet.requests")
        obs.inc("serve.fleet.rows", n)
        if obs.enabled():
            for m, c in zip(*np.unique(tid, return_counts=True)):
                obs.inc(f"serve.fleet.tenant.{int(m)}.rows", int(c))
        return out

    # -- micro-batching, a queue and a worker a replica -------------------
    def start(self) -> "FleetServer":
        """Start one micro-batching worker a replica (idempotent)."""
        with self._lock:
            self._stopping.clear()
            for rep in self._replicas:
                if rep.worker is not None and rep.worker.is_alive():
                    continue
                rep.worker = threading.Thread(
                    target=self._drain_loop, args=(rep,),
                    name=f"lgbm-fleet-{rep.index}", daemon=True)
                rep.worker.start()
        return self

    def stop(self) -> None:
        """Stop the workers; queued requests are answered first."""
        with self._lock:
            workers = [rep.worker for rep in self._replicas]
            for rep in self._replicas:
                rep.worker = None
            # inside the lock: submit() checks liveness and enqueues under
            # it, so an accepted request lands in a queue that is drained
            self._stopping.set()
        for w in workers:
            if w is not None:
                w.join(timeout=10.0)

    def __enter__(self) -> "FleetServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def submit(self, tenant_ids, data, raw_score: bool = False) -> Future:
        """Enqueue a (tenant_ids, rows) request on the next replica's
        queue; resolves to what ``predict`` returns for those rows."""
        data = np.atleast_2d(np.asarray(data))
        tid = np.asarray(tenant_ids, np.int32)
        if tid.ndim == 0:
            tid = np.full(data.shape[0], int(tid), np.int32)
        fut: Future = Future()
        rep = self._pick_replica()
        with self._lock:
            if (self._stopping.is_set() or rep.worker is None
                    or not rep.worker.is_alive()):
                raise LightGBMError("fleet micro-batching workers not "
                                    "running; call start() (or "
                                    "predict())")
            # the submitter's trace context rides the queue item to the
            # replica worker (None while tracing is off)
            rep.queue.put((tid, data, bool(raw_score), fut,
                           time.perf_counter(), tracing.capture()))
        obs.set_gauge(f"serve.fleet.replica_queue_depth.{rep.index}",
                      rep.queue.qsize())
        return fut

    def _drain_loop(self, rep: _Replica) -> None:
        while True:
            try:
                first = rep.queue.get(timeout=0.05)
            except Empty:
                if self._stopping.is_set():
                    return
                continue
            batch = [first]
            rows = first[1].shape[0]
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            while rows < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = rep.queue.get(timeout=remaining)
                except Empty:
                    break
                batch.append(item)
                rows += item[1].shape[0]
            obs.set_gauge(f"serve.fleet.replica_queue_depth.{rep.index}",
                          rep.queue.qsize())
            self._run_batch(rep, batch)

    def _run_batch(self, rep: _Replica, batch: List[Tuple]) -> None:
        """One launch per raw_score flavour; a failing batch is retried
        request by request, so a bad request fails only its own Future."""
        now = time.perf_counter()
        for item in batch:
            obs.observe("serve.fleet.queue_wait", now - item[4])
        for flavor in sorted({b[2] for b in batch}):
            group = [b for b in batch if b[2] == flavor]
            try:
                if len(group) > 1:
                    tid = np.concatenate([g[0] for g in group])
                    data = np.concatenate([g[1] for g in group], axis=0)
                else:
                    tid, data = group[0][0], group[0][1]
                out = self.predict(tid, data, raw_score=flavor,
                                   replica=rep.index)
            except Exception:   # noqa: BLE001 -- isolate the bad request
                obs.inc("serve.fleet.poisoned_batches")
                for g in group:
                    try:
                        res = self.predict(g[0], g[1], raw_score=flavor,
                                           replica=rep.index)
                    except Exception as e:   # noqa: BLE001 -- per future
                        if not g[3].done():
                            g[3].set_exception(e)
                    else:
                        if not g[3].done():
                            g[3].set_result(res)
                continue
            lo = 0
            for g in group:
                hi = lo + g[1].shape[0]
                if not g[3].done():
                    g[3].set_result(out[lo:hi])
                lo = hi
        done = time.perf_counter()
        for _, data, _, fut, t0, ctx in batch:
            if (fut.done() and not fut.cancelled()
                    and fut.exception() is None):
                obs.observe("serve.fleet.request_latency", done - t0)
                if ctx is not None:
                    # submit -> replica flush causal edge, parented under
                    # the submitter's active span
                    obs.span_event(
                        "serve.fleet.request", t0, done - t0,
                        cat="serve", rows=int(data.shape[0]),
                        replica=rep.index,
                        span_id=tracing.new_id(),
                        trace_id=ctx.trace_id,
                        **({"parent_id": ctx.span_id}
                           if ctx.span_id else {}))


class TenantHandle:
    """One tenant of a :class:`FleetServer` behind the solo
    ``PredictionServer`` surface (``swap``/``predict``/``warmup``/
    ``_model``), so the retrain pipeline can target a fleet tenant."""

    __slots__ = ("fleet_server", "tenant_id")

    def __init__(self, fleet_server: FleetServer, tenant_id: int):
        m = int(tenant_id)
        if not 0 <= m < fleet_server.num_tenants:
            raise LightGBMError(
                f"tenant_id {m} out of range "
                f"[0, {fleet_server.num_tenants})")
        self.fleet_server = fleet_server
        self.tenant_id = m

    @property
    def _model(self) -> Optional[ModelMeta]:
        return self.fleet_server._snapshot().metas[self.tenant_id]

    def swap(self, booster) -> bool:
        return self.fleet_server.swap_tenant(self.tenant_id, booster)

    def predict(self, data, raw_score: bool = False) -> np.ndarray:
        return self.fleet_server.predict(self.tenant_id, data,
                                         raw_score=raw_score)

    def warmup(self, row_buckets: Optional[Sequence[int]] = None
               ) -> List[int]:
        return self.fleet_server.warmup(row_buckets)

    def stop(self) -> None:
        """Nothing: the fleet's workers outlive any one tenant view."""
