"""Hot-swap prediction server over the packed-forest kernel.

Counterpart of ``lightgbm_tpu/serve/engine.py``.  The fork's serving shape
retrains a booster every window while every arriving request is scored
against the current model.  :class:`PredictionServer` owns that read side:

* ``swap(booster)`` replaces the packed ensemble atomically: packing and
  the upload to the card happen before the lock, so a ``predict`` in
  flight never sees a half-built model;
* ``predict(rows)`` runs the whole ensemble over the batch in one launch
  of ``csrc/forest_predict.cu``;
* micro-batching (``start()`` / ``submit(rows)``): small requests coalesce
  up to ``max_batch`` rows or ``max_wait_ms`` into one launch;
* ``warmup()`` builds the kernel's library and launches each of its two
  routes once (small batches spread a row's trees over a block, large
  ones walk a row a thread), so the first request pays neither; given
  row buckets (:func:`warmup_bucket_ladder`, ``default_warmup_buckets``)
  it also scores a batch of zeros at each.  The JAX package compiles one
  program per padded batch size and warms each; the kernel compiles
  nothing per shape and pads no rows;
* **graceful degradation** (``host_fallback``, on by default as in the
  JAX package): when the ``serve.dispatch`` injected fault fires (the
  chaos harness's simulated device death, ``robust/faults.py``), the
  batch is answered by the host ``Tree.predict`` walk over the same
  served tree slice (``packed.tree_slice``), a circuit breaker (3
  consecutive failures, re-probe every 2 s) trips so later requests skip
  the card, and a timed re-probe goes back to the kernel once it
  answers.

The degrade path never hides a card that does not work.  Only an
injected dispatch fault degrades: a real error from the kernel's launch
(a CUDA error, a kernel library that does not build or load, a fault in
the wrapper) is counted as ``serve.failed`` and raised to the caller,
whatever ``host_fallback`` says, and never touches the breaker.  Unlike
the JAX package, which answers any dispatch error from the host, the
port thus never serves a faulty card's requests from the CPU; a real
CUDA error is sticky in PyTorch (the context stays poisoned), so every
later request raises too and counts against availability.  The injected
degradation stays loud: every fallback answer is counted
(``serve.fallback_requests``), the trip is logged and sets the
``serve.degraded`` gauge, the dark time lands in ``serve.degraded_time``
and the SLO engine charges it against availability (``obs/slo.py``).  A
kernel library that does not build or load
(:class:`~lightgbm_tpu_torch.ops.build.KernelBuildError`) raises where
the server is built (on the card the library is loaded then) or warmed.

Telemetry (``serve.`` prefix): ``serve.predict`` / ``serve.queue_wait`` /
``serve.request_latency`` timings, the ``serve.batch_rows`` gauge,
``serve.swaps`` / ``serve.requests`` / ``serve.rows`` counters, the
request outcomes ``serve.ok`` / ``serve.fallback_requests`` /
``serve.failed`` / ``serve.input_errors`` (input errors never count
against the card or availability), ``serve.device_failures``,
``serve.poisoned_batches``, the ``serve.degraded`` gauge and the
``serve.degraded_time`` timing.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from queue import Empty, Queue
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..boosting.gbdt import GBDT, _convert_by_name, resolve_device
from ..obs import tracing
from ..robust import faults
from ..robust.retry import CircuitBreaker
from ..utils.log import LightGBMError, log_warning
from .packed import (PackedEnsemble, _kernel_lib, _pow2_at_least,
                     _sm_count, forest_geometry, launch_forest, pack_gbdt,
                     predict_scores, query_tensor, tree_slice)

__all__ = ["PredictionServer", "warmup_bucket_ladder", "row_bucket",
           "FALLBACK_COUNTS"]

#: requests the host walk answered in this process, by server kind
#: ("server": PredictionServer, "fleet": FleetServer), whether or not
#: telemetry is on: a run that must never degrade reads them
FALLBACK_COUNTS = {"server": 0, "fleet": 0}
_FALLBACK_LOCK = threading.Lock()


def count_fallback(kind: str) -> None:
    with _FALLBACK_LOCK:
        FALLBACK_COUNTS[kind] += 1


def row_bucket(n: int, lo: int = 128) -> int:
    """The power of two at least ``max(n, lo)`` (the JAX package's batch
    pad, ``lightgbm_tpu/serve/packed.py::row_bucket``)."""
    return _pow2_at_least(int(n), int(lo))


def warmup_bucket_ladder(min_rows: Optional[int] = None,
                         min_bucket: int = 128) -> List[int]:
    """The default warm-up batch sizes (``lightgbm_tpu/serve/engine.py::
    warmup_bucket_ladder``): 128, 1,024 and 8,192 rows and the bucket of
    ``device_predict_min_rows`` (``None``: the schema default), where
    ``Booster.predict`` moves to the card."""
    if min_rows is None:
        from ..params import PARAM_BY_NAME
        min_rows = int(PARAM_BY_NAME["device_predict_min_rows"].default)
    out = [128, 1024, 8192]
    if min_rows > 0:
        b = row_bucket(int(min_rows), min_bucket)
        if b not in out:
            out.append(b)
    return out


def require_kernel(device) -> None:
    """Build and load the forest kernel's library now when ``device`` is
    the card (a server is built there): a library that does not build
    raises :class:`KernelBuildError` here, never on a request, so it can
    never be answered from the host walk."""
    if device.type == "cuda":
        _kernel_lib()


def _as_gbdt(booster) -> GBDT:
    """Accept a ``basic.Booster``, a ``GBDT`` (trained or loaded) or a
    model-file path."""
    if isinstance(booster, str):
        return GBDT.load_model_from_file(booster)
    return getattr(booster, "_gbdt", booster)


class ModelMeta:
    """The booster-level facts of one served model that do not depend on
    where its packed tables live (a solo pack or one tenant row of a
    fleet): the output conversion ``Booster.predict`` applies, and for
    the degrade path the host ``Tree`` objects of the same served slice,
    so a failing card never drops a request."""

    __slots__ = ("objective", "objective_str", "average_output", "n_iters",
                 "host_trees", "num_model", "train_ctx")

    def __init__(self, gbdt, n_iters: int, host_trees=None,
                 num_model: int = 1):
        self.objective = gbdt.objective
        self.objective_str = gbdt.loaded_objective_str
        self.average_output = bool(gbdt.average_output)
        self.n_iters = int(n_iters)
        self.host_trees = host_trees
        self.num_model = max(int(num_model), 1)
        # the trace context of the swap (obs/tracing.py): a request this
        # generation answers links back to the window that trained it
        self.train_ctx = None

    def host_raw(self, data: np.ndarray) -> np.ndarray:
        """(K, rows) float64 raw scores by the host tree walk over this
        slice, trees interleaved iteration-major (``out[i % K]``) as the
        pack lays them out: the accumulation ``Booster.predict``'s host
        path does."""
        out = np.zeros((self.num_model, data.shape[0]), np.float64)
        for i, tree in enumerate(self.host_trees):
            out[i % self.num_model] += tree.predict(data)
        return out

    def convert(self, raw: np.ndarray, raw_score: bool) -> np.ndarray:
        """(K, R) raw scores -> what ``GBDT.predict`` returns."""
        if self.average_output:
            if self.n_iters > 0:
                raw = raw / self.n_iters
        elif not raw_score:
            if self.objective is not None:
                raw = self.objective.convert_output(raw)
            elif self.objective_str:
                raw = _convert_by_name(self.objective_str, raw)
        if raw.shape[0] == 1:
            return raw[0]
        return raw.T


def host_slice(gbdt, start_iteration: int, num_iteration: int):
    """The host trees of the slice ``pack_gbdt`` packs (the same clamping,
    ``packed.tree_slice``): the degrade path answers from exactly the
    served trees."""
    return list(tree_slice(gbdt.models, gbdt.num_model, start_iteration,
                           num_iteration))


class _Model(ModelMeta):
    """One immutable generation of the server's model: the pack and its
    :class:`ModelMeta`."""

    __slots__ = ("packed",)

    def __init__(self, packed: PackedEnsemble, gbdt, host_trees=None):
        super().__init__(gbdt, packed.num_iterations, host_trees,
                         packed.num_model)
        self.packed = packed


class PredictionServer:
    """Thread-safe hot-swap predictor over a :class:`PackedEnsemble` on
    ``device`` (``cuda`` by default, which raises without a card).

    ``booster`` may be a ``Booster``, a ``GBDT`` or a model-file path, or
    ``None`` for an empty server to ``swap()`` into later.
    ``num_iteration``/``start_iteration`` select the served tree slice on
    every swap; ``max_batch``/``max_wait_ms`` configure the micro-batching
    queue (``start()``/``submit()``); ``min_bucket`` and
    ``device_predict_min_rows`` (``None``: the swapped booster's) set the
    warm-up ladder (:meth:`default_warmup_buckets`).

    ``host_fallback`` (default on) keeps the served slice's host trees so
    a failing launch degrades to the host walk instead of failing the
    request; ``breaker`` replaces the default circuit breaker (3
    consecutive failures trip it, re-probe every 2 s)."""

    def __init__(self, booster=None, *, device="cuda",
                 num_iteration: int = -1, start_iteration: int = 0,
                 max_batch: int = 8192, max_wait_ms: float = 2.0,
                 min_bucket: int = 128,
                 device_predict_min_rows: Optional[int] = None,
                 host_fallback: bool = True,
                 breaker: Optional[CircuitBreaker] = None):
        self.device = resolve_device(str(device))
        require_kernel(self.device)
        self.host_fallback = bool(host_fallback)
        self._breaker = breaker if breaker is not None else \
            CircuitBreaker(failure_threshold=3, reprobe_interval_s=2.0)
        self.min_bucket = int(min_bucket)
        self.device_predict_min_rows = (
            None if device_predict_min_rows is None
            else int(device_predict_min_rows))
        self._lock = threading.Lock()
        self._model: Optional[_Model] = None
        self.num_iteration = int(num_iteration)
        self.start_iteration = int(start_iteration)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._queue: Queue = Queue()
        self._worker: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        if booster is not None:
            self.swap(booster)

    @property
    def degraded(self) -> bool:
        """True while the circuit breaker is open (the card's path dark,
        requests answered by the host walk)."""
        return self._breaker.state == "open"

    @property
    def dark_seconds(self) -> float:
        """Total breaker-open seconds, a still-open period included."""
        return self._breaker.dark_seconds()

    # -- model lifecycle ------------------------------------------------
    def swap(self, booster) -> bool:
        """Replace the served model atomically: packing and upload happen
        outside the lock, readers switch between complete generations.
        Returns whether the new pack's pads (``shape_signature``) equal
        the previous model's, as the JAX package's swap does (there the
        same pads reuse compiled programs; the kernel compiles nothing per
        shape)."""
        gbdt = _as_gbdt(booster)
        if self.device_predict_min_rows is None:
            rows = getattr(getattr(gbdt, "config", None),
                           "device_predict_min_rows", None)
            if rows is not None:
                self.device_predict_min_rows = int(rows)
        with obs.span("serve.swap", cat="serve"):
            packed = pack_gbdt(gbdt, self.start_iteration,
                               self.num_iteration, device=self.device)
            packed.records      # the kernel's node records, built here too
            host_trees = (host_slice(gbdt, self.start_iteration,
                                     self.num_iteration)
                          if self.host_fallback else None)
            model = _Model(packed, gbdt, host_trees)
            model.train_ctx = tracing.capture()
            with self._lock:
                prev = self._model
                self._model = model
        same_shape = (prev is not None and prev.packed.shape_signature()
                      == packed.shape_signature())
        obs.inc("serve.swaps")
        if prev is not None and not same_shape:
            obs.inc("serve.swap_shape_changes")
        return same_shape

    @property
    def packed(self) -> PackedEnsemble:
        """The current model's pack."""
        return self._snapshot().packed

    def _snapshot(self) -> _Model:
        with self._lock:
            model = self._model
        if model is None:
            raise LightGBMError("PredictionServer has no model; call "
                                "swap(booster) first")
        return model

    def default_warmup_buckets(self) -> List[int]:
        """:func:`warmup_bucket_ladder` at this server's
        ``device_predict_min_rows`` and ``min_bucket``."""
        return warmup_bucket_ladder(self.device_predict_min_rows,
                                    self.min_bucket)

    def warmup(self, row_buckets: Optional[Sequence[int]] = None
               ) -> List[int]:
        """Build the kernel's library and launch each route once, forced,
        on a row of zeros against the current model (on the CPU: one
        call); then score a batch of zeros at each of ``row_buckets``
        (rounded up to powers of two of at least ``min_bucket``).  Returns
        the buckets scored."""
        model = self._snapshot()
        pe = model.packed
        x = np.zeros((1, pe.num_features))
        if pe.device.type != "cuda" or pe.num_trees == 0:
            predict_scores(pe, x)
        else:
            xq = query_tensor(x, pe.num_features, pe.device)
            _, t, n = pe.tables().split_feature.shape
            for route in ("rows", "trees"):
                geo = forest_geometry(1, t, n, pe.num_features, True, False,
                                      pe.num_model, sm_count=_sm_count(
                                          pe.device.index), route=route)
                launch_forest(pe.records, xq, None, geo,
                              num_model=pe.num_model,
                              max_depth=pe.max_depth)
        done: List[int] = []
        for rows in row_buckets or ():
            b = row_bucket(int(rows), self.min_bucket)
            if b in done:
                continue
            with obs.span("serve.warmup", cat="serve", rows=b):
                predict_scores(pe, np.zeros((b, pe.num_features)))
            done.append(b)
        return done

    # -- direct prediction ----------------------------------------------
    def _score_batch(self, model: _Model, data: np.ndarray) -> np.ndarray:
        """(K, rows) raw scores with graceful degradation: the kernel when
        the breaker allows it, the host walk when the injected dispatch
        fault fires or the breaker is open.  Input errors (too few
        features) raise at once and never count against the card; a real
        launch error (a CUDA error, a kernel that does not build) raises
        and never degrades."""
        if data.shape[1] < model.packed.num_features:
            obs.inc("serve.input_errors")
            raise LightGBMError(
                f"query data has {data.shape[1]} features but the served "
                f"model needs {model.packed.num_features}")
        err: Optional[BaseException] = None
        if self._breaker.allow():
            try:
                faults.check("serve.dispatch")
                raw = predict_scores(model.packed, data)
            except faults.InjectedFault as e:
                err = e
            except Exception:
                # a real launch error is the card's or the code's: raised,
                # never answered from the host
                obs.inc("serve.failed")
                raise
            else:
                dark = self._breaker.record_success()
                if dark is not None:
                    obs.observe("serve.degraded_time", dark)
                    log_warning(f"serve: device path recovered after "
                                f"{dark:.3f} s degraded")
                # on every success, not only at recovery: the rolling gauge
                # integrates from its first transition, so the healthy
                # prefix must be on record (a same-value write is free)
                obs.set_gauge("serve.degraded", 0)
                obs.inc("serve.ok")
                return raw
        if not self.host_fallback or model.host_trees is None:
            # the request goes unanswered: the availability SLO's hard
            # failures
            obs.inc("serve.failed")
            if err is not None:
                raise err
            raise LightGBMError("serve: device path unavailable (circuit "
                                "open) and host fallback is disabled")
        out = model.host_raw(data)
        if err is not None:
            # the host walk answered the injected device failure
            obs.inc("serve.device_failures")
            if self._breaker.record_failure():
                obs.set_gauge("serve.degraded", 1)
                log_warning(f"serve: device dispatch failing ({err!r}); "
                            f"circuit open, serving the host walk, "
                            f"re-probing every "
                            f"{self._breaker.reprobe_interval_s:g} s")
        obs.inc("serve.fallback_requests")
        count_fallback("server")
        return out

    def predict(self, data, raw_score: bool = False) -> np.ndarray:
        """Score a raw feature matrix against the current model in one
        kernel launch (the host walk under a failing card, see
        :meth:`_score_batch`).  Output matches ``Booster.predict``:
        (rows,) for one model per iteration, (rows, num_model) for
        multiclass."""
        data = np.atleast_2d(np.asarray(data))
        model = self._snapshot()
        with obs.span("serve.predict", cat="serve",
                      rows=int(data.shape[0])) as sp:
            ctx = model.train_ctx
            if ctx is not None:
                sp.set(model_trace_id=ctx.trace_id,
                       model_span_id=ctx.span_id)
            obs.set_gauge("serve.batch_rows", int(data.shape[0]))
            out = model.convert(self._score_batch(model, data), raw_score)
        obs.inc("serve.requests")
        obs.inc("serve.rows", int(data.shape[0]))
        return out

    # -- micro-batching queue -------------------------------------------
    def start(self) -> "PredictionServer":
        """Start the micro-batching worker thread (idempotent)."""
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return self
            self._stopping.clear()
            self._worker = threading.Thread(
                target=self._drain_loop, name="lgbm-serve", daemon=True)
            self._worker.start()
        return self

    def stop(self) -> None:
        """Stop the worker; queued requests are answered first."""
        with self._lock:
            worker = self._worker
            self._worker = None
            # set inside the lock: submit() holds it across its liveness
            # check and enqueue, so a request accepted concurrently with
            # stop() still lands in a queue the worker drains
            self._stopping.set()
        if worker is not None:
            worker.join(timeout=10.0)

    def __enter__(self) -> "PredictionServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def submit(self, data, raw_score: bool = False) -> Future:
        """Enqueue rows for micro-batched prediction; resolves to what
        ``predict`` returns for those rows."""
        fut: Future = Future()
        data = np.atleast_2d(np.asarray(data))
        with self._lock:
            if (self._stopping.is_set() or self._worker is None
                    or not self._worker.is_alive()):
                raise LightGBMError("micro-batching worker not running; "
                                    "call start() (or use predict())")
            # the submitter's trace context rides the queue item (None
            # while tracing is off): the worker emits a serve.request span
            # parented under the submit site
            self._queue.put((data, bool(raw_score), fut,
                             time.perf_counter(), tracing.capture()))
        return fut

    def _drain_loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except Empty:
                if self._stopping.is_set():
                    return
                continue
            batch = [first]
            rows = first[0].shape[0]
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            while rows < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except Empty:
                    break
                batch.append(item)
                rows += item[0].shape[0]
            self._run_batch(batch)

    def _run_batch(self, batch: List[Tuple]) -> None:
        """One launch per raw_score flavour in the batch; a batch that
        fails is retried request by request, so one bad request fails only
        its own Future."""
        now = time.perf_counter()
        for item in batch:
            obs.observe("serve.queue_wait", now - item[3])
        for flavor in sorted({b[1] for b in batch}):
            group = [b for b in batch if b[1] == flavor]
            try:
                data = np.concatenate([g[0] for g in group], axis=0) \
                    if len(group) > 1 else group[0][0]
                out = self.predict(data, raw_score=flavor)
            except Exception:   # noqa: BLE001 -- isolate the bad request
                obs.inc("serve.poisoned_batches")
                for g in group:
                    fut = g[2]
                    try:
                        res = self.predict(g[0], raw_score=flavor)
                    except Exception as e:   # noqa: BLE001 -- per future
                        if not fut.done():
                            fut.set_exception(e)
                    else:
                        if not fut.done():
                            fut.set_result(res)
                continue
            lo = 0
            for g in group:
                hi = lo + g[0].shape[0]
                # a caller may have cancelled its Future
                if not g[2].done():
                    g[2].set_result(out[lo:hi])
                lo = hi
        done = time.perf_counter()
        for data, _, fut, t0, ctx in batch:
            if (fut.done() and not fut.cancelled()
                    and fut.exception() is None):
                obs.observe("serve.request_latency", done - t0)
                if ctx is not None:
                    # submit -> flush causal edge: one span a request from
                    # submit time to its future's resolution, parented
                    # under the submitter's active span
                    obs.span_event(
                        "serve.request", t0, done - t0, cat="serve",
                        rows=int(data.shape[0]),
                        span_id=tracing.new_id(),
                        trace_id=ctx.trace_id,
                        **({"parent_id": ctx.span_id}
                           if ctx.span_id else {}))
