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
  ones walk a row a thread), so the first request pays neither.  The JAX
  package compiles one program per padded batch size and warms each; the
  kernel compiles nothing per shape and pads no rows.

Not ported yet (they come with ``robust/`` and ``obs/``): the degrade-to-
host path (circuit breaker, host-walk fallback, injected faults) and the
telemetry.  A failure on the card raises to the caller.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from queue import Empty, Queue
from typing import List, Optional, Tuple

import numpy as np

from ..boosting.gbdt import GBDT, _convert_by_name, resolve_device
from ..utils.log import LightGBMError
from .packed import (PackedEnsemble, _sm_count, forest_geometry,
                     launch_forest, pack_gbdt, predict_scores, query_tensor)

__all__ = ["PredictionServer"]


def _as_gbdt(booster) -> GBDT:
    """Accept a ``basic.Booster``, a ``GBDT`` (trained or loaded) or a
    model-file path."""
    if isinstance(booster, str):
        return GBDT.load_model_from_file(booster)
    return getattr(booster, "_gbdt", booster)


class ModelMeta:
    """The booster-level facts of one served model that do not depend on
    where its packed tables live: the output conversion ``Booster.predict``
    applies."""

    __slots__ = ("objective", "objective_str", "average_output", "n_iters")

    def __init__(self, gbdt, n_iters: int):
        self.objective = gbdt.objective
        self.objective_str = gbdt.loaded_objective_str
        self.average_output = bool(gbdt.average_output)
        self.n_iters = int(n_iters)

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


class _Model(ModelMeta):
    """One immutable generation of the server's model: the pack and its
    :class:`ModelMeta`."""

    __slots__ = ("packed",)

    def __init__(self, packed: PackedEnsemble, gbdt):
        super().__init__(gbdt, packed.num_iterations)
        self.packed = packed


class PredictionServer:
    """Thread-safe hot-swap predictor over a :class:`PackedEnsemble` on
    ``device`` (``cuda`` by default, which raises without a card).

    ``booster`` may be a ``Booster``, a ``GBDT`` or a model-file path, or
    ``None`` for an empty server to ``swap()`` into later.
    ``num_iteration``/``start_iteration`` select the served tree slice on
    every swap; ``max_batch``/``max_wait_ms`` configure the micro-batching
    queue (``start()``/``submit()``)."""

    def __init__(self, booster=None, *, device="cuda",
                 num_iteration: int = -1, start_iteration: int = 0,
                 max_batch: int = 8192, max_wait_ms: float = 2.0):
        self.device = resolve_device(str(device))
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

    # -- model lifecycle ------------------------------------------------
    def swap(self, booster) -> None:
        """Replace the served model atomically: packing and upload happen
        outside the lock, readers switch between complete generations."""
        gbdt = _as_gbdt(booster)
        packed = pack_gbdt(gbdt, self.start_iteration, self.num_iteration,
                           device=self.device)
        packed.records          # the kernel's node records, built here too
        model = _Model(packed, gbdt)
        with self._lock:
            self._model = model

    def _snapshot(self) -> _Model:
        with self._lock:
            model = self._model
        if model is None:
            raise LightGBMError("PredictionServer has no model; call "
                                "swap(booster) first")
        return model

    def warmup(self) -> None:
        """Build the kernel's library and launch each route once, forced,
        on a row of zeros against the current model (on the CPU: one
        call)."""
        model = self._snapshot()
        pe = model.packed
        x = np.zeros((1, pe.num_features))
        if pe.device.type != "cuda" or pe.num_trees == 0:
            predict_scores(pe, x)
            return
        x = query_tensor(x, pe.num_features, pe.device)
        _, t, n = pe.tables().split_feature.shape
        for route in ("rows", "trees"):
            geo = forest_geometry(1, t, n, pe.num_features, True, False,
                                  pe.num_model, sm_count=_sm_count(
                                      pe.device.index), route=route)
            launch_forest(pe.records, x, None, geo, num_model=pe.num_model,
                          max_depth=pe.max_depth)

    # -- direct prediction ----------------------------------------------
    def predict(self, data, raw_score: bool = False) -> np.ndarray:
        """Score a raw feature matrix against the current model in one
        kernel launch.  Output matches ``Booster.predict``: (rows,) for
        one model per iteration, (rows, num_model) for multiclass."""
        data = np.atleast_2d(np.asarray(data))
        model = self._snapshot()
        if data.shape[1] < model.packed.num_features:
            raise LightGBMError(
                f"query data has {data.shape[1]} features but the served "
                f"model needs {model.packed.num_features}")
        return model.convert(predict_scores(model.packed, data), raw_score)

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
            self._queue.put((data, bool(raw_score), fut))
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
        for flavor in sorted({rs for _, rs, _ in batch}):
            group = [b for b in batch if b[1] == flavor]
            try:
                data = np.concatenate([g[0] for g in group], axis=0) \
                    if len(group) > 1 else group[0][0]
                out = self.predict(data, raw_score=flavor)
            except Exception:   # noqa: BLE001 -- isolate the bad request
                for data, _, fut in group:
                    try:
                        res = self.predict(data, raw_score=flavor)
                    except Exception as e:   # noqa: BLE001 -- per future
                        if not fut.done():
                            fut.set_exception(e)
                    else:
                        if not fut.done():
                            fut.set_result(res)
                continue
            lo = 0
            for data, _, fut in group:
                hi = lo + data.shape[0]
                # a caller may have cancelled its Future
                if not fut.done():
                    fut.set_result(out[lo:hi])
                lo = hi
