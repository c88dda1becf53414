"""Async windowed-retrain pipeline: prep || train || serve.

Counterpart of ``lightgbm_tpu/pipeline/core.py``.  The fork exists to
retrain a cache-admission model every sliding trace window (PAPER.md,
``src/test.cpp``): label, featurize, bin, train, predict — and the
reference runs those phases strictly serially.  This module overlaps them:

* **host prep** (labeling, featurization, CSR/dense -> binned on the host
  via the :class:`~lightgbm_tpu_torch.pipeline.bins.BinMapperCache`) for
  window N+1 runs on ONE background thread, double-buffered (a bounded
  queue of depth 1) against
* **training** of window N on the main thread, on the card: a fresh
  ``GBDT`` whose grower captures its CUDA graphs (counted per window by
  ``obs/capture_track.py``) and trains fused chunks, while
* **serving** answers continuously from a
  :class:`~lightgbm_tpu_torch.serve.engine.PredictionServer`
  (``csrc/forest_predict.cu``): the freshly trained model lands via an
  atomic ``swap()``, and the window is scored against the PREVIOUS model
  before training — the reference's evaluateModel-then-trainModel order.

Window policies (``window_policy``, selectable per window by passing a
callable): ``fresh`` retrains from scratch (byte-identical to a serial
loop); ``refit`` keeps the previous ensemble's routing and re-fits leaf
values against the new labels with ``refit_decay_rate``; ``warm`` refits,
then continues boosting ``pipeline_warm_iterations`` new trees from the
refit scores.  Both warm-start policies assign rows to leaves with the
binned traversal on the training device (``ops/traverse.py``) — exact
because the mappers are the SAME objects across windows.

The prep thread runs numpy only (the user's ``prep_fn`` and host
binning), so it does not contend with the main thread's torch ops for
torch's CPU threads.

Telemetry (``pipeline.*``): per-window ``pipeline.prep`` /
``pipeline.train`` / ``pipeline.eval`` / ``pipeline.stall`` /
``pipeline.refit`` / ``pipeline.swap`` timings, the cumulative
``pipeline.overlap_fraction`` gauge (overlapped prep seconds over total
prep seconds, steady-state windows), the ``pipeline.drift`` gauge, and
``pipeline.windows`` / ``pipeline.rebinds`` counters.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from .. import obs
from ..boosting import create_boosting
from ..boosting.gbdt import GBDT, scores_from_leaves
from ..config import Config, normalize_params
from ..obs import capture_track, tracing
from ..robust import checkpoint as _checkpoint
from ..robust import faults
from ..utils.log import LightGBMError, log_info, log_warning
from .bins import BinMapperCache

POLICIES = ("fresh", "refit", "warm")


class PipelineError(LightGBMError):
    """A prep-stage failure, re-raised on the caller's thread.  Serving
    is NOT torn down: the server keeps answering from the last good
    model.  ``window`` is the failing window index; ``results`` holds
    the windows completed before the failure."""

    def __init__(self, window: int, results: List["WindowResult"],
                 cause: BaseException):
        super().__init__(f"pipeline prep failed at window {window}: "
                         f"{cause!r}")
        self.window = window
        self.results = results
        self.__cause__ = cause


@dataclass
class PreppedWindow:
    """Everything host prep produces for one window.  Training features
    are either ``dense`` (rows, features) or ``csr``
    ``(indptr, indices, values, num_col)``; ``eval_*`` optionally carry
    the rows the PREVIOUS model should be scored on before this
    window's retrain (the reference's evaluateModel)."""

    label: np.ndarray
    dense: Optional[np.ndarray] = None
    csr: Optional[Tuple] = None
    eval_label: Optional[np.ndarray] = None
    eval_dense: Optional[np.ndarray] = None
    eval_csr: Optional[Tuple] = None
    meta: dict = field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        if self.dense is not None:
            return int(np.asarray(self.dense).shape[0])
        return len(self.csr[0]) - 1

    def has_eval(self) -> bool:
        return self.eval_dense is not None or self.eval_csr is not None


@dataclass
class WindowResult:
    window: int
    policy: str
    rebinned: bool
    drift: Optional[float]
    rows: int
    num_trees: int
    prep_s: float
    stall_s: float
    train_s: float
    eval_s: float
    swap_s: float
    swap_same_shape: Optional[bool]
    train_span: Tuple[float, float]
    eval_metrics: Optional[dict]
    meta: dict
    booster: Optional[GBDT]
    captures: int = 0
    capture_s: float = 0.0

    def to_json(self) -> dict:
        """Per-window JSON line (booster and eval arrays omitted)."""
        out = {
            "window": self.window, "policy": self.policy,
            "rebinned": self.rebinned,
            "drift": None if self.drift is None else round(self.drift, 5),
            "rows_trained": self.rows, "num_trees": self.num_trees,
            "prep_s": round(self.prep_s, 3),
            "stall_s": round(self.stall_s, 3),
            "train_s": round(self.train_s, 3),
            "eval_s": round(self.eval_s, 3),
            "swap_s": round(self.swap_s, 4),
            "swap_same_shape": self.swap_same_shape,
            "captures": self.captures,
            "capture_s": round(self.capture_s, 4),
        }
        if self.eval_metrics:
            out.update(self.eval_metrics)
        out.update(self.meta)
        return out


def densify_csr_rows(csr: Tuple, lo: int, hi: int) -> np.ndarray:
    """Dense (hi-lo, num_col) float64 block of CSR rows [lo, hi)."""
    indptr, indices, values, num_col = csr
    out = np.zeros((hi - lo, int(num_col)), np.float64)
    p0, p1 = int(indptr[lo]), int(indptr[hi])
    rows = np.repeat(np.arange(lo, hi),
                     np.diff(np.asarray(indptr[lo:hi + 1])))
    out[rows - lo, np.asarray(indices[p0:p1])] = values[p0:p1]
    return out


class RetrainPipeline:
    """The windowed-retrain orchestrator (see module docstring).

    ``params`` is a dict / ``key=value`` string / :class:`Config` with
    the training configuration; pipeline knobs default from it
    (``window_policy``, ``pipeline_rebin``,
    ``pipeline_drift_threshold``, ``pipeline_warm_iterations``,
    ``refit_decay_rate``, ``num_iterations``, ``fused_chunk``,
    ``pipeline_checkpoint_dir``) and can be overridden by keyword.
    ``window_policy`` may be a callable ``(window_index) -> str`` for
    per-window selection.  Training and the server run on
    ``device_type`` (default ``cuda``, which raises without a card).
    ``captures``/``capture_s`` of a window count its CUDA-graph captures
    while telemetry is on (``metrics_enabled``).
    """

    def __init__(self, params=None, *,
                 num_iterations: Optional[int] = None,
                 chunk: Optional[int] = None,
                 window_policy=None,
                 refit_decay_rate: Optional[float] = None,
                 warm_iterations: Optional[int] = None,
                 rebin_on_drift: Optional[bool] = None,
                 drift_threshold: Optional[float] = None,
                 categorical: Sequence[int] = (),
                 pipelined: bool = True,
                 serve: bool = True,
                 server=None,
                 tenant_id: Optional[int] = None,
                 eval_chunk_rows: int = 65536,
                 warmup_rows="auto",
                 keep_boosters: bool = True,
                 checkpoint_dir: Optional[str] = None):
        if isinstance(params, Config):
            cfg = params
        elif isinstance(params, str):
            # the C API's space-separated key=value string, or config
            # file lines
            kv = dict(tok.split("=", 1) for tok in params.split()
                      if "=" in tok)
            cfg = Config(normalize_params(
                {k.strip(): v.strip() for k, v in kv.items()}))
        else:
            cfg = Config(params or {})
        self.config = cfg
        self.num_iterations = int(num_iterations
                                  if num_iterations is not None
                                  else cfg.num_iterations)
        self.chunk = int(chunk if chunk is not None
                         else max(int(getattr(cfg, "fused_chunk", 20)), 1))
        policy = (window_policy if window_policy is not None
                  else getattr(cfg, "window_policy", "fresh"))
        if not callable(policy):
            if str(policy) not in POLICIES:
                raise LightGBMError(f"unknown window_policy {policy!r}; "
                                    f"expected one of {POLICIES}")
            policy = str(policy)
        self.window_policy = policy
        self.refit_decay_rate = float(
            refit_decay_rate if refit_decay_rate is not None
            else getattr(cfg, "refit_decay_rate", 0.9))
        warm = (warm_iterations if warm_iterations is not None
                else int(getattr(cfg, "pipeline_warm_iterations", 0)))
        self.warm_iterations = int(warm) if warm else self.num_iterations
        self.bins = BinMapperCache(
            drift_threshold=float(
                drift_threshold if drift_threshold is not None
                else getattr(cfg, "pipeline_drift_threshold", 0.1)),
            rebin_on_drift=bool(
                rebin_on_drift if rebin_on_drift is not None
                else getattr(cfg, "pipeline_rebin", True)))
        self.categorical = tuple(int(c) for c in categorical)
        self.pipelined = bool(pipelined)
        self.eval_chunk_rows = int(eval_chunk_rows)
        self.server = server
        if serve and self.server is None:
            from ..serve.engine import PredictionServer
            self.server = PredictionServer(device=cfg.device_type)
        if tenant_id is not None:
            # the pipeline retrains ONE tenant of a FleetServer: every swap
            # and evaluation lands on that tenant while the others keep
            # serving
            if self.server is None:
                raise LightGBMError(
                    "tenant_id= needs a serving target; pass server= (a "
                    "FleetServer) and keep serve=True")
            if not hasattr(self.server, "tenant"):
                raise LightGBMError(
                    "tenant_id= needs a multi-tenant server (a FleetServer "
                    "or anything exposing .tenant())")
            self.server = self.server.tenant(int(tenant_id))
        # the server's warm-up at this pipeline's first swap: "auto" builds
        # the kernel's library and launches both routes, a list of row
        # counts also scores those buckets, an empty list skips it
        self.warmup_rows = warmup_rows
        # False = drop each WindowResult's booster reference after
        # on_window fires (long service loops would otherwise pin every
        # window's device scores + binned matrix for the life of run();
        # only the last model — final_booster() — and the served packed
        # copy are needed at steady state); the previous window's booster
        # also hands its grower back before the next window trains
        self.keep_boosters = bool(keep_boosters)
        # fault tolerance (docs/Robustness.md): after every completed
        # window the model + bin mappers + a manifest land atomically in
        # checkpoint_dir; resume(dir) continues at the next window
        self.checkpoint_dir = str(
            checkpoint_dir if checkpoint_dir is not None
            else getattr(cfg, "pipeline_checkpoint_dir", "") or "") or None
        self._start_window = 0
        # causal chain id for this pipeline's windows (obs/tracing.py):
        # minted lazily at the first traced run(), restored from the
        # checkpoint manifest on resume() so a resumed window keeps the
        # originating trace
        self._trace_id: Optional[str] = None
        self._prev: Optional[GBDT] = None
        #: the last refit's per-tree leaf ids (the refit/warm policies)
        self.last_leaf_ids: Optional[list] = None
        self._warmed = False
        self._policy_fallback_logged = False
        self._prep_thread: Optional[threading.Thread] = None
        self._prep_queue: Optional[queue.Queue] = None
        # overlap accounting (steady-state windows only)
        self._prep_total_s = 0.0
        self._overlap_s = 0.0

    # -- checkpoint / resume ------------------------------------------
    @classmethod
    def resume(cls, checkpoint_dir: str, params=None, **kwargs
               ) -> "RetrainPipeline":
        """Rebuild a pipeline from a checkpoint directory: the last
        completed window's model becomes ``_prev`` (so serving and the
        warm-start policies continue from it), the bin-mapper cache is
        restored (so later windows stay shape-stable against the SAME
        reference mappers), and ``run()`` skips every window the
        checkpoint already covers — under a deterministic config
        (``pipeline_rebin=false``, ``window_policy=fresh``) the resumed
        run's final model is byte-identical to an uninterrupted one."""
        cp = _checkpoint.load_pipeline_checkpoint(checkpoint_dir)
        if cp is None:
            raise LightGBMError(
                f"no pipeline checkpoint manifest in {checkpoint_dir}")
        kwargs.setdefault("checkpoint_dir", checkpoint_dir)
        pipe = cls(params, **kwargs)
        if cp.bins_path:
            loaded = BinMapperCache.load(
                cp.bins_path, rebin_on_drift=pipe.bins.rebin_on_drift)
            loaded.drift_threshold = pipe.bins.drift_threshold
            pipe.bins = loaded
        # checkpoint -> resume propagation: the resumed windows join the
        # originating run's causal chain instead of minting a new one
        pipe._trace_id = cp.trace_id
        model_str = cp.model_string()
        if model_str:
            pipe._prev = GBDT.load_model_from_string(
                model_str, pipe.config.clone())
            if pipe.server is not None:
                # serving restarts WITH the last good model: the first
                # resumed window is test-then-train scored against it,
                # exactly as if the process had never died
                pipe._swap(pipe._prev)
        pipe._start_window = cp.window + 1
        log_info(f"Resuming pipeline at window {pipe._start_window} "
                 f"(checkpoint {checkpoint_dir})")
        return pipe

    def _save_checkpoint(self, idx: int, bst: GBDT, policy: str,
                         rows: int) -> None:
        t0 = time.perf_counter()
        _checkpoint.save_pipeline_checkpoint(
            self.checkpoint_dir, window=idx,
            model_str=bst.model_to_string(),
            bins=self.bins,
            meta={"policy": policy, "rows": int(rows),
                  "num_trees": len(bst.models),
                  "num_iterations": self.num_iterations,
                  "trace_id": self._trace_id})
        obs.observe("pipeline.checkpoint", time.perf_counter() - t0)
        obs.inc("pipeline.checkpoints")

    # -- prep stage ---------------------------------------------------
    def _prep_window(self, payload, idx: int, prep_fn):
        t0 = time.perf_counter()
        with obs.span("pipeline.prep_window", cat="pipeline", window=idx):
            faults.check("pipeline.prep")
            pw = prep_fn(payload)
            if not isinstance(pw, PreppedWindow):
                raise LightGBMError(
                    "prep_fn must return a PreppedWindow")
            ds, info = self.bins.dataset_for(
                self.config, dense=pw.dense, csr=pw.csr,
                categorical=self.categorical, label=pw.label)
            # captured INSIDE the span: the prep_window span becomes the
            # parent of everything the main thread does with this
            # window (train -> swap -> the serve requests its model
            # answers); None while tracing is off
            prep_ctx = tracing.capture()
        prep_s = time.perf_counter() - t0
        obs.observe("pipeline.prep", prep_s)
        return pw, ds, info, prep_s, prep_ctx

    def _window_stream(self, payloads, prep_fn, stop: threading.Event,
                       root_ctx=None):
        """Yield ``("window", idx, pw, ds, info, prep_s, prep_ctx)``
        items, then ``("done",)`` — from a background thread when
        pipelined (queue depth 1 = double buffering), inline otherwise.
        Prep failures travel as ``("error", idx, exc)``.  ``root_ctx``
        is the pipeline's trace root, activated on the prep thread
        (threads start with an empty contextvars context)."""
        start = self._start_window
        if not self.pipelined:
            def inline():
                idx = -1
                try:
                    for idx, payload in enumerate(payloads):
                        if idx < start:    # resumed: already completed
                            continue
                        yield ("window", idx) + self._prep_window(
                            payload, idx, prep_fn)
                except Exception as e:   # noqa: BLE001 — surfaced below
                    yield ("error", idx, e)
                    return
                yield ("done",)
            return inline()

        q: "queue.Queue" = queue.Queue(maxsize=1)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            idx = -1
            tracing.set_current(root_ctx)   # thread-local; dies with us
            try:
                for idx, payload in enumerate(payloads):
                    if stop.is_set():
                        return
                    if idx < start:        # resumed: already completed
                        continue
                    item = ("window", idx) + self._prep_window(
                        payload, idx, prep_fn)
                    if not put(item):
                        return
            except Exception as e:   # noqa: BLE001 — surfaced on main
                put(("error", idx, e))
                return
            put(("done",))

        t = threading.Thread(target=worker, name="lgbm-pipeline-prep",
                             daemon=True)
        t.start()
        self._prep_thread = t
        self._prep_queue = q

        def drain():
            # timed get + liveness check: a prep thread killed without
            # running its except/put (interpreter teardown, os._exit in
            # a prep_fn) must surface as an error on the training
            # thread, not hang the window loop forever
            while True:
                try:
                    yield q.get(timeout=0.5)
                    continue
                except queue.Empty:
                    pass
                if t.is_alive():
                    continue
                try:
                    # the worker may have delivered its final item
                    # between the timeout and the death check
                    yield q.get_nowait()
                except queue.Empty:
                    raise LightGBMError(
                        "pipeline prep thread died without delivering "
                        "a result") from None

        return drain()

    # -- policies -----------------------------------------------------
    def _policy_for(self, idx: int, rebinned: bool) -> str:
        pol = (self.window_policy(idx) if callable(self.window_policy)
               else self.window_policy)
        if pol not in POLICIES:
            raise LightGBMError(f"unknown window_policy {pol!r}")
        if pol == "fresh":
            return pol
        fallback = None
        if self._prev is None:
            fallback = "no previous model"
        elif rebinned:
            fallback = "window was re-binned (leaf assignment needs the "
            fallback += "previous mappers)"
        elif type(self._prev) is not GBDT:
            fallback = "previous booster is not plain gbdt"
        if fallback is not None:
            if not self._policy_fallback_logged:
                log_warning(f"window_policy={pol}: falling back to "
                            f"fresh ({fallback})")
                self._policy_fallback_logged = True
            return "fresh"
        return pol

    # -- training -----------------------------------------------------
    def _train_fresh(self, ds) -> GBDT:
        bst = create_boosting(self.config)
        bst.init_train(ds)
        bst.train_chunked(self.num_iterations,
                          chunk=min(self.chunk, self.num_iterations))
        return bst

    def _leaf_assignments(self, trees, ds, bst):
        """Per-tree (N,) leaf ids of ``ds``'s rows by the binned traversal
        on the training device, over the booster's ``(G, N)`` training
        codes (the device grower's or the host learner's) — exact,
        because the mappers are shared objects across windows
        (BinMapperCache).  One copy back to the host for all trees; a
        stump's entry is None."""
        from ..ops.traverse import device_tree, traverse
        binned = bst._train_codes_t()
        ids = [traverse(binned, device_tree(tree, ds, self.config.num_leaves,
                                            bst.device),
                        groups_major=True)
               if tree.num_leaves > 1 else None for tree in trees]
        grown = [t for t in ids if t is not None]
        host = iter(torch.stack(grown).cpu().numpy() if grown else ())
        return [None if t is None else next(host) for t in ids]

    def _train_warm_start(self, ds, policy: str) -> GBDT:
        """``refit``/``warm``: adopt DEEP COPIES of the previous
        ensemble's trees (its pending records flushed first), refit their
        leaf values against this window's labels with decay, and
        (``warm``) continue boosting new trees from the refit scores,
        copied into the booster's score buffer on the card in place (a
        captured tree reads it by address)."""
        prev = self._prev
        prev._flush_pending()
        bst = create_boosting(self.config)
        bst.init_train(ds)
        trees = [copy.deepcopy(t) for t in prev.models]
        bst.models = trees
        bst.iter = len(trees) // max(bst.num_model, 1)
        with obs.span("pipeline.refit", cat="pipeline",
                      trees=len(trees)) as sp:
            leaf_ids = self._leaf_assignments(trees, ds, bst)
            label = np.asarray(ds.metadata.label, np.float64)
            # the ONE refit implementation (GBDT.refit_leaves): with
            # precomputed leaf assignments it rebuilds raw scores from
            # leaf values and never touches raw features
            bst.refit_leaves(None, label,
                             decay_rate=self.refit_decay_rate,
                             leaf_ids=leaf_ids)
            sp.set(rows=len(label))
        self.last_leaf_ids = leaf_ids
        if policy == "warm":
            # training scores of the REFIT model on this window (f64
            # host accumulation, cast once — continued boosting corrects
            # any representation difference on the next gradient step)
            score = scores_from_leaves(trees, leaf_ids, bst.num_model,
                                       ds.num_data)
            bst.train_score.copy_(torch.from_numpy(score.astype(np.float32)))
            bst.train_chunked(self.warm_iterations,
                              chunk=min(self.chunk, self.warm_iterations))
        return bst

    def _train_window(self, ds, policy: str) -> GBDT:
        faults.check("pipeline.train")
        if not self.keep_boosters and self._prev is not None:
            # nothing trains the previous window's booster again (its
            # trees were flushed when it finished; the warm policies read
            # only them): its grower goes back to the cache, idle, for this
            # window's booster to adopt, instead of a second grower built
            # and captured while the first sits pinned by _prev
            self._prev.release_grower()
        if policy == "fresh":
            bst = self._train_fresh(ds)
        else:
            bst = self._train_warm_start(ds, policy)
        bst._flush_pending()
        obs.inc(f"pipeline.policy_{policy}")
        self._prev = bst
        return bst

    def _emit_feature_telemetry(self, bst, idx: int, policy: str) -> None:
        """Per-window split-gain/importance event: the trained window's
        top feature gains as one instant event next to the
        ``pipeline.drift`` bin-occupancy gauge, so feature drift across
        retrain windows shows in the same trace."""
        if not obs.enabled():
            return
        try:
            gain = np.asarray(bst.feature_importance("gain"), np.float64)
            splits = np.asarray(bst.feature_importance("split"),
                                np.float64)
        except Exception:   # noqa: BLE001 — non-gbdt boosters
            return
        total = float(gain.sum())
        order = np.argsort(gain)[::-1][:16]
        top = [[int(f), round(float(gain[f]), 5), int(splits[f])]
               for f in order if gain[f] > 0.0]
        obs.instant("pipeline.window_features", cat="pipeline",
                    window=idx, policy=policy, features=int(gain.size),
                    total_gain=round(total, 5), top=top)
        obs.inc("pipeline.feature_events")
        if total > 0.0 and top:
            # share of total gain held by the strongest feature: a
            # cheap scalar drift indicator next to pipeline.drift
            obs.set_gauge("pipeline.gain_top_share",
                          round(top[0][1] / total, 5))

    # -- serving ------------------------------------------------------
    def _swap(self, bst) -> Tuple[float, Optional[bool]]:
        if self.server is None:
            return 0.0, None
        t0 = time.perf_counter()
        first = self.server._model is None
        same = self.server.swap(bst)
        swap_s = time.perf_counter() - t0
        obs.observe("pipeline.swap", swap_s)
        # the model-freshness anchor of the SLO engine (obs/slo.py
        # ``freshness_s<=D``)
        obs.set_gauge("pipeline.last_swap_unix", time.time())
        # a fleet tenant always has a model (the fleet seeds every tenant),
        # so this warms at the pipeline's first swap, not only when the
        # server was empty
        if not self._warmed:
            # build the forest kernel and launch both routes while window
            # 1's prep is still running
            self._warmed = True
            rows = self.warmup_rows
            if rows == "auto":
                self.server.warmup()
            elif rows:
                self.server.warmup(list(rows))
        return swap_s, (None if first else same)

    def _eval_window(self, pw: PreppedWindow, eval_fn):
        """Score the CURRENTLY SERVED model (the previous window's) on
        this window's eval rows, ``eval_chunk_rows`` at a time through
        the server (one forest-kernel launch a chunk on the card)."""
        if self.server is None or self.server._model is None \
                or not pw.has_eval():
            return None, 0.0
        t0 = time.perf_counter()
        with obs.span("pipeline.eval", cat="pipeline"):
            if pw.eval_dense is not None:
                n = int(np.asarray(pw.eval_dense).shape[0])
                fetch = lambda lo, hi: np.asarray(  # noqa: E731
                    pw.eval_dense[lo:hi], np.float64)
            else:
                n = len(pw.eval_csr[0]) - 1
                fetch = lambda lo, hi: densify_csr_rows(  # noqa: E731
                    pw.eval_csr, lo, hi)
            preds = []
            step = self.eval_chunk_rows
            for lo in range(0, n, step):
                hi = min(lo + step, n)
                preds.append(np.asarray(self.server.predict(
                    fetch(lo, hi))))
            pred = np.concatenate(preds, axis=0) if preds \
                else np.zeros(0)
            metrics = eval_fn(pred, pw) if eval_fn is not None else None
        eval_s = time.perf_counter() - t0
        return metrics, eval_s

    # -- the loop ------------------------------------------------------
    def run(self, payloads, prep_fn: Callable,
            eval_fn: Optional[Callable] = None,
            on_window: Optional[Callable] = None) -> List[WindowResult]:
        """Drive the pipeline over ``payloads`` (any iterable; each item
        is handed to ``prep_fn(payload) -> PreppedWindow`` on the prep
        thread).  ``eval_fn(pred, prepped) -> dict`` turns the served
        model's predictions on a window's eval rows into metrics;
        ``on_window(result)`` fires after every completed window.
        Returns the list of :class:`WindowResult`.  A prep failure
        raises :class:`PipelineError` — completed results ride on the
        exception and the server keeps serving the last good model."""
        if self._prep_thread is not None and self._prep_thread.is_alive():
            # a previous run's worker is still mid-prep; letting a new
            # one start would race it on the shared BinMapperCache
            raise LightGBMError(
                "a previous run()'s prep thread is still active; wait "
                "for it to finish before starting another run")
        obs.configure_from_config(self.config)
        faults.configure_from_config(self.config)
        # one causal chain per pipeline (kept across resume via the
        # checkpoint manifest); both the prep thread and the main loop
        # root their spans under it
        if tracing.enabled() and self._trace_id is None:
            self._trace_id = tracing.new_id()
        root_ctx = (tracing.SpanContext(self._trace_id)
                    if tracing.enabled() else None)
        root_tok = tracing.set_current(root_ctx)
        results: List[WindowResult] = []
        stop = threading.Event()
        stream = self._window_stream(payloads, prep_fn, stop, root_ctx)
        try:
            while True:
                t_wait = time.perf_counter()
                item = next(stream)
                stall_s = time.perf_counter() - t_wait
                if item[0] == "done":
                    break
                if item[0] == "error":
                    _, idx, exc = item
                    obs.inc("pipeline.prep_errors")
                    raise PipelineError(idx, results, exc)
                _, idx, pw, ds, info, prep_s, prep_ctx = item
                obs.observe("pipeline.stall", stall_s)
                if idx > 0:
                    self._prep_total_s += prep_s
                    self._overlap_s += max(prep_s - stall_s, 0.0)
                    if self._prep_total_s > 0:
                        obs.set_gauge(
                            "pipeline.overlap_fraction",
                            self._overlap_s / self._prep_total_s)
                # cross-thread handoff: the window span (and everything
                # under it — train, swap, checkpoint) parents under the
                # prep thread's prep_window span
                ctx_tok = tracing.set_current(prep_ctx)
                try:
                    with obs.span("pipeline.window", cat="pipeline",
                                  window=idx, rows=int(ds.num_data)):
                        eval_metrics, eval_s = self._eval_window(
                            pw, eval_fn)
                        policy = self._policy_for(idx, info["rebinned"])
                        cap_n = capture_track.total()
                        cap_s = capture_track.seconds()
                        t0 = time.perf_counter()
                        # the span exit records the pipeline.train timing
                        with obs.span("pipeline.train", cat="pipeline",
                                      window=idx, policy=policy):
                            bst = self._train_window(ds, policy)
                        t1 = time.perf_counter()
                        cap_n = capture_track.total() - cap_n
                        cap_s = capture_track.seconds() - cap_s
                        self._emit_feature_telemetry(bst, idx, policy)
                        swap_s, same = self._swap(bst)
                        if self.checkpoint_dir:
                            # commit the completed window AFTER serving
                            # has it: a crash from here on resumes at
                            # idx + 1
                            self._save_checkpoint(idx, bst, policy,
                                                  int(ds.num_data))
                finally:
                    tracing.reset(ctx_tok)
                res = WindowResult(
                    window=idx, policy=policy,
                    rebinned=info["rebinned"], drift=info["drift"],
                    rows=int(ds.num_data), num_trees=len(bst.models),
                    prep_s=prep_s, stall_s=stall_s, train_s=t1 - t0,
                    eval_s=eval_s, swap_s=swap_s, swap_same_shape=same,
                    train_span=(t0, t1), eval_metrics=eval_metrics,
                    meta=dict(pw.meta), booster=bst, captures=cap_n,
                    capture_s=cap_s)
                results.append(res)
                obs.inc("pipeline.windows")
                if on_window is not None:
                    on_window(res)
                if not self.keep_boosters:
                    res.booster = None
        finally:
            tracing.reset(root_tok)
            stop.set()
            self._shutdown_prep()
        return results

    def _shutdown_prep(self, timeout_s: float = 30.0) -> None:
        """Wait for the prep worker to exit (its ``put`` loop notices
        ``stop`` within 0.1 s; draining the queue unparks it).  A worker
        deep inside a long ``prep_fn`` finishes that window first —
        best effort, bounded; if it is somehow still alive afterwards
        the thread reference is kept so the next ``run()`` refuses to
        race it."""
        worker = self._prep_thread
        if worker is None:
            return
        deadline = time.perf_counter() + timeout_s
        while worker.is_alive() and time.perf_counter() < deadline:
            try:
                self._prep_queue.get_nowait()
            except queue.Empty:
                pass
            worker.join(timeout=0.2)
        if worker.is_alive():
            log_warning("pipeline prep thread did not stop within "
                        f"{timeout_s:.0f} s; a new run() will refuse "
                        "until it exits")
        else:
            self._prep_thread = None
            self._prep_queue = None

    @property
    def overlap_fraction(self) -> Optional[float]:
        """Overlapped prep seconds / total prep seconds across
        steady-state windows (window 0 is inherently serial)."""
        if self._prep_total_s <= 0:
            return None
        return self._overlap_s / self._prep_total_s

    def final_booster(self) -> Optional[GBDT]:
        return self._prev
