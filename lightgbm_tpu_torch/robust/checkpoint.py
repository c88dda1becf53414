"""Atomic checkpoints: training snapshots and pipeline window state.

Counterpart of ``lightgbm_tpu/robust/checkpoint.py``.  Both checkpoint
families have the same crash contract — **a
reader never observes a partial file**: every write lands in a
same-directory temp file first and is moved into place with
``os.replace`` (atomic on POSIX), so a process killed mid-write leaves
either the previous checkpoint or the new one, never a torn mix.

* **Training snapshots** (``save_train_state``/``load_train_state``,
  used by ``GBDT.save_checkpoint``): the model text file plus a
  ``.state.npz`` sidecar holding the EXACT float32 training scores and
  the iteration counter.  Restoring the scores bit-exactly is what makes
  continued boosting byte-identical to an uninterrupted run.  Bagging,
  feature_fraction and int8 quantization draws need no state: they are
  Threefry draws keyed on (seed, iteration) or (seed, tree index).

* **Pipeline checkpoints** (``save_pipeline_checkpoint``/
  ``load_pipeline_checkpoint``): one directory per retrain loop holding
  ``model.<w>.txt`` (the last completed window's ensemble),
  ``bins.<w>.pkl`` (the :class:`~lightgbm_tpu_torch.pipeline.bins.
  BinMapperCache` reference mappers and drift occupancy) and
  ``checkpoint.json`` — the manifest, written LAST, which is the commit
  point.  The files are the JAX package's formats, so a checkpoint
  written by either package resumes in the other.

Under ``data_sharding=multi_controller`` a training snapshot commits by
the pod protocol below (every host acks a digest of its state, host 0
writes the files and then a commit marker): a snapshot some host never
reached is never resumed.

The ``io.write`` fault site sits between temp-write and rename so chaos
tests can simulate a crash at the worst moment and assert the previous
checkpoint survives intact.
"""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..utils.log import LightGBMError, log_info
from . import faults

MANIFEST = "checkpoint.json"
MANIFEST_VERSION = 1

_SNAPSHOT_RE = re.compile(r"\.snapshot_iter_(\d+)$")


def _tmp_path(path: str) -> str:
    return f"{path}.tmp.{os.getpid()}"


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write-temp-then-rename; fsynced so the rename never outruns the
    data.  The ``io.write`` fault site fires BEFORE the rename — an
    injected fault (or a real crash there) leaves the old file intact
    and at most a stray ``.tmp.<pid>`` behind."""
    tmp = _tmp_path(path)
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    faults.check("io.write")
    os.replace(tmp, path)


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode())


def atomic_replace_from(writer, path: str) -> None:
    """Atomic wrapper for APIs that insist on writing a path themselves
    (e.g. ``BinMapperCache.save``): ``writer(tmp)`` then rename."""
    tmp = _tmp_path(path)
    writer(tmp)
    faults.check("io.write")
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# training snapshots (GBDT.save_checkpoint sidecar)
# ---------------------------------------------------------------------------

def save_train_state(path: str, score: np.ndarray, iteration: int,
                     rng_state: Optional[tuple] = None) -> None:
    """Atomic ``.npz`` sidecar with the exact (K, N) float32 training
    scores, the iteration counter and (optionally) the host learner's
    Mersenne-Twister state, the one draw stream that is not keyed on the
    iteration (its feature_fraction), in the JAX package's format."""
    arrays = {"score": np.asarray(score, np.float32),
              "iteration": np.int64(iteration)}
    if rng_state is not None:
        name, keys, pos, has_gauss, cached = rng_state
        arrays.update(rng_name=np.asarray(str(name)),
                      rng_keys=np.asarray(keys, np.uint32),
                      rng_pos=np.int64(pos),
                      rng_has_gauss=np.int64(has_gauss),
                      rng_cached=np.float64(cached))
    tmp = _tmp_path(path)
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    faults.check("io.write")
    os.replace(tmp, path)


def load_train_state(path: str) -> Optional[Tuple]:
    """-> (score float32, iteration, host learner's RNG state or None),
    or None when no sidecar exists."""
    if not os.path.exists(path):
        return None
    with np.load(path) as state:
        rng_state = None
        if "rng_name" in state.files:
            rng_state = (str(state["rng_name"]),
                         np.asarray(state["rng_keys"], np.uint32),
                         int(state["rng_pos"]),
                         int(state["rng_has_gauss"]),
                         float(state["rng_cached"]))
        return (np.asarray(state["score"], np.float32),
                int(state["iteration"]), rng_state)


def latest_snapshot(output_model: str) -> Optional[str]:
    """The highest-iteration ``<output_model>.snapshot_iter_N`` whose
    state sidecar exists (a snapshot without one cannot resume
    byte-identically, so it is skipped), or None."""
    best, best_iter = None, -1
    for cand in glob.glob(glob.escape(output_model) + ".snapshot_iter_*"):
        m = _SNAPSHOT_RE.search(cand)
        if m is None or not os.path.exists(cand + ".state.npz"):
            continue
        it = int(m.group(1))
        if it > best_iter:
            best, best_iter = cand, it
    return best


# ---------------------------------------------------------------------------
# the pod commit protocol (data_sharding=multi_controller)
# ---------------------------------------------------------------------------
#
# A pod checkpoint is real only once EVERY host has reached its state:
# host 0 must not publish a snapshot a dead peer never reached, or a resume
# would diverge.  The protocol:
#
#   1. every host writes an atomic ack file ``<path>.ack.h<rank>`` with a
#      digest of its view of the snapshot (model trees, scores, iteration:
#      the same on every host, so the digest is also a divergence check);
#   2. host 0 polls for every ack (a network_timeout-derived deadline) and
#      checks each digest against its own;
#   3. host 0 writes the payload (model text, .state.npz sidecar) and THEN
#      the ``<path>.commit`` marker, the commit point;
#   4. peers poll for a marker with the matching digest before returning,
#      so no host goes past an uncommitted snapshot.
#
# A host killed mid-window never acks, host 0 times out, no marker lands,
# and the pod resumes from the previous committed snapshot.  The
# ``ckpt.ack`` fault site arms step 1.

_POLL_INTERVAL_S = 0.05


def _pod_ack_path(path: str, rank: int) -> str:
    return f"{path}.ack.h{int(rank)}"


def pod_commit_path(path: str) -> str:
    return f"{path}.commit"


def pod_state_digest(model_trees: str, score: np.ndarray,
                     iteration: int) -> str:
    """Digest of one host's snapshot view.  Callers pass the model text
    WITHOUT the parameters echo (``host_rank`` differs per host); the
    scores and the iteration are the same on every host."""
    import hashlib
    h = hashlib.sha256()
    h.update(model_trees.encode())
    h.update(np.ascontiguousarray(score, np.float32).tobytes())
    h.update(str(int(iteration)).encode())
    return h.hexdigest()


def write_pod_ack(path: str, rank: int, digest: str) -> None:
    """Atomically publish this host's readiness for the snapshot at
    ``path`` (step 1)."""
    faults.check("ckpt.ack")
    atomic_write_text(_pod_ack_path(path, rank),
                      json.dumps({"rank": int(rank), "digest": digest}))


def await_pod_acks(path: str, num_hosts: int, digest: str,
                   timeout_s: float, sleep=None) -> None:
    """Host 0: block until every host's ack lands with a matching digest;
    raises :class:`LightGBMError` naming the missing ranks on timeout and
    the diverging rank on a digest mismatch."""
    import time
    sleep = sleep or time.sleep
    deadline = time.monotonic() + float(timeout_s)
    missing = list(range(int(num_hosts)))
    while True:
        still = []
        for rank in missing:
            ack = _pod_ack_path(path, rank)
            if not os.path.exists(ack):
                still.append(rank)
                continue
            try:
                with open(ack) as fh:
                    got = json.load(fh)
            except (OSError, ValueError):
                still.append(rank)   # read mid-replace; retry
                continue
            if str(got.get("digest")) != digest:
                raise LightGBMError(
                    f"pod checkpoint {path}: host {rank} acked digest "
                    f"{got.get('digest')!r} but host 0 computed "
                    f"{digest!r} — pod state diverged, refusing to "
                    f"commit")
        missing = still
        if not missing:
            return
        if time.monotonic() >= deadline:
            raise LightGBMError(
                f"pod checkpoint {path}: no ack from host(s) "
                f"{missing} within {timeout_s:.1f}s — a peer died "
                f"mid-window; snapshot NOT committed")
        sleep(_POLL_INTERVAL_S)


def commit_pod(path: str, digest: str) -> None:
    """Step 3's commit point: the marker is written LAST, after every
    payload file, so its presence certifies a complete snapshot."""
    atomic_write_text(pod_commit_path(path),
                      json.dumps({"digest": digest}))


def await_pod_commit(path: str, digest: str, timeout_s: float,
                     sleep=None) -> None:
    """Peers: block until host 0's commit marker lands with the matching
    digest (a stale marker of an earlier snapshot at the same path keeps
    the poll going until the fresh one replaces it)."""
    import time
    sleep = sleep or time.sleep
    deadline = time.monotonic() + float(timeout_s)
    while True:
        marker = pod_commit_path(path)
        if os.path.exists(marker):
            try:
                with open(marker) as fh:
                    got = json.load(fh)
            except (OSError, ValueError):
                got = {}
            if str(got.get("digest")) == digest:
                return
        if time.monotonic() >= deadline:
            raise LightGBMError(
                f"pod checkpoint {path}: host 0 never committed "
                f"within {timeout_s:.1f}s — snapshot abandoned")
        sleep(_POLL_INTERVAL_S)


def has_pod_commit(path: str) -> bool:
    """Whether the snapshot at ``path`` was pod-committed (a pod resumes
    only committed snapshots)."""
    return os.path.exists(pod_commit_path(path))


def clear_pod_acks(path: str, num_hosts: int) -> None:
    """Best-effort ack cleanup before a commit (stale acks of an earlier
    snapshot at the same path would short-circuit step 2)."""
    for rank in range(int(num_hosts)):
        try:
            os.remove(_pod_ack_path(path, rank))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# pipeline window checkpoints
# ---------------------------------------------------------------------------

@dataclass
class PipelineCheckpoint:
    """A loaded pipeline checkpoint (the manifest's view)."""

    directory: str
    window: int
    model_path: Optional[str]
    bins_path: Optional[str]
    meta: dict = field(default_factory=dict)

    @property
    def trace_id(self) -> Optional[str]:
        """The originating run's causal trace id (obs/tracing.py), when
        the checkpointing pipeline recorded one — a resumed pipeline
        reuses it so the resumed windows stay on the same trace."""
        return str(self.meta.get("trace_id") or "") or None

    def model_string(self) -> Optional[str]:
        if self.model_path is None:
            return None
        with open(self.model_path) as fh:
            return fh.read()


def save_pipeline_checkpoint(directory: str, *, window: int,
                             model_str: str, bins=None,
                             meta: Optional[dict] = None) -> None:
    """Persist one completed window: model text, optional bin-mapper
    cache, then the manifest (the commit point — always written last).

    The payload files are VERSIONED per window (``model.<w>.txt``)
    precisely so the manifest really is the commit point: with fixed
    names, a crash after replacing window N's model but before the
    manifest rename would pair window N-1's manifest with window N's
    model and resume would warm-start/evaluate against the wrong
    ensemble.  With versioned names that crash leaves window N-1's
    manifest pointing at window N-1's untouched files.  Files from
    windows older than the committed one are garbage-collected after
    the manifest lands."""
    os.makedirs(directory, exist_ok=True)
    model_name = f"model.{int(window)}.txt"
    atomic_write_text(os.path.join(directory, model_name), model_str)
    bins_name = None
    if bins is not None and bins.reference is not None:
        bins_name = f"bins.{int(window)}.pkl"
        atomic_replace_from(bins.save,
                            os.path.join(directory, bins_name))
    manifest = {
        "version": MANIFEST_VERSION,
        "window": int(window),
        "model": model_name,
        "bins": bins_name,
        "meta": dict(meta or {}),
    }
    atomic_write_text(os.path.join(directory, MANIFEST),
                      json.dumps(manifest, indent=1))
    _gc_stale_payloads(directory, int(window))


def _gc_stale_payloads(directory: str, committed_window: int) -> None:
    """Best-effort removal of payload/temp files from windows OLDER
    than the committed one (the manifest no longer references them)."""
    keep = {f"model.{committed_window}.txt",
            f"bins.{committed_window}.pkl", MANIFEST}
    for name in os.listdir(directory):
        if name in keep:
            continue
        m = re.match(r"^(?:model|bins)\.(\d+)\.(?:txt|pkl)", name)
        if m is None or int(m.group(1)) >= committed_window:
            continue
        try:
            os.remove(os.path.join(directory, name))
        except OSError:
            pass


def has_pipeline_checkpoint(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, MANIFEST))


def load_pipeline_checkpoint(directory: str) -> Optional[PipelineCheckpoint]:
    """Read the manifest and resolve the files it names; None when no
    manifest was ever committed."""
    path = os.path.join(directory, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        manifest = json.load(fh)
    if int(manifest.get("version", 0)) != MANIFEST_VERSION:
        raise LightGBMError(
            f"pipeline checkpoint {path} has version "
            f"{manifest.get('version')!r}; this build reads "
            f"{MANIFEST_VERSION}")
    def resolve(name):
        if not name:
            return None
        full = os.path.join(directory, name)
        if not os.path.exists(full):
            raise LightGBMError(
                f"pipeline checkpoint manifest names missing file "
                f"{full}")
        return full
    cp = PipelineCheckpoint(
        directory=directory,
        window=int(manifest["window"]),
        model_path=resolve(manifest.get("model")),
        bins_path=resolve(manifest.get("bins")),
        meta=dict(manifest.get("meta") or {}))
    log_info(f"Loaded pipeline checkpoint (window {cp.window}) from "
             f"{directory}")
    return cp
