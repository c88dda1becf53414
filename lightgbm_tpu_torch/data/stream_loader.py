"""Two-round streaming text loading with a double-buffered reader
(counterpart of ``lightgbm_tpu/data/stream_loader.py``).

``two_round`` loading never holds the file's float64 matrix: round one
streams the file in chunks behind a background reader thread, counts its
rows and reservoir-samples ``bin_construct_sample_cnt`` of them for bin
finding; round two streams it again and bins each chunk into the
preallocated ``(N, G)`` uint8 matrix (reference
``dataset_loader.cpp:161-264``, ``utils/pipeline_reader.h:19-66``).  Peak
host memory is the sample, two chunks and the codes.

The pod's load (:func:`load_text_multihost`, one process a host): round
one on host 0, the mapper reference broadcast over the socket plane, and
each host streaming round two with every label parsed but only its own
row block of the pod layout binned.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import obs
from ..robust import faults
from ..utils.file_io import open_text
from ..utils.log import LightGBMError, log_info
from .parser import _atof, _sniff

_CHUNK_BYTES = 8 << 20          # ~8 MB of text per chunk


def _chunk_reader(path: str,
                  skip_header: bool) -> Iterator[Tuple[int, List[str]]]:
    """Yield ``(first_line_number, lines)`` chunks, double-buffered: a
    background thread reads the next chunk from disk while the consumer
    parses the current one (the ``PipelineReader`` pattern,
    utils/pipeline_reader.h:19-66).  Line numbers are 1-based file
    positions so parse errors can name the offending row.

    Abandonment-safe (docs/Robustness.md): if the consumer stops early
    — a parse error propagates, the generator is closed or collected —
    the ``finally`` block trips ``stop`` and the reader's bounded put
    notices within 0.1 s, so the thread can NEVER hang forever blocked
    on the full queue (the failure mode of an unconditional
    ``q.put``)."""
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        line_no = 1
        try:
            faults.check("io.read")
            with open_text(path) as fh:
                if skip_header:
                    fh.readline()
                    line_no += 1
                while True:
                    lines = fh.readlines(_CHUNK_BYTES)
                    if not lines:
                        break
                    if not put((line_no, lines)):
                        return
                    line_no += len(lines)
        except Exception as e:    # noqa: BLE001 — forwarded to consumer
            put(e)
            return
        put(None)

    def next_item():
        # timed get + liveness check: a reader killed mid-chunk (OOM,
        # interpreter teardown) must surface as an error, not hang the
        # consumer forever on an empty queue
        while True:
            try:
                return q.get(timeout=0.5)
            except queue.Empty:
                if t.is_alive():
                    continue
                try:
                    # the reader may have delivered its last item (or
                    # sentinel) between the timeout and the death check
                    return q.get_nowait()
                except queue.Empty:
                    raise LightGBMError(
                        f"stream reader thread for {path} died "
                        "without delivering a result") from None

    t = threading.Thread(target=reader, daemon=True,
                         name="lgbm-stream-reader")
    t.start()
    try:
        while True:
            item = next_item()
            if item is None:
                break
            if isinstance(item, LightGBMError):
                raise item
            if isinstance(item, Exception):
                raise LightGBMError(
                    f"failed reading data file {path}: {item}") from item
            yield item
    finally:
        stop.set()
        # unpark a reader blocked on a full queue, then reap it
        try:
            q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)


def _parse_chunk_checked(fmt: "_Format", path: str, line_no: int,
                         lines: List[str], num_cols: int):
    """``fmt.parse_chunk`` with failure context: a poisoned row (bad
    float, truncated ``feat:value`` token, ragged line) surfaces as a
    :class:`LightGBMError` naming the FILE and LINE instead of a bare
    ``ValueError`` from deep inside numpy."""
    try:
        faults.check("stream.parse")
        return fmt.parse_chunk(lines, num_cols)
    except LightGBMError:
        raise
    except Exception as e:      # noqa: BLE001 — re-raised with location
        row = _locate_bad_line(fmt, lines, num_cols)
        where = (f"line {line_no + row}: {lines[row].rstrip()!r}"
                 if row is not None
                 else f"lines {line_no}-{line_no + len(lines) - 1}")
        raise LightGBMError(
            f"failed to parse data file {path} at {where} "
            f"(truncated or malformed row?): {e}") from e


def _locate_bad_line(fmt: "_Format", lines: List[str],
                     num_cols: int) -> Optional[int]:
    """Error-path-only bisect: which single line fails to parse."""
    for i, line in enumerate(lines):
        try:
            fmt.parse_chunk([line], num_cols)
        except Exception:       # noqa: BLE001 — probing
            return i
    return None


class _Format:
    """Sniffed file format + per-chunk parse to a float64 matrix."""

    def __init__(self, path: str, config):
        self.header = bool(getattr(config, "header", False))
        with open_text(path) as fh:
            if self.header:
                self.header_line = fh.readline()
            sample = [fh.readline() for _ in range(50)]
        sample = [l for l in sample if l and l.strip()]
        if not sample:
            raise LightGBMError(f"empty data file {path}")
        self.kind = _sniff(sample)
        lc = str(getattr(config, "label_column", "") or "0")
        self.label_col = 0
        label_name = None
        if lc.startswith("name:"):
            label_name = lc[5:]
            if not self.header:
                raise LightGBMError(
                    "label_column=name: requires header=true")
        else:
            self.label_col = int(lc)
        if self.kind == "libsvm":
            self.num_cols = 0     # grows while scanning round one
            self.names = None
        else:
            self.delim = "\t" if self.kind == "tsv" else ","
            ncol = len(sample[0].rstrip("\n").split(self.delim))
            self.num_cols = ncol - 1          # minus label
            self.names = None
            if self.header:
                cols = [c.strip() for c in
                        self.header_line.rstrip("\n").split(self.delim)]
                if label_name is not None:
                    if label_name not in cols:
                        raise LightGBMError(
                            f"label column name {label_name!r} not found "
                            f"in header")
                    self.label_col = cols.index(label_name)
                self.names = [c for i, c in enumerate(cols)
                              if i != self.label_col]

    def parse_chunk(self, lines: List[str], num_features: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (x (n, num_features) float64, label (n,) float64)."""
        if self.kind == "libsvm":
            labels, rows, cols, vals = [], [], [], []
            for line in lines:
                toks = line.split()
                if not toks:
                    continue
                labels.append(float(toks[0]))
                r = len(labels) - 1
                for t in toks[1:]:
                    c, v = t.split(":", 1)
                    c = int(c)
                    if c < num_features:
                        rows.append(r)
                        cols.append(c)
                        vals.append(float(v))
            x = np.zeros((len(labels), num_features), np.float64)
            if cols:
                x[rows, cols] = vals
            return x, np.asarray(labels, np.float64)
        out = self._parse_full_rows(lines)
        if out is not None:
            label = out[:, self.label_col]
            return np.delete(out, self.label_col, axis=1), label
        out = np.empty((len(lines), self.num_cols + 1), np.float64)
        n = 0
        for line in lines:
            if not line.strip():
                continue
            toks = line.rstrip("\n").split(self.delim)
            out[n, :len(toks)] = [_atof(t) for t in toks]
            if len(toks) < out.shape[1]:
                out[n, len(toks):] = np.nan
            n += 1
        out = out[:n]
        label = out[:, self.label_col]
        x = np.delete(out, self.label_col, axis=1)
        return x, label

    def _parse_full_rows(self, lines: List[str]) -> Optional[np.ndarray]:
        """The chunk as one ``float`` pass when every row has all its
        columns and every token is a number (the common case), else None
        for the token-by-token path.  ``float`` of such a token is
        ``_atof``'s value, so both paths give the same matrix."""
        ncol = self.num_cols + 1
        rows = [line.rstrip("\n").split(self.delim) for line in lines
                if line.strip()]
        if any(len(r) != ncol for r in rows):
            return None
        try:
            flat = np.fromiter(map(float, itertools.chain.from_iterable(
                rows)), np.float64, len(rows) * ncol)
        except ValueError:
            return None
        return flat.reshape(len(rows), ncol)

    def scan_columns(self, lines: List[str]) -> int:
        """libsvm round-one helper: max feature index + 1 in this chunk."""
        mx = 0
        for line in lines:
            for t in line.split()[1:]:
                c = t.split(":", 1)[0]
                mx = max(mx, int(c) + 1)
        return mx


def iter_parsed_chunks(path: str, config, num_features: int):
    """Public chunked-parse entry point: yields ``(x, label)`` float64
    chunks behind the double-buffered reader.  Used by the CLI's
    streaming prediction (``predictor.hpp:170-259`` analog)."""
    fmt = _Format(path, config)
    for line_no, lines in _chunk_reader(path, fmt.header):
        yield _parse_chunk_checked(fmt, path, line_no, lines,
                                   num_features)


def _round_one(path: str, fmt: "_Format", config
               ) -> Tuple[np.ndarray, int, int]:
    """Round one of a two-round load: stream the file once behind the
    double-buffered reader, count rows, grow the libsvm column bound,
    and reservoir-sample ``bin_construct_sample_cnt`` rows for bin
    finding.  Returns ``(sample, n_total, num_cols)``."""
    sample_cnt_target = int(config.bin_construct_sample_cnt)
    rng = np.random.default_rng(config.data_random_seed & 0x7FFFFFFF)
    n_total = 0
    num_cols = fmt.num_cols
    reservoir: Optional[np.ndarray] = None      # (sample, F) float64
    res_filled = 0
    for line_no, lines in _chunk_reader(path, fmt.header):
        if fmt.kind == "libsvm":
            try:
                num_cols = max(num_cols, fmt.scan_columns(lines))
            except Exception as e:   # noqa: BLE001 — located below
                raise LightGBMError(
                    f"failed to parse data file {path} near line "
                    f"{line_no} (truncated feature:value token?): "
                    f"{e}") from e
            fmt.num_cols = num_cols
        x, _ = _parse_chunk_checked(fmt, path, line_no, lines, num_cols)
        if reservoir is None:
            reservoir = np.zeros((sample_cnt_target, x.shape[1]))
        elif x.shape[1] > reservoir.shape[1]:   # libsvm column growth
            pad = np.zeros((sample_cnt_target,
                            x.shape[1] - reservoir.shape[1]))
            reservoir = np.hstack([reservoir, pad])
        # chunk-vectorized reservoir sampling: fill the head directly,
        # then draw all acceptance slots for the chunk's remaining rows
        # in one rng call (duplicate slots keep the LAST writer, matching
        # sequential reservoir order via np's last-write-wins on argsorted
        # unique; a per-row Python loop here costs minutes at 10M rows)
        m = x.shape[0]
        take_head = min(max(sample_cnt_target - res_filled, 0), m)
        if take_head:
            reservoir[res_filled:res_filled + take_head, :x.shape[1]] = \
                x[:take_head]
            res_filled += take_head
        rest = np.arange(take_head, m)
        if len(rest):
            slots = rng.integers(0, n_total + rest + 1)
            accept = slots < sample_cnt_target
            rs, ss = rest[accept], slots[accept]
            if len(rs):
                # later rows overwrite earlier ones on slot collisions
                reservoir[ss, :] = 0.0
                reservoir[ss, :x.shape[1]] = x[rs]
        n_total += m
    if n_total == 0:
        raise LightGBMError(f"data file {path} is empty")
    sample = reservoir[:res_filled]
    log_info(f"two-round load: {n_total} rows, sampled {res_filled} "
             f"for bin finding ({fmt.kind})")
    return sample, n_total, num_cols


def _round_two(path: str, fmt: "_Format", ds, num_cols: int,
               n_total: int,
               row_span: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Round two: re-stream the file and bin chunk-wise into the
    preallocated ``(N, G)`` matrix; returns the full label vector.

    ``row_span=(lo, hi)`` bins only the global rows ``[lo, hi)``, pushed
    at local coordinates ``row - lo`` (the pod's load, where ``ds`` holds
    this host's padded block).  Labels are parsed for every row either
    way: every pod host computes the global gradients from the global
    scores."""
    start = 0
    label = np.zeros(n_total, np.float64)
    lo, hi = row_span if row_span is not None else (0, n_total)
    for line_no, lines in _chunk_reader(path, fmt.header):
        x, y = _parse_chunk_checked(fmt, path, line_no, lines, num_cols)
        m = x.shape[0]
        label[start:start + len(y)] = y
        a, b = max(start, lo), min(start + m, hi)
        if a < b:
            ds.construct_streaming_push(x[a - start:b - start], a - lo)
        start += m
    ds.construct_streaming_finish()
    return label


def load_text_two_round(path: str, config, categorical=(),
                        reference=None):
    """Stream-load ``path`` into a BinnedDataset without materializing
    the float64 matrix (dataset_loader.cpp:161-264 semantics).

    Returns ``(dataset, label)``.
    """
    from .dataset import BinnedDataset

    if not os.path.exists(path):
        raise LightGBMError(f"could not open data file {path}")
    fmt = _Format(path, config)
    sample, n_total, num_cols = _round_one(path, fmt, config)

    # ---- bin finding + bundling from the sample ------------------------
    ds = BinnedDataset.construct_streaming_begin(
        sample, n_total, num_cols, config, categorical,
        feature_names=fmt.names, reference=reference)

    # ---- round two: bin chunk-wise into the (N, G) matrix --------------
    label = _round_two(path, fmt, ds, num_cols, n_total)
    ds.metadata.set_label(label)
    return ds, label


def load_text_multihost(path: str, config, categorical=()):
    """The pod's two-round streamed load (``lightgbm_tpu/data/
    stream_loader.py::load_text_multihost``).

    Bins and bundles are found ONCE for the whole pod (per-host bin
    finding would give the hosts different mappers and diverge the
    models): host 0 runs round one over the whole file and broadcasts the
    serialized mapper reference on the coordinator's port plus one.  Every
    host (host 0 too, for the same mapper state) rebuilds the skeleton
    from the same bytes, allocates only its contiguous padded row block
    ``[lo, hi)`` of the pod layout (``ops/shard.process_row_span``) and
    streams round two: labels parsed globally, binning filtered to the
    span.

    Returns ``(dataset, label)``: ``dataset.num_data`` is the global row
    count, ``dataset.binned`` this host's padded block, and
    ``dataset.host_shard`` / ``dataset.host_row_span`` mark the layout for
    ``DeviceGrower``, which checks the span.  A peer that dies during the
    load surfaces as a :class:`LightGBMError` naming the host and the
    file: the reference broadcast and the layout handshake after it ride
    the deadline-bound blob plane, and parse errors keep their file and
    line, prefixed with this host's rank.  Sets the ``ingest.rows_per_s``
    gauge (this host's binned rows over its round two).
    """
    from .dataset import BinnedDataset
    from ..ops.shard import (make_pod_mesh, multihost_params,
                             multihost_setup, pod_local_shards,
                             process_row_span, shard_local_rows)
    from ..parallel.network import broadcast_blob, pod_broadcast_address
    from ..pipeline.bins import (reference_from_bytes,
                                 reference_layout_digest,
                                 reference_to_bytes)

    resolved = multihost_params(config)
    if resolved is None:
        raise LightGBMError(
            "load_text_multihost: no coordinator configured — set "
            "coordinator_address/num_hosts/host_rank (or the "
            "LGBM_TPU_COORDINATOR/LGBM_TPU_NUM_HOSTS/"
            "LGBM_TPU_HOST_RANK env vars)")
    coord = resolved[0]
    rank, hosts = multihost_setup(config)
    mesh = make_pod_mesh(pod_local_shards(config))
    addr = pod_broadcast_address(coord)

    def _blob_round(payload, what):
        try:
            return broadcast_blob(payload, address=addr, num_hosts=hosts,
                                  rank=rank, config=config)
        except LightGBMError as e:
            raise LightGBMError(
                f"sharded ingest of {path} failed on host {rank} "
                f"during {what}: {e}") from e

    if not os.path.exists(path):
        raise LightGBMError(
            f"could not open data file {path} (host {rank})")
    fmt = _Format(path, config)

    # ---- round one on host 0 only, the reference over the blob plane ----
    blob = None
    if rank == 0:
        sample, n_total, num_cols = _round_one(path, fmt, config)
        ref = BinnedDataset.construct_streaming_begin(
            sample, n_total, num_cols, config, categorical,
            feature_names=fmt.names)
        ref.binned = None     # mappers and bundles only
        blob = reference_to_bytes(
            ref, extra={"n_total": n_total, "num_cols": num_cols})
    blob = _blob_round(blob, "mapper-reference broadcast")
    skeleton, extra = reference_from_bytes(blob)
    n_total = int(extra["n_total"])
    num_cols = int(extra["num_cols"])
    if fmt.kind == "libsvm":
        fmt.num_cols = num_cols   # host 0's global column bound

    # ---- this host's contiguous padded block of the pod's rows ----------
    n_loc = shard_local_rows(n_total, len(mesh), config)
    lo, hi = process_row_span(mesh, n_loc)
    ds = BinnedDataset.construct_streaming_begin(
        np.zeros((0, num_cols)), hi - lo, num_cols, config, categorical,
        feature_names=fmt.names, reference=skeleton)

    # ---- round two: every label, this host's span binned ----------------
    t0 = time.perf_counter()
    try:
        label = _round_two(path, fmt, ds, num_cols, n_total,
                           row_span=(lo, hi))
    except LightGBMError as e:
        raise LightGBMError(f"[host {rank}] {e}") from e
    binned_rows = max(0, min(hi, n_total) - min(lo, n_total))
    obs.set_gauge("ingest.rows_per_s",
                  binned_rows / max(time.perf_counter() - t0, 1e-9))

    # ---- the global-row contract the grower checks ----------------------
    ds.num_data = n_total
    ds.metadata = type(ds.metadata)(n_total)
    ds.host_shard = True
    ds.host_row_span = (lo, hi)
    ds.metadata.set_label(label)

    # ---- the layout handshake: a liveness barrier and a cross-check -----
    my_digest = reference_layout_digest(ds).encode()
    echoed = _blob_round(my_digest if rank == 0 else None,
                         "post-ingest layout handshake")
    if echoed != my_digest:
        raise LightGBMError(
            f"host {rank} binned {path} with a different feature "
            f"layout than host 0 (digest {my_digest.decode()[:12]} vs "
            f"{echoed.decode()[:12]}); pod ingest diverged")
    log_info(f"multihost load: host {rank}/{hosts} holds rows "
             f"[{lo}, {hi}) of {n_total} ({binned_rows} real, "
             f"{fmt.kind})")
    return ds, label
