"""The fork's cache-admission workload, the soak's window payloads.

The port's own copy of ``examples/cache_admission.py``'s derivation (the
fork's ``src/test.cpp``): a Zipf-popular request trace with lognormal
object sizes (:func:`synth_trace`), relaxed-Belady OPT admission labels
(:func:`calculate_opt`, ``calculateOPT``), 50 inter-arrival gap features
plus log2 size, available cache bytes and cost in CSR
(:func:`derive_features`, ``deriveFeatures``), and a CSR row subset.
The same inputs give the example's outputs bit for bit
(``tests/test_torch_soak.py``).
"""

from __future__ import annotations

import numpy as np

HISTFEATURES = 50


def synth_trace(n_requests: int, n_objects: int, seed: int = 7):
    """Zipf-popularity request stream with per-object lognormal sizes."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_objects + 1, dtype=np.float64)
    probs = ranks ** -0.8
    probs /= probs.sum()
    ids = rng.choice(n_objects, size=n_requests, p=probs).astype(np.int64)
    obj_size = np.clip(rng.lognormal(9.0, 1.5, n_objects), 64,
                       1 << 26).astype(np.int64)
    sizes = obj_size[ids]
    costs = np.ones(n_requests, np.float64)
    return ids, sizes, costs


def calculate_opt(ids, sizes, cache_size, window_size):
    """OPT admission labels (test.cpp:97-122): an interval's volume is
    (reuse distance x size); admit smallest volumes until the window's
    cache volume budget fills."""
    n = len(ids)
    # next-occurrence interval per request, vectorized over the id-sorted
    # permutation (same-id requests are adjacent, original order kept)
    order = np.lexsort((np.arange(n), ids))
    sid = ids[order]
    spos = np.arange(n)[order]
    same = sid[:-1] == sid[1:]
    has_next = np.zeros(n, bool)
    volume = np.full(n, np.iinfo(np.int64).max, np.int64)
    prev_idx = spos[:-1][same]
    next_idx = spos[1:][same]
    has_next[prev_idx] = True
    volume[prev_idx] = (next_idx - prev_idx) * sizes[prev_idx]

    to_cache = np.zeros(n, bool)
    cache_volume = cache_size * window_size
    by_vol = np.argsort(volume, kind="stable")
    vol_cum = np.cumsum(volume[by_vol].astype(np.float64))
    # the C++ admits while the running volume has not yet exceeded the
    # budget (checked BEFORE adding), entries without a next skip
    admit = np.concatenate([[True], vol_cum[:-1] <= cache_volume])
    sel = by_vol[admit & has_next[by_vol]]
    to_cache[sel] = True
    return to_cache, float(to_cache.sum()) / n


def derive_features(ids, sizes, costs, to_cache, cache_size,
                    sample_size, sampling, rng):
    """Gap features + size/cacheAvail/cost, CSR (test.cpp:125-209).

    Gap features are vectorized: within the id-sorted order, feature k
    of a request is the gap between its (k)th and (k+1)th most recent
    past occurrences.  The running cacheAvailBytes is vectorized too
    (:func:`cache_avail_bytes`), where the example walks the window in
    a Python loop: the loop held the interpreter lock for seconds a
    window, which the soak's serving threads waited on.
    """
    n = len(ids)
    order = np.lexsort((np.arange(n), ids))
    sid = ids[order]
    spos = np.arange(n)[order].astype(np.int64)
    # occ_k[p] = position of the k-th previous occurrence of sid[p]
    gaps = np.zeros((n, HISTFEATURES), np.float64)
    gap_count = np.zeros(n, np.int32)
    prev = spos.copy()
    prev_valid = np.ones(n, bool)
    for k in range(HISTFEATURES):
        shifted = np.empty(n, np.int64)
        shifted[1 + k:] = spos[:n - 1 - k]
        shifted[:1 + k] = -1
        valid = np.zeros(n, bool)
        valid[1 + k:] = sid[1 + k:] == sid[:n - 1 - k]
        valid &= prev_valid
        g = np.where(valid, prev - shifted, 0)
        gaps[spos[valid], k] = g[valid]
        gap_count[spos[valid]] += 1
        prev = np.where(valid, shifted, prev)
        prev_valid = valid

    cache_avail = cache_avail_bytes(ids, sizes, to_cache, cache_size)

    if sampling == 1:
        keep = np.arange(n) >= (n - sample_size)
    elif sampling == 2:
        keep = rng.random(n) < sample_size / n
    else:
        keep = np.ones(n, bool)

    kn = int(keep.sum())
    gc = gap_count[keep]
    row_nnz = gc + 3
    indptr = np.zeros(kn + 1, np.int32)
    np.cumsum(row_nnz, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = np.zeros(nnz, np.int32)
    data = np.zeros(nnz, np.float64)
    # scatter gap features: row r occupies indptr[r] : indptr[r]+gc[r]
    rows = np.repeat(np.arange(kn), gc)
    col_in_row = np.arange(int(gc.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(gc, dtype=np.int64) - gc, gc)
    flat = indptr[:-1][rows] + col_in_row
    kgaps = gaps[keep]
    indices[flat] = col_in_row
    data[flat] = kgaps[rows, col_in_row]
    # the three fixed features
    tail = indptr[1:] - 3
    indices[tail] = HISTFEATURES
    data[tail] = np.round(100.0 * np.log2(sizes[keep]))
    indices[tail + 1] = HISTFEATURES + 1
    data[tail + 1] = cache_avail[keep]
    indices[tail + 2] = HISTFEATURES + 2
    data[tail + 2] = costs[keep]
    labels = to_cache[keep].astype(np.float32)
    return labels, indptr, indices, data


def cache_avail_bytes(ids, sizes, to_cache, cache_size):
    """round(100 log2(free cache bytes)) before each request, 0 once the
    cache is full: the example's admission walk (an object enters on an
    admitted request, leaves with the size it entered with on a refused
    one), bit for bit.  An object is cached after each of its requests
    exactly when that request was admitted, so the walk is a prefix sum
    of per-request deltas in exact int64."""
    n = len(ids)
    order = np.lexsort((np.arange(n), ids))
    sid = ids[order]
    adm = np.asarray(to_cache, bool)[order]
    size = np.asarray(sizes)[order].astype(np.int64)
    was = np.zeros(n, bool)                 # cached before this request
    was[1:] = adm[:-1] & (sid[1:] == sid[:-1])
    enter = adm & ~was
    leave = was & ~adm
    # the size at the start of each run of admitted requests
    start = np.where(enter, np.arange(n), 0)
    np.maximum.accumulate(start, out=start)
    delta = np.zeros(n, np.int64)
    delta[enter] = -size[enter]
    out_at = np.flatnonzero(leave)
    delta[out_at] = size[start[out_at - 1]]
    step = np.empty(n, np.int64)
    step[order] = delta
    avail = np.empty(n, np.int64)
    avail[:1] = 0
    np.cumsum(step[:-1], out=avail[1:])
    avail = (avail + int(cache_size)).astype(np.float64)
    out = np.zeros(n, np.float64)
    free = avail > 0
    out[free] = np.round(100.0 * np.log2(avail[free]))
    return out


def csr_row_subset(indptr, indices, data, keep):
    """CSR rows selected by boolean mask ``keep`` (one gather)."""
    rows = np.flatnonzero(keep)
    counts = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    out_indptr = np.zeros(len(rows) + 1, np.int32)
    out_indptr[1:] = np.cumsum(counts)
    flat = np.repeat(indptr[rows].astype(np.int64)
                     - out_indptr[:-1], counts) \
        + np.arange(int(out_indptr[-1]), dtype=np.int64)
    return out_indptr, indices[flat], data[flat]
