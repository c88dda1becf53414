"""Single-controller row sharding of the device grower (counterpart of
``lightgbm_tpu/ops/shard.py``, its ``single_controller`` half).

One process holds a *mesh*: a list of ``torch.device`` shards (the
JAX package's one-axis ``Mesh``; several shards may name one card).  The
global padded row space is ``n_shards * local_rows``; shard ``d`` owns the
contiguous block ``[d * local_rows, (d + 1) * local_rows)``, and dataset
row ``r`` lives at global index ``r`` (:class:`ShardSpec`).  Each shard
holds its block of the ``(G, N)`` codes on its device, and every wave
launches kernel 1 once a shard over that shard's rows
(``ops/hist_cuda.wave_hist_sharded``); the shards' histograms are the one
reduction of the growth loop.  The find-best scan, the split application
and the score update read the reduced histograms and the per-row state
(leaf ids, stat columns, scores), which the port keeps in the global
layout on the grower's device: every shard grows the same tree, and no
split is broadcast.

The port's contract is stronger than the JAX package's f32 ``psum``:

* kernel 1 sums bf16 and f32 stats in int64 fixed point, one power-of-two
  exponent a column from the column's global maximum and the unsharded
  grower's row count, so every shard uses the same exponents; the shards'
  int64 accumulators (int32 for int8 stats) are summed *before* the one
  conversion to f32.  Integer sums do not depend on their order, so on the
  card a sharded model is bit-equal to the unsharded one in every regime;
* the int8 scale is the global maximum, and the rounding noise and the
  bagging mask are drawn at the unsharded grower's canonical shapes
  (element ``i`` of a Threefry draw depends on ``i`` and the key only,
  :func:`slice_global_draw`), so the int8 columns are the unsharded ones.

On the CPU each shard takes the kernel's plain version (f32 ``index_add_``)
and the shards' f32 histograms are summed in shard order: int8 models are
byte-equal to the unsharded ones, bf16 trees equal them up to that f32
summation.

A mesh of shards on one card grows a tree as one composed CUDA graph (the
shard launches and the reduction sit inside the capture); a mesh over
several cards runs the per-piece loop (``DeviceGrower._run_pieces``).
``data_sharding=multi_controller`` (one process a host, the pod slice) is
refused by name (``ops/grow.py::unported_options``): its collectives are
``torch.distributed``'s, one rank a process.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ..utils.log import LightGBMError, log_info
from .histogram import bucket_size


class ShardSpec(NamedTuple):
    """Static facts of one sharded layout (part of the grower's key)."""

    n_shards: int     #: mesh size D (always > 1; D == 1 runs unsharded)
    global_rows: int  #: real global row count (the valid-row bound)
    local_rows: int   #: rows a shard, padding included
    #: canonical global shape of the int8 rounding-noise draw (the
    #: unsharded grower's row pad)
    draw_npad: int
    #: canonical global shape of the bagging draw
    #: (``histogram.bucket_size(global_rows)``)
    bag_npad: int


def local_valid_rows(spec: ShardSpec, shard: int,
                     num_valid: Optional[int] = None) -> int:
    """Real rows of shard ``shard``: global rows are laid out in
    contiguous ``local_rows`` blocks, so shard ``d`` is valid up to
    ``num_valid - d * local_rows`` (clipped)."""
    nv = spec.global_rows if num_valid is None else int(num_valid)
    return max(0, min(nv - int(shard) * spec.local_rows, spec.local_rows))


def slice_global_draw(spec: ShardSpec, full: torch.Tensor,
                      shard: int) -> torch.Tensor:
    """Shard ``shard``'s block of a draw made at a canonical global shape
    (``draw_npad`` / ``bag_npad``); rows past the draw (only padding, which
    the valid mask zeroes) read as 0."""
    total = spec.n_shards * spec.local_rows
    if full.shape[0] >= total:
        full = full[:total]
    else:
        full = torch.nn.functional.pad(full, (0, total - full.shape[0]))
    off = int(shard) * spec.local_rows
    return full[off:off + spec.local_rows]


def canonical(device) -> torch.device:
    """``device`` with its index ("cuda" is the current card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _devices() -> List[torch.device]:
    """The process's cards (the JAX package's ``jax.devices()``)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_shard_mesh(num_devices: int = 0,
                    devices: Optional[Sequence] = None) -> List[torch.device]:
    """A mesh of ``num_devices`` shards (0: all) over ``devices`` (default
    the process's cards).  Raises :class:`LightGBMError` below 2 shards:
    one shard is the unsharded grower, and callers fall back to it."""
    devices = _devices() if devices is None else [torch.device(d)
                                                 for d in devices]
    d = int(num_devices) or len(devices)
    if d < 2:
        raise LightGBMError(
            f"data_sharding=single_controller needs >= 2 devices, have "
            f"{len(devices)} (request {d}); pass a mesh to name several "
            f"shards of one card")
    if d > len(devices):
        raise LightGBMError(
            f"shard_devices={d} exceeds available devices "
            f"({len(devices)})")
    return list(devices[:d])


def sharding_mode(config) -> str:
    """Resolved ``data_sharding`` mode string ("off" when unset)."""
    return str(getattr(config, "data_sharding", "off") or "off").lower()


def shard_local_rows(num_data: int, n_shards: int, config,
                     row_bucketing: Optional[bool] = None) -> int:
    """Padded rows a shard for ``num_data`` rows over ``n_shards``:
    ``ceil(N / D)`` lifted onto the power-of-two bucket ladder (as the
    port's unsharded grower pads, int8 included) unless
    ``train_row_bucketing`` is off or the global pad would reach the
    striped-count bound's twice."""
    from .grow import COUNT_SPLIT_ROWS
    if row_bucketing is None:
        row_bucketing = bool(getattr(config, "train_row_bucketing", True))
    srows = max(-(-int(num_data) // int(n_shards)), 1)
    if row_bucketing:
        b = bucket_size(srows)
        if b * int(n_shards) >= 2 * COUNT_SPLIT_ROWS:
            log_info(f"train_row_bucketing: per-shard bucket {b} would "
                     f"reach the striped-count bound; using exact "
                     f"per-shard rows ({srows})")
        else:
            srows = b
    return srows


def shard_spec(num_data: int, mesh: Sequence, config) -> ShardSpec:
    """The :class:`ShardSpec` of ``num_data`` rows over ``mesh``."""
    from .grow import grower_rows
    _, n_pad = grower_rows(num_data, config)
    return ShardSpec(len(mesh), int(num_data),
                     shard_local_rows(num_data, len(mesh), config), n_pad,
                     bucket_size(max(int(num_data), 1)))


def replicate_to_all(mesh: Sequence):
    """A function that puts a tensor on every shard's device (one copy a
    shard; a shard on the tensor's own device shares it)."""
    devs = [torch.device(d) for d in mesh]
    return lambda x: [x.to(d) for d in devs]


def host_replicated(mesh: Sequence, value) -> List[torch.Tensor]:
    """Host data (the same on every shard) placed on every shard's
    device."""
    return [torch.as_tensor(value, device=torch.device(d)) for d in mesh]


def resolve_shard_mesh(config, devices: Optional[Sequence] = None):
    """The mesh of the configured ``data_sharding`` mode, or None.
    ``single_controller`` with fewer than two devices logs and returns
    None: training goes on unsharded (it is a local optimisation).
    ``multi_controller`` is refused by name."""
    mode = sharding_mode(config)
    if mode == "multi_controller":
        raise LightGBMError("not ported to lightgbm_tpu_torch yet: "
                            "data_sharding=multi_controller (one process "
                            "a host)")
    if mode != "single_controller":
        return None
    try:
        mesh = make_shard_mesh(int(getattr(config, "shard_devices", 0)
                                   or 0), devices)
    except LightGBMError as e:
        log_info(f"data_sharding=single_controller unavailable ({e}); "
                 f"training unsharded")
        return None
    log_info(f"data_sharding=single_controller: row-sharding over "
             f"{len(mesh)} device(s), wave histograms reduced in fixed "
             f"point")
    return mesh
