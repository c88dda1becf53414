"""Row sharding of the device grower (counterpart of
``lightgbm_tpu/ops/shard.py``): single-controller, one process over a mesh
of shards, and multi-controller, one process a host over
``torch.distributed``.

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

Multi-controller (``data_sharding=multi_controller``, the pod): N
processes, one a host, each bring up ``torch.distributed`` (gloo) against
``coordinator_address`` / ``num_hosts`` / ``host_rank``
(:func:`multihost_setup`) and build one :class:`PodMesh`: every process's
local shards in (rank, local index) order, so a process's rows are one
contiguous block of the global padded rows (:func:`process_row_span`) that
it loads and bins alone (``data/stream_loader.load_text_multihost``).
Every process keeps the global scores, labels and gradients; its block of
the codes, leaf ids and the split application are its own.  A wave's
histograms are its shards' fixed-point accumulators all-reduced (SUM) across
the processes, staged through pinned host memory on the card (gloo), before
the one conversion: a pod of P processes over D shards is bit-equal to
single-controller over the same D shards.  On the CPU each shard's plain f32
partial is gathered and the partials are summed in global shard order, so
the CPU legs are byte-equal to single-controller too.  After each tree the
processes all-gather their blocks of the score (:meth:`PodMesh.gather_rows`);
the int8 refit's integer leaf sums are all-reduced.  A gloo collective
cannot sit in a CUDA graph, so a pod grower runs the per-piece loop.  A
bring-up failure raises, naming the rank: a process that trained alone
while its peers wait in the reduction would wedge the pod.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.log import LightGBMError, log_info
from .histogram import bucket_size

#: env fallbacks of the multi-controller bring-up parameters (one process a
#: host cannot share a per-rank config edit, so a launcher usually passes
#: the rank and host count in the environment)
ENV_COORDINATOR = "LGBM_TPU_COORDINATOR"
ENV_NUM_HOSTS = "LGBM_TPU_NUM_HOSTS"
ENV_HOST_RANK = "LGBM_TPU_HOST_RANK"


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


# ---------------------------------------------------------------------------
# multi-controller (the pod): one process a host over torch.distributed
# ---------------------------------------------------------------------------

def multihost_params(config=None) -> Optional[Tuple[str, int, int]]:
    """``(coordinator_address, num_hosts, host_rank)`` from the config,
    with the ``LGBM_TPU_COORDINATOR`` / ``LGBM_TPU_NUM_HOSTS`` /
    ``LGBM_TPU_HOST_RANK`` env fallbacks.

    None when none of the three is set anywhere (multi-controller not
    configured); raises :class:`LightGBMError` when the triple is partial
    or malformed: a pod host guessing its rank would train a wrong
    model."""
    coord = str(getattr(config, "coordinator_address", "") or ""
                ) or os.environ.get(ENV_COORDINATOR, "")
    hosts_raw = getattr(config, "num_hosts", 0) or 0
    hosts = int(hosts_raw) or int(os.environ.get(ENV_NUM_HOSTS, "0")
                                  or "0")
    rank_raw = getattr(config, "host_rank", -1)
    rank = int(-1 if rank_raw is None else rank_raw)
    if rank < 0:
        rank = int(os.environ.get(ENV_HOST_RANK, "-1") or "-1")
    if not coord and hosts <= 0 and rank < 0:
        return None
    if not coord or hosts <= 0 or rank < 0:
        raise LightGBMError(
            f"data_sharding=multi_controller needs ALL of "
            f"coordinator_address/num_hosts/host_rank (or the "
            f"{ENV_COORDINATOR}/{ENV_NUM_HOSTS}/{ENV_HOST_RANK} env "
            f"vars); resolved coordinator={coord!r} num_hosts={hosts} "
            f"host_rank={rank}")
    if rank >= hosts:
        raise LightGBMError(
            f"host_rank={rank} out of range for num_hosts={hosts}")
    if ":" not in coord:
        raise LightGBMError(
            f"coordinator_address must be host:port, got {coord!r}")
    return coord, hosts, rank


def _dist():
    import torch.distributed as dist
    return dist


def _group_up() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def multihost_setup(config=None) -> Tuple[int, int]:
    """Fail-fast ``torch.distributed`` bring-up of one pod host; returns
    ``(host_rank, num_hosts)``.  Idempotent: a process whose process group
    is up reports its rank.  Rank 0 hosts the coordinator (the group's TCP
    store) and initializes directly; ranks above 0 first probe it with
    :func:`~lightgbm_tpu_torch.parallel.network.wait_for_peer`
    (``network_timeout`` / ``network_retries``), so a dead coordinator
    surfaces as "peer unreachable after N attempts" instead of a long
    rendezvous hang.  The backend is gloo (host collectives; the card's
    reductions are staged through pinned host memory)."""
    from .. import obs
    dist = _dist()
    if _group_up():
        rank, hosts = int(dist.get_rank()), int(dist.get_world_size())
        obs.set_gauge("shard.hosts", hosts)
        return rank, hosts
    resolved = multihost_params(config)
    if resolved is None:
        raise LightGBMError(
            "data_sharding=multi_controller: no coordinator configured "
            "— set coordinator_address/num_hosts/host_rank (or the "
            "LGBM_TPU_COORDINATOR/LGBM_TPU_NUM_HOSTS/"
            "LGBM_TPU_HOST_RANK env vars)")
    coord, hosts, rank = resolved
    from ..parallel.network import network_policy_from_config, wait_for_peer
    if rank > 0:
        # fail fast with the peer named, before the rendezvous
        wait_for_peer(coord, config=config)
    attempts, timeout_s = network_policy_from_config(config)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}", world_size=hosts,
            rank=rank,
            timeout=timedelta(seconds=max(10, int(attempts * timeout_s))))
    except Exception as e:   # noqa: BLE001 — any bring-up failure
        raise LightGBMError(
            f"torch.distributed bring-up failed for host {rank}/{hosts} "
            f"against coordinator {coord}: {type(e).__name__}: {e}") from e
    got = int(dist.get_world_size())
    if got != hosts:
        raise LightGBMError(
            f"pod bring-up inconsistent: num_hosts={hosts} configured "
            f"but torch.distributed.get_world_size()={got}")
    obs.set_gauge("shard.hosts", hosts)
    log_info(f"multi_controller: host {rank}/{hosts} up against {coord}")
    return rank, hosts


def multihost_shutdown() -> None:
    """Tear the process group down (a pod process's last step: gloo's
    teardown at interpreter exit can abort the process)."""
    if _group_up():
        _dist().destroy_process_group()


def is_multihost() -> bool:
    """Whether this process is one of several of an initialized process
    group (never initializes one)."""
    return _group_up() and int(_dist().get_world_size()) > 1


class PodMesh:
    """The shard mesh of a pod: every process's local shards in (rank,
    local index) order (the JAX package's ``make_pod_mesh`` sorted by
    ``(process_index, device id)``).  ``local`` are this process's shard
    devices, ``counts`` each process's shard count.  ``len()`` is the
    global shard count.  The host-staged collectives of the grower live
    here; each logs ``[verb, bytes, copy ms, collective ms]`` in
    :attr:`comm_log` (:meth:`comm_summary` sums it by verb)."""

    def __init__(self, local: Sequence, counts: Sequence[int], rank: int):
        self.local = [torch.device(d) for d in local]
        self.counts = tuple(int(c) for c in counts)
        self.rank = int(rank)
        if not 0 <= self.rank < len(self.counts) \
                or self.counts[self.rank] != len(self.local):
            raise LightGBMError(f"pod mesh: rank {rank} with "
                                f"{len(self.local)} local shards does not "
                                f"match the shard counts {self.counts}")
        #: one entry a collective: [verb, bytes, the card-host copies' ms
        #: (CUDA events, added once they have completed: at the next
        #: staging or a summary), the collective's ms (host clock)]
        self.comm_log: list = []
        self._unread: list = []     # (entry, copy events) not read yet
        # pinned staging buffers by (shape, dtype), reused every wave (a
        # card-to-host copy into one is stream-ordered after the previous
        # host-to-card copy out of it)
        self._pinned: dict = {}

    def __len__(self) -> int:
        return sum(self.counts)

    @property
    def hosts(self) -> int:
        return len(self.counts)

    @property
    def first(self) -> int:
        """Mesh position of this process's first shard."""
        return sum(self.counts[:self.rank])

    def key(self) -> tuple:
        """What a grower's key records of the mesh."""
        return ("pod", self.rank, self.counts,
                tuple(str(d) for d in self.local))

    # -- host-staged collectives ----------------------------------------
    def _stage(self, t: torch.Tensor):
        """(host tensor, [events]) of ``t``: a CUDA tensor copied into
        pinned host memory between two CUDA events, a CPU one as is."""
        if t.device.type != "cuda":
            return t, []
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        key = (tuple(t.shape), t.dtype)
        host = self._pinned.get(key)
        if host is None:
            host = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype,
                                                   pin_memory=True)
        a.record()
        host.copy_(t, non_blocking=True)
        b.record()
        b.synchronize()
        # every copy queued before this one has completed
        self._read_events()
        return host, [a, b]

    def _unstage(self, host: torch.Tensor, t: torch.Tensor, events) -> None:
        if t.device.type != "cuda":
            if host is not t:
                t.copy_(host)
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t.copy_(host, non_blocking=True)
        b.record()
        events.extend([a, b])

    def _read_events(self) -> None:
        for entry, events in self._unread:
            entry[2] += sum(a.elapsed_time(b)
                            for a, b in zip(events[::2], events[1::2]))
        self._unread = []

    def _collective(self, verb: str, nbytes: int, events, fn) -> None:
        """Run one collective, named with this host on failure, and log
        it."""
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:   # noqa: BLE001 — named, never swallowed
            raise LightGBMError(
                f"pod collective {verb} failed on host {self.rank}/"
                f"{self.hosts}: {type(e).__name__}: {e}") from e
        entry = [verb, int(nbytes), 0.0, (time.perf_counter() - t0) * 1e3]
        self.comm_log.append(entry)
        if events:
            self._unread.append((entry, events))

    def allreduce_(self, t: torch.Tensor, verb: str = "allreduce"
                   ) -> torch.Tensor:
        """Sum ``t`` (an integer tensor: the sum does not depend on the
        order) over the processes, in place; a card tensor goes through
        pinned host memory."""
        dist = _dist()
        host, events = self._stage(t)
        self._collective(verb, host.numel() * host.element_size(), events,
                         lambda: dist.all_reduce(host))
        self._unstage(host, t, events)
        return t

    def gather_shards(self, parts: Sequence[torch.Tensor]) -> list:
        """Every process's local shard partials (equal shapes), in global
        shard order: this process's ``parts`` beside its peers'."""
        dist = _dist()
        width = max(self.counts)
        dev = parts[0].device
        mine = torch.stack([p.to("cpu") for p in parts])
        if len(parts) < width:
            mine = torch.cat([mine, mine.new_zeros(
                (width - len(parts),) + tuple(mine.shape[1:]))])
        outs = [torch.empty_like(mine) for _ in range(self.hosts)]
        self._collective("gather_shards", mine.numel() * mine.element_size(),
                         None, lambda: dist.all_gather(outs, mine))
        return [outs[r][i].to(dev) for r in range(self.hosts)
                for i in range(self.counts[r])]

    def gather_rows(self, block: torch.Tensor, local_rows: int
                    ) -> torch.Tensor:
        """The global padded rows from every process's row block
        (``counts[r] * local_rows`` rows each, this process's
        ``block``): the JAX package's replicate-to-all of a row-sharded
        array."""
        dist = _dist()
        width = max(self.counts) * int(local_rows)
        host, events = self._stage(block.contiguous())
        if host.shape[0] < width:
            host = torch.cat([host, host.new_zeros(
                (width - host.shape[0],) + tuple(host.shape[1:]))])
        outs = [torch.empty_like(host) for _ in range(self.hosts)]
        self._collective("gather_rows", host.numel() * host.element_size(),
                         events, lambda: dist.all_gather(outs, host))
        full = torch.cat([o[:c * int(local_rows)]
                          for o, c in zip(outs, self.counts)])
        out = torch.empty(full.shape, dtype=block.dtype,
                          device=block.device)
        self._unstage(full, out, events)
        return out

    def comm_summary(self, reset: bool = False) -> dict:
        """Per verb: calls, bytes, the host copies' ms (CUDA events) and
        the collectives' ms (host clock)."""
        if self._unread:
            torch.cuda.synchronize()
            self._read_events()
        out = {}
        for verb, nbytes, copy_ms, collective_ms in self.comm_log:
            d = out.setdefault(verb, dict(calls=0, bytes=0, copy_ms=0.0,
                                          collective_ms=0.0))
            d["calls"] += 1
            d["bytes"] += nbytes
            d["copy_ms"] += copy_ms
            d["collective_ms"] += collective_ms
        if reset:
            self.comm_log = []
        return out


def mesh_is_multihost(mesh) -> bool:
    """Whether a mesh spans more than one process."""
    return isinstance(mesh, PodMesh) and mesh.hosts > 1


def pod_local_shards(config, devices: Optional[Sequence] = None
                     ) -> List[torch.device]:
    """This process's shards of a pod: ``devices`` when given, else
    ``shard_devices`` shards (0: one a card) over the process's cards
    (``device_type=cpu``: the CPU), several shards of one card when
    ``shard_devices`` exceeds the cards."""
    if devices is not None:
        local = [torch.device(d) for d in devices]
    else:
        if torch.device(str(getattr(config, "device_type", "cuda")
                            or "cuda")).type == "cpu":
            base = [torch.device("cpu")]
        else:
            base = _devices()
        if not base:
            raise LightGBMError("data_sharding=multi_controller: this "
                                "process has no device to shard on")
        n = int(getattr(config, "shard_devices", 0) or 0) or len(base)
        local = [base[i % len(base)] for i in range(n)]
    if not local:
        raise LightGBMError("data_sharding=multi_controller: no local "
                            "shard")
    return local


def make_pod_mesh(local: Sequence) -> PodMesh:
    """The pod's :class:`PodMesh` over every process's ``local`` shards
    (an all-gather of the shard counts; the process group must be up)."""
    dist = _dist()
    if not _group_up():
        raise LightGBMError("make_pod_mesh: the process group is not up "
                            "(multihost_setup first)")
    counts = [None] * int(dist.get_world_size())
    dist.all_gather_object(counts, len(local))
    mesh = PodMesh(local, counts, int(dist.get_rank()))
    if len(mesh) < 2:
        raise LightGBMError(
            f"data_sharding=multi_controller needs >= 2 global "
            f"devices, have {len(mesh)}")
    return mesh


def process_row_span(mesh: PodMesh, local_rows: int,
                     process_index: Optional[int] = None
                     ) -> Tuple[int, int]:
    """``[lo, hi)`` block of the global padded rows owned by one process
    of a pod mesh with ``local_rows`` rows a shard."""
    pid = mesh.rank if process_index is None else int(process_index)
    if not 0 <= pid < mesh.hosts or mesh.counts[pid] == 0:
        raise LightGBMError(
            f"process {pid} owns no devices of the pod mesh")
    first = sum(mesh.counts[:pid])
    return first * int(local_rows), (first + mesh.counts[pid]) \
        * int(local_rows)


def replicate_to_all(mesh):
    """A function that replicates a value on every shard: over a list
    mesh it puts a tensor on every shard's device (one copy a shard; a
    shard on the tensor's own device shares it); over a :class:`PodMesh`
    it takes this process's row block (``local_rows`` rows a shard) and
    returns the global padded rows, all-gathered from every process."""
    if isinstance(mesh, PodMesh):
        return lambda block, local_rows: mesh.gather_rows(block, local_rows)
    devs = [torch.device(d) for d in mesh]
    return lambda x: [x.to(d) for d in devs]


def host_replicated(mesh, value) -> List[torch.Tensor]:
    """Host data (the same on every shard; on a pod, the caller passes
    the same value in every process) placed on every local shard's
    device."""
    devs = mesh.local if isinstance(mesh, PodMesh) else mesh
    return [torch.as_tensor(value, device=torch.device(d)) for d in devs]


def resolve_shard_mesh(config, devices: Optional[Sequence] = None):
    """The mesh of the configured ``data_sharding`` mode, or None.
    ``single_controller`` with fewer than two devices logs and returns
    None: training goes on unsharded (it is a local optimisation).
    ``multi_controller`` brings the pod up (:func:`multihost_setup`) and
    returns its :class:`PodMesh` over ``devices`` (or
    :func:`pod_local_shards`); any failure raises: a pod host training
    alone while its peers wait in the reduction would wedge the pod."""
    mode = sharding_mode(config)
    if mode == "multi_controller":
        rank, hosts = multihost_setup(config)
        mesh = make_pod_mesh(pod_local_shards(config, devices))
        log_info(f"data_sharding=multi_controller: host {rank}/{hosts}, "
                 f"row-sharding over {len(mesh)} global shard(s), wave "
                 f"histograms all-reduced in fixed point")
        return mesh
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
