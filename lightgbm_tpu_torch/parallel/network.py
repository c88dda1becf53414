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

The socket half (the JAX module's, ported as written) is the host-blob
plane of the multi-controller pod, one process a host: a TCP connect with
bounded retries (:func:`connect_with_retries`, :func:`wait_for_peer`, the
probe of the ``torch.distributed`` coordinator before bring-up),
length-prefixed sends and receives with a per-operation timeout, and
:func:`broadcast_blob`, rank 0's payload to every peer on the
coordinator's port plus one (the mapper reference and the layout
handshake of the pod's streamed load).  Every operation is bounded by
``network_timeout`` / ``network_retries`` and fails with its peer named,
never hangs; the fault sites are ``net.connect``, ``net.send``,
``net.recv`` and ``net.broadcast``.
"""

from __future__ import annotations

import functools
import socket
import struct
import time
from typing import List, Optional, Sequence

import torch

from .. import obs
from ..robust import faults
from ..robust.retry import RetryError, RetryPolicy, with_retries
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


# ---------------------------------------------------------------------------
# fault-tolerant point-to-point helpers (the host-blob plane)
# ---------------------------------------------------------------------------
# The collectives of a pod are torch.distributed's (gloo), but the bring-up
# and the ingest handshake ride plain TCP: the coordinator probe, and the
# serialized mapper reference a host needs before it can bin its rows.
# The reference blocks forever on a dead peer (linkers_socket.cpp
# Construct/Recv); these helpers bound every operation with a timeout and
# give connects capped-backoff retries, so a missing worker fails the pod
# fast and with context.

DEFAULT_NETWORK_TIMEOUT_S = 30.0
DEFAULT_NETWORK_RETRIES = 5
#: recv_bytes length-prefix bound: a corrupt peer gets a bounded protocol
#: error, never a giant allocation
MAX_MESSAGE_BYTES = 1 << 30

_LEN_PREFIX = struct.Struct("<Q")


def connect_with_retries(host: str, port: int, *,
                         attempts: Optional[int] = None,
                         timeout_s: Optional[float] = None,
                         base_delay_s: float = 0.1,
                         config=None, sleep=time.sleep) -> socket.socket:
    """TCP connect with ``attempts`` bounded tries and capped exponential
    backoff; raises "peer unreachable after N attempts"
    (:class:`LightGBMError`) instead of hanging.  The returned socket keeps
    ``timeout_s`` as its per-operation timeout.  Explicit arguments win,
    then ``config``'s ``network_retries`` / ``network_timeout``, then the
    defaults."""
    cfg_attempts, cfg_timeout = network_policy_from_config(config)
    if attempts is None:
        attempts = cfg_attempts
    if timeout_s is None:
        timeout_s = cfg_timeout
    attempts = max(int(attempts), 1)

    def attempt():
        faults.check("net.connect")
        return socket.create_connection((host, int(port)),
                                        timeout=float(timeout_s))

    policy = RetryPolicy(max_attempts=attempts,
                         base_delay_s=float(base_delay_s),
                         max_delay_s=2.0,
                         retry_on=(OSError, faults.InjectedFault))
    try:
        sock = with_retries(attempt, policy, site="net.connect",
                            sleep=sleep)
    except RetryError as e:
        raise LightGBMError(
            f"peer {host}:{port} unreachable after {attempts} "
            f"attempt{'s' if attempts != 1 else ''} (last error: "
            f"{e.__cause__!r}); check the machine list / coordinator "
            f"address and that the peer process is up") from e
    sock.settimeout(float(timeout_s))
    return sock


def wait_for_peer(address: str, *, attempts: Optional[int] = None,
                  timeout_s: Optional[float] = None,
                  base_delay_s: float = 0.1, config=None,
                  sleep=time.sleep) -> None:
    """Probe a ``host:port`` peer (the ``torch.distributed`` coordinator)
    until it accepts a connection, then close it: called before
    ``init_process_group`` so a dead or mistyped coordinator fails fast
    with this error instead of stalling inside the rendezvous."""
    host, _, port = str(address).rpartition(":")
    if not host or not port.isdigit():
        raise LightGBMError(
            f"bad peer address {address!r} (expected host:port)")
    sock = connect_with_retries(host, int(port), attempts=attempts,
                                timeout_s=timeout_s,
                                base_delay_s=base_delay_s,
                                config=config, sleep=sleep)
    sock.close()


def _netop(sock: socket.socket, site: str, timeout_s: Optional[float],
           fn, what: str):
    """Shared wrapper of send/recv: the fault site, an optional per-op
    timeout, timeout and OS errors re-raised with the peer named."""
    faults.check(site)
    if timeout_s is not None:
        sock.settimeout(float(timeout_s))
    try:
        return fn()
    except socket.timeout as e:
        peer = _peer_name(sock)
        raise LightGBMError(
            f"network timeout {what} {peer} (after "
            f"{sock.gettimeout():g} s); peer dead or partitioned — "
            f"the mesh should be rebuilt") from e
    except OSError as e:
        peer = _peer_name(sock)
        raise LightGBMError(f"network error {what} {peer}: {e}") from e


def _peer_name(sock: socket.socket) -> str:
    try:
        addr = sock.getpeername()
    except OSError:
        return "peer <unknown>"
    if isinstance(addr, tuple) and len(addr) >= 2:
        return f"peer {addr[0]}:{addr[1]}"
    return f"peer {addr!r}"     # AF_UNIX etc.


class _ClosedUnanswered(LightGBMError):
    """The peer closed (or reset) the connection before it took a message
    or before the first byte of its reply."""


def send_bytes(sock: socket.socket, payload: bytes,
               timeout_s: Optional[float] = None) -> None:
    """Length-prefixed blocking send with a bounded timeout (the
    reference's ``Linkers::Send`` had none)."""
    def run():
        try:
            sock.sendall(_LEN_PREFIX.pack(len(payload)))
            sock.sendall(payload)
        except (BrokenPipeError, ConnectionResetError) as e:
            raise _ClosedUnanswered(
                f"connection closed by {_peer_name(sock)} before the "
                f"message was sent: {e}") from e
    _netop(sock, "net.send", timeout_s, run, "sending to")


def recv_bytes(sock: socket.socket,
               timeout_s: Optional[float] = None) -> bytes:
    """Length-prefixed blocking receive with a bounded timeout; a peer
    closing mid-message raises instead of returning a short read."""
    first = [True]

    def read_exact(n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            # cap each request so a large n never asks for one giant
            # buffer
            try:
                chunk = sock.recv(min(n - len(buf), 1 << 20))
            except ConnectionResetError as e:
                if first[0] and not buf:
                    raise _ClosedUnanswered(
                        f"connection reset by {_peer_name(sock)} before "
                        f"a reply") from e
                raise
            if not chunk:
                kind = _ClosedUnanswered if first[0] and not buf \
                    else LightGBMError
                raise kind(
                    f"connection closed by {_peer_name(sock)} "
                    f"mid-message ({len(buf)}/{n} bytes)")
            first[0] = False
            buf.extend(chunk)
        return bytes(buf)

    def run():
        (length,) = _LEN_PREFIX.unpack(read_exact(_LEN_PREFIX.size))
        if length > MAX_MESSAGE_BYTES:
            raise LightGBMError(
                f"{_peer_name(sock)} announced a {length}-byte message "
                f"(limit {MAX_MESSAGE_BYTES}); corrupt length prefix "
                f"or protocol mismatch")
        return read_exact(length)
    return _netop(sock, "net.recv", timeout_s, run, "receiving from")


def network_policy_from_config(config):
    """(attempts, timeout_s) from a Config's ``network_retries`` /
    ``network_timeout`` (the defaults otherwise)."""
    return (int(getattr(config, "network_retries",
                        DEFAULT_NETWORK_RETRIES)),
            float(getattr(config, "network_timeout",
                          DEFAULT_NETWORK_TIMEOUT_S)))


# ---------------------------------------------------------------------------
# the pod's blob broadcast (rank 0 -> every peer)
# ---------------------------------------------------------------------------
# The mapper reference a pod host needs before it can bin its rows cannot
# ride a collective of the training mesh (it does not exist yet), so the
# ingest handshake rides the length-prefixed plane above: rank 0 serves the
# payload on the coordinator's port + 1, every peer dials it with the
# coordinator probe's retry and timeout policy.  Rounds are sequenced:
# every process calls broadcast_blob the same number of times in the same
# order, so one port serves any number of rounds.  A peer already served
# that dials for the next round while rank 0 still serves this one (the
# JAX package answers it this round's payload again) is closed unanswered,
# or reset when it waits in the backlog of a round's closing endpoint,
# and redials until the round's deadline.

#: offset from the coordinator's port to the blob broadcast port (rank 0's
#: torch.distributed store owns the coordinator's port)
BROADCAST_PORT_OFFSET = 1


def pod_broadcast_address(coordinator_address: str) -> str:
    """``host:port`` of the blob broadcast endpoint derived from the
    coordinator address."""
    host, _, port = str(coordinator_address).rpartition(":")
    if not host or not port.isdigit():
        raise LightGBMError(
            f"bad coordinator address {coordinator_address!r} "
            f"(expected host:port)")
    return f"{host}:{int(port) + BROADCAST_PORT_OFFSET}"


def broadcast_blob(payload: Optional[bytes], *, address: str,
                   num_hosts: int, rank: int, config=None) -> bytes:
    """One broadcast round: rank 0 sends ``payload`` to every peer and
    returns it; peers pass ``payload=None`` and return the received bytes.
    Fail-fast on both sides: rank 0 bounds its accept loop by the
    ``network_timeout``-derived deadline and names the ranks that never
    dialed in; peers ride :func:`connect_with_retries`, so a dead rank 0
    surfaces as "peer unreachable after N attempts"."""
    faults.check("net.broadcast")
    attempts, timeout_s = network_policy_from_config(config)
    host, _, port = str(address).rpartition(":")
    if not host or not port.isdigit():
        raise LightGBMError(
            f"bad broadcast address {address!r} (expected host:port)")
    port = int(port)
    num_hosts = int(num_hosts)
    if int(rank) != 0:
        deadline = time.monotonic() + max(10.0, attempts * timeout_s)
        while True:
            sock = connect_with_retries(host, port, config=config)
            try:
                send_bytes(sock, struct.pack("<i", int(rank)),
                           timeout_s=timeout_s)
                blob = recv_bytes(sock, timeout_s=timeout_s)
                break
            except _ClosedUnanswered:
                # rank 0 still serves the previous round
                if time.monotonic() >= deadline:
                    raise
            finally:
                sock.close()
            time.sleep(0.05)
        obs.inc("net.broadcast_bytes", len(blob))
        return blob
    if payload is None:
        raise LightGBMError("broadcast_blob: rank 0 must supply the "
                            "payload")
    deadline = time.monotonic() + max(10.0, attempts * timeout_s)
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    pending = set(range(1, num_hosts))
    try:
        try:
            # peers dial the coordinator's host name; rank 0 accepts on
            # every interface, so "localhost" and the public name both land
            server.bind(("", port))
        except OSError as e:
            raise LightGBMError(
                f"broadcast endpoint {address} unavailable on host 0: "
                f"{e}") from e
        server.listen(max(num_hosts, 1))
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise LightGBMError(
                    f"pod broadcast on {address}: host(s) "
                    f"{sorted(pending)} never connected within the "
                    f"network_timeout budget — peer dead at ingest "
                    f"bring-up")
            server.settimeout(min(remaining, 1.0))
            try:
                conn, _addr = server.accept()
            except socket.timeout:
                continue
            try:
                (peer_rank,) = struct.unpack(
                    "<i", recv_bytes(conn, timeout_s=timeout_s))
                if peer_rank in pending:
                    send_bytes(conn, payload, timeout_s=timeout_s)
            finally:
                conn.close()
            pending.discard(peer_rank)
    finally:
        server.close()
    obs.inc("net.broadcast_bytes", len(payload))
    return payload


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
