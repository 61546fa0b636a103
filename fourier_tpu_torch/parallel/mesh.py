"""Groups of shards and the collectives the parallel paths use.

The counterpart of ``fourier_tpu.parallel.mesh.make_mesh`` and of
``fourier_tpu.parallel.msm_fused_sharded.local_mesh``.  A group has a
``size`` and a ``rank``, and comes in two kinds:

- ``Group``: a torch.distributed process group, one process a rank.
  Tensors sent through it live on the rank's own card (NCCL) or on the
  CPU (gloo).
- ``LocalShard``: one shard of a ``LocalMesh``, the shards of one process
  over a list of devices (a device may repeat).  ``LocalMesh.run`` calls a
  function once per shard, each in its own thread with its device
  current.  The collectives meet at a barrier, then every receiver copies
  what it needs onto its own device, and no shard goes on before all have
  (a second barrier).  Such a copy runs on the source device's current
  stream, which is the stream its shard launched on (no shard thread sets
  another), so it follows the work that made the data, and comes before
  any the source shard launches after the collective.
  The shards take turns on the host, one running at a time and the turn
  passing at each collective: their host side is torch calls from Python,
  which free-running threads would only contend for (on four H100 cards,
  four such threads spent ~60 ms of a BGMW MSM at 2^19 points waiting for
  the interpreter lock; PERF.md), while their launches are asynchronous,
  so the cards still compute at once.

``all_gather_last`` and ``all_to_all_last`` take either kind.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch
import torch.distributed as dist

# A shard that waits at a collective longer than this fails the call (the
# counterpart of the process groups' collective timeout).
SHARD_TIMEOUT_S = 600.0


class Group(NamedTuple):
    pg: object          # the torch.distributed process group
    size: int
    rank: int           # -1 where this process is not a member


def make_mesh(n_ranks: int | None = None) -> Group | None:
    """The default process group, or the subgroup of its first n_ranks
    ranks (every process must call this: creating a subgroup is
    collective).  None where there is one process (torch.distributed not
    initialised, or a world of one) and one rank was asked for: every
    entry of the package runs a None group in process, with no
    collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 and n_ranks in (None, 1):
        return None
    if not dist.is_initialized():
        raise ValueError(f"requested {n_ranks} ranks, but torch.distributed is not "
                         "initialised")
    n = world if n_ranks is None else n_ranks
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} ranks, have {world}")
    if n == world:
        return Group(dist.group.WORLD, world, dist.get_rank())
    pg = dist.new_group(list(range(n)))
    return Group(pg, n, dist.get_rank(pg))


class LocalShard(NamedTuple):
    mesh: "LocalMesh"
    size: int
    rank: int
    device: torch.device


class LocalMesh:
    """The shards of one process, one a device of `devices`.  The
    counterpart of a mesh over the local devices: ``run(fn)`` is one SPMD
    step, fn(shard) called for every shard at once.  One step runs at a
    time."""

    def __init__(self, devices, timeout_s: float = SHARD_TIMEOUT_S):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.timeout_s = timeout_s
        self._barrier = threading.Barrier(self.size, timeout=timeout_s)
        self._slots: list = [None] * self.size
        self._step = threading.Lock()
        self._turn = threading.Lock()

    def shard(self, rank: int) -> LocalShard:
        return LocalShard(self, self.size, rank, self.devices[rank])

    def run(self, fn) -> list:
        """[fn(shard 0), ..., fn(shard D - 1)], each called in its own
        thread with its shard's device current.  A shard that raises
        breaks the barrier, so the others leave their collectives at once;
        the call then raises that shard's exception (TimeoutError where a
        collective timed out) after every thread has ended."""
        results, errors = [None] * self.size, [None] * self.size

        def body(rank):
            try:
                with self._turn, _current_device(self.devices[rank]):
                    results[rank] = fn(self.shard(rank))
            except BaseException as e:          # handed to the caller below
                errors[rank] = e
                self._barrier.abort()

        with self._step:
            threads = [threading.Thread(target=body, args=(r,), name=f"shard-{r}")
                       for r in range(self.size)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            self._slots = [None] * self.size
            if self._barrier.broken:
                self._barrier.reset()
        raised = [e for e in errors if e is not None]
        first = next((e for e in raised if not isinstance(e, threading.BrokenBarrierError)),
                     None)
        if first is not None:
            raise first
        if raised:
            raise TimeoutError(f"a collective of {self.size} shards waited over "
                               f"{self.timeout_s} s")
        return results

    def _exchange(self, rank: int, t: torch.Tensor, take) -> list:
        """take(t of shard j) for every shard j, once all have arrived; the
        second wait keeps a slot until every shard has taken its part, and
        keeps every shard's copies ahead of the next work on their source
        devices."""
        self._slots[rank] = t
        self._wait()
        got = [take(p) for p in self._slots]
        self._wait()
        return got

    def _wait(self):
        self._turn.release()
        try:
            self._barrier.wait()
        finally:
            self._turn.acquire()


def _current_device(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def local_mesh(devices=None) -> LocalMesh | None:
    """A LocalMesh over `devices` (default: every visible card), or None
    where the list has fewer than two entries (the reference's local_mesh
    over jax.devices())."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return LocalMesh(devices) if len(devices) > 1 else None


def size_rank(group) -> tuple[int, int]:
    return (1, 0) if group is None else (group.size, group.rank)


def shard_device(group, default) -> torch.device:
    """The device a shard computes on: a LocalShard's own, else `default`
    (a process's tensors already live on its rank's device)."""
    return group.device if isinstance(group, LocalShard) else torch.device(default)


def all_gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t (one shape on all ranks), concatenated along the last
    axis in rank order."""
    t = t.contiguous()
    if isinstance(group, LocalShard):
        parts = group.mesh._exchange(group.rank, t, lambda p: p.to(group.device))
        return torch.cat(parts, dim=-1)
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t, group=group.pg)
    return torch.cat(parts, dim=-1)


def all_to_all_last(t: torch.Tensor, group) -> torch.Tensor:
    """[..., D * k] on every rank -> [..., D, k]: slice d of the last axis
    goes to rank d, and row j of the result is the slice rank j sent."""
    D = group.size
    k = t.shape[-1] // D
    if isinstance(group, LocalShard):
        lo = group.rank * k
        parts = group.mesh._exchange(group.rank, t,
                                     lambda p: p[..., lo:lo + k].to(group.device))
        return torch.stack(parts, dim=-2)
    send = t.reshape(t.shape[:-1] + (D, k)).movedim(-2, 0).contiguous()   # [D, ..., k]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group.pg)
    return recv.movedim(0, -2)
