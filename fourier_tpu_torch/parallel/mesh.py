"""Process groups and the collectives the parallel paths use.

The counterpart of ``fourier_tpu.parallel.mesh.make_mesh``: a ``Group``
is a torch.distributed process group with its size and this process's
rank in it.  Tensors sent through a group live on the rank's own card
(NCCL) or on the CPU (gloo).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


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


def size_rank(group: Group | None) -> tuple[int, int]:
    return (1, 0) if group is None else (group.size, group.rank)


def all_gather_last(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's t (one shape on all ranks), concatenated along the last
    axis in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t, group=group.pg)
    return torch.cat(parts, dim=-1)


def all_to_all_last(t: torch.Tensor, group: Group) -> torch.Tensor:
    """[..., D * k] on every rank -> [..., D, k]: slice d of the last axis
    goes to rank d, and row j of the result is the slice rank j sent."""
    D = group.size
    k = t.shape[-1] // D
    send = t.reshape(t.shape[:-1] + (D, k)).movedim(-2, 0).contiguous()   # [D, ..., k]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group.pg)
    return recv.movedim(0, -2)
