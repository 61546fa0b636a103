"""The tableless MSM with its point axis split over the ranks of a group.

Port of ``fourier_tpu.parallel.msm_sharded``: each rank runs the whole
windowed MSM (``msm_naive`` where its shard has at most 64 points) on its
contiguous slice of the points, and the D partial points are gathered and
summed by the tree kernel on every rank.  Communication is D points,
compute n / D points a rank.  The group is a process group or the
in-process shards of ``mesh.LocalMesh``; None is one device.
"""

from __future__ import annotations

from ..ops import msm as msm_mod
from ..ops import msm_fused as mf
from ..ops.curve import G1Aff, G1Jac
from .mesh import size_rank
from .msm_fused_sharded import point_split_msm


def msm_sharded(points: G1Aff, scalars, group, window: int = 0) -> G1Jac:
    """sum_i scalars[i] * points[i] with the i axis split over the group.

    points: G1Aff [L, n]; scalars: int64 [FR_LIMBS, n] canonical; n must be
    divisible by the group's size (ValueError otherwise).  window 0 takes
    ``msm._auto_window`` of the shard's n / D points.  Returns one point
    ([L] coordinates), equal on every rank."""
    D, _ = size_rank(group)
    n = points.x.shape[-1]
    if n % D:
        raise ValueError(f"n={n} not divisible by mesh axis size {D}")

    def local(p: G1Aff, s) -> G1Jac:
        k = p.x.shape[-1]
        if k <= 64:
            return msm_mod.msm_naive(p, s)
        return mf.msm_fused(p, s, window or msm_mod._auto_window(k))

    return local(points, scalars) if D == 1 else point_split_msm(points, scalars, group, local)
