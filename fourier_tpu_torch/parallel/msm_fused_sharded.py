"""One MSM split over the ranks of a group.

Port of ``fourier_tpu.parallel.msm_fused_sharded``.  A group is a process
group or the in-process shards of ``mesh.LocalMesh`` (one thread a
device); each rank computes on its own device.  BGMW tables: the
expanded table's flat (window, point) rows T[w * n + i] = 2^(c w) * P_i
are split contiguously over the D ranks.  The window weights are in the
entries, so any slice is a valid shared-bucket MSM: each rank runs the
bucket pass (K1) over its rows into a complete bucket set of partial sums.
The weighted reduction is then paid once, split over the bucket axis
(``sharded_reduce_parts``):

  1. the main region [0, Bpow) goes through ``all_to_all_single``: rank d
     keeps bucket slice d of every rank's set and the tree kernel sums the
     D sets;
  2. the local slice reduces factorised (b = g * H + h): the row sums R_g
     stay local and weigh their high bits by the GLOBAL group index
     d * Gl + g; the column partials are gathered and summed over ranks;
  3. the dynamic region (the signed +2^(c-1) bucket and the split spare
     slots) stays on its rank, its masked bit partial sums reduce locally
     and their residual lanes are gathered;
  4. one replicated K4 over the same [c, R] terms as one card's.

Tableless points are split along the point axis: each rank runs the whole
windowed MSM on its points and the D partial points are gathered and
summed.  On one rank (group None or of size 1) every entry is exactly the
one-device MSM.  A server keeps each shard's table rows on its device and
calls ``msm_fused_bgmw_local`` with them, so no table moves a request.
"""

from __future__ import annotations

import torch

from ..constants import FP_LIMBS
from ..ops import curve as cv
from ..ops import kernels
from ..ops import msm as msm_mod
from ..ops import msm_fused as mf
from ..ops.curve import G1Aff, G1Jac
from .mesh import (all_gather_last, all_to_all_last, local_mesh, make_mesh,  # noqa: F401
                   shard_device, size_rank)


def _stack(p: G1Jac) -> torch.Tensor:
    return torch.stack(tuple(p))


def _unstack(t: torch.Tensor) -> G1Jac:
    return G1Jac(*t.unbind(0))


def _gather_lanes(p: G1Jac, group) -> G1Jac:
    """Every rank's point batch, concatenated along the lane axis."""
    return _unstack(all_gather_last(_stack(p), group))


class ShardSplitError(ValueError):
    """A shard count that cannot split a window's bucket space."""


def check_bucket_split(c: int, signed: bool, D: int) -> None:
    """Raise ShardSplitError (a ValueError), naming D, where D ranks cannot
    split the bucket space of window c: each rank's slice must hold whole
    column groups of the factorised reduction."""
    Bpow = 1 << (c - 1) if signed else 1 << c
    if Bpow % D:
        raise ShardSplitError(f"{D} ranks do not divide the {Bpow} buckets of c = {c}")
    H = 1 << (c // 2)
    if (Bpow // D) % H:
        raise ShardSplitError(f"{D} ranks are too many for c = {c}: a bucket slice of "
                              f"{Bpow // D} must hold whole column groups of {H}")


def sharded_reduce_parts(buckets: G1Jac, weights, c: int, signed: bool, group) -> G1Jac:
    """The bucket exchange and the weighted reduction split over the bucket
    axis (steps 1-3 of the module docstring): [L, Bp] buckets of this rank
    (the main region's weight is its index, the rest carry `weights`) ->
    the [L, c, R] Horner terms, equal on every rank."""
    D, d = group.size, group.rank
    check_bucket_split(c, signed, D)
    Bpow = 1 << (c - 1) if signed else 1 << c
    h_bits = c // 2
    H = 1 << h_bits
    Gl = Bpow // D // H
    dyn = buckets.x.shape[-1] > Bpow

    # 1. exchange the main region and sum the D received sets (one launch
    # with the dynamic region's bit partial sums, which need no exchange)
    recv = _unstack(all_to_all_last(_stack(G1Jac(*(t[..., :Bpow] for t in buckets))),
                                    group))                          # [L, D, Bl]
    trees = [(recv, -2, 1)]
    if dyn:
        spare = G1Jac(*(t[..., Bpow:] for t in buckets))
        trees.append((mf._weighted_partial_leaves(spare, weights[Bpow:], c), -1, 32))
    sums = kernels.g1_tree_reduce(trees)
    local = G1Jac(*(t.squeeze(-2) for t in sums[0]))                  # [L, Bl]

    # 2. factorised reduction of the local slice: rows and column partials
    grid = G1Jac(*(t.reshape(FP_LIMBS, Gl, H) for t in local))
    rows, colp = kernels.g1_tree_reduce([(grid, -1, 1), (grid, -2, 1)])
    rows = G1Jac(*(t.squeeze(-1) for t in rows))                      # [L, Gl]
    colg = _gather_lanes(G1Jac(*(t.squeeze(-2)[..., None] for t in colp)), group)  # [L, H, D]
    g_idx = d * Gl + torch.arange(Gl, device=rows.x.device)
    cols, high_l = kernels.g1_tree_reduce(
        [(colg, -1, 1), (mf._weighted_partial_leaves(rows, g_idx, c - h_bits), -1, 32)])
    cols = G1Jac(*(t.squeeze(-1) for t in cols))                      # [L, H]

    # 3. gather the high bits' and the dynamic region's residual lanes, and
    # fold them with the low bits' trees back to one card's widths
    gathered = [_gather_lanes(high_l, group)]                         # [L, c - h, D * R]
    if dyn:
        gathered.append(_gather_lanes(sums[1], group))                # [L, c, D * R]
    low, high, *dyn_t = kernels.g1_tree_reduce(
        [(msm_mod._bit_partial_leaves(cols, h_bits), -1, 32)] + [(g, -1, 32) for g in gathered])
    r_main = max(low.x.shape[-1], high.x.shape[-1])
    terms = G1Jac(*(torch.cat([a, b], dim=-2)
                    for a, b in zip(mf._pad_lanes(low, r_main), mf._pad_lanes(high, r_main))))
    if dyn:
        terms = G1Jac(*(torch.cat([a, b], dim=-1) for a, b in zip(terms, dyn_t[0])))
    return terms


def _slice_rows(n_rows: int, group) -> slice:
    D, d = group.size, group.rank
    if n_rows % D:
        raise ValueError(f"table rows {n_rows} not divisible by {D} ranks")
    k = n_rows // D
    return slice(d * k, (d + 1) * k)


def msm_fused_bgmw_sharded(packed_table, table_inf, scalars, c: int, group) -> G1Jac:
    """Shared-bucket BGMW MSM with the flat (window, point) table rows split
    over the group's ranks and the bucket reduction paid once across them.
    Every rank passes the whole packed table ([W*n, 24], ``pack_points``
    of ``bgmw_expand``), its infinity mask and the scalars, and reads its
    contiguous slice of rows; the result is equal on every rank."""
    D, d = size_rank(group)
    if D == 1:
        return mf.msm_fused_bgmw(packed_table, table_inf, scalars, c)
    rows = _slice_rows(packed_table.shape[0], group)
    return msm_fused_bgmw_shard(packed_table[rows], table_inf[rows],
                                *shard_digits(scalars, c, packed_table.shape[0], D)[d], c, group)


def shard_digits(scalars, c: int, n_rows: int, D: int) -> list:
    """The BGMW digits (``bgmw_digits_for``) of every row of a table of
    n_rows rows, cut like the rows into D contiguous slices: for each rank,
    (digits, negate flags or None)."""
    digits, neg = mf.bgmw_digits_for(scalars, c, n_rows // scalars.shape[-1])
    k = n_rows // D
    return [(digits[d * k:(d + 1) * k], None if neg is None else neg[d * k:(d + 1) * k])
            for d in range(D)]


def msm_fused_bgmw_shard(packed_rows, inf_rows, digit_rows, neg_rows, c: int,
                         group) -> G1Jac:
    """msm_fused_bgmw_sharded from this rank's own rows: its contiguous
    slice, rank d's d-th of D, of the packed table ([W*n/D, 24]), of its
    infinity mask and of the rows' digits (``shard_digits``).  The table
    rows of a server's shard already live on its device; what does not
    comes to it.  Computing the digits once for all ranks spares each the
    digits of every row."""
    dev = shard_device(group, packed_rows.device)
    buckets, weights = mf.bgmw_buckets_from_digits(
        packed_rows.to(dev), inf_rows.to(dev), digit_rows.to(dev), c,
        None if neg_rows is None else neg_rows.to(dev))
    terms = sharded_reduce_parts(buckets, weights, c, neg_rows is not None, group)
    return msm_mod._horner_2k(terms)


def msm_fused_bgmw_local(mesh, rows, scalars, c: int) -> G1Jac:
    """The BGMW MSM over the shards of a ``mesh.LocalMesh``, each holding
    its slice of the table, rows[d] = (packed rows, infinity mask) on
    shard d's device (``PianoPrecompute.shard_rows``): the digits once,
    each shard's slice sent to its device before any shard launches (a
    copy runs on its source device's stream, where it would otherwise
    wait for the first shard's kernels), then every shard's part; the
    result on the first shard's device."""
    digits = [tuple(None if t is None else t.to(dev) for t in part) for part, dev in
              zip(shard_digits(scalars, c, sum(r[0].shape[0] for r in rows), mesh.size),
                  mesh.devices)]
    return mesh.run(lambda shard: msm_fused_bgmw_shard(*rows[shard.rank], *digits[shard.rank],
                                                       c, shard))[0]


def msm_bgmw_sharded(table: G1Aff, scalars, c: int, group) -> G1Jac:
    """The plain twin of msm_fused_bgmw_sharded over an affine BGMW table:
    unsigned digits over the whole 2^c bucket space, each rank's buckets
    summed by K1's plain twin over whole runs, then the same exchange and
    reduction.  As in the fused form, a rank's rows may start or end inside
    a window."""
    if size_rank(group)[0] == 1:
        return mf.msm_fused_bgmw(mf.pack_points(table), table.inf, scalars, c)
    WN = table.x.shape[-1]
    rows = _slice_rows(WN, group)
    dev = shard_device(group, table.x.device)
    inf = table.inf[rows].to(dev)
    digits = msm_mod._all_window_digits(scalars.to(dev), c,
                                        WN // scalars.shape[-1]).reshape(-1)
    digits = torch.where(inf, 0, digits[rows])
    index, start, count, weights = mf._sorted_runs(digits, inf.to(torch.int64), 1 << c,
                                                   cap=digits.shape[0], spare=0)
    packed = mf.pack_points(G1Aff(table.x[:, rows].to(dev), table.y[:, rows].to(dev), inf))
    buckets = kernels.accumulate_plain(packed, index, start, count)
    return msm_mod._horner_2k(sharded_reduce_parts(buckets, weights, c, False, group))


def msm_fused_sharded(points: G1Aff, scalars, c: int, group) -> G1Jac:
    """Tableless MSM with the points split over the ranks: each rank runs
    the whole windowed MSM on its points; the partials are gathered and
    summed (the tree kernel), equal on every rank."""
    if size_rank(group)[0] == 1:
        return mf.msm_fused(points, scalars, c)
    return point_split_msm(points, scalars, group, lambda p, s: mf.msm_fused(p, s, c))


def point_split_msm(points: G1Aff, scalars, group, local_msm) -> G1Jac:
    """local_msm(points, scalars) over this rank's contiguous slice of the
    n points, moved to its device; the D partial points gathered and summed
    by the tree kernel, equal on every rank."""
    n = points.x.shape[-1]
    if n % group.size:
        raise ValueError(f"n = {n} not divisible by {group.size} ranks")
    pts = _slice_rows(n, group)
    dev = shard_device(group, points.x.device)
    part = local_msm(G1Aff(points.x[:, pts].to(dev), points.y[:, pts].to(dev),
                           points.inf[pts].to(dev)), scalars[:, pts].to(dev))
    parts = _gather_lanes(G1Jac(*(t[:, None] for t in part)), group)     # [L, D]
    return cv.tree_reduce_axis(parts, -1)


# local_mesh (imported from mesh) is the reference's: the in-process shards
# of the local devices, None where there is one.  local_group: the group of
# every process, None where there is one process.
local_group = make_mesh
