"""One MSM split over the ranks of a group.

Port of ``fourier_tpu.parallel.msm_fused_sharded``.  BGMW tables: the
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
one-device MSM.
"""

from __future__ import annotations

import torch

from ..constants import FP_LIMBS
from ..ops import curve as cv
from ..ops import kernels
from ..ops import msm as msm_mod
from ..ops import msm_fused as mf
from ..ops.curve import G1Aff, G1Jac
from .mesh import Group, all_gather_last, all_to_all_last, make_mesh, size_rank


def _stack(p: G1Jac) -> torch.Tensor:
    return torch.stack(tuple(p))


def _unstack(t: torch.Tensor) -> G1Jac:
    return G1Jac(*t.unbind(0))


def _gather_lanes(p: G1Jac, group: Group) -> G1Jac:
    """Every rank's point batch, concatenated along the lane axis."""
    return _unstack(all_gather_last(_stack(p), group))


def sharded_reduce_parts(buckets: G1Jac, weights, c: int, signed: bool,
                         group: Group) -> G1Jac:
    """The bucket exchange and the weighted reduction split over the bucket
    axis (steps 1-3 of the module docstring): [L, Bp] buckets of this rank
    (the main region's weight is its index, the rest carry `weights`) ->
    the [L, c, R] Horner terms, equal on every rank."""
    D, d = group.size, group.rank
    Bpow = 1 << (c - 1) if signed else 1 << c
    if Bpow % D:
        raise ValueError(f"{D} ranks do not divide the {Bpow} buckets of c = {c}")
    h_bits = c // 2
    H = 1 << h_bits
    Bl = Bpow // D
    if Bl % H:
        raise ValueError(f"{D} ranks are too many for c = {c}: a bucket slice of {Bl} "
                         f"must hold whole column groups of {H}")
    Gl = Bl // H
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


def _slice_rows(n_rows: int, group: Group) -> slice:
    D, d = group.size, group.rank
    if n_rows % D:
        raise ValueError(f"table rows {n_rows} not divisible by {D} ranks")
    k = n_rows // D
    return slice(d * k, (d + 1) * k)


def msm_fused_bgmw_sharded(packed_table, table_inf, scalars, c: int,
                           group: Group | None) -> G1Jac:
    """Shared-bucket BGMW MSM with the flat (window, point) table rows split
    over the group's ranks and the bucket reduction paid once across them.
    Every rank passes the whole packed table ([W*n, 24], ``pack_points``
    of ``bgmw_expand``), its infinity mask and the scalars, and reads its
    contiguous slice of rows; the result is equal on every rank."""
    if size_rank(group)[0] == 1:
        return mf.msm_fused_bgmw(packed_table, table_inf, scalars, c)
    WN = packed_table.shape[0]
    rows = _slice_rows(WN, group)
    digits_flat, neg_flat = mf.bgmw_digits_for(scalars, c, WN // scalars.shape[-1])
    buckets, weights = mf.bgmw_buckets_from_digits(
        packed_table[rows], table_inf[rows], digits_flat[rows], c,
        None if neg_flat is None else neg_flat[rows])
    terms = sharded_reduce_parts(buckets, weights, c, neg_flat is not None, group)
    return msm_mod._horner_2k(terms)


def msm_bgmw_sharded(table: G1Aff, scalars, c: int, group: Group | None) -> G1Jac:
    """The plain twin of msm_fused_bgmw_sharded over an affine BGMW table:
    unsigned digits over the whole 2^c bucket space, each rank's buckets
    summed by K1's plain twin over whole runs, then the same exchange and
    reduction.  As in the fused form, a rank's rows may start or end inside
    a window."""
    if size_rank(group)[0] == 1:
        return mf.msm_fused_bgmw(mf.pack_points(table), table.inf, scalars, c)
    WN = table.x.shape[-1]
    rows = _slice_rows(WN, group)
    inf = table.inf[rows]
    digits = msm_mod._all_window_digits(scalars, c, WN // scalars.shape[-1]).reshape(-1)
    digits = torch.where(inf, 0, digits[rows])
    index, start, count, weights = mf._sorted_runs(digits, inf.to(torch.int64), 1 << c,
                                                   cap=digits.shape[0], spare=0)
    packed = mf.pack_points(G1Aff(table.x[:, rows], table.y[:, rows], inf))
    buckets = kernels.accumulate_plain(packed, index, start, count)
    return msm_mod._horner_2k(sharded_reduce_parts(buckets, weights, c, False, group))


def msm_fused_sharded(points: G1Aff, scalars, c: int, group: Group | None) -> G1Jac:
    """Tableless MSM with the points split over the ranks: each rank runs
    the whole windowed MSM on its points; the partials are gathered and
    summed (the tree kernel), equal on every rank."""
    if size_rank(group)[0] == 1:
        return mf.msm_fused(points, scalars, c)
    n = points.x.shape[-1]
    if n % group.size:
        raise ValueError(f"n = {n} not divisible by {group.size} ranks")
    pts = _slice_rows(n, group)
    part = mf.msm_fused(G1Aff(points.x[:, pts], points.y[:, pts], points.inf[pts]),
                        scalars[:, pts], c)
    parts = _gather_lanes(G1Jac(*(t[:, None] for t in part)), group)     # [L, D]
    return cv.tree_reduce_axis(parts, -1)


# the reference's local_mesh: the group of every process, None where there is one
local_group = make_mesh
