"""Window digits, bucket-sum helpers, the Horner combine, the tableless
MSM entry points (``msm``, ``msm_naive``) and the fixed-base MSMs of setup
and precompute.

Port of ``fourier_tpu.ops.msm``.  Scalars are canonical (non-Montgomery)
Fr limbs, int64 ``[16, n]``.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..constants import FP_LIMBS, LIMB_BITS
from ..refimpl.curve import g1_add, g1_mul

from . import curve as cv
from . import kernels
from .curve import G1Aff, G1Jac


def _all_window_digits(scalars, c: int, n_windows: int):
    """[FR_LIMBS, n] canonical limbs -> [n_windows, n] int64 c-bit digits."""
    out = []
    for w in range(n_windows):
        lo = w * c
        limb = lo // LIMB_BITS
        off = lo % LIMB_BITS
        d = scalars[limb] >> off
        if off + c > LIMB_BITS and limb + 1 < scalars.shape[0]:
            d = d | (scalars[limb + 1] << (LIMB_BITS - off))
        out.append(d & ((1 << c) - 1))
    return torch.stack(out)


def _bit_partial_leaves(buckets: G1Jac, c: int) -> G1Jac:
    """[L, B] buckets -> the [L, c, B] leaves of their bit partial sums:
    row j holds bucket b where bit j of b is set and the identity (z = 0)
    elsewhere; x and y are broadcast views.  Reduced over B to R <= 32
    residual lanes, row j sums to S_j = sum over b with bit j set of B_b,
    and sum_b b * B_b = sum_j 2^j S_j."""
    n_buckets = buckets.x.shape[-1]
    c_eff = max(c, 1)
    idx = torch.arange(n_buckets, device=buckets.x.device)
    bits = torch.arange(c_eff, device=buckets.x.device)
    masks = ((idx[None, :] >> bits[:, None]) & 1).bool()          # [c, B]
    shape = (FP_LIMBS, c_eff, n_buckets)
    bz = torch.where(masks[None], buckets.z[:, None, :], 0)       # z=0: identity
    return G1Jac(buckets.x[:, None, :].expand(shape), buckets.y[:, None, :].expand(shape), bz)


def _horner_2k(terms: G1Jac) -> G1Jac:
    """sum over k and r of 2^k * terms[:, k, r] for [L, K, R] terms;
    returns the single point ([L] coordinates).  One K4 launch folds each
    term's R residual lanes, weights the folded terms and sums them."""
    L, K, R = terms.x.shape
    out = kernels.horner_2k(G1Jac(*(c.reshape(L, K * R) for c in terms)), width=R)
    return G1Jac(*(c[..., 0] for c in out))


def _auto_window(n: int) -> int:
    """The reference's tableless window: many buckets, few fat runs."""
    return max(6, min(13, n.bit_length() - 4))


def msm(points: G1Aff, scalars) -> G1Jac:
    """Tableless Pippenger MSM sum_i scalars[i] * points[i] for an [L, n]
    affine batch; returns one Jacobian point ([L] coordinates)."""
    from .msm_fused import msm_fused

    return msm_fused(points, scalars, _auto_window(points.x.shape[-1]))


def _bit_length(scalars) -> int:
    """Bits of the largest of [FR_LIMBS, ...] canonical scalars."""
    nonzero = torch.nonzero((scalars != 0).reshape(scalars.shape[0], -1).any(dim=1))
    if nonzero.numel() == 0:
        return 0
    top = int(nonzero[-1, 0])
    return top * LIMB_BITS + int(scalars[top].max()).bit_length()


def msm_naive(points: G1Aff, scalars) -> G1Jac:
    """The MSM of tiny n: every lane runs double-and-add on its own point
    from the scalars' top bit down (one K5 ladder launch: a doubling and a
    mixed add of the affine point where the bit is set, a bit), then one
    tree sum, a K2 launch a level.  Points [L, ..., n] and scalars
    [FR_LIMBS, ..., n] with leading batch axes give one MSM each, in the
    same launches."""
    acc = kernels.g1_madd_ladder(points, scalars, _bit_length(scalars))
    out = cv.halving_tree(acc, -1, 1, add=cv.add_fast)
    return G1Jac(*(c[..., 0] for c in out))


# -- fixed-base MSM (trusted-setup generation) ------------------------------------

@lru_cache(maxsize=4)
def _fixed_base_rows(base_point, c: int) -> tuple:
    """Host rows of the fixed-base table: row w * 2^c + d is
    (d << (c * w)) * base (None for d = 0)."""
    rows = []
    for w in range(-(-256 // c)):
        step = g1_mul(base_point, 1 << (c * w))
        entry = None
        for _ in range(1 << c):
            rows.append(entry)
            entry = g1_add(entry, step)
    return tuple(rows)


def fixed_base_table(base_point, c: int = 8, device="cpu") -> G1Aff:
    """Affine table T[w * 2^c + d] = (d << (c * w)) * base."""
    return cv.affine_from_ints(_fixed_base_rows(base_point, c), device)


def fixed_base_msm(base_point, scalars, c: int = 8) -> G1Jac:
    """[d_i * base for each scalar d_i] as a Jacobian batch [L, n]."""
    table = fixed_base_table(base_point, c, scalars.device)
    return _fixed_base_apply(table, scalars, c)


def _fixed_base_apply(table: G1Aff, scalars, c: int) -> G1Jac:
    """One K1 launch: lane i's run is its W window rows, in window order."""
    from .msm_fused import pack_points

    n = scalars.shape[-1]
    n_windows = -(-256 // c)
    digits = _all_window_digits(scalars, c, n_windows)               # [W, n]
    offsets = torch.arange(n_windows, device=scalars.device)[:, None] << c
    rows = (digits + offsets).T.reshape(-1)                           # lane-major
    index = ((rows << 2) | table.inf[rows].to(torch.int64)).to(torch.int32)
    lanes = torch.arange(n, dtype=torch.int32, device=scalars.device)
    return kernels.accumulate(pack_points(table), index, lanes * n_windows,
                              torch.full_like(lanes, n_windows))


# -- BGMW-expanded tables -----------------------------------------------------------

def bgmw_expand(points: G1Aff, c: int) -> G1Aff:
    """Expand fixed bases into the BGMW window table
    T[w * n + j] = 2^(c * w) * P_j, window by window (one affine
    conversion and one K3 launch of c doublings per window)."""
    n_windows = -(-256 // c)
    jac = cv.from_affine(points)
    xs, ys, infs = [], [], []
    for w in range(n_windows):
        aff = cv.to_affine_batched(jac)
        xs.append(aff.x)
        ys.append(aff.y)
        infs.append(aff.inf)
        if w + 1 < n_windows:
            jac = _dbl_n(jac, c)
    return G1Aff(torch.cat(xs, dim=-1), torch.cat(ys, dim=-1), torch.cat(infs, dim=-1))


def _dbl_n(p: G1Jac, c: int) -> G1Jac:
    return cv.dbl_fast(p, repeat=c)
