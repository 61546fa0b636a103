"""The shared-bucket BGMW MSM over a precomputed window table: the MSM of
every workerCommit and workerOpen.

Port of the BGMW half of ``fourier_tpu.ops.msm_fused``, keeping its
contract and not its TPU layout.  Digits are sorted once
(``torch.sort(stable=True)``), bucket counts and starts come from
``bincount``/``cumsum``, heavy buckets are split exactly as in the
reference (``_split_heavy_slots``, ``_split_cap(factor=64)``), and one K1
launch accumulates every slot: thread s mixed-adds its run of table rows
in stable-sorted order, the order the reference's slab rounds use, so
the buckets equal the reference's slot for slot.  The slab machinery
(tiles, rounds, quad gathers, the unpermute) has no counterpart.
"""

from __future__ import annotations

import torch

from fourier_tpu.constants import FP_LIMBS

from . import curve as cv
from . import kernels
from . import msm as msm_mod
from .curve import G1Aff, G1Jac

# Scalars are treated as SCALAR_BITS-bit integers when deriving the window
# count (canonical Fr scalars leave the top bucket range half empty).
SCALAR_BITS = 256

# The spare region of split slots has at least this many slots: the
# reference sized it BTILE // 8 with BTILE = 1024 accumulator lanes per
# tile, and the same floor keeps the two bucket sets slot-for-slot equal.
MIN_SPARE = 128


def pack_points(points: G1Aff) -> torch.Tensor:
    """[24, n] affine limbs -> [n, 24] int32 rows: 12 words of x, then 12
    of y, each word two 16-bit limbs (natural 32-bit limbs, 96 bytes a
    point).  The infinity mask stays beside the table."""

    def words(v):
        return v[0::2] | (v[1::2] << 16)

    w = torch.cat([words(points.x), words(points.y)], dim=0).T
    return (w - ((w >> 31) << 32)).to(torch.int32).contiguous()


def signed_window_count(c: int) -> int:
    """Windows of SCALAR_BITS-bit scalars under balanced signed digits
    (c * W >= SCALAR_BITS + 1: the top window absorbs the last carry)."""
    return -(-(SCALAR_BITS + 1) // c)


def _signed_digits(scalars, c: int, n_windows: int):
    """Balanced signed digits: (magnitude, negate) [W, n] with values in
    [-(2^(c-1) - 1), 2^(c-1)] and a carry into the next window."""
    raw = msm_mod._all_window_digits(scalars, c, n_windows)
    half = 1 << (c - 1)
    full = 1 << c
    if SCALAR_BITS - c * (n_windows - 1) > c - 1:
        raise ValueError("top window cannot absorb the signed-digit carry")
    mags, negs = [], []
    carry = torch.zeros_like(raw[0])
    for w in range(n_windows):
        d = raw[w] + carry
        neg = d > half
        mags.append(torch.where(neg, full - d, d))
        negs.append(neg)
        carry = neg.to(raw.dtype)
    return torch.stack(mags), torch.stack(negs)


def bgmw_digits_for(scalars, c: int, n_windows: int):
    """(digits_flat, neg_flat | None) for a W-window BGMW table: signed
    digits where the window count covers them, else unsigned."""
    if n_windows == signed_window_count(c):
        mag, neg = _signed_digits(scalars, c, n_windows)
        return mag.reshape(-1), neg.reshape(-1)
    return msm_mod._all_window_digits(scalars, c, n_windows).reshape(-1), None


def bgmw_auto_window(n: int, shards: int = 1) -> int:
    """Window size of the BGMW table, unchanged from the reference so
    tables use the same c: a cost model of w * n row adds plus ~9 units
    per bucket, signed digits where c does not divide SCALAR_BITS, and no
    window whose top window has no effective bits."""
    if shards == 4 and n >= (1 << 16):
        return 13
    best, best_cost = 8, None
    for c in range(8, 23):
        w = signed_window_count(c)
        if w == -(-SCALAR_BITS // c):
            buckets = 1 << (c - 1)
            if (SCALAR_BITS - 1) - c * (w - 1) < 1:
                continue
        else:
            w = -(-SCALAR_BITS // c)
            buckets = 1 << c
        cost = w * n + 9 * buckets
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def _split_cap(total: int, n_buckets: int, factor: int = 16) -> int:
    """Per-slot load cap: `factor` x the mean load."""
    return factor * max(1, -(-total // n_buckets))


def _split_heavy_slots(counts, starts, cap: int, spare: int):
    """Heavy-bucket splitting over one bucket axis: loads capped at `cap`.

    A bucket with count > cap keeps its first `cap` rows in its own slot;
    each further cap-sized chunk takes the next slot of the spare region.
    Returns (counts', starts', weights') of length B + spare, weights'
    being each slot's bucket index (0 = contributes nothing)."""
    B = counts.shape[-1]
    dev = counts.device
    extra = torch.clamp((counts - 1) // cap, min=0)
    cum_incl = torch.cumsum(extra, dim=-1)
    total_extra = cum_incl[-1:]
    e = torch.arange(spare, dtype=cum_incl.dtype, device=dev)
    j = torch.searchsorted(cum_incl, e, right=True).clamp(0, B - 1)
    p = e - (cum_incl - extra)[j] + 1                  # part index >= 1
    valid = e < total_extra
    sp_counts = torch.where(valid, torch.clamp(counts[j] - p * cap, 0, cap), 0)
    sp_starts = starts[j] + p * cap
    sp_weights = torch.where(valid & (sp_counts > 0), j, 0)
    idx = torch.arange(B, dtype=j.dtype, device=dev)
    return (torch.cat([torch.clamp(counts, max=cap), sp_counts]),
            torch.cat([starts, sp_starts]),
            torch.cat([idx, sp_weights]))


def bgmw_buckets_from_digits(packed_table, table_inf, digits_flat, c: int,
                             neg_flat=None):
    """Sort, split and accumulate: (buckets [L, Bp], weights [Bp]).

    The main region [0, Bpow) has weight == index; from Bpow on come the
    signed +2^(c-1) bucket and the split spare slots with their bucket's
    index as weight."""
    index, start, count, weights = bucket_runs(table_inf, digits_flat, c, neg_flat)
    return kernels.accumulate(packed_table, index, start, count), weights


def bucket_runs(table_inf, digits_flat, c: int, neg_flat=None):
    """K1's arguments for a BGMW MSM: (index, start, count, weights).

    index lists the table rows in stable digit order, each entry
    (row << 2) | (negate << 1) | infinity; slot s accumulates
    index[start[s] : start[s] + count[s]].  Rows at infinity join the
    dropped digit-0 class."""
    signed = neg_flat is not None
    WN = table_inf.shape[0]
    Bpow = 1 << (c - 1) if signed else 1 << c
    B = Bpow + 1 if signed else Bpow
    cap = _split_cap(WN, Bpow, factor=64)
    spare = max(MIN_SPARE, -(-WN // cap))

    digits = torch.where(table_inf, 0, digits_flat)
    order = torch.sort(digits, stable=True).indices
    counts = torch.bincount(digits, minlength=B)
    starts = torch.cumsum(counts, 0) - counts
    counts[0] = 0                                                # drop digit 0
    counts_s, starts_s, weights = _split_heavy_slots(counts, starts, cap, spare)

    flags = table_inf.to(torch.int64)
    if signed:
        flags = flags | (neg_flat.to(torch.int64) << 1)
    index = ((order << 2) | flags[order]).to(torch.int32)
    return index, starts_s.to(torch.int32), counts_s.to(torch.int32), weights


def _pad_lanes(p: G1Jac, width: int) -> G1Jac:
    pad = width - p.x.shape[-1]
    return p if pad == 0 else cv._pad_last(p, pad)


def _weighted_sums_factored(buckets: G1Jac, weights, c: int, B: int) -> G1Jac:
    """[L, Bp] buckets -> [L, c, R] bit partial sums.

    The main region's index b = g * H + h factorizes the weighted sum:
    sum_b b * B_b = H * sum_g g * R_g + sum_h h * C_h over the row sums
    R_g and column sums C_h, so bits below log2(H) reduce over C and the
    rest over R; the spare slots keep the masked form of their dynamic
    weights, and their residual lanes join the same [c, R] terms."""
    h_bits = c // 2
    H = 1 << h_bits
    Gg = B >> h_bits
    main = G1Jac(*(t[..., :B].reshape(FP_LIMBS, Gg, H) for t in buckets))
    rows = cv.tree_reduce_axis(main, -1)          # [L, Gg]  R_g = sum over h
    cols = cv.tree_reduce_axis(main, -2)          # [L, H]   C_h = sum over g
    low = msm_mod._bit_partial_sums(cols, h_bits)
    high = msm_mod._bit_partial_sums(rows, c - h_bits)
    r_main = max(low.x.shape[-1], high.x.shape[-1])
    low = _pad_lanes(low, r_main)
    high = _pad_lanes(high, r_main)
    terms = G1Jac(*(torch.cat([a, b], dim=-2) for a, b in zip(low, high)))
    if buckets.x.shape[-1] == B:
        return terms
    spare = G1Jac(*(t[..., B:] for t in buckets))
    sp_terms = _weighted_partial_sums(spare, weights[B:], c)
    return G1Jac(*(torch.cat([a, b], dim=-1) for a, b in zip(terms, sp_terms)))


def _weighted_partial_sums(buckets: G1Jac, weights, c: int) -> G1Jac:
    """[L, B'] buckets with per-slot weights -> [L, c, R] bit partial sums."""
    n = buckets.x.shape[-1]
    bits = torch.arange(c, device=weights.device)
    masks = ((weights[None, :] >> bits[:, None]) & 1).bool()       # [c, B']
    shape = (FP_LIMBS, c, n)
    return cv.tree_reduce_last(
        G1Jac(buckets.x[:, None, :].expand(shape),
              buckets.y[:, None, :].expand(shape),
              torch.where(masks[None], buckets.z[:, None, :], 0)), to=32)


def bgmw_reduce(buckets: G1Jac, weights, c: int, signed: bool) -> G1Jac:
    """Weighted bucket reduction and Horner combine -> one point."""
    Bpow = 1 << (c - 1) if signed else 1 << c
    return msm_mod._horner_2k(_weighted_sums_factored(buckets, weights, c, Bpow))


def msm_fused_bgmw(packed_table, table_inf, scalars, c: int) -> G1Jac:
    """Shared-bucket MSM over a BGMW table (pack_points of bgmw_expand's
    T[w * n + i] = 2^(c * w) * P_i): every (window, point) row accumulates
    into one set of buckets, reduced once."""
    n = scalars.shape[-1]
    digits_flat, neg_flat = bgmw_digits_for(scalars, c, packed_table.shape[0] // n)
    buckets, weights = bgmw_buckets_from_digits(packed_table, table_inf, digits_flat,
                                                c, neg_flat)
    return bgmw_reduce(buckets, weights, c, neg_flat is not None)
