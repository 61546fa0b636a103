"""The bucket MSMs: the shared-bucket BGMW MSM over a precomputed window
table (every workerCommit and workerOpen of a row with a table) and the
tableless per-window Pippenger MSM (a row without one).

Port of ``fourier_tpu.ops.msm_fused``, keeping its contract and not its
TPU layout.  Digits are sorted once (``torch.sort(stable=True)``, per
window for the tableless MSM), bucket counts and starts come from
``bincount``/``cumsum``, heavy buckets are split exactly as in the
reference (``_split_heavy_slots``; ``_split_cap`` with factor 64 for BGMW,
16 tableless), and one K1 launch accumulates every slot: thread s
mixed-adds its run of table rows in stable-sorted order, the order the
reference's slab rounds use, so the buckets equal the reference's slot for
slot.  The slab machinery (tiles, rounds, quad gathers, the unpermute) has
no counterpart.
"""

from __future__ import annotations

import torch

from ..constants import FP_LIMBS

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
    """Heavy-bucket splitting over the last (bucket) axis of [..., B]
    counts and starts: loads capped at `cap`.

    A bucket with count > cap keeps its first `cap` rows in its own slot;
    each further cap-sized chunk takes the next slot of the spare region.
    Returns (counts', starts', weights') shaped [..., B + spare], weights'
    being each slot's bucket index (0 = contributes nothing)."""
    B = counts.shape[-1]
    dev = counts.device
    lead = counts.shape[:-1]
    extra = torch.clamp((counts - 1) // cap, min=0)
    cum_incl = torch.cumsum(extra, dim=-1)
    e = torch.arange(spare, dtype=cum_incl.dtype, device=dev).expand(lead + (spare,))
    j = torch.searchsorted(cum_incl, e.contiguous(), right=True).clamp(0, B - 1)
    p = e - torch.gather(cum_incl - extra, -1, j) + 1          # part index >= 1
    valid = e < cum_incl[..., -1:]
    sp_counts = torch.where(valid, torch.clamp(torch.gather(counts, -1, j) - p * cap, 0, cap), 0)
    sp_starts = torch.gather(starts, -1, j) + p * cap
    sp_weights = torch.where(valid & (sp_counts > 0), j, 0)
    idx = torch.arange(B, dtype=j.dtype, device=dev).expand(lead + (B,))
    return (torch.cat([torch.clamp(counts, max=cap), sp_counts], dim=-1),
            torch.cat([starts, sp_starts], dim=-1),
            torch.cat([idx, sp_weights], dim=-1))


def _sorted_runs(digits, flags, n_buckets: int, cap: int, spare: int):
    """K1's arguments for bucket sets along the last axis of [..., m]
    digits (one set per leading index, e.g. per window): (index, start,
    count, weights).

    Each row's digits are sorted stably; index entry k of row r is
    (table row << 2) | flags of that row, where table row is the sorted
    position's column.  Slot (r, s) accumulates index[start : start +
    count], with starts into the flattened index; digit 0 is dropped and
    heavy buckets are split (weights [..., n_buckets + spare])."""
    lead, m = digits.shape[:-1], digits.shape[-1]
    dev = digits.device
    order = torch.sort(digits, dim=-1, stable=True).indices
    rows = digits.reshape(-1, m).shape[0]
    row_off = torch.arange(rows, device=dev)[:, None]
    counts = torch.bincount((digits.reshape(rows, m) + row_off * n_buckets).reshape(-1),
                            minlength=rows * n_buckets).reshape(lead + (n_buckets,))
    starts = (torch.cumsum(counts, -1) - counts
              + (row_off * m).reshape(lead + (1,)))                  # into the flat index
    counts[..., 0] = 0                                                # drop digit 0
    counts_s, starts_s, weights = _split_heavy_slots(counts, starts, cap, spare)
    index = (order << 2) | torch.gather(flags.expand(digits.shape), -1, order)
    return (index.reshape(-1).to(torch.int32), starts_s.reshape(-1).to(torch.int32),
            counts_s.reshape(-1).to(torch.int32), weights)


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
    flags = table_inf.to(torch.int64)
    if signed:
        flags = flags | (neg_flat.to(torch.int64) << 1)
    return _sorted_runs(torch.where(table_inf, 0, digits_flat), flags, B, cap,
                        max(MIN_SPARE, -(-WN // cap)))


def _pad_lanes(p: G1Jac, width: int) -> G1Jac:
    pad = width - p.x.shape[-1]
    return p if pad == 0 else cv._pad_last(p, pad)


def _weighted_sums_factored(buckets: G1Jac, weights, c: int, B: int) -> G1Jac:
    """[L, Bp] buckets -> [L, c, R] bit partial sums.

    The main region's index b = g * H + h factorizes the weighted sum:
    sum_b b * B_b = H * sum_g g * R_g + sum_h h * C_h over the row sums
    R_g and column sums C_h, so bits below log2(H) reduce over C and the
    rest over R; the spare slots keep the masked form of their dynamic
    weights, and their residual lanes join the same [c, R] terms.  The
    row, column and spare trees share one tree-kernel launch, the two
    bit-partial-sum trees another."""
    h_bits = c // 2
    H = 1 << h_bits
    Gg = B >> h_bits
    main = G1Jac(*(t[..., :B].reshape(FP_LIMBS, Gg, H) for t in buckets))
    trees = [(main, -1, 1), (main, -2, 1)]       # R_g = sum over h, C_h = sum over g
    if buckets.x.shape[-1] > B:
        spare = G1Jac(*(t[..., B:] for t in buckets))
        trees.append((_weighted_partial_leaves(spare, weights[B:], c), -1, 32))
    sums = kernels.g1_tree_reduce(trees)
    rows, cols = (G1Jac(*(t.squeeze(axis) for t in p)) for p, axis in zip(sums, (-1, -2)))
    low, high = kernels.g1_tree_reduce(
        [(msm_mod._bit_partial_leaves(cols, h_bits), -1, 32),
         (msm_mod._bit_partial_leaves(rows, c - h_bits), -1, 32)])
    r_main = max(low.x.shape[-1], high.x.shape[-1])
    low = _pad_lanes(low, r_main)
    high = _pad_lanes(high, r_main)
    terms = G1Jac(*(torch.cat([a, b], dim=-2) for a, b in zip(low, high)))
    if len(sums) == 2:
        return terms
    return G1Jac(*(torch.cat([a, b], dim=-1) for a, b in zip(terms, sums[2])))


def _weighted_partial_leaves(buckets: G1Jac, weights, c: int) -> G1Jac:
    """[L, ..., B'] buckets with per-slot weights [..., B'] -> the
    [L, ..., c, B'] leaves of their bit partial sums (bucket s in row j
    where bit j of its weight is set, the identity elsewhere)."""
    bits = torch.arange(c, device=weights.device)
    masks = ((weights[..., None, :] >> bits[:, None]) & 1).bool()  # [..., c, B']
    shape = buckets.x.shape[:-1] + (c, buckets.x.shape[-1])
    return G1Jac(buckets.x.unsqueeze(-2).expand(shape), buckets.y.unsqueeze(-2).expand(shape),
                 torch.where(masks[None], buckets.z.unsqueeze(-2), 0))


def _weighted_partial_sums(buckets: G1Jac, weights, c: int) -> G1Jac:
    """[L, ..., B'] buckets with per-slot weights [..., B'] -> [L, ..., c, R]
    bit partial sums."""
    return cv.tree_reduce_last(_weighted_partial_leaves(buckets, weights, c), to=32)


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


# -- the tableless MSM ------------------------------------------------------------

def msm_fused(points: G1Aff, scalars, c: int) -> G1Jac:
    """Tableless Pippenger MSM sum_i scalars[i] * points[i] (one point)."""
    return msm_fused_packed(pack_points(points), points.inf, scalars, c)


def msm_fused_packed(packed, inf, scalars, c: int) -> G1Jac:
    """Tableless Pippenger MSM over packed points: W = ceil(256 / c) windows
    of unsigned c-bit digits, each with its own 2^c buckets and spare
    slots; one K1 launch over all W * (2^c + spare) slots, the weighted
    bucket sums of every window at once through K2 trees, and one K4
    Horner over the W * c terms (term c * w + j has weight 2^(c w + j))."""
    n = packed.shape[0]
    W = -(-SCALAR_BITS // c)
    B = 1 << c
    cap = _split_cap(n, B)
    digits = msm_mod._all_window_digits(scalars, c, W)             # [W, n]
    digits = torch.where(inf[None], 0, digits)       # infinity joins digit 0
    index, start, count, weights = _sorted_runs(digits, inf.to(torch.int64), B, cap,
                                                max(MIN_SPARE, -(-n // cap)))
    buckets = kernels.accumulate(packed, index, start, count)     # [L, W * Bp]
    Bp = weights.shape[-1]
    ps = _weighted_partial_sums(G1Jac(*(t.reshape(FP_LIMBS, W, Bp) for t in buckets)),
                                weights, c)                        # [L, W, c, R]
    return msm_mod._horner_2k(G1Jac(*(t.reshape(FP_LIMBS, W * c, -1) for t in ps)))
