"""The port's BGMW MSM against fourier_tpu.ops.msm / msm_fused.

The bucket half of the reference's msm_fused_bgmw runs through the
Pallas interpreter (BTILE patched to 128, so its spare region has 16
slots; the port's MIN_SPARE is patched to match), and the port's
(buckets, weights) must equal it slot for slot after canonicalize: limb
for limb where K1's twin sums whole runs, as group elements where it cuts
them into pieces as the kernel does.  The
final point is held against refimpl and the reference's msm_naive (the
reduction half under the interpreter costs minutes on a CPU).  n = 32 at
c = 7 (signed digits) and c = 8 (unsigned), with an infinity row, a zero
scalar, a duplicated point with an equal scalar, and all-equal scalars.
The tableless msm (n = 65, random and all-equal scalars) and msm_naive (n = 8,
with scalars 0, 1 and r - 1 and a point at infinity; K5's ladder on the CPU
runs its twin) give the points of the reference's msm (its CPU jnp path) and
msm_naive.  Comparisons are exact.
"""

import random
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_tpu.constants import FR_LIMBS, R
from fourier_tpu.ops import curve as jcv
from fourier_tpu.ops import msm as jmsm
from fourier_tpu.ops import msm_fused as jmf
from fourier_tpu.ops import pallas_curve as pc
from fourier_tpu.ops.field import FP as JFP
from fourier_tpu.ops.limbs import ints_to_vec
from fourier_tpu.refimpl.curve import G1_GEN, g1_add, g1_msm, g1_msm_fast, g1_mul, g1_neg
from fourier_tpu_torch.ops import curve as tcv
from fourier_tpu_torch.ops import kernels
from fourier_tpu_torch.ops import msm as tmsm
from fourier_tpu_torch.ops import msm_fused as tmf

torch.set_num_threads(1)

N = 32


def _to_torch(p):
    cls = tcv.G1Aff if hasattr(p, "inf") else tcv.G1Jac
    arrs = [np.array(c) for c in p]
    return cls(*(torch.as_tensor(a if a.dtype == np.bool_ else a.astype(np.int64))
                 for a in arrs))


def _same(j, t):
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


def _scalar_pair(vals):
    limbs = ints_to_vec(vals, FR_LIMBS)
    return jnp.asarray(limbs), torch.as_tensor(limbs.astype(np.int64))


@pytest.fixture(scope="module")
def points():
    rng = random.Random(0x3535)
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(N)]
    pts[5] = None        # infinity row
    pts[9] = pts[8]      # duplicated point (an equal scalar below)
    return pts


@pytest.fixture(scope="module")
def jax_tables(points):
    cache = {}

    def get(c):
        if c not in cache:
            cache[c] = jmsm.bgmw_expand(jcv.affine_from_ints(points), c)
        return cache[c]

    return get


def _scalars(kind, c):
    rng = random.Random(c)
    if kind == "equal":
        return [12345678901234567890] * N
    sc = [rng.randrange(R) for _ in range(N)]
    sc[3] = 0
    sc[9] = sc[8]
    return sc


@pytest.mark.parametrize("c,kind", [(7, "mixed"), (8, "mixed"), (7, "equal"), (8, "equal")])
def test_bgmw_buckets_and_point_match_jax(points, jax_tables, c, kind, monkeypatch):
    """K1's plain twin with whole runs (piece=None) gives the reference's
    buckets limb for limb; cut into pieces (3 rows, and the kernel's
    PIECE, which the CPU wrapper runs) it gives the same group elements."""
    jtable = jax_tables(c)
    ttable = _to_torch(jtable)
    sc = _scalars(kind, c)
    jsc, tsc = _scalar_pair(sc)
    W = jtable.x.shape[-1] // N

    td, tneg = tmf.bgmw_digits_for(tsc, c, W)
    assert (tneg is not None) == (c == 7)

    monkeypatch.setenv("FOURIER_PALLAS", "1")
    monkeypatch.setenv("FOURIER_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pc, "TILE", 128)
    monkeypatch.setattr(jmf, "BTILE", 128)
    monkeypatch.setattr(tmf, "MIN_SPARE", 128 // 8)
    jd, jneg = jmf.bgmw_digits_for(jsc, c, W)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    jb, jw = jmf.bgmw_buckets_from_digits(jmf.pack_points(jtable), jtable.inf, jd, c, jneg)
    packed = tmf.pack_points(ttable)
    runs = tmf.bucket_runs(ttable.inf, td, c, tneg)
    whole = kernels.accumulate_plain(packed, *runs[:3])
    _same(jcv.G1Jac(*(JFP.canonicalize(x) for x in jb)), whole)
    np.testing.assert_array_equal(np.asarray(jw), runs[3].numpy())
    assert int(runs[2].max()) > 3                      # pieces of 3 split runs
    want = tcv.jac_to_int_points(whole)
    assert tcv.jac_to_int_points(kernels.accumulate_plain(packed, *runs[:3], piece=3)) == want
    tb, tw = tmf.bgmw_buckets_from_digits(packed, ttable.inf, td, c, tneg)
    assert tcv.jac_to_int_points(tb) == want
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())

    monkeypatch.setenv("FOURIER_PALLAS", "0")
    # the whole MSM: these digits, buckets and weights through bgmw_reduce
    got = _point(tmf.msm_fused_bgmw(packed, ttable.inf, tsc, c))
    assert got == g1_msm_fast(points, sc)
    want = jcv.jac_to_int_points(jmsm.msm_naive(jcv.affine_from_ints(points), jsc))
    assert [got] == want


def _point(p):
    """A single-point batch (either package's G1Jac of [L] coordinates) as a
    refimpl point."""
    if isinstance(p.x, torch.Tensor):
        return tcv.jac_to_int_points(tcv.G1Jac(*(x[..., None] for x in p)))[0]
    return jcv.jac_to_int_points(jcv.G1Jac(*(x[..., None] for x in p)))[0]


@pytest.mark.parametrize("n,kind", [(65, "mixed"), (65, "equal")])
def test_tableless_msm_matches_jax(n, kind):
    """msm at the reference's window (c = 6: 43 windows of 64 buckets).
    mixed: random points, two at infinity, a zero scalar; equal: every
    window puts all 65 points in one bucket, past its cap, so the bucket
    splits over the spare slots."""
    rng = random.Random(f"{n}-{kind}")
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    if kind == "mixed":
        pts[3] = pts[40] = None
        sc = [rng.randrange(R) for _ in range(n)]
        sc[7] = 0
    else:
        sc = [12345678901234567890123] * n
        assert tmf._split_cap(n, 1 << 6) < n
    jsc, tsc = _scalar_pair(sc)
    assert tmsm._auto_window(n) == jmsm._auto_window(n) == 6
    with ThreadPoolExecutor(1) as pool:           # the reference alongside the port
        want = pool.submit(lambda: _point(jmsm.msm(jcv.affine_from_ints(pts), jsc)))
        got = _point(tmsm.msm(tcv.affine_from_ints(pts), tsc))
        assert got == want.result() == g1_msm_fast(pts, sc)


def test_msm_naive_matches_jax():
    rng = random.Random(8)
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(8)]
    pts[2] = None
    sc = [0, 1, R - 1] + [rng.randrange(R) for _ in range(5)]
    jsc, tsc = _scalar_pair(sc)
    got = _point(tmsm.msm_naive(tcv.affine_from_ints(pts), tsc))
    assert got == _point(jmsm.msm_naive(jcv.affine_from_ints(pts), jsc)) == g1_msm(pts, sc)


def test_split_heavy_slots_matches_jax():
    rng = random.Random(0x5917)
    B, cap = 64, 5
    counts = np.array([rng.choice([0, 1, 3, 5, 6, 11, 17]) for _ in range(B)], np.int32)
    counts[7] = 40
    spare = int(counts.sum()) // cap + 3   # the callers' sizing: >= total / cap
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    jout = jmf._split_heavy_slots(jnp.asarray(counts), jnp.asarray(starts), cap, spare)
    tout = tmf._split_heavy_slots(torch.as_tensor(counts.astype(np.int64)),
                                  torch.as_tensor(starts.astype(np.int64)), cap, spare)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(tout[0].sum()) == int(counts.sum())


@pytest.mark.parametrize("c", [7, 8, 11, 16])
def test_window_digits_match_jax(c):
    rng = random.Random(c)
    jsc, tsc = _scalar_pair([0, 1, R - 1] + [rng.randrange(R) for _ in range(13)])
    W = -(-256 // c)
    np.testing.assert_array_equal(np.asarray(jmsm._all_window_digits(jsc, c, W)),
                                  tmsm._all_window_digits(tsc, c, W).numpy())
    jd, jneg = jmf.bgmw_digits_for(jsc, c, W)       # signed where c does not divide 256
    td, tneg = tmf.bgmw_digits_for(tsc, c, W)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert (jneg is None) == (tneg is None) == (256 % c == 0)
    if jneg is not None:
        np.testing.assert_array_equal(np.asarray(jneg), tneg.numpy())
    assert tmf.bgmw_auto_window(1 << 19) == jmf.bgmw_auto_window(1 << 19) == 16
    assert tmf.bgmw_auto_window(1 << 12) == jmf.bgmw_auto_window(1 << 12) == 11


def _horner_terms(K, width, kind, rng):
    """K terms of `width` refimpl points.  "identity": random points, lane 1
    of term 2 at infinity.  "same-point": the points B + i S for random B
    and S (one add each), the sum V_k of each term's lanes set so that the
    kernel's tree meets the same point twice: V_2 = 2 V_3 (its first step
    adds 2^2 V_2 and 2^3 V_3) and V_4 + 2 V_5 = 4 (V_6 + 2 V_7) (its second
    step), with an identity lane in term 0."""
    if kind == "identity":
        terms = [[g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(width)] for _ in range(K)]
        terms[2][1] = None
        return terms
    pt, step = (g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(2))
    terms = []
    for _ in range(K):
        terms.append([])
        for _ in range(width):
            terms[-1].append(pt)
            pt = g1_add(pt, step)
    terms[0][1] = None
    v = [None] * K
    for k in range(K):
        for pt in terms[k]:
            v[k] = g1_add(v[k], pt)
    want = {2: g1_mul(v[3], 2)}
    if K > 7:
        want[4] = g1_add(g1_mul(g1_add(v[6], g1_mul(v[7], 2)), 4), g1_neg(g1_mul(v[5], 2)))
    for k, target in want.items():
        rest = None
        for pt in terms[k][1:]:
            rest = g1_add(rest, pt)
        terms[k][0] = g1_add(target, g1_neg(rest))
    return terms


HORNER_K = 13


@pytest.mark.parametrize("K,kind", [(6, "identity"), (5, "same-point"), (HORNER_K, "same-point")])
def test_horner_matches_pallas_kernel(monkeypatch, K, kind):
    """K4's single point (its plain twin on the CPU) against
    pallas_curve.horner_2k through the interpreter, at HORNER_K terms
    (identities past K), whose width residual lanes fold_small sums, as
    one group element, exact; and against refimpl.  K = 5 and 13 are no powers of two, and put same-point pairs
    in the kernel's tree (the doubling branch)."""
    monkeypatch.setenv("FOURIER_PALLAS", "1")
    monkeypatch.setenv("FOURIER_PALLAS_INTERPRET", "1")
    rng = random.Random(0x4042 if kind == "identity" else 0x4042 + K)
    width = 4
    terms = _horner_terms(K, width, kind, rng)
    jac = jcv.from_affine(jcv.affine_from_ints([p for row in terms for p in row]))
    # the reference runs at one shape for every case (one interpreter
    # compile): terms past K are identities, which add nothing at 2^k
    ref = jcv.from_affine(jcv.affine_from_ints(
        [p for row in terms for p in row] + [None] * ((HORNER_K - K) * width)))
    jout = jcv.fold_small(jcv.G1Jac(*pc.horner_2k(ref.x, ref.y, ref.z, width=width)))
    tout = kernels.horner_2k(_to_torch(jac), width)
    assert tout.x.shape == (24, 1)
    expect = None
    for k in range(K):
        row = None
        for pt in terms[k]:
            row = g1_add(row, pt)
        expect = g1_add(expect, g1_mul(row, 1 << k))
    assert tcv.jac_to_int_points(tout) == jcv.jac_to_int_points(jout) == [expect]
    if kind == "same-point":
        w = tcv.jac_to_int_points(kernels.horner_weighted_terms(_to_torch(jac), width))
        assert w[2] == w[3]
        if K > 7:
            assert g1_add(w[4], w[5]) == g1_add(w[6], w[7])


@pytest.mark.parametrize("K,width,block_terms", [(13, 4, 4), (9, 3, 2), (6, 8, 8)])
def test_horner_block_split_matches_unsplit(K, width, block_terms):
    """K4's block split on its plain twin: runs of block_terms terms whose
    partials carry their 2^(first k) weights, summed by the tree that
    continues each run's, give the unsplit twin's limbs; each partial is
    2^(first k) times the unsplit sum of its run's own terms."""
    rng = random.Random(K * 100 + width)
    terms = _horner_terms(K, width, "same-point", rng)
    pts = tcv.from_affine(tcv.affine_from_ints([p for row in terms for p in row]))
    whole = kernels.horner_2k_plain(pts, width)
    split = kernels.horner_2k_plain(pts, width, block_terms=block_terms)
    for a, b in zip(whole, split):
        assert torch.equal(a, b)
    total = None
    for k0 in range(0, K, block_terms):
        run = tcv.G1Jac(*(c[:, k0 * width:min(K, k0 + block_terms) * width] for c in pts))
        part = tcv.jac_to_int_points(kernels.horner_2k_plain(run, width))[0]
        total = g1_add(total, g1_mul(part, 1 << k0))
    assert tcv.jac_to_int_points(whole) == [total]


def test_fixed_base_msm_matches_jax():
    rng = random.Random(0xFB)
    jsc, tsc = _scalar_pair([0, 1, R - 1] + [rng.randrange(R) for _ in range(5)])
    _same(jmsm.fixed_base_msm(G1_GEN, jsc), tmsm.fixed_base_msm(G1_GEN, tsc))


def test_bgmw_expand_matches_jax(points):
    jpts = jcv.affine_from_ints(points[4:8])   # includes the infinity row
    _same(jmsm.bgmw_expand(jpts, 8), tmsm.bgmw_expand(_to_torch(jpts), 8))
