"""The port's BGMW MSM against fourier_tpu.ops.msm / msm_fused.

The bucket half of the reference's msm_fused_bgmw runs through the
Pallas interpreter (BTILE patched to 128, so its spare region has 16
slots; the port's MIN_SPARE is patched to match), and the port's
(buckets, weights) must equal it slot for slot after canonicalize.  The
final point is held against refimpl and the reference's msm_naive (the
reduction half under the interpreter costs minutes on a CPU).  n = 32 at
c = 7 (signed digits) and c = 8 (unsigned), with an infinity row, a zero
scalar, a duplicated point with an equal scalar, and all-equal scalars.
Comparisons are exact.
"""

import random

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
from fourier_tpu.refimpl.curve import G1_GEN, g1_add, g1_msm, g1_mul
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
    tb, tw = tmf.bgmw_buckets_from_digits(tmf.pack_points(ttable), ttable.inf, td, c, tneg)
    _same(jcv.G1Jac(*(JFP.canonicalize(x) for x in jb)), tb)
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())

    monkeypatch.setenv("FOURIER_PALLAS", "0")
    point = tmf.bgmw_reduce(tb, tw, c, tneg is not None)
    got = tcv.jac_to_int_points(tcv.G1Jac(*(x[..., None] for x in point)))[0]
    assert got == g1_msm(points, sc)
    want = jcv.jac_to_int_points(jmsm.msm_naive(jcv.affine_from_ints(points), jsc))
    assert [got] == want
    assert got == tcv.jac_to_int_points(tcv.G1Jac(*(x[..., None] for x in tmf.msm_fused_bgmw(
        tmf.pack_points(ttable), ttable.inf, tsc, c))))[0]


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


def test_horner_matches_pallas_kernel(monkeypatch):
    """K = 6 terms of width 4 with an identity lane, against
    pallas_curve.horner_2k through the interpreter."""
    monkeypatch.setenv("FOURIER_PALLAS", "1")
    monkeypatch.setenv("FOURIER_PALLAS_INTERPRET", "1")
    rng = random.Random(0x4042)
    K, width = 6, 4
    terms = [[g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(width)] for _ in range(K)]
    terms[2][1] = None
    jac = jcv.from_affine(jcv.affine_from_ints([p for row in terms for p in row]))
    jout = pc.horner_2k(jac.x, jac.y, jac.z, width=width)
    tout = kernels.horner_2k(_to_torch(jac), width)
    _same(jout, tout)
    expect = None
    for k in range(K):
        row = None
        for pt in terms[k]:
            row = g1_add(row, pt)
        expect = g1_add(expect, g1_mul(row, 1 << k))
    assert tcv.jac_to_int_points(tcv.fold_small(tout)) == [expect]


def test_fixed_base_msm_matches_jax():
    rng = random.Random(0xFB)
    jsc, tsc = _scalar_pair([0, 1, R - 1] + [rng.randrange(R) for _ in range(5)])
    _same(jmsm.fixed_base_msm(G1_GEN, jsc), tmsm.fixed_base_msm(G1_GEN, tsc))


def test_bgmw_expand_matches_jax(points):
    jpts = jcv.affine_from_ints(points[4:8])   # includes the infinity row
    _same(jmsm.bgmw_expand(jpts, 8), tmsm.bgmw_expand(_to_torch(jpts), 8))
