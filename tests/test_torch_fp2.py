"""fourier_tpu_torch.ops.fp2 against fourier_tpu.ops.fp2, on the CPU.

The same seeded G2 points and Fp2 elements go to both packages: the JAX
side builds them with its own helpers, fourier_tpu_torch.convert carries
its uint32 [L, 2, *batch] arrays to the port.  Fp2 mul, square and inv,
g2_dbl, g2_add, g2_madd and g2_scalar_mul must give the JAX limbs exactly,
on batches with the identity on either side, P = Q and P = -Q lanes, and
scalars 0, 1 and random ones; the affine results must equal refimpl's.
"""

import random
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_tpu.constants import FR_LIMBS, P, R
from fourier_tpu.ops import fp2 as j2
from fourier_tpu.ops.limbs import ints_to_vec
from fourier_tpu.refimpl.curve import G2_GEN, g2_add, g2_mul, g2_neg
from fourier_tpu.refimpl.tower import Fp2
from fourier_tpu_torch import convert
from fourier_tpu_torch.ops import fp2 as t2

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return random.Random(0xF2F2)


def _same(jax_limbs, port_limbs):
    np.testing.assert_array_equal(np.asarray(jax_limbs).astype(np.int64), port_limbs.numpy())


def _same_points(jp, tp):
    for a, b in zip(jp, tp):
        _same(a, b)


def _as_ints(pt):
    return None if pt is None else ((pt[0].c0, pt[0].c1), (pt[1].c0, pt[1].c1))


def _jax_jac(points):
    """A JAX G2 Jacobian batch of refimpl points (z = 1, or 0 at None)."""
    aff = j2.g2_affine_from_ints(points)
    one = j2.FP2.broadcast_const(j2.FP.one_mont, aff.x.shape[1:])
    return j2.G1Jac(aff.x, aff.y, j2.FP2.select(aff.inf, jnp.zeros_like(aff.x), one)), aff


def _arrays(p):
    return type(p)(*(np.asarray(c) for c in p))


def test_fp2_mul_square_inv_match_jax(rng):
    n = 5
    vals = [(rng.randrange(P), rng.randrange(P)) for _ in range(2 * n)]
    vals[3] = (0, 0)                             # 0 inverts to 0
    vals[4] = (1, 0)
    vals[5] = (0, P - 1)

    def enc(pairs):
        mont = [c * j2.FP.mont_r % P for pair in pairs for c in pair]
        return np.ascontiguousarray(
            ints_to_vec(mont, 24).reshape(24, len(pairs), 2).transpose(0, 2, 1))

    a_np, b_np = enc(vals[:n]), enc(vals[n:])
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    ta, tb = convert.limbs_from_array(a_np, "cpu"), convert.limbs_from_array(b_np, "cpu")
    _same(j2.FP2.mul(ja, jb), t2.FP2.mul(ta, tb))
    _same(j2.FP2.square(ja), t2.FP2.square(ta))
    _same(j2.FP2.inv(ja), t2.FP2.inv(ta))
    _same(j2.FP2.is_zero(ja), t2.FP2.is_zero(ta))
    one = t2.FP2.broadcast_const("one_mont", (2, n), "cpu")
    prod = t2.FP2.mul(ta, t2.FP2.inv(ta))
    _same(np.where(np.asarray(j2.FP2.is_zero(ja))[None, None], 0, np.asarray(one)), prod)
    # against the tower arithmetic of refimpl
    got = t2.FP2.mul(ta, tb)
    r_mont_inv = pow(j2.FP.mont_r, -1, P)
    for k, ((a0, a1), (b0, b1)) in enumerate(zip(vals[:n], vals[n:])):
        want = Fp2(a0, a1) * Fp2(b0, b1)
        limbs = got[:, :, k].T.numpy()
        c = [sum(int(v) << (16 * i) for i, v in enumerate(row)) * r_mont_inv % P
             for row in limbs]
        assert (c[0], c[1]) == (want.c0, want.c1)


def test_g2_dbl_add_madd_match_jax(rng):
    ps = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(6)]
    qs = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(6)]
    qs[1] = ps[1]                         # P = Q: the doubling branch
    qs[2] = g2_neg(ps[2])                 # P = -Q: the identity
    ps[3] = None                          # identity on the left
    qs[4] = None                          # identity on the right
    ps[5] = qs[5] = None
    jp, _ = _jax_jac(ps)
    jq, jq_aff = _jax_jac(qs)
    tp = convert.jac_from_arrays(_arrays(jp), "cpu")
    tq = convert.jac_from_arrays(_arrays(jq), "cpu")
    tq_aff = convert.affine_from_arrays(_arrays(jq_aff), "cpu")
    _same_points(j2.g2_affine_from_ints(qs), t2.g2_affine_from_ints(qs, "cpu"))

    with ThreadPoolExecutor(1) as pool:         # the reference alongside the port
        want = pool.submit(lambda: [_arrays(j2.g2_dbl(jp)), _arrays(j2.g2_add(jp, jq)),
                                    _arrays(j2.g2_madd(jp, jq_aff))])
        got = [t2.g2_dbl(tp), t2.g2_add(tp, tq), t2.g2_madd(tp, tq_aff)]
        for a, b in zip(want.result(), got):
            _same_points(a, b)
    sums = [_as_ints(g2_add(a, b)) for a, b in zip(ps, qs)]
    assert t2.g2_jac_to_int_points(got[0]) == [_as_ints(g2_add(a, a)) for a in ps]
    assert t2.g2_jac_to_int_points(got[1]) == sums
    assert t2.g2_jac_to_int_points(got[2]) == sums
    assert sums[2] is None and sums[5] is None


def test_g2_scalar_mul_matches_jax(rng):
    ks = [rng.randrange(R), 0, 1, R - 1]
    pts = [G2_GEN, G2_GEN, g2_mul(G2_GEN, rng.randrange(1, R)), None]
    jp, _ = _jax_jac(pts)
    sc = ints_to_vec(ks, FR_LIMBS)
    tp = convert.jac_from_arrays(_arrays(jp), "cpu")
    tsc = convert.limbs_from_array(sc, "cpu")
    _same_points(j2.g2_generator_jac((2,)), t2.g2_generator_jac((2,), "cpu"))
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(lambda: _arrays(j2.g2_scalar_mul(jp, jnp.asarray(sc))))
        got = t2.g2_scalar_mul(tp, tsc)
        _same_points(want.result(), got)
    assert t2.g2_jac_to_int_points(got) == [
        None if p is None else _as_ints(g2_mul(p, k)) for p, k in zip(pts, ks)]
