"""fourier_tpu_torch.ops.field against fourier_tpu.ops.field, limb for limb.

The same inputs, made from a seed (edge values 0, 1, N-1 and a value
whose carries ripple through every limb among them), go through the JAX
Field and the port's; every comparison is exact (integer arithmetic).
The CUDA header's constants are checked against the Python ones here,
so that a CPU-only run catches a wrong constant before any build.
"""

import os
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_tpu.constants import FP_LIMBS, FR_LIMBS, P, R
from fourier_tpu.ops import field as jf
from fourier_tpu.ops.limbs import ints_to_vec, vec_to_ints
from fourier_tpu_torch.ops import field as tf

torch.set_num_threads(1)

FIELDS = {"fr": (jf.FR, tf.FR, R, FR_LIMBS), "fp": (jf.FP, tf.FP, P, FP_LIMBS)}


def _values(modulus, L, rng, n=13):
    # 2^(16(L-1)) - 1 is L-1 limbs of 0xFFFF: adding 1 ripples through all
    edge = [0, 1, modulus - 1, (1 << (16 * (L - 1))) - 1]
    return edge + [rng.randrange(modulus) for _ in range(n - len(edge))]


def _both(vals, L):
    limbs = ints_to_vec(vals, L)
    return jnp.asarray(limbs), torch.as_tensor(limbs.astype(np.int64))


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_arithmetic_matches_jax(name):
    jfield, tfield, modulus, L = FIELDS[name]
    rng = random.Random(0xF1E1D + L)
    xs = _values(modulus, L, rng)
    ys = list(reversed(_values(modulus, L, rng)))
    ja, ta = _both(xs, L)
    jb, tb = _both(ys, L)
    _same(jfield.add(ja, jb), tfield.add(ta, tb))
    _same(jfield.sub(ja, jb), tfield.sub(ta, tb))
    _same(jfield.neg(ja), tfield.neg(ta))
    _same(jfield.mul(ja, jb), tfield.mul(ta, tb))
    _same(jfield.mul(ja, jb), tfield._mul_whole(ta, tb))     # both forms of the product
    _same(jfield.mul(ja, jb), tfield._mul_cios(ta, tb))
    _same(jfield.square(ja), tfield.square(ta))
    _same(jfield.to_mont(ja), tfield.to_mont(ta))
    _same(jfield.from_mont(ja), tfield.from_mont(ta))
    _same(jfield.is_zero(ja), tfield.is_zero(ta))
    mask = np.array([v % 2 == 0 for v in xs])
    _same(jfield.select(jnp.asarray(mask), ja, jb), tfield.select(torch.as_tensor(mask), ta, tb))
    # and against the integers themselves
    rinv = pow(tfield.mont_r, -1, modulus)
    assert vec_to_ints(tfield.mul(ta, tb).numpy()) == [x * y * rinv % modulus
                                                       for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_inversion_matches_jax(name):
    jfield, tfield, modulus, L = FIELDS[name]
    rng = random.Random(0x1A7 + L)
    xs = _values(modulus, L, rng, n=70)  # 70 lanes: one full chunk of 64 and a tail
    ja, ta = _both(xs, L)
    jm, tm = jfield.to_mont(ja), tfield.to_mont(ta)
    _same(jfield.pow_const(jm, 12345), tfield.pow_const(tm, 12345))
    _same(jfield.pow_const(jm, 0), tfield.pow_const(tm, 0))
    _same(jfield.inv(jm), tfield.inv(tm))
    _same(jfield.batch_inv(jm), tfield.batch_inv(tm))
    _same(jfield.batch_inv(jm[:, :5]), tfield.batch_inv(tm[:, :5]))
    assert vec_to_ints(tfield.from_mont(tfield.batch_inv(tm)).numpy()) == [
        pow(x, -1, modulus) if x else 0 for x in xs]


def test_canonicalize_matches_jax():
    """Representatives N + x and 2N + x (the reference's lazy domain)
    reduce to x in both packages."""
    rng = random.Random(0xCA)
    xs = _values(P, FP_LIMBS, rng)
    reps = [x + P for x in xs] + [x + 2 * P for x in xs[:4]]
    ja, ta = _both(reps, FP_LIMBS)
    _same(jf.FP.canonicalize(ja), tf.FP.canonicalize(ta))
    assert vec_to_ints(tf.FP.canonicalize(ta).numpy()) == [v % P for v in reps]


def test_cuda_header_constants():
    """The Fp constants of csrc/g1.cuh (12 x 32-bit words) are p, the
    Montgomery one 2^384 mod p and -p^-1 mod 2^32."""
    from fourier_tpu_torch.ops import kernels

    with open(os.path.join(kernels.CSRC, "g1.cuh")) as fh:
        src = fh.read()

    def words(name):
        body = re.search(name + r"\[FP_WORDS\] = \{([^}]*)\}", src).group(1)
        vals = [int(w.strip().rstrip("u"), 16) for w in body.split(",") if w.strip()]
        assert len(vals) == 12
        return sum(v << (32 * i) for i, v in enumerate(vals))

    assert words("FP_P") == P
    assert words("FP_ONE") == (1 << 384) % P
    ninv = int(re.search(r"#define FP_NINV (0x[0-9a-f]+)u", src).group(1), 16)
    assert ninv == (-pow(P, -1, 1 << 32)) % (1 << 32)

