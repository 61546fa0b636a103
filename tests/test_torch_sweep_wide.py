"""The pianist sweep's cases with n = 7 on fourier_tpu_torch against
fourier_tpu, on the CPU: the checks of test_torch_sweep.py (n = 8 is in
test_torch_sweep_n8.py).  At m = n - 1 a row is 2 points: 64 workers.
Beside them, the port's counterparts of test_verify_default and
test_bipoly_algebra (tests/test_piano.py).
"""

import random

import pytest

from fourier_tpu.constants import R
from fourier_tpu.models.bipoly import BivariatePolynomial as JaxBivariate
from fourier_tpu_torch.models.bipoly import BivariatePolynomial
from fourier_tpu_torch.refimpl.poly import poly_eval

import torch_sweep as sw

# (7, 6) first: tests/test_piano.py reaches (7, 1) first, so its programs
# are in the compile cache by the time this file's (7, 1) runs.
CASES = [(7, 6), (7, 1)]


@pytest.mark.parametrize("n,m", CASES)
def test_pianist_matches_jax_wide(n, m):
    sw.sweep_case(n, m)


def test_verify_default():
    """The identity commitment, eval 0 and the identity proof verify (the
    vacuous proof), in both packages."""
    jb, tb = sw.sides(2, 1)
    alpha = random.Random(0xDE).randrange(R)
    assert tb.worker_verify(0, None, alpha, 0, None)
    assert jb.worker_verify(0, None, alpha, 0, None)


def test_bipoly_algebra():
    """add/mul/scale of the bivariate oracle commute with evaluation, and
    every evaluation equals the JAX package's."""
    rng = random.Random(0xB1)

    def rand_rows(h, w):
        return [[rng.randrange(R) for _ in range(w)] for _ in range(h)]

    ra, rb = rand_rows(3, 4), rand_rows(2, 5)
    a, b = BivariatePolynomial(ra), BivariatePolynomial(rb)
    ja, jb = JaxBivariate(ra), JaxBivariate(rb)
    k = rng.randrange(R)
    for _ in range(4):
        x, y = rng.randrange(R), rng.randrange(R)
        assert a.add(b).eval(x, y) == (a.eval(x, y) + b.eval(x, y)) % R
        assert a.mul(b).eval(x, y) == a.eval(x, y) * b.eval(x, y) % R
        assert a.scale(k).eval(x, y) == k * a.eval(x, y) % R
        assert BivariatePolynomial.zero().eval(x, y) == 0
        assert poly_eval(a.eval_x(x), y) == a.eval(x, y)
        assert poly_eval(a.eval_y(y), x) == a.eval(x, y)
        assert (a.mul(b).eval(x, y), a.add(b).eval_y(y), a.scale(k).eval_x(x)) == \
            (ja.mul(jb).eval(x, y), ja.add(jb).eval_y(y), ja.scale(k).eval_x(x))
