"""Beside the pianist sweep, on fourier_tpu_torch against fourier_tpu on the
CPU: the port's counterparts of test_poly_reconstruction, test_fake_poly
and test_partial_commit (tests/test_piano.py) and the list-form helpers of
models/piano.py.
"""

import random

from fourier_tpu.constants import R
from fourier_tpu.refimpl.curve import g1_to_bytes
from fourier_tpu_torch.refimpl.poly import poly_eval

import torch_sweep as sw


def test_poly_reconstruction():
    """Distributed evaluation equals direct bivariate evaluation, in both
    packages (the master opens evals alone, no proofs)."""
    jb, tb = sw.sides(6, 2)
    rng = random.Random(0x4E)
    rows = sw.random_rows(tb.fft, rng)
    alpha, beta = rng.randrange(R), rng.randrange(R)
    evals = [tb.worker_open(i, row, alpha)[0] for i, row in enumerate(rows)]
    z, _ = tb.master_open(evals, [None] * len(evals), beta)
    assert z == sw.ground_truth(tb.fft, rows).eval(alpha, beta)
    assert z == jb.master_open(evals, [None] * len(evals), beta)[0]


def test_list_form_helpers_match_jax():
    """random_bivariate_polynomial, evaluate, fft_right and
    left_lagrange_poly: the list-form surface, equal to the JAX package's."""
    jb, tb = sw.sides(6, 2)
    rng = random.Random(0x15)
    poly = tb.random_bivariate_polynomial()
    assert len(poly) == tb.fft.M and all(len(r) == tb.fft.T and max(r) < R for r in poly)
    col, x = [rng.randrange(R) for _ in range(tb.fft.M)], rng.randrange(R)
    assert tb.evaluate(poly[1], x) == jb.evaluate(poly[1], x) == poly_eval(poly[1], x)
    for inverse in (False, True):
        assert tb.fft.fft_right(col, inverse) == jb.fft.fft_right(col, inverse)
    assert tb.fft.fft_right(tb.fft.fft_right(col, False), True) == col
    for j in (0, 5, tb.fft.T - 1):
        assert tb.fft.left_lagrange_poly(j) == jb.fft.left_lagrange_poly(j)
    assert tb.fft.fft_left(tb.fft.left_lagrange_poly(5), False) == [
        int(k == 5) for k in range(tb.fft.T)]


def test_partial_commit():
    """Inactive machines contribute the identity and eval 0, and the
    aggregate still verifies, with the JAX package's bytes."""
    jb, tb = sw.sides(6, 2)
    rng = random.Random(0x9A)
    rows = sw.random_rows(tb.fft, rng)
    alpha, beta = rng.randrange(R), rng.randrange(R)
    got = sw.both_transcripts(jb, tb, rows, alpha, beta, active=(0, 2))
    assert got["coms"][1] is None and got["proofs"][3] is None
    assert tb.master_verify(got["mc"], beta, alpha, got["z"], got["pi"])


def test_fake_poly():
    """A lying worker passes iff the verifier trusts the worker-supplied
    eval: a proof of a fake row fails against the honest commitment and
    holds against its own; bytes equal to the JAX package's."""
    jb, tb = sw.sides(4, 1)
    rng = random.Random(0xFA)
    honest, fake = (sw.random_rows(tb.fft, rng)[0] for _ in range(2))
    alpha = rng.randrange(R)

    def answers(b):
        y, pi = b.worker_open(0, fake, alpha)
        return b.worker_commit(0, honest), b.worker_commit(0, fake), y, pi

    def wire(a):
        com_h, com_f, y, pi = a
        return g1_to_bytes(com_h), g1_to_bytes(com_f), y, g1_to_bytes(pi)

    com_honest, com_fake, y_fake, pi_fake = got = answers(tb)
    assert wire(got) == wire(answers(jb))
    assert not tb.worker_verify(0, com_honest, alpha, y_fake, pi_fake)
    assert tb.worker_verify(0, com_fake, alpha, y_fake, pi_fake)
