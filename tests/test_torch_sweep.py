"""The pianist sweep on fourier_tpu_torch against fourier_tpu, on the CPU.

The reference sweep's cases with n <= 6 (tests/test_piano.py:109-135;
n >= 7 are in test_torch_sweep_wide.py): for each (n, m) both packages
build one trusted setup from the same secrets and their own window
tables, which must be equal limb for limb; every worker commits and
opens its row and the master aggregates, and every commitment, eval and
proof must be byte-equal to the JAX backend's; the port's worker and
master proofs verify, a wrong z is rejected, and z equals the bivariate
ground truth (models/bipoly.py).  Beside the sweep, the port's
counterparts of test_partial_commit, test_fake_poly, test_verify_default,
test_poly_reconstruction and test_bipoly_algebra (tests/test_piano.py),
the list-form helpers of models/piano.py, and one setup and FTPC file
round trip at (6, 2) that crosses between the packages.
"""

import random

import pytest

from fourier_tpu.constants import R
from fourier_tpu.models.bipoly import BivariatePolynomial as JaxBivariate
from fourier_tpu.refimpl.curve import g1_to_bytes
from fourier_tpu.runtime import io as jrio
from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.models.bipoly import BivariatePolynomial
from fourier_tpu_torch.refimpl.poly import poly_eval
from fourier_tpu_torch.runtime import io as trio

import torch_sweep as sw

CASES = [(2, 1)] + [(n, m) for n in range(3, 7) for m in (1, n - 1)] + [(6, 2), (6, 3)]


@pytest.mark.parametrize("n,m", CASES)
def test_pianist_matches_jax(n, m):
    sw.sweep_case(n, m)


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


def test_files_cross_between_packages_at_m2(tmp_path):
    """(6, 2): the JAX package's setup and FTPC files (its tables carry a
    tau_Y table, which the port skips) serve in the port, and the port's
    in the JAX package, with the same commitments as the originals."""
    jb, tb = sw.sides(6, 2)
    paths = {k: str(tmp_path / k) for k in ("js", "jp", "ts", "tp")}
    jrio.save_setup(jb.settings, paths["js"], True)
    jrio.save_precompute(jb.settings.precompute, paths["jp"])
    trio.save_setup(tb.settings, paths["ts"], True)
    trio.save_precompute(tb.settings.precompute, paths["tp"])

    from_jax = trio.load_setup(paths["js"], True, "cpu")
    from_jax.precompute = trio.load_precompute(paths["jp"], "cpu")
    assert len(from_jax.precompute.u_rows) == tb.fft.M
    port_loaded = tpiano.PianoBackend(tb.fft, from_jax)
    sw.same_setup(jb, port_loaded)

    from_port = jrio.load_setup(paths["ts"], True)
    from_port.precompute = jrio.load_precompute(paths["tp"])
    assert from_port.precompute.g1_tau_y is None
    jax_loaded = type(jb)(jb.fft, from_port)

    rng = random.Random(0xF1)
    row = sw.random_rows(tb.fft, rng)[2]
    alpha = rng.randrange(R)
    want = [g1_to_bytes(jb.worker_commit(2, row)), g1_to_bytes(jb.worker_open(2, row, alpha)[1])]
    for b in (port_loaded, jax_loaded, tb):
        assert [g1_to_bytes(b.worker_commit(2, row)),
                g1_to_bytes(b.worker_open(2, row, alpha)[1])] == want
