"""Shared helpers of the pianist sweep parity tests (tests/test_torch_sweep*.py
and tests/test_torch_prove.py).

For an (n, m) case both packages build one trusted setup from SECRETS and
their own window tables, side by side in two threads, once per process;
a transcript is every worker's commitment, eval and proof and the
master's commitment, z and proofs, as bytes.
"""

from __future__ import annotations

import functools
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fourier_tpu.constants import R
from fourier_tpu.models import piano as jpiano
from fourier_tpu.refimpl.curve import g1_to_bytes
from fourier_tpu.refimpl.field import fr_to_bytes
from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.models.bipoly import BivariatePolynomial
from fourier_tpu_torch.refimpl import poly as rpoly

torch.set_num_threads(1)

SECRETS = (b"\x01" * 32, b"\x02" * 32)       # tests/test_piano.py's


def _jax_backend(n: int, m: int):
    fft = jpiano.PianoFFTSettings(n, m)
    settings = jpiano.generate_trusted_setup(fft, SECRETS)
    settings.precompute = jpiano.PianoPrecompute.generate(settings)
    return jpiano.PianoBackend(fft, settings)


def _port_backend(n: int, m: int):
    fft = tpiano.PianoFFTSettings(n, m, "cpu")
    settings = tpiano.generate_trusted_setup(fft, SECRETS)
    settings.precompute = tpiano.PianoPrecompute.generate(settings)
    return tpiano.PianoBackend(fft, settings)


@functools.lru_cache(maxsize=None)
def sides(n: int, m: int):
    """(JAX backend, port backend) of case (n, m), built side by side."""
    with ThreadPoolExecutor(1) as pool:
        jax = pool.submit(_jax_backend, n, m)
        port = _port_backend(n, m)
        return jax.result(), port


def same_limbs(jax_arr, port_tensor):
    np.testing.assert_array_equal(np.asarray(jax_arr).astype(np.int64),
                                  port_tensor.cpu().numpy())


def same_setup(jb, tb):
    """The port's setup and tables equal the JAX package's limb for limb."""
    for name in ("g_tau_x", "g_tau_y", "u"):
        for a, b in zip(getattr(jb.settings, name), getattr(tb.settings, name)):
            same_limbs(a, b)
    assert tb.settings.g_tau_y_host == jb.settings.g_tau_y_host
    assert tb.settings.precompute.c == jb.settings.precompute.c
    for ta, tt in zip(jb.settings.precompute.u_rows, tb.settings.precompute.u_rows):
        for a, b in zip(ta, tt):
            same_limbs(a, b)


def random_rows(fft, rng) -> list[list[int]]:
    return [[rng.randrange(R) for _ in range(fft.T)] for _ in range(fft.M)]


def ground_truth(fft, rows) -> BivariatePolynomial:
    """Lagrange-basis rows -> the standard-basis bivariate polynomial."""
    x_coeffs = [rpoly.ntt(row, fft.t, inverse=True) for row in rows]
    y_coeffs = [rpoly.ntt(list(col), fft.m, inverse=True) for col in zip(*x_coeffs)]
    return BivariatePolynomial([[y_coeffs[b][a] for b in range(fft.T)]
                                for a in range(fft.M)])


def transcript(b, rows, alpha, beta, active=None):
    """(points, wire bytes) of the distributed round on backend b: every
    active worker commits and opens its row at alpha (an inactive one
    gives the identity, eval 0 and no proof), the master aggregates and
    opens at beta."""
    coms, evals, proofs = [], [], []
    for i, row in enumerate(rows):
        if active is None or i in active:
            coms.append(b.worker_commit(i, row))
            y, pi = b.worker_open(i, row, alpha)
        else:
            coms.append(None)
            y, pi = 0, None
        evals.append(y)
        proofs.append(pi)
    mc = b.master_commit(coms)
    z, (pi0, pi1) = b.master_open(evals, proofs, beta)
    points = dict(coms=coms, evals=evals, proofs=proofs, mc=mc, z=z, pi=(pi0, pi1))
    wire = ([g1_to_bytes(c) for c in coms], [fr_to_bytes(y) for y in evals],
            [g1_to_bytes(p) for p in proofs], g1_to_bytes(mc), fr_to_bytes(z),
            g1_to_bytes(pi0), g1_to_bytes(pi1))
    return points, wire


def both_transcripts(jb, tb, rows, alpha, beta, active=None):
    """The port's transcript (points, bytes), asserted byte-equal to the
    JAX backend's, which runs alongside in a thread."""
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(transcript, jb, rows, alpha, beta, active)
        got, got_bytes = transcript(tb, rows, alpha, beta, active)
        assert got_bytes == want.result()[1]
    return got


def sweep_case(n, m):
    """One case of the sweep: setups, the round on both packages, verifies."""
    jb, tb = sides(n, m)
    same_setup(jb, tb)
    rng = random.Random(0xF0F0 + 16 * n + m)
    rows = random_rows(tb.fft, rng)
    alpha, beta = rng.randrange(R), rng.randrange(R)
    got = both_transcripts(jb, tb, rows, alpha, beta)
    for i, (com, y, pi) in enumerate(zip(got["coms"], got["evals"], got["proofs"])):
        assert tb.worker_verify(i, com, alpha, y, pi), f"worker {i}"
    z = got["z"]
    assert z == ground_truth(tb.fft, rows).eval(alpha, beta)
    assert tb.master_verify(got["mc"], beta, alpha, z, got["pi"])
    assert not tb.master_verify(got["mc"], beta, alpha, (z + 1) % R, got["pi"])
