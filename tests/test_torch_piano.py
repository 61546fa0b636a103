"""fourier_tpu_torch.models.piano against fourier_tpu.models.piano.

At scale 4 / machines 1 with the pinned fixture's secrets: the port's own
trusted setup and window tables equal the JAX package's limb for limb;
the JAX setup carried across by fourier_tpu_torch.convert commits and
opens to the JAX backend's bytes (including the coefficient-basis
fallback for an alpha in the domain); and the port's own backend
reproduces the pinned transcript, with its tables and without them.
"""

import json
import os
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fourier_tpu.constants import FR_LIMBS, R
from fourier_tpu.models import piano as jpiano
from fourier_tpu.ops.limbs import ints_to_vec
from fourier_tpu.refimpl.curve import g1_to_bytes
from fourier_tpu.refimpl.field import fr_to_bytes
from fourier_tpu.runtime import wire
from fourier_tpu_torch import convert
from fourier_tpu_torch.models import piano as tpiano

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "protocol_transcript_s4_m1.json")


@pytest.fixture(scope="module")
def fx():
    with open(FIXTURE) as fh:
        return json.load(fh)


def _secrets(fx):
    return tuple(bytes.fromhex(h) for h in fx["secrets_hex"])


def _jax_side(fx):
    """JAX settings with tables (as numpy) and a JAX backend without
    tables (its CPU MSM path)."""
    fft = jpiano.PianoFFTSettings(fx["scale"], fx["machines_scale"])
    settings = jpiano.generate_trusted_setup(fft, _secrets(fx))
    backend = jpiano.PianoBackend(fft, settings)
    pre = jpiano.PianoPrecompute.generate(settings)

    def arrays(p):
        return None if p is None else type(p)(*(np.asarray(c) for c in p))

    numpy_settings = jpiano.PianoSettings(
        g=settings.g, g_tau_x=arrays(settings.g_tau_x), g_tau_y=arrays(settings.g_tau_y),
        u=arrays(settings.u), g2=settings.g2, g2_tau_x=settings.g2_tau_x,
        g2_tau_y=settings.g2_tau_y, g_tau_y_host=settings.g_tau_y_host,
        precompute=jpiano.PianoPrecompute(c=pre.c, g1_tau_y=arrays(pre.g1_tau_y),
                                          u_rows=[arrays(t) for t in pre.u_rows]))
    return backend, numpy_settings


def _port_backend(fx):
    fft = tpiano.PianoFFTSettings(fx["scale"], fx["machines_scale"], "cpu")
    settings = tpiano.generate_trusted_setup(fft, _secrets(fx))
    settings.precompute = tpiano.PianoPrecompute.generate(settings)
    return tpiano.PianoBackend(fft, settings)


@pytest.fixture(scope="module")
def both_sides(fx):
    """(_jax_side, _port_backend), the two setups built side by side."""
    with ThreadPoolExecutor(1) as pool:
        jax = pool.submit(_jax_side, fx)
        port = _port_backend(fx)
        return jax.result(), port


@pytest.fixture(scope="module")
def jax_side(both_sides):
    return both_sides[0]


@pytest.fixture(scope="module")
def port_backend(both_sides):
    return both_sides[1]


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x).astype(np.int64),
                                      y.numpy().astype(np.int64))


def test_setup_and_tables_match_jax(jax_side, port_backend):
    _, ref = jax_side
    got = port_backend.settings
    for name in ("g_tau_x", "g_tau_y", "u"):
        _same(getattr(ref, name), getattr(got, name))
    assert got.g_tau_y_host == ref.g_tau_y_host
    assert (got.g2_tau_x, got.g2_tau_y) == (ref.g2_tau_x, ref.g2_tau_y)
    assert got.precompute.c == ref.precompute.c == 8
    for a, b in zip(ref.precompute.u_rows, got.precompute.u_rows):
        _same(a, b)


def test_converted_backend_matches_jax_bytes(fx, jax_side):
    jbackend, ref = jax_side
    settings = convert.settings_from_arrays(ref, device="cpu")
    fft = tpiano.PianoFFTSettings(fx["scale"], fx["machines_scale"], "cpu")
    backend = tpiano.PianoBackend(fft, settings)
    rng = random.Random(0xB17E)
    rows = fx["rows"] + [[rng.randrange(R) for _ in range(backend.fft.T)]]
    in_domain = backend.fft.left_roots[3]
    # past 2048 coefficients evaluate runs on the device
    limbs = ints_to_vec([rng.randrange(R) for _ in range(3000)], FR_LIMBS)

    def answers(b, verify):
        """Every answer of backend b as bytes or ints, in one order."""
        out = []
        for i, row in enumerate(rows):
            i %= b.fft.M
            com = b.worker_commit(i, row)
            out.append(g1_to_bytes(com))
            for alpha in (fx["alpha"], in_domain):
                y, pi = b.worker_open(i, row, alpha)
                out.append((fr_to_bytes(y), g1_to_bytes(pi)))
                if verify:
                    assert b.worker_verify(i, com, alpha, y, pi)
        return out + [b.fft.fft(rows[0], True, True), b.fft.fft(rows[0][:2], False, False),
                      b.evaluate_limbs(limbs, fx["alpha"])]

    with ThreadPoolExecutor(1) as pool:           # the reference alongside the port
        want = pool.submit(answers, jbackend, False)
        got = answers(backend, True)
        assert got == want.result()


def test_port_reproduces_pinned_transcript(fx, port_backend):
    b = port_backend

    def g1(p):
        return wire.b64_encode(g1_to_bytes(p))

    def fr(v):
        return wire.b64_encode(fr_to_bytes(v))

    alpha, beta = fx["alpha"], fx["beta"]
    coms, evals, proofs = [], [], []
    for i, row in enumerate(fx["rows"]):
        com = b.worker_commit(i, row)
        y, pi = b.worker_open(i, row, alpha)
        assert g1(com) == fx["commitments"][i]
        assert fr(y) == fx["evals"][i] and g1(pi) == fx["proofs"][i]
        assert b.worker_verify(i, com, alpha, y, pi)
        coms.append(com)
        evals.append(y)
        proofs.append(pi)
    mc = b.master_commit(coms)
    z, (pi0, pi1) = b.master_open(evals, proofs, beta)
    assert g1(mc) == fx["master_commitment"]
    assert (fr(z), g1(pi0), g1(pi1)) == (fx["z"], fx["pi_0"], fx["pi_1"])
    assert b.master_verify(mc, beta, alpha, z, (pi0, pi1))


def test_tableless_rows_reproduce_pinned_transcript(fx, port_backend):
    """Without tables every row serves tableless (msm_naive: 8 points a
    row) and gives the pinned transcript's commitments, evals and proofs."""
    settings = port_backend.settings
    saved = settings.precompute
    settings.precompute = None
    try:
        for i, row in enumerate(fx["rows"]):
            y, pi = port_backend.worker_open(i, row, fx["alpha"])
            assert (g1_to_bytes(port_backend.worker_commit(i, row)), fr_to_bytes(y),
                    g1_to_bytes(pi)) == (wire.b64_decode(fx["commitments"][i]),
                                         wire.b64_decode(fx["evals"][i]),
                                         wire.b64_decode(fx["proofs"][i]))
    finally:
        settings.precompute = saved
