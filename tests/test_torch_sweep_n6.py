"""The pianist sweep's cases (6, 5), (6, 2) and (6, 3) on fourier_tpu_torch
against fourier_tpu, on the CPU (the checks of test_torch_sweep.py), and
one setup and FTPC file round trip at (6, 2) that crosses between the
packages.
"""

import random

import pytest

from fourier_tpu.constants import R
from fourier_tpu.refimpl.curve import g1_to_bytes
from fourier_tpu.runtime import io as jrio
from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.runtime import io as trio

import torch_sweep as sw

CASES = [(6, 5), (6, 2), (6, 3)]


@pytest.mark.parametrize("n,m", CASES)
def test_pianist_matches_jax(n, m):
    sw.sweep_case(n, m)


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
