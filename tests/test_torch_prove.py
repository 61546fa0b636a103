"""The port's round as one call (parallel/prove_sharded.py) against the
port's own per-request round, on the CPU.

For M = 1, 2 and 4 workers (scale 4, machines_scale 0, 1 and 2: T = 16, 8
and 4), the port's backend with its window tables commits and opens every
row and the master aggregates (torch_sweep.transcript, the round the sweep
holds byte-equal to the JAX package); build_distributed_prove on one
device must give the same commitments, evals, proofs, master commitment,
z, pi0 and pi1: tabled (the backend's tables reused), with tables of
another window (expanded by prove_inputs_from_backend), and tableless
(msm_naive over all rows in one ladder).  The aggregate proof verifies
and a wrong z is rejected; an alpha in the left domain raises ValueError.
"""

import functools
import random

import pytest
import torch

from fourier_tpu_torch.constants import R
from fourier_tpu_torch.convert import prove_outputs_to_ints
from fourier_tpu_torch.parallel import prove_sharded as ps

import torch_sweep as sw

torch.set_num_threads(1)

# (machines_scale, how the rows' MSMs run)
CASES = [(0, "tabled"), (0, "tableless"), (0, "expanded"), (1, "tabled"), (1, "tableless"),
         (2, "tabled"), (2, "tableless")]


@functools.lru_cache(maxsize=None)
def _case(m: int):
    """(backend, rows, alpha, beta, per-request transcript) at scale 4."""
    tb = sw._port_backend(4, m)
    rng = random.Random(0x70 + m)
    rows = sw.random_rows(tb.fft, rng)
    alpha, beta = rng.randrange(R), rng.randrange(R)
    return tb, rows, alpha, beta, sw.transcript(tb, rows, alpha, beta)[0]


@pytest.mark.parametrize("m,mode", CASES)
def test_round_matches_per_request(m, mode):
    tb, rows, alpha, beta, want = _case(m)
    table_c = {"tabled": tb.settings.precompute.c, "expanded": 9, "tableless": None}[mode]
    prove = ps.build_distributed_prove(None, table_c)
    got = prove_outputs_to_ints(prove(*ps.prove_inputs_from_backend(tb, rows, alpha, beta,
                                                                    table_c)))
    assert got["commits"] == want["coms"]
    assert got["evals"] == want["evals"]
    assert got["proofs"] == want["proofs"]
    assert (got["master_com"], got["z"], (got["pi0"], got["pi1"])) == \
        (want["mc"], want["z"], want["pi"])
    pi = (got["pi0"], got["pi1"])
    assert tb.master_verify(got["master_com"], beta, alpha, got["z"], pi)
    assert not tb.master_verify(got["master_com"], beta, alpha, (got["z"] + 1) % R, pi)


def test_alpha_in_domain_raises():
    tb, rows, _, beta, _ = _case(1)
    args = ps.prove_inputs_from_backend(tb, rows, tb.fft.left_roots[3], beta)
    with pytest.raises(ValueError, match="left evaluation domain"):
        ps.build_distributed_prove()(*args)
