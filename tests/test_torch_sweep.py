"""The pianist sweep on fourier_tpu_torch against fourier_tpu, on the CPU.

The reference sweep's cases (tests/test_piano.py:109-135): for each (n, m)
both packages build one trusted setup from the same secrets and their own
window tables, which must be equal limb for limb; every worker commits and
opens its row and the master aggregates, and every commitment, eval and
proof must be byte-equal to the JAX backend's; the port's worker and
master proofs verify, a wrong z is rejected, and z equals the bivariate
ground truth (models/bipoly.py).  This file holds the cases with n <= 4.

The sweep's cases and its other tests are spread over small files
(test_torch_sweep{,_n4,_n6,_helpers,_wide,_n8}.py): pytest-xdist hands out
files with fewer tests later, so each runs once tests/test_piano.py has
compiled the same JAX programs, and the files run side by side.
"""

import pytest

import torch_sweep as sw

CASES = [(2, 1), (3, 1), (3, 2), (4, 1)]


@pytest.mark.parametrize("n,m", CASES)
def test_pianist_matches_jax(n, m):
    sw.sweep_case(n, m)
