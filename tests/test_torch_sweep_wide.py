"""The pianist sweep's cases with n >= 7 on fourier_tpu_torch against
fourier_tpu, on the CPU: the same checks as test_torch_sweep.py (which
holds the n <= 6 cases), in a file of their own so that the two halves
run in parallel.  At m = n - 1 a row is 2 points: 64 and 128 workers.
"""

import pytest

from torch_sweep import sweep_case

CASES = [(n, m) for n in (7, 8) for m in (1, n - 1)] + [(8, 4)]


@pytest.mark.parametrize("n,m", CASES)
def test_pianist_matches_jax_wide(n, m):
    sweep_case(n, m)
