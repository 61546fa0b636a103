"""The pianist sweep's cases with n = 8 on fourier_tpu_torch against
fourier_tpu, on the CPU: the checks of test_torch_sweep.py.  At (8, 7) a
row is 2 points: 128 workers, 256 BGMW MSMs on the port's side.
"""

import pytest

import torch_sweep as sw

# (8, 7) first: tests/test_piano.py reaches (8, 1) first, so its programs
# are in the compile cache by the time this file's (8, 1) runs.
CASES = [(8, 7), (8, 4), (8, 1)]


@pytest.mark.parametrize("n,m", CASES)
def test_pianist_matches_jax_wide(n, m):
    sw.sweep_case(n, m)
