"""The pianist sweep's cases (4, 3), (5, 1), (5, 4) and (6, 1) on
fourier_tpu_torch against fourier_tpu, on the CPU: the checks of
test_torch_sweep.py.
"""

import pytest

import torch_sweep as sw

CASES = [(4, 3), (5, 1), (5, 4), (6, 1)]


@pytest.mark.parametrize("n,m", CASES)
def test_pianist_matches_jax(n, m):
    sw.sweep_case(n, m)
