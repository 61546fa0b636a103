"""The port's multi-process round on the CPU over gloo: the counterparts of
tests/test_parallel.py's multihost dryruns.

spawn_dryrun starts 2 processes (two workers each) and 4 (one worker each,
the reference's one server a machine) at scale 5 / machines_scale 2; they
run the round over one group (parallel/multihost.py), and each holds the
master outputs and every commitment against its backend's per-request
round, verifies the aggregate proof and rejects a wrong z.
"""

import pytest

from fourier_tpu_torch.parallel.multihost import spawn_dryrun


@pytest.mark.e2e
@pytest.mark.parametrize("n_processes", [2, 4])
def test_spawn_dryrun(n_processes):
    """The round over 2 processes (two workers each) and over 4 (one
    worker each, the reference's one server a machine)."""
    spawn_dryrun(n_processes, scale=5, machines_scale=2, device="cpu", timeout=600)
