"""The port's round as one call against the JAX package's, on the CPU.

At the inputs of tests/test_parallel.py's test_distributed_prove[2]
(scale 5 / machines_scale 2: M = 4 workers of T = 8, its secrets, rows,
alpha and beta, a mesh of 2 devices, tableless), so that the JAX program is
one that file compiles too: JAX's prove_inputs_from_backend tuple is
carried across by fourier_tpu_torch.convert, the port's own
prove_inputs_from_backend gives the same arguments, and the port's
build_distributed_prove on them gives every output of JAX's (master_com,
z, pi0, pi1, and each worker's commitment, eval and proof) as affine
points and ints.  The JAX round runs in a thread beside the port's.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import torch

from fourier_tpu.constants import R
from fourier_tpu.models.piano import PianoBackend, PianoFFTSettings, generate_trusted_setup
from fourier_tpu.parallel.mesh import make_mesh
from fourier_tpu.parallel.prove_sharded import build_distributed_prove, prove_inputs_from_backend
from fourier_tpu_torch import convert
from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.parallel import prove_sharded as tps

torch.set_num_threads(1)

SECRETS = (b"\x05" * 32, b"\x06" * 32)       # tests/test_parallel.py's


def _jax_round(backend, rows, alpha, beta):
    """(JAX's prove arguments as numpy, a future of its outputs)."""
    args = [np.asarray(a) for a in prove_inputs_from_backend(backend, rows, alpha, beta)]
    prove = build_distributed_prove(make_mesh(2, axis="workers"), axis="workers")
    return args, jax.block_until_ready(prove(*args))


def test_round_matches_jax(rng):
    n, m = 5, 2
    fft = PianoFFTSettings(n, m)
    backend = PianoBackend(fft, generate_trusted_setup(fft, SECRETS))
    rows = [[rng.randrange(R) for _ in range(fft.T)] for _ in range(fft.M)]
    alpha, beta = rng.randrange(R), rng.randrange(R)
    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(_jax_round, backend, rows, alpha, beta)
        tfft = tpiano.PianoFFTSettings(n, m, "cpu")
        tb = tpiano.PianoBackend(tfft, tpiano.generate_trusted_setup(tfft, SECRETS))
        own = tps.prove_inputs_from_backend(tb, rows, alpha, beta)
        args, jax_out = jax_side.result()
    carried = convert.prove_inputs_from_arrays(args, "cpu")
    assert len(carried) == len(own) == 12
    for a, b in zip(carried, own):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got = convert.prove_outputs_to_ints(tps.build_distributed_prove()(*carried))
    assert got == convert.prove_outputs_to_ints(jax_out)
    assert tb.master_verify(got["master_com"], beta, alpha, got["z"], (got["pi0"], got["pi1"]))
