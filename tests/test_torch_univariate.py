"""fourier_tpu_torch.models.univariate against fourier_tpu.models.univariate.

Both packages build the X-side SRS from the same secrets on the CPU and
commit and open the same seeded polynomials: at T = 16 (the JAX test's
PianoFFTSettings(5, 1): msm_naive, the ladder's plain twin) and at T = 128
with 100 coefficients (the tableless msm).  Commitments and proofs must
be byte-equal to the JAX class's, the port's proofs must verify and a
wrong value must be rejected.
"""

import random
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from fourier_tpu.constants import R
from fourier_tpu.models import piano as jpiano
from fourier_tpu.models.univariate import UnivariateKZG as JaxKZG
from fourier_tpu.refimpl.curve import g1_to_bytes
from fourier_tpu.refimpl.field import fr_to_bytes
from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.models.univariate import UnivariateKZG
from fourier_tpu_torch.refimpl import poly as rpoly

torch.set_num_threads(1)

SECRETS = (b"\x07" * 32, b"\x08" * 32)


def _answers(kzg, polys, x):
    """[(commitment, y, proof)] of each polynomial at x."""
    return [(kzg.commit_to_poly(coeffs), *kzg.compute_proof_single(coeffs, x))
            for coeffs in polys]


def _wire(answers):
    return [(g1_to_bytes(com), fr_to_bytes(y), g1_to_bytes(proof)) for com, y, proof in answers]


@pytest.mark.parametrize("n,m,lengths", [(5, 1, (16, 5)), (7, 0, (100,))],
                         ids=["T16_naive", "T128_tableless"])
def test_univariate_matches_jax(n, m, lengths):
    rng = random.Random(0x0E1 + n)
    polys = [[rng.randrange(R) for _ in range(k)] for k in lengths]
    x = rng.randrange(R)

    def jax_side():
        fft = jpiano.PianoFFTSettings(n, m)
        return _wire(_answers(JaxKZG(jpiano.generate_trusted_setup(fft, SECRETS), fft),
                              polys, x))

    with ThreadPoolExecutor(1) as pool:          # the reference alongside the port
        want = pool.submit(jax_side)
        fft = tpiano.PianoFFTSettings(n, m, "cpu")
        kzg = UnivariateKZG(tpiano.generate_trusted_setup(fft, SECRETS), fft)
        got = _answers(kzg, polys, x)
        assert _wire(got) == want.result()
    for coeffs, (com, y, proof) in zip(polys, got):
        assert y == rpoly.poly_eval(coeffs, x)
        assert kzg.verify_proof_single(com, x, y, proof)
        assert not kzg.verify_proof_single(com, x, (y + 1) % R, proof)
    with pytest.raises(ValueError, match="larger than the SRS"):
        kzg.commit_to_poly([1] * (fft.T + 1))
