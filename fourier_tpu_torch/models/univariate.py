"""Univariate KZG commit/open/verify (the reference's legacy L2' surface).

Port of ``fourier_tpu.models.univariate``.  The reference ships a generic
univariate KZG backend (Backend trait, reference
src/engine/backend.rs:4-47; BlstBackend, src/engine/blst.rs:35-289) that
its README documents, though the module is compiled out of its live build
(SURVEY.md L2').  The same capability over the X-side SRS that the Piano
setup already carries (``settings.g_tau_x``):

    commit(f)      = g^{f(tau)}           (MSM against tau powers)
    open(f, x)     = (f(x), g^{q(tau)}),  q = (f - f(x)) / (X - x)
    verify         = e(com - g^y, g2) == e(pi, g2^{tau - x})

The MSM is the JAX class's branch: ``msm_naive`` (K5's ladder, then K2) up
to 64 coefficients, the tableless ``msm`` (K1, the tree kernel, K4) above
that; on a CPU tensor both run their plain twins.  Verify runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import FR_LIMBS, R
from ..ops import curve as cv
from ..ops import msm as msm_mod
from ..ops.curve import G1Aff, G1Jac
from ..ops.limbs import ints_to_vec
from ..refimpl import curve as rc
from ..refimpl import pairing as rp
from ..refimpl import poly as rpoly


class UnivariateKZG:
    """Single-machine KZG over the X-side SRS (degree < T), on the device
    of ``settings.g_tau_x``."""

    def __init__(self, settings, fft):
        self.settings = settings
        self.fft = fft

    def _tau_powers(self, n: int) -> G1Aff:
        g = self.settings.g_tau_x
        return G1Aff(g.x[..., :n], g.y[..., :n], g.inf[..., :n])

    def _msm(self, points: G1Aff, coeffs: list[int]):
        sc = torch.as_tensor(ints_to_vec(coeffs, FR_LIMBS).astype(np.int64),
                             device=points.x.device)
        if len(coeffs) <= 64:
            out = msm_mod.msm_naive(points, sc)
        else:
            out = msm_mod.msm(points, sc)
        return cv.jac_to_int_points(G1Jac(*(c[..., None] for c in out)))[0]

    def commit_to_poly(self, coeffs: list[int]):
        """g^{f(tau_X)} for monomial-basis coefficients (Backend::commit_to_poly)."""
        if len(coeffs) > self.fft.T:
            raise ValueError("polynomial larger than the SRS")
        return self._msm(self._tau_powers(len(coeffs)), [c % R for c in coeffs])

    def compute_proof_single(self, coeffs: list[int], x: int):
        """(f(x), proof) - Backend::compute_proof_single."""
        coeffs = [c % R for c in coeffs]
        y = rpoly.poly_eval(coeffs, x)
        q = rpoly.poly_div_linear(coeffs, x)
        if not q:
            return y, None
        return y, self._msm(self._tau_powers(len(q)), q)

    def verify_proof_single(self, commitment, x: int, y: int, proof) -> bool:
        """e(com - g^y, g2) == e(pi, g2^{tau_X - x}) - Backend::verify_proof_single."""
        com_minus_y = rc.g1_sub_fast(commitment, rc.g1_mul_fast(self.settings.g, y))
        g2_tau_minus_x = rc.g2_sub_fast(
            self.settings.g2_tau_x, rc.g2_mul_fast(self.settings.g2, x))
        return rp.pairings_verify_single(com_minus_y, self.settings.g2, proof,
                                         g2_tau_minus_x)
