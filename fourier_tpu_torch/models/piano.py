"""The PIANO/Pianist bivariate KZG protocol over PyTorch tensors.

Port of ``fourier_tpu.models.piano``, single device.  A degree-N
polynomial is split into M = 2^m rows of T = 2^t Lagrange coefficients;
worker i commits and opens its row with one BGMW MSM against U row i's
precomputed window table, the master aggregates on the host.  The
opening quotient is built in evaluation form (barycentric y, then
q(w^j) = (y - f_j) / (alpha - w^j)), as in the reference.  Verify and
the master role run the shared host code (``fourier_tpu.refimpl`` and
``fourier_tpu.native``).

Not ported yet: setup and precompute files (``runtime/io.py``) and the
tableless MSM, which serves a row only when precompute is off or its
table would exceed MAX_TABLE_POINTS.
"""

from __future__ import annotations

import logging
import os
import secrets as py_secrets
from dataclasses import dataclass, field

import numpy as np
import torch

from fourier_tpu.constants import FR_LIMBS, R, root_of_unity
from fourier_tpu.ops.limbs import bytes_be_to_limbs, ints_to_vec, vec_to_int, vec_to_ints
from fourier_tpu.refimpl import curve as rc
from fourier_tpu.refimpl import pairing as rp
from fourier_tpu.refimpl import poly as rpoly
from fourier_tpu.refimpl.field import hash_to_bls_field
from fourier_tpu.utils.timing import timed

from ..ops import curve as cv
from ..ops import msm as msm_mod
from ..ops import msm_fused as mf
from ..ops.curve import G1Aff, G1Jac
from ..ops.field import FR, batch_inverse_host
from ..ops.ntt import get_domain

logger = logging.getLogger("fourier_tpu")


def _tensor(limbs, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(limbs).astype(np.int64), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


@dataclass
class SetupConfig:
    """The deployment's size: N = 2^scale coefficients over M = 2^machines_scale
    workers.  The SRS and tables are generated in memory (files are not
    ported yet)."""

    scale: int = 20
    machines_scale: int = 1


class PianoFFTSettings:
    """Two radix-2 domains: `left` of size T = 2^(n-m) (X), `right` of
    size M = 2^m (Y)."""

    def __init__(self, n: int, m: int, device="cpu"):
        if m > n:
            raise ValueError("m must be less than or equal to n")
        self.n = n
        self.m = m
        self.t = n - m
        self.device = torch.device(device)
        self.left = get_domain(self.t)
        self.right = get_domain(self.m)
        self.T = 1 << self.t
        self.M = 1 << self.m
        self.left_roots = self._powers(root_of_unity(self.t), self.T)
        self.right_roots = self._powers(root_of_unity(self.m), self.M)
        self._left_roots_mont = None

    @staticmethod
    def _powers(w: int, n: int) -> list[int]:
        out = [1] * n
        for i in range(1, n):
            out[i] = out[i - 1] * w % R
        return out

    def left_roots_mont(self) -> torch.Tensor:
        """[FR_LIMBS, T] Montgomery tensor of the left domain points."""
        if self._left_roots_mont is None:
            self._left_roots_mont = _tensor(
                ints_to_vec([v * FR.mont_r % R for v in self.left_roots], FR_LIMBS),
                self.device)
        return self._left_roots_mont

    def fft(self, values: list[int], left: bool, inverse: bool) -> list[int]:
        """Zero-padding NTT over Python ints."""
        if len(values) > (self.left if left else self.right).n:
            raise ValueError(f"input length {len(values)} exceeds domain")
        return vec_to_ints(self.fft_limbs(ints_to_vec(values, FR_LIMBS), left, inverse))

    def fft_limbs(self, limbs, left: bool, inverse: bool) -> np.ndarray:
        """NTT over canonical [FR_LIMBS, n] limbs, zero-padded to the
        domain; returns canonical uint32 [FR_LIMBS, domain] limbs."""
        dom = self.left if left else self.right
        limbs = np.asarray(limbs)
        if limbs.shape[-1] > dom.n:
            raise ValueError(f"input length {limbs.shape[-1]} exceeds domain {dom.n}")
        if limbs.shape[-1] < dom.n:
            pad = np.zeros(limbs.shape[:-1] + (dom.n - limbs.shape[-1],), np.uint32)
            limbs = np.concatenate([limbs, pad], axis=-1)
        x = FR.to_mont(_tensor(limbs, self.device))
        return _host(FR.from_mont(dom.ntt(x, inverse=inverse)))

    def fft_left(self, values, inverse: bool) -> list[int]:
        return self.fft(values, True, inverse)

    def right_lagrange_poly(self, i: int) -> list[int]:
        return rpoly.lagrange_poly(i, self.m)


# ---------------------------------------------------------------------------
# SRS + precompute
# ---------------------------------------------------------------------------

@dataclass
class PianoSettings:
    """g, g^{tau_X^j} (j < T), g^{tau_Y^i} (i < M), the M x T U matrix and
    the G2 side; point batches are affine Montgomery limb tensors."""

    g: tuple
    g_tau_x: G1Aff                # [L, T]
    g_tau_y: G1Aff                # [L, M]
    u: G1Aff                      # [L, M, T]
    g2: tuple
    g2_tau_x: tuple
    g2_tau_y: tuple
    g_tau_y_host: list = field(default_factory=list)
    precompute: "PianoPrecompute | None" = None

    def u_row(self, i: int) -> G1Aff:
        return G1Aff(self.u.x[:, i], self.u.y[:, i], self.u.inf[i])


@dataclass
class PianoPrecompute:
    """BGMW window tables: all W * n (window, point) rows of a table
    accumulate into one set of buckets (ops.msm_fused.msm_fused_bgmw).
    The packed row form the K1 kernel reads is made once per table.

    Only the U rows have tables: the reference's tau_Y table serves its
    setup files alone (runtime/io.py, not ported); the master opens
    against the host points in PianoSettings.g_tau_y_host."""

    c: int
    u_rows: list                   # per-row G1Aff [L, W*T] or None
    _packed: dict = field(default_factory=dict, repr=False)

    # A table is W*n points x 96 B; past this many points a row would
    # serve tableless, which is not ported yet.
    MAX_TABLE_POINTS = 1 << 25

    @staticmethod
    def window_for(n: int) -> int:
        """The reference's table window on one device: small rows keep
        c = 8, others follow ops.msm_fused.bgmw_auto_window."""
        if n < (1 << 12):
            return 8
        return mf.bgmw_auto_window(n, shards=1)

    @staticmethod
    def generate(settings: PianoSettings, c: int | None = None) -> "PianoPrecompute":
        t_len = settings.u.x.shape[2]
        c = c or PianoPrecompute.window_for(t_len)

        def expand(points: G1Aff):
            n = points.x.shape[-1]
            n_windows = -(-256 // c)
            if n * n_windows > PianoPrecompute.MAX_TABLE_POINTS:
                logger.warning(
                    "precompute: table of %d points (%d windows x %d) exceeds "
                    "MAX_TABLE_POINTS=%d; this row has no table",
                    n * n_windows, n_windows, n, PianoPrecompute.MAX_TABLE_POINTS)
                return None
            return msm_mod.bgmw_expand(points, c)

        u_rows = [expand(settings.u_row(i)) for i in range(settings.u.x.shape[1])]
        return PianoPrecompute(c=c, u_rows=u_rows)

    def packed_row(self, i: int) -> torch.Tensor:
        if i not in self._packed:
            self._packed[i] = mf.pack_points(self.u_rows[i])
        return self._packed[i]


def _msm_dispatch(precompute: PianoPrecompute | None, i: int, scalars) -> G1Jac:
    """MSM of row i's scalars against U row i's BGMW table: the
    single-device tabled branch of the reference.  A row without a table
    (precompute off, or past MAX_TABLE_POINTS) needs the tableless MSM."""
    table = None if precompute is None else precompute.u_rows[i]
    if table is None:
        raise NotImplementedError("tableless MSM not yet ported")
    return mf.msm_fused_bgmw(precompute.packed_row(i), table.inf, scalars, precompute.c)


# ---------------------------------------------------------------------------
# Trusted setup generation
# ---------------------------------------------------------------------------

def _lagrange_evals_at(tau: int, roots: list[int]) -> list[int]:
    """L_j(tau) = (w^j / n) * (tau^n - 1) / (tau - w^j) for all j."""
    n = len(roots)
    if tau in set(roots):
        k = roots.index(tau)
        return [1 if j == k else 0 for j in range(n)]
    n_inv = pow(n, -1, R)
    tau_n = pow(tau, n, R) - 1
    invs = batch_inverse_host([(tau - wj) % R for wj in roots], R)
    return [wj * n_inv % R * tau_n % R * inv % R for wj, inv in zip(roots, invs)]


# Fixed-base generation runs in chunks of this many points: one K1 launch
# and one affine conversion each.
SETUP_CHUNK = 1 << 19


def generate_trusted_setup(fft: PianoFFTSettings, secrets: tuple[bytes, bytes]) -> PianoSettings:
    tau_x = hash_to_bls_field(secrets[0])
    tau_y = hash_to_bls_field(secrets[1])
    T, M = fft.T, fft.M
    dev = fft.device

    powers_x = fft._powers(tau_x, T)
    powers_y = fft._powers(tau_y, M)
    r_evals = _lagrange_evals_at(tau_y, fft.right_roots)
    l_evals = _lagrange_evals_at(tau_x, fft.left_roots)
    u_scalars = [r * l % R for r in r_evals for l in l_evals]  # M*T, row-major
    g = rc.G1_GEN

    def fb(scalars, label):
        xs, ys, infs = [], [], []
        n = len(scalars)
        for lo in range(0, n, SETUP_CHUNK):
            part = scalars[lo : lo + SETUP_CHUNK]
            sc = _tensor(ints_to_vec(part, FR_LIMBS), dev)
            aff = cv.to_affine_batched(msm_mod.fixed_base_msm(g, sc))
            xs.append(aff.x)
            ys.append(aff.y)
            infs.append(aff.inf)
            logger.info("setup %s: %d%% (%d/%d)", label, (lo + len(part)) * 100 // n,
                        lo + len(part), n)
        return G1Aff(torch.cat(xs, dim=-1), torch.cat(ys, dim=-1), torch.cat(infs, dim=-1))

    g_tau_x = timed("g_tau_x powers", lambda: fb(powers_x, "g_tau_x"))
    g_tau_y = timed("g_tau_y powers", lambda: fb(powers_y, "g_tau_y"))
    u_flat = timed("U matrix", lambda: fb(u_scalars, "U matrix"))
    u = G1Aff(u_flat.x.reshape(u_flat.x.shape[0], M, T),
              u_flat.y.reshape(u_flat.y.shape[0], M, T),
              u_flat.inf.reshape(M, T))

    g2_tau_x = rc.g2_mul(rc.G2_GEN, tau_x)
    g2_tau_y = rc.g2_mul(rc.G2_GEN, tau_y)
    return PianoSettings(
        g=g, g_tau_x=g_tau_x, g_tau_y=g_tau_y, u=u, g2=rc.G2_GEN,
        g2_tau_x=g2_tau_x, g2_tau_y=g2_tau_y,
        g_tau_y_host=cv.jac_to_int_points(cv.from_affine(g_tau_y)),
    )


# ---------------------------------------------------------------------------
# Evaluation-form opening
# ---------------------------------------------------------------------------

def _eval_form_open(roots_mont, f_mont, alpha_mont, t_inv_mont):
    """(y_mont [L, 1], qhat_mont [L, T], any_zero_diff) for Lagrange values
    f_j on the domain and a point alpha, all Montgomery:

    y      = (alpha^T - 1)/T * sum_j f_j w^j / (alpha - w^j)
    q(w^j) = (y - f_j) / (alpha - w^j)
    """
    T = roots_mont.shape[-1]
    diffs = FR.sub(alpha_mont, roots_mont)
    any_zero = bool(FR.is_zero(diffs).any())
    invd = FR.batch_inv(diffs)
    alpha_t = FR.pow_const(alpha_mont, T)
    one = FR.broadcast_const("one_mont", (1,), roots_mont.device)
    factor = FR.mul(FR.sub(alpha_t, one), t_inv_mont)
    s = FR.mul(FR.mul(f_mont, roots_mont), invd)
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = FR.add(s[..., :h], s[..., h:])
    y = FR.mul(factor, s)
    qhat = FR.mul(FR.sub(y, f_mont), invd)
    return y, qhat, any_zero


def _poly_eval_device(f_mont, x_mont):
    """sum_i f_i x^i for [L, n] Montgomery coefficients, n a power of two:
    a log-doubling power ladder, one product and a tree sum."""
    n = f_mont.shape[-1]
    p = FR.broadcast_const("one_mont", (1,), f_mont.device)
    xk = x_mont
    while p.shape[-1] < n:
        p = torch.cat([p, FR.mul(p, xk)], dim=-1)
        xk = FR.square(xk)
    terms = FR.mul(f_mont, p)
    while terms.shape[-1] > 1:
        h = terms.shape[-1] // 2
        terms = FR.add(terms[..., :h], terms[..., h:])
    return terms


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------

class PianoBackend:
    """Worker/master commit-open-verify engine on one torch device.
    Host-facing values are Python ints and refimpl affine points; row
    coefficients are [FR_LIMBS, T] canonical limbs (numpy or lists)."""

    def __init__(self, fft: PianoFFTSettings, settings: PianoSettings, device=None):
        self.fft = fft
        self.settings = settings
        self.device = torch.device(device) if device is not None else fft.device

    # -- utils ---------------------------------------------------------------

    def random_bivariate_limbs(self) -> np.ndarray:
        """[M, FR_LIMBS, T] canonical rows: uniform 256-bit values mod R,
        reduced by a Montgomery round trip."""
        m, t = self.fft.M, self.fft.T
        limbs = bytes_be_to_limbs(os.urandom(32 * m * t), 32, FR_LIMBS)
        red = _host(FR.from_mont(FR.to_mont(_tensor(limbs.T, self.device))))
        return red.reshape(FR_LIMBS, m, t).transpose(1, 0, 2)

    def random_point(self) -> int:
        return int.from_bytes(os.urandom(32), "big") % R

    def evaluate_limbs(self, limbs: np.ndarray, x: int) -> int:
        """f(x) over canonical [FR_LIMBS, n] coefficient limbs; small
        inputs stay on the host."""
        limbs = np.asarray(limbs)
        n = limbs.shape[-1]
        if n == 0:
            return 0
        if n <= 2048:
            return rpoly.poly_eval(vec_to_ints(limbs), x)
        pow2 = 1 << (n - 1).bit_length()
        if n < pow2:
            limbs = np.concatenate(
                [limbs, np.zeros((limbs.shape[0], pow2 - n), np.uint32)], axis=-1)
        xm = FR.to_mont(_tensor(ints_to_vec([x], FR_LIMBS), self.device))
        y_m = _poly_eval_device(FR.to_mont(_tensor(limbs, self.device)), xm)
        return vec_to_int(_host(FR.from_mont(y_m)))

    def _coeffs_to_device(self, coeffs) -> torch.Tensor:
        """list[int] (zero-padded to T) or ready [FR_LIMBS, T] limbs."""
        if isinstance(coeffs, (list, tuple)):
            if len(coeffs) > self.fft.T:
                raise ValueError("polynomial larger than sub-circuit size")
            coeffs = ints_to_vec(list(coeffs) + [0] * (self.fft.T - len(coeffs)), FR_LIMBS)
        return _tensor(coeffs, self.device)

    # -- protocol: worker side ---------------------------------------------------

    def _row_msm(self, i: int, scalars) -> tuple:
        out = _msm_dispatch(self.settings.precompute, i, scalars)
        return cv.jac_to_int_points(_lift(out))[0]

    def worker_commit(self, i: int, coeffs):
        """MSM of the Lagrange coefficients against U row i."""
        if not 0 <= i < self.fft.M:
            raise ValueError(f"machine index {i} out of range")
        return self._row_msm(i, self._coeffs_to_device(coeffs))

    def worker_open(self, i: int, coeffs, alpha: int):
        """(f_i(alpha), pi_0^{(i)}) via the evaluation-form quotient."""
        if not 0 <= i < self.fft.M:
            raise ValueError(f"machine index {i} out of range")
        sc = self._coeffs_to_device(coeffs)
        f_mont = FR.to_mont(sc)
        alpha_mont = FR.to_mont(_tensor(ints_to_vec([alpha], FR_LIMBS), self.device))
        t_inv = _tensor(ints_to_vec([pow(self.fft.T, -1, R) * FR.mont_r % R], FR_LIMBS),
                        self.device)
        y_m, qhat_m, any_zero = _eval_form_open(self.fft.left_roots_mont(), f_mont,
                                                alpha_mont, t_inv)
        if any_zero:  # alpha hits the domain: coefficient-basis fallback
            return self._worker_open_coeff_fallback(i, sc, alpha)
        y = vec_to_int(_host(FR.from_mont(y_m)))
        return y, self._row_msm(i, FR.from_mont(qhat_m))

    def _worker_open_coeff_fallback(self, i: int, sc, alpha: int):
        coeff_ints = self.fft.fft_left(vec_to_ints(_host(sc)), True)
        y = rpoly.poly_eval(coeff_ints, alpha)
        q = rpoly.poly_div_linear(coeff_ints, alpha)
        q_hat = self.fft.fft_left(q + [0] * (self.fft.T - len(q)), False)
        return y, self._row_msm(i, _tensor(ints_to_vec(q_hat, FR_LIMBS), self.device))

    def worker_verify(self, i: int, commitment, alpha: int, y: int, pi) -> bool:
        """e(com - g^{y'}, g2) == e(pi, g2^{tau_X - alpha}), on the host."""
        if not 0 <= i < self.fft.M:
            return False
        r_coeffs = self.fft.right_lagrange_poly(i)
        r_i_tau_y = rc.g1_msm_fast(self.settings.g_tau_y_host, r_coeffs)
        com_minus = rc.g1_sub_fast(commitment, rc.g1_mul_fast(r_i_tau_y, y))
        g2_tau_x_minus_alpha = rc.g2_sub_fast(
            self.settings.g2_tau_x, rc.g2_mul_fast(self.settings.g2, alpha))
        return rp.pairings_verify_single(com_minus, self.settings.g2, pi,
                                         g2_tau_x_minus_alpha)

    # -- protocol: master side ---------------------------------------------------

    def master_commit(self, commitments: list) -> object:
        return rc.g1_sum(commitments)

    def master_open(self, evals: list[int], proofs: list, beta: int):
        """(z, (pi_0, pi_1)): aggregate the proofs and open along Y."""
        pi0 = rc.g1_sum(proofs)
        coeffs = rpoly.ntt(evals, self.fft.m, inverse=True)
        z = rpoly.poly_eval(coeffs, beta)
        q = rpoly.poly_div_linear(coeffs, beta)
        pi1 = rc.g1_msm_fast(self.settings.g_tau_y_host[: len(q)], q)
        return z, (pi0, pi1)

    def master_verify(self, commitment, beta: int, alpha: int, z: int, pi) -> bool:
        pi0, pi1 = pi
        com_minus_z = rc.g1_sub_fast(commitment, rc.g1_mul_fast(self.settings.g, z))
        g2 = self.settings.g2
        b12 = rc.g2_sub_fast(self.settings.g2_tau_x, rc.g2_mul_fast(g2, alpha))
        b22 = rc.g2_sub_fast(self.settings.g2_tau_y, rc.g2_mul_fast(g2, beta))
        return rp.pairings_verify(com_minus_z, g2, pi0, b12, pi1, b22)

    # -- construction ------------------------------------------------------------

    @staticmethod
    def setup(cfg: SetupConfig, device="cpu") -> "PianoBackend":
        """Generate the SRS and the window tables in memory."""
        fft = PianoFFTSettings(cfg.scale, cfg.machines_scale, device)
        secrets = (py_secrets.token_bytes(32), py_secrets.token_bytes(32))
        settings = timed("Generating Trusted Setup",
                         lambda: generate_trusted_setup(fft, secrets))
        settings.precompute = timed("Generating Precomputations",
                                    lambda: PianoPrecompute.generate(settings))
        return PianoBackend(fft, settings, device)


def _lift(p: G1Jac) -> G1Jac:
    """batch-() point -> batch-(1,)"""
    return G1Jac(*(c[..., None] for c in p))
