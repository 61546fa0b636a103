"""The PIANO/Pianist bivariate KZG protocol over PyTorch tensors.

Port of ``fourier_tpu.models.piano``.  A degree-N polynomial is split
into M = 2^m rows of T = 2^t Lagrange coefficients; worker i commits and
opens its row with one BGMW MSM against U row i's precomputed window
table, the master aggregates on the host.  As in the reference, a
worker's MSM is split over the local devices on its own (the backend's
``msm_devices``, by default every visible card when the device is CUDA;
``FOURIER_SHARD_MSM=0`` keeps one): each shard holds its slice of every
row table on its device (``parallel/msm_fused_sharded.py``), while the Fr
work of an open stays on the backend's device.  The
opening quotient is built in evaluation form (barycentric y, then
q(w^j) = (y - f_j) / (alpha - w^j)), as in the reference.  Verify and
the master role run on the host (the port's ``refimpl`` and ``native``).
A row without a table (its table would pass MAX_TABLE_POINTS, or a
precompute file carries none for it) serves through the tableless MSM.
The SRS and the tables come from setup and precompute files
(``runtime/io.py``) or are generated in memory.
"""

from __future__ import annotations

import logging
import os
import secrets as py_secrets
from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import FR_LIMBS, R, root_of_unity
from ..ops.limbs import bytes_be_to_limbs, ints_to_vec, vec_to_int, vec_to_ints
from ..refimpl import curve as rc
from ..refimpl import pairing as rp
from ..refimpl import poly as rpoly
from ..refimpl.field import hash_to_bls_field
from ..utils.trace import TRACER, span, timed

from ..ops import curve as cv
from ..ops import kernels
from ..ops import msm as msm_mod
from ..ops import msm_fused as mf
from ..ops.curve import G1Aff, G1Jac
from ..ops.field import FR, batch_inverse_host
from ..ops.ntt import get_domain
from ..parallel.mesh import LocalMesh, local_mesh
from ..parallel.msm_fused_sharded import (check_bucket_split, msm_fused_bgmw_local,
                                          msm_fused_sharded)
from ..runtime import io as rio

logger = logging.getLogger("fourier_tpu")


def _tensor(limbs, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(limbs).astype(np.int64), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


@dataclass
class SetupConfig:
    """The deployment's size (N = 2^scale coefficients over M =
    2^machines_scale workers) and where its SRS and tables come from.  As
    in the reference (config.rs:174-200), a part that is not generated is
    loaded from its path."""

    scale: int = 20
    machines_scale: int = 1
    setup_path: str | None = None
    precompute_path: str | None = None
    compressed: bool = True
    generate_setup: bool = True
    generate_precompute: bool = True


class PianoFFTSettings:
    """Two radix-2 domains: `left` of size T = 2^(n-m) (X), `right` of
    size M = 2^m (Y)."""

    def __init__(self, n: int, m: int, device="cuda"):
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
        with span("fft", sync=True, n=dom.n):
            if limbs.shape[-1] < dom.n:
                pad = np.zeros(limbs.shape[:-1] + (dom.n - limbs.shape[-1],), np.uint32)
                limbs = np.concatenate([limbs, pad], axis=-1)
            with span("fft.upload"):
                x = _tensor(limbs, self.device)
            with span("fft.ntt", sync=True):
                y = FR.from_mont(dom.ntt(FR.to_mont(x), inverse=inverse))
            with span("fft.readback"):
                return _host(y)

    def fft_left(self, values, inverse: bool) -> list[int]:
        return self.fft(values, True, inverse)

    def fft_right(self, values, inverse: bool) -> list[int]:
        return self.fft(values, False, inverse)

    def left_lagrange_poly(self, j: int) -> list[int]:
        return rpoly.lagrange_poly(j, self.t)

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
    The packed row form the K1 kernel reads is made once per table, or,
    for an MSM split over D shards, once per shard: D contiguous slices
    of the rows, each on its shard's device (``shard_rows``).

    Only the U rows have tables: the master opens against the host points
    in PianoSettings.g_tau_y_host, so the reference's tau_Y table has no
    reader here (precompute files skip it).  A row whose table is None
    serves tableless."""

    c: int
    u_rows: list                   # per-row G1Aff [L, W*T] or None
    _packed: dict = field(default_factory=dict, repr=False)

    # A table is W*n points x 96 B; past this many points a row serves
    # tableless.
    MAX_TABLE_POINTS = 1 << 25

    @staticmethod
    def window_for(n: int, shards: int = 1) -> int:
        """The reference's table window for an MSM split over `shards`
        devices (tables are built for the serving topology): small rows
        keep c = 8, others follow ops.msm_fused.bgmw_auto_window."""
        if n < (1 << 12):
            return 8
        return mf.bgmw_auto_window(n, shards=shards)

    @staticmethod
    def generate(settings: PianoSettings, c: int | None = None,
                 shards: int = 1) -> "PianoPrecompute":
        u = settings.u
        L, m, t_len = u.x.shape
        c = c or PianoPrecompute.window_for(t_len, shards)
        n_windows = -(-256 // c)
        if t_len * n_windows > PianoPrecompute.MAX_TABLE_POINTS:
            logger.warning(
                "precompute: table of %d points (%d windows x %d) exceeds "
                "MAX_TABLE_POINTS=%d; every row serves tableless",
                t_len * n_windows, n_windows, t_len, PianoPrecompute.MAX_TABLE_POINTS)
            return PianoPrecompute(c=c, u_rows=[None] * m)
        # Rows are expanded together, up to SETUP_CHUNK points at a time:
        # the same limbs as row by row, in fewer launches and tensor ops
        # where rows are short (M = 128 rows of 2 points at scale 8).
        per = max(1, SETUP_CHUNK // t_len)
        u_rows = []
        for lo in range(0, m, per):
            k = min(per, m - lo)
            flat = msm_mod.bgmw_expand(G1Aff(u.x[:, lo:lo + k].reshape(L, k * t_len),
                                             u.y[:, lo:lo + k].reshape(L, k * t_len),
                                             u.inf[lo:lo + k].reshape(k * t_len)), c)
            # lane w*k*T + i*T + j of the expansion is lane w*T + j of row lo + i
            u_rows += [G1Aff(*(a.unflatten(-1, (n_windows, k, t_len))[..., i, :].flatten(-2)
                               for a in flat)) for i in range(k)]
        return PianoPrecompute(c=c, u_rows=u_rows)

    def packed_row(self, i: int) -> torch.Tensor:
        if i not in self._packed:
            self._packed[i] = mf.pack_points(self.u_rows[i])
        return self._packed[i]

    def shard_rows(self, i: int, devices) -> list:
        """Row i's table split over len(devices) shards: for shard d, its
        d-th contiguous slice of the rows, packed, and of the infinity
        mask, on devices[d]."""
        key = (i, tuple(str(d) for d in devices))
        if key not in self._packed:
            table, D = self.u_rows[i], len(devices)
            k = table.x.shape[-1] // D
            self._packed[key] = [
                (mf.pack_points(G1Aff(*(a[..., d * k:(d + 1) * k] for a in table))).to(dev),
                 table.inf[d * k:(d + 1) * k].to(dev)) for d, dev in enumerate(devices)]
        return self._packed[key]


def msm_mesh(device, msm_devices=None) -> LocalMesh | None:
    """The shards of a worker's MSM: None (one device) where
    FOURIER_SHARD_MSM=0 or the list has one entry.  msm_devices defaults
    to every visible card when `device` is CUDA, else to [device]."""
    if os.environ.get("FOURIER_SHARD_MSM", "1") == "0":
        return None
    if msm_devices is None and torch.device(device).type != "cuda":
        msm_devices = [device]
    return local_mesh(msm_devices)


def _msm_dispatch(settings: PianoSettings, i: int, scalars,
                  mesh: LocalMesh | None = None) -> G1Jac:
    """MSM of row i's scalars against U row i, the reference's branches in
    its order: the BGMW table where the row has one, split over the mesh
    where it divides the table's rows; rows of at most 64 points through
    msm_naive, on one device; the tableless MSM, split along the points at
    the shards' window where the mesh divides them; else one device's."""
    precompute = settings.precompute
    table = None if precompute is None else precompute.u_rows[i]
    if table is not None:
        if mesh is not None and table.x.shape[-1] % mesh.size == 0:
            return msm_fused_bgmw_local(mesh, precompute.shard_rows(i, mesh.devices), scalars,
                                        precompute.c)
        return mf.msm_fused_bgmw(precompute.packed_row(i), table.inf, scalars, precompute.c)
    points = settings.u_row(i)
    n = points.x.shape[-1]
    if n <= 64:
        return msm_mod.msm_naive(points, scalars)
    if mesh is not None and n % mesh.size == 0:
        c = msm_mod._auto_window(n // mesh.size)
        return mesh.run(lambda shard: msm_fused_sharded(points, scalars, c, shard))[0]
    return msm_mod.msm(points, scalars)


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
    """(y_mont [L, ..., 1], qhat_mont [L, ..., T], any_zero_diff) for
    Lagrange values f_j on the domain and a point alpha, all Montgomery:

    y      = (alpha^T - 1)/T * sum_j f_j w^j / (alpha - w^j)
    q(w^j) = (y - f_j) / (alpha - w^j)

    roots [L, T], alpha and t_inv [L, 1]; f [L, T] is one row, [L, ..., T]
    a batch of rows, which share the one batch inversion of alpha - w^j.
    On a card the hand-written kernels of ops/kernels.py fr_quotient; on
    the CPU their plain twin.
    """
    return kernels.fr_quotient(roots_mont, f_mont, alpha_mont, t_inv_mont)


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
    """Worker/master commit-open-verify engine on one torch device, its
    row MSMs split over `msm_devices` (see msm_mesh; a device may repeat).
    Host-facing values are Python ints and refimpl affine points; row
    coefficients are [FR_LIMBS, T] canonical limbs (numpy or lists).

    With several shards, every row table must split over them: a shard
    count that cannot split the tables' bucket space raises ValueError
    here, once, and each shard's slices of the tables are placed on its
    device here too."""

    def __init__(self, fft: PianoFFTSettings, settings: PianoSettings, device=None,
                 msm_devices=None):
        self.fft = fft
        self.settings = settings
        self.device = torch.device(device) if device is not None else fft.device
        self.mesh = msm_mesh(self.device, msm_devices)
        pc = settings.precompute
        if self.mesh is not None and pc is not None:
            for i, table in enumerate(pc.u_rows):
                if table is not None:
                    signed = table.x.shape[-1] // fft.T == mf.signed_window_count(pc.c)
                    check_bucket_split(pc.c, signed, self.mesh.size)
                    if table.x.shape[-1] % self.mesh.size == 0:
                        pc.shard_rows(i, self.mesh.devices)

    @property
    def msm_devices(self) -> list:
        """The devices the row MSMs run on, one a shard."""
        return [self.device] if self.mesh is None else list(self.mesh.devices)

    # -- utils ---------------------------------------------------------------

    def random_bivariate_polynomial(self) -> list[list[int]]:
        """M rows of T uniform values mod R, as Python ints (the list form
        of random_bivariate_limbs)."""
        return [[int.from_bytes(os.urandom(32), "big") % R for _ in range(self.fft.T)]
                for _ in range(self.fft.M)]

    def random_bivariate_limbs(self) -> np.ndarray:
        """[M, FR_LIMBS, T] canonical rows: uniform 256-bit values mod R,
        reduced by a Montgomery round trip."""
        m, t = self.fft.M, self.fft.T
        limbs = bytes_be_to_limbs(os.urandom(32 * m * t), 32, FR_LIMBS)
        red = _host(FR.from_mont(FR.to_mont(_tensor(limbs.T, self.device))))
        return red.reshape(FR_LIMBS, m, t).transpose(1, 0, 2)

    def random_point(self) -> int:
        return int.from_bytes(os.urandom(32), "big") % R

    def evaluate(self, coeffs: list[int], x: int) -> int:
        return rpoly.poly_eval(coeffs, x)

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
        with span("msm", sync=True):
            out = _msm_dispatch(self.settings, i, scalars, self.mesh)
        with span("commit.lift"):
            return cv.jac_to_int_points(_lift(out))[0]

    def worker_commit(self, i: int, coeffs):
        """MSM of the Lagrange coefficients against U row i."""
        if not 0 <= i < self.fft.M:
            raise ValueError(f"machine index {i} out of range")
        with span("worker_commit", T=self.fft.T):
            with span("commit.upload"):
                sc = self._coeffs_to_device(coeffs)
            return self._row_msm(i, sc)

    def worker_open(self, i: int, coeffs, alpha: int):
        """(f_i(alpha), pi_0^{(i)}) via the evaluation-form quotient."""
        if not 0 <= i < self.fft.M:
            raise ValueError(f"machine index {i} out of range")
        with span("worker_open", T=self.fft.T):
            with span("open.upload"):
                sc = self._coeffs_to_device(coeffs)
            f_mont = FR.to_mont(sc)
            alpha_mont = FR.to_mont(_tensor(ints_to_vec([alpha], FR_LIMBS), self.device))
            t_inv = _tensor(ints_to_vec([pow(self.fft.T, -1, R) * FR.mont_r % R], FR_LIMBS),
                            self.device)
            with span("open.quotient", sync=True) as quotient:
                launched = kernels.COUNTERS.total() if TRACER.on else None
                y_m, qhat_m, any_zero = _eval_form_open(self.fft.left_roots_mont(), f_mont,
                                                        alpha_mont, t_inv)
                if launched is not None:
                    quotient.add(launches=kernels.COUNTERS.total() - launched)
            if any_zero:  # alpha hits the domain: coefficient-basis fallback
                with span("open.fallback"):
                    return self._worker_open_coeff_fallback(i, sc, alpha)
            with span("open.eval"):
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
    def setup(cfg: SetupConfig, device="cuda", msm_devices=None) -> "PianoBackend":
        """The SRS and the window tables, each generated in memory or
        loaded from its file (the reference's piano.rs:87-122); generated
        tables take the window of the MSM's shard count.  A file's tables
        serve at any shard count that splits their buckets."""
        fft = PianoFFTSettings(cfg.scale, cfg.machines_scale, device)
        mesh = msm_mesh(fft.device, msm_devices)
        shards = 1 if mesh is None else mesh.size
        if cfg.generate_setup:
            secrets = (py_secrets.token_bytes(32), py_secrets.token_bytes(32))
            settings = timed("Generating Trusted Setup",
                             lambda: generate_trusted_setup(fft, secrets))
        else:
            settings = timed("Reading trusted setup from file",
                             lambda: rio.load_setup(cfg.setup_path, cfg.compressed, device))
        if cfg.generate_precompute:
            settings.precompute = timed("Generating Precomputations",
                                        lambda: PianoPrecompute.generate(settings,
                                                                         shards=shards))
        else:
            settings.precompute = timed("Loading Precomputations from file",
                                        lambda: rio.load_precompute(cfg.precompute_path, device))
        return timed("Placing the tables on the MSM's shards",
                     lambda: PianoBackend(fft, settings, device, msm_devices))

    @staticmethod
    def setup_and_save(cfg: SetupConfig, device="cuda", msm_devices=None) -> "PianoBackend":
        """setup, then write the SRS and the tables to the paths given."""
        backend = PianoBackend.setup(cfg, device, msm_devices)
        if cfg.setup_path:
            rio.save_setup(backend.settings, cfg.setup_path, cfg.compressed)
        if cfg.precompute_path:
            rio.save_precompute(backend.settings.precompute, cfg.precompute_path)
        return backend


def _lift(p: G1Jac) -> G1Jac:
    """batch-() point -> batch-(1,)"""
    return G1Jac(*(c[..., None] for c in p))
