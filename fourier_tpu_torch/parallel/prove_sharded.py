"""The whole Pianist round as one call: every worker's commit and
evaluation-form open, then the master's aggregation.

Port of ``fourier_tpu.parallel.prove_sharded``.  What a deployment does
with M servers and a client moving base64 between them runs here as one
function over the M rows.  On one device it is one call in process; with
a group of D ranks (processes, or the in-process shards of
``mesh.LocalMesh``, as the reference runs over a local mesh) each rank
holds M / D rows (``prove_in_specs``), and
the per-worker commitments, evals and proofs are all-gathered before the
master step, which every rank then computes alike:

  workers: M row MSMs of the coefficients against U (BGMW tables where
  ``table_c`` is set, else the tableless MSM, ``msm_naive`` for rows of at
  most 64 points) and the evaluation-form opens of every row, which share
  one batch inversion of alpha - w^j;
  master: the point sums of the commitments and of the proofs (one tree
  kernel launch), the size-M inverse NTT of the evals, z by Horner at
  beta, the quotient by (Y - beta) and pi1 = msm_naive(g_tau_y, q).

Where the reference assumes alpha outside the left domain, the port
raises ValueError (the per-request open's coefficient-basis fallback
serves that case).
"""

from __future__ import annotations

import torch

from ..constants import FP_LIMBS, FR_LIMBS, R
from ..models.piano import _eval_form_open, _tensor
from ..ops import kernels
from ..ops import msm as msm_mod
from ..ops import msm_fused as mf
from ..ops.curve import G1Aff, G1Jac
from ..ops.field import FR
from ..ops.limbs import ints_to_vec
from ..ops.ntt import get_domain
from .mesh import all_gather_last, shard_device, size_rank


def _horner_eval(coeffs_m, x_m):
    """sum_k c_k x^k for [L, M] coefficients and x [L, 1] (Montgomery)."""
    acc = torch.zeros_like(x_m)
    for k in reversed(range(coeffs_m.shape[-1])):
        acc = FR.add(FR.mul(acc, x_m), coeffs_m[..., k:k + 1])
    return acc


def _div_linear(coeffs_m, x_m):
    """(f - f(x)) / (Y - x) for [L, M] coefficients: the [L, M - 1]
    quotient by synthetic division."""
    qs, acc = [], torch.zeros_like(x_m)
    for k in reversed(range(1, coeffs_m.shape[-1])):
        acc = FR.add(coeffs_m[..., k:k + 1], FR.mul(x_m, acc))
        qs.append(acc)
    return torch.cat(qs[::-1], dim=-1) if qs else coeffs_m[..., :0]


def prove_in_specs(table_c: int | None = None) -> tuple:
    """The worker axis of each argument of prove, in order (None: every
    rank holds all of it): U's x, y and mask, g_tau_y's x, y and mask,
    coeffs, alpha, beta, the left roots, the right roots and 1/T; with
    table_c, the packed row tables and their masks."""
    base = (1, 1, 0, None, None, None, 1, None, None, None, None, None)
    return base if table_c is None else base + (0, 0)


def local_inputs(args, group, table_c: int | None = None) -> tuple:
    """This rank's share of prove's arguments: its M / D rows of every
    argument with a worker axis (a slice of the row tables' sequences),
    everything on the rank's device."""
    D, d = size_rank(group)
    if D == 1:
        return tuple(args)
    dev = shard_device(group, args[0].device)
    out = []
    for a, axis in zip(args, prove_in_specs(table_c)):
        if axis is not None:
            m = a.shape[axis] if isinstance(a, torch.Tensor) else len(a)
            if m % D:
                raise ValueError(f"{m} workers do not divide over {D} ranks")
            k = m // D
            a = a.narrow(axis, d * k, k) if isinstance(a, torch.Tensor) else a[d * k:(d + 1) * k]
        out.append(a.to(dev) if isinstance(a, torch.Tensor) else [t.to(dev) for t in a])
    return tuple(out)


def build_distributed_prove(group=None, table_c: int | None = None):
    """Returns

        prove(u_x, u_y, u_inf, g_ty_x, g_ty_y, g_ty_inf, coeffs, alpha,
              beta, left_roots_mont, right_roots_mont, t_inv_mont
              [, ut_packed, ut_inf]) -> dict

    over this rank's share of the arguments (``local_inputs``; on one
    device, all of them).  group: None (one device), a process group
    (``mesh.Group``), or a ``mesh.LocalShard``, prove then being called
    from ``LocalMesh.run`` once for every shard.  coeffs, alpha and beta are canonical limbs
    ([FR_LIMBS, M/D, T], [FR_LIMBS, 1]); the rest as
    ``prove_inputs_from_backend`` makes them.  With table_c set the row
    MSMs run over the packed BGMW tables ut_packed, a sequence of M/D
    tensors [W*T, 24], with masks ut_inf, M/D tensors [W*T] (the
    reference passes the affine tables, stacked).

    The dict holds master_com, pi0 and pi1 (Jacobian [L, 1]), z
    (canonical [FR_LIMBS, 1]), and every worker's commits and proofs
    (Jacobian [L, M]) and evals (canonical [FR_LIMBS, M]), all equal on
    every rank."""

    def row_msms(u: G1Aff, ut, scalars) -> G1Jac:
        """[L, n] points: the MSM of row j of scalars [FR_LIMBS, n, T]
        against U row j % Ml of the Ml local rows (or its table)."""
        n, T = scalars.shape[1:]
        Ml = u.x.shape[1]
        if table_c is not None:
            outs = [mf.msm_fused_bgmw(ut[0][j % Ml], ut[1][j % Ml], scalars[:, j], table_c)
                    for j in range(n)]
        elif T <= 64:                                           # one ladder for all rows
            k = n // Ml
            return msm_mod.msm_naive(G1Aff(u.x.repeat(1, k, 1), u.y.repeat(1, k, 1),
                                           u.inf.repeat(k, 1)), scalars)
        else:
            outs = [msm_mod.msm(G1Aff(u.x[:, j % Ml], u.y[:, j % Ml], u.inf[j % Ml]),
                                scalars[:, j]) for j in range(n)]
        return G1Jac(*(torch.stack(c, dim=-1) for c in zip(*outs)))

    def prove(u_x, u_y, u_inf, gty_x, gty_y, gty_inf, coeffs, alpha, beta,
              left_roots, right_roots, t_inv, *ut):
        D, _ = size_rank(group)
        M = right_roots.shape[-1]
        Ml = coeffs.shape[1]
        if Ml * D != M:
            raise ValueError(f"{Ml} rows on each of {D} ranks, for {M} workers")
        y_mont, qhat_mont, any_zero = _eval_form_open(left_roots, FR.to_mont(coeffs),
                                                      FR.to_mont(alpha), t_inv)
        if any_zero:
            raise ValueError("alpha lies in the left evaluation domain")

        # worker commits and proofs: 2 Ml row MSMs, the commits first
        pts = row_msms(G1Aff(u_x, u_y, u_inf), ut,
                       torch.cat([coeffs, FR.from_mont(qhat_mont)], dim=1))

        # every rank gathers every worker's commitment, proof and eval
        mine = torch.cat([c[:, :Ml] for c in pts] + [c[:, Ml:] for c in pts]
                         + [FR.from_mont(y_mont[..., 0])])        # [6 L + FR_LIMBS, Ml]
        everyone = mine if D == 1 else all_gather_last(mine, group)
        commits, proofs = (G1Jac(*everyone[k * 3 * FP_LIMBS:(k + 1) * 3 * FP_LIMBS]
                                 .reshape(3, FP_LIMBS, M)) for k in (0, 1))
        evals = everyone[6 * FP_LIMBS:]                         # [FR_LIMBS, M]

        # master: both point sums in one tree launch, the Y-side open
        master_com, pi0 = kernels.g1_tree_reduce([(commits, -1, 1), (proofs, -1, 1)])
        coeffs_y = get_domain(M.bit_length() - 1).ntt(FR.to_mont(evals), inverse=True)
        beta_mont = FR.to_mont(beta)
        z_mont = _horner_eval(coeffs_y, beta_mont)
        q_pad = torch.cat([_div_linear(coeffs_y, beta_mont), torch.zeros_like(beta_mont)], -1)
        pi1 = msm_mod.msm_naive(G1Aff(gty_x, gty_y, gty_inf), FR.from_mont(q_pad))
        return {
            "master_com": master_com,
            "z": FR.from_mont(z_mont),
            "pi0": pi0,
            "pi1": G1Jac(*(c[..., None] for c in pi1)),
            "commits": commits,
            "evals": evals,
            "proofs": proofs,
        }

    return prove


def prove_inputs_from_backend(backend, rows, alpha: int, beta: int,
                              table_c: int | None = None) -> tuple:
    """The backend's state and the witness rows as prove's arguments, on
    the backend's device.  rows: M rows, each a list of ints or
    [FR_LIMBS, T] canonical limbs.  With table_c set, the packed tables of
    the U rows and their masks are appended, as two lists of one tensor a
    row: the backend's own tensors where its precompute has window
    table_c (nothing is copied), else expanded here (``bgmw_expand``)."""
    s, fft, dev = backend.settings, backend.fft, backend.device
    coeffs = torch.stack([backend._coeffs_to_device(r) for r in rows], dim=1)

    def fr(v):
        return _tensor(ints_to_vec(v, FR_LIMBS), dev)

    gty = s.g_tau_y
    args = (
        s.u.x, s.u.y, s.u.inf,
        gty.x, gty.y, gty.inf,
        coeffs,
        fr([alpha]), fr([beta]),
        fft.left_roots_mont(),
        fr([v * FR.mont_r % R for v in fft.right_roots]),
        fr([pow(fft.T, -1, R) * FR.mont_r % R]),
    )
    if table_c is None:
        return args
    pc = s.precompute
    packed, infs = [], []
    for i in range(fft.M):
        if pc is not None and pc.c == table_c and pc.u_rows[i] is not None:
            packed.append(pc.packed_row(i))
            infs.append(pc.u_rows[i].inf)
        else:
            table = msm_mod.bgmw_expand(s.u_row(i), table_c)
            packed.append(mf.pack_points(table))
            infs.append(table.inf)
    return args + (packed, infs)
