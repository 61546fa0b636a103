"""Carry setups, window tables and point batches from the JAX package across.

The reference's ``PianoSettings`` and ``PianoPrecompute`` hold their
point batches as ``uint32[24, ...]`` Montgomery limb arrays, and its
``ops.fp2`` holds Fp2 elements as ``uint32[24, 2, ...]`` (limb axis, then
the component axis); the port holds the same limbs, in the same layout,
as int64 tensors.  These functions take any object with the reference's
attribute names whose point batches are array-likes (``x``, ``y``,
``z`` or ``inf``) and build the port's objects on `device`, so both
packages compute on the same points.  Nothing here imports jax: callers
pass numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.piano import PianoBackend, PianoFFTSettings, PianoPrecompute, PianoSettings
from .ops import curve as cv
from .ops.curve import G1Aff, G1Jac
from .ops.limbs import vec_to_ints
from .ops.msm_fused import pack_points


def limbs_from_array(a, device="cuda") -> torch.Tensor:
    """A uint32 limb array (Fp [L, *batch] or Fp2 [L, 2, *batch]) -> the
    int64 tensor of the same limbs and shape."""
    return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)


def affine_from_arrays(points, device="cuda") -> G1Aff:
    """(x, y, inf) array-likes -> a G1Aff of int64 limb tensors (G1, or G2
    with Fp2 coordinates)."""
    return G1Aff(limbs_from_array(points.x, device), limbs_from_array(points.y, device),
                 torch.as_tensor(np.asarray(points.inf).astype(bool), device=device))


def jac_from_arrays(points, device="cuda") -> G1Jac:
    """(x, y, z) array-likes -> a G1Jac of int64 limb tensors (G1, or G2
    with Fp2 coordinates)."""
    return G1Jac(*(limbs_from_array(c, device) for c in (points.x, points.y, points.z)))


def precompute_from_arrays(src, device="cuda") -> PianoPrecompute:
    """The U row tables; the reference's tau_Y table has no counterpart."""
    def table(t):
        return None if t is None else affine_from_arrays(t, device)

    return PianoPrecompute(c=int(src.c), u_rows=[table(t) for t in src.u_rows])


def settings_from_arrays(src, device="cuda") -> PianoSettings:
    return PianoSettings(
        g=src.g,
        g_tau_x=affine_from_arrays(src.g_tau_x, device),
        g_tau_y=affine_from_arrays(src.g_tau_y, device),
        u=affine_from_arrays(src.u, device),
        g2=src.g2,
        g2_tau_x=src.g2_tau_x,
        g2_tau_y=src.g2_tau_y,
        g_tau_y_host=list(src.g_tau_y_host),
        precompute=(None if src.precompute is None
                    else precompute_from_arrays(src.precompute, device)),
    )


def backend_from_arrays(src, device="cuda", msm_devices=None) -> PianoBackend:
    """The reference's backend (its fft's n and m, its settings with their
    tables) as a port backend on `device`, its row MSMs split over
    `msm_devices` (PianoBackend's default where None)."""
    fft = PianoFFTSettings(src.fft.n, src.fft.m, device)
    return PianoBackend(fft, settings_from_arrays(src.settings, device), device, msm_devices)


def prove_inputs_from_arrays(args, device="cuda") -> tuple:
    """The reference's prove_inputs_from_backend tuple (u_x, u_y, u_inf,
    g_ty_x, g_ty_y, g_ty_inf, coeffs, alpha, beta, left_roots, right_roots,
    t_inv[, ut_x, ut_y, ut_inf]) as array-likes -> the arguments of the
    port's prove (parallel/prove_sharded.py): the same limbs as int64
    tensors, the masks as bool, and the affine row tables, where present,
    as the lists of packed rows ([W*T, 24] each) and masks ([W*T]) the
    port reads."""
    masks = (2, 5)
    out = tuple(torch.as_tensor(np.asarray(a).astype(bool), device=device) if k in masks
                else limbs_from_array(a, device) for k, a in enumerate(args[:12]))
    if len(args) == 12:
        return out
    tx, ty, tinf = (np.asarray(a) for a in args[12:])
    tables = [affine_from_arrays(G1Aff(tx[:, i], ty[:, i], tinf[i]), device)
              for i in range(tinf.shape[0])]
    return out + ([pack_points(t) for t in tables], [t.inf for t in tables])


def prove_outputs_to_ints(out) -> dict:
    """A prove output dict of either package -> affine points (refimpl
    tuples, None at infinity) and ints: master_com, z, pi0, pi1, and the
    lists commits, evals and proofs."""

    def arr(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    def points(p):
        return cv.jac_to_int_points(G1Jac(*(torch.as_tensor(arr(c).astype(np.int64))
                                            for c in p)))

    return {
        "master_com": points(out["master_com"])[0],
        "z": vec_to_ints(arr(out["z"]))[0],
        "pi0": points(out["pi0"])[0],
        "pi1": points(out["pi1"])[0],
        "commits": points(out["commits"]),
        "evals": vec_to_ints(arr(out["evals"])),
        "proofs": points(out["proofs"]),
    }
