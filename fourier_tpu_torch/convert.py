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

from .models.piano import PianoPrecompute, PianoSettings
from .ops.curve import G1Aff, G1Jac


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
