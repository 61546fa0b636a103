"""Carry a setup and its window tables from the JAX package across.

The reference's ``PianoSettings`` and ``PianoPrecompute`` hold their
point batches as ``uint32[24, ...]`` Montgomery limb arrays; the port
holds the same limbs as int64 tensors.  These functions take any object
with the reference's attribute names whose point batches are array-likes
(``x``, ``y``, ``inf``) and build the port's objects on `device`, so
both packages commit with the same SRS and the same tables.  Nothing
here imports jax: callers pass numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.piano import PianoPrecompute, PianoSettings
from .ops.curve import G1Aff


def affine_from_arrays(points, device="cpu") -> G1Aff:
    """(x, y, inf) array-likes -> a G1Aff of int64 limb tensors."""
    return G1Aff(
        torch.as_tensor(np.asarray(points.x).astype(np.int64), device=device),
        torch.as_tensor(np.asarray(points.y).astype(np.int64), device=device),
        torch.as_tensor(np.asarray(points.inf).astype(bool), device=device),
    )


def precompute_from_arrays(src, device="cpu") -> PianoPrecompute:
    """The U row tables; the reference's tau_Y table has no counterpart."""
    def table(t):
        return None if t is None else affine_from_arrays(t, device)

    return PianoPrecompute(c=int(src.c), u_rows=[table(t) for t in src.u_rows])


def settings_from_arrays(src, device="cpu") -> PianoSettings:
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
