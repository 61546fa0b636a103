"""Fp2 and G2 on the device: the quadratic-extension twin of ops/curve.py.

Port of ``fourier_tpu.ops.fp2``.  The reference's FsG2 lives in blst and
serves the verify side only; the serving path keeps the host C++ of
``native`` for its single-point G2 algebra.  This module is the batched
form: Fp2 arithmetic as a Field-shaped adapter over the base Fp engine
(ops/field.py), so the field-generic Jacobian formulas of ops/curve.py
run unchanged for G2, plus batched scalar multiplication.

An Fp2 element is an int64 tensor ``[L, 2, *batch]`` of the port's 16-bit
Montgomery limbs: the limb axis first (what the base Field expects), the
real/imaginary component axis second, the batch after; the same limbs as
the JAX package's ``uint32[L, 2, *batch]``.  u^2 = -1 (BLS12-381's
quadratic non-residue), so a product is one Karatsuba over the two
components.  The JAX module reaches no Pallas kernel: these are plain
tensor ops on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import FP_LIMBS, G2_GENERATOR_X, G2_GENERATOR_Y
from . import curve as cv
from .curve import G1Aff, G1Jac
from .field import FP
from .limbs import ints_to_vec, vec_to_ints


class FP2Field:
    """Field-protocol adapter: Fp2 ops over [L, 2, *batch] limb tensors.

    The surface the point formulas of ops/curve.py consume (add, sub,
    mul, square, is_zero, select, broadcast_const), plus inv; linear ops
    treat the component axis as one more batch axis, products combine the
    components by Karatsuba."""

    def __init__(self, base):
        self.base = base

    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    @staticmethod
    def _split(a):
        return a[:, 0], a[:, 1]

    def mul(self, a, b):
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        f = self.base
        t0 = f.mul(a0, b0)
        t1 = f.mul(a1, b1)
        t2 = f.mul(f.add(a0, a1), f.add(b0, b1))
        c0 = f.sub(t0, t1)
        c1 = f.sub(f.sub(t2, t0), t1)
        return torch.stack([c0, c1], dim=1)

    def square(self, a):
        a0, a1 = self._split(a)
        f = self.base
        c0 = f.mul(f.add(a0, a1), f.sub(a0, a1))
        t = f.mul(a0, a1)
        c1 = f.add(t, t)
        return torch.stack([c0, c1], dim=1)

    def inv(self, a):
        """(a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2); 0 -> 0."""
        a0, a1 = self._split(a)
        f = self.base
        n = f.add(f.mul(a0, a0), f.mul(a1, a1))
        ninv = f.inv(n)
        c0 = f.mul(a0, ninv)
        c1 = f.mul(f.neg(a1), ninv)
        return torch.stack([c0, c1], dim=1)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=1).all(dim=0)

    @staticmethod
    def select(mask, a, b):
        """mask ? a : b, with mask shaped like the batch dims."""
        return torch.where(mask[None, None], a, b)

    def broadcast_const(self, name: str, batch_shape, device):
        """A base-field constant (by name, as Field.broadcast_const) as
        (value, 0) in Fp2.  The curve formulas pass batch_shape =
        z.shape[1:], whose leading dim is the component axis."""
        if batch_shape[0] != 2:
            raise ValueError("Fp2 tensors carry the component axis")
        re = self.base.broadcast_const(name, tuple(batch_shape[1:]), device)
        return torch.stack([re, torch.zeros_like(re)], dim=1)


FP2 = FP2Field(FP)


# -- G2 points ---------------------------------------------------------------
# The G1Jac / G1Aff containers, with [L, 2, *batch] coordinates.

def g2_identity(batch_shape, device="cuda") -> G1Jac:
    shape = (FP_LIMBS, 2) + tuple(batch_shape)
    return G1Jac(*(torch.zeros(shape, dtype=torch.int64, device=device) for _ in range(3)))


def _fp2_const(pair, batch_shape, device) -> torch.Tensor:
    vals = [c * FP.mont_r % FP.modulus for c in pair]
    arr = torch.as_tensor(ints_to_vec(vals, FP_LIMBS).astype(np.int64), device=device)
    return arr.reshape((FP_LIMBS, 2) + (1,) * len(batch_shape)).expand(
        (FP_LIMBS, 2) + tuple(batch_shape)).clone()


def g2_generator_jac(batch_shape=(), device="cuda") -> G1Jac:
    return G1Jac(
        _fp2_const(G2_GENERATOR_X, batch_shape, device),
        _fp2_const(G2_GENERATOR_Y, batch_shape, device),
        FP2.broadcast_const("one_mont", (2,) + tuple(batch_shape), device),
    )


def g2_dbl(p: G1Jac) -> G1Jac:
    return cv.dbl(p, FP2)


def g2_add(p: G1Jac, q: G1Jac) -> G1Jac:
    return cv.add(p, q, FP2)


def g2_madd(p: G1Jac, q: G1Aff) -> G1Jac:
    return cv.madd(p, q, FP2)


def g2_scalar_mul(p: G1Jac, scalars) -> G1Jac:
    """[k]P batched: double-and-add over the 16 * FR_LIMBS scalar bits,
    most significant first.

    p: Jacobian batch [L, 2, *batch]; scalars: int64 [FR_LIMBS, *batch]
    canonical little-endian 16-bit limbs.  The identity in gives the
    identity out; k = 0 gives the identity."""
    n_bits = 16 * scalars.shape[0]
    acc = g2_identity(p.z.shape[2:], p.z.device)
    for i in reversed(range(n_bits)):
        acc = g2_dbl(acc)
        with_p = g2_add(acc, p)
        bit = ((scalars[i // 16] >> (i % 16)) & 1).bool()
        acc = cv._where(bit, with_p, acc, FP2)
    return acc


def g2_to_affine(p: G1Jac):
    """Jacobian batch -> (x, y, inf) affine tensors ([L, 2, *batch])."""
    inf = FP2.is_zero(p.z)
    safe_z = FP2.select(inf, FP2.broadcast_const("one_mont", p.z.shape[1:], p.z.device), p.z)
    zinv = FP2.inv(safe_z)
    zinv2 = FP2.square(zinv)
    zinv3 = FP2.mul(zinv2, zinv)
    return FP2.mul(p.x, zinv2), FP2.mul(p.y, zinv3), inf


def g2_affine_from_ints(points, device="cuda") -> G1Aff:
    """List of refimpl G2 points (Fp2 coordinates or int pairs, or None)
    -> a device batch."""
    xs, ys, infs = [], [], []
    for pt in points:
        if pt is None:
            xs.extend([0, 0])
            ys.extend([0, 0])
            infs.append(True)
        else:
            x, y = pt
            x0, x1 = (x.c0, x.c1) if hasattr(x, "c0") else (x[0], x[1])
            y0, y1 = (y.c0, y.c1) if hasattr(y, "c0") else (y[0], y[1])
            xs.extend([x0 * FP.mont_r % FP.modulus, x1 * FP.mont_r % FP.modulus])
            ys.extend([y0 * FP.mont_r % FP.modulus, y1 * FP.mont_r % FP.modulus])
            infs.append(False)
    n = len(points)

    def coord(vals):        # point-major [L, 2n] -> [L, 2, n]
        t = torch.as_tensor(ints_to_vec(vals, FP_LIMBS).astype(np.int64), device=device)
        return t.reshape(FP_LIMBS, n, 2).movedim(2, 1).contiguous()

    return G1Aff(coord(xs), coord(ys), torch.tensor(infs, dtype=torch.bool, device=device))


def g2_jac_to_int_points(p: G1Jac) -> list:
    """Device G2 Jacobian batch -> list of ((x0, x1), (y0, y1)) or None."""
    x, y, inf = g2_to_affine(p)

    def ints(c):            # [L, 2, n] -> point-major [L, 2n] -> ints
        return vec_to_ints(FP.from_mont(c.movedim(1, -1).reshape(FP_LIMBS, -1)).cpu().numpy())

    xs, ys = ints(x), ints(y)
    out = []
    for i, is_inf in enumerate(inf.reshape(-1).tolist()):
        out.append(None if is_inf else ((xs[2 * i], xs[2 * i + 1]), (ys[2 * i], ys[2 * i + 1])))
    return out
