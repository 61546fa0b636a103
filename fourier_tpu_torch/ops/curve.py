"""Batched G1 arithmetic: Jacobian coordinates over limb-decomposed Fp.

Port of ``fourier_tpu.ops.curve``.  A point batch is ``G1Jac(x, y, z)`` of
int64 ``[24, *batch]`` Montgomery limbs with the identity at z == 0, or
``G1Aff(x, y, inf)`` with an explicit infinity mask.  ``dbl``/``add``/
``madd`` are the complete formulas of the reference (dbl-2009-l,
add-2007-bl, madd-2007-bl) in plain tensor ops, over the field ``f`` they
are given (``FP`` for G1; ``ops.fp2.FP2`` runs them for G2, as the
reference's ``_dbl_impl``/``_add_impl``/``_madd_impl`` do);
``dbl_fast``/``add_fast``/``madd_fast`` take the hand-written kernels of
``ops.kernels`` on a CUDA tensor and these plain formulas on a CPU one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import FP_LIMBS
from .limbs import ints_to_vec, vec_to_ints

from .field import FP


class G1Jac(NamedTuple):
    x: torch.Tensor  # [L, ...]
    y: torch.Tensor
    z: torch.Tensor


class G1Aff(NamedTuple):
    x: torch.Tensor  # [L, ...]
    y: torch.Tensor
    inf: torch.Tensor  # bool [...]


def jac_identity(batch_shape, device="cpu") -> G1Jac:
    """All-zero Jacobian points (z = 0 is the identity)."""
    shape = (FP_LIMBS,) + tuple(batch_shape)
    return G1Jac(*(torch.zeros(shape, dtype=torch.int64, device=device)
                   for _ in range(3)))


def is_identity(p: G1Jac):
    return FP.is_zero(p.z)


def _where(mask, a: G1Jac, b: G1Jac, f=FP) -> G1Jac:
    return G1Jac(f.select(mask, a.x, b.x), f.select(mask, a.y, b.y),
                 f.select(mask, a.z, b.z))


def dbl(p: G1Jac, f=FP) -> G1Jac:
    """Point doubling; the identity maps to the identity (z3 = 2yz)."""
    a = f.square(p.x)
    b = f.square(p.y)
    c = f.square(b)
    t = f.sub(f.sub(f.square(f.add(p.x, b)), a), c)
    d = f.add(t, t)                          # 2((x + b)^2 - a - c)
    e = f.add(f.add(a, a), a)                # 3a
    x3 = f.sub(f.square(e), f.add(d, d))
    c4 = f.add(f.add(c, c), f.add(c, c))
    c8 = f.add(c4, c4)
    y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
    z3 = f.mul(f.add(p.y, p.y), p.z)
    return G1Jac(x3, y3, z3)


def _doubling_branch(same, p: G1Jac, out: G1Jac, f=FP) -> G1Jac:
    """dbl(p) on the lanes where the addition met the same finite point,
    `out` elsewhere (lanes with an identity operand are selected after);
    the doubling is computed only when some lane takes it."""
    return _where(same, dbl(p, f), out, f) if bool(same.any()) else out


def add(p: G1Jac, q: G1Jac, f=FP) -> G1Jac:
    """Complete Jacobian + Jacobian addition via selects."""
    z1z1 = f.square(p.z)
    z2z2 = f.square(q.z)
    u1 = f.mul(p.x, z2z2)
    u2 = f.mul(q.x, z1z1)
    s1 = f.mul(f.mul(p.y, q.z), z2z2)
    s2 = f.mul(f.mul(q.y, p.z), z1z1)
    h = f.sub(u2, u1)
    i = f.square(f.add(h, h))
    j = f.mul(h, i)
    rr = f.sub(s2, s1)
    rr = f.add(rr, rr)
    v = f.mul(u1, i)
    x3 = f.sub(f.sub(f.square(rr), j), f.add(v, v))
    s1j = f.mul(s1, j)
    y3 = f.sub(f.mul(rr, f.sub(v, x3)), f.add(s1j, s1j))
    z3 = f.mul(f.sub(f.sub(f.square(f.add(p.z, q.z)), z1z1), z2z2), h)
    # h == 0, rr == 0: same point, take the doubling; h == 0, rr != 0:
    # inverse pair, z3 = 0 falls out of the formula.
    p_inf, q_inf = f.is_zero(p.z), f.is_zero(q.z)
    same = f.is_zero(h) & f.is_zero(rr) & ~p_inf & ~q_inf
    out = _doubling_branch(same, p, G1Jac(x3, y3, z3), f)
    return _where(p_inf, q, _where(q_inf, p, out, f), f)


def madd(p: G1Jac, q: G1Aff, f=FP) -> G1Jac:
    """Complete mixed addition (q affine, z = 1)."""
    z1z1 = f.square(p.z)
    u2 = f.mul(q.x, z1z1)
    s2 = f.mul(f.mul(q.y, p.z), z1z1)
    h = f.sub(u2, p.x)
    hh = f.square(h)
    i = f.add(hh, hh)
    i = f.add(i, i)
    j = f.mul(h, i)
    rr = f.sub(s2, p.y)
    rr = f.add(rr, rr)
    v = f.mul(p.x, i)
    x3 = f.sub(f.sub(f.square(rr), j), f.add(v, v))
    yj = f.mul(p.y, j)
    y3 = f.sub(f.mul(rr, f.sub(v, x3)), f.add(yj, yj))
    z3 = f.sub(f.sub(f.square(f.add(p.z, h)), z1z1), hh)
    p_inf = f.is_zero(p.z)
    out = _doubling_branch(f.is_zero(h) & f.is_zero(rr) & ~p_inf & ~q.inf, p,
                           G1Jac(x3, y3, z3), f)
    one = f.broadcast_const("one_mont", p.z.shape[1:], p.z.device)
    out = _where(p_inf, G1Jac(q.x, q.y, one), out, f)
    return _where(q.inf, p, out, f)


def to_affine(p: G1Jac) -> G1Aff:
    """Jacobian -> affine with a per-lane inversion of z."""
    zinv = FP.inv(p.z)  # 0 -> 0, harmless for identity lanes
    zinv2 = FP.square(zinv)
    zinv3 = FP.mul(zinv2, zinv)
    return G1Aff(FP.mul(p.x, zinv2), FP.mul(p.y, zinv3), is_identity(p))


def to_affine_batched(p: G1Jac) -> G1Aff:
    """to_affine with the chunked batch inversion: the form for the
    hundred-thousand-lane conversions of setup and precompute."""
    zinv = FP.batch_inv(p.z)
    zinv2 = FP.square(zinv)
    zinv3 = FP.mul(zinv2, zinv)
    return G1Aff(FP.mul(p.x, zinv2), FP.mul(p.y, zinv3), is_identity(p))


def from_affine(q: G1Aff) -> G1Jac:
    one = FP.broadcast_const("one_mont", q.x.shape[1:], q.x.device)
    return G1Jac(q.x, q.y, torch.where(q.inf.unsqueeze(0), torch.zeros_like(one), one))


# -- host conversions ---------------------------------------------------------

_R_INV = pow(FP.mont_r, -1, FP.modulus)


def affine_from_ints(points, device="cpu") -> G1Aff:
    """List of refimpl affine points (or None) -> device batch."""
    xs, ys, infs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(0)
            infs.append(True)
        else:
            xs.append(pt[0] * FP.mont_r % FP.modulus)
            ys.append(pt[1] * FP.mont_r % FP.modulus)
            infs.append(False)

    def dev(v):
        return torch.as_tensor(ints_to_vec(v, FP_LIMBS).astype("int64"), device=device)

    return G1Aff(dev(xs), dev(ys), torch.tensor(infs, dtype=torch.bool, device=device))


def jac_to_int_points(p: G1Jac) -> list:
    """Jacobian batch -> list of refimpl affine points (or None).

    Finished on the host with Python integers: callers convert a handful
    of points (a commitment, a proof, the M tau_Y powers), for which a
    device inversion would be hundreds of small launches per lane."""
    mod = FP.modulus
    xs, ys, zs = (vec_to_ints(c.cpu().numpy()) for c in p)
    out = []
    for xm, ym, zm in zip(xs, ys, zs):
        z = zm * _R_INV % mod
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, mod)
        zi2 = zi * zi % mod
        out.append((xm * _R_INV * zi2 % mod, ym * _R_INV * zi2 * zi % mod))
    return out


# -- kernel dispatch ------------------------------------------------------------

def madd_fast(p: G1Jac, q: G1Aff) -> G1Jac:
    """The counterpart of the reference's curve.madd_fast (batched K5).  No
    serving path of the port calls it: the reference's callers, the bucket
    accumulation and the fixed-base scan of its ops/msm.py, run through K1
    here.  It stays for callers of the reference's interface, held against
    it by the parity tests."""
    from . import kernels

    return kernels.g1_madd(p, q)


def add_fast(p: G1Jac, q: G1Jac) -> G1Jac:
    from . import kernels

    return kernels.g1_add(p, q)


def dbl_fast(p: G1Jac, repeat: int = 1) -> G1Jac:
    from . import kernels

    return kernels.g1_dbl(p, repeat)


def _pad_last(p: G1Jac, pad: int) -> G1Jac:
    """Append `pad` identity lanes along the last axis."""
    z = torch.zeros(p.x.shape[:-1] + (pad,), dtype=torch.int64, device=p.x.device)
    return G1Jac(*(torch.cat([c, z], dim=-1) for c in p))


def halving_tree(p: G1Jac, axis: int = -1, to: int = 1, add=add) -> G1Jac:
    """The reference's halving tree over `axis`: padded with identities to
    to << k lanes, then lane i += lane i + half until `to` lanes remain.
    `add` is one level's batched addition (the plain formula, or K2)."""
    n = p.x.shape[axis]
    if n <= to:
        return p
    width = to << (-(-n // to) - 1).bit_length()
    if width != n:
        shape = list(p.x.shape)
        shape[axis] = width - n
        z = torch.zeros(shape, dtype=torch.int64, device=p.x.device)
        p = G1Jac(*(torch.cat([c, z], dim=axis) for c in p))
    while width > to:
        width //= 2
        p = add(G1Jac(*(c.narrow(axis, 0, width) for c in p)),
                G1Jac(*(c.narrow(axis, width, width) for c in p)))
    return p


def tree_reduce_last(p: G1Jac, to: int = 1) -> G1Jac:
    """Halving-tree reduction of the last axis down to `to` lanes (one
    g1_tree_reduce launch on a CUDA tensor)."""
    from . import kernels

    return kernels.g1_tree_reduce([(p, -1, to)])[0]


def tree_reduce_axis(p: G1Jac, axis: int) -> G1Jac:
    """Halving-tree reduction over any axis; the axis is removed from the
    result shape."""
    from . import kernels

    return G1Jac(*(c.squeeze(axis) for c in kernels.g1_tree_reduce([(p, axis, 1)])[0]))

