"""Optimal ate pairing on BLS12-381 over Python ints (ground truth).

Strategy: untwist G2 points into E(Fp12) once, then run a plain affine
Miller loop entirely in Fp12.  This trades constant-factor speed for
obvious correctness; pairings only run on the verify path, which is O(1)
work per request (the reference likewise verifies on CPU through blst FFI,
reference src/engine/piano.rs:358-464).  Any non-degenerate bilinear
pairing yields identical accept/reject behavior for the KZG checks.
"""

from __future__ import annotations

from ..constants import BLS_X, BLS_X_IS_NEGATIVE, P, R
from .curve import G1Point, G2Point
from .tower import Fp2, Fp6, Fp12

# w in Fp12 = Fp6[w]/(w^2 - v)
_W = Fp12(Fp6.zero(), Fp6.one())
_W2 = _W * _W            # = v
_W3 = _W2 * _W
_W2_INV = _W2.inverse()
_W3_INV = _W3.inverse()


def _embed_fp2(a: Fp2) -> Fp12:
    return Fp12(Fp6(a, Fp2.zero(), Fp2.zero()), Fp6.zero())


def _embed_fp(a: int) -> Fp12:
    return _embed_fp2(Fp2(a, 0))


def untwist(q: G2Point) -> tuple[Fp12, Fp12] | None:
    """Map a point on the twist E'(Fp2) to E(Fp12): (x, y) -> (x/w^2, y/w^3)."""
    if q is None:
        return None
    x, y = q
    return (_embed_fp2(x) * _W2_INV, _embed_fp2(y) * _W3_INV)


def _line_eval(a, b, xp: Fp12, yp: Fp12) -> Fp12:
    """Line through a and b (or tangent if a == b) evaluated at (xp, yp)."""
    ax, ay = a
    bx, by = b
    if ax == bx and ay == by:
        lam = ax.square() * _embed_fp(3) * (ay + ay).inverse()
    elif ax == bx:
        # vertical line
        return xp - ax
    else:
        lam = (by - ay) * (bx - ax).inverse()
    return (yp - ay) - lam * (xp - ax)


def _add_fp12_points(a, b):
    ax, ay = a
    bx, by = b
    if ax == bx and ay == by:
        lam = ax.square() * _embed_fp(3) * (ay + ay).inverse()
    elif ax == bx:
        return None
    else:
        lam = (by - ay) * (bx - ax).inverse()
    x3 = lam.square() - ax - bx
    y3 = lam * (ax - x3) - ay
    return (x3, y3)


def miller_loop(p: G1Point, q: G2Point) -> Fp12:
    """Miller function f_{|x|, Q}(P) for the ate pairing (conjugated for x < 0)."""
    if p is None or q is None:
        return Fp12.one()
    qq = untwist(q)
    xp, yp = _embed_fp(p[0]), _embed_fp(p[1])
    f = Fp12.one()
    t = qq
    for bit in bin(BLS_X)[3:]:  # skip the leading 1
        f = f.square() * _line_eval(t, t, xp, yp)
        t = _add_fp12_points(t, t)
        if bit == "1":
            f = f * _line_eval(t, qq, xp, yp)
            t = _add_fp12_points(t, qq)
    if BLS_X_IS_NEGATIVE:
        f = f.conjugate()
    return f


_HARD_PART_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12 - 1) / r) via the standard easy/hard split."""
    # easy part: f^((p^6 - 1)(p^2 + 1))
    f = f.conjugate() * f.inverse()
    f = f.pow(P * P) * f
    # hard part
    return f.pow(_HARD_PART_EXP)


def pairing(p: G1Point, q: G2Point) -> Fp12:
    return final_exponentiation(miller_loop(p, q))


def _native_check(pairs) -> bool | None:
    """Native (C++) multi-pairing product check; None (a degenerate
    input) -> use this module."""
    from .. import native

    return native.pairings_check(pairs)


def pairings_verify_single(a1: G1Point, a2: G2Point, b1: G1Point, b2: G2Point) -> bool:
    """Check e(a1, a2) == e(b1, b2) as a 2-pairing product with one final exp.

    Mirrors PianoBackend::pairings_verify_single (reference
    src/engine/piano.rs:358-388): negate the first G1 input, aggregate two
    Miller loops, one final exponentiation, compare to 1.  Served by the
    native kernel (fourier_tpu_torch/native/fastpairing.cpp); this module
    serves the inputs it calls degenerate and is the ground truth.
    """
    from .curve import g1_neg

    got = _native_check([(g1_neg(a1), a2), (b1, b2)])
    if got is not None:
        return got
    f = miller_loop(g1_neg(a1), a2) * miller_loop(b1, b2)
    return final_exponentiation(f).is_one()


def pairings_verify(
    a1: G1Point,
    a2: G2Point,
    b11: G1Point,
    b12: G2Point,
    b21: G1Point,
    b22: G2Point,
) -> bool:
    """Check e(a1,a2) == e(b11,b12) * e(b21,b22) (3 Miller loops, 1 final exp).

    Mirrors PianoBackend::pairings_verify (reference src/engine/piano.rs:422-464).
    Native-served like pairings_verify_single.
    """
    from .curve import g1_neg

    got = _native_check([(g1_neg(a1), a2), (b11, b12), (b21, b22)])
    if got is not None:
        return got
    f = miller_loop(g1_neg(a1), a2) * miller_loop(b11, b12) * miller_loop(b21, b22)
    return final_exponentiation(f).is_one()
