"""G1/G2 group arithmetic and ZCash serialization over Python ints (ground truth).

Points are affine tuples; ``None`` is the identity.  Serialization follows
the ZCash BLS12-381 encoding used by blst, which is what the reference's
``FsG1::to_bytes`` (48B compressed) / ``FsG1::serialize`` (96B uncompressed)
and the G2 equivalents produce (reference src/engine/piano.rs:649-846).
"""

from __future__ import annotations

from ..constants import (
    B_COEFF,
    G1_GENERATOR_X,
    G1_GENERATOR_Y,
    G2_GENERATOR_X,
    G2_GENERATOR_Y,
    P,
    R,
)
from .field import fp_inv, fp_sqrt
from .tower import Fp2

# A point is None (identity) or a tuple (x, y) with ints for G1, Fp2 for G2.
G1Point = tuple[int, int] | None
G2Point = tuple[Fp2, Fp2] | None

G1_GEN: G1Point = (G1_GENERATOR_X, G1_GENERATOR_Y)
G2_GEN: G2Point = (Fp2(*G2_GENERATOR_X), Fp2(*G2_GENERATOR_Y))


# ---------------------------------------------------------------------------
# G1 (affine, exact)
# ---------------------------------------------------------------------------

def g1_is_on_curve(pt: G1Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B_COEFF) % P == 0


def g1_neg(pt: G1Point) -> G1Point:
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P)


def g1_add(p1: G1Point, p2: G1Point) -> G1Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * fp_inv(2 * y1) % P
    else:
        lam = (y2 - y1) * fp_inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_sub(p1: G1Point, p2: G1Point) -> G1Point:
    return g1_add(p1, g1_neg(p2))


def g1_mul(pt: G1Point, k: int) -> G1Point:
    k %= R
    result: G1Point = None
    addend = pt
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        k >>= 1
    return result


def g1_sum(points) -> G1Point:
    acc: G1Point = None
    for pt in points:
        acc = g1_add(acc, pt)
    return acc


def g1_msm(points, scalars) -> G1Point:
    """Naive multi-scalar multiplication (the test oracle for the MSM kernel,
    mirroring manual_commit_test, reference src/engine/piano.rs:1415-1459)."""
    acc: G1Point = None
    for pt, k in zip(points, scalars):
        acc = g1_add(acc, g1_mul(pt, k))
    return acc


# ---------------------------------------------------------------------------
# G2 (affine over Fp2, exact)
# ---------------------------------------------------------------------------

B2 = Fp2(B_COEFF, B_COEFF)  # twist: y^2 = x^3 + 4(u+1)


def g2_is_on_curve(pt: G2Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y.square() - x.square() * x - B2).is_zero()


def g2_neg(pt: G2Point) -> G2Point:
    if pt is None:
        return None
    x, y = pt
    return (x, -y)


def g2_add(p1: G2Point, p2: G2Point) -> G2Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = x1.square().scale(3) * (y1 + y1).inverse()
    else:
        lam = (y2 - y1) * (x2 - x1).inverse()
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_sub(p1: G2Point, p2: G2Point) -> G2Point:
    return g2_add(p1, g2_neg(p2))


def g2_mul(pt: G2Point, k: int) -> G2Point:
    k %= R
    result: G2Point = None
    addend = pt
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


# ---------------------------------------------------------------------------
# ZCash serialization (bit-compatible with blst)
# ---------------------------------------------------------------------------

_COMPRESSED_FLAG = 0x80
_INFINITY_FLAG = 0x40
_SIGN_FLAG = 0x20


def _y_is_larger(y: int) -> bool:
    """Lexicographically-largest convention: y > p - y."""
    return y > P - y


def g1_to_bytes(pt: G1Point) -> bytes:
    """48-byte compressed encoding (FsG1::to_bytes)."""
    if pt is None:
        return bytes([_COMPRESSED_FLAG | _INFINITY_FLAG]) + bytes(47)
    x, y = pt
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _COMPRESSED_FLAG
    if _y_is_larger(y):
        out[0] |= _SIGN_FLAG
    return bytes(out)


def g1_from_bytes(b: bytes) -> G1Point:
    """Parse 48-byte compressed G1 (curve check, no subgroup check --
    matching blst_p1_uncompress semantics behind FsG1::from_bytes)."""
    if len(b) != 48:
        raise ValueError(f"expected 48 bytes, got {len(b)}")
    flags = b[0]
    if not flags & _COMPRESSED_FLAG:
        raise ValueError("compressed bit not set")
    if flags & _INFINITY_FLAG:
        if flags != (_COMPRESSED_FLAG | _INFINITY_FLAG) or any(b[1:]):
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + b[1:], "big")
    if x >= P:
        raise ValueError("x is not canonical")
    y = fp_sqrt((x * x * x + B_COEFF) % P)
    if y is None:
        raise ValueError("x is not on the curve")
    if bool(flags & _SIGN_FLAG) != _y_is_larger(y):
        y = P - y
    return (x, y)


def g1_serialize(pt: G1Point) -> bytes:
    """96-byte uncompressed encoding (FsG1::serialize)."""
    if pt is None:
        return bytes([_INFINITY_FLAG]) + bytes(95)
    x, y = pt
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def g1_deserialize(b: bytes) -> G1Point:
    """Parse 96-byte uncompressed G1 (FsG1::deserialize)."""
    if len(b) != 96:
        raise ValueError(f"expected 96 bytes, got {len(b)}")
    flags = b[0]
    if flags & _COMPRESSED_FLAG:
        raise ValueError("compressed bit set on uncompressed encoding")
    if flags & _INFINITY_FLAG:
        if flags != _INFINITY_FLAG or any(b[1:]):
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(b[:48], "big")
    y = int.from_bytes(b[48:], "big")
    if x >= P or y >= P:
        raise ValueError("coordinate is not canonical")
    pt = (x, y)
    if not g1_is_on_curve(pt):
        raise ValueError("point is not on the curve")
    return pt


def _fp2_sqrt(a: Fp2) -> Fp2 | None:
    """Square root in Fp2 via the standard p%4==3 construction."""
    if a.is_zero():
        return Fp2.zero()
    # candidate = a^((p^2+7)/16)-style shortcuts do not apply; use generic:
    # a1 = a^((p-3)/4); x0 = a1*a; alpha = a1*x0
    a1 = _fp2_pow(a, (P - 3) // 4)
    x0 = a1 * a
    alpha = a1 * x0
    if alpha == Fp2(P - 1, 0):
        # x = u * x0 is a root
        x = Fp2(0, 1) * x0
    else:
        b = _fp2_pow(alpha + Fp2.one(), (P - 1) // 2)
        x = b * x0
    if x.square() == a:
        return x
    return None


def _fp2_pow(a: Fp2, e: int) -> Fp2:
    result = Fp2.one()
    base = a
    while e:
        if e & 1:
            result = result * base
        base = base.square()
        e >>= 1
    return result


def _fp2_y_is_larger(y: Fp2) -> bool:
    """Lexicographically-largest over (c1, c0): compare c1 first, then c0."""
    neg = -y
    if y.c1 != neg.c1:
        return y.c1 > neg.c1
    return y.c0 > neg.c0


def g2_to_bytes(pt: G2Point) -> bytes:
    """96-byte compressed encoding: x_c1 || x_c0 with flags (FsG2::to_bytes)."""
    if pt is None:
        return bytes([_COMPRESSED_FLAG | _INFINITY_FLAG]) + bytes(95)
    x, y = pt
    out = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
    out[0] |= _COMPRESSED_FLAG
    if _fp2_y_is_larger(y):
        out[0] |= _SIGN_FLAG
    return bytes(out)


def g2_from_bytes(b: bytes) -> G2Point:
    if len(b) != 96:
        raise ValueError(f"expected 96 bytes, got {len(b)}")
    flags = b[0]
    if not flags & _COMPRESSED_FLAG:
        raise ValueError("compressed bit not set")
    if flags & _INFINITY_FLAG:
        if flags != (_COMPRESSED_FLAG | _INFINITY_FLAG) or any(b[1:]):
            raise ValueError("malformed infinity encoding")
        return None
    xc1 = int.from_bytes(bytes([flags & 0x1F]) + b[1:48], "big")
    xc0 = int.from_bytes(b[48:], "big")
    if xc0 >= P or xc1 >= P:
        raise ValueError("coordinate is not canonical")
    x = Fp2(xc0, xc1)
    y = _fp2_sqrt(x.square() * x + B2)
    if y is None:
        raise ValueError("x is not on the twist curve")
    if bool(flags & _SIGN_FLAG) != _fp2_y_is_larger(y):
        y = -y
    return (x, y)


def g2_serialize(pt: G2Point) -> bytes:
    """192-byte uncompressed encoding: x_c1 || x_c0 || y_c1 || y_c0."""
    if pt is None:
        return bytes([_INFINITY_FLAG]) + bytes(191)
    x, y = pt
    return (
        x.c1.to_bytes(48, "big")
        + x.c0.to_bytes(48, "big")
        + y.c1.to_bytes(48, "big")
        + y.c0.to_bytes(48, "big")
    )


def g2_deserialize(b: bytes) -> G2Point:
    if len(b) != 192:
        raise ValueError(f"expected 192 bytes, got {len(b)}")
    flags = b[0]
    if flags & _COMPRESSED_FLAG:
        raise ValueError("compressed bit set on uncompressed encoding")
    if flags & _INFINITY_FLAG:
        if flags != _INFINITY_FLAG or any(b[1:]):
            raise ValueError("malformed infinity encoding")
        return None
    xc1 = int.from_bytes(b[0:48], "big")
    xc0 = int.from_bytes(b[48:96], "big")
    yc1 = int.from_bytes(b[96:144], "big")
    yc0 = int.from_bytes(b[144:192], "big")
    for c in (xc0, xc1, yc0, yc1):
        if c >= P:
            raise ValueError("coordinate is not canonical")
    pt = (Fp2(xc0, xc1), Fp2(yc0, yc1))
    if not g2_is_on_curve(pt):
        raise ValueError("point is not on the twist curve")
    return pt


# ---------------------------------------------------------------------------
# Native-dispatch wrappers (verify-side hot host ops)
#
# The exact Python functions above are the ground-truth oracle; these
# `*_fast` forms route through the C++ group kernels
# (fourier_tpu_torch/native/fastpairing.cpp — the analog of the reference's
# blst scalar-mul FFI at src/engine/piano.rs:321-347,402-410).
# ---------------------------------------------------------------------------

def g1_msm_fast(points, scalars) -> G1Point:
    from .. import native

    return native.g1_msm(list(points), list(scalars))


def g1_mul_fast(pt: G1Point, k: int) -> G1Point:
    from .. import native

    return native.g1_msm([pt], [k])


def g1_sub_fast(p1: G1Point, p2: G1Point) -> G1Point:
    from .. import native

    return native.g1_combine(p1, p2, negate_b=True)


def g2_mul_fast(pt: G2Point, k: int) -> G2Point:
    from .. import native

    return native.g2_mul(pt, k)


def g2_sub_fast(p1: G2Point, p2: G2Point) -> G2Point:
    from .. import native

    return native.g2_combine(p1, p2, negate_b=True)
