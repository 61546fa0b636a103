"""Python-int models of the redundant arithmetic of csrc/g1.cuh, and the
lanes that test it.

The point formulas of the CUDA kernels hold every coordinate in [0, 2p)
and make it canonical only at the store.  These functions compute the
same values on Montgomery ints, in the kernels' order, so that a test can
check that each one stays below 2p and that the result, made canonical,
equals the plain twins' limbs.  test_torch_curve.py runs them on the CPU;
test_torch_kernels.py and chip_smoke.py pick the card's edge lanes with
them.  The module imports no jax.
"""

import functools

from fourier_tpu_torch.ops.field import FP


@functools.cache
def _redundant_ops():
    """(mul, add, sub) of csrc/g1.cuh's redundant form on Montgomery values
    as Python ints in [0, 2p): a product or square is (a b + M p) / 2^384
    with M = -a b / p mod 2^384, the value of the word-serial reduction;
    adds and subs reduce modulo 2p."""
    p, p2, r = FP.modulus, 2 * FP.modulus, 1 << 384
    neg_pinv = -pow(p, -1, r) % r

    def mul(a, b):
        t = a * b
        return (t + (t * neg_pinv % r) * p) >> 384

    def add(a, b):
        return a + b - p2 if a + b >= p2 else a + b

    def sub(a, b):
        return a - b + p2 if a < b else a - b

    return mul, add, sub


def g1_dbl_redundant(x: int, y: int, z: int) -> list:
    """One doubling as the kernels run it (csrc/g1.cuh g1_dbl_lazy), on
    Montgomery values as Python ints in [0, 2p): every value it holds, in
    order, the last three being the x3, y3, z3 it carries on."""
    mul, add, sub = _redundant_ops()
    a, b = mul(x, x), mul(y, y)
    c = mul(b, b)
    t = add(x, b)
    s = mul(t, t)
    d1 = sub(s, a)
    d0 = sub(d1, c)
    d = add(d0, d0)
    e2 = add(a, a)
    e = add(e2, a)
    f = mul(e, e)
    d2 = add(d, d)
    x3 = sub(f, d2)
    c2 = add(c, c)
    c4 = add(c2, c2)
    c8 = add(c4, c4)
    u = sub(d, x3)
    v = mul(e, u)
    y3 = sub(v, c8)
    y2 = add(y, y)
    z3 = mul(y2, z)
    return [a, b, c, t, s, d1, d0, d, e2, e, f, d2, c2, c4, c8, u, v, y2, x3, y3, z3]


def g1_add_redundant(p: tuple, q: tuple) -> list:
    """One complete addition p + q of (x, y, z) Montgomery ints in [0, 2p)
    as the kernels run it (csrc/g1.cuh g1_add_lazy): every value it holds,
    in order, the last three being the x3, y3, z3 it returns (an identity
    operand returns the other's coordinates; the same point, the
    doubling's)."""
    mul, add, sub = _redundant_ops()
    m = FP.modulus
    (x1, y1, z1), (x2, y2, z2) = p, q
    if z1 % m == 0:
        return list(q)
    if z2 % m == 0:
        return list(p)
    z1z1, z2z2 = mul(z1, z1), mul(z2, z2)
    u1, u2 = mul(x1, z2z2), mul(x2, z1z1)
    s1a = mul(y1, z2)
    s1 = mul(s1a, z2z2)
    s2a = mul(y2, z1)
    s2 = mul(s2a, z1z1)
    h, r0 = sub(u2, u1), sub(s2, s1)
    held = [z1z1, z2z2, u1, u2, s1a, s1, s2a, s2, h, r0]
    if h % m == 0 and r0 % m == 0:
        return held + g1_dbl_redundant(*p)
    h2 = add(h, h)
    i = mul(h2, h2)
    j = mul(h, i)
    rr = add(r0, r0)
    v = mul(u1, i)
    t0 = mul(rr, rr)
    t1 = sub(t0, j)
    v2 = add(v, v)
    x3 = sub(t1, v2)
    s1j = mul(s1, j)
    s1j2 = add(s1j, s1j)
    w = sub(v, x3)
    t2 = mul(rr, w)
    y3 = sub(t2, s1j2)
    zs = add(z1, z2)
    zz = mul(zs, zs)
    t3 = sub(zz, z1z1)
    t4 = sub(t3, z2z2)
    z3 = mul(t4, h)
    return held + [h2, i, j, rr, v, t0, t1, v2, s1j, s1j2, w, t2, zs, zz, t3, t4, x3, y3, z3]


def g1_madd_redundant(p: tuple, qx: int, qy: int) -> list:
    """One complete mixed addition p + (qx, qy), q finite, of Montgomery
    ints in [0, 2p) as the kernels run it (csrc/g1.cuh g1_madd_lazy): every
    value it holds, in order, the last three being the x3, y3, z3 it
    returns."""
    mul, add, sub = _redundant_ops()
    m = FP.modulus
    x1, y1, z1 = p
    if z1 % m == 0:
        return [qx, qy, FP.mont_r]
    z1z1 = mul(z1, z1)
    u2 = mul(qx, z1z1)
    s2a = mul(qy, z1)
    s2 = mul(s2a, z1z1)
    h, r0 = sub(u2, x1), sub(s2, y1)
    held = [z1z1, u2, s2a, s2, h, r0]
    if h % m == 0 and r0 % m == 0:
        return held + g1_dbl_redundant(*p)
    hh = mul(h, h)
    i2 = add(hh, hh)
    i = add(i2, i2)
    j = mul(h, i)
    rr = add(r0, r0)
    v = mul(x1, i)
    t0 = mul(rr, rr)
    t1 = sub(t0, j)
    v2 = add(v, v)
    x3 = sub(t1, v2)
    yj = mul(y1, j)
    yj2 = add(yj, yj)
    w = sub(v, x3)
    t2 = mul(rr, w)
    y3 = sub(t2, yj2)
    zh = add(z1, h)
    zz = mul(zh, zh)
    t3 = sub(zz, z1z1)
    z3 = sub(t3, hh)
    return held + [hh, i2, i, j, rr, v, t0, t1, v2, yj, yj2, w, t2, zh, zz, t3, x3, y3, z3]


def affine_ints(pt: tuple) -> tuple:
    """The affine Montgomery (x, y) of a finite Jacobian Montgomery (x, y,
    z) of ints: x R^2 / z^2 and y R^3 / z^3 mod p."""
    m, r = FP.modulus, FP.mont_r
    x, y, z = pt
    zi = pow(z, -1, m)
    return x * r * r * zi * zi % m, y * r ** 3 * zi ** 3 % m


def addition_edge_lanes(rng, mixed: bool, near: int = 8) -> list:
    """(P, Q) pairs of Montgomery ints that test the redundant additions
    (Q an affine (x, y) when mixed): identities on either side and both
    (z = 0, x and y zero or not), P = Q (the same coordinates, and the
    same point scaled), P = -Q, coordinates 0, 1 and p - 1, and the `near`
    pairs of 3000 random ones whose addition returns, or holds, the values
    closest to 2p."""
    m = FP.modulus

    def rnd():
        return tuple(rng.randrange(m) for _ in range(3))

    p1, p2, lam = rnd(), rnd(), rng.randrange(2, m)
    scaled = (p2[0] * lam ** 2 % m, p2[1] * lam ** 3 % m, p2[2] * lam % m)
    neg = (p1[0], m - p1[1], p1[2])
    top = (m - 1, m - 1, m - 1)
    pairs = [((0, 0, 0), rnd()), (rnd()[:2] + (0,), rnd()), (rnd(), (0, 0, 0)),
             (rnd(), rnd()[:2] + (0,)), ((0, 0, 0), (0, 0, 0)), (p1, p1), (p2, scaled),
             (p1, neg), ((1, 1, 1), top), ((0, 1, m - 1), (m - 1, 0, 1)), (top, top),
             ((0, 0, 1), (1, 1, 1))]
    if mixed:
        # q finite: its affine form; p at infinity also meets q = (0, 0)
        pairs = [(a, affine_ints(b) if b[2] else b[:2]) for a, b in pairs if b[2] or a[2] == 0]
        cands = [(rnd(), rnd()[:2]) for _ in range(3000)]
        vals = [g1_madd_redundant(a, *b) for a, b in cands]
    else:
        cands = [(rnd(), rnd()) for _ in range(3000)]
        vals = [g1_add_redundant(a, b) for a, b in cands]
    returned = sorted(range(len(cands)), key=lambda i: 2 * m - max(vals[i][-3:]))
    held = sorted(range(len(cands)), key=lambda i: 2 * m - max(vals[i]))
    return pairs + [cands[i] for i in returned[:near - near // 2] + held[:near // 2]]
