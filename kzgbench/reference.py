"""The plain reference that decides `correct`: Pianist/PIANO bivariate KZG
over BLS12-381 in Python integers.

It imports nothing of the program.  The curve constants, the G1 group law
and the compressed encoding are frozen copies of the public BLS12-381
definitions (the ZCash encoding that blst writes).

The reference knows the seed's setup secrets, so it needs no SRS points:
U[i][j] = g^(R_i(tau_y) * L_j(tau_x)), hence a worker's commitment to the
Lagrange values f_j of its row is g^(R_i(tau_y) * f(tau_x)) with
f(tau_x) = sum_j f_j L_j(tau_x), and its proof at alpha is
g^(R_i(tau_y) * (f(tau_x) - f(alpha)) / (tau_x - alpha)).  f(alpha) is the
barycentric sum over the domain.  The master's values follow the same way
along Y.  One scalar multiplication a point, where an MSM over the SRS
would take 2^19 of them.
"""

from __future__ import annotations

# BLS12-381 (the curve's public parameters)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
G1 = (0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
      0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)
# 7 generates Fr*; the 2^s-th root of unity is 7^((r - 1) / 2^s) (c-kzg)
FR_GENERATOR = 7


def root_of_unity(scale: int) -> int:
    return pow(FR_GENERATOR, (R - 1) >> scale, R)


def hash_to_field(secret: bytes) -> int:
    """A setup secret's 32 bytes, big-endian, mod r (EIP-4844's
    hash_to_bls_field, which the reference server applies to its secrets)."""
    return int.from_bytes(secret, "big") % R


# -- G1, affine ------------------------------------------------------------------

def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    (x1, y1), (x2, y2) = a, b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def g1_mul(pt, k: int):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, pt)
        pt = g1_add(pt, pt)
        k >>= 1
    return acc


def g1_bytes(pt) -> bytes:
    """48-byte compressed encoding (ZCash / blst)."""
    if pt is None:
        return bytes([0xC0]) + bytes(47)
    x, y = pt
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if y > P - y else 0)
    return bytes(out)


def g_pow(k: int) -> bytes:
    """g^k, compressed."""
    return g1_bytes(g1_mul(G1, k))


def fr_bytes(v: int) -> bytes:
    return (v % R).to_bytes(32, "big")


# -- Fr vectors --------------------------------------------------------------------

def powers(w: int, n: int) -> list[int]:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * w % R
    return out


def batch_inverse(values: list[int]) -> list[int]:
    prefix = [0] * len(values)
    acc = 1
    for i, v in enumerate(values):
        prefix[i] = acc
        acc = acc * v % R
    inv = pow(acc, -1, R)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * values[i] % R
    return out


def lagrange_at(x: int, roots: list[int]) -> list[int]:
    """L_j(x) = (w^j / n) (x^n - 1) / (x - w^j) on the domain `roots`, for
    x off the domain."""
    n = len(roots)
    scale = (pow(x, n, R) - 1) * pow(n, -1, R) % R
    invs = batch_inverse([(x - w) % R for w in roots])
    return [w * scale % R * inv % R for w, inv in zip(roots, invs)]


def dot(a, b) -> int:
    return sum(x * y for x, y in zip(a, b)) % R


def intt(values: list[int], scale: int) -> list[int]:
    """Inverse radix-2 NTT on the 2^scale domain, natural order in and out,
    scaled by 1/n: the coefficients whose evaluations at w^0..w^(n-1) are
    `values`."""
    n = 1 << scale
    a = [v % R for v in values] + [0] * (n - len(values))
    j = 0
    for i in range(1, n):  # bit-reversal permutation
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    w_inv = pow(root_of_unity(scale), -1, R)
    size = 2
    while size <= n:
        half = size // 2
        tw = powers(pow(w_inv, n // size, R), half)
        for start in range(0, n, size):
            for k in range(half):
                u = a[start + k]
                v = a[start + k + half] * tw[k] % R
                a[start + k] = (u + v) % R
                a[start + k + half] = (u - v) % R
        size *= 2
    n_inv = pow(n, -1, R)
    return [v * n_inv % R for v in a]


# -- the protocol ------------------------------------------------------------------

class Deployment:
    """The values every answer of one deployment needs: the secrets' field
    elements, the left domain and L_j(tau_x), and R_i(tau_y)."""

    def __init__(self, scale: int, machines_scale: int, secrets: tuple[bytes, bytes]):
        self.t = scale - machines_scale
        self.m = machines_scale
        self.T, self.M = 1 << self.t, 1 << self.m
        self.tau_x, self.tau_y = hash_to_field(secrets[0]), hash_to_field(secrets[1])
        self.left = powers(root_of_unity(self.t), self.T)
        self.right = powers(root_of_unity(self.m), self.M)
        self.l_tau = lagrange_at(self.tau_x, self.left)
        self.r_tau = lagrange_at(self.tau_y, self.right)

    def row_at_tau(self, f: list[int]) -> int:
        """f(tau_x) for the Lagrange values f."""
        return dot(f, self.l_tau)

    def row_at(self, f: list[int], alpha: int) -> int:
        """f(alpha) for the Lagrange values f, alpha off the domain."""
        return dot(f, lagrange_at(alpha, self.left))

    def worker(self, i: int, f: list[int], alpha: int | None):
        """(f(tau_x), commitment, y, proof) of row i; y and proof are None
        without alpha."""
        f_tau = self.row_at_tau(f)
        com = g_pow(self.r_tau[i] * f_tau)
        if alpha is None:
            return f_tau, com, None, None
        y = self.row_at(f, alpha)
        q_tau = (f_tau - y) * pow(self.tau_x - alpha, -1, R)
        return f_tau, com, y, g_pow(self.r_tau[i] * q_tau)

    def master(self, f_taus: list[int], ys: list[int], alpha: int, beta: int):
        """(commitment, z, pi_0, pi_1) over the M rows' f_i(tau_x) and
        f_i(alpha): z = F(beta) with F(Y) = sum_i f_i(alpha) R_i(Y)."""
        com = g_pow(sum(r * f for r, f in zip(self.r_tau, f_taus)))
        z = dot(ys, lagrange_at(beta, self.right))
        x_inv = pow(self.tau_x - alpha, -1, R)
        pi0 = g_pow(sum(r * (f - y) for r, f, y in zip(self.r_tau, f_taus, ys)) * x_inv)
        f_tau_y = dot(ys, self.r_tau)
        pi1 = g_pow((f_tau_y - z) * pow(self.tau_y - beta, -1, R))
        return com, z, pi0, pi1
