"""Extension-field tower Fp2 / Fp6 / Fp12 over Python ints (ground truth).

Tower construction (standard for BLS12-381):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)

Used only on the verify path (pairings are O(1) per request; the reference
likewise runs them on CPU via blst FFI, reference src/engine/piano.rs:358-464).
Elements are immutable tuples of ints; all ops are exact.
"""

from __future__ import annotations

from ..constants import P


class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero() -> "Fp2":
        return Fp2(0, 0)

    @staticmethod
    def one() -> "Fp2":
        return Fp2(1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, other) -> bool:
        return self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fp2":
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o: "Fp2") -> "Fp2":
        # (a0 + a1 u)(b0 + b1 u), u^2 = -1
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp2(t0 - t1, t2 - t0 - t1)

    def scale(self, k: int) -> "Fp2":
        return Fp2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fp2":
        return self * self

    def conjugate(self) -> "Fp2":
        return Fp2(self.c0, -self.c1)

    def inverse(self) -> "Fp2":
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        inv = pow(norm, -1, P)
        return Fp2(self.c0 * inv, -self.c1 * inv)

    def mul_by_xi(self) -> "Fp2":
        # multiply by xi = 1 + u
        return Fp2(self.c0 - self.c1, self.c0 + self.c1)

    def __repr__(self):
        return f"Fp2({hex(self.c0)}, {hex(self.c1)})"


XI = Fp2(1, 1)


class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fp6":
        return Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @staticmethod
    def one() -> "Fp6":
        return Fp6(Fp2.one(), Fp2.zero(), Fp2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, other) -> bool:
        return self.c0 == other.c0 and self.c1 == other.c1 and self.c2 == other.c2

    def __add__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fp6":
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fp6") -> "Fp6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_xi() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def square(self) -> "Fp6":
        return self * self

    def mul_by_v(self) -> "Fp6":
        # (c0 + c1 v + c2 v^2) * v = c2*xi + c0 v + c1 v^2
        return Fp6(self.c2.mul_by_xi(), self.c0, self.c1)

    def inverse(self) -> "Fp6":
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - (b * c).mul_by_xi()
        t1 = (c.square()).mul_by_xi() - a * b
        t2 = b.square() - a * c
        denom = a * t0 + (c * t1).mul_by_xi() + (b * t2).mul_by_xi()
        # denom lies in Fp (c1 == c2 == 0 by construction of the norm)
        inv = denom.inverse()
        return Fp6(t0 * inv, t1 * inv, t2 * inv)


class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one() -> "Fp12":
        return Fp12(Fp6.one(), Fp6.zero())

    def is_one(self) -> bool:
        return self == Fp12.one()

    def __eq__(self, other) -> bool:
        return self.c0 == other.c0 and self.c1 == other.c1

    def __add__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp12") -> "Fp12":
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "Fp12") -> "Fp12":
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fp12(c0, c1)

    def square(self) -> "Fp12":
        return self * self

    def conjugate(self) -> "Fp12":
        """The p^6 Frobenius: (c0 + c1 w) -> (c0 - c1 w)."""
        return Fp12(self.c0, -self.c1)

    def inverse(self) -> "Fp12":
        # 1/(c0 + c1 w) = (c0 - c1 w)/(c0^2 - c1^2 v)
        denom = (self.c0.square() - self.c1.square().mul_by_v()).inverse()
        return Fp12(self.c0 * denom, -(self.c1 * denom))

    def pow(self, e: int) -> "Fp12":
        if e < 0:
            return self.inverse().pow(-e)
        result = Fp12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result
