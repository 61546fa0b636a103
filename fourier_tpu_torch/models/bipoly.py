"""Dense bivariate polynomials over Fr (exact, host-side).

The port's copy of ``fourier_tpu.models.bipoly``, which it does not
import.  Ground truth for the distributed protocol tests, with the same
role and surface as the reference's BivariateFsPolynomial
(src/bipoly.rs:36-124):
f(x, y) = sum_i y^i * (sum_j a_{ij} x^j), stored as a list of coefficient
rows (row i = coefficients in x of the y^i term).
"""

from __future__ import annotations

from ..constants import R
from ..refimpl.poly import poly_eval


class BivariatePolynomial:
    def __init__(self, rows: list[list[int]]):
        self.rows = [[c % R for c in row] for row in rows]

    @staticmethod
    def from_coeffs(rows) -> "BivariatePolynomial":
        return BivariatePolynomial(rows)

    def eval(self, x: int, y: int) -> int:
        """f(x, y), exact."""
        return poly_eval([poly_eval(row, x) for row in self.rows], y)

    def eval_x(self, x: int) -> list[int]:
        """Partial evaluation: coefficients in y of f(x, Y)."""
        return [poly_eval(row, x) for row in self.rows]

    def eval_y(self, y: int) -> list[int]:
        """Partial evaluation: coefficients in x of f(X, y)."""
        width = max(len(r) for r in self.rows)
        out = [0] * width
        ypow = 1
        for row in self.rows:
            for j, c in enumerate(row):
                out[j] = (out[j] + ypow * c) % R
            ypow = ypow * y % R
        return out

    # algebra surface of the reference (bipoly.rs:36-124) -------------------

    @staticmethod
    def zero() -> "BivariatePolynomial":
        return BivariatePolynomial([[0]])

    def add(self, other: "BivariatePolynomial") -> "BivariatePolynomial":
        """Coefficient-wise sum; sizes may differ."""
        height = max(len(self.rows), len(other.rows))
        width = max(
            max((len(r) for r in self.rows), default=0),
            max((len(r) for r in other.rows), default=0),
        )
        out = [[0] * width for _ in range(height)]
        for src in (self.rows, other.rows):
            for i, row in enumerate(src):
                for j, c in enumerate(row):
                    out[i][j] = (out[i][j] + c) % R
        return BivariatePolynomial(out)

    def mul(self, other: "BivariatePolynomial") -> "BivariatePolynomial":
        """Full product: degrees add in both variables."""
        h = len(self.rows) + len(other.rows) - 1
        w = (
            max(len(r) for r in self.rows)
            + max(len(r) for r in other.rows)
            - 1
        )
        out = [[0] * w for _ in range(h)]
        for i1, r1 in enumerate(self.rows):
            for i2, r2 in enumerate(other.rows):
                for j1, c1 in enumerate(r1):
                    if not c1:
                        continue
                    for j2, c2 in enumerate(r2):
                        out[i1 + i2][j1 + j2] = (
                            out[i1 + i2][j1 + j2] + c1 * c2
                        ) % R
        return BivariatePolynomial(out)

    def scale(self, k: int) -> "BivariatePolynomial":
        """k * f for a scalar k."""
        return BivariatePolynomial(
            [[c * k % R for c in row] for row in self.rows]
        )
