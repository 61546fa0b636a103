"""Polynomial and NTT ground truth over Fr (Python ints).

Conventions match rust-kzg's FsFFTSettings/FsPoly as exercised by the
reference (src/engine/piano.rs:1096-1103, 187-238):

- ``ntt(vals, inverse=False)`` evaluates the coefficient vector at
  ``w^0 .. w^(n-1)`` in natural order; the inverse scales by 1/n.
- Inputs shorter than the domain are zero-padded (fft_fr semantics noted
  at reference src/engine/piano.rs:1095).
- ``poly_eval`` is Horner; ``poly_div_linear`` is synthetic division by
  (X - a), the only divisor shape the protocol uses (FsPoly::div at
  reference src/engine/piano.rs:206-215, 273-282).
"""

from __future__ import annotations

from ..constants import R, root_of_unity
from .field import fr_inv


def ntt(values, scale: int, inverse: bool = False) -> list[int]:
    """Radix-2 NTT over Fr on the 2^scale domain, natural order in/out."""
    n = 1 << scale
    if len(values) > n:
        raise ValueError(f"input of length {len(values)} exceeds domain {n}")
    data = [v % R for v in values] + [0] * (n - len(values))
    w = root_of_unity(scale)
    if inverse:
        w = fr_inv(w)
    out = _fft_recursive(data, w)
    if inverse:
        n_inv = fr_inv(n)
        out = [v * n_inv % R for v in out]
    return out


def _fft_recursive(data: list[int], w: int) -> list[int]:
    n = len(data)
    if n == 1:
        return data
    even = _fft_recursive(data[0::2], w * w % R)
    odd = _fft_recursive(data[1::2], w * w % R)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % R
        out[k] = (even[k] + t) % R
        out[k + n // 2] = (even[k] - t) % R
        wk = wk * w % R
    return out


def poly_eval(coeffs, x: int) -> int:
    """Horner evaluation of sum_i coeffs[i] * x^i."""
    acc = 0
    for c in reversed(list(coeffs)):
        acc = (acc * x + c) % R
    return acc


def poly_div_linear(coeffs, a: int) -> list[int]:
    """Quotient of (f(X) - f(a)) / (X - a) by synthetic division.

    Returns a list of len(coeffs) - 1 coefficients.
    """
    coeffs = list(coeffs)
    n = len(coeffs)
    if n == 0:
        return []
    q = [0] * (n - 1)
    acc = 0
    for k in range(n - 1, 0, -1):
        acc = (coeffs[k] + acc * a) % R
        q[k - 1] = acc
    return q


def lagrange_poly(i: int, scale: int) -> list[int]:
    """Standard-basis coefficients of the i-th Lagrange polynomial on the
    2^scale domain: the unit-vector IFFT (reference src/engine/piano.rs:1120-1135)."""
    n = 1 << scale
    unit = [0] * n
    unit[i] = 1
    return ntt(unit, scale, inverse=True)
