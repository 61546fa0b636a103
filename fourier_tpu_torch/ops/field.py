"""Batched prime-field arithmetic in PyTorch: 16-bit limbs, Montgomery form.

Port of ``fourier_tpu.ops.field``.  Elements are ``int64[L, *batch]``
tensors of little-endian 16-bit limbs, limb axis leading (L=16 for Fr,
L=24 for Fp): the same limbs as the JAX package's ``uint32[L, ...]``
arrays, held in int64 because PyTorch's CPU build has no add, shift or
compare on uint32.  The Montgomery radix is kept (2^256 for Fr, 2^384
for Fp), so Montgomery values equal the JAX ones as integers.

These are the plain tensor versions: the CPU path, the NTT, the
evaluation-form opening and the affine conversions run them.  Point
arithmetic on a CUDA device goes through the hand-written kernels in
``ops.kernels`` instead.  The TPU formulation (Kogge-Stone carries, the
wide/rolled switch, the padded lazy domain) has no counterpart: a mul is
an interleaved word-serial Montgomery product with plain carry loops.
"""

from __future__ import annotations

import torch

from fourier_tpu.constants import FP_LIMBS, FR_LIMBS, LIMB_BITS, LIMB_MASK, P, R
from fourier_tpu.ops.limbs import int_to_limbs, ints_to_limbs, limbs_to_ints

MASK = LIMB_MASK


def batch_inverse_host(values: list[int], modulus: int) -> list[int]:
    """Inverses of Python ints mod `modulus`, 0 -> 0, by Montgomery's trick:
    one modular inverse and three products per value, where a modular
    inverse of a 381-bit value costs as much as ~50 products."""
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        if v:
            acc = acc * v % modulus
    inv_acc = pow(acc, -1, modulus)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        if values[i]:
            out[i] = inv_acc * prefix[i] % modulus
            inv_acc = inv_acc * values[i] % modulus
    return out


def _col(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """[L] constant -> [L, 1, ...] broadcasting against an ndim tensor."""
    return t.view((t.shape[0],) + (1,) * (ndim - 1))


class Field:
    """Montgomery limb arithmetic for a fixed prime modulus.

    Every tensor argument is int64 ``[L, *batch]`` with canonical limbs
    (< 2^16 each, value < modulus) unless stated otherwise; results are
    canonical too.
    """

    def __init__(self, modulus: int, n_limbs: int):
        self.modulus = modulus
        self.L = n_limbs
        radix_bits = LIMB_BITS * n_limbs
        self.mont_r = (1 << radix_bits) % modulus
        self.mont_r2 = self.mont_r * self.mont_r % modulus
        self.n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        # subtracting the modulus this many times canonicalizes any L-limb value
        self.max_multiple = ((1 << radix_bits) - 1) // modulus
        self._limbs = {
            "mod": int_to_limbs(modulus, n_limbs),
            "one_mont": int_to_limbs(self.mont_r, n_limbs),
            "r2": int_to_limbs(self.mont_r2, n_limbs),
            "one0": int_to_limbs(1, n_limbs),
        }
        self._consts: dict = {}

    # -- constants -----------------------------------------------------------

    def const(self, name: str, device) -> torch.Tensor:
        """An [L] int64 constant on `device` (cached per device)."""
        key = (name, str(torch.device(device)))
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(
                self._limbs[name].astype("int64"), device=device)
        return self._consts[key]

    def broadcast_const(self, name: str, batch_shape, device) -> torch.Tensor:
        c = self.const(name, device)
        return c.view((self.L,) + (1,) * len(batch_shape)).expand(
            (self.L,) + tuple(batch_shape)).clone()

    # -- carries -------------------------------------------------------------

    @staticmethod
    def _normalize(x: torch.Tensor, bits: int = 17):
        """Non-negative limbs below 2^bits -> 16-bit limbs, plus the carry
        out of the top limb.

        Each pass moves every limb's high part one limb up; once no limb
        exceeds 2^16 the remaining one-bit carries are resolved at once:
        limb i passes a carry on iff the nearest limb at or below i that
        is not 0xFFFF equals 2^16 (a running maximum finds that limb)."""
        L = x.shape[0]
        zero_row = torch.zeros_like(x[:1])
        cout = torch.zeros_like(x[0])
        while True:
            hi = x >> LIMB_BITS
            cout = cout + hi[-1]
            x = (x & MASK) + torch.cat([zero_row, hi[:-1]])
            if bits <= 17:
                break
            bits = max(bits - LIMB_BITS, LIMB_BITS) + 1
        idx = torch.arange(L, device=x.device).view((L,) + (1,) * (x.ndim - 1))
        last = torch.where(x == MASK, -1, idx).cummax(dim=0).values
        gen = torch.cat([zero_row, x >> LIMB_BITS])
        carry = torch.gather(gen, 0, last + 1)       # carry out of limb i
        out = (x + torch.cat([zero_row, carry[:-1]])) & MASK
        return out, cout + carry[-1]

    def _cond_sub(self, x: torch.Tensor) -> torch.Tensor:
        """x - N where x >= N, else x (x normalized, x < 2N)."""
        comp = _col(MASK - self.const("mod", x.device), x.ndim)
        one0 = _col(self.const("one0", x.device), x.ndim)
        d, ge = self._normalize(x + comp + one0)   # x - N + 2^(16L)
        return torch.where((ge > 0).unsqueeze(0), d, x)

    # -- basic ops -----------------------------------------------------------

    def add(self, a, b):
        s, _ = self._normalize(a + b)  # a + b < 2N < 2^(16L)
        return self._cond_sub(s)

    def sub(self, a, b):
        one0 = _col(self.const("one0", a.device), a.ndim)
        d, ge = self._normalize(a + (MASK - b) + one0)  # a - b + 2^(16L)
        mod = _col(self.const("mod", d.device), d.ndim)
        out, _ = self._normalize(d + mod * (ge == 0).to(d.dtype).unsqueeze(0))
        return out

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=0)

    @staticmethod
    def select(mask, a, b):
        """mask ? a : b, with mask shaped like the batch dims."""
        return torch.where(mask.unsqueeze(0), a, b)

    def canonicalize(self, a):
        """Any L-limb value (< 2^(16L)) -> its residue in [0, N)."""
        for _ in range(self.max_multiple):
            a = self._cond_sub(a)
        return a

    # -- multiplication ------------------------------------------------------

    def mul(self, a, b):
        """Montgomery product a*b/2^(16L) mod N, word-serial (CIOS).

        Iteration i adds a[i]*b into the window t[i:i+L], picks m so that
        t[i] + m*N[0] = 0 mod 2^16, adds m*N and moves t[i]'s carry up one
        limb.  Window limbs stay below 2L * 2^33, far inside int64.  The
        result t[L:2L] is < 2N for any a < 2^(16L) and b < N."""
        a, b = torch.broadcast_tensors(a, b)
        L = self.L
        mod = _col(self.const("mod", a.device), a.ndim)
        t = torch.zeros((2 * L,) + a.shape[1:], dtype=torch.int64, device=a.device)
        for i in range(L):
            win = t[i : i + L]
            win.addcmul_(a[i].unsqueeze(0), b)
            m = ((t[i] & MASK) * self.n0inv) & MASK
            win.addcmul_(mod, m.unsqueeze(0))
            t[i + 1] += t[i] >> LIMB_BITS
        res, _ = self._normalize(t[L:], bits=40)
        return self._cond_sub(res)

    def square(self, a):
        return self.mul(a, a)

    # -- Montgomery domain conversions ----------------------------------------

    def to_mont(self, a):
        """Any L-limb value a < 2^(16L) -> a*R mod N (canonical)."""
        return self.mul(a, _col(self.const("r2", a.device), a.ndim))

    def from_mont(self, a):
        return self.mul(a, _col(self.const("one0", a.device), a.ndim))

    # -- exponentiation ------------------------------------------------------

    def pow_const(self, a, e: int):
        """a^e for a host exponent; Montgomery in/out (square and multiply)."""
        if e == 0:
            return self.broadcast_const("one_mont", a.shape[1:], a.device)
        acc = a
        for bit in bin(e)[3:]:
            acc = self.square(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Batched inversion, Montgomery in/out; 0 maps to 0.

        Runs on the host with Python integers, whatever the device: the
        lanes are copied to the host, inverted and copied back.  A Fermat
        chain on the device would be ~2x the bit length in sequential
        muls, each a few hundred small tensor ops.  What reaches here is
        batch_inv's chunk totals (n / 64 lanes: 8192 for a 2^19-lane
        batch), inverted together by batch_inverse_host.  The result
        equals pow_const(a, N-2)."""
        shape = a.shape
        flat = a.reshape(self.L, -1).T.cpu().numpy()
        # a R -> (a R)^-1 R^2 = a^-1 R
        out = [v * self.mont_r2 % self.modulus
               for v in batch_inverse_host(limbs_to_ints(flat), self.modulus)]
        res = torch.as_tensor(ints_to_limbs(out, self.L).T.astype("int64"))
        return res.reshape(shape).to(a.device)

    def batch_inv(self, z, chunk: int = 64):
        """Montgomery batch inversion over the last axis; 0 maps to 0.

        Lanes are folded `chunk` at a time with a forward and a backward
        product pass, and only the 1/chunk-sized chunk totals are
        inverted, on the host (see inv): ~3 muls per lane plus one
        inversion per chunk."""
        n = z.shape[-1]
        chunk = max(1, min(chunk, n))
        pad = (-n) % chunk
        zero = self.is_zero(z)
        one = self.broadcast_const("one_mont", z.shape[1:], z.device)
        zz = self.select(zero, one, z)
        if pad:
            fill = one[..., :1].expand(one.shape[:-1] + (pad,))
            zz = torch.cat([zz, fill], dim=-1)
        g = (n + pad) // chunk
        zc = zz.reshape(zz.shape[:-1] + (g, chunk)).movedim(-1, 0)  # [chunk, L, ..., g]
        carry = self.broadcast_const("one_mont", zc.shape[2:], z.device)
        pre = []
        for k in range(chunk):  # exclusive prefix products
            pre.append(carry)
            carry = self.mul(carry, zc[k])
        carry = self.inv(carry)
        invs = [None] * chunk
        for k in reversed(range(chunk)):
            invs[k] = self.mul(carry, pre[k])
            carry = self.mul(carry, zc[k])
        out = torch.stack(invs, 0).movedim(0, -1).reshape(zz.shape)[..., :n]
        return torch.where(zero.unsqueeze(0), torch.zeros_like(out), out)


FR = Field(R, FR_LIMBS)
FP = Field(P, FP_LIMBS)
