"""Radix-2 NTT/INTT over Fr in plain tensor ops.

Port of ``fourier_tpu.ops.ntt``: iterative decimation in time over the
minor axis, natural order in and out (out[k] = f(w^k)), the inverse
scaled by 1/n, Montgomery values in and out.  Serves the `fft` RPC
method and the coefficient-basis opening fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import FR_LIMBS, R, root_of_unity
from .limbs import ints_to_vec

from .field import FR


def _bit_reverse_indices(scale: int) -> np.ndarray:
    n = 1 << scale
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for _ in range(scale):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


class NTTDomain:
    """NTT domain of size 2^scale over Fr (Montgomery-form values)."""

    def __init__(self, scale: int):
        self.scale = scale
        self.n = 1 << scale
        self.w = root_of_unity(scale)
        self.w_inv = pow(self.w, -1, R) if scale > 0 else 1
        self.n_inv_mont = ints_to_vec([pow(self.n, -1, R) * FR.mont_r % R], FR_LIMBS)
        self.bitrev = _bit_reverse_indices(scale)
        self._tables: dict = {}

    def _powers(self, inverse: bool, device) -> torch.Tensor:
        """[L, n/2] Montgomery powers w^k; stage s takes every (n >> s)-th."""
        key = (inverse, str(device))
        if key not in self._tables:
            w = self.w_inv if inverse else self.w
            vals, acc = [], FR.mont_r
            for _ in range(max(self.n // 2, 1)):
                vals.append(acc)
                acc = acc * w % R
            self._tables[key] = torch.as_tensor(
                ints_to_vec(vals, FR_LIMBS).astype(np.int64), device=device)
        return self._tables[key]

    def ntt(self, x, inverse: bool = False):
        """NTT/INTT along the minor axis of an int64 [L, ..., n] tensor."""
        if x.shape[-1] != self.n:
            raise ValueError(f"minor axis {x.shape[-1]} != domain size {self.n}")
        if self.scale == 0:
            return x
        powers = self._powers(inverse, x.device)
        x = x[..., torch.as_tensor(self.bitrev, device=x.device)]
        L, lead = x.shape[0], x.shape[:-1]
        for s in range(1, self.scale + 1):
            m = 1 << s
            h = m >> 1
            tw = powers[:, :: self.n >> s][:, :h]
            xb = x.reshape(lead + (self.n // m, m))
            u, v = xb[..., :h], xb[..., h:]
            t = FR.mul(v, tw.reshape((L,) + (1,) * (xb.ndim - 2) + (h,)))
            x = torch.cat([FR.add(u, t), FR.sub(u, t)], dim=-1).reshape(lead + (self.n,))
        if inverse:
            ninv = torch.as_tensor(self.n_inv_mont.astype(np.int64), device=x.device)
            x = FR.mul(x, ninv.reshape((L,) + (1,) * (x.ndim - 1)))
        return x


_domains: dict[int, NTTDomain] = {}


def get_domain(scale: int) -> NTTDomain:
    if scale not in _domains:
        _domains[scale] = NTTDomain(scale)
    return _domains[scale]
