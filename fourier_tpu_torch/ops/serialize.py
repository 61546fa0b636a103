"""Batched ZCash-format G1 point serialization for device point batches.

Port of ``fourier_tpu.ops.serialize``: the setup-file encodings are blst's
(48-byte compressed, 96-byte uncompressed G1; refimpl.curve has the
per-point rules).  Byte marshalling is numpy; the curve math of a whole
batch runs on the batch's device in plain torch: the Montgomery
conversions, the on-curve check and, when decompressing, the square root
y = (x^3 + 4)^((p + 1) / 4), a chain of ~570 Fp products.  Batches are
cut into chunks of _CHUNK points so that a multi-million-point array
never holds more than one chunk's temporaries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import FP_LIMBS, P
from .curve import G1Aff
from .field import FP
from .limbs import bytes_be_to_limbs, int_to_limbs, limbs_to_bytes_be

_COMPRESSED_FLAG = 0x80
_INFINITY_FLAG = 0x40
_SIGN_FLAG = 0x20

# threshold for "lexicographically largest y": y >= (p+1)/2
_Y_THRESHOLD = int_to_limbs((P + 1) // 2, FP_LIMBS).astype(np.int64)
_P_LIMBS = int_to_limbs(P, FP_LIMBS).astype(np.int64)
_SQRT_EXP = (P + 1) // 4
_B_MONT = int_to_limbs(4 * FP.mont_r % P, FP_LIMBS).astype(np.int64)  # curve b = 4

_CHUNK = 1 << 18  # points per device pass of a whole-array conversion


def _np_geq(a: np.ndarray, thresh: np.ndarray) -> np.ndarray:
    """Lexicographic a >= thresh for [n, L] little-endian limb rows."""
    rev = (a.astype(np.int64) - thresh[None, :])[:, ::-1]
    nz = rev != 0
    idx = np.argmax(nz, axis=1)
    top = np.take_along_axis(rev, idx[:, None], axis=1)[:, 0]
    return np.where(nz.any(axis=1), top > 0, True)


def from_mont_np(coord: torch.Tensor) -> np.ndarray:
    """Montgomery [L, n] tensor -> canonical uint32 numpy [L, n], a chunk
    of points at a time."""
    n = coord.shape[-1]
    out = np.empty(coord.shape, np.uint32)
    for lo in range(0, n, _CHUNK):
        out[..., lo:lo + _CHUNK] = FP.from_mont(coord[..., lo:lo + _CHUNK]).cpu().numpy()
    return out


def to_mont(arr_np: np.ndarray, device) -> torch.Tensor:
    """Canonical numpy [L, n] limbs -> Montgomery int64 tensor on `device`,
    a chunk of points at a time."""
    n = arr_np.shape[-1]
    out = torch.empty(arr_np.shape, dtype=torch.int64, device=device)
    for lo in range(0, n, _CHUNK):
        part = torch.from_numpy(np.ascontiguousarray(arr_np[..., lo:lo + _CHUNK]).astype(np.int64))
        out[..., lo:lo + _CHUNK] = FP.to_mont(part.to(device))
    return out


def _curve_rhs(xm: torch.Tensor) -> torch.Tensor:
    """x^3 + 4 (Montgomery in and out)."""
    b = torch.as_tensor(_B_MONT, device=xm.device)[:, None]
    return FP.add(FP.mul(FP.square(xm), xm), b)


def _on_curve(ym: torch.Tensor, rhs: torch.Tensor, inf: torch.Tensor) -> bool:
    """y^2 == rhs on every finite lane."""
    return bool(((FP.square(ym) == rhs).all(dim=0) | inf).all())


def g1_encode_batch(aff: G1Aff, compressed: bool) -> bytes:
    """A device affine batch -> concatenated 48-byte or 96-byte encodings."""
    x = from_mont_np(aff.x).T
    y = from_mont_np(aff.y).T
    inf = aff.inf.reshape(-1).cpu().numpy()
    n = x.shape[0]
    xb = np.frombuffer(limbs_to_bytes_be(x, 48), np.uint8).reshape(n, 48)
    if compressed:
        out = xb.copy()
        out[:, 0] |= _COMPRESSED_FLAG
        out[_np_geq(y, _Y_THRESHOLD), 0] |= _SIGN_FLAG
        out[inf] = 0
        out[inf, 0] = _COMPRESSED_FLAG | _INFINITY_FLAG
    else:
        yb = np.frombuffer(limbs_to_bytes_be(y, 48), np.uint8).reshape(n, 48)
        out = np.concatenate([xb, yb], axis=1)
        out[inf] = 0
        out[inf, 0] = _INFINITY_FLAG
    return out.tobytes()


def g1_decode_batch(data: bytes, compressed: bool, device="cuda") -> G1Aff:
    """Concatenated encodings -> an affine batch on `device`.

    Raises ValueError on malformed flags, non-canonical coordinates and
    points off the curve (blst_p1_uncompress / blst_p1_deserialize); a
    compressed point's y is the square root whose sign bit matches."""
    size = 48 if compressed else 96
    if len(data) % size:
        raise ValueError(f"data size {len(data)} not a multiple of {size}")
    n_total = len(data) // size
    if n_total > _CHUNK:
        parts = [g1_decode_batch(data[lo * size:(lo + _CHUNK) * size], compressed, device)
                 for lo in range(0, n_total, _CHUNK)]
        return G1Aff(*(torch.cat([p[k] for p in parts], dim=-1) for k in range(3)))
    rows = np.frombuffer(data, np.uint8).reshape(-1, size).copy()
    flags = rows[:, 0].copy()
    inf = (flags & _INFINITY_FLAG) != 0
    sign = (flags & _SIGN_FLAG) != 0
    has_comp = (flags & _COMPRESSED_FLAG) != 0
    if compressed:
        if not has_comp.all():
            raise ValueError("compressed bit not set")
        if np.any(inf & sign):
            raise ValueError("malformed infinity encoding")
    else:
        if has_comp.any():
            raise ValueError("compressed bit set on uncompressed encoding")
        if sign.any():
            # blst_p1_deserialize: the sign bit means something only with
            # the compressed bit; alone it is BLST_BAD_ENCODING
            raise ValueError("sign bit set on uncompressed encoding")
    rows[:, 0] &= 0x1F
    if rows[inf].any():  # infinity rows are all zero beyond the flags
        raise ValueError("malformed infinity encoding")
    inf_t = torch.as_tensor(inf, device=device)

    x = bytes_be_to_limbs(rows[:, :48].tobytes(), 48, FP_LIMBS)      # [n, L]
    if compressed:
        if (_np_geq(x, _P_LIMBS) & ~inf).any():
            raise ValueError("x is not canonical")
        xm = to_mont(x.T, device)
        rhs = _curve_rhs(xm)
        y = FP.pow_const(rhs, _SQRT_EXP)
        if not _on_curve(y, rhs, inf_t):
            raise ValueError("x is not on the curve")
        larger = _np_geq(from_mont_np(y).T, _Y_THRESHOLD)
        flip = torch.as_tensor((larger != sign) & ~inf, device=device)
        return G1Aff(xm, FP.select(flip, FP.neg(y), y), inf_t)

    yl = bytes_be_to_limbs(rows[:, 48:].tobytes(), 48, FP_LIMBS)
    if ((_np_geq(x, _P_LIMBS) | _np_geq(yl, _P_LIMBS)) & ~inf).any():
        raise ValueError("coordinate is not canonical")
    xm = to_mont(x.T, device)
    ym = to_mont(yl.T, device)
    if not _on_curve(ym, _curve_rhs(xm), inf_t):
        raise ValueError("point is not on the curve")
    return G1Aff(xm, ym, inf_t)
