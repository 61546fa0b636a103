"""Host-side limb packing: Python ints / bytes <-> numpy uint32 limb arrays.

Device representation: little-endian 16-bit limbs stored one per uint32
lane, shape ``[..., L]`` (L=16 for Fr, L=24 for Fp).  16-bit limbs keep
limb products exactly representable in 32-bit integer lanes, with
headroom for carry-deferred column accumulation.  A copy of
``fourier_tpu.ops.limbs``, so the port's limbs are the JAX package's; the
torch tensors hold them as int64.
"""

from __future__ import annotations

import numpy as np

from ..constants import FP_LIMBS, FR_LIMBS, LIMB_BITS, LIMB_MASK


def ints_to_limbs(values, n_limbs: int) -> np.ndarray:
    """List/iterable of ints -> [n, n_limbs] uint32 little-endian limbs.

    Vectorized through int.to_bytes + numpy (the per-limb Python loop cost
    ~60s at 2^19 elements)."""
    values = list(values)
    nbytes = 2 * n_limbs
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    a = np.frombuffer(buf, np.uint8).reshape(len(values), nbytes)
    return np.ascontiguousarray(
        a[:, 0::2].astype(np.uint32) | (a[:, 1::2].astype(np.uint32) << 8)
    )


def int_to_limbs(v: int, n_limbs: int) -> np.ndarray:
    return ints_to_limbs([v], n_limbs)[0]


def limbs_to_ints(arr) -> list[int]:
    """[..., L] limbs -> flat list of ints over the leading dims."""
    a = np.asarray(arr, dtype=np.uint32)
    flat = a.reshape(-1, a.shape[-1])
    n, L = flat.shape
    le = np.empty((n, 2 * L), np.uint8)
    le[:, 0::2] = flat & 0xFF
    le[:, 1::2] = (flat >> 8) & 0xFF
    buf = le.tobytes()
    w = 2 * L
    return [
        int.from_bytes(buf[i * w : (i + 1) * w], "little") for i in range(n)
    ]


def limbs_to_int(arr) -> int:
    return limbs_to_ints(np.asarray(arr).reshape(1, -1))[0]


def bytes_be_to_limbs(buf: bytes, nbytes: int, n_limbs: int) -> np.ndarray:
    """Concatenated big-endian ``nbytes``-wide values -> [n, n_limbs] limbs.

    Vectorized wire decode: 32-byte scalars (nbytes=32, 16 limbs) or
    48-byte field elements (nbytes=48, 24 limbs).
    """
    a = np.frombuffer(buf, dtype=np.uint8)
    if a.size % nbytes:
        raise ValueError(f"buffer size {a.size} not a multiple of {nbytes}")
    a = a.reshape(-1, nbytes)[:, ::-1]  # little-endian byte order
    lo = a[:, 0::2].astype(np.uint32)
    hi = a[:, 1::2].astype(np.uint32)
    limbs = lo | (hi << 8)
    if limbs.shape[1] > n_limbs:
        raise ValueError("value wider than limb layout")
    if limbs.shape[1] < n_limbs:
        pad = np.zeros((limbs.shape[0], n_limbs - limbs.shape[1]), np.uint32)
        limbs = np.concatenate([limbs, pad], axis=1)
    return np.ascontiguousarray(limbs)


def limbs_to_bytes_be(arr, nbytes: int) -> bytes:
    """[n, L] limbs -> concatenated big-endian nbytes-wide encodings."""
    a = np.asarray(arr, dtype=np.uint32).reshape(-1, np.asarray(arr).shape[-1])
    n, L = a.shape
    le = np.empty((n, 2 * L), dtype=np.uint8)
    le[:, 0::2] = a & 0xFF
    le[:, 1::2] = (a >> 8) & 0xFF
    if 2 * L > nbytes:
        if np.any(le[:, nbytes:]):
            raise ValueError("value does not fit target width")
        le = le[:, :nbytes]
    be = le[:, ::-1]
    if 2 * L < nbytes:
        pad = np.zeros((n, nbytes - 2 * L), np.uint8)
        be = np.concatenate([pad, be], axis=1)
    return be.tobytes()


def fr_ints_to_limbs(values) -> np.ndarray:
    return ints_to_limbs(values, FR_LIMBS)


def fp_ints_to_limbs(values) -> np.ndarray:
    return ints_to_limbs(values, FP_LIMBS)


# -- device-form helpers (limb axis leading) --------------------------------

def ints_to_vec(values, n_limbs: int) -> np.ndarray:
    """List of ints -> [L, n] uint32 (device layout: limb axis leading)."""
    return np.ascontiguousarray(ints_to_limbs(values, n_limbs).T)


def int_to_vec(v: int, n_limbs: int) -> np.ndarray:
    """Single int -> [L, 1] uint32 (device layout, singleton batch)."""
    return ints_to_vec([v], n_limbs)


def vec_to_ints(arr) -> list[int]:
    """[L, ...batch] device-layout limbs -> flat list of ints."""
    a = np.asarray(arr)
    return limbs_to_ints(a.reshape(a.shape[0], -1).T)


def vec_to_int(arr) -> int:
    return vec_to_ints(arr)[0]
