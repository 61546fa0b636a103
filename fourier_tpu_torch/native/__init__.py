"""Native (C++) host-side kernels, loaded via ctypes: the port's copy of
``fourier_tpu.native`` (sources included), which the port does not import.

Two translation units:
- fastwire.cpp     — wire marshalling (base64, limb packing) with
                     canonicality checking fused in.
- fastpairing.cpp  — the BLS12-381 multi-pairing verify kernel (the
                     architecture of the reference's blst FFI,
                     reference src/engine/piano.rs:358-464).

Each builds lazily with g++ on first use into a shared library whose
filename is keyed on a content hash of its source, under
``fourier_tpu_torch/_build`` (never beside the sources, never committed):
a stale build can never serve requests (mtimes are not preserved by git
checkouts).  A failed build raises: the port needs g++ on its host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_libs: dict[str, object] = {}

# Compile command; part of the .so cache key (a flags-only change must
# rebuild — a binary built with stale flags can otherwise serve forever).
_CXX_FLAGS = ["g++", "-O3", "-shared", "-fPIC", "-pthread"]


def _load(stem: str):
    """Load (building if needed) lib<stem>-<hash(src+flags)>.so; raises
    RuntimeError when g++ fails."""
    if stem in _libs:
        return _libs[stem]
    src = os.path.join(_HERE, f"{stem}.cpp")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + b"\0" + " ".join(_CXX_FLAGS).encode()
        ).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"  # a concurrent build never sees half a file
        os.makedirs(BUILD_DIR, exist_ok=True)
        res = subprocess.run(_CXX_FLAGS + ["-o", tmp, src], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {stem} ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    _libs[stem] = lib
    return lib


def get_lib():
    """The wire-marshalling library."""
    lib = _load("fastwire")
    if not getattr(lib, "_fw_typed", False):
        lib.fw_b64decode_many.restype = ctypes.c_int64
        lib.fw_decode_scalars.restype = ctypes.c_int64
        lib._fw_typed = True
    return lib


def get_pairing_lib():
    """The pairing library."""
    lib = _load("fastpairing")
    if not getattr(lib, "_fp_typed", False):
        # argtypes must be declared: ctypes passes bare Python ints as
        # 32-bit c_int, leaving the high half of an int64_t parameter
        # undefined on the C side.
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.fw_pairings_check.restype = ctypes.c_int
        lib.fw_pairings_check.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.fw_pairing.restype = ctypes.c_int
        lib.fw_pairing.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            u8p,
        ]
        lib.fw_g1_msm.restype = ctypes.c_int
        lib.fw_g1_msm.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, u8p,
        ]
        lib.fw_g1_add.restype = ctypes.c_int
        lib.fw_g1_add.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, u8p,
        ]
        lib.fw_g2_mul.restype = ctypes.c_int
        lib.fw_g2_mul.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u8p]
        lib.fw_g2_add.restype = ctypes.c_int
        lib.fw_g2_add.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, u8p,
        ]
        lib._fp_typed = True
    return lib


def decode_scalars_b64(strs: list[str], modulus_be: bytes, n_limbs: int):
    """Batch base64 -> canonical-checked [n, n_limbs] uint32 limbs."""
    lib = get_lib()
    data = "".join(strs).encode("ascii")
    offsets = np.zeros(len(strs) + 1, np.int64)
    np.cumsum([len(s) for s in strs], out=offsets[1:])
    out = np.empty((len(strs), n_limbs), np.uint32)
    bad = lib.fw_decode_scalars(
        data,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(strs),
        modulus_be,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n_limbs,
    )
    if bad >= 0:
        raise ValueError(f"scalar {bad} is malformed or not canonical")
    return out


def encode_b64_batch(raw: np.ndarray) -> list[str]:
    """[n, item_len] uint8 rows -> unpadded-base64 strings."""
    lib = get_lib()
    n, item_len = raw.shape
    stride = (item_len * 4 + 2) // 3
    out = np.empty((n, stride), np.uint8)
    raw = np.ascontiguousarray(raw)
    lib.fw_b64encode_many(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        item_len,
        out.ctypes.data_as(ctypes.c_char_p),
        stride,
    )
    flat = out.tobytes().decode("ascii")
    return [flat[i * stride : (i + 1) * stride] for i in range(n)]


# -- pairing entry points ----------------------------------------------------

_P2_BE = None
_HARD_BE = None


def _exponents():
    """The easy/hard final-exponentiation exponents, computed host-side
    once (the C++ side has no multiprecision integers)."""
    global _P2_BE, _HARD_BE
    if _P2_BE is None:
        from ..constants import P, R

        p2 = P * P
        hard = (P**4 - P**2 + 1) // R
        _P2_BE = p2.to_bytes((p2.bit_length() + 7) // 8, "big")
        _HARD_BE = hard.to_bytes((hard.bit_length() + 7) // 8, "big")
    return _P2_BE, _HARD_BE


def _enc_g1(pt) -> bytes:
    if pt is None:
        return bytes(96)
    x, y = pt
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def _enc_g2(pt) -> bytes:
    if pt is None:
        return bytes(192)
    x, y = pt
    return (
        x.c0.to_bytes(48, "big") + x.c1.to_bytes(48, "big")
        + y.c0.to_bytes(48, "big") + y.c1.to_bytes(48, "big")
    )


def pairings_check(pairs) -> bool | None:
    """prod e(P_i, Q_i) == 1 for affine int/Fp2 points, or None when the
    input is degenerate (caller uses refimpl)."""
    lib = get_pairing_lib()
    g1s = b"".join(_enc_g1(p) for p, _ in pairs)
    g2s = b"".join(_enc_g2(q) for _, q in pairs)
    p2, hard = _exponents()
    rc = lib.fw_pairings_check(
        g1s, g2s, len(pairs), p2, len(p2), hard, len(hard)
    )
    if rc < 0:
        return None
    return bool(rc)


def _dec_g1(raw: bytes):
    if not any(raw):
        return None
    return (int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:], "big"))


def _dec_g2(raw: bytes):
    if not any(raw):
        return None
    from ..refimpl.tower import Fp2

    return (
        Fp2(int.from_bytes(raw[:48], "big"),
            int.from_bytes(raw[48:96], "big")),
        Fp2(int.from_bytes(raw[96:144], "big"),
            int.from_bytes(raw[144:], "big")),
    )


def g1_msm(points, scalars) -> "tuple | None":
    """sum_i k_i * P_i over affine int G1 points."""
    lib = get_pairing_lib()
    from ..constants import R

    pts = b"".join(_enc_g1(p) for p in points)
    ks = b"".join((int(k) % R).to_bytes(32, "big") for k in scalars)
    out = np.zeros(96, np.uint8)
    lib.fw_g1_msm(pts, ks, len(points),
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return _dec_g1(out.tobytes())


def g1_combine(a, b, negate_b: bool) -> "tuple | None":
    """a + b or a - b."""
    lib = get_pairing_lib()
    out = np.zeros(96, np.uint8)
    lib.fw_g1_add(_enc_g1(a), _enc_g1(b), int(negate_b),
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return _dec_g1(out.tobytes())


def g2_mul(q, k: int) -> "tuple | None":
    """k * Q for an affine Fp2 G2 point."""
    lib = get_pairing_lib()
    from ..constants import R

    out = np.zeros(192, np.uint8)
    lib.fw_g2_mul(_enc_g2(q), (int(k) % R).to_bytes(32, "big"),
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return _dec_g2(out.tobytes())


def g2_combine(a, b, negate_b: bool) -> "tuple | None":
    lib = get_pairing_lib()
    out = np.zeros(192, np.uint8)
    lib.fw_g2_add(_enc_g2(a), _enc_g2(b), int(negate_b),
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return _dec_g2(out.tobytes())


def pairing_value(p, q) -> list[int] | None:
    """Full pairing e(P, Q) as 12 canonical Fp ints (test hook), or None
    when the input is degenerate."""
    lib = get_pairing_lib()
    p2, hard = _exponents()
    out = np.zeros(12 * 48, np.uint8)
    rc = lib.fw_pairing(
        _enc_g1(p), _enc_g2(q), p2, len(p2), hard, len(hard),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        return None
    raw = out.tobytes()
    return [int.from_bytes(raw[48 * k : 48 * (k + 1)], "big") for k in range(12)]
