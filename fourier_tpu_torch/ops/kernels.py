"""The hand-written CUDA kernels of the G1 path, their wrappers and their
plain PyTorch twins.

| kernel      | source               | replaces (fourier_tpu)                                    |
|-------------|----------------------|-----------------------------------------------------------|
| accumulate  | csrc/accumulate.cu   | ops/msm_fused.py:_accum_kernel, ops/pallas_curve.py:_madd_inc_kernel |
| g1_add      | csrc/g1_add.cu       | ops/pallas_curve.py:_add_inc_kernel                        |
| g1_dbl      | csrc/g1_dbl.cu       | ops/pallas_curve.py:_dbl_kernel                            |
| horner_2k   | csrc/horner_2k.cu    | ops/pallas_curve.py:horner_2k                              |
| g1_madd     | csrc/g1_madd.cu      | ops/pallas_curve.py:_madd_kernel                           |

ops/pallas_curve.py:_add_kernel (the complete Jacobian add behind
pallas_curve.add) computes K2's function on every lane and maps to K2.

The kernels are built with nvcc for sm_90a at first use, one nvcc per
source, all started together, then linked into one library in
``fourier_tpu_torch/_build`` under a name keyed by a hash of the sources
and flags; the library is bound through a plain C interface with ctypes.
A wrapper given CUDA tensors launches its kernel on the current stream or
raises; given CPU tensors it runs the plain twin.  Every launch adds one to
``COUNTERS.launches[name]``; lanes that took the doubling branch of a
complete addition are summed on the device into ``COUNTERS.collisions``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

from ..constants import FP_LIMBS

from . import curve as cv
from .curve import G1Aff, G1Jac
from .field import FP

KERNELS = ("accumulate", "g1_add", "g1_dbl", "horner_2k", "g1_madd")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_SOURCES = ("accumulate.cu", "g1_add.cu", "g1_dbl.cu", "horner_2k.cu", "g1_madd.cu",
            "errors.cu")
_HEADERS = ("g1.cuh",)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")


class KernelCounters:
    """Launch counts (host integers) and doubling-branch lanes (device
    int64 scalars, one per kernel and device; reading them synchronises)."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)
        self._collisions: dict = {}

    def reset(self):
        self.launches = dict.fromkeys(KERNELS, 0)
        for t in self._collisions.values():
            t.zero_()

    def collision_buffer(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._collisions:
            self._collisions[key] = torch.zeros(1, dtype=torch.int64, device=device)
        return self._collisions[key]

    def collisions(self) -> dict:
        out = dict.fromkeys(KERNELS, 0)
        for (name, _), t in self._collisions.items():
            out[name] += int(t.item())
        return out


COUNTERS = KernelCounters()


# -- build ------------------------------------------------------------------------

def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] \
        if os.environ.get("CUDA_HOME") else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(b"\0" + name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _compile_and_link(path: str) -> None:
    """One nvcc per source, all running at once, then one link; the
    library appears under its final name only when complete."""
    nvcc = _nvcc()
    work = f"{path}.{os.getpid()}.d"
    os.makedirs(work, exist_ok=True)
    try:
        objs = [os.path.join(work, s + ".o") for s in _SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, s), "-o", o],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(_SOURCES, objs)]
        outs = [(s, p.communicate()[0], p.returncode) for s, p in zip(_SOURCES, procs)]
        failed = [f"{s} ({rc}):\n{out}" for s, out, rc in outs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        res = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


@functools.cache
def build() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    path = os.path.join(BUILD_DIR, f"libfourier_kernels-{_digest()}.so")
    if not os.path.exists(path):
        _compile_and_link(path)
    lib = ctypes.CDLL(path)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.fk_accumulate.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp, vp, vp]
    lib.fk_g1_add.argtypes = [vp] * 9 + [i64, vp, vp]
    lib.fk_g1_dbl.argtypes = [vp] * 6 + [i64, i32, vp]
    lib.fk_horner_2k.argtypes = [vp, vp, vp, i64, i64, vp, vp, vp, vp, vp]
    lib.fk_g1_madd.argtypes = [vp] * 9 + [i64, vp, vp]
    for fn in (lib.fk_accumulate, lib.fk_g1_add, lib.fk_g1_dbl, lib.fk_horner_2k,
               lib.fk_g1_madd):
        fn.restype = ctypes.c_int
    lib.fk_error_string.argtypes = [ctypes.c_int]
    lib.fk_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.fk_error_string(rc).decode()})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# -- argument checks ------------------------------------------------------------

def _coords(p):
    """Coordinates as contiguous int64 [24, n] tensors on one device."""
    out = []
    for c in p:
        if c.dtype != torch.int64 or c.shape[0] != FP_LIMBS:
            raise ValueError(f"expected int64 [{FP_LIMBS}, ...] limbs, got "
                             f"{c.dtype} {tuple(c.shape)}")
        out.append(c.reshape(FP_LIMBS, -1).contiguous())
    if any(c.device != out[0].device or c.shape != out[0].shape for c in out):
        raise ValueError("coordinates differ in device or shape")
    return out


def _empty_like_coords(n: int, device):
    return [torch.empty((FP_LIMBS, n), dtype=torch.int64, device=device)
            for _ in range(3)]


# -- K1 accumulate ----------------------------------------------------------------

def unpack_rows(rows: torch.Tensor):
    """[n, 24] packed words (x then y, 32-bit limbs) -> ([24, n], [24, n])
    16-bit limbs."""
    w = rows.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(rows.shape[0], 2 * FP_LIMBS)
    return limbs[:, :FP_LIMBS].T, limbs[:, FP_LIMBS:].T


def accumulate_plain(table, index, start, count) -> G1Jac:
    """Plain twin of K1: one complete mixed add per step for every slot
    that still has rows, in run order."""
    S = start.shape[0]
    acc = cv.jac_identity((S,), table.device)
    if S == 0 or index.shape[0] == 0:
        return acc
    index = index.to(torch.int64)
    start = start.to(torch.int64)
    count = count.to(torch.int64)
    for k in range(int(count.max())):
        valid = k < count
        e = index[torch.where(valid, start + k, 0)]
        qx, qy = unpack_rows(table[e >> 2])
        qy = FP.select((e & 2) != 0, FP.neg(qy), qy)
        acc = cv.madd(acc, G1Aff(qx, qy, ((e & 1) != 0) | ~valid))
    return acc


def accumulate(table, index, start, count) -> G1Jac:
    """K1: out[s] = the sum of the rows index[start[s] : start[s] + count[s]]
    of the packed table, added in order to the identity.

    table: int32 [rows, 24]; index: int32 entries (row << 2) | (negate << 1)
    | infinity; start, count: int32 [S].  Returns int64 [24, S] limbs."""
    dev = table.device
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[1] != FP_LIMBS:
        raise ValueError(f"table must be int32 [rows, {FP_LIMBS}]")
    for name, t in (("index", index), ("start", start), ("count", count)):
        if t.dtype != torch.int32 or t.ndim != 1 or t.device != dev:
            raise ValueError(f"{name} must be a 1-D int32 tensor on {dev}")
    if start.shape != count.shape:
        raise ValueError("start and count differ in shape")
    S = start.shape[0]
    if dev.type == "cpu":
        return accumulate_plain(table, index, start, count)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = build()
    table, index = table.contiguous(), index.contiguous()
    start, count = start.contiguous(), count.contiguous()
    out = _empty_like_coords(S, dev)
    rc = lib.fk_accumulate(
        _ptr(table), _ptr(index), _ptr(start), _ptr(count), S, *map(_ptr, out),
        _ptr(COUNTERS.collision_buffer("accumulate", dev)), _stream(dev))
    COUNTERS.launches["accumulate"] += 1
    _check(lib, "accumulate", rc)
    return G1Jac(*out)


# -- K2 g1_add ----------------------------------------------------------------------

def g1_add_plain(p: G1Jac, q: G1Jac) -> G1Jac:
    return cv.add(p, q)


def g1_add(p: G1Jac, q: G1Jac) -> G1Jac:
    """K2: batched complete Jacobian addition, any batch shape."""
    shape = p.x.shape
    if q.x.shape != shape:
        raise ValueError(f"batch shapes differ: {tuple(shape)} vs {tuple(q.x.shape)}")
    a = _coords(p)
    b = _coords(q)
    dev = a[0].device
    if b[0].device != dev:
        raise ValueError("operands on different devices")
    if dev.type == "cpu":
        out = g1_add_plain(G1Jac(*a), G1Jac(*b))
    elif dev.type == "cuda":
        lib = build()
        n = a[0].shape[1]
        out = _empty_like_coords(n, dev)
        rc = lib.fk_g1_add(*map(_ptr, a + b + out), n,
                           _ptr(COUNTERS.collision_buffer("g1_add", dev)), _stream(dev))
        COUNTERS.launches["g1_add"] += 1
        _check(lib, "g1_add", rc)
    else:
        raise ValueError(f"unsupported device {dev}")
    return G1Jac(*(c.reshape(shape) for c in out))


# -- K5 g1_madd ---------------------------------------------------------------------

def g1_madd_plain(p: G1Jac, q: G1Aff) -> G1Jac:
    return cv.madd(p, q)


def g1_madd(p: G1Jac, q: G1Aff) -> G1Jac:
    """K5: batched complete mixed addition p + q (q affine, bool infinity
    mask), any batch shape."""
    shape = p.x.shape
    if q.x.shape != shape or q.inf.shape != shape[1:]:
        raise ValueError(f"batch shapes differ: {tuple(shape)} vs {tuple(q.x.shape)}")
    if q.inf.dtype != torch.bool:
        raise ValueError(f"q.inf must be bool, got {q.inf.dtype}")
    a = _coords(p)
    b = _coords(q[:2])
    inf = q.inf.reshape(-1).contiguous()
    dev = a[0].device
    if b[0].device != dev or inf.device != dev:
        raise ValueError("operands on different devices")
    if dev.type == "cpu":
        out = g1_madd_plain(G1Jac(*a), G1Aff(*b, inf))
    elif dev.type == "cuda":
        lib = build()
        n = a[0].shape[1]
        out = _empty_like_coords(n, dev)
        rc = lib.fk_g1_madd(*map(_ptr, a + b), _ptr(inf), *map(_ptr, out), n,
                            _ptr(COUNTERS.collision_buffer("g1_madd", dev)), _stream(dev))
        COUNTERS.launches["g1_madd"] += 1
        _check(lib, "g1_madd", rc)
    else:
        raise ValueError(f"unsupported device {dev}")
    return G1Jac(*(c.reshape(shape) for c in out))


# -- K3 g1_dbl ----------------------------------------------------------------------

def g1_dbl_plain(p: G1Jac, repeat: int = 1) -> G1Jac:
    for _ in range(repeat):
        p = cv.dbl(p)
    return p


def g1_dbl(p: G1Jac, repeat: int = 1) -> G1Jac:
    """K3: `repeat` successive doublings of every lane, any batch shape."""
    if repeat < 0:
        raise ValueError("repeat must be >= 0")
    shape = p.x.shape
    a = _coords(p)
    dev = a[0].device
    if dev.type == "cpu":
        out = g1_dbl_plain(G1Jac(*a), repeat)
    elif dev.type == "cuda":
        lib = build()
        n = a[0].shape[1]
        out = _empty_like_coords(n, dev)
        rc = lib.fk_g1_dbl(*map(_ptr, a + out), n, repeat, _stream(dev))
        COUNTERS.launches["g1_dbl"] += 1
        _check(lib, "g1_dbl", rc)
    else:
        raise ValueError(f"unsupported device {dev}")
    return G1Jac(*(c.reshape(shape) for c in out))


# -- K4 horner_2k ---------------------------------------------------------------------

def horner_2k_plain(terms: G1Jac, width: int) -> G1Jac:
    K = terms.x.shape[1] // width

    def term(k):
        return G1Jac(*(c[:, k * width:(k + 1) * width] for c in terms))

    acc = term(K - 1)
    for k in range(K - 2, -1, -1):
        acc = cv.add(cv.dbl(acc), term(k))
    return acc


def horner_2k(terms: G1Jac, width: int) -> G1Jac:
    """K4: sum_k 2^k * T_k per residual lane, for [24, K * width] terms
    (term k in columns [k * width, (k + 1) * width)); returns [24, width]."""
    t = _coords(terms)
    n = t[0].shape[1]
    if width <= 0 or n == 0 or n % width:
        raise ValueError(f"{n} columns are not a positive multiple of width {width}")
    dev = t[0].device
    if dev.type == "cpu":
        return horner_2k_plain(G1Jac(*t), width)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = build()
    out = _empty_like_coords(width, dev)
    rc = lib.fk_horner_2k(*map(_ptr, t), n // width, width, *map(_ptr, out),
                          _ptr(COUNTERS.collision_buffer("horner_2k", dev)), _stream(dev))
    COUNTERS.launches["horner_2k"] += 1
    _check(lib, "horner_2k", rc)
    return G1Jac(*out)
