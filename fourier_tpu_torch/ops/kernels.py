"""The hand-written CUDA kernels of the G1 path and of the open's Fr
quotient, their wrappers and their plain PyTorch twins.

| kernel         | source             | replaces (fourier_tpu)                                    |
|----------------|--------------------|-----------------------------------------------------------|
| accumulate     | csrc/accumulate.cu | ops/msm_fused.py:_accum_kernel, ops/pallas_curve.py:_madd_inc_kernel |
| g1_add         | csrc/g1_add.cu     | ops/pallas_curve.py:_add_inc_kernel                        |
| g1_tree_reduce | csrc/g1_tree.cu    | ops/pallas_curve.py:_add_inc_kernel in the halving trees of ops/curve.py |
| g1_dbl         | csrc/g1_dbl.cu     | ops/pallas_curve.py:_dbl_kernel                            |
| horner_2k      | csrc/horner_2k.cu  | ops/pallas_curve.py:horner_2k, and ops/msm.py:_horner_2k's fold |
| g1_madd        | csrc/g1_madd.cu    | ops/pallas_curve.py:_madd_kernel                           |
| g1_madd_ladder | csrc/g1_madd.cu    | ops/msm.py:msm_naive's steps: ops/pallas_curve.py:_add_inc_kernel, _dbl_kernel |
| fr_quotient_*  | csrc/fr_quotient.cu | none: models/piano.py:_eval_form_open is jnp that XLA fuses |

ops/pallas_curve.py:_add_kernel (the complete Jacobian add behind
pallas_curve.add) computes K2's function on every lane and maps to K2.
The bucket-reduction trees, one K2 launch a level in the reference's
form, run through g1_tree_reduce, one launch for up to TREE_MAX_TREES
independent trees; K2 serves msm_naive's tree.  accumulate cuts each run
into pieces of at most PIECE rows; its plain twin takes the piece size
(None: whole runs, the reference's association).  horner_2k also takes in
the fold of the residual lanes after the reference's Horner chain, and
returns one point.  g1_madd_ladder is K5's second entry: msm_naive's whole
double-and-add (a doubling and a mixed add a scalar bit) in one launch.
Every point formula of the kernels (csrc/g1.cuh) runs on redundant
coordinates in [0, 2p) and stores canonical limbs (tests/torch_redundant.py
models their values in Python ints).  fr_quotient is the evaluation-form
quotient of a workerOpen in four launches (inv, sum, eval, qhat: one
batch inversion that stays on the card, a Fermat inversion a block of
csrc/fr_quotient.cu, then the sums, y and q); its plain twin is the
tensor code of ops/field.py.

The kernels are built with nvcc for sm_90a at first use, one nvcc per
source, all started together, then linked into one library in
``fourier_tpu_torch/_build`` under a name keyed by a hash of the sources
and flags; the library is bound through a plain C interface with ctypes.
A wrapper given CUDA tensors launches its kernel on their device's current
stream or raises; given CPU tensors it runs the plain twin.  It launches
from the context of its tensors' device, whatever the calling thread's
current device, so threads working for several cards (the in-process
shards of parallel/mesh.py) may launch at once.  Every launch adds one to
``COUNTERS.launches[name]``, under a lock; lanes that took the doubling
branch of a complete addition are summed on the device into
``COUNTERS.collisions`` (the ladder's steps under g1_madd).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..constants import FP_LIMBS, FR_LIMBS, LIMB_BITS

from . import curve as cv
from .curve import G1Aff, G1Jac
from .field import FP, FR

KERNELS = ("accumulate", "g1_add", "g1_tree_reduce", "g1_dbl", "horner_2k", "g1_madd",
           "g1_madd_ladder", "fr_quotient_inv", "fr_quotient_sum", "fr_quotient_eval",
           "fr_quotient_qhat")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# fp_mul_bench.cu holds no kernel of the path: dependent chains of the Fp
# product and square and of the additions, whose latencies chip_smoke.py
# and kernel_probe.py measure for the latency floors
_SOURCES = ("accumulate.cu", "g1_add.cu", "g1_tree.cu", "g1_dbl.cu", "horner_2k.cu",
            "g1_madd.cu", "fr_quotient.cu", "fp_mul_bench.cu", "errors.cu")
_HEADERS = ("g1.cuh", "fr.cuh")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# K1 cuts every run into pieces of at most PIECE rows, one thread a piece.
# At least 32 keeps each fixed-base setup run (W = 32 rows at c = 8) whole.
PIECE = 32
# g1_tree_reduce keeps at most TREE_LANES lanes of a group in shared memory
# (144 bytes a lane) and folds wider groups while loading them, over at
# most TREE_MAX_FAN_LEVELS levels; a block of TREE_THREADS threads owns a
# group, and one launch carries at most TREE_MAX_TREES trees.  The last
# three are also compiled into csrc/g1_tree.cu.
TREE_LANES = 256
TREE_THREADS = 64
TREE_MAX_FAN_LEVELS = 8
TREE_MAX_TREES = 4


class KernelCounters:
    """Launch counts (host integers) and doubling-branch lanes (device
    int64 scalars, one per kernel and device; reading them synchronises).
    Threads may launch at once: counting and creating a buffer take a
    lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = dict.fromkeys(KERNELS, 0)
        self._collisions: dict = {}

    def reset(self):
        with self._lock:
            self.launches = dict.fromkeys(KERNELS, 0)
            for t in self._collisions.values():
                t.zero_()

    def count(self, name: str):
        with self._lock:
            self.launches[name] += 1

    def total(self) -> int:
        """Launches of every kernel so far."""
        with self._lock:
            return sum(self.launches.values())

    def collision_buffer(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        with self._lock:
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


_BUILD_LOCK = threading.Lock()


def build() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library; threads
    that ask at once wait for one build."""
    with _BUILD_LOCK:
        return _build()


@functools.cache
def _build() -> ctypes.CDLL:
    path = os.path.join(BUILD_DIR, f"libfourier_kernels-{_digest()}.so")
    if not os.path.exists(path):
        _compile_and_link(path)
    lib = ctypes.CDLL(path)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.fk_accumulate.argtypes = [vp] * 5 + [i64, i32, i64] + [vp] * 6
    lib.fk_g1_add.argtypes = [vp] * 9 + [i64, vp, vp]
    lib.fk_g1_tree_reduce.argtypes = [i32, vp, i32, vp, vp]
    lib.fk_g1_dbl.argtypes = [vp] * 6 + [i64, i32, vp]
    lib.fk_horner_2k.argtypes = [vp, vp, vp, i64, i64, i32, i32] + [vp] * 6
    lib.fk_g1_madd.argtypes = [vp] * 9 + [i64, vp, vp]
    lib.fk_g1_madd_ladder.argtypes = [vp] * 4 + [i32] + [vp] * 3 + [i64, vp, vp]
    lib.fk_fr_quotient_inv.argtypes = [vp, vp, i64] + [vp] * 4
    lib.fk_fr_quotient_sum.argtypes = [vp, vp, i64, i64, vp, vp]
    lib.fk_fr_quotient_eval.argtypes = [vp] * 4 + [i64, i64] + [vp] * 3
    lib.fk_fr_quotient_qhat.argtypes = [vp] * 3 + [i64, i64, vp, vp]
    lib.fk_fr_quotient_blocks.argtypes = [i64]
    lib.fk_fr_quotient_blocks.restype = i64
    for fn in (lib.fk_accumulate, lib.fk_g1_add, lib.fk_g1_tree_reduce, lib.fk_g1_dbl,
               lib.fk_horner_2k, lib.fk_g1_madd, lib.fk_g1_madd_ladder, lib.fk_fr_quotient_inv,
               lib.fk_fr_quotient_sum, lib.fk_fr_quotient_eval, lib.fk_fr_quotient_qhat):
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


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call the library's fk_<name>(*args, stream of dev) from dev's
    context (the launch, and g1_tree_reduce's cudaFuncSetAttribute, act on
    the calling thread's current device), count the launch and raise if it
    failed."""
    lib = build()
    with torch.cuda.device(dev):
        rc = getattr(lib, "fk_" + name)(*args, _stream(dev))
    COUNTERS.count(name)
    _check(lib, name, rc)


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


def _runs_plain(table, index, start, count) -> G1Jac:
    """Every run summed from the identity, one complete mixed add per step
    over the slots whose run has a row left, in run order."""
    acc = cv.jac_identity((start.shape[0],), table.device)
    if start.shape[0] == 0 or index.shape[0] == 0:
        return acc
    for k in range(int(count.max())):
        lanes = torch.nonzero(count > k).reshape(-1)
        e = index[start[lanes] + k]
        qx, qy = unpack_rows(table[e >> 2])
        qy = FP.select((e & 2) != 0, FP.neg(qy), qy)
        new = cv.madd(G1Jac(*(c[:, lanes] for c in acc)), G1Aff(qx, qy, (e & 1) != 0))
        for c, v in zip(acc, new):
            c[:, lanes] = v
    return acc


def accumulate_plain(table, index, start, count, piece: int | None = None) -> G1Jac:
    """Plain twin of K1.  piece=None sums each run whole, in run order (the
    reference's association).  Otherwise the kernel's: each run is cut into
    pieces of at most `piece` rows, every piece summed from the identity in
    run order, then a slot's piece sums added left to right with the
    complete Jacobian add."""
    index = index.to(torch.int64)
    start = start.to(torch.int64)
    count = count.to(torch.int64)
    if piece is None:
        return _runs_plain(table, index, start, count)
    S = start.shape[0]
    pieces = (count + (piece - 1)) // piece
    first = torch.cumsum(pieces, 0) - pieces
    slot = torch.repeat_interleave(torch.arange(S, device=start.device), pieces)
    k = torch.arange(slot.shape[0], device=start.device) - first[slot]
    sums = _runs_plain(table, index, start[slot] + k * piece,
                       torch.clamp(count[slot] - k * piece, max=piece))
    acc = cv.jac_identity((S,), table.device)
    for j in range(int(pieces.max()) if S else 0):
        lanes = torch.nonzero(pieces > j).reshape(-1)
        q = G1Jac(*(c[:, first[lanes] + j] for c in sums))
        new = q if j == 0 else cv.add(G1Jac(*(c[:, lanes] for c in acc)), q)
        for c, v in zip(acc, new):
            c[:, lanes] = v
    return acc


def accumulate(table, index, start, count) -> G1Jac:
    """K1: out[s] = the sum of the rows index[start[s] : start[s] + count[s]]
    of the packed table, each run cut into pieces of at most PIECE rows
    (see accumulate_plain; a run of at most PIECE rows is summed whole).

    table: int32 [rows, 24]; index: int32 entries (row << 2) | (negate << 1)
    | infinity; start, count: int32 [S], the runs disjoint ranges of index.
    Returns int64 [24, S] limbs."""
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
        return accumulate_plain(table, index, start, count, piece=PIECE)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    table, index = table.contiguous(), index.contiguous()
    start, count = start.contiguous(), count.contiguous()
    piece_end = torch.cumsum((count + (PIECE - 1)) // PIECE, 0, dtype=torch.int32)
    # disjoint runs hold at most len(index) rows: a bound on the pieces
    # that needs no read of piece_end on the host
    max_pieces = -(-index.shape[0] // PIECE) + S
    partial = torch.empty((3 * FP_LIMBS // 2, max_pieces), dtype=torch.int32, device=dev)
    out = _empty_like_coords(S, dev)
    _launch("accumulate", dev,
            _ptr(table), _ptr(index), _ptr(start), _ptr(count), _ptr(piece_end), S, PIECE,
            max_pieces, _ptr(partial), *map(_ptr, out),
            _ptr(COUNTERS.collision_buffer("accumulate", dev)))
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
        n = a[0].shape[1]
        out = _empty_like_coords(n, dev)
        _launch("g1_add", dev, *map(_ptr, a + b + out), n,
                _ptr(COUNTERS.collision_buffer("g1_add", dev)))
    else:
        raise ValueError(f"unsupported device {dev}")
    return G1Jac(*(c.reshape(shape) for c in out))


# -- g1_tree_reduce -------------------------------------------------------------------

def g1_tree_reduce_plain(p: G1Jac, axis: int = -1, to: int = 1) -> G1Jac:
    """Plain twin of g1_tree_reduce: the reference's halving loop over the
    complete add."""
    return cv.halving_tree(p, axis, to)


def _tree_layout(p: G1Jac, axis: int):
    """(coordinates, groups0, groups1, strides) for the tree kernel: the
    dims other than the limbs and `axis` as at most two group dims, size-1
    dims dropped and neighbours merged where every coordinate's strides
    allow (coordinates that still need more are made contiguous); strides
    are (limb, group 0, group 1, leaf) for x, y and z in turn."""
    coords = list(p)
    for _ in range(2):
        merged = []
        for d, size in enumerate(coords[0].shape):
            if d in (0, axis) or size == 1:
                continue
            strides = tuple(c.stride(d) for c in coords)
            if merged and all(a == b * size for a, b in zip(merged[-1][1], strides)):
                merged[-1] = (merged[-1][0] * size, strides)
            else:
                merged.append((size, strides))
        if len(merged) <= 2:
            break
        coords = [c.contiguous() for c in coords]
    merged += [(1, (0, 0, 0))] * (2 - len(merged))
    strides = [v for k, c in enumerate(coords)
               for v in (c.stride(0), merged[0][1][k], merged[1][1][k], c.stride(axis))]
    return coords, merged[0][0], merged[1][0], strides


def _tree_spec(p: G1Jac, axis: int, to: int):
    if to < 1:
        raise ValueError("to must be >= 1")
    shape = p.x.shape
    for c in p:
        if c.dtype != torch.int64 or c.shape[0] != FP_LIMBS or c.shape != shape:
            raise ValueError(f"expected int64 [{FP_LIMBS}, ...] limbs of one shape")
    if any(c.device != p.x.device for c in p):
        raise ValueError("coordinates on different devices")
    if axis < 0:
        axis += len(shape)
    if not 0 < axis < len(shape):
        raise ValueError(f"axis {axis} is not a batch axis of {tuple(shape)}")
    return axis


def tree_plan(n: int, to: int) -> tuple[int, int]:
    """(lanes, fan_levels) of a group of n leaves reduced to `to` roots:
    the padded width to << k (k as small as covers n) is lanes <<
    fan_levels, where lanes = to << j is the widest such that fits
    TREE_LANES.  The block keeps `lanes` points and folds the first
    fan_levels levels while loading."""
    if not 1 <= to <= TREE_LANES:
        raise ValueError(f"to = {to} is not in [1, {TREE_LANES}]")
    width = to << (-(-n // to) - 1).bit_length()
    lanes = to << (min(width, TREE_LANES) // to).bit_length() - 1
    fan_levels = (width // lanes).bit_length() - 1
    if fan_levels > TREE_MAX_FAN_LEVELS:
        raise ValueError(f"{n} leaves to {to} roots need {fan_levels} fan-in levels, "
                         f"over {TREE_MAX_FAN_LEVELS}")
    return lanes, fan_levels


def g1_tree_reduce(trees) -> list:
    """Halving-tree reductions of independent point batches, one launch
    for all: for each (p, axis, to), `axis` is padded with identities to
    to << k lanes and lane i takes lane i + half at every level, the
    reference's pairing.  Each result is p's shape with the axis cut to
    `to` (p itself where the axis has at most `to` lanes)."""
    specs = [(p, _tree_spec(p, axis, to), to) for p, axis, to in trees]
    out = [p if p.x.shape[axis] <= to else None for p, axis, to in specs]
    todo = [i for i, r in enumerate(out) if r is None]
    if not todo:
        return out
    dev = specs[todo[0]][0].x.device
    if any(specs[i][0].x.device != dev for i in todo):
        raise ValueError("trees on different devices")
    if dev.type == "cpu":
        for i in todo:
            out[i] = g1_tree_reduce_plain(*specs[i])
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if len(todo) > TREE_MAX_TREES:
        raise ValueError(f"at most {TREE_MAX_TREES} trees a launch")
    desc, keep = [], []
    for i in todo:
        p, axis, to = specs[i]
        n = p.x.shape[axis]
        lanes, fan_levels = tree_plan(n, to)
        coords, groups0, groups1, strides = _tree_layout(p, axis)
        roots = _empty_like_coords(groups0 * groups1 * to, dev)
        keep.append((coords, roots))
        desc += [*map(_ptr, coords), *map(_ptr, roots), *strides, groups0, groups1, n, to,
                 lanes, fan_levels]
        batch = [s for d, s in enumerate(p.x.shape) if d not in (0, axis)]
        out[i] = G1Jac(*(c.reshape(FP_LIMBS, *batch, to).movedim(-1, axis) for c in roots))
    _launch("g1_tree_reduce", dev, len(todo), (ctypes.c_int64 * len(desc))(*desc),
            TREE_THREADS, _ptr(COUNTERS.collision_buffer("g1_tree_reduce", dev)))
    return out


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
        n = a[0].shape[1]
        out = _empty_like_coords(n, dev)
        _launch("g1_madd", dev, *map(_ptr, a + b), _ptr(inf), *map(_ptr, out), n,
                _ptr(COUNTERS.collision_buffer("g1_madd", dev)))
    else:
        raise ValueError(f"unsupported device {dev}")
    return G1Jac(*(c.reshape(shape) for c in out))


def g1_madd_ladder_plain(points: G1Aff, scalars, nbits: int) -> G1Jac:
    """Plain twin of K5's ladder: the stepwise canonical chain, from the
    identity, for bit i from nbits - 1 down to 0, one doubling (none on
    the first bit) and one complete mixed add of the point where bit i of
    its scalar is set."""
    acc = cv.jac_identity(points.x.shape[1:], points.x.device)
    for k, i in enumerate(reversed(range(nbits))):
        if k:
            acc = g1_dbl_plain(acc)
        bit = ((scalars[i // LIMB_BITS] >> (i % LIMB_BITS)) & 1).bool()
        acc = g1_madd_plain(acc, G1Aff(points.x, points.y, points.inf | ~bit))
    return acc


def g1_madd_ladder(points: G1Aff, scalars, nbits: int) -> G1Jac:
    """K5's ladder: scalars[i] * points[i] for every lane, by double-and-add
    over the low nbits bits, in one launch (limbs equal to
    g1_madd_ladder_plain's).  points: [24, *batch] affine with a bool
    infinity mask; scalars: int64 [FR_LIMBS, *batch], 16 bits a limb."""
    shape = points.x.shape
    if scalars.dtype != torch.int64 or scalars.shape != (FR_LIMBS, *shape[1:]):
        raise ValueError(f"scalars must be int64 [{FR_LIMBS}, *{tuple(shape[1:])}], got "
                         f"{scalars.dtype} {tuple(scalars.shape)}")
    if points.inf.dtype != torch.bool or points.inf.shape != shape[1:]:
        raise ValueError("points.inf must be a bool mask of the batch shape")
    if not 0 <= nbits <= FR_LIMBS * LIMB_BITS:
        raise ValueError(f"nbits = {nbits} is not in [0, {FR_LIMBS * LIMB_BITS}]")
    xy = _coords(points[:2])
    inf = points.inf.reshape(-1).contiguous()
    sc = scalars.reshape(FR_LIMBS, -1).contiguous()
    dev = xy[0].device
    if inf.device != dev or sc.device != dev:
        raise ValueError("operands on different devices")
    if dev.type == "cpu":
        out = g1_madd_ladder_plain(G1Aff(*xy, inf), sc, nbits)
    elif dev.type == "cuda":
        n = xy[0].shape[1]
        out = _empty_like_coords(n, dev)
        _launch("g1_madd_ladder", dev, *map(_ptr, xy), _ptr(inf), _ptr(sc), nbits,
                *map(_ptr, out), n, _ptr(COUNTERS.collision_buffer("g1_madd", dev)))
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
        n = a[0].shape[1]
        out = _empty_like_coords(n, dev)
        _launch("g1_dbl", dev, *map(_ptr, a + out), n, repeat)
    else:
        raise ValueError(f"unsupported device {dev}")
    return G1Jac(*(c.reshape(shape) for c in out))


# -- K4 horner_2k ---------------------------------------------------------------------

# K4 keeps at most H4_LANES points of a block in shared memory, a term's
# lanes rounded up to a power of two (also compiled into csrc/horner_2k.cu);
# its last block sums at most H4_LANES block partials.
H4_LANES = 256


def horner_plan(n_terms: int, width: int) -> tuple[int, int, int]:
    """(lanes a term takes, terms a block, blocks) of K4 for n_terms terms
    of `width` lanes."""
    if not 1 <= width <= H4_LANES:
        raise ValueError(f"width {width} is not in [1, {H4_LANES}]")
    rp = 1 << (width - 1).bit_length()
    tpb = H4_LANES // rp
    blocks = -(-n_terms // tpb)
    if blocks > H4_LANES:
        raise ValueError(f"{n_terms} terms of {width} lanes need {blocks} blocks, "
                         f"over {H4_LANES}")
    return rp, tpb, blocks


def _pair_tree(p: G1Jac) -> G1Jac:
    """Adjacent-pair tree over the last axis: at step s = 1, 2, 4, ...
    point 2js takes point 2js + s, a point with no partner passes; returns
    [..., 1]."""
    while p.x.shape[-1] > 1:
        n = p.x.shape[-1]
        s = cv.add(G1Jac(*(c[..., 0:n - 1:2] for c in p)), G1Jac(*(c[..., 1::2] for c in p)))
        p = s if n % 2 == 0 else G1Jac(*(torch.cat([a, c[..., n - 1:]], -1)
                                         for a, c in zip(s, p)))
    return p


def horner_weighted_terms(terms: G1Jac, width: int) -> G1Jac:
    """K4's first steps, plain: each term's `width` lanes folded by the
    halving tree (lane i takes lane i + half, identities past width), then
    folded term k doubled k times; returns [24, K]."""
    K = terms.x.shape[-1] // width
    folded = cv.halving_tree(G1Jac(*(c.reshape(FP_LIMBS, K, width) for c in terms)), -1, 1)
    v = [c[..., 0].clone() for c in folded]
    for s in range(1, K):
        for c, d in zip(v, cv.dbl(G1Jac(*(c[:, s:] for c in v)))):
            c[:, s:] = d
    return G1Jac(*v)


def horner_2k_plain(terms: G1Jac, width: int, block_terms: int | None = None) -> G1Jac:
    """Plain twin of K4, in its order: the weighted terms of
    horner_weighted_terms summed by the adjacent-pair tree; returns
    [24, 1].  With block_terms (a power of two, the kernel's terms a
    block), the terms are cut into runs of that many, each run summed to a
    partial that carries its 2^(first k) weight, and the partials summed
    by the same tree: the kernel's blocks, which continue the unsplit tree,
    so both give the same limbs."""
    v = horner_weighted_terms(terms, width)
    if block_terms is None:
        return _pair_tree(v)
    K = v.x.shape[-1]
    parts = [_pair_tree(G1Jac(*(c[:, k0:k0 + block_terms] for c in v)))
             for k0 in range(0, K, block_terms)]
    return _pair_tree(G1Jac(*(torch.cat(cs, -1) for cs in zip(*parts))))


def horner_2k(terms: G1Jac, width: int) -> G1Jac:
    """K4: the single point sum over k and r of 2^k * T_{k,r} for
    [24, K * width] terms (term k in columns [k * width, (k + 1) * width)),
    one launch; returns [24, 1]."""
    t = _coords(terms)
    n = t[0].shape[1]
    if width <= 0 or n == 0 or n % width:
        raise ValueError(f"{n} columns are not a positive multiple of width {width}")
    rp, tpb, blocks = horner_plan(n // width, width)
    dev = t[0].device
    if dev.type == "cpu":
        return horner_2k_plain(G1Jac(*t), width)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _empty_like_coords(1, dev)
    scratch = torch.empty(blocks * 3 * FP_LIMBS // 2 + 1, dtype=torch.int32, device=dev)
    _launch("horner_2k", dev, *map(_ptr, t), n // width, width, rp, tpb, _ptr(scratch),
            *map(_ptr, out), _ptr(COUNTERS.collision_buffer("horner_2k", dev)))
    return G1Jac(*out)


# -- fr_quotient ----------------------------------------------------------------------

def fr_quotient_plain(roots_mont, f_mont, alpha_mont, t_inv_mont):
    """Plain twin of fr_quotient, in Field's tensor ops: the batch
    inversion of ops/field.py (its chunk totals inverted on the host) and
    a halving tree of additions."""
    L, T = roots_mont.shape
    diffs = FR.sub(alpha_mont, roots_mont)
    any_zero = bool(FR.is_zero(diffs).any())
    invd = FR.batch_inv(diffs)
    alpha_t = FR.pow_const(alpha_mont, T)
    one = FR.broadcast_const("one_mont", (1,), roots_mont.device)
    factor = FR.mul(FR.sub(alpha_t, one), t_inv_mont)
    rows = (L,) + (1,) * (f_mont.ndim - 2)
    roots_b, invd_b = roots_mont.reshape(rows + (T,)), invd.reshape(rows + (T,))
    s = FR.mul(FR.mul(f_mont, roots_b), invd_b)
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = FR.add(s[..., :h], s[..., h:])
    y = FR.mul(factor.reshape(rows + (1,)), s)
    qhat = FR.mul(FR.sub(y, f_mont), invd_b)
    return y, qhat, any_zero


def fr_quotient(roots_mont, f_mont, alpha_mont, t_inv_mont):
    """(y_mont [16, ..., 1], qhat_mont [16, ..., T], any_zero) for Lagrange
    values f_j on the domain w^j and a point alpha, all canonical
    Montgomery limbs:

    y      = (alpha^T - 1)/T * sum_j f_j w^j / (alpha - w^j)
    q(w^j) = (y - f_j) / (alpha - w^j)

    roots [16, T], alpha and t_inv 16 limbs of one element; f [16, T] is
    one row, [16, ..., T] a batch of rows sharing the one inversion of
    alpha - w^j.  A lane where alpha - w^j = 0 takes 0 as its inverse and
    sets any_zero (a Python bool, read once after the launches).  On a card
    four launches and that one read; on the CPU the plain twin."""
    if roots_mont.dtype != torch.int64 or roots_mont.ndim != 2 or roots_mont.shape[0] != FR_LIMBS:
        raise ValueError(f"roots must be int64 [{FR_LIMBS}, T] limbs")
    T = roots_mont.shape[1]
    if T == 0 or f_mont.dtype != torch.int64 or f_mont.ndim < 2 \
            or f_mont.shape[0] != FR_LIMBS or f_mont.shape[-1] != T:
        raise ValueError(f"f must be int64 [{FR_LIMBS}, ..., {T}] limbs, got "
                         f"{f_mont.dtype} {tuple(f_mont.shape)}")
    for name, t in (("alpha", alpha_mont), ("t_inv", t_inv_mont)):
        if t.dtype != torch.int64 or t.shape[0] != FR_LIMBS or t.numel() != FR_LIMBS:
            raise ValueError(f"{name} must be int64 limbs of one element")
    dev = roots_mont.device
    if any(t.device != dev for t in (f_mont, alpha_mont, t_inv_mont)):
        raise ValueError("operands on different devices")
    if dev.type == "cpu":
        return fr_quotient_plain(roots_mont, f_mont, alpha_mont, t_inv_mont)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    batch = tuple(f_mont.shape[1:-1])
    B = f_mont[0, ..., 0].numel()
    roots = roots_mont.contiguous()
    f = f_mont.reshape(FR_LIMBS, B, T).contiguous()
    alpha = alpha_mont.reshape(FR_LIMBS, 1).contiguous()
    t_inv = t_inv_mont.reshape(FR_LIMBS, 1).contiguous()
    blocks = build().fk_fr_quotient_blocks(T)      # the block shape is the kernel's
    words = FR_LIMBS // 2
    # 1/d_j (rows 0-7) and w^j/d_j (rows 8-15) as 32-bit words a lane; a
    # partial sum a row and block; the blocks' flags, then any_zero
    scratch = torch.empty((2 * words, T), dtype=torch.int32, device=dev)
    partials = torch.empty((words, B * blocks), dtype=torch.int32, device=dev)
    flags = torch.empty(blocks + 1, dtype=torch.int32, device=dev)
    y = torch.empty((FR_LIMBS, B), dtype=torch.int64, device=dev)
    qhat = torch.empty((FR_LIMBS, B, T), dtype=torch.int64, device=dev)
    inv, wi = scratch[:words], scratch[words:]
    _launch("fr_quotient_inv", dev, _ptr(roots), _ptr(alpha), T, _ptr(inv), _ptr(wi),
            _ptr(flags))
    _launch("fr_quotient_sum", dev, _ptr(f), _ptr(wi), T, B, _ptr(partials))
    _launch("fr_quotient_eval", dev, _ptr(alpha), _ptr(t_inv), _ptr(partials), _ptr(flags), T,
            B, _ptr(y), _ptr(flags[blocks:]))
    _launch("fr_quotient_qhat", dev, _ptr(f), _ptr(inv), _ptr(y), T, B, _ptr(qhat))
    any_zero = bool(flags[blocks].item())
    return (y.reshape((FR_LIMBS,) + batch + (1,)), qhat.reshape((FR_LIMBS,) + batch + (T,)),
            any_zero)
