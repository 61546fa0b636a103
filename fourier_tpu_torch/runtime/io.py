"""Setup and precompute files.

Port of ``fourier_tpu.runtime.io``; a file written by either package loads
in the other.

The **setup file** is byte-compatible with the reference
(PianoSettings::save_setup_to_file / load_setup_from_file, reference
src/engine/piano.rs:649-846) and with the JAX package:

    g                                 48B compressed | 96B uncompressed G1
    u64-LE len, g_tau_x[len]          G1 array
    u64-LE len, g_tau_y[len]          G1 array
    u64-LE rows, u64-LE cols, U[r][c] G1 matrix, row-major
    g2, g2_tau_x, g2_tau_y            96B | 192B G2 each

The file carries no compression marker; the caller must know.

The **precompute file** is the JAX package's "FTPC" container: the magic,
a u64-LE header length, a JSON header ({"c", "n_rows", "arrays"}), then
each array's raw bytes at a 4096-aligned offset.  The arrays are the BGMW
row tables as Montgomery uint32 [24, W*T] limb arrays (``u{k}_x``,
``u{k}_y``) and a bool [W*T] infinity mask (``u{k}_inf``).  The two
packages' Montgomery values are equal (same radix), so the limbs cross
without conversion.  The port writes no tau_Y table (``gy_*``: it builds
none) and skips one when loading; a row without arrays loads as None and
serves tableless.  The legacy ``.npz`` format (canonical limbs in a zip)
is still read.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..ops import curve as cv
from ..ops import serialize as ser
from ..ops.curve import G1Aff
from ..refimpl import curve as rc


def _g1_single_bytes(pt, compressed: bool) -> bytes:
    return rc.g1_to_bytes(pt) if compressed else rc.g1_serialize(pt)


def _g2_single_bytes(pt, compressed: bool) -> bytes:
    return rc.g2_to_bytes(pt) if compressed else rc.g2_serialize(pt)


def save_setup(settings, path: str, compressed: bool) -> None:
    with open(path, "wb") as f:
        f.write(_g1_single_bytes(settings.g, compressed))

        for aff in (settings.g_tau_x, settings.g_tau_y):
            f.write(struct.pack("<Q", aff.x.shape[-1]))
            f.write(ser.g1_encode_batch(aff, compressed))
        L, m, t = settings.u.x.shape
        f.write(struct.pack("<QQ", m, t))
        f.write(ser.g1_encode_batch(
            G1Aff(settings.u.x.reshape(L, m * t), settings.u.y.reshape(L, m * t),
                  settings.u.inf.reshape(m * t)), compressed))
        for pt in (settings.g2, settings.g2_tau_x, settings.g2_tau_y):
            f.write(_g2_single_bytes(pt, compressed))


def load_setup(path: str, compressed: bool, device="cuda"):
    """The settings of a setup file, point batches on `device`."""
    from ..models.piano import PianoSettings

    g1_size = 48 if compressed else 96
    g2_size = 96 if compressed else 192
    g1_parse = rc.g1_from_bytes if compressed else rc.g1_deserialize
    g2_parse = rc.g2_from_bytes if compressed else rc.g2_deserialize

    with open(path, "rb") as f:
        g = g1_parse(f.read(g1_size))

        def read_array(n: int) -> G1Aff:
            return ser.g1_decode_batch(f.read(n * g1_size), compressed, device)

        (n_x,) = struct.unpack("<Q", f.read(8))
        g_tau_x = read_array(n_x)
        (n_y,) = struct.unpack("<Q", f.read(8))
        g_tau_y = read_array(n_y)
        rows, cols = struct.unpack("<QQ", f.read(16))
        u_flat = read_array(rows * cols)
        L = u_flat.x.shape[0]
        u = G1Aff(u_flat.x.reshape(L, rows, cols), u_flat.y.reshape(L, rows, cols),
                  u_flat.inf.reshape(rows, cols))
        g2, g2_tau_x, g2_tau_y = (g2_parse(f.read(g2_size)) for _ in range(3))

    return PianoSettings(g=g, g_tau_x=g_tau_x, g_tau_y=g_tau_y, u=u, g2=g2,
                         g2_tau_x=g2_tau_x, g2_tau_y=g2_tau_y,
                         g_tau_y_host=cv.jac_to_int_points(cv.from_affine(g_tau_y)))


# -- precompute: the FTPC container ----------------------------------------------

_FTPC_MAGIC = b"FTPC0001"
_FTPC_ALIGN = 4096


def _aligned(n: int) -> int:
    return (n + _FTPC_ALIGN - 1) // _FTPC_ALIGN * _FTPC_ALIGN


def _write_array(f, t: torch.Tensor) -> None:
    """A bool mask as bytes; an int64 [L, n] limb tensor as uint32 [L, n],
    one limb row at a time (every limb is below 2^16, so int32 carries it
    unchanged)."""
    if t.dtype == torch.bool:
        f.write(t.cpu().numpy().tobytes())
        return
    for row in t:
        f.write(row.to(torch.int32).cpu().numpy().tobytes())


def save_precompute(pc, path: str) -> None:
    """The U row tables of `pc` (None: no rows) as an FTPC file."""
    rows = [] if pc is None else pc.u_rows
    arrays = [(f"u{k}_{name}", t) for k, row in enumerate(rows) if row is not None
              for name, t in (("x", row.x), ("y", row.y), ("inf", row.inf))]
    meta, offset = [], 0
    for key, t in arrays:
        mask = t.dtype == torch.bool
        nbytes = t.numel() * (1 if mask else 4)
        meta.append({"key": key, "dtype": "bool" if mask else "uint32",
                     "shape": list(t.shape), "offset": offset, "nbytes": nbytes})
        offset += _aligned(nbytes)
    header = json.dumps({"c": int(pc.c) if pc else 0, "n_rows": len(rows),
                         "arrays": meta}).encode()
    data_start = _aligned(len(_FTPC_MAGIC) + 8 + len(header))
    with open(path, "wb") as f:
        f.write(_FTPC_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for m, (_, t) in zip(meta, arrays):
            f.seek(data_start + m["offset"])
            _write_array(f, t)


def _array_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A mapped uint32 limb array or bool mask -> an int64 or bool tensor
    on `device`, copied a limb row at a time."""
    if a.dtype == np.bool_:
        return torch.from_numpy(np.array(a)).to(device)
    out = torch.empty(a.shape, dtype=torch.int64, device=device)
    for j in range(a.shape[0]):
        out[j].copy_(torch.from_numpy(np.array(a[j]).view(np.int32)))
    return out


def load_precompute(path: str, device="cuda"):
    """The row tables of a precompute file (FTPC, or the legacy .npz), on
    `device`.  A backend whose MSM splits over several shards places each
    row's slices on them (PianoBackend), whatever c the file was written
    at, where the shard count splits its buckets."""
    from ..models.piano import PianoPrecompute

    with open(path, "rb") as f:
        magic = f.read(len(_FTPC_MAGIC))
    if magic != _FTPC_MAGIC:
        return _load_precompute_npz(path, device)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    hstart = len(_FTPC_MAGIC) + 8
    (hlen,) = struct.unpack("<Q", mm[len(_FTPC_MAGIC):hstart].tobytes())
    header = json.loads(mm[hstart:hstart + hlen].tobytes())
    data_start = _aligned(hstart + hlen)
    by_key = {m["key"]: m for m in header["arrays"]}

    def arr(key):
        m = by_key[key]
        start = data_start + m["offset"]
        view = np.frombuffer(mm[start:start + m["nbytes"]], dtype=np.dtype(m["dtype"]))
        return _array_to_device(view.reshape(m["shape"]), device)

    u_rows = []
    for k in range(header["n_rows"]):
        if f"u{k}_x" in by_key:
            u_rows.append(G1Aff(arr(f"u{k}_x"), arr(f"u{k}_y"), arr(f"u{k}_inf")))
        else:
            u_rows.append(None)
    return PianoPrecompute(c=header["c"], u_rows=u_rows)


def _load_precompute_npz(path: str, device):
    """The legacy .npz precompute file: canonical coordinate limbs in a zip
    container, converted to Montgomery form on `device`."""
    from ..models.piano import PianoPrecompute

    with np.load(path) as z:
        n_rows = int(z["n_rows"][0]) if "n_rows" in z else 0
        u_rows = []
        for k in range(n_rows):
            if f"u{k}_x" in z:
                u_rows.append(G1Aff(ser.to_mont(z[f"u{k}_x"], device),
                                    ser.to_mont(z[f"u{k}_y"], device),
                                    torch.as_tensor(z[f"u{k}_inf"], device=device)))
            else:
                u_rows.append(None)
        return PianoPrecompute(c=int(z["c"][0]), u_rows=u_rows)
