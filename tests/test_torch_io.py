"""fourier_tpu_torch.runtime.io against fourier_tpu.runtime.io.

At scale 4 / machines 1 with the pinned fixture's secrets, on the CPU:
the port's setup file hashes to the fixture's pinned sha256 in both
encodings, and `setup --decompress-existing` / `--compress-existing` turn
one into the other; setup files cross between the packages with equal
points; an FTPC precompute file written by the port loads in the JAX
package with equal arrays, and one written by the JAX package (with a
tau_Y table, which the port skips, and a row without a table, which
serves tableless) loads in the port and commits to the fixture's bytes;
the legacy .npz container still loads; the point decoder refuses each bad
encoding the JAX package's refuses, with the same message; and one
`setup` -> load round trip goes through the CLI in a subprocess.
Comparisons are exact (bytes and limbs).
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fourier_tpu.models import piano as jpiano
from fourier_tpu.ops import curve as jcv
from fourier_tpu.ops import serialize as jser
from fourier_tpu.runtime import io as jrio
from fourier_tpu_torch.constants import P
from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.ops import curve as tcv
from fourier_tpu_torch.ops import serialize as ser
from fourier_tpu_torch.refimpl.curve import G1_GEN, g1_mul, g1_serialize, g1_to_bytes
from fourier_tpu_torch.runtime import cli
from fourier_tpu_torch.runtime import io as trio
from fourier_tpu_torch.runtime import wire

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "protocol_transcript_s4_m1.json")


@pytest.fixture(scope="module")
def fx():
    with open(FIXTURE) as fh:
        return json.load(fh)


def _secrets(fx):
    return tuple(bytes.fromhex(h) for h in fx["secrets_hex"])


@pytest.fixture(scope="module")
def port_settings(fx):
    fft = tpiano.PianoFFTSettings(fx["scale"], fx["machines_scale"], "cpu")
    settings = tpiano.generate_trusted_setup(fft, _secrets(fx))
    settings.precompute = tpiano.PianoPrecompute.generate(settings)
    return settings


def _sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _port_points(aff):
    return tcv.jac_to_int_points(tcv.from_affine(aff))


def _jax_points(aff):
    return jcv.jac_to_int_points(jcv.from_affine(aff))


def _com(backend, i, row):
    return wire.b64_encode(g1_to_bytes(backend.worker_commit(i, row)))


@pytest.mark.parametrize("compressed", [True, False])
def test_setup_file_matches_pinned_hash(fx, port_settings, compressed, tmp_path):
    path = tmp_path / "setup"
    trio.save_setup(port_settings, str(path), compressed)
    assert _sha256(path) == fx["setup_sha256_" + ("c" if compressed else "u")]


def test_cli_converts_setup_encoding(fx, port_settings, tmp_path):
    path = str(tmp_path / "setup")
    trio.save_setup(port_settings, path, compressed=True)
    common = ["setup", "--setup-path", path, "--precompute-path", str(tmp_path / "pre"),
              "--device", "cpu"]
    assert cli.main(common + ["--decompress-existing"]) == 0
    assert _sha256(path) == fx["setup_sha256_u"]
    assert cli.main(common + ["--compress-existing", "--uncompressed"]) == 0
    assert _sha256(path) == fx["setup_sha256_c"]


def test_setup_files_cross_between_packages(fx, port_settings, tmp_path):
    jfft = jpiano.PianoFFTSettings(fx["scale"], fx["machines_scale"])
    jsettings = jpiano.generate_trusted_setup(jfft, _secrets(fx))
    jrio.save_setup(jsettings, str(tmp_path / "jax"), compressed=True)
    trio.save_setup(port_settings, str(tmp_path / "port"), compressed=True)
    from_jax = trio.load_setup(str(tmp_path / "jax"), True, "cpu")
    from_port = jrio.load_setup(str(tmp_path / "port"), True)
    for name in ("g_tau_x", "g_tau_y", "u"):
        want = _port_points(getattr(port_settings, name))
        assert _port_points(getattr(from_jax, name)) == want
        assert _jax_points(getattr(from_port, name)) == want
        assert _jax_points(getattr(jsettings, name)) == want
    for name in ("g", "g2", "g2_tau_x", "g2_tau_y", "g_tau_y_host"):
        assert getattr(from_jax, name) == getattr(port_settings, name) \
            == getattr(from_port, name)


def test_port_precompute_loads_in_jax(port_settings, tmp_path):
    path = str(tmp_path / "pre")
    trio.save_precompute(port_settings.precompute, path)
    loaded = jrio.load_precompute(path)
    assert loaded.c == port_settings.precompute.c
    assert loaded.g1_tau_y is None
    assert len(loaded.u_rows) == len(port_settings.precompute.u_rows)
    for got, want in zip(loaded.u_rows, port_settings.precompute.u_rows):
        for a, b in zip(got, want):
            assert np.asarray(a).dtype in (np.uint32, np.bool_)
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                          b.numpy().astype(np.int64))


def test_jax_precompute_loads_in_port_and_commits(fx, port_settings, tmp_path):
    """The JAX writer over numpy arrays: row 0's table, a tau_Y table the
    port skips, and no table for row 1 (it serves tableless)."""
    def arrays(t):
        return jcv.G1Aff(t.x.numpy().astype(np.uint32), t.y.numpy().astype(np.uint32),
                         t.inf.numpy())

    row0 = port_settings.precompute.u_rows[0]
    pre = jpiano.PianoPrecompute(c=port_settings.precompute.c, g1_tau_y=arrays(row0),
                                 u_rows=[arrays(row0), None])
    path = str(tmp_path / "pre")
    jrio.save_precompute(pre, path)
    loaded = trio.load_precompute(path, "cpu")
    assert loaded.c == pre.c and loaded.u_rows[1] is None
    for a, b in zip(loaded.u_rows[0], row0):
        assert torch.equal(a, b)
    settings = tpiano.PianoSettings(**{k: getattr(port_settings, k) for k in (
        "g", "g_tau_x", "g_tau_y", "u", "g2", "g2_tau_x", "g2_tau_y", "g_tau_y_host")},
        precompute=loaded)
    backend = tpiano.PianoBackend(tpiano.PianoFFTSettings(fx["scale"], fx["machines_scale"],
                                                          "cpu"), settings)
    assert [_com(backend, i, row) for i, row in enumerate(fx["rows"])] == fx["commitments"]


def test_legacy_npz_precompute_loads_in_port(port_settings, tmp_path):
    """The .npz container of canonical limbs still loads, to Montgomery."""
    pc = port_settings.precompute
    row = pc.u_rows[0]
    path = str(tmp_path / "pre.npz")
    np.savez(path, c=np.array([pc.c]), n_rows=np.array([2]),
             u0_x=ser.from_mont_np(row.x), u0_y=ser.from_mont_np(row.y),
             u0_inf=row.inf.numpy())
    loaded = trio.load_precompute(path, "cpu")
    assert loaded.c == pc.c and loaded.u_rows[1] is None
    for a, b in zip(loaded.u_rows[0], row):
        assert torch.equal(a, b)


def _bad_encoding(compressed, case):
    """A good point's encoding followed by one the decoder must refuse."""
    good = g1_mul(G1_GEN, 7)
    enc = g1_to_bytes if compressed else g1_serialize
    size = 48 if compressed else 96
    flag = 0x80 if compressed else 0
    bad = bytearray(enc(g1_mul(G1_GEN, 11)))
    if case == "flag bit":
        bad[0] ^= 0x80                                  # compressed bit off / on
    elif case == "sign bit":
        bad[0] |= 0x20
    elif case == "infinity with sign":
        bad = bytearray([flag | 0x60]) + bytes(size - 1)
    elif case == "infinity with body":
        bad = bytearray([flag | 0x40]) + bytes(size - 2) + b"\x01"
    elif case == "x = p":
        bad[:48] = P.to_bytes(48, "big")
        bad[0] |= flag
    elif case == "y = y + p":
        y = int.from_bytes(bad[48:], "big")
        bad[48:] = (y + P).to_bytes(48, "big")
    elif case == "off the curve":
        if compressed:           # an x whose x^3 + 4 has no square root
            x = next(x for x in range(1, 100) if pow(x ** 3 + 4, (P - 1) // 2, P) == P - 1)
            bad[:48] = x.to_bytes(48, "big")
            bad[0] |= flag
        else:
            y = int.from_bytes(bad[48:], "big")
            bad[48:] = ((y + 1) % P).to_bytes(48, "big")
    return enc(good) + bytes(bad)


@pytest.mark.parametrize("compressed,case,message", [
    (True, "flag bit", "compressed bit not set"),
    (True, "infinity with sign", "malformed infinity encoding"),
    (True, "infinity with body", "malformed infinity encoding"),
    (True, "x = p", "x is not canonical"),
    (True, "off the curve", "x is not on the curve"),
    (False, "flag bit", "compressed bit set on uncompressed encoding"),
    (False, "sign bit", "sign bit set on uncompressed encoding"),
    (False, "infinity with body", "malformed infinity encoding"),
    (False, "y = y + p", "coordinate is not canonical"),
    (False, "off the curve", "point is not on the curve"),
])
def test_decode_refuses_bad_points_like_jax(compressed, case, message):
    data = _bad_encoding(compressed, case)
    with pytest.raises(ValueError, match=message):
        jser.g1_decode_batch(data, compressed)
    with pytest.raises(ValueError, match=message):
        ser.g1_decode_batch(data, compressed, "cpu")
    good = ser.g1_decode_batch(data[:len(data) // 2], compressed, "cpu")
    assert _port_points(good) == [g1_mul(G1_GEN, 7)]


def test_cli_setup_then_load_round_trip(fx, tmp_path):
    setup_path, pre_path = str(tmp_path / "setup"), str(tmp_path / "pre")
    out = subprocess.run(
        [sys.executable, "-m", "fourier_tpu_torch", "setup", "--scale", "4",
         "--machines-scale", "1", "--setup-path", setup_path, "--precompute-path", pre_path,
         "--generate-setup", "--generate-precompute", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    cfg = tpiano.SetupConfig(scale=4, machines_scale=1, setup_path=setup_path,
                             precompute_path=pre_path, generate_setup=False,
                             generate_precompute=False)
    loaded = tpiano.PianoBackend.setup(cfg, "cpu")
    regenerated = tpiano.PianoBackend.setup(
        tpiano.SetupConfig(scale=4, machines_scale=1, setup_path=setup_path,
                           generate_setup=False), "cpu")
    row = fx["rows"][1]
    com = loaded.worker_commit(1, row)
    assert g1_to_bytes(com) == g1_to_bytes(regenerated.worker_commit(1, row))
    y, pi = loaded.worker_open(1, row, fx["alpha"])
    assert loaded.worker_verify(1, com, fx["alpha"], y, pi)
