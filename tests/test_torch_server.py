"""The port's JSON-RPC server against the JAX package's, over sockets.

Both servers run in-process on localhost ports, each over a backend
built from the same fixed secrets at scale 4 / machines 1.  The 11
methods are driven over HTTP: deterministic answers (and error
envelopes) must be byte-identical; randomPoly and randomPoint are
checked for shape and canonicality.
"""

import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import pytest
import torch

from fourier_tpu.constants import FR_LIMBS, R
from fourier_tpu.models import piano as jpiano
from fourier_tpu.ops.limbs import bytes_be_to_limbs
from fourier_tpu.refimpl.field import fr_to_bytes
from fourier_tpu.runtime import server as jserver
from fourier_tpu.runtime import wire
from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.runtime import server as tserver

torch.set_num_threads(1)

SECRETS = (b"\x05" * 32, b"\x06" * 32)
SCALE, MACHINES_SCALE = 4, 1


def _serve(module, backend):
    handler = type("H", (module._HTTPHandler,), {"rpc": module.RpcHandler(backend)})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def _jax_backend():
    jfft = jpiano.PianoFFTSettings(SCALE, MACHINES_SCALE)
    return jpiano.PianoBackend(jfft, jpiano.generate_trusted_setup(jfft, SECRETS))


def _port_backend():
    tfft = tpiano.PianoFFTSettings(SCALE, MACHINES_SCALE, "cpu")
    tsettings = tpiano.generate_trusted_setup(tfft, SECRETS)
    tsettings.precompute = tpiano.PianoPrecompute.generate(tsettings)
    return tpiano.PianoBackend(tfft, tsettings)


@pytest.fixture(scope="module")
def urls():
    with ThreadPoolExecutor(2) as pool:           # the two setups side by side
        jax_future = pool.submit(_jax_backend)
        tbackend = _port_backend()
        jbackend = jax_future.result()
    servers = [_serve(jserver, jbackend), _serve(tserver, tbackend)]
    yield [f"http://127.0.0.1:{h.server_address[1]}/" for h, _ in servers]
    for httpd, thread in servers:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)
        assert not thread.is_alive()


def _post(url, body: bytes) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.read()


def _both(urls, method, params=None):
    """(JAX answer, port answer) as raw bytes, both servers asked at once;
    asserts they are equal."""
    body = wire.serialize_request(method, params).encode()
    with ThreadPoolExecutor(len(urls)) as pool:
        ref, got = pool.map(lambda u: _post(u, body), urls)
    assert got == ref, method
    return json.loads(got)


def _fr(v):
    return wire.b64_encode(fr_to_bytes(v % R))


def _canonical(s):
    raw = wire.b64_decode(s)
    return len(raw) == 32 and int.from_bytes(raw, "big") < R


def test_random_methods_shape_and_canonicality(urls):
    port = urls[1]
    poly = json.loads(_post(port, wire.serialize_request("randomPoly").encode()))["poly"]
    assert len(poly) == 1 << MACHINES_SCALE
    assert all(len(row) == 1 << (SCALE - MACHINES_SCALE) for row in poly)
    assert all(_canonical(s) for row in poly for s in row)
    point = json.loads(_post(port, wire.serialize_request("randomPoint").encode()))["point"]
    assert _canonical(point)
    assert json.loads(_post(port, wire.serialize_request("ping").encode())) is None


def test_deterministic_methods_match_jax_server(urls):
    assert _both(urls, "ping") is None
    rows = [[_fr(7 * i + 3 * j + 1) for j in range(8)] for i in range(2)]
    alpha, beta = _fr(0x1234567), _fr(0x89ABCDE)
    _both(urls, "evaluate", {"poly": rows[0], "x": alpha})
    for left in (True, False):
        for inverse in (True, False):
            _both(urls, "fft", {"poly": rows[0][: 8 if left else 2], "left": left,
                                "inverse": inverse})
    coms, evals, proofs = [], [], []
    for i, row in enumerate(rows):
        coeffs = _both(urls, "fft", {"poly": row, "left": True, "inverse": True})["poly"]
        com = _both(urls, "workerCommit", {"i": i, "poly": coeffs})["commitment"]
        opened = _both(urls, "workerOpen", {"i": i, "poly": coeffs, "x": alpha})
        verdict = _both(urls, "workerVerify", {"i": i, "alpha": alpha, "proof": opened["proof"],
                                               "eval": opened["eval"], "commitment": com})
        assert verdict == {"valid": True}
        coms.append(com)
        evals.append(opened["eval"])
        proofs.append(opened["proof"])
    wrong = _both(urls, "workerVerify", {"i": 0, "alpha": alpha, "proof": proofs[0],
                                         "eval": evals[1], "commitment": coms[0]})
    assert wrong == {"valid": False}
    mc = _both(urls, "masterCommit", {"commitments": coms})["commitment"]
    mo = _both(urls, "masterOpen", {"evals": evals, "proofs": proofs, "beta": beta})
    verdict = _both(urls, "masterVerify", {"commitment": mc, "beta": beta, "alpha": alpha,
                                           "z": mo["z"], "pi_0": mo["pi_0"], "pi_1": mo["pi_1"]})
    assert verdict == {"valid": True}


def test_canonicality_check_without_native_decoder():
    """The numpy check that replaces the native decoder's range check."""
    vals = [0, 1, R - 2, R - 1, R, R + 1, R + (1 << 200), (1 << 256) - 1, R - (1 << 128)]
    raw = b"".join(v.to_bytes(32, "big") for v in vals)
    limbs = bytes_be_to_limbs(raw, 32, FR_LIMBS)
    assert tserver._geq_r(limbs).tolist() == [v >= R for v in vals]


def test_error_envelopes_match_jax_server(urls):
    big = wire.b64_encode(R.to_bytes(32, "big"))          # == r: not canonical
    for method, params in [
        ("workerCommit", {"i": 0, "poly": [big]}),
        ("workerCommit", {"i": 5, "poly": [_fr(1)]}),
        ("workerCommit", {"i": "0", "poly": [_fr(1)]}),
        ("workerCommit", {"i": 0, "poly": [_fr(1)] * 9}),
        ("fft", {"poly": [_fr(1)], "left": 1, "inverse": False}),
    ]:
        out = _both(urls, method, params)
        assert set(out) == {"message"}, method
    for raw in (b'{"method":"prove","params":{}}', b"not json"):
        ref, got = (_post(u, raw) for u in urls)
        assert got == ref and set(json.loads(got)) == {"message"}
