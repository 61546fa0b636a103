"""The multi-card server's MSM split (a worker's MSM over the in-process
shards of parallel/mesh.py) against the JAX package, on the CPU.

At the sweep's case (8, 1) (T = 128 points a row, c = 8 tables; the JAX
programs come from tests/test_piano.py's compile cache):

- a port backend carried across from the JAX backend's setup
  (convert.backend_from_arrays) with msm_devices of 2 and of 4 "cpu"
  entries gives the JAX backend's transcript byte for byte;
- with its tables dropped it takes the tableless sharded branch and
  commits like the one-device port backend;
- over HTTP, a server over 2 shards answers workerCommit and workerOpen
  with the in-process one-device backend's bytes;
- the table window for four shards (c = 13 at 2^19 points) and for one
  equals the JAX package's; FOURIER_SHARD_MSM=0, a list of one device and
  the CPU default give the one-device branch; 3 shards refuse at start;
- --msm-devices parses.

Comparisons are exact: the arithmetic is integer.
"""

import functools
import json
import random
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from fourier_tpu.models import piano as jpiano
from fourier_tpu.ops import msm_fused as jmf
from fourier_tpu.refimpl.curve import g1_to_bytes
from fourier_tpu.refimpl.field import fr_to_bytes
from fourier_tpu_torch.constants import R
from fourier_tpu_torch.convert import backend_from_arrays
from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.parallel.msm_fused_sharded import ShardSplitError
from fourier_tpu_torch.runtime import cli, wire
from fourier_tpu_torch.runtime import server as tserver

import torch_sweep as sw

CASE = (8, 1)


@functools.lru_cache(maxsize=None)
def _round():
    """(rows, alpha, beta, the JAX backend's transcript bytes) at CASE."""
    jb, tb = sw.sides(*CASE)
    rng = random.Random(0x5D)
    rows = sw.random_rows(tb.fft, rng)
    alpha, beta = rng.randrange(R), rng.randrange(R)
    return rows, alpha, beta, sw.transcript(jb, rows, alpha, beta)[1]


@functools.lru_cache(maxsize=None)
def _sharded(n_shards: int):
    jb, _ = sw.sides(*CASE)
    return backend_from_arrays(jb, "cpu", ["cpu"] * n_shards)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_backend_matches_jax(n_shards):
    b = _sharded(n_shards)
    assert b.mesh.size == n_shards
    rows, alpha, beta, want = _round()
    assert sw.transcript(b, rows, alpha, beta)[1] == want


def test_tableless_sharded_branch(monkeypatch):
    jb, tb = sw.sides(*CASE)
    b = backend_from_arrays(jb, "cpu", ["cpu"] * 2)
    b.settings.precompute = None                         # every row tableless
    calls = []
    real = tpiano.msm_fused_sharded

    def recorded(points, scalars, c, group):
        calls.append((points.x.shape[-1], c, group.size))
        return real(points, scalars, c, group)

    monkeypatch.setattr(tpiano, "msm_fused_sharded", recorded)
    row = _round()[0][1]
    assert b.worker_commit(1, row) == tb.worker_commit(1, row)
    # both shards, the whole row of T = 128 points, the window of 64
    assert calls == [(128, 6, 2)] * 2


def test_server_over_two_shards_answers_like_one_device():
    _, tb = sw.sides(*CASE)
    b = _sharded(2)
    handler = type("H", (tserver._HTTPHandler,), {"rpc": tserver.RpcHandler(b)})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    rows, alpha, _, _ = _round()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/"

    def rpc(method, params):
        req = urllib.request.Request(url, data=wire.serialize_request(method, params).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    try:
        poly = [wire.b64_encode(fr_to_bytes(v)) for v in rows[0]]
        x = wire.b64_encode(fr_to_bytes(alpha))
        got_com = rpc("workerCommit", {"i": 0, "poly": poly})
        got_open = rpc("workerOpen", {"i": 0, "poly": poly, "x": x})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10)
    assert not thread.is_alive()
    y, proof = tb.worker_open(0, rows[0], alpha)
    assert got_com == {"commitment": wire.b64_encode(g1_to_bytes(tb.worker_commit(0, rows[0])))}
    assert got_open == {"proof": wire.b64_encode(g1_to_bytes(proof)),
                        "eval": wire.b64_encode(fr_to_bytes(y))}


def test_window_for_matches_jax():
    assert tpiano.PianoPrecompute.window_for(1 << 19, shards=4) == 13
    assert jmf.bgmw_auto_window(1 << 19, shards=4) == 13
    for n in (1 << 7, 1 << 12, 1 << 19):
        # the JAX package's window_for takes the shards of its local mesh
        # (the suite's 8 virtual CPU devices): the one-device cost model
        assert tpiano.PianoPrecompute.window_for(n) == jpiano.PianoPrecompute.window_for(n)
        assert tpiano.PianoPrecompute.window_for(n, 4) == \
            (8 if n < 1 << 12 else jmf.bgmw_auto_window(n, shards=4))


def test_one_device_branch(monkeypatch):
    jb, tb = sw.sides(*CASE)
    settings = tb.settings
    assert tb.mesh is None and tb.msm_devices == [tb.device]              # CPU default
    assert tpiano.PianoBackend(tb.fft, settings, "cpu", ["cpu"]).mesh is None
    monkeypatch.setenv("FOURIER_SHARD_MSM", "0")
    assert tpiano.PianoBackend(tb.fft, settings, "cpu", ["cpu"] * 4).mesh is None
    monkeypatch.delenv("FOURIER_SHARD_MSM")
    with pytest.raises(ShardSplitError, match="3 ranks do not divide the 256 buckets"):
        tpiano.PianoBackend(tb.fft, settings, "cpu", ["cpu"] * 3)


def test_msm_devices_flag():
    parser = cli.build_parser()
    assert parser.parse_args(["run"]).msm_devices is None
    assert parser.parse_args(["run", "--msm-devices", "cpu, cpu"]).msm_devices == ["cpu", "cpu"]
    assert parser.parse_args(["setup", "--msm-devices", "cuda:0,cuda:1,cuda:0"]).msm_devices \
        == ["cuda:0", "cuda:1", "cuda:0"]
    with pytest.raises(SystemExit):
        parser.parse_args(["run", "--msm-devices", "cpu,gpu7"])
