"""fourier_tpu_torch.runtime.client against fourier_tpu.runtime.client.

- The port's client builds the same request bodies as the JAX client for
  the same inputs, method by method, and the same server command line,
  with its own module and the device option added.
- The port's test_routine spawns the port's server (`python -m
  fourier_tpu_torch run --device cpu`) at scale 6 / machines_scale 2 and
  drives the whole distributed round over HTTP: every worker proof and
  the master proof must verify (it raises on a rejected one), as
  tests/test_client_e2e.py does for the JAX package.
"""

import socket
import sys

import pytest
import requests

from fourier_tpu.runtime import client as jclient
from fourier_tpu_torch.runtime import client as tclient

POLY = ["AAAA", "AAAB"]
G1 = "wAAAAA=="


def _calls(client):
    """Every RPC method of `client` once, with fixed arguments."""
    client.ping()
    client.random_poly()
    client.random_point()
    client.eval(POLY, "x1")
    client.fft(POLY, left=True, inverse=False)
    client.fft(POLY, left=False, inverse=True)
    client.worker_commit(3, POLY)
    client.worker_open(1, POLY, "x2")
    client.worker_verify(2, G1, "a", "e", G1)
    client.master_commit([G1, G1])
    client.master_open(["e0", "e1"], [G1, G1], "b")
    client.master_verify(G1, "b", "a", "z", G1, G1)
    client.post("evaluate", {"poly": [], "x": "0"})


def test_request_bodies_match_jax(monkeypatch):
    sent = []

    def fake_post(url, data=None, **kw):
        sent.append((url, data))
        return None

    monkeypatch.setattr(requests, "post", fake_post)
    _calls(jclient.Client(host="h", port=7))
    want, sent[:] = list(sent), []
    _calls(tclient.Client(host="h", port=7))
    assert sent == want and len(want) == 13


def test_server_command_matches_jax(monkeypatch):
    spawned = []

    class FakePopen:
        def __init__(self, args, **kw):
            spawned.append((args, kw))

        def poll(self):
            return None

    monkeypatch.setattr(jclient.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(tclient.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(jclient.time, "sleep", lambda s: None)
    monkeypatch.setattr(tclient.time, "sleep", lambda s: None)
    opts = dict(host="127.0.0.1", port=9, scale=6, machines_scale=2, setup_path="s",
                uncompressed=True)
    assert jclient.CLI().run(**opts) and tclient.CLI().run(**opts, device="cpu")
    assert tclient.CLI().setup(setup_path="s", generate_setup=True)
    (jargs, _), (targs, tkw), (sargs, _) = spawned
    assert jargs[:3] == [sys.executable, "-m", "fourier_tpu"]
    assert targs == [sys.executable, "-m", "fourier_tpu_torch", *jargs[3:], "--device", "cpu"]
    assert sargs[-2:] == ["--device", "cuda"] and tkw == {"stdout": None, "stderr": None}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.e2e
def test_port_routine_on_cpu(monkeypatch):
    # the spawned server inherits the environment: no card, one thread
    # (xdist workers share the machine)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tclient.test_routine(host="127.0.0.1", port=_free_port(), scale=6, machines_scale=2,
                         device="cpu")
