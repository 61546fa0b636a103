"""The port's tracer (fourier_tpu_torch/utils/trace.py) over its client and
server, on the CPU.

One module-scoped server at scale 4 / machines 1 serves the port's
RpcHandler through its HTTP handler, as tests/test_torch_server.py builds
it (the port alone: no JAX backend).

- Off (the default), a workerCommit's request is the one the client sent
  before it had a tracer, body and headers byte for byte; no span
  synchronizes and nothing is recorded.
- On, a workerCommit and a workerOpen over HTTP each give the tree of
  client, server and protocol spans, every span of a request carrying its
  one id, each child inside its parent on the host clock.
- A span and the profiler's record of a range inside it share a clock.
- `timed` synchronizes the cards when given work on them (on a card only).
"""

import json
import socketserver
import threading
import time
from http.server import ThreadingHTTPServer

import pytest
import requests
import torch

from fourier_tpu_torch.models import piano as tpiano
from fourier_tpu_torch.runtime import client, server, wire
from fourier_tpu_torch.utils import trace

torch.set_num_threads(1)

SECRETS = (b"\x05" * 32, b"\x06" * 32)
SCALE, MACHINES_SCALE = 4, 1
ROW = [(7 + 13 * k) ** 5 for k in range(8)]
ROW_STRINGS = [wire.b64_encode(v.to_bytes(32, "big")) for v in ROW]

COMMIT_TREE = {
    "client.request": None, "client.encode": "client.request", "client.post": "client.request",
    "client.decode": "client.request", "server.request": None, "server.read": "server.request",
    "server.parse": "server.request", "server.queue": "server.request",
    "server.decode": "server.request", "server.call": "server.request",
    "server.encode": "server.request", "server.write": "server.request",
    "worker_commit": "server.call", "commit.upload": "worker_commit", "msm": "worker_commit",
    "commit.lift": "worker_commit",
}
OPEN_TREE = {
    **{k: v for k, v in COMMIT_TREE.items() if v not in ("worker_commit", "server.call")},
    "worker_open": "server.call", "open.upload": "worker_open", "open.quotient": "worker_open",
    "open.eval": "worker_open", "msm": "worker_open", "commit.lift": "worker_open",
}


@pytest.fixture(scope="module")
def port():
    fft = tpiano.PianoFFTSettings(SCALE, MACHINES_SCALE, "cpu")
    settings = tpiano.generate_trusted_setup(fft, SECRETS)
    settings.precompute = tpiano.PianoPrecompute.generate(settings)
    handler = type("H", (server._HTTPHandler,),
                   {"rpc": server.RpcHandler(tpiano.PianoBackend(fft, settings))})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    thread.join(10)
    assert not thread.is_alive()


@pytest.fixture
def tracing():
    trace.TRACER.drain()
    trace.TRACER.enable()
    try:
        yield trace.TRACER
    finally:
        trace.TRACER.disable()
        trace.TRACER.drain()


class _Capture(socketserver.StreamRequestHandler):
    """Keeps each request's bytes (head and body) and answers a commitment."""

    def handle(self):
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            head += self.rfile.readline()
        length = int(next(ln.split(b":")[1] for ln in head.split(b"\r\n")
                          if ln.lower().startswith(b"content-length:")))
        self.server.seen.append(head + self.rfile.read(length))
        reply = b'{"commitment":"AA"}'
        self.wfile.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n%s" % (len(reply), reply))


@pytest.fixture
def capture():
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Capture)
    srv.daemon_threads = True
    srv.seen = []
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(10)
    assert not thread.is_alive()


def _no_sync(monkeypatch):
    """A synchronize on a (pretended) card raises."""
    def refuse(*a, **k):
        raise AssertionError("synchronized")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def test_off_the_wire_is_unchanged_and_nothing_is_recorded(port, capture, monkeypatch):
    assert not trace.TRACER.on
    port_of = capture.server_address[1]
    body = wire.serialize_request("workerCommit", {"i": 0, "poly": ROW_STRINGS})
    requests.post(f"http://127.0.0.1:{port_of}", data=body)     # the request before tracing
    rpc = client.Client(host="127.0.0.1", port=port_of)
    assert client.worker_commit(rpc, 0, ROW_STRINGS) == "AA"
    assert capture.seen[0] == capture.seen[1]
    assert trace.REQUEST_HEADER.lower().encode() not in capture.seen[1].lower()

    _no_sync(monkeypatch)
    com = client.worker_commit(client.Client(host="127.0.0.1", port=port), 0, ROW_STRINGS)
    assert isinstance(com, str) and len(com) == 64
    with trace.span("x", sync=True):
        pass
    trace.timed("a phase", lambda: None)
    assert trace.TRACER.drain() == []
    # on, the same spans do synchronize: the patch above is what they would call
    trace.TRACER.enable()
    try:
        with pytest.raises(AssertionError, match="synchronized"):
            with trace.span("x", sync=True):
                pass
    finally:
        trace.TRACER.disable()
        trace.TRACER.drain()


def _by_request(spans):
    out = {}
    for s in spans:
        out.setdefault(s["request"], []).append(s)
    return out


def _check_tree(spans, tree):
    names = [s["name"] for s in spans]
    assert set(names) == set(tree), sorted(set(names) ^ set(tree))
    assert names.count("server.encode") >= 1
    by_name = {s["name"]: s for s in spans if s["name"] != "server.encode"}
    for s in spans:
        assert s["parent"] == tree[s["name"]], s
        assert s["t0"] <= s["t1"]
        if s["parent"] is not None:
            p = by_name[s["parent"]]
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (s, p)
    return by_name


def test_on_each_request_gives_its_tree_under_one_id(port, tracing):
    rpc = client.Client(host="127.0.0.1", port=port)
    com = client.worker_commit(rpc, 0, ROW_STRINGS)
    y, proof = client.worker_open(rpc, 1, ROW_STRINGS, wire.b64_encode((12345).to_bytes(32, "big")))
    spans, deadline = tracing.drain(), time.monotonic() + 30
    # the server closes its request's spans after the reply the client has read
    while sum(s["name"] == "server.request" for s in spans) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
        spans += tracing.drain()
    requests_ = _by_request(spans)
    assert len(requests_) == 2 and None not in requests_
    (commit_id, commit), (open_id, open_) = sorted(
        requests_.items(), key=lambda kv: min(s["t0"] for s in kv[1]))
    for rid, spans, tree, method in ((commit_id, commit, COMMIT_TREE, "workerCommit"),
                                     (open_id, open_, OPEN_TREE, "workerOpen")):
        assert all(s["request"] == rid for s in spans)
        s = _check_tree(spans, tree)
        assert s["client.request"]["method"] == s["server.request"]["method"] == method
        assert s["client.post"]["req_bytes"] == s["server.request"]["body_bytes"] > 32 * 8
        assert s["client.post"]["resp_bytes"] == s["server.request"]["reply_bytes"] > 0
        assert isinstance(s["server.request"]["launches"], dict)
        assert s["worker_commit" if method == "workerCommit" else "worker_open"]["T"] == 8
        # the server's request starts inside the client's post
        assert s["client.post"]["t0"] <= s["server.request"]["t0"]
    assert com and y and proof


def test_server_writes_each_request_to_its_trace_file(port, tracing, tmp_path, monkeypatch):
    path = tmp_path / "spans.jsonl"
    monkeypatch.setattr(server._HTTPHandler, "trace_path", str(path))
    rpc = client.Client(host="127.0.0.1", port=port)
    assert len(client.random_point(rpc)) == 43
    deadline = time.monotonic() + 30      # the line follows the reply
    while not (path.exists() and path.read_text().endswith("\n")) and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    lines = path.read_text().splitlines()
    assert len(lines) == 1
    spans = json.loads(lines[0])
    assert {s["name"] for s in spans} >= {"server.request", "server.read", "server.parse",
                                          "server.call", "server.encode", "server.write"}
    assert len({s["request"] for s in spans}) == 1


def test_a_span_and_the_profiler_share_a_clock():
    tr = trace.Tracer()
    tr.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with torch.profiler.record_function("fourier_inner"):
                time.sleep(0.02)
    (rec,) = tr.drain()
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "fourier_inner"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert 0 <= start - rec["t0"] <= 1_000_000
    assert 0 <= rec["t1"] - end <= 1_000_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_timed_synchronizes_the_card(card, monkeypatch, tracing):
    calls = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a) or sync(*a))
    x = torch.ones(1 << 22, device="cuda", dtype=torch.int64)
    out = trace.timed("a card phase", lambda: (x * 3).sum())
    assert calls and int(out) == 3 << 22
    (rec,) = [r for r in tracing.drain() if r["name"] == "a card phase"]
    assert rec["t1"] >= rec["t0"]
