"""Python client: the L5 user-facing surface.

The port's copy of ``fourier_tpu.runtime.client``, which it does not
import: its default server command is ``python -m fourier_tpu_torch``, and
a ``device`` option (default ``cuda``) reaches the server as ``--device``.
API parity target is the reference client (reference fourier/fourier.py):
the same entry points exist with the same names, argument orders, and
return shapes — ``Client`` methods return raw ``requests.Response``
objects and the module-level helpers extract values — so reference users
can switch without edits.  The construction is this package's own:
requests are built through :mod:`fourier_tpu_torch.runtime.wire` (the same
module the server parses with, so client and server cannot drift), the
server subprocess is managed declaratively from an option mapping, and
errors surface as exceptions rather than printed-and-swallowed Nones.

With the port's tracer on (``utils.trace.TRACER.enable()``), each helper
records ``client.request`` (its request's id, sent to the server in the
``X-Fourier-Request`` header) around ``client.encode``, ``client.post``
(counts ``req_bytes`` and ``resp_bytes``) and ``client.decode``.  Off, the
request on the wire is the reference's, byte for byte, headers included.

Two reference bugs are deliberately not reproduced: its ``Client.prove``
calls a request constructor that does not exist (fourier.py:345-348), and its
``CLI.stop`` returns True exactly when the process FAILED to stop
(fourier.py:207-210).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from operator import itemgetter
from typing import List

import requests

from ..utils.trace import REQUEST_HEADER, TRACER, span
from . import wire

DEFAULT_HOST = "127.0.0.1"
DEFAULT_PORT = 1337
DEFAULT_BIN = None  # None -> python -m fourier_tpu_torch
DEFAULT_DEVICE = "cuda"
DEFAULT_SETUP_PATH = "setup"
DEFAULT_PRECOMPUTE_PATH = "precompute"
DEFAULT_SKIP_PRECOMPUTE = False
DEFAULT_UNCOMPRESSED = False


class RpcError(RuntimeError):
    """An error response ({"message": ...}) from the server."""


def _raise_if_error(data: dict) -> dict:
    msg = data.get("message") if isinstance(data, dict) else None
    if msg is not None:
        raise RpcError(msg)
    return data


class CLI:
    """Manages a `fourier_tpu_torch` server subprocess.

    The reference manages its Rust binary the same way
    (fourier.py:99-213); here the default command is this package's own
    module entry point.  `output`, when given, is a file that receives the
    server's standard output and error (by default they are inherited).
    """

    # maps keyword -> CLI flag; bool True appends the bare flag,
    # any other non-None value appends "flag value".
    _OPTION_FLAGS = {
        "host": "--host",
        "port": "--port",
        "scale": "--scale",
        "machines_scale": "--machines-scale",
        "setup_path": "--setup-path",
        "precompute_path": "--precompute-path",
        "uncompressed": "--uncompressed",
        "overwrite": "--overwrite",
        "generate_setup": "--generate-setup",
        "generate_precompute": "--generate-precompute",
        "compress_existing": "--compress-existing",
        "decompress_existing": "--decompress-existing",
        "device": "--device",
    }

    def __init__(self, bin=DEFAULT_BIN, output=None):
        if bin is not None and not os.path.exists(bin):
            raise FileNotFoundError(bin)
        self.bin = bin
        self.output = output
        self.process: subprocess.Popen | None = None

    def cmd(self, args: List[str]) -> List[str]:
        base = [self.bin] if self.bin else [sys.executable, "-m", "fourier_tpu_torch"]
        return [*base, *args]

    def _spawn(self, subcommand: str, options: dict) -> bool:
        args = [subcommand]
        for key, value in options.items():
            if value is None or value is False:
                continue
            flag = self._OPTION_FLAGS[key]
            args.append(flag)
            if value is not True:
                args.append(str(value))
        self.process = subprocess.Popen(self.cmd(args), stdout=self.output,
                                        stderr=None if self.output is None
                                        else subprocess.STDOUT)
        return self.wait_until_running()

    def wait_until_running(self, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        time.sleep(1)
        while not self.is_running():
            if time.monotonic() > deadline:
                return False
            time.sleep(1)
        return True

    def run(self, host=None, port=None, scale=None, machines_scale=None,
            setup_path=None, precompute_path=None, uncompressed=None,
            device=DEFAULT_DEVICE) -> bool:
        return self._spawn("run", dict(
            host=host, port=port, scale=scale, machines_scale=machines_scale,
            setup_path=setup_path, precompute_path=precompute_path,
            uncompressed=bool(uncompressed), device=device,
        ))

    def setup(self, setup_path=None, overwrite=False, scale=None,
              machines_scale=None, precompute_path=None, generate_setup=False,
              generate_precompute=False, uncompressed=False,
              compress_existing=False, decompress_existing=False,
              device=DEFAULT_DEVICE) -> bool:
        return self._spawn("setup", dict(
            setup_path=setup_path, precompute_path=precompute_path,
            overwrite=overwrite, scale=scale, machines_scale=machines_scale,
            generate_setup=generate_setup,
            generate_precompute=generate_precompute,
            uncompressed=uncompressed, compress_existing=compress_existing,
            decompress_existing=decompress_existing, device=device,
        ))

    def stop(self) -> bool:
        if self.is_running():
            self.process.terminate()
            try:
                self.process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.process.kill()
        return self.is_running()

    def is_running(self) -> bool:
        return self.process is not None and self.process.poll() is None


class Client:
    """HTTP client plus server lifecycle.

    Every RPC method posts a request built by ``wire.serialize_request``
    and returns the raw ``requests.Response`` (reference-compatible
    shape); use the module-level helpers for extracted values.
    """

    def __init__(self, setup_path=None, precompute_path=None,
                 host=DEFAULT_HOST, port=DEFAULT_PORT,
                 uncompressed=DEFAULT_UNCOMPRESSED, bin=DEFAULT_BIN,
                 device=DEFAULT_DEVICE, output=None):
        self.host = host
        self.port = port
        self.cli = CLI(bin=bin, output=output)
        self.setup_path = setup_path
        self.precompute_path = precompute_path
        self.uncompressed = uncompressed
        self.device = device

    def endpoint(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _call(self, method: str, params: dict | None = None) -> requests.Response:
        rid = TRACER.current_request()   # None unless traced inside a helper's request
        if rid is None:
            return requests.post(
                self.endpoint(), data=wire.serialize_request(method, params)
            )
        with span("client.encode"):
            body = wire.serialize_request(method, params)
        with span("client.post", req_bytes=len(body)) as post:
            resp = requests.post(self.endpoint(), data=body, headers={REQUEST_HEADER: rid})
            post.add(resp_bytes=len(resp.content))
        return resp

    # -- lifecycle -----------------------------------------------------

    def start_server(self, scale=None, machines_scale=None) -> bool:
        self.cli.run(
            host=self.host, port=self.port, scale=scale,
            machines_scale=machines_scale, setup_path=self.setup_path,
            precompute_path=self.precompute_path,
            uncompressed=self.uncompressed, device=self.device,
        )
        return self.cli.is_running()

    start_rust = start_server  # reference name preserved

    def stop_server(self) -> bool:
        return self.cli.stop()

    stop_rust = stop_server

    def start(self, scale=None, machines_scale=None, timeout=300):
        """Start the server and poll ping until it answers.

        Setup generation dominates startup at large scale, so liveness is
        polled against the deadline rather than checked once.  Returns
        None once the server answers (the reference contract) and False
        on failure.
        """
        if not self.start_server(scale=scale, machines_scale=machines_scale):
            return False
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if self.ping().ok:
                    return None  # reference returns None on success
            except requests.ConnectionError:
                pass
            if not self.cli.is_running():
                return False
            time.sleep(0.5)
        return False

    def stop(self):
        if not self.stop_server():
            return False

    # -- RPC surface (11 methods) ---------------------------------------

    def post(self, method: str, params: dict | None = None) -> requests.Response:
        return self._call(method, params)

    def ping(self) -> requests.Response:
        return self._call("ping")

    def random_poly(self) -> requests.Response:
        return self._call("randomPoly")

    def random_point(self) -> requests.Response:
        return self._call("randomPoint")

    def eval(self, poly, x) -> requests.Response:
        return self._call("evaluate", {"poly": poly, "x": x})

    def fft(self, poly, left: bool, inverse: bool) -> requests.Response:
        return self._call("fft", {"poly": poly, "left": left, "inverse": inverse})

    def worker_commit(self, i, poly) -> requests.Response:
        return self._call("workerCommit", {"i": i, "poly": poly})

    def worker_open(self, i, poly, x) -> requests.Response:
        return self._call("workerOpen", {"i": i, "poly": poly, "x": x})

    def worker_verify(self, i, proof, alpha, eval, commitment) -> requests.Response:
        return self._call("workerVerify", {
            "i": i, "alpha": alpha, "proof": proof,
            "eval": eval, "commitment": commitment,
        })

    def master_commit(self, commitments) -> requests.Response:
        return self._call("masterCommit", {"commitments": commitments})

    def master_open(self, evals, proofs, beta) -> requests.Response:
        return self._call("masterOpen", {
            "evals": evals, "proofs": proofs, "beta": beta,
        })

    def master_verify(self, commitment, beta, alpha, z, pi_0, pi_1):
        return self._call("masterVerify", {
            "commitment": commitment, "beta": beta, "alpha": alpha,
            "z": z, "pi_0": pi_0, "pi_1": pi_1,
        })


# -- module-level helpers: post, check for errors, extract the value --------

def _answer(method: str, send, extract):
    """send() the request, then extract the value from its answer."""
    with TRACER.request("client.request", method=method):
        with send() as resp:
            with span("client.decode"):
                return extract(_raise_if_error(resp.json()))


def random_poly(rpc: Client):
    return _answer("randomPoly", rpc.random_poly, itemgetter("poly"))


def random_point(rpc: Client):
    return _answer("randomPoint", rpc.random_point, itemgetter("point"))


def eval_poly(rpc: Client, poly, x):
    return _answer("evaluate", lambda: rpc.eval(poly, x), itemgetter("y"))


def fft(rpc: Client, poly, left: bool, inverse: bool):
    return _answer("fft", lambda: rpc.fft(poly, left, inverse), itemgetter("poly"))


def worker_commit(rpc: Client, i, poly):
    return _answer("workerCommit", lambda: rpc.worker_commit(i, poly),
                   itemgetter("commitment"))


def worker_open(rpc: Client, i, poly, x):
    return _answer("workerOpen", lambda: rpc.worker_open(i, poly, x),
                   itemgetter("eval", "proof"))


def worker_verify(rpc: Client, i, proof, alpha, eval, commitment):
    return _answer("workerVerify",
                   lambda: rpc.worker_verify(i, proof, alpha, eval, commitment),
                   itemgetter("valid"))


def worker_commit_and_open(rpc: Client, i, poly, alpha):
    return (worker_commit(rpc, i, poly), *worker_open(rpc, i, poly, alpha))


def master_commit(rpc: Client, commitments):
    return _answer("masterCommit", lambda: rpc.master_commit(commitments),
                   itemgetter("commitment"))


def master_open(rpc: Client, evals, proofs, beta):
    return _answer("masterOpen", lambda: rpc.master_open(evals, proofs, beta),
                   itemgetter("z", "pi_0", "pi_1"))


def master_verify(rpc: Client, commitment, beta, alpha, z, pi_0, pi_1):
    return _answer("masterVerify",
                   lambda: rpc.master_verify(commitment, beta, alpha, z, pi_0, pi_1),
                   itemgetter("valid"))


def test_routine(host: str = DEFAULT_HOST, port: int = DEFAULT_PORT,
                 setup_path: str = None, precompute_path: str = None,
                 uncompressed: bool = True, bin: str = DEFAULT_BIN,
                 scale: int = 6, machines_scale: int = 2,
                 device: str = DEFAULT_DEVICE):
    """End-to-end routine over a live server: the CI gate flow.

    Behavioral note preserved from the reference client (SURVEY.md §3.5):
    each row is IFFT'd (left=True, inverse=True) and the *standard-basis*
    row is what workerCommit/workerOpen receive.  Commit and open use the
    same basis, so worker and master proofs verify either way.
    """
    rpc = Client(host=host, port=port, bin=bin, setup_path=setup_path,
                 precompute_path=precompute_path, uncompressed=uncompressed,
                 device=device)
    n_workers = 2 ** machines_scale
    try:
        rpc.start(scale=scale, machines_scale=machines_scale)

        f = random_poly(rpc)
        alpha, beta = random_point(rpc), random_point(rpc)

        commitments, evals, proofs = [], [], []
        for i in range(n_workers):
            row = fft(rpc, f[i], left=True, inverse=True)
            com, y, pi = worker_commit_and_open(rpc, i, row, alpha)
            if not worker_verify(rpc, i, pi, alpha, y, com):
                raise AssertionError(f"worker {i}: proof rejected")
            print(f"worker {i}: committed, opened at alpha, proof verified")
            commitments.append(com)
            evals.append(y)
            proofs.append(pi)

        master_commitment = master_commit(rpc, commitments)
        z, pi_0, pi_1 = master_open(rpc, evals, proofs, beta)
        if not master_verify(rpc, master_commitment, beta, alpha, z, pi_0, pi_1):
            raise AssertionError("master: aggregated proof rejected")
        print(f"master: aggregate of {n_workers} workers verified at beta")
    finally:
        rpc.stop()


if __name__ == "__main__":
    os.environ.setdefault("FOURIER_LOG", "debug")
    test_routine(host="localhost", port=1337)
