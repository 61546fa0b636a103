"""HTTP JSON-RPC server exposing the 11-method wire protocol.

Port of ``fourier_tpu.runtime.server`` on the port's backend, with the
shared wire codec (``fourier_tpu.runtime.wire``, ``fourier_tpu.native``):
any HTTP verb is served, responses are the bare result JSON and errors
are ``{"message": ...}``.  After server start and after every device
request the server logs the kernel launch counts of that step on a line
``KERNEL_LAUNCHES {"step": ..., "launches": {...}}``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fourier_tpu import native
from fourier_tpu.constants import FR_LIMBS, R
from fourier_tpu.ops.limbs import bytes_be_to_limbs, int_to_limbs, limbs_to_bytes_be
from fourier_tpu.refimpl import curve as rc
from fourier_tpu.refimpl.field import fr_from_bytes, fr_to_bytes
from fourier_tpu.runtime import wire

from ..models.piano import PianoBackend, SetupConfig
from ..ops.kernels import COUNTERS

logger = logging.getLogger("fourier_tpu")

_R_BE = int(R).to_bytes(32, "big")
_R_LIMBS_HI_FIRST = int_to_limbs(R, FR_LIMBS)[::-1].astype(np.int64)


@dataclass
class ServerConfig:
    host: str = "localhost"
    port: int = 1337
    device: str = "cuda"
    backend: SetupConfig = field(default_factory=SetupConfig)


def log_launches(step: str) -> None:
    logger.info("KERNEL_LAUNCHES %s",
                json.dumps({"step": step, "launches": COUNTERS.launches}))


def _parse_fr(s: str) -> int:
    return fr_from_bytes(wire.b64_decode(s))


def _parse_g1(s: str) -> object:
    return rc.g1_from_bytes(wire.b64_decode(s))


def _enc_fr(v: int) -> str:
    return wire.b64_encode(fr_to_bytes(v))


def _enc_fr_batch(limbs: np.ndarray) -> list[str]:
    """[FR_LIMBS, n] canonical limbs -> base64 wire strings."""
    raw = np.frombuffer(limbs_to_bytes_be(np.asarray(limbs).T, 32), np.uint8).reshape(-1, 32)
    out = native.encode_b64_batch(raw)
    if out is not None:
        return out
    return [wire.b64_encode(r.tobytes()) for r in raw]


def _enc_g1(pt) -> str:
    return wire.b64_encode(rc.g1_to_bytes(pt))


def _parse_usize(v) -> int:
    """JSON unsigned integers only (no bools, floats or strings)."""
    if type(v) is not int or v < 0:
        raise ValueError("invalid type for machine index: expected unsigned integer")
    return v


def _geq_r(limbs: np.ndarray) -> np.ndarray:
    """Per row of [n, FR_LIMBS] limbs: value >= R (lexicographic from the
    top limb: the first differing limb decides)."""
    hi_first = limbs[:, ::-1].astype(np.int64)
    diff = hi_first - _R_LIMBS_HI_FIRST
    nz = diff != 0
    first = np.argmax(nz, axis=1)
    decided = diff[np.arange(len(diff)), first]
    return ~nz.any(axis=1) | (decided > 0)


def _parse_poly_limbs(strs: list[str]) -> np.ndarray:
    """Base64 strings -> canonical [FR_LIMBS, n] limbs, rejecting values
    >= r; the native batch decoder when it is built, else numpy."""
    if strs and all(isinstance(s, str) for s in strs):
        limbs = native.decode_scalars_b64(strs, _R_BE, FR_LIMBS)
        if limbs is not None:
            return np.ascontiguousarray(limbs.T)
    raw = b"".join(wire.b64_decode(s) for s in strs)
    if len(raw) != 32 * len(strs):
        raise ValueError("scalar encoding must be 32 bytes")
    limbs = bytes_be_to_limbs(raw, 32, FR_LIMBS)  # [n, L]
    if _geq_r(limbs).any():
        raise ValueError("scalar is not canonical (>= r)")
    return np.ascontiguousarray(limbs.T)


class RpcHandler:
    """Method dispatch.  Device methods share one lock (one card, one
    queue), the RNG methods a small one; host math runs lock-free."""

    _DEVICE_METHODS = frozenset({"fft", "workerCommit", "workerOpen", "masterOpen"})
    _RNG_METHODS = frozenset({"randomPoly", "randomPoint"})

    def __init__(self, backend: PianoBackend):
        self.backend = backend
        self._device_lock = threading.Lock()
        self._rng_lock = threading.Lock()

    def handle(self, method: str, params: dict) -> dict:
        fn = getattr(self, "_handle_" + method)
        if method in self._DEVICE_METHODS:
            with self._device_lock:
                COUNTERS.reset()
                try:
                    return fn(params)
                finally:
                    log_launches(method)
        if method in self._RNG_METHODS:
            with self._rng_lock:
                return fn(params)
        return fn(params)

    # -- utils -----------------------------------------------------------------

    def _handle_ping(self, params):
        return None  # serialized as JSON null

    def _handle_randomPoly(self, params):
        rows = self.backend.random_bivariate_limbs()
        return {"poly": [_enc_fr_batch(row) for row in rows]}

    def _handle_randomPoint(self, params):
        return {"point": _enc_fr(self.backend.random_point())}

    def _handle_evaluate(self, params):
        limbs = _parse_poly_limbs(params["poly"])
        x = _parse_fr(params["x"])
        return {"y": _enc_fr(self.backend.evaluate_limbs(limbs, x))}

    def _handle_fft(self, params):
        left, inverse = params["left"], params["inverse"]
        if not isinstance(left, bool) or not isinstance(inverse, bool):
            raise ValueError("left/inverse must be booleans")
        limbs = _parse_poly_limbs(params["poly"])
        return {"poly": _enc_fr_batch(self.backend.fft.fft_limbs(limbs, left, inverse))}

    # -- worker ------------------------------------------------------------------

    def _handle_workerCommit(self, params):
        limbs = _parse_poly_limbs(params["poly"])
        self._check_len(limbs)
        commitment = self.backend.worker_commit(_parse_usize(params["i"]), self._pad(limbs))
        return {"commitment": _enc_g1(commitment)}

    def _handle_workerOpen(self, params):
        limbs = _parse_poly_limbs(params["poly"])
        self._check_len(limbs)
        x = _parse_fr(params["x"])
        y, proof = self.backend.worker_open(_parse_usize(params["i"]), self._pad(limbs), x)
        return {"proof": _enc_g1(proof), "eval": _enc_fr(y)}

    def _handle_workerVerify(self, params):
        valid = self.backend.worker_verify(
            _parse_usize(params["i"]),
            _parse_g1(params["commitment"]),
            _parse_fr(params["alpha"]),
            _parse_fr(params["eval"]),
            _parse_g1(params["proof"]),
        )
        return {"valid": bool(valid)}

    # -- master ------------------------------------------------------------------

    def _handle_masterCommit(self, params):
        commitments = [_parse_g1(s) for s in params["commitments"]]
        return {"commitment": _enc_g1(self.backend.master_commit(commitments))}

    def _handle_masterOpen(self, params):
        evals = [_parse_fr(s) for s in params["evals"]]
        proofs = [_parse_g1(s) for s in params["proofs"]]
        beta = _parse_fr(params["beta"])
        z, (pi0, pi1) = self.backend.master_open(evals, proofs, beta)
        return {"z": _enc_fr(z), "pi_0": _enc_g1(pi0), "pi_1": _enc_g1(pi1)}

    def _handle_masterVerify(self, params):
        valid = self.backend.master_verify(
            _parse_g1(params["commitment"]),
            _parse_fr(params["beta"]),
            _parse_fr(params["alpha"]),
            _parse_fr(params["z"]),
            (_parse_g1(params["pi_0"]), _parse_g1(params["pi_1"])),
        )
        return {"valid": bool(valid)}

    # -- helpers -----------------------------------------------------------------

    def _check_len(self, limbs: np.ndarray):
        if limbs.shape[-1] > self.backend.fft.T:
            raise ValueError("polynomial larger than sub-circuit size")

    def _pad(self, limbs: np.ndarray) -> np.ndarray:
        t = self.backend.fft.T
        if limbs.shape[-1] == t:
            return limbs
        pad = np.zeros((limbs.shape[0], t - limbs.shape[-1]), np.uint32)
        return np.concatenate([limbs, pad], axis=-1)


# Request-body bound (a full scale-22 worker polynomial is ~190 MB of base64).
_MAX_BODY = int(os.environ.get("FOURIER_MAX_BODY", str(1 << 30)))


class _HTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    rpc: RpcHandler = None  # type: ignore[assignment]

    def _serve(self):
        try:
            length = int(self.headers.get("Content-Length") or 0)
            if length > _MAX_BODY:
                payload = wire.serialize_result(
                    {"message": f"request body exceeds {_MAX_BODY} bytes"})
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Connection", "close")  # the body is never read
                self.end_headers()
                self.wfile.write(payload)
                self.close_connection = True
                return
            body = self.rfile.read(length) if length else b""
            logger.info("Received request")
            try:
                method, params = wire.parse_request(body)
                result = self.rpc.handle(method, params)
                payload = b"null" if result is None else wire.serialize_result(result)
            except Exception as e:  # error -> {"message": ...}, HTTP 200
                logger.error("Error: %s", e)
                payload = wire.serialize_result({"message": str(e)})
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except Exception as e:
            logger.error("Connection error: %s", e)

    do_GET = _serve
    do_POST = _serve

    def log_message(self, fmt, *args):
        logger.debug("http: " + fmt, *args)


def warm_up(backend: PianoBackend) -> None:
    """Build the kernels (on a CUDA device) and run one commit, so the
    first request pays neither."""
    if backend.device.type == "cuda":
        from ..ops import kernels

        kernels.build()
    backend.worker_commit(0, [1])


class Server:
    """Owns the backend and the listening socket."""

    def __init__(self, cfg: ServerConfig):
        self.cfg = cfg
        self.httpd: ThreadingHTTPServer | None = None

    def _new_handler(self) -> RpcHandler:
        COUNTERS.reset()
        t0 = time.perf_counter()
        backend = PianoBackend.setup(self.cfg.backend, self.cfg.device)
        logger.info("setup took %.3f s (scale %d, machines scale %d, %s)",
                    time.perf_counter() - t0, self.cfg.backend.scale,
                    self.cfg.backend.machines_scale, self.cfg.device)
        log_launches("setup")
        COUNTERS.reset()
        t0 = time.perf_counter()
        warm_up(backend)
        logger.info("warm-up took %.3f s", time.perf_counter() - t0)
        log_launches("warm-up")
        return RpcHandler(backend)

    def run(self) -> None:
        logger.info("Starting RPC server...")
        handler_cls = type("BoundHandler", (_HTTPHandler,), {})
        addr = (self.cfg.host, self.cfg.port)
        self.httpd = ThreadingHTTPServer(addr, handler_cls)
        logger.info("Listening on: %s:%s", *addr)
        try:
            handler_cls.rpc = self._new_handler()
        except BaseException:
            self.httpd.server_close()  # a retry binds the port anew
            raise
        logger.info("Serving")
        self.httpd.serve_forever()

    def shutdown(self):
        if self.httpd:
            self.httpd.shutdown()


def start_rpc_server(cfg: ServerConfig, on_server=None) -> None:
    """Run the server, restarting it two seconds after a failure."""
    server = Server(cfg)
    if on_server is not None:
        on_server(server)
    while True:
        try:
            server.run()
            return
        except Exception as e:
            logger.error("Error: %s", e)
            logger.info("Error starting server, retrying in 2 seconds...")
            time.sleep(2)
