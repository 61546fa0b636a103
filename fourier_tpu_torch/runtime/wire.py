"""Wire protocol (the port's copy of ``fourier_tpu.runtime.wire``): the 11
JSON-RPC-style methods, byte-compatible with the reference server (RpcRequest/RpcResult, reference src/rpc.rs:18-143).

Requests:  {"method": "<camelCase>", "params": {...}}  (params absent for
nullary methods).  Responses are the *bare* result JSON — no jsonrpc
envelope — exactly like the reference's make_response, which serializes
RpcResult rather than RpcResponse (reference src/rpc.rs:409-411).  Errors
are {"message": "..."}.

Payload scalars/points are base64 (standard alphabet, no padding:
B64ENGINE = STANDARD_NO_PAD, reference src/utils.rs:10) over 32-byte
big-endian Fr / 48-byte compressed G1.
"""

from __future__ import annotations

import base64
import json

# (method, ordered param keys) — the serialization order is pinned by the
# reference's serde round-trip test (src/rpc.rs:553-565).
METHODS: dict[str, list[str]] = {
    "ping": [],
    "randomPoly": [],
    "randomPoint": [],
    "evaluate": ["poly", "x"],
    "workerCommit": ["i", "poly"],
    "workerOpen": ["i", "poly", "x"],
    "workerVerify": ["i", "alpha", "proof", "eval", "commitment"],
    "masterCommit": ["commitments"],
    "masterOpen": ["evals", "proofs", "beta"],
    "masterVerify": ["commitment", "beta", "alpha", "z", "pi_0", "pi_1"],
    "fft": ["poly", "left", "inverse"],
}


def b64_encode(raw: bytes) -> str:
    return base64.b64encode(raw).decode().rstrip("=")


def b64_decode(s: str) -> bytes:
    """Strict STANDARD_NO_PAD decode, matching the reference engine.

    The reference's base64::STANDARD_NO_PAD rejects '=' padding, invalid
    symbols, and nonzero unused trailing bits in the final symbol — every
    byte string has exactly ONE accepted encoding (no wire malleability).
    """
    if "=" in s:
        raise ValueError("base64 padding is not accepted")
    pad = -len(s) % 4
    if pad == 3:
        raise ValueError("invalid base64 length")
    out = base64.b64decode(s + "=" * pad, validate=True)
    # trailing-bit check: re-encoding must reproduce the input exactly
    if base64.b64encode(out).decode().rstrip("=") != s:
        raise ValueError("non-canonical base64 (trailing bits set)")
    return out


def parse_request(body: bytes | str):
    """-> (method, params dict).  Raises ValueError on malformed requests."""
    try:
        obj = json.loads(body)
    except json.JSONDecodeError as e:
        raise ValueError(str(e)) from e
    if not isinstance(obj, dict) or "method" not in obj:
        raise ValueError("missing method")
    method = obj["method"]
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    params = obj.get("params") or {}
    keys = METHODS[method]
    if keys:
        missing = [k for k in keys if k not in params]
        if missing:
            raise ValueError(f"missing params {missing} for {method}")
    return method, params


def serialize_request(method: str, params: dict | None = None) -> str:
    """Canonical request serialization, key order pinned (wire-format test)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    keys = METHODS[method]
    if not keys:
        return json.dumps({"method": method}, separators=(",", ":"))
    ordered = {k: params[k] for k in keys}
    return json.dumps(
        {"method": method, "params": ordered}, separators=(",", ":")
    )


def serialize_result(result: dict) -> bytes:
    """Bare-result response body (field order as given)."""
    return json.dumps(result, separators=(",", ":")).encode()
