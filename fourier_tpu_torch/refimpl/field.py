"""Prime-field helpers over Python ints (ground truth).

Serialization follows rust-kzg-blst semantics:
``FsFr::from_bytes``/``to_bytes`` are 32-byte big-endian with a canonicality
check (reference src/engine/piano.rs:60-63 feeds base64-decoded 32-byte
big-endian strings into ``FsFr::from_bytes``).
"""

from ..constants import P, R


def fr_add(a: int, b: int) -> int:
    return (a + b) % R


def fr_sub(a: int, b: int) -> int:
    return (a - b) % R


def fr_mul(a: int, b: int) -> int:
    return (a * b) % R


def fr_neg(a: int) -> int:
    return (-a) % R


def fr_inv(a: int) -> int:
    return pow(a, -1, R)


def fr_pow(a: int, e: int) -> int:
    return pow(a, e, R)


def fr_to_bytes(a: int) -> bytes:
    """32-byte big-endian (FsFr::to_bytes)."""
    return int(a % R).to_bytes(32, "big")


def fr_from_bytes(b: bytes) -> int:
    """Parse 32-byte big-endian scalar; reject non-canonical values.

    Mirrors blst_scalar_fr_check behaviour behind FsFr::from_bytes.
    """
    if len(b) != 32:
        raise ValueError(f"expected 32 bytes, got {len(b)}")
    v = int.from_bytes(b, "big")
    if v >= R:
        raise ValueError("scalar is not canonical (>= r)")
    return v


def hash_to_bls_field(b: bytes) -> int:
    """32 untrusted bytes -> Fr, reducing mod r.

    Mirrors kzg::eip_4844::hash_to_bls_field used for trusted-setup secrets
    (reference src/engine/piano.rs:890-891); EIP-4844 uses big-endian.
    """
    if len(b) != 32:
        raise ValueError(f"expected 32 bytes, got {len(b)}")
    return int.from_bytes(b, "big") % R


def fp_add(a: int, b: int) -> int:
    return (a + b) % P


def fp_sub(a: int, b: int) -> int:
    return (a - b) % P


def fp_mul(a: int, b: int) -> int:
    return (a * b) % P


def fp_neg(a: int) -> int:
    return (-a) % P


def fp_inv(a: int) -> int:
    return pow(a, -1, P)


def fp_sqrt(a: int) -> int | None:
    """Square root in Fp (p % 4 == 3), or None if a is not a QR."""
    root = pow(a, (P + 1) // 4, P)
    if root * root % P != a % P:
        return None
    return root
