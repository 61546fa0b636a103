"""Pure-Python ground-truth implementation of the BLS12-381 crypto core
(the port's copy of ``fourier_tpu.refimpl``).

This subpackage is the framework's *authoritative slow path*: exact
arbitrary-precision arithmetic over Python ints.  It plays two roles:

1. **Test oracle.** Every device kernel (limb field ops, NTT, curve ops, MSM)
   is checked bit-exactly against this implementation, mirroring how the
   reference uses ``BivariateFsPolynomial`` as ground truth for its
   distributed protocol tests (reference src/bipoly.rs:36-124).

2. **Verify-side arithmetic.** Pairing checks are O(1) per request and run
   host-side (the reference likewise verifies on CPU through blst FFI,
   reference src/engine/piano.rs:358-464).
"""

from . import field, curve, tower, pairing, poly  # noqa: F401
