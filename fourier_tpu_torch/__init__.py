"""fourier_tpu_torch: the PyTorch + CUDA port of fourier_tpu for NVIDIA Hopper.

The same Pianist/PIANO bivariate KZG server over BLS12-381 and the same
11-method JSON-RPC wire, with every Pallas kernel of the JAX package
rewritten as a hand-written CUDA kernel for sm_90a (``ops.kernels``).
The JAX package ``fourier_tpu`` stays the reference; this package imports
neither jax nor any of its modules, and keeps its own copies of the
framework-free ones (constants, ops.limbs, refimpl, native, runtime.wire),
and its own tracer (utils.trace, which holds the copy of utils.timing).

Layer map (top to bottom):
  runtime.cli     - `python -m fourier_tpu_torch run|setup`
  runtime.server  - JSON-RPC HTTP server (11 wire methods)
  runtime.io      - setup files (the reference's bytes) and FTPC precompute files
  models.piano    - PIANO protocol: setup / commit / open / verify
  ops.*           - Fp/Fr tensors, G1 curve, MSMs, NTT, point serialization;
                    ops.kernels holds the CUDA kernels and their plain twins
  refimpl, native - host arithmetic, pairings and the wire codec
  convert         - carries the JAX package's setup and tables across
"""

__version__ = "0.1.0"
