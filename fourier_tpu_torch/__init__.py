"""fourier_tpu_torch: the PyTorch + CUDA port of fourier_tpu for NVIDIA Hopper.

The same Pianist/PIANO bivariate KZG server over BLS12-381 and the same
11-method JSON-RPC wire, with every Pallas kernel of the commit/open path
rewritten as a hand-written CUDA kernel for sm_90a (``ops.kernels``).
The JAX package ``fourier_tpu`` stays the reference; this package imports
only its framework-free modules (constants, limbs, refimpl, native, wire,
timing) and never jax.

Layer map (top to bottom):
  runtime.cli     - `python -m fourier_tpu_torch run`
  runtime.server  - JSON-RPC HTTP server (11 wire methods)
  models.piano    - PIANO protocol: setup / commit / open / verify
  ops.*           - Fp/Fr tensors, G1 curve, MSM, NTT; ops.kernels holds the
                    CUDA kernels and their plain twins
  convert         - carries the JAX package's setup and tables across
"""

__version__ = "0.1.0"
