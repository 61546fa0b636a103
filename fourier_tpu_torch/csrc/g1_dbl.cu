// K3 g1_dbl: batched Jacobian doubling, repeated `repeat` times in
// registers, one thread per lane.
//
// Replaces fourier_tpu/ops/pallas_curve.py:224 _dbl_kernel, which
// fourier_tpu/ops/msm.py:_dbl_n launched c times per BGMW window; here the
// c doublings between two windows are one launch.
//
// Bound: operations.  A doubling is 7 Fp Montgomery products (5 of them
// squarings) against 2 x 3 coordinates moved once for all repeats, and
// the setup's 2^19 lanes fill the card, so the time is instructions per
// doubling over the card's integer issue rate.  The design cuts those
// instructions, not bytes: each squaring takes the cross products once
// (78 word products instead of the product's 144), and the whole chain
// runs on coordinates held in [0, 2p) (g1.cuh g1_dbl_lazy): no product
// ends in a conditional subtraction, adds and subs reduce modulo 2p, and
// x, y and z are made canonical once before the store, so the limbs equal
// `repeat` canonical doublings (the reference's _dbl_n).
//
// Occupancy: with the out-of-line products of g1.cuh ptxas gives this
// kernel 118 registers and no spill.  Blocks of 256 threads ran 4% faster
// than 128, 64, or any minimum-blocks cap, in one paired measurement of
// the inlined form (PERF.md).

#include "g1.cuh"

#define DBL_THREADS 256

__global__ void __launch_bounds__(DBL_THREADS)
g1_dbl_kernel(const int64_t *__restrict__ x, const int64_t *__restrict__ y,
              const int64_t *__restrict__ z, int64_t *out_x, int64_t *out_y,
              int64_t *out_z, int64_t n, int32_t repeat) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p;
  load_jac(p, x, y, z, n, i);
  g1_dbl_n(p, repeat);
  store_jac(out_x, out_y, out_z, n, i, p);
}

extern "C" int fk_g1_dbl(const void *x, const void *y, const void *z, void *out_x,
                         void *out_y, void *out_z, int64_t n, int32_t repeat,
                         void *stream) {
  if (n > 0) {
    g1_dbl_kernel<<<blocks_for(n, DBL_THREADS), DBL_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)x, (const int64_t *)y, (const int64_t *)z, (int64_t *)out_x,
        (int64_t *)out_y, (int64_t *)out_z, n, repeat);
  }
  return (int)cudaGetLastError();
}
