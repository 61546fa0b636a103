// K3 g1_dbl: batched Jacobian doubling, repeated `repeat` times in
// registers, one thread per lane.
//
// Replaces fourier_tpu/ops/pallas_curve.py:_dbl_kernel, which
// fourier_tpu/ops/msm.py:_dbl_n launched c times per BGMW window; here the
// c doublings between two windows are one launch.
//
// Bound: integer multiply throughput: 6 Fp Montgomery products per
// doubling against 2 x 3 x 24 int64 limbs moved once for all repeats.
//
// Left for later: the doubling chain of a lane is serial, so the launch
// is as long as `repeat` doublings; at the precompute's 2^19 lanes the
// card is full and nothing more is needed.

#include "g1.cuh"

__global__ void __launch_bounds__(128)
g1_dbl_kernel(const int64_t *__restrict__ x, const int64_t *__restrict__ y,
              const int64_t *__restrict__ z, int64_t *out_x, int64_t *out_y,
              int64_t *out_z, int64_t n, int32_t repeat) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p;
  load_jac(p, x, y, z, n, i);
  for (int32_t k = 0; k < repeat; k++) g1_dbl(p, p);
  store_jac(out_x, out_y, out_z, n, i, p);
}

extern "C" int fk_g1_dbl(const void *x, const void *y, const void *z, void *out_x,
                         void *out_y, void *out_z, int64_t n, int32_t repeat,
                         void *stream) {
  if (n > 0) {
    g1_dbl_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        (const int64_t *)x, (const int64_t *)y, (const int64_t *)z, (int64_t *)out_x,
        (int64_t *)out_y, (int64_t *)out_z, n, repeat);
  }
  return (int)cudaGetLastError();
}
