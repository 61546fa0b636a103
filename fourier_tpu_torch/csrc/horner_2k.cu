// K4 horner_2k: sum over k of 2^k * T_k for K terms of R residual lanes.
//
// Replaces fourier_tpu/ops/pallas_curve.py:horner_2k, whose accumulator
// lived in a revisited VMEM block across a sequential grid of K steps.
// Here thread r runs the whole chain: acc = T_{K-1}, then for k = K-2 .. 0
// acc = 2 * acc + T_k, with the complete doubling and addition.  Term k of
// lane r sits at column k * R + r of the [24, K * R] inputs.
//
// Bound: integer multiply throughput: ~22 Fp Montgomery products per term
// and lane, and only R (<= 64) threads: the launch is one short serial
// chain, a few hundred microseconds at most.
//
// Left for later: with R lanes the card is almost idle; splitting the
// chain over k (partial Horner sums scaled by 2^k and added) would use it.

#include "g1.cuh"

__global__ void __launch_bounds__(64)
horner_2k_kernel(const int64_t *__restrict__ tx, const int64_t *__restrict__ ty,
                 const int64_t *__restrict__ tz, int64_t n_terms, int64_t width,
                 int64_t *out_x, int64_t *out_y, int64_t *out_z,
                 unsigned long long *collisions) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= width) return;
  const int64_t stride = n_terms * width;
  Jac acc, t;
  load_jac(acc, tx, ty, tz, stride, (n_terms - 1) * width + r);
  unsigned long long doubled = 0ull;
  for (int64_t k = n_terms - 2; k >= 0; k--) {
    g1_dbl(acc, acc);
    load_jac(t, tx, ty, tz, stride, k * width + r);
    doubled += g1_add(acc, acc, t);
  }
  if (doubled) atomicAdd(collisions, doubled);
  store_jac(out_x, out_y, out_z, width, r, acc);
}

extern "C" int fk_horner_2k(const void *tx, const void *ty, const void *tz,
                            int64_t n_terms, int64_t width, void *out_x, void *out_y,
                            void *out_z, void *collisions, void *stream) {
  if (n_terms > 0 && width > 0) {
    horner_2k_kernel<<<blocks_for(width, 64), 64, 0, (cudaStream_t)stream>>>(
        (const int64_t *)tx, (const int64_t *)ty, (const int64_t *)tz, n_terms, width,
        (int64_t *)out_x, (int64_t *)out_y, (int64_t *)out_z,
        (unsigned long long *)collisions);
  }
  return (int)cudaGetLastError();
}
