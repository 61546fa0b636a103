// A microbenchmark of the Fp Montgomery product and square of the G1
// kernels (fp_mul, fp_sqr of g1.cuh): one per thread (for its SASS) and a
// dependent chain per thread (for the rate over many lanes and the
// latency in one warp), also in redundant form; and dependent chains of
// the complete additions
// (g1_add, g1_madd of g1.cuh), for an addition's latency in one warp.
// kernel_probe.py builds it and counts its SASS.  Values are 12 x 32-bit
// words, word-major: word j of lane i at j * n + i; a point is its x, y
// and z one after the other (3 x 12 words a lane).

#include "g1.cuh"

__device__ __forceinline__ void bench_load(Fp &r, const uint32_t *src, int64_t n, int64_t i) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = src[j * n + i];
}

__device__ __forceinline__ void bench_store(uint32_t *dst, int64_t n, int64_t i, const Fp &a) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) dst[j * n + i] = a.w[j];
}

// One product per lane: the kernel whose SASS is counted.
__global__ void bench_one(const uint32_t *a, const uint32_t *b, uint32_t *r, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp x, y, z;
  bench_load(x, a, n, i);
  bench_load(y, b, n, i);
  fp_mul(z, x, y);
  bench_store(r, n, i, z);
}

// One square per lane.
__global__ void bench_sqr_one(const uint32_t *a, uint32_t *r, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp x, z;
  bench_load(x, a, n, i);
  fp_sqr(z, x);
  bench_store(r, n, i, z);
}

// x := x^(2^iters) per lane, a dependent chain of squares.
__global__ void __launch_bounds__(128) bench_sqr_chain(uint32_t *x, int iters, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp acc;
  bench_load(acc, x, n, i);
  for (int k = 0; k < iters; k++) fp_sqr(acc, acc);
  bench_store(x, n, i, acc);
}

// x := x * b^iters per lane, a dependent chain: the rate over many lanes.
__global__ void __launch_bounds__(128) bench_chain(uint32_t *x, const uint32_t *b, int iters,
                                                   int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp acc, m;
  bench_load(acc, x, n, i);
  bench_load(m, b, n, i);
  for (int k = 0; k < iters; k++) fp_mul(acc, acc, m);
  bench_store(x, n, i, acc);
}

// The same chains in redundant form (fp_mul_lazy, fp_sqr_lazy: values
// stay below 2p), the products of the point formulas.
__global__ void __launch_bounds__(128) bench_lazy_chain(uint32_t *x, const uint32_t *b,
                                                        int iters, int64_t n, int square) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp acc, m;
  bench_load(acc, x, n, i);
  bench_load(m, b, n, i);
  if (square)
    for (int k = 0; k < iters; k++) fp_sqr_lazy(acc, acc);
  else
    for (int k = 0; k < iters; k++) fp_mul_lazy(acc, acc, m);
  bench_store(x, n, i, acc);
}

extern "C" int fk_bench_lazy_chain(void *x, const void *b, int iters, int64_t n, int square,
                                   void *stream) {
  bench_lazy_chain<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (uint32_t *)x, (const uint32_t *)b, iters, n, square);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void bench_load_jac(Jac &p, const uint32_t *src, int64_t n,
                                               int64_t i) {
  bench_load(p.x, src, n, i);
  bench_load(p.y, src + FP_WORDS * n, n, i);
  bench_load(p.z, src + 2 * FP_WORDS * n, n, i);
}

__device__ __forceinline__ void bench_store_jac(uint32_t *dst, int64_t n, int64_t i,
                                                const Jac &p) {
  bench_store(dst, n, i, p.x);
  bench_store(dst + FP_WORDS * n, n, i, p.y);
  bench_store(dst + 2 * FP_WORDS * n, n, i, p.z);
}

// acc := acc + q per lane, iters times: the complete Jacobian addition
// (mixed = 0) or the mixed addition with q's x and y (mixed = 1).
template <int MIXED>
__global__ void __launch_bounds__(128) bench_add_chain(uint32_t *acc, const uint32_t *q,
                                                       int iters, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac a, b;
  bench_load_jac(a, acc, n, i);
  bench_load_jac(b, q, n, i);
  for (int k = 0; k < iters; k++) {
    if (MIXED)
      g1_madd(a, a, b.x, b.y);
    else
      g1_add(a, a, b);
  }
  bench_store_jac(acc, n, i, a);
}

extern "C" int fk_bench_add_chain(void *acc, const void *q, int mixed, int iters, int64_t n,
                                  void *stream) {
  if (mixed)
    bench_add_chain<1><<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        (uint32_t *)acc, (const uint32_t *)q, iters, n);
  else
    bench_add_chain<0><<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        (uint32_t *)acc, (const uint32_t *)q, iters, n);
  return (int)cudaGetLastError();
}

extern "C" int fk_bench_one(const void *a, const void *b, void *r, int64_t n, void *stream) {
  bench_one<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)a, (const uint32_t *)b, (uint32_t *)r, n);
  return (int)cudaGetLastError();
}

extern "C" int fk_bench_chain(void *x, const void *b, int iters, int64_t n, void *stream) {
  bench_chain<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (uint32_t *)x, (const uint32_t *)b, iters, n);
  return (int)cudaGetLastError();
}

extern "C" int fk_bench_sqr_chain(void *x, int iters, int64_t n, void *stream) {
  bench_sqr_chain<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>((uint32_t *)x, iters, n);
  return (int)cudaGetLastError();
}
