// K2 g1_add: batched complete Jacobian addition, one thread per lane.
//
// Replaces fourier_tpu/ops/pallas_curve.py:_add_inc_kernel (with the
// lax.cond rerun of curve.add_fast) and _add_kernel (pallas_curve.add).
// The port launches it for msm_naive's halving tree, one launch a level
// (1 to 32 lanes); the bucket-reduction trees run in g1_tree.cu.  The
// doubling branch is taken per thread where the TPU flagged the lane and
// reran the whole batch; such lanes are counted into `collisions`.
//
// Each lane runs the redundant complete addition of g1.cuh (coordinates
// in [0, 2p), no conditional subtraction inside a product, adds and subs
// modulo 2p) and stores canonical limbs once.
//
// Bound: operations, ~16 Fp Montgomery products per finite lane against 6
// coordinates read and 3 written.  At msm_naive's tree levels the work is
// one addition's latency, so its floor is that latency.
//
// Occupancy: ptxas gives it 226 registers, no spill; at 2^19 lanes blocks
// of 128 threads ran faster than 64 or 256 (PERF.md).

#include "g1.cuh"

#define ADD_THREADS 128

__global__ void __launch_bounds__(ADD_THREADS)
g1_add_kernel(const int64_t *__restrict__ x1, const int64_t *__restrict__ y1,
              const int64_t *__restrict__ z1, const int64_t *__restrict__ x2,
              const int64_t *__restrict__ y2, const int64_t *__restrict__ z2,
              int64_t *out_x, int64_t *out_y, int64_t *out_z, int64_t n,
              unsigned long long *collisions) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p, q, r;
  load_jac(p, x1, y1, z1, n, i);
  load_jac(q, x2, y2, z2, n, i);
  if (g1_add(r, p, q)) atomicAdd(collisions, 1ull);
  store_jac(out_x, out_y, out_z, n, i, r);
}

extern "C" int fk_g1_add(const void *x1, const void *y1, const void *z1, const void *x2,
                         const void *y2, const void *z2, void *out_x, void *out_y,
                         void *out_z, int64_t n, void *collisions, void *stream) {
  if (n > 0) {
    g1_add_kernel<<<blocks_for(n, ADD_THREADS), ADD_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)x1, (const int64_t *)y1, (const int64_t *)z1,
        (const int64_t *)x2, (const int64_t *)y2, (const int64_t *)z2,
        (int64_t *)out_x, (int64_t *)out_y, (int64_t *)out_z, n,
        (unsigned long long *)collisions);
  }
  return (int)cudaGetLastError();
}
