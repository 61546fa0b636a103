// K2 g1_add: batched complete Jacobian addition, one thread per lane.
//
// Replaces fourier_tpu/ops/pallas_curve.py:_add_inc_kernel (with the
// lax.cond rerun of curve.add_fast) and serves every halving step of the
// bucket-reduction trees.  The doubling branch is taken per thread where
// the TPU flagged the lane and reran the whole batch; such lanes are
// counted into `collisions`.
//
// Bound: integer multiply throughput: ~16 Fp Montgomery products per lane
// against 6 x 24 int64 limbs read and 3 x 24 written.
//
// Left for later: the int64 16-bit-limb layout moves 4x the bytes of a
// packed one, and narrow tree levels leave most of the card idle (a
// whole tree in one launch would keep it busy).

#include "g1.cuh"

__global__ void __launch_bounds__(128)
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
    g1_add_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        (const int64_t *)x1, (const int64_t *)y1, (const int64_t *)z1,
        (const int64_t *)x2, (const int64_t *)y2, (const int64_t *)z2,
        (int64_t *)out_x, (int64_t *)out_y, (int64_t *)out_z, n,
        (unsigned long long *)collisions);
  }
  return (int)cudaGetLastError();
}
