// K5 g1_madd: batched complete mixed addition p + q, q affine with an
// infinity mask, one thread per lane.
//
// Replaces fourier_tpu/ops/pallas_curve.py:_madd_kernel (reached through
// pallas_curve.madd), with the branches of its _madd_values: q at infinity
// gives p; p at infinity gives q lifted to z = 1; the same point takes the
// doubling.  Doubling lanes are counted into `collisions`, as K2 does.
//
// Bound: integer multiply throughput for finite lanes: 11 Fp Montgomery
// products (~300 32-bit multiply-adds each) against 5 x 24 int64 limbs and
// one mask byte read and 3 x 24 limbs written.  In the int64 16-bit-limb
// layout of the tensors the bytes are the tighter bound at full occupancy.
//
// Left for later: the int64 layout moves 4x the bytes of a packed one.  The
// serving path launches this kernel only through msm_naive (a row of at most
// 64 points without a table).

#include "g1.cuh"

__global__ void __launch_bounds__(128)
g1_madd_kernel(const int64_t *__restrict__ x1, const int64_t *__restrict__ y1,
               const int64_t *__restrict__ z1, const int64_t *__restrict__ x2,
               const int64_t *__restrict__ y2, const uint8_t *__restrict__ inf2,
               int64_t *out_x, int64_t *out_y, int64_t *out_z, int64_t n,
               unsigned long long *collisions) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p, r;
  load_jac(p, x1, y1, z1, n, i);
  if (inf2[i]) {
    r = p;
  } else {
    Fp qx, qy;
    load_fp(qx, x2, n, i);
    load_fp(qy, y2, n, i);
    if (g1_madd(r, p, qx, qy)) atomicAdd(collisions, 1ull);
  }
  store_jac(out_x, out_y, out_z, n, i, r);
}

extern "C" int fk_g1_madd(const void *x1, const void *y1, const void *z1, const void *x2,
                          const void *y2, const void *inf2, void *out_x, void *out_y,
                          void *out_z, int64_t n, void *collisions, void *stream) {
  if (n > 0) {
    g1_madd_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        (const int64_t *)x1, (const int64_t *)y1, (const int64_t *)z1,
        (const int64_t *)x2, (const int64_t *)y2, (const uint8_t *)inf2,
        (int64_t *)out_x, (int64_t *)out_y, (int64_t *)out_z, n,
        (unsigned long long *)collisions);
  }
  return (int)cudaGetLastError();
}
