// K5 g1_madd: complete mixed additions p + q, q affine with an infinity
// mask, one thread per lane, in two entries.
//
// fk_g1_madd, the batched entry, replaces
// fourier_tpu/ops/pallas_curve.py:_madd_kernel (reached through
// pallas_curve.madd), with the branches of its _madd_values: q at infinity
// gives p; p at infinity gives q lifted to z = 1; the same point takes the
// doubling.  Doubling lanes are counted into `collisions`, as K2 does.
//
// fk_g1_madd_ladder runs msm_naive's whole double-and-add in one launch:
// lane i holds its accumulator in registers from the identity and, for
// bit b of its scalar from nbits - 1 down to 0, doubles it (except on the
// first bit) and mixed-adds its affine point where the bit is set and the
// point is finite: the chain msm_naive ran as one K3 and one K5 launch a
// bit.  In the reference those steps are msm_naive's add_fast and dbl_fast
// (fourier_tpu/ops/msm.py:msm_naive, reaching pallas_curve.py's
// _add_inc_kernel and _dbl_kernel), which the ladder replaces.  Scalars are the port's canonical Fr layout, int64 [16, n], 16 bits
// a limb.  Doubling-branch steps are counted into `collisions`.
//
// Both run the redundant formulas of g1.cuh (coordinates in [0, 2p), no
// conditional subtraction inside a product, adds and subs modulo 2p) and
// store canonical limbs once, so the limbs equal the canonical formulas'
// and the stepwise chain's.
//
// Bound: operations.  A finite lane's mixed add is 11 Fp Montgomery
// products (~300 32-bit multiply-adds each) against 5 coordinates and a
// mask byte read and 3 coordinates written (48 bytes a coordinate).  At
// msm_naive's shape (8 to 64 lanes) neither bound describes the work: the
// ladder is one lane's chain from its scalar's leading set bit, a doubling
// a bit below it and a mixed add a set bit below it, so its floor is the
// longest such chain's latency.
//
// Occupancy: ptxas gives the batched entry 220 registers and the ladder
// 226, no spill.  At 2^19 lanes blocks of 128 threads ran faster than 64
// or 256; the ladder's 64-lane rows ran 1% faster as one block of 64 than
// as two of 32 (PERF.md).

#include "g1.cuh"

#define MADD_THREADS 128
#define LADDER_THREADS 64

__global__ void __launch_bounds__(MADD_THREADS)
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

__global__ void __launch_bounds__(LADDER_THREADS)
g1_madd_ladder_kernel(const int64_t *__restrict__ x, const int64_t *__restrict__ y,
                      const uint8_t *__restrict__ inf, const int64_t *__restrict__ scalars,
                      int32_t nbits, int64_t *out_x, int64_t *out_y, int64_t *out_z,
                      int64_t n, unsigned long long *collisions) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp qx, qy;
  load_fp(qx, x, n, i);
  load_fp(qy, y, n, i);
  const bool finite = !inf[i];
  Jac acc;
  fp_set_zero(acc.x);
  fp_set_zero(acc.y);
  fp_set_zero(acc.z);
  unsigned long long doubled = 0;
  for (int b = nbits - 1; b >= 0; b--) {
    if (b != nbits - 1) g1_dbl_lazy(acc, acc);
    const uint32_t limb = (uint32_t)scalars[(int64_t)(b >> 4) * n + i];
    if (finite && ((limb >> (b & 15)) & 1u)) doubled += g1_madd_lazy(acc, acc, qx, qy);
  }
  g1_reduce(acc);
  store_jac(out_x, out_y, out_z, n, i, acc);
  if (doubled) atomicAdd(collisions, doubled);
}

extern "C" int fk_g1_madd(const void *x1, const void *y1, const void *z1, const void *x2,
                          const void *y2, const void *inf2, void *out_x, void *out_y,
                          void *out_z, int64_t n, void *collisions, void *stream) {
  if (n > 0) {
    g1_madd_kernel<<<blocks_for(n, MADD_THREADS), MADD_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)x1, (const int64_t *)y1, (const int64_t *)z1,
        (const int64_t *)x2, (const int64_t *)y2, (const uint8_t *)inf2,
        (int64_t *)out_x, (int64_t *)out_y, (int64_t *)out_z, n,
        (unsigned long long *)collisions);
  }
  return (int)cudaGetLastError();
}

extern "C" int fk_g1_madd_ladder(const void *x, const void *y, const void *inf,
                                 const void *scalars, int32_t nbits, void *out_x, void *out_y,
                                 void *out_z, int64_t n, void *collisions, void *stream) {
  if (n > 0) {
    g1_madd_ladder_kernel<<<blocks_for(n, LADDER_THREADS), LADDER_THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const int64_t *)x, (const int64_t *)y, (const uint8_t *)inf,
        (const int64_t *)scalars, nbits, (int64_t *)out_x, (int64_t *)out_y,
        (int64_t *)out_z, n, (unsigned long long *)collisions);
  }
  return (int)cudaGetLastError();
}
