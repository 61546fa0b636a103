// K1 accumulate: bucket accumulation by runs of table rows.
//
// Replaces fourier_tpu/ops/msm_fused.py:_accum_kernel (the slab kernel of
// the BGMW and tableless MSMs) and fourier_tpu/ops/pallas_curve.py:
// _madd_inc_kernel (the per-window mixed adds of the fixed-base setup MSM).
//
// Slot s starts from the identity and mixed-adds, in order, the table rows named by index[start[s] ..
// start[s] + count[s]).  An index entry is (row << 2) | (negate << 1) |
// infinity: infinity rows leave the sum unchanged, negated rows add
// (x, p - y).  The slot's sum is written once.  The addition is complete
// (the doubling branch is taken per thread), so the TPU's collision flag
// and its complete-formula rerun have no counterpart; doubling lanes are
// only counted into `collisions`.
//
// Bound: integer multiply throughput.  Each step reads one 96-byte row
// and spends ~11 Fp Montgomery products (~150 32-bit multiply-adds each)
// on it, far above the card's bytes-per-operation balance.
//
// Left for later: one thread walks a whole run, so the slowest slot sets
// the time and occupancy is bounded by register pressure; a warp-wide
// Fp product (limbs across lanes), runs split across threads with a
// second reduction pass, and cp.async prefetch of the next rows.

#include "g1.cuh"

__global__ void __launch_bounds__(128)
accumulate_kernel(const uint32_t *__restrict__ table, const int32_t *__restrict__ index,
                  const int32_t *__restrict__ start, const int32_t *__restrict__ count,
                  int64_t n_slots, int64_t *out_x, int64_t *out_y, int64_t *out_z,
                  unsigned long long *collisions) {
  int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  Jac acc;
  fp_set_zero(acc.x);
  fp_set_zero(acc.y);
  fp_set_zero(acc.z);
  const int32_t first = start[s];
  const int32_t n = count[s];
  unsigned long long doubled = 0ull;
  for (int32_t k = 0; k < n; k++) {
    const uint32_t e = (uint32_t)index[first + k];
    if (e & 1u) continue;  // point at infinity
    const uint32_t *row = table + (int64_t)(e >> 2) * (2 * FP_WORDS);
    Fp qx, qy;
#pragma unroll
    for (int j = 0; j < FP_WORDS; j++) {
      qx.w[j] = row[j];
      qy.w[j] = row[FP_WORDS + j];
    }
    if (e & 2u) fp_neg(qy, qy);
    doubled += g1_madd(acc, acc, qx, qy);
  }
  if (doubled) atomicAdd(collisions, doubled);
  store_jac(out_x, out_y, out_z, n_slots, s, acc);
}

extern "C" int fk_accumulate(const void *table, const void *index, const void *start,
                             const void *count, int64_t n_slots, void *out_x,
                             void *out_y, void *out_z, void *collisions, void *stream) {
  if (n_slots > 0) {
    accumulate_kernel<<<blocks_for(n_slots, 128), 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)table, (const int32_t *)index, (const int32_t *)start,
        (const int32_t *)count, n_slots, (int64_t *)out_x, (int64_t *)out_y,
        (int64_t *)out_z, (unsigned long long *)collisions);
  }
  return (int)cudaGetLastError();
}
