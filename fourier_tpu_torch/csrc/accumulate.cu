// K1 accumulate: bucket accumulation by runs of table rows.
//
// Replaces fourier_tpu/ops/msm_fused.py:_accum_kernel (the slab kernel of
// the BGMW and tableless MSMs) and fourier_tpu/ops/pallas_curve.py:
// _madd_inc_kernel (the per-window mixed adds of the fixed-base setup MSM).
//
// Slot s sums the table rows named by index[start[s] .. start[s] +
// count[s]).  An index entry is (row << 2) | (negate << 1) | infinity:
// infinity rows leave the sum unchanged, negated rows add (x, p - y).
// The additions are complete (the doubling branch is taken per thread), so
// the TPU's collision flag and its complete-formula rerun have no
// counterpart; doubling lanes are only counted into `collisions`.
//
// Bound: integer multiply throughput.  Each row costs one mixed add (11 Fp
// Montgomery products) against 96 bytes read, far above the card's
// bytes-per-operation balance.  What holds it back is latency: a thread's
// adds are one dependent chain, and the registers a mixed add needs leave
// an SM few warps to hide it.  So each run is split into pieces of at most
// `piece` rows:
//
//   pass 1, one thread per piece: the piece's rows mixed-added in run order
//     from the identity, written as a Jacobian point to `partial`;
//   pass 2, one thread per slot: the slot's piece sums added in piece order
//     with the complete Jacobian add, written once as int64 [24, S] limbs.
//
// A run of at most `piece` rows is one piece, and its sum is the whole-run
// sum limb for limb; a longer run gives the same group element associated
// otherwise.  Pass 1 copies each row as six 16-byte asynchronous copies
// into shared memory and starts the next row's copy (and the load of the
// index entry after it) before the current add, so the gather's latency
// hides behind the arithmetic without holding the row in registers; its
// registers are capped so that ACC_MIN_BLOCKS blocks fit an SM (PERF.md
// gives the caps measured on an H100).
//
// Pieces are numbered slot by slot: piece_end is the inclusive cumulative
// sum of ceil(count / piece) over the slots.  The runs must be disjoint
// ranges of index, which bounds the pieces by ceil(len(index) / piece) +
// S, the width of `partial` (`max_pieces`); threads past the last piece
// find no slot and exit.

#include <cuda_pipeline.h>

#include "g1.cuh"

#define ACC_THREADS 128
// Blocks of ACC_THREADS an SM must fit: a cap on pass 1's registers per
// thread, so more warps hide the latency of the product chains.  With the
// out-of-line products of g1.cuh pass 1 needs 238 registers; a cap of 3
// blocks (168) spills and ran slower (PERF.md).
#define ACC_MIN_BLOCKS 2

// A Jacobian point as 36 words, word j of item i at j * stride + i.
__device__ __forceinline__ void store_packed(uint32_t *dst, int64_t stride, int64_t i,
                                             const Jac &p) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    dst[j * stride + i] = p.x.w[j];
    dst[(FP_WORDS + j) * stride + i] = p.y.w[j];
    dst[(2 * FP_WORDS + j) * stride + i] = p.z.w[j];
  }
}

__device__ __forceinline__ void load_packed(Jac &p, const uint32_t *src, int64_t stride,
                                            int64_t i) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    p.x.w[j] = src[j * stride + i];
    p.y.w[j] = src[(FP_WORDS + j) * stride + i];
    p.z.w[j] = src[(2 * FP_WORDS + j) * stride + i];
  }
}

// Starts the copy of one 96-byte table row (x, then y) into this thread's
// shared-memory slots dst[j][threadIdx.x], six 16-byte asynchronous copies,
// and commits them as one group.
__device__ __forceinline__ void fetch_row(uint4 (*dst)[ACC_THREADS], const uint32_t *table,
                                          uint32_t e) {
  const uint4 *row = reinterpret_cast<const uint4 *>(table + (int64_t)(e >> 2) * (2 * FP_WORDS));
#pragma unroll
  for (int j = 0; j < 6; j++) __pipeline_memcpy_async(&dst[j][threadIdx.x], row + j, 16);
  __pipeline_commit();
}

__device__ __forceinline__ void row_words(Fp &qx, Fp &qy, const uint4 (*src)[ACC_THREADS]) {
#pragma unroll
  for (int j = 0; j < 3; j++) {
    const uint4 a = src[j][threadIdx.x], b = src[3 + j][threadIdx.x];
    qx.w[4 * j] = a.x;
    qx.w[4 * j + 1] = a.y;
    qx.w[4 * j + 2] = a.z;
    qx.w[4 * j + 3] = a.w;
    qy.w[4 * j] = b.x;
    qy.w[4 * j + 1] = b.y;
    qy.w[4 * j + 2] = b.z;
    qy.w[4 * j + 3] = b.w;
  }
}

__global__ void __launch_bounds__(ACC_THREADS, ACC_MIN_BLOCKS)
accumulate_pieces_kernel(const uint32_t *__restrict__ table, const int32_t *__restrict__ index,
                         const int32_t *__restrict__ start, const int32_t *__restrict__ count,
                         const int32_t *__restrict__ piece_end, int64_t n_slots, int32_t piece,
                         int64_t max_pieces, uint32_t *partial,
                         unsigned long long *collisions) {
  // two row buffers a thread, word-major so a warp's 16-byte reads do not
  // conflict: row k of the piece lands in rows[k & 1]
  __shared__ uint4 rows[2][6][ACC_THREADS];
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= max_pieces) return;
  int64_t lo = 0, hi = n_slots;  // the slot: the first s with piece_end[s] > p
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (piece_end[mid] > p) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  if (lo >= n_slots) return;
  const int32_t off = (int32_t)(p - (lo ? piece_end[lo - 1] : 0)) * piece;
  const int32_t *run = index + start[lo] + off;
  const int32_t n = min(piece, count[lo] - off);

  Jac acc;
  fp_set_zero(acc.x);
  fp_set_zero(acc.y);
  fp_set_zero(acc.z);
  unsigned long long doubled = 0ull;
  // Row k is in flight (or arrived) when step k starts; its index entry is
  // e_cur, the next one's e_next.  Every step commits one copy group (empty
  // for an infinity row or past the run), so waiting for all but the
  // newest group means row k has arrived.
  uint32_t e_cur = (uint32_t)run[0];
  uint32_t e_next = n > 1 ? (uint32_t)run[1] : 1u;
  if (!(e_cur & 1u)) {
    fetch_row(rows[0], table, e_cur);
  } else {
    __pipeline_commit();
  }
  for (int32_t k = 0; k < n; k++) {
    if (k + 1 < n && !(e_next & 1u)) {
      fetch_row(rows[(k + 1) & 1], table, e_next);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    const uint32_t e = e_cur;
    e_cur = e_next;
    e_next = k + 2 < n ? (uint32_t)run[k + 2] : 1u;
    if (e & 1u) continue;  // point at infinity
    Fp qx, qy;
    row_words(qx, qy, rows[k & 1]);
    if (e & 2u) fp_neg(qy, qy);
    doubled += g1_madd(acc, acc, qx, qy);
  }
  if (doubled) atomicAdd(collisions, doubled);
  store_packed(partial, max_pieces, p, acc);
}

__global__ void __launch_bounds__(ACC_THREADS)
accumulate_slots_kernel(const uint32_t *__restrict__ partial, int64_t max_pieces,
                        const int32_t *__restrict__ piece_end, int64_t n_slots, int64_t *out_x,
                        int64_t *out_y, int64_t *out_z, unsigned long long *collisions) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const int64_t first = s ? piece_end[s - 1] : 0;
  const int64_t last = piece_end[s];
  Jac acc;
  unsigned long long doubled = 0ull;
  if (first == last) {
    fp_set_zero(acc.x);
    fp_set_zero(acc.y);
    fp_set_zero(acc.z);
  } else {
    load_packed(acc, partial, max_pieces, first);
    for (int64_t q = first + 1; q < last; q++) {
      Jac t;
      load_packed(t, partial, max_pieces, q);
      doubled += g1_add(acc, acc, t);
    }
  }
  if (doubled) atomicAdd(collisions, doubled);
  store_jac(out_x, out_y, out_z, n_slots, s, acc);
}

extern "C" int fk_accumulate(const void *table, const void *index, const void *start,
                             const void *count, const void *piece_end, int64_t n_slots,
                             int32_t piece, int64_t max_pieces, void *partial, void *out_x,
                             void *out_y, void *out_z, void *collisions, void *stream) {
  if (n_slots > 0) {
    accumulate_pieces_kernel<<<blocks_for(max_pieces, ACC_THREADS), ACC_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const uint32_t *)table, (const int32_t *)index, (const int32_t *)start,
        (const int32_t *)count, (const int32_t *)piece_end, n_slots, piece, max_pieces,
        (uint32_t *)partial, (unsigned long long *)collisions);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    accumulate_slots_kernel<<<blocks_for(n_slots, ACC_THREADS), ACC_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t *)partial, max_pieces, (const int32_t *)piece_end, n_slots,
        (int64_t *)out_x, (int64_t *)out_y, (int64_t *)out_z,
        (unsigned long long *)collisions);
  }
  return (int)cudaGetLastError();
}
