// K4 horner_2k: the single point sum over k < K and r < R of 2^k T_{k,r},
// in one launch.
//
// Replaces fourier_tpu/ops/pallas_curve.py:255 horner_2k (acc = 2 acc +
// T_k per residual lane r over a sequential grid of K steps) and the fold
// of the R residual lanes after it (fourier_tpu/ops/msm.py:121 _horner_2k,
// a compact complete-add tree; a second launch in an earlier form).  Term
// k, lane r sits at column k * R + r of the [24, K * R] inputs.
//
// Bound: latency.  The work is a few hundred point operations, far below
// what fills the card (the throughput bound is microseconds); the time is
// the critical path of dependent point operations.  Weighting term k by
// 2^k takes k doublings of something, so at least K - 1 doublings lie on
// any path, and summing K R points at least ceil(log2(K R)) adds.  The
// floor is (K - 1) x 7 + adds x 16 product latencies (a doubling is 7
// products, an add 16), with one thread's product latency as PERF.md
// measures it (1.9 us on an H100): ~0.5 ms at K = 16, R = 64 and ~3.9 ms
// at K = 260, R = 32 for this design's path below.  A chain of K - 1
// (doubling, add) steps a lane, then a fold of the lanes, puts K - 1 more
// adds on the path.
//
// Design, for the critical path:
//   1. block b takes the run of TPB consecutive terms from k0 = b TPB (TPB
//      = H4_LANES / Rp, Rp = R rounded up to a power of two) and loads its
//      Rp lanes a term into shared memory (identities past R);
//   2. each term's lanes are folded by a halving tree, lane i taking lane
//      i + half (log2 Rp adds);
//   3. thread t doubles folded term k0 + t, k0 + t times, in redundant
//      form (g1.cuh g1_dbl_n): every term carries its full weight 2^k, so
//      no doubling waits for another term and the longest chain is K - 1;
//   4. the block's weighted terms are summed by an adjacent-pair tree:
//      at step s = 1, 2, 4, ... term 2js takes term 2js + s, and a term
//      with no partner passes;
//   5. the block's partial (carrying its 2^k0 weight) goes to `partials`;
//      the last block to arrive (a __threadfence, then an atomic counter)
//      sums the partials with the same adjacent-pair tree, which continues
//      step 4's tree across blocks, and writes the one point.
// So the path is log2 Rp + log2 TPB + log2(blocks) adds and K - 1
// doublings.  The additions are complete; lanes that take the doubling
// branch (same-point pairs) are counted into `collisions`.  The plain twin
// kernels.horner_2k_plain computes the same order, so the limbs agree.

#include "g1.cuh"

// Points a block keeps in shared memory, and its threads (the fold's
// first level is H4_LANES / 2 adds).  H4_LANES is also ops/kernels.py's.
#define H4_LANES 256
#define H4_THREADS 128
#define H4_POINT_WORDS (3 * FP_WORDS)

// Shared lanes: word w of lane i at w * H4_LANES + i.
__device__ __forceinline__ void h4_store(uint32_t *s, int i, const Jac &p) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    s[j * H4_LANES + i] = p.x.w[j];
    s[(FP_WORDS + j) * H4_LANES + i] = p.y.w[j];
    s[(2 * FP_WORDS + j) * H4_LANES + i] = p.z.w[j];
  }
}

__device__ __forceinline__ void h4_load(Jac &p, const uint32_t *s, int i) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    p.x.w[j] = s[j * H4_LANES + i];
    p.y.w[j] = s[(FP_WORDS + j) * H4_LANES + i];
    p.z.w[j] = s[(2 * FP_WORDS + j) * H4_LANES + i];
  }
}

// One step of an adjacent-pair tree over n points at shared lanes j *
// spacing: point 2ks takes point 2ks + s.
__device__ __forceinline__ unsigned long long h4_pair_step(uint32_t *s, int n, int step,
                                                           int spacing) {
  unsigned long long doubled = 0ull;
  for (int j = threadIdx.x; (2 * j + 1) * step < n; j += blockDim.x) {
    Jac p, q;
    h4_load(p, s, 2 * j * step * spacing);
    h4_load(q, s, (2 * j + 1) * step * spacing);
    doubled += g1_add(p, p, q);
    h4_store(s, 2 * j * step * spacing, p);
  }
  return doubled;
}

__global__ void __launch_bounds__(H4_THREADS)
horner_2k_kernel(const int64_t *__restrict__ tx, const int64_t *__restrict__ ty,
                 const int64_t *__restrict__ tz, int64_t n_terms, int64_t width, int32_t rp,
                 int32_t tpb, uint32_t *partials, unsigned int *arrived, int64_t *out_x,
                 int64_t *out_y, int64_t *out_z, unsigned long long *collisions) {
  __shared__ uint32_t smem[H4_POINT_WORDS * H4_LANES];
  __shared__ bool is_last;
  const int64_t k0 = (int64_t)blockIdx.x * tpb;
  const int nk = n_terms - k0 < tpb ? (int)(n_terms - k0) : tpb;
  const int64_t stride = n_terms * width;
  unsigned long long doubled = 0ull;

  for (int i = threadIdx.x; i < nk * rp; i += blockDim.x) {
    const int t = i / rp, r = i % rp;
    Jac v;
    if (r < width) {
      load_jac(v, tx, ty, tz, stride, (k0 + t) * width + r);
    } else {
      fp_set_zero(v.x);
      fp_set_zero(v.y);
      fp_set_zero(v.z);
    }
    h4_store(smem, i, v);
  }
  __syncthreads();

  for (int half = rp >> 1; half > 0; half >>= 1) {
    for (int i = threadIdx.x; i < nk * half; i += blockDim.x) {
      const int l = (i / half) * rp + i % half;
      Jac p, q;
      h4_load(p, smem, l);
      h4_load(q, smem, l + half);
      doubled += g1_add(p, p, q);
      h4_store(smem, l, p);
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < nk; t += blockDim.x) {
    Jac v;
    h4_load(v, smem, t * rp);
    g1_dbl_n(v, (int)(k0 + t));
    h4_store(smem, t * rp, v);
  }
  __syncthreads();

  for (int s = 1; s < nk; s <<= 1) {
    doubled += h4_pair_step(smem, nk, s, rp);
    __syncthreads();
  }

  if (gridDim.x > 1) {
    if (threadIdx.x == 0) {
      for (int w = 0; w < H4_POINT_WORDS; w++)
        partials[(int64_t)w * gridDim.x + blockIdx.x] = smem[w * H4_LANES];
      __threadfence();
      is_last = atomicAdd(arrived, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (is_last) {
      __threadfence();
      const int n = (int)gridDim.x;
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        for (int w = 0; w < H4_POINT_WORDS; w++)
          smem[w * H4_LANES + i] = __ldcg(&partials[(int64_t)w * n + i]);
      __syncthreads();
      for (int s = 1; s < n; s <<= 1) {
        doubled += h4_pair_step(smem, n, s, 1);
        __syncthreads();
      }
    }
  }
  if ((gridDim.x == 1 || is_last) && threadIdx.x == 0) {
    Jac v;
    h4_load(v, smem, 0);
    store_jac(out_x, out_y, out_z, 1, 0, v);
  }
  if (doubled) atomicAdd(collisions, doubled);
}

// scratch: (blocks x 36 + 1) 32-bit words, the partials then the arrival
// counter.  The plan (rp, tpb, blocks) is ops/kernels.py horner_plan's.
extern "C" int fk_horner_2k(const void *tx, const void *ty, const void *tz, int64_t n_terms,
                            int64_t width, int32_t rp, int32_t tpb, void *scratch,
                            void *out_x, void *out_y, void *out_z, void *collisions,
                            void *stream) {
  if (n_terms < 1 || width < 1 || rp < width || rp > H4_LANES || (rp & (rp - 1)) ||
      tpb * rp != H4_LANES)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_terms + tpb - 1) / tpb;
  if (blocks > H4_LANES) return (int)cudaErrorInvalidValue;
  uint32_t *partials = (uint32_t *)scratch;
  unsigned int *arrived = (unsigned int *)(partials + blocks * H4_POINT_WORDS);
  cudaError_t rc = cudaMemsetAsync(arrived, 0, sizeof(unsigned int), (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  horner_2k_kernel<<<(unsigned int)blocks, H4_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t *)tx, (const int64_t *)ty, (const int64_t *)tz, n_terms, width, rp, tpb,
      partials, arrived, (int64_t *)out_x, (int64_t *)out_y, (int64_t *)out_z,
      (unsigned long long *)collisions);
  return (int)cudaGetLastError();
}
