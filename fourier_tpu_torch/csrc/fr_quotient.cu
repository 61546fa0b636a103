// The evaluation-form quotient of a workerOpen, in four launches:
//
//   y      = (alpha^T - 1)/T * sum_j f_j w^j / (alpha - w^j)
//   q(w^j) = (y - f_j) / (alpha - w^j)
//
// for the Lagrange values f_j of B rows on the domain w^0..w^(T-1) and a
// point alpha, all Fr in Montgomery form.  The rows share one batch
// inversion of d_j = alpha - w^j; a lane with d_j = 0 (alpha on the
// domain) inverts to 0 and raises the flag that sends worker_open to its
// coefficient-basis fallback.  The function and the outputs are those of
// ops/kernels.py fr_quotient_plain, the plain tensor code before it.
//
// Replaces no Pallas kernel: the JAX package's _eval_form_open
// (fourier_tpu/models/piano.py:485) is plain jnp that XLA fuses, and this
// is the port's counterpart of that fusion.  Done with tensor ops, the
// quotient took ~35,000 launches an open, and the host's launch rate set
// its time.
//
// Bound: operations.  The 4 + 2B Fr products a lane (4 for the
// inversion's way up and down, one a row for the sum and one for q; 136
// 32-bit multiply-adds each) take ~0.026 ms at T = 2^19 x 1 and at
// 2^18 x 4 at the card's int32 peak; the bytes the function needs (f and
// the roots read, q written, 32 B an element) take ~0.015 and ~0.023 ms at
// 3.35 TB/s (the int64 limbs the port moves are 4x that).  The design spreads the
// products over every lane (neighbouring threads on neighbouring lanes,
// coalesced), reads each int64 operand only in the kernels that need it
// and keeps its scratch in 32-bit words.  The one serial part is the
// inversion: each block inverts its own product by Fermat (~420 dependent
// products), all blocks at once, so the latency floor is one block's chain;
// it, not the products or the bytes, holds the four kernels at ~0.53 ms at
// 2^19 (PERF.md §6).
//
// Kernels (QT_THREADS threads a block; run of QT_RUN lanes a thread, lane
// j = block * QT_THREADS * QT_RUN + i * QT_THREADS + t for i < QT_RUN, so
// neighbouring threads touch neighbouring lanes):
// 1. fr_quotient_inv: d_j and the run's prefix products on the way up; a
//    Hillis-Steele product scan of the runs' totals each way over the
//    block; the last thread inverts the block's total; each run's inverse
//    from the scans; on the way down each lane's 1/d_j, and w^j / d_j.
//    Per block, whether some d_j was 0.
// 2. fr_quotient_sum: sum over lanes of f_j * (w^j / d_j), a partial per
//    row and block of QT_THREADS * QT_RUN lanes.
// 3. fr_quotient_eval (one block): alpha^T, each row's sum of partials
//    and y; the flags OR-ed into one word.
// 4. fr_quotient_qhat: q_j = (y - f_j) * (1 / d_j) for every row and lane.

#include "fr.cuh"

#define QT_THREADS 256
#define QT_RUN 16

static inline unsigned int qt_blocks(int64_t n, int64_t per_block) {
  return (unsigned int)((n + per_block - 1) / per_block);
}

__device__ __forceinline__ void sh_load(Fr &r, const uint32_t (*sh)[QT_THREADS], int t) {
#pragma unroll
  for (int k = 0; k < FR_WORDS; k++) r.w[k] = sh[k][t];
}

__device__ __forceinline__ void sh_store(uint32_t (*sh)[QT_THREADS], int t, const Fr &a) {
#pragma unroll
  for (int k = 0; k < FR_WORDS; k++) sh[k][t] = a.w[k];
}

// inv: scratch rows 0-7 hold the run's prefix products on the way up and
// 1/d_j after; rows 8-15 hold d_j, then w^j / d_j (both [8, T] words).
__global__ void __launch_bounds__(QT_THREADS)
fr_quotient_inv_kernel(const int64_t *__restrict__ roots, const int64_t *__restrict__ alpha_l,
                       int64_t T, uint32_t *pre, uint32_t *dd, int32_t *flags) {
  __shared__ uint32_t pre_sh[FR_WORDS][QT_THREADS];
  __shared__ uint32_t suf_sh[FR_WORDS][QT_THREADS];
  __shared__ Fr inv_total;
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * QT_THREADS * QT_RUN + t;
  Fr alpha, acc;
  load_fr(alpha, alpha_l, 1, 0);
  fr_set_one(acc);
  int zero = 0;
#pragma unroll 1
  for (int i = 0; i < QT_RUN; i++) {
    const int64_t j = base + (int64_t)i * QT_THREADS;
    if (j >= T) break;
    Fr w, d;
    load_fr(w, roots, T, j);
    fr_sub(d, alpha, w);
    store_words(dd, T, j, d);
    store_words(pre, T, j, acc);
    if (fr_is_zero(d)) zero = 1;            // a zero lane counts as 1
    else acc = fr_mul_call(acc, d);
  }
  // inclusive scans of the runs' totals, from the left and from the right
  Fr lo = acc, hi = acc;
  sh_store(pre_sh, t, lo);
  sh_store(suf_sh, t, hi);
  __syncthreads();
#pragma unroll 1
  for (int off = 1; off < QT_THREADS; off <<= 1) {
    Fr x;
    if (t >= off) {
      sh_load(x, pre_sh, t - off);
      lo = fr_mul_call(x, lo);
    }
    if (t + off < QT_THREADS) {
      sh_load(x, suf_sh, t + off);
      hi = fr_mul_call(hi, x);
    }
    __syncthreads();
    sh_store(pre_sh, t, lo);
    sh_store(suf_sh, t, hi);
    __syncthreads();
  }
  if (t == QT_THREADS - 1) inv_total = fr_inv(lo);   // lo: the block's whole product
  __syncthreads();
  // 1 / (run total) = 1 / (block total) * (runs left of t) * (runs right of t)
  Fr inv_acc = inv_total, x;
  if (t > 0) {
    sh_load(x, pre_sh, t - 1);
    inv_acc = fr_mul_call(inv_acc, x);
  }
  if (t + 1 < QT_THREADS) {
    sh_load(x, suf_sh, t + 1);
    inv_acc = fr_mul_call(inv_acc, x);
  }
  int any = __syncthreads_or(zero);
  if (t == 0) flags[blockIdx.x] = any;
#pragma unroll 1
  for (int i = QT_RUN - 1; i >= 0; i--) {
    const int64_t j = base + (int64_t)i * QT_THREADS;
    if (j >= T) continue;
    Fr d, p, inv, wi;
    load_words(d, dd, T, j);
    load_words(p, pre, T, j);
    if (fr_is_zero(d)) {
      fr_set_zero(inv);
      fr_set_zero(wi);
    } else {
      inv = fr_mul_call(inv_acc, p);
      inv_acc = fr_mul_call(inv_acc, d);
      Fr w;
      fr_sub(w, alpha, d);                  // w^j = alpha - d_j
      wi = fr_mul_call(w, inv);
    }
    store_words(pre, T, j, inv);
    store_words(dd, T, j, wi);
  }
}

// sum: partials [8, B * blocks] words, row b's partial of block k at
// b * blocks + k; f is [16, B * T] limbs, row b's lane j at b * T + j.
__global__ void __launch_bounds__(QT_THREADS)
fr_quotient_sum_kernel(const int64_t *__restrict__ f, const uint32_t *__restrict__ wi,
                       int64_t T, int64_t B, uint32_t *partials) {
  __shared__ uint32_t sh[FR_WORDS][QT_THREADS];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t base = (int64_t)blockIdx.x * QT_THREADS * QT_RUN + t;
  Fr acc;
  fr_set_zero(acc);
#pragma unroll 1
  for (int i = 0; i < QT_RUN; i++) {
    const int64_t j = base + (int64_t)i * QT_THREADS;
    if (j >= T) break;
    Fr fj, x;
    load_fr(fj, f + b * T, B * T, j);
    load_words(x, wi, T, j);
    fr_add(acc, acc, fr_mul_call(fj, x));
  }
  sh_store(sh, t, acc);
  __syncthreads();
#pragma unroll 1
  for (int h = QT_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) {
      Fr x;
      sh_load(x, sh, t + h);
      fr_add(acc, acc, x);
      sh_store(sh, t, acc);
    }
    __syncthreads();
  }
  if (t == 0) store_words(partials, B * gridDim.x, b * gridDim.x + blockIdx.x, acc);
}

// eval: one block.  y [16, B] limbs; any_zero[0] = whether some block of
// the inversion met d_j = 0.
__global__ void __launch_bounds__(QT_THREADS)
fr_quotient_eval_kernel(const int64_t *__restrict__ alpha_l, const int64_t *__restrict__ t_inv_l,
                        const uint32_t *__restrict__ partials, const int32_t *__restrict__ flags,
                        int64_t T, int64_t B, int64_t blocks, int64_t *y, int32_t *any_zero) {
  __shared__ Fr factor;
  const int t = threadIdx.x;
  if (t == 0) {
    // (alpha^T - 1) * t_inv, alpha^T by square and multiply from T's top bit
    Fr alpha, a, one, ti;
    load_fr(alpha, alpha_l, 1, 0);
    load_fr(ti, t_inv_l, 1, 0);
    a = alpha;
#pragma unroll 1
    for (int bit = 62 - __clzll(T); bit >= 0; bit--) {
      a = fr_mul_call(a, a);
      if ((T >> bit) & 1) a = fr_mul_call(a, alpha);
    }
    fr_set_one(one);
    fr_sub(a, a, one);
    factor = fr_mul_call(a, ti);
  }
  int zero = 0;
  for (int64_t k = t; k < blocks; k += QT_THREADS) zero |= flags[k];
  zero = __syncthreads_or(zero);
  if (t == 0) any_zero[0] = zero;
  for (int64_t b = t; b < B; b += QT_THREADS) {
    Fr s, x;
    fr_set_zero(s);
#pragma unroll 1
    for (int64_t k = 0; k < blocks; k++) {
      load_words(x, partials, B * blocks, b * blocks + k);
      fr_add(s, s, x);
    }
    store_fr(y, B, b, fr_mul_call(factor, s));
  }
}

// qhat: one thread a lane of one row (grid: lanes, rows), q [16, B * T]
// limbs.
__global__ void __launch_bounds__(QT_THREADS)
fr_quotient_qhat_kernel(const int64_t *__restrict__ f, const uint32_t *__restrict__ inv,
                        const int64_t *__restrict__ y, int64_t T, int64_t B, int64_t *q) {
  const int64_t j = (int64_t)blockIdx.x * QT_THREADS + threadIdx.x;
  if (j >= T) return;
  const int64_t b = blockIdx.y, n = B * T;
  Fr yb, fj, x, d;
  load_fr(yb, y, B, b);
  load_fr(fj, f + b * T, n, j);
  load_words(x, inv, T, j);
  fr_sub(d, yb, fj);
  fr_mul(d, d, x);
  store_fr(q + b * T, n, j, d);
}

extern "C" int fk_fr_quotient_inv(const void *roots, const void *alpha, int64_t T, void *pre,
                                  void *dd, void *flags, void *stream) {
  if (T > 0) {
    fr_quotient_inv_kernel<<<qt_blocks(T, QT_THREADS * QT_RUN), QT_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const int64_t *)roots, (const int64_t *)alpha, T, (uint32_t *)pre, (uint32_t *)dd,
        (int32_t *)flags);
  }
  return (int)cudaGetLastError();
}

extern "C" int fk_fr_quotient_sum(const void *f, const void *wi, int64_t T, int64_t B,
                                  void *partials, void *stream) {
  if (T > 0 && B > 0) {
    dim3 grid(qt_blocks(T, QT_THREADS * QT_RUN), (unsigned int)B);
    fr_quotient_sum_kernel<<<grid, QT_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)f, (const uint32_t *)wi, T, B, (uint32_t *)partials);
  }
  return (int)cudaGetLastError();
}

extern "C" int fk_fr_quotient_eval(const void *alpha, const void *t_inv, const void *partials,
                                   const void *flags, int64_t T, int64_t B, void *y,
                                   void *any_zero, void *stream) {
  if (T > 0) {
    const int64_t blocks = qt_blocks(T, QT_THREADS * QT_RUN);
    fr_quotient_eval_kernel<<<1, QT_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)alpha, (const int64_t *)t_inv, (const uint32_t *)partials,
        (const int32_t *)flags, T, B, blocks, (int64_t *)y, (int32_t *)any_zero);
  }
  return (int)cudaGetLastError();
}

extern "C" int fk_fr_quotient_qhat(const void *f, const void *inv, const void *y, int64_t T,
                                   int64_t B, void *q, void *stream) {
  if (T > 0 && B > 0) {
    dim3 grid(qt_blocks(T, QT_THREADS), (unsigned int)B);
    fr_quotient_qhat_kernel<<<grid, QT_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)f, (const uint32_t *)inv, (const int64_t *)y, T, B, (int64_t *)q);
  }
  return (int)cudaGetLastError();
}

// Blocks of the inversion and of the sums over T lanes: the length of the
// flags and, times B, of the partials that the caller allocates.
extern "C" int64_t fk_fr_quotient_blocks(int64_t T) {
  return qt_blocks(T, QT_THREADS * QT_RUN);
}
