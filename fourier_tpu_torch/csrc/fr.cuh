// Device code of the Fr kernels: BLS12-381 scalar-field arithmetic.
//
// Fr elements are 8 x 32-bit little-endian words in Montgomery form with
// radix 2^256, the radix of the reference's 16 x 16-bit limbs, so every
// Montgomery value here equals the reference's as an integer.  Every
// operation takes canonical values (< r) and returns canonical values: r
// is 255 bits, so 2r < 2^256 but 4r > 2^256, and the redundant [0, 2p)
// form of g1.cuh has no Fr counterpart; a product of canonical inputs is
// below 2r and ends in one conditional subtraction.  Canonical results
// are unique, so any association of the same products and sums gives the
// limbs of ops/field.py's Field.
//
// The tensors the kernels read and write as field elements hold the
// reference layout: int64 [16, n], limb k of lane i at k * stride + i,
// 16 bits per limb.  Scratch tensors hold words: int32 [8, n], word k of
// lane i at k * stride + i.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FR_WORDS 8

// r, 2^256 mod r (Montgomery one) and r - 2 (the Fermat exponent), low
// word first; -r^-1 mod 2^32.
static __constant__ uint32_t FR_P[FR_WORDS] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
static __constant__ uint32_t FR_ONE[FR_WORDS] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
static __constant__ uint32_t FR_EXP_INV[FR_WORDS] = {
    0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
#define FR_NINV 0xffffffffu

struct Fr {
  uint32_t w[FR_WORDS];
};

__device__ __forceinline__ void fr_set_zero(Fr &r) {
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) r.w[j] = 0u;
}

__device__ __forceinline__ void fr_set_one(Fr &r) {
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) r.w[j] = FR_ONE[j];
}

__device__ __forceinline__ bool fr_is_zero(const Fr &a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) acc |= a.w[j];
  return acc == 0u;
}

// t := t - r when t >= r (t < 2r).
__device__ __forceinline__ void fr_reduce_once(uint32_t *t) {
  uint32_t d[FR_WORDS];
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) {
    uint64_t s = (uint64_t)t[j] - FR_P[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  if (!borrow) {
#pragma unroll
    for (int j = 0; j < FR_WORDS; j++) t[j] = d[j];
  }
}

// a + b mod r; a + b < 2r < 2^256 never carries out.
__device__ __forceinline__ void fr_add(Fr &r, const Fr &a, const Fr &b) {
  uint32_t t[FR_WORDS];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) {
    uint64_t s = (uint64_t)a.w[j] + b.w[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  fr_reduce_once(t);
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) r.w[j] = t[j];
}

// a - b mod r: r is added back when a < b (the carry out cancels the wrap).
__device__ __forceinline__ void fr_sub(Fr &r, const Fr &a, const Fr &b) {
  uint32_t t[FR_WORDS];
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) {
    uint64_t s = (uint64_t)a.w[j] - b.w[j] - borrow;
    t[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FR_WORDS; j++) {
      uint64_t s = (uint64_t)t[j] + FR_P[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
  }
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) r.w[j] = t[j];
}

// Montgomery product a * b / 2^256 mod r, word-serial CIOS (the 8-word
// form of g1.cuh's fp_mul_lazy): for a, b < r the value (a b + M r) /
// 2^256 is < 2r < 2^256, so t[8] ends at zero, and one conditional
// subtraction makes it canonical.  2 * 64 + 8 word multiply-adds.
__device__ __forceinline__ void fr_mul(Fr &r, const Fr &a, const Fr &b) {
  uint32_t t[FR_WORDS + 2];
#pragma unroll
  for (int j = 0; j < FR_WORDS + 2; j++) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < FR_WORDS; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FR_WORDS; j++) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[FR_WORDS] + c;
    t[FR_WORDS] = (uint32_t)s;
    t[FR_WORDS + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * FR_NINV;
    s = (uint64_t)m * FR_P[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < FR_WORDS; j++) {
      s = (uint64_t)m * FR_P[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[FR_WORDS] + c;
    t[FR_WORDS - 1] = (uint32_t)s;
    t[FR_WORDS] = t[FR_WORDS + 1] + (uint32_t)(s >> 32);
  }
  fr_reduce_once(t);
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) r.w[j] = t[j];
}

// The product as one out-of-line body, for the loops that chain many
// (the Fermat chain, the scans): one copy of its code instead of one a
// call site.
static __device__ __noinline__ Fr fr_mul_call(const Fr a, const Fr b) {
  Fr r;
  fr_mul(r, a, b);
  return r;
}

// a^-1 = a^(r - 2) by Fermat, square and multiply from the exponent's top
// bit (254), Montgomery in and out; a != 0.  A loop, not unrolled: the
// chain is ~420 dependent products and only its latency counts.
__device__ __forceinline__ Fr fr_inv(const Fr &a) {
  Fr acc = a;
#pragma unroll 1
  for (int bit = 253; bit >= 0; bit--) {
    acc = fr_mul_call(acc, acc);
    if ((FR_EXP_INV[bit >> 5] >> (bit & 31)) & 1u) acc = fr_mul_call(acc, a);
  }
  return acc;
}

// -- tensor layout -------------------------------------------------------------

__device__ __forceinline__ void load_fr(Fr &r, const int64_t *src, int64_t stride,
                                        int64_t lane) {
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) {
    uint32_t lo = (uint32_t)src[(2 * j) * stride + lane];
    uint32_t hi = (uint32_t)src[(2 * j + 1) * stride + lane];
    r.w[j] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void store_fr(int64_t *dst, int64_t stride, int64_t lane,
                                         const Fr &a) {
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) {
    dst[(2 * j) * stride + lane] = (int64_t)(a.w[j] & 0xffffu);
    dst[(2 * j + 1) * stride + lane] = (int64_t)(a.w[j] >> 16);
  }
}

__device__ __forceinline__ void load_words(Fr &r, const uint32_t *src, int64_t stride,
                                           int64_t lane) {
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) r.w[j] = src[j * stride + lane];
}

__device__ __forceinline__ void store_words(uint32_t *dst, int64_t stride, int64_t lane,
                                            const Fr &a) {
#pragma unroll
  for (int j = 0; j < FR_WORDS; j++) dst[j * stride + lane] = a.w[j];
}
