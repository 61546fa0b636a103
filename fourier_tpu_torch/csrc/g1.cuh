// Shared device code of the G1 kernels: BLS12-381 Fp arithmetic and the
// complete point formulas.
//
// Fp elements are 12 x 32-bit little-endian words in Montgomery form with
// radix 2^384, the radix of the reference's 24 x 16-bit limbs, so every
// Montgomery value here equals the reference's as an integer.  All
// arithmetic is canonical (values < p after every operation); a point
// operation therefore returns exactly the limbs of the reference's
// complete formulas (fourier_tpu/ops/curve.py _dbl_impl, _add_impl,
// _madd_impl): same algebra, same select order for identity operands.
//
// The tensors the kernels read and write hold the reference layout:
// int64 [24, B], limb k of lane i at k * stride + i, 16 bits per limb.
// The packed point table holds one affine point per 96-byte row: 12 words
// of x, then 12 words of y.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FP_WORDS 12
#define FP_LIMBS16 24

// p, 2^384 mod p (Montgomery one) and -p^-1 mod 2^32, low word first.
static __constant__ uint32_t FP_P[FP_WORDS] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
static __constant__ uint32_t FP_ONE[FP_WORDS] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
#define FP_NINV 0xfffcfffdu

struct Fp {
  uint32_t w[FP_WORDS];
};

struct Jac {
  Fp x, y, z;
};

// -- Fp ----------------------------------------------------------------------

__device__ __forceinline__ void fp_set_zero(Fp &r) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = 0u;
}

__device__ __forceinline__ void fp_set_one(Fp &r) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = FP_ONE[j];
}

__device__ __forceinline__ bool fp_is_zero(const Fp &a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) acc |= a.w[j];
  return acc == 0u;
}

// t := t - p when t >= p (t < 2p).
__device__ __forceinline__ void fp_reduce_once(uint32_t *t) {
  uint32_t d[FP_WORDS];
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    uint64_t s = (uint64_t)t[j] - FP_P[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  if (!borrow) {
#pragma unroll
    for (int j = 0; j < FP_WORDS; j++) t[j] = d[j];
  }
}

__device__ __forceinline__ void fp_add(Fp &r, const Fp &a, const Fp &b) {
  uint32_t t[FP_WORDS];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    uint64_t s = (uint64_t)a.w[j] + b.w[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  fp_reduce_once(t);  // a + b < 2p < 2^384: no carry out
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = t[j];
}

__device__ __forceinline__ void fp_sub(Fp &r, const Fp &a, const Fp &b) {
  uint32_t t[FP_WORDS];
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    uint64_t s = (uint64_t)a.w[j] - b.w[j] - borrow;
    t[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  if (borrow) {  // a < b: add p back (the carry out cancels the wrap)
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FP_WORDS; j++) {
      uint64_t s = (uint64_t)t[j] + FP_P[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
  }
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = t[j];
}

__device__ __forceinline__ void fp_neg(Fp &r, const Fp &a) {
  Fp zero;
  fp_set_zero(zero);
  fp_sub(r, zero, a);
}

// Montgomery product a * b / 2^384 mod p, word-serial CIOS.  With a, b < p
// the pre-reduction value is < 2p < 2^384, so t[12] ends at zero and one
// conditional subtraction makes the result canonical.
__device__ __forceinline__ void fp_mul(Fp &r, const Fp &a, const Fp &b) {
  uint32_t t[FP_WORDS + 2];
#pragma unroll
  for (int j = 0; j < FP_WORDS + 2; j++) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < FP_WORDS; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FP_WORDS; j++) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[FP_WORDS] + c;
    t[FP_WORDS] = (uint32_t)s;
    t[FP_WORDS + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * FP_NINV;
    s = (uint64_t)m * FP_P[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < FP_WORDS; j++) {
      s = (uint64_t)m * FP_P[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[FP_WORDS] + c;
    t[FP_WORDS - 1] = (uint32_t)s;
    t[FP_WORDS] = t[FP_WORDS + 1] + (uint32_t)(s >> 32);
  }
  fp_reduce_once(t);
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = t[j];
}

__device__ __forceinline__ void fp_sqr(Fp &r, const Fp &a) { fp_mul(r, a, a); }

// -- tensor layout -------------------------------------------------------------

__device__ __forceinline__ void load_fp(Fp &r, const int64_t *src, int64_t stride,
                                        int64_t lane) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    uint32_t lo = (uint32_t)src[(2 * j) * stride + lane];
    uint32_t hi = (uint32_t)src[(2 * j + 1) * stride + lane];
    r.w[j] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void store_fp(int64_t *dst, int64_t stride, int64_t lane,
                                         const Fp &a) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    dst[(2 * j) * stride + lane] = (int64_t)(a.w[j] & 0xffffu);
    dst[(2 * j + 1) * stride + lane] = (int64_t)(a.w[j] >> 16);
  }
}

__device__ __forceinline__ void load_jac(Jac &p, const int64_t *x, const int64_t *y,
                                         const int64_t *z, int64_t stride, int64_t lane) {
  load_fp(p.x, x, stride, lane);
  load_fp(p.y, y, stride, lane);
  load_fp(p.z, z, stride, lane);
}

__device__ __forceinline__ void store_jac(int64_t *x, int64_t *y, int64_t *z,
                                          int64_t stride, int64_t lane, const Jac &p) {
  store_fp(x, stride, lane, p.x);
  store_fp(y, stride, lane, p.y);
  store_fp(z, stride, lane, p.z);
}

// -- points --------------------------------------------------------------------

// dbl-2009-l (curve.py _dbl_impl); the identity (z = 0) maps to z = 0.
__device__ __forceinline__ void g1_dbl(Jac &r, const Jac &p) {
  Fp a, b, c, d, e, f, t;
  fp_sqr(a, p.x);
  fp_sqr(b, p.y);
  fp_sqr(c, b);
  fp_add(t, p.x, b);
  fp_sqr(d, t);
  fp_sub(d, d, a);
  fp_sub(d, d, c);
  fp_add(d, d, d);           // d = 2((x + b)^2 - a - c)
  fp_add(e, a, a);
  fp_add(e, e, a);           // e = 3a
  fp_sqr(f, e);
  Jac o;
  fp_add(t, d, d);
  fp_sub(o.x, f, t);         // x3 = e^2 - 2d
  fp_add(c, c, c);
  fp_add(c, c, c);
  fp_add(c, c, c);           // 8c
  fp_sub(t, d, o.x);
  fp_mul(t, e, t);
  fp_sub(o.y, t, c);         // y3 = e(d - x3) - 8c
  fp_add(t, p.y, p.y);
  fp_mul(o.z, t, p.z);       // z3 = 2yz
  r = o;
}

// The doubling branch of the additions: a separate call keeps the rarely
// taken path out of the inlined hot loop.
static __device__ __noinline__ void g1_dbl_branch(Jac &r, const Jac &p) { g1_dbl(r, p); }

// Complete Jacobian addition (add-2007-bl, curve.py _add_impl).  Returns 1
// when the same-point lane took the doubling branch, else 0.
__device__ __forceinline__ int g1_add(Jac &r, const Jac &p, const Jac &q) {
  if (fp_is_zero(p.z)) {
    r = q;
    return 0;
  }
  if (fp_is_zero(q.z)) {
    r = p;
    return 0;
  }
  Fp z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t;
  fp_sqr(z1z1, p.z);
  fp_sqr(z2z2, q.z);
  fp_mul(u1, p.x, z2z2);
  fp_mul(u2, q.x, z1z1);
  fp_mul(s1, p.y, q.z);
  fp_mul(s1, s1, z2z2);
  fp_mul(s2, q.y, p.z);
  fp_mul(s2, s2, z1z1);
  fp_sub(h, u2, u1);
  fp_sub(rr, s2, s1);
  if (fp_is_zero(h) && fp_is_zero(rr)) {
    g1_dbl_branch(r, p);
    return 1;
  }
  fp_add(t, h, h);
  fp_sqr(i, t);
  fp_mul(j, h, i);
  fp_add(rr, rr, rr);
  fp_mul(v, u1, i);
  Jac o;
  fp_sqr(t, rr);
  fp_sub(t, t, j);
  fp_add(o.x, v, v);
  fp_sub(o.x, t, o.x);       // x3 = rr^2 - j - 2v
  fp_mul(s1, s1, j);
  fp_add(s1, s1, s1);
  fp_sub(t, v, o.x);
  fp_mul(t, rr, t);
  fp_sub(o.y, t, s1);        // y3 = rr(v - x3) - 2 s1 j
  fp_add(t, p.z, q.z);
  fp_sqr(t, t);
  fp_sub(t, t, z1z1);
  fp_sub(t, t, z2z2);
  fp_mul(o.z, t, h);         // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h
  r = o;
  return 0;
}

// Complete mixed addition p + (qx, qy) with q affine and finite
// (madd-2007-bl, curve.py _madd_impl).  Returns 1 on the doubling branch.
__device__ __forceinline__ int g1_madd(Jac &r, const Jac &p, const Fp &qx, const Fp &qy) {
  if (fp_is_zero(p.z)) {
    r.x = qx;
    r.y = qy;
    fp_set_one(r.z);
    return 0;
  }
  Fp z1z1, u2, s2, h, hh, i, j, rr, v, t;
  fp_sqr(z1z1, p.z);
  fp_mul(u2, qx, z1z1);
  fp_mul(s2, qy, p.z);
  fp_mul(s2, s2, z1z1);
  fp_sub(h, u2, p.x);
  fp_sub(rr, s2, p.y);
  if (fp_is_zero(h) && fp_is_zero(rr)) {
    g1_dbl_branch(r, p);
    return 1;
  }
  fp_sqr(hh, h);
  fp_add(i, hh, hh);
  fp_add(i, i, i);
  fp_mul(j, h, i);
  fp_add(rr, rr, rr);
  fp_mul(v, p.x, i);
  Jac o;
  fp_sqr(t, rr);
  fp_sub(t, t, j);
  fp_add(o.x, v, v);
  fp_sub(o.x, t, o.x);       // x3 = rr^2 - j - 2v
  fp_mul(u2, p.y, j);
  fp_add(u2, u2, u2);
  fp_sub(t, v, o.x);
  fp_mul(t, rr, t);
  fp_sub(o.y, t, u2);        // y3 = rr(v - x3) - 2 y1 j
  fp_add(t, p.z, h);
  fp_sqr(t, t);
  fp_sub(t, t, z1z1);
  fp_sub(o.z, t, hh);        // z3 = (z1 + h)^2 - z1z1 - hh
  r = o;
  return 0;
}

static inline unsigned int blocks_for(int64_t n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}
