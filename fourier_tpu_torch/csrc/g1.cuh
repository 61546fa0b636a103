// Shared device code of the G1 kernels: BLS12-381 Fp arithmetic and the
// complete point formulas.
//
// Fp elements are 12 x 32-bit little-endian words in Montgomery form with
// radix 2^384, the radix of the reference's 24 x 16-bit limbs, so every
// Montgomery value here equals the reference's as an integer.
//
// The point formulas run in redundant form: p < 2^381 and R = 2^384, so
// 4p < R and a Montgomery product or squaring of inputs below 2p ends
// below 2p with no final subtraction; adds and subs reduce modulo 2p, and
// a zero test asks for 0 or p.  Every step keeps its value's residue mod
// p, so a chain of doublings (g1_dbl_n), or an addition (g1_add, g1_madd),
// made canonical once at its output returns exactly the limbs of the
// reference's canonical complete formulas (fourier_tpu/ops/curve.py
// _dbl_impl, _add_impl, _madd_impl): same algebra, same select order for
// identity operands; the canonical residue is unique.
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
static __constant__ uint32_t FP_2P[FP_WORDS] = {
    0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu, 0xed61ec48u, 0xce61a541u,
    0xe70a257eu, 0xc8ee9709u, 0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
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

// a == 0 mod p for a in [0, 2p): a is 0 or p.
__device__ __forceinline__ bool fp_is_zero_lazy(const Fp &a) {
  uint32_t zero = 0u, is_p = 0u;
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    zero |= a.w[j];
    is_p |= a.w[j] ^ FP_P[j];
  }
  return zero == 0u || is_p == 0u;
}

// t := t - m when t >= m, for m = p (TWO_P false, t < 2p) or 2p (TWO_P
// true, t < 4p).
template <bool TWO_P = false>
__device__ __forceinline__ void fp_reduce_once(uint32_t *t) {
  uint32_t d[FP_WORDS];
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    uint64_t s = (uint64_t)t[j] - (TWO_P ? FP_2P[j] : FP_P[j]) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  if (!borrow) {
#pragma unroll
    for (int j = 0; j < FP_WORDS; j++) t[j] = d[j];
  }
}

// a + b modulo m = p (TWO_P false: a, b < p) or 2p (TWO_P true: a, b < 2p);
// a + b < 4p < 2^384 never carries out.
template <bool TWO_P>
__device__ __forceinline__ void fp_add_mod(Fp &r, const Fp &a, const Fp &b) {
  uint32_t t[FP_WORDS];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    uint64_t s = (uint64_t)a.w[j] + b.w[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  fp_reduce_once<TWO_P>(t);
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = t[j];
}

// a - b modulo m (as fp_add_mod): m is added back when a < b (the carry
// out cancels the wrap).
template <bool TWO_P>
__device__ __forceinline__ void fp_sub_mod(Fp &r, const Fp &a, const Fp &b) {
  uint32_t t[FP_WORDS];
  uint32_t borrow = 0u;
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    uint64_t s = (uint64_t)a.w[j] - b.w[j] - borrow;
    t[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FP_WORDS; j++) {
      uint64_t s = (uint64_t)t[j] + (TWO_P ? FP_2P[j] : FP_P[j]) + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
  }
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = t[j];
}

// -a mod p for a < p.
__device__ __forceinline__ void fp_neg(Fp &r, const Fp &a) {
  Fp zero;
  fp_set_zero(zero);
  fp_sub_mod<false>(r, zero, a);
}

// Montgomery product a * b / 2^384 mod p, word-serial CIOS, left in
// [0, 2p) for a, b < 2p: the value (a b + M p) / 2^384 is < 2p because
// 4p < 2^384, so t[12] ends at zero.
__device__ __forceinline__ void fp_mul_lazy(Fp &r, const Fp &a, const Fp &b) {
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
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = t[j];
}

// Montgomery square a^2 / 2^384 mod p, left in [0, 2p) for a < 2p: the 66
// cross products a_i a_j (i < j) once, doubled, plus the 12 squares a_i^2
// (78 word products where the product takes 144), then the same
// word-serial reduction, one word of the 24-word square at a time.
__device__ __forceinline__ void fp_sqr_lazy(Fp &r, const Fp &a) {
  uint32_t t[2 * FP_WORDS];
#pragma unroll
  for (int j = 0; j < 2 * FP_WORDS; j++) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < FP_WORDS - 1; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < FP_WORDS; j++) {
      uint64_t s = (uint64_t)a.w[i] * a.w[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + FP_WORDS] = (uint32_t)c;  // row i - 1 wrote up to t[i + 11]
  }
#pragma unroll
  for (int j = 2 * FP_WORDS - 1; j > 0; j--) t[j] = (t[j] << 1) | (t[j - 1] >> 31);
  t[0] <<= 1;
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < FP_WORDS; i++) {
    uint64_t s = (uint64_t)a.w[i] * a.w[i] + t[2 * i] + c;
    t[2 * i] = (uint32_t)s;
    s = (s >> 32) + t[2 * i + 1];
    t[2 * i + 1] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  // a^2 + M p < 2^766: the carry out of word i + 12 is deferred to word
  // i + 13, which the next row's carry reaches after its own loop.
  uint32_t hc = 0u;
#pragma unroll
  for (int i = 0; i < FP_WORDS; i++) {
    const uint32_t m = t[i] * FP_NINV;
    uint64_t cc = 0;
#pragma unroll
    for (int j = 0; j < FP_WORDS; j++) {
      uint64_t s = (uint64_t)m * FP_P[j] + t[i + j] + cc;
      t[i + j] = (uint32_t)s;
      cc = s >> 32;
    }
    uint64_t s = (uint64_t)t[i + FP_WORDS] + cc + hc;
    t[i + FP_WORDS] = (uint32_t)s;
    hc = (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) r.w[j] = t[FP_WORDS + j];
}

// The products of the point formulas: one out-of-line body of the
// redundant product and one of the square, operands and result by value
// in registers.  Inlined, a mixed add and a doubling are some 22,000
// instructions, past what the SM's instruction cache holds, so every warp
// of a point formula waits on instruction fetch; called, they run from
// two bodies of ~1,200 instructions that stay cached, and each formula
// keeps fewer values live (PERF.md has the measurements).
static __device__ __noinline__ Fp fp_mul_call(const Fp a, const Fp b) {
  Fp r;
  fp_mul_lazy(r, a, b);
  return r;
}

static __device__ __noinline__ Fp fp_sqr_call(const Fp a) {
  Fp r;
  fp_sqr_lazy(r, a);
  return r;
}

// The canonical product and square, inputs < p, outputs < p (the point
// formulas use the redundant forms; kernel_probe.py times both).
__device__ __forceinline__ void fp_mul(Fp &r, const Fp &a, const Fp &b) {
  fp_mul_lazy(r, a, b);
  fp_reduce_once(r.w);
}

__device__ __forceinline__ void fp_sqr(Fp &r, const Fp &a) {
  fp_sqr_lazy(r, a);
  fp_reduce_once(r.w);
}

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

// dbl-2009-l (curve.py _dbl_impl) in redundant form: coordinates in
// [0, 2p) in and out.  The identity (z = 0, or p once redundant) stays
// the identity: z3 = 2yz.
__device__ __forceinline__ void g1_dbl_lazy(Jac &r, const Jac &p) {
  Fp a, b, c, d, e, f, t;
  a = fp_sqr_call(p.x);
  b = fp_sqr_call(p.y);
  c = fp_sqr_call(b);
  fp_add_mod<true>(t, p.x, b);
  d = fp_sqr_call(t);
  fp_sub_mod<true>(d, d, a);
  fp_sub_mod<true>(d, d, c);
  fp_add_mod<true>(d, d, d);           // d = 2((x + b)^2 - a - c)
  fp_add_mod<true>(e, a, a);
  fp_add_mod<true>(e, e, a);           // e = 3a
  f = fp_sqr_call(e);
  Jac o;
  fp_add_mod<true>(t, d, d);
  fp_sub_mod<true>(o.x, f, t);         // x3 = e^2 - 2d
  fp_add_mod<true>(c, c, c);
  fp_add_mod<true>(c, c, c);
  fp_add_mod<true>(c, c, c);           // 8c
  fp_sub_mod<true>(t, d, o.x);
  t = fp_mul_call(e, t);
  fp_sub_mod<true>(o.y, t, c);         // y3 = e(d - x3) - 8c
  fp_add_mod<true>(t, p.y, p.y);
  o.z = fp_mul_call(t, p.z);           // z3 = 2yz
  r = o;
}

// Each coordinate of a point in [0, 2p) to its canonical value.
__device__ __forceinline__ void g1_reduce(Jac &p) {
  fp_reduce_once(p.x.w);
  fp_reduce_once(p.y.w);
  fp_reduce_once(p.z.w);
}

// n doublings of p in place, in redundant form, then one canonical
// reduction of each coordinate: the limbs of n canonical doublings.
__device__ __forceinline__ void g1_dbl_n(Jac &p, int n) {
  for (int k = 0; k < n; k++) g1_dbl_lazy(p, p);
  g1_reduce(p);
}

// The doubling branch of the additions: a separate call keeps the rarely
// taken path out of the inlined hot loop.
static __device__ __noinline__ void g1_dbl_branch(Jac &r, const Jac &p) {
  g1_dbl_lazy(r, p);
}

// Complete Jacobian addition (add-2007-bl, curve.py _add_impl) in
// redundant form: coordinates in [0, 2p) in and out.  Returns 1 when the
// same-point lane took the doubling branch, else 0.  r may alias p or q.
__device__ __forceinline__ int g1_add_lazy(Jac &r, const Jac &p, const Jac &q) {
  if (fp_is_zero_lazy(p.z)) {
    r = q;
    return 0;
  }
  if (fp_is_zero_lazy(q.z)) {
    r = p;
    return 0;
  }
  Fp z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t;
  z1z1 = fp_sqr_call(p.z);
  z2z2 = fp_sqr_call(q.z);
  u1 = fp_mul_call(p.x, z2z2);
  u2 = fp_mul_call(q.x, z1z1);
  s1 = fp_mul_call(p.y, q.z);
  s1 = fp_mul_call(s1, z2z2);
  s2 = fp_mul_call(q.y, p.z);
  s2 = fp_mul_call(s2, z1z1);
  fp_sub_mod<true>(h, u2, u1);
  fp_sub_mod<true>(rr, s2, s1);
  if (fp_is_zero_lazy(h) && fp_is_zero_lazy(rr)) {
    g1_dbl_branch(r, p);
    return 1;
  }
  fp_add_mod<true>(t, h, h);
  i = fp_sqr_call(t);
  j = fp_mul_call(h, i);
  fp_add_mod<true>(rr, rr, rr);
  v = fp_mul_call(u1, i);
  Jac o;
  t = fp_sqr_call(rr);
  fp_sub_mod<true>(t, t, j);
  fp_add_mod<true>(o.x, v, v);
  fp_sub_mod<true>(o.x, t, o.x);       // x3 = rr^2 - j - 2v
  s1 = fp_mul_call(s1, j);
  fp_add_mod<true>(s1, s1, s1);
  fp_sub_mod<true>(t, v, o.x);
  t = fp_mul_call(rr, t);
  fp_sub_mod<true>(o.y, t, s1);        // y3 = rr(v - x3) - 2 s1 j
  fp_add_mod<true>(t, p.z, q.z);
  t = fp_sqr_call(t);
  fp_sub_mod<true>(t, t, z1z1);
  fp_sub_mod<true>(t, t, z2z2);
  o.z = fp_mul_call(t, h);             // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h
  r = o;
  return 0;
}

// Complete mixed addition p + (qx, qy) with q affine and finite
// (madd-2007-bl, curve.py _madd_impl) in redundant form: coordinates in
// [0, 2p) in and out.  Returns 1 on the doubling branch.  r may alias p.
__device__ __forceinline__ int g1_madd_lazy(Jac &r, const Jac &p, const Fp &qx, const Fp &qy) {
  if (fp_is_zero_lazy(p.z)) {
    r.x = qx;
    r.y = qy;
    fp_set_one(r.z);
    return 0;
  }
  Fp z1z1, u2, s2, h, hh, i, j, rr, v, t;
  z1z1 = fp_sqr_call(p.z);
  u2 = fp_mul_call(qx, z1z1);
  s2 = fp_mul_call(qy, p.z);
  s2 = fp_mul_call(s2, z1z1);
  fp_sub_mod<true>(h, u2, p.x);
  fp_sub_mod<true>(rr, s2, p.y);
  if (fp_is_zero_lazy(h) && fp_is_zero_lazy(rr)) {
    g1_dbl_branch(r, p);
    return 1;
  }
  hh = fp_sqr_call(h);
  fp_add_mod<true>(i, hh, hh);
  fp_add_mod<true>(i, i, i);
  j = fp_mul_call(h, i);
  fp_add_mod<true>(rr, rr, rr);
  v = fp_mul_call(p.x, i);
  Jac o;
  t = fp_sqr_call(rr);
  fp_sub_mod<true>(t, t, j);
  fp_add_mod<true>(o.x, v, v);
  fp_sub_mod<true>(o.x, t, o.x);       // x3 = rr^2 - j - 2v
  u2 = fp_mul_call(p.y, j);
  fp_add_mod<true>(u2, u2, u2);
  fp_sub_mod<true>(t, v, o.x);
  t = fp_mul_call(rr, t);
  fp_sub_mod<true>(o.y, t, u2);        // y3 = rr(v - x3) - 2 y1 j
  fp_add_mod<true>(t, p.z, h);
  t = fp_sqr_call(t);
  fp_sub_mod<true>(t, t, z1z1);
  fp_sub_mod<true>(o.z, t, hh);        // z3 = (z1 + h)^2 - z1z1 - hh
  r = o;
  return 0;
}

// The canonical additions: canonical coordinates in (they lie in [0, 2p))
// and out, the redundant form in between.
__device__ __forceinline__ int g1_add(Jac &r, const Jac &p, const Jac &q) {
  int doubled = g1_add_lazy(r, p, q);
  g1_reduce(r);
  return doubled;
}

__device__ __forceinline__ int g1_madd(Jac &r, const Jac &p, const Fp &qx, const Fp &qy) {
  int doubled = g1_madd_lazy(r, p, qx, qy);
  g1_reduce(r);
  return doubled;
}

static inline unsigned int blocks_for(int64_t n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}
