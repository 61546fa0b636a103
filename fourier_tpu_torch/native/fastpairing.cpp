// Native BLS12-381 pairing: the host-side verify kernel.
//
// The reference verifies through blst's C/assembly pairing FFI
// (reference src/engine/piano.rs:358-464); this is the same architecture
// for this framework — a native multi-pairing product check behind a
// small C ABI, consumed via ctypes.
//
// Two pairing implementations live here:
//  - the REFERENCE path (miller_loop / fp12_pow_be final exp), which
//    mirrors fourier_tpu/refimpl/pairing.py line by line (untwist to
//    E(Fp12), affine Miller loop with Fp12 inversions, generic
//    exponentiation), exported as fw_pairing_ref for cross-checks;
//  - the FAST path used by fw_pairings_check / fw_pairing: Jacobian
//    Miller loop on the twist E'(Fp2) with monomial-tracked line
//    coefficients (no inversions — per-step Fp2 scale factors live in
//    proper subfields and die in the final exponentiation), Frobenius
//    maps with init-computed gamma constants, and the exact BLS12
//    hard-part chain e = ((x-1)^2/3)(x+p)(x^2+p^2-1) + 1 so the
//    pairing VALUE equals the reference path bit for bit.
//
// Fp is 6 x uint64 in Montgomery form with __uint128 CIOS multiplication.
// Big exponents (p^2 for the easy part, (p^4 - p^2 + 1)/r for the hard
// part) are passed in from Python as big-endian byte strings; the fast
// path no longer needs them but the ABI is kept.
//
// C ABI only.  Build: g++ -O3 -shared -fPIC (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

typedef unsigned __int128 u128;

// ---------------------------------------------------------------------------
// Fp: 6x64 Montgomery
// ---------------------------------------------------------------------------

static const uint64_t MOD[6] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL,
};
static const uint64_t N0INV = 0x89f3fffcfffcfffdULL;  // -p^-1 mod 2^64

struct Fp {
    uint64_t v[6];
};

static Fp FP_ZERO;     // all zero
static Fp FP_ONE;      // R mod p (Montgomery one), set in init
static Fp FP_R2;       // R^2 mod p, set in init
static Fp FP_THREE;    // 3 in Montgomery form

inline bool fp_is_zero(const Fp& a) {
    uint64_t acc = 0;
    for (int i = 0; i < 6; i++) acc |= a.v[i];
    return acc == 0;
}

inline bool fp_eq(const Fp& a, const Fp& b) {
    uint64_t acc = 0;
    for (int i = 0; i < 6; i++) acc |= a.v[i] ^ b.v[i];
    return acc == 0;
}

inline void fp_sub_mod_if_ge(Fp& a) {
    // subtract p if a >= p
    uint64_t t[6];
    unsigned borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a.v[i] - MOD[i] - borrow;
        t[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;  // wrapped -> borrow
    }
    if (!borrow) memcpy(a.v, t, sizeof(t));
}

inline void fp_add(Fp& o, const Fp& a, const Fp& b) {
    unsigned carry = 0;
    for (int i = 0; i < 6; i++) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        o.v[i] = (uint64_t)s;
        carry = (unsigned)(s >> 64);
    }
    fp_sub_mod_if_ge(o);
}

inline void fp_sub(Fp& o, const Fp& a, const Fp& b) {
    unsigned borrow = 0;
    uint64_t t[6];
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        t[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        unsigned carry = 0;
        for (int i = 0; i < 6; i++) {
            u128 s = (u128)t[i] + MOD[i] + carry;
            t[i] = (uint64_t)s;
            carry = (unsigned)(s >> 64);
        }
    }
    memcpy(o.v, t, sizeof(t));
}

inline void fp_neg(Fp& o, const Fp& a) {
    if (fp_is_zero(a)) { o = a; return; }
    unsigned borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)MOD[i] - a.v[i] - borrow;
        o.v[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

// CIOS Montgomery multiplication
inline void fp_mul(Fp& o, const Fp& a, const Fp& b) {
    uint64_t t[8] = {0};
    for (int i = 0; i < 6; i++) {
        u128 carry = 0;
        uint64_t ai = a.v[i];
        for (int j = 0; j < 6; j++) {
            u128 s = (u128)ai * b.v[j] + t[j] + (uint64_t)carry;
            t[j] = (uint64_t)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[6] + (uint64_t)carry;
        t[6] = (uint64_t)s;
        t[7] = (uint64_t)(s >> 64);

        uint64_t m = t[0] * N0INV;
        carry = 0;
        u128 s0 = (u128)m * MOD[0] + t[0];
        carry = s0 >> 64;
        for (int j = 1; j < 6; j++) {
            u128 s2 = (u128)m * MOD[j] + t[j] + (uint64_t)carry;
            t[j - 1] = (uint64_t)s2;
            carry = s2 >> 64;
        }
        u128 s3 = (u128)t[6] + (uint64_t)carry;
        t[5] = (uint64_t)s3;
        t[6] = t[7] + (uint64_t)(s3 >> 64);
        t[7] = 0;
    }
    memcpy(o.v, t, 6 * sizeof(uint64_t));
    fp_sub_mod_if_ge(o);
}

inline void fp_sqr(Fp& o, const Fp& a) { fp_mul(o, a, a); }

// a^e for a big-endian exponent byte string
static void fp_pow_be(Fp& o, const Fp& a, const uint8_t* e, int64_t len) {
    Fp r = FP_ONE;
    for (int64_t i = 0; i < len; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            fp_sqr(r, r);
            if ((e[i] >> bit) & 1) fp_mul(r, r, a);
        }
    }
    o = r;
}

static const uint8_t P_MINUS_2_BE[48] = {
    0x1a, 0x01, 0x11, 0xea, 0x39, 0x7f, 0xe6, 0x9a, 0x4b, 0x1b, 0xa7, 0xb6,
    0x43, 0x4b, 0xac, 0xd7, 0x64, 0x77, 0x4b, 0x84, 0xf3, 0x85, 0x12, 0xbf,
    0x67, 0x30, 0xd2, 0xa0, 0xf6, 0xb0, 0xf6, 0x24, 0x1e, 0xab, 0xff, 0xfe,
    0xb1, 0x53, 0xff, 0xff, 0xb9, 0xfe, 0xff, 0xff, 0xff, 0xff, 0xaa, 0xa9,
};

inline void fp_inv(Fp& o, const Fp& a) {
    fp_pow_be(o, a, P_MINUS_2_BE, 48);
}

static void fp_from_be(Fp& o, const uint8_t* b) {
    Fp raw;
    for (int i = 0; i < 6; i++) {
        uint64_t w = 0;
        for (int j = 0; j < 8; j++) w = (w << 8) | b[(5 - i) * 8 + j];
        raw.v[i] = w;
    }
    fp_mul(o, raw, FP_R2);  // to Montgomery
}

static void init_constants_impl() {
    // R mod p by 384 doublings of 1
    Fp one;
    memset(&one, 0, sizeof(one));
    one.v[0] = 1;
    Fp r = one;
    for (int i = 0; i < 384; i++) fp_add(r, r, r);
    FP_ONE = r;
    Fp r2 = r;
    for (int i = 0; i < 384; i++) fp_add(r2, r2, r2);
    FP_R2 = r2;
    memset(&FP_ZERO, 0, sizeof(FP_ZERO));
    Fp three;
    fp_add(three, FP_ONE, FP_ONE);
    fp_add(FP_THREE, three, FP_ONE);
}

static void init_constants() {
    // C++11 magic static: exactly-once, concurrent callers wait
    static const bool done = [] { init_constants_impl(); return true; }();
    (void)done;
}

// ---------------------------------------------------------------------------
// Tower: Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3 - (u+1)); Fp12 = Fp6[w]/(w^2 - v)
// (identical construction to refimpl/tower.py)
// ---------------------------------------------------------------------------

struct Fp2 { Fp c0, c1; };
struct Fp6 { Fp2 c0, c1, c2; };
struct Fp12 { Fp6 c0, c1; };

inline void fp2_add(Fp2& o, const Fp2& a, const Fp2& b) {
    fp_add(o.c0, a.c0, b.c0);
    fp_add(o.c1, a.c1, b.c1);
}
inline void fp2_sub(Fp2& o, const Fp2& a, const Fp2& b) {
    fp_sub(o.c0, a.c0, b.c0);
    fp_sub(o.c1, a.c1, b.c1);
}
inline void fp2_neg(Fp2& o, const Fp2& a) {
    fp_neg(o.c0, a.c0);
    fp_neg(o.c1, a.c1);
}
inline void fp2_mul(Fp2& o, const Fp2& a, const Fp2& b) {
    Fp t0, t1, t2, sa, sb;
    fp_mul(t0, a.c0, b.c0);
    fp_mul(t1, a.c1, b.c1);
    fp_add(sa, a.c0, a.c1);
    fp_add(sb, b.c0, b.c1);
    fp_mul(t2, sa, sb);
    Fp2 r;
    fp_sub(r.c0, t0, t1);
    fp_sub(t2, t2, t0);
    fp_sub(r.c1, t2, t1);
    o = r;
}
inline void fp2_sqr(Fp2& o, const Fp2& a) { fp2_mul(o, a, a); }
inline bool fp2_is_zero(const Fp2& a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }
inline bool fp2_eq(const Fp2& a, const Fp2& b) { return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1); }
inline void fp2_mul_by_xi(Fp2& o, const Fp2& a) {
    // xi = 1 + u
    Fp t0, t1;
    fp_sub(t0, a.c0, a.c1);
    fp_add(t1, a.c0, a.c1);
    o.c0 = t0;
    o.c1 = t1;
}
inline void fp2_inv(Fp2& o, const Fp2& a) {
    Fp n, t0, t1, inv;
    fp_sqr(t0, a.c0);
    fp_sqr(t1, a.c1);
    fp_add(n, t0, t1);
    fp_inv(inv, n);
    fp_mul(o.c0, a.c0, inv);
    Fp negc1;
    fp_neg(negc1, a.c1);
    fp_mul(o.c1, negc1, inv);
}

inline void fp6_add(Fp6& o, const Fp6& a, const Fp6& b) {
    fp2_add(o.c0, a.c0, b.c0);
    fp2_add(o.c1, a.c1, b.c1);
    fp2_add(o.c2, a.c2, b.c2);
}
inline void fp6_sub(Fp6& o, const Fp6& a, const Fp6& b) {
    fp2_sub(o.c0, a.c0, b.c0);
    fp2_sub(o.c1, a.c1, b.c1);
    fp2_sub(o.c2, a.c2, b.c2);
}
inline void fp6_neg(Fp6& o, const Fp6& a) {
    fp2_neg(o.c0, a.c0);
    fp2_neg(o.c1, a.c1);
    fp2_neg(o.c2, a.c2);
}
inline bool fp6_is_zero(const Fp6& a) {
    return fp2_is_zero(a.c0) && fp2_is_zero(a.c1) && fp2_is_zero(a.c2);
}
inline bool fp6_eq(const Fp6& a, const Fp6& b) {
    return fp2_eq(a.c0, b.c0) && fp2_eq(a.c1, b.c1) && fp2_eq(a.c2, b.c2);
}
static void fp6_mul(Fp6& o, const Fp6& a, const Fp6& b) {
    Fp2 t0, t1, t2, s0, s1, r0, r1, r2, x;
    fp2_mul(t0, a.c0, b.c0);
    fp2_mul(t1, a.c1, b.c1);
    fp2_mul(t2, a.c2, b.c2);
    // c0 = ((a1+a2)(b1+b2) - t1 - t2)*xi + t0
    fp2_add(s0, a.c1, a.c2);
    fp2_add(s1, b.c1, b.c2);
    fp2_mul(x, s0, s1);
    fp2_sub(x, x, t1);
    fp2_sub(x, x, t2);
    fp2_mul_by_xi(x, x);
    fp2_add(r0, x, t0);
    // c1 = (a0+a1)(b0+b1) - t0 - t1 + t2*xi
    fp2_add(s0, a.c0, a.c1);
    fp2_add(s1, b.c0, b.c1);
    fp2_mul(x, s0, s1);
    fp2_sub(x, x, t0);
    fp2_sub(x, x, t1);
    Fp2 t2x;
    fp2_mul_by_xi(t2x, t2);
    fp2_add(r1, x, t2x);
    // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    fp2_add(s0, a.c0, a.c2);
    fp2_add(s1, b.c0, b.c2);
    fp2_mul(x, s0, s1);
    fp2_sub(x, x, t0);
    fp2_sub(x, x, t2);
    fp2_add(r2, x, t1);
    o.c0 = r0;
    o.c1 = r1;
    o.c2 = r2;
}
inline void fp6_mul_by_v(Fp6& o, const Fp6& a) {
    Fp2 t;
    fp2_mul_by_xi(t, a.c2);
    Fp2 a0 = a.c0, a1 = a.c1;
    o.c0 = t;
    o.c1 = a0;
    o.c2 = a1;
}
static void fp6_inv(Fp6& o, const Fp6& in) {
    Fp2 t0, t1, t2, x, denom;
    // t0 = a^2 - (b*c)*xi
    fp2_sqr(t0, in.c0);
    fp2_mul(x, in.c1, in.c2);
    fp2_mul_by_xi(x, x);
    fp2_sub(t0, t0, x);
    // t1 = (c^2)*xi - a*b
    fp2_sqr(x, in.c2);
    fp2_mul_by_xi(t1, x);
    fp2_mul(x, in.c0, in.c1);
    fp2_sub(t1, t1, x);
    // t2 = b^2 - a*c
    fp2_sqr(t2, in.c1);
    fp2_mul(x, in.c0, in.c2);
    fp2_sub(t2, t2, x);
    // denom = a*t0 + (c*t1)*xi + (b*t2)*xi
    Fp2 d0, d1, d2;
    fp2_mul(d0, in.c0, t0);
    fp2_mul(x, in.c2, t1);
    fp2_mul_by_xi(d1, x);
    fp2_mul(x, in.c1, t2);
    fp2_mul_by_xi(d2, x);
    fp2_add(denom, d0, d1);
    fp2_add(denom, denom, d2);
    Fp2 dinv;
    fp2_inv(dinv, denom);
    fp2_mul(o.c0, t0, dinv);
    fp2_mul(o.c1, t1, dinv);
    fp2_mul(o.c2, t2, dinv);
}

inline void fp12_add(Fp12& o, const Fp12& a, const Fp12& b) {
    fp6_add(o.c0, a.c0, b.c0);
    fp6_add(o.c1, a.c1, b.c1);
}
inline void fp12_sub(Fp12& o, const Fp12& a, const Fp12& b) {
    fp6_sub(o.c0, a.c0, b.c0);
    fp6_sub(o.c1, a.c1, b.c1);
}
static void fp12_mul(Fp12& o, const Fp12& a, const Fp12& b) {
    Fp6 t0, t1, s0, s1, x, r0, r1;
    fp6_mul(t0, a.c0, b.c0);
    fp6_mul(t1, a.c1, b.c1);
    Fp6 t1v;
    fp6_mul_by_v(t1v, t1);
    fp6_add(r0, t0, t1v);
    fp6_add(s0, a.c0, a.c1);
    fp6_add(s1, b.c0, b.c1);
    fp6_mul(x, s0, s1);
    fp6_sub(x, x, t0);
    fp6_sub(r1, x, t1);
    o.c0 = r0;
    o.c1 = r1;
}
inline void fp12_sqr(Fp12& o, const Fp12& a) { fp12_mul(o, a, a); }
inline void fp12_conj(Fp12& o, const Fp12& a) {
    o.c0 = a.c0;
    fp6_neg(o.c1, a.c1);
}
static void fp12_inv(Fp12& o, const Fp12& a) {
    Fp6 t0, t1, d;
    fp6_mul(t0, a.c0, a.c0);
    fp6_mul(t1, a.c1, a.c1);
    Fp6 t1v;
    fp6_mul_by_v(t1v, t1);
    fp6_sub(d, t0, t1v);
    Fp6 dinv;
    fp6_inv(dinv, d);
    fp6_mul(o.c0, a.c0, dinv);
    Fp6 n;
    fp6_mul(n, a.c1, dinv);
    fp6_neg(o.c1, n);
}
static Fp12 fp12_one() {
    Fp12 r;
    memset(&r, 0, sizeof(r));
    r.c0.c0.c0 = FP_ONE;
    return r;
}
inline bool fp12_is_one(const Fp12& a) {
    Fp12 one = fp12_one();
    return fp6_eq(a.c0, one.c0) && fp6_is_zero(a.c1);
}
static void fp12_pow_be(Fp12& o, const Fp12& a, const uint8_t* e, int64_t len) {
    Fp12 r = fp12_one();
    bool started = false;
    for (int64_t i = 0; i < len; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) fp12_sqr(r, r);
            if ((e[i] >> bit) & 1) {
                if (started) fp12_mul(r, r, a);
                else { r = a; started = true; }
            }
        }
    }
    o = r;
}

// ---------------------------------------------------------------------------
// Pairing: untwist + affine Fp12 Miller loop (mirrors refimpl/pairing.py)
// ---------------------------------------------------------------------------

struct PtFp12 { Fp12 x, y; bool inf; };

static Fp12 embed_fp2(const Fp2& a) {
    Fp12 r;
    memset(&r, 0, sizeof(r));
    r.c0.c0 = a;
    return r;
}

// w^-2 and w^-3 in Fp12 (computed once)
static Fp12 W2_INV, W3_INV;

static void init_twist_constants_impl() {
    Fp12 w;
    memset(&w, 0, sizeof(w));
    w.c1.c0.c0 = FP_ONE;  // w
    Fp12 w2, w3;
    fp12_mul(w2, w, w);
    fp12_mul(w3, w2, w);
    fp12_inv(W2_INV, w2);
    fp12_inv(W3_INV, w3);
}

static void init_twist_constants() {
    static const bool done = [] { init_twist_constants_impl(); return true; }();
    (void)done;
}

// lam for doubling (3x^2 / 2y) or chord ((y2-y1)/(x2-x1)); o = line value at
// (xp, yp): (yp - ay) - lam*(xp - ax).  Returns false for the vertical case
// (handled by caller as xp - ax).
static void line_eval(Fp12& o, const PtFp12& a, const PtFp12& b,
                      const Fp12& xp, const Fp12& yp) {
    Fp12 lam, num, den, t;
    if (fp6_eq(a.x.c0, b.x.c0) && fp6_eq(a.x.c1, b.x.c1) &&
        fp6_eq(a.y.c0, b.y.c0) && fp6_eq(a.y.c1, b.y.c1)) {
        Fp12 x2, three;
        fp12_sqr(x2, a.x);
        three = fp12_one();
        // 3 in Fp12
        Fp12 two;
        fp12_add(two, three, three);
        fp12_add(three, two, three);
        fp12_mul(num, x2, three);
        fp12_add(den, a.y, a.y);
        Fp12 deninv;
        fp12_inv(deninv, den);
        fp12_mul(lam, num, deninv);
    } else if (fp6_eq(a.x.c0, b.x.c0) && fp6_eq(a.x.c1, b.x.c1)) {
        fp12_sub(o, xp, a.x);  // vertical line
        return;
    } else {
        Fp12 dy, dx, dxinv;
        fp12_sub(dy, b.y, a.y);
        fp12_sub(dx, b.x, a.x);
        fp12_inv(dxinv, dx);
        fp12_mul(lam, dy, dxinv);
    }
    Fp12 dxp;
    fp12_sub(dxp, xp, a.x);
    fp12_mul(t, lam, dxp);
    fp12_sub(o, yp, a.y);
    fp12_sub(o, o, t);
}

// a + b on E(Fp12), affine; sets inf on inverse pairs
static void pt_add(PtFp12& o, const PtFp12& a, const PtFp12& b) {
    Fp12 lam;
    bool same_x = fp6_eq(a.x.c0, b.x.c0) && fp6_eq(a.x.c1, b.x.c1);
    bool same_y = fp6_eq(a.y.c0, b.y.c0) && fp6_eq(a.y.c1, b.y.c1);
    if (same_x && same_y) {
        Fp12 x2, three, two, num, den, deninv;
        fp12_sqr(x2, a.x);
        three = fp12_one();
        fp12_add(two, three, three);
        fp12_add(three, two, three);
        fp12_mul(num, x2, three);
        fp12_add(den, a.y, a.y);
        fp12_inv(deninv, den);
        fp12_mul(lam, num, deninv);
    } else if (same_x) {
        o.inf = true;
        return;
    } else {
        Fp12 dy, dx, dxinv;
        fp12_sub(dy, b.y, a.y);
        fp12_sub(dx, b.x, a.x);
        fp12_inv(dxinv, dx);
        fp12_mul(lam, dy, dxinv);
    }
    Fp12 x3, y3, t;
    fp12_sqr(x3, lam);
    fp12_sub(x3, x3, a.x);
    fp12_sub(x3, x3, b.x);
    fp12_sub(t, a.x, x3);
    fp12_mul(y3, lam, t);
    fp12_sub(y3, y3, a.y);
    o.x = x3;
    o.y = y3;
    o.inf = false;
}

// BLS parameter |x| = 0xd201000000010000 (x itself is negative)
static const uint64_t BLS_X_ABS = 0xd201000000010000ULL;

// Miller function f_{|x|, Q}(P), conjugated for negative x — exactly
// refimpl/pairing.py miller_loop.  Returns false if the point chain hits
// infinity mid-loop (only possible for out-of-subgroup adversarial Q;
// the Python ground truth raises there, so callers must fail the same
// way — the ctypes wrapper falls back to the Python path).
static bool miller_loop(Fp12& o, const Fp& px, const Fp& py,
                        const Fp2& qx, const Fp2& qy) {
    init_twist_constants();
    PtFp12 qq;
    Fp12 exq = embed_fp2(qx), eyq = embed_fp2(qy);
    fp12_mul(qq.x, exq, W2_INV);
    fp12_mul(qq.y, eyq, W3_INV);
    qq.inf = false;

    Fp12 xp, yp;
    memset(&xp, 0, sizeof(xp));
    memset(&yp, 0, sizeof(yp));
    xp.c0.c0.c0 = px;
    yp.c0.c0.c0 = py;

    Fp12 f = fp12_one();
    PtFp12 t = qq;
    // iterate bits of |x| after the leading one
    int top = 63;
    while (!((BLS_X_ABS >> top) & 1)) top--;
    for (int i = top - 1; i >= 0; i--) {
        Fp12 l;
        fp12_sqr(f, f);
        line_eval(l, t, t, xp, yp);
        fp12_mul(f, f, l);
        PtFp12 t2;
        t2.inf = false;
        pt_add(t2, t, t);
        if (t2.inf) return false;
        t = t2;
        if ((BLS_X_ABS >> i) & 1) {
            line_eval(l, t, qq, xp, yp);
            fp12_mul(f, f, l);
            pt_add(t2, t, qq);
            if (t2.inf) return false;
            t = t2;
        }
    }
    fp12_conj(o, f);  // x < 0
    return true;
}

// ---------------------------------------------------------------------------
// Fast pairing path: Jacobian Miller loop on the twist + Frobenius final
// exponentiation.  Value-identical to the reference path above (the
// per-step line scale factors are Fp2 elements, killed by the final
// exponentiation; the hard part exponentiates by exactly
// (p^4 - p^2 + 1)/r via the verified identity
// e = ((x-1)^2/3)(x+p)(x^2+p^2-1) + 1).
// ---------------------------------------------------------------------------

inline void fp2_conj(Fp2& o, const Fp2& a) {
    o.c0 = a.c0;
    fp_neg(o.c1, a.c1);
}

static void fp2_pow_be(Fp2& o, const Fp2& a, const uint8_t* e, int64_t len) {
    Fp2 r;
    memset(&r, 0, sizeof(r));
    r.c0 = FP_ONE;
    bool started = false;
    for (int64_t i = 0; i < len; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) fp2_sqr(r, r);
            if ((e[i] >> bit) & 1) {
                if (started) fp2_mul(r, r, a);
                else { r = a; started = true; }
            }
        }
    }
    o = r;
}

// Frobenius gamma constants: G1C[i] = xi^(i(p-1)/6) (Fp2),
// G2C[i] = G1C[i]^(p+1) = Norm(G1C[i]) (in Fp, stored as Fp2).
static Fp2 G1C[6], G2C[6];

static void init_frobenius_impl() {
    init_constants();
    // (p - 1) / 6 as big-endian bytes (p is odd, p ≡ 1 mod 6)
    uint64_t t[6];
    for (int i = 0; i < 6; i++) t[i] = MOD[i];
    t[0] -= 1;
    uint64_t rem = 0;
    for (int i = 5; i >= 0; i--) {
        u128 cur = ((u128)rem << 64) | t[i];
        t[i] = (uint64_t)(cur / 6);
        rem = (uint64_t)(cur % 6);
    }
    uint8_t be[48];
    for (int i = 0; i < 6; i++) {
        uint64_t w = t[5 - i];
        for (int j = 0; j < 8; j++) be[8 * i + j] = (uint8_t)(w >> (8 * (7 - j)));
    }
    Fp2 xi;  // 1 + u (Montgomery)
    xi.c0 = FP_ONE;
    xi.c1 = FP_ONE;
    memset(&G1C[0], 0, sizeof(Fp2));
    G1C[0].c0 = FP_ONE;
    fp2_pow_be(G1C[1], xi, be, 48);
    for (int i = 2; i < 6; i++) fp2_mul(G1C[i], G1C[i - 1], G1C[1]);
    for (int i = 0; i < 6; i++) {
        Fp2 c;
        fp2_conj(c, G1C[i]);
        fp2_mul(G2C[i], G1C[i], c);
    }
}

static void init_frobenius() {
    static const bool done = [] { init_frobenius_impl(); return true; }();
    (void)done;
}

// w-basis view: element = sum_i g_i w^i with g0=c0.c0, g1=c1.c0,
// g2=c0.c1, g3=c1.c1, g4=c0.c2, g5=c1.c2 (w^2 = v).
static void fp12_frob1(Fp12& o, const Fp12& a) {
    const Fp2* g[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1,
                       &a.c1.c1, &a.c0.c2, &a.c1.c2};
    Fp12 r;
    Fp2* out[6] = {&r.c0.c0, &r.c1.c0, &r.c0.c1,
                   &r.c1.c1, &r.c0.c2, &r.c1.c2};
    for (int i = 0; i < 6; i++) {
        Fp2 c;
        fp2_conj(c, *g[i]);
        fp2_mul(*out[i], c, G1C[i]);
    }
    o = r;
}

static void fp12_frob2(Fp12& o, const Fp12& a) {
    const Fp2* g[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1,
                       &a.c1.c1, &a.c0.c2, &a.c1.c2};
    Fp12 r;
    Fp2* out[6] = {&r.c0.c0, &r.c1.c0, &r.c0.c1,
                   &r.c1.c1, &r.c0.c2, &r.c1.c2};
    for (int i = 0; i < 6; i++) fp2_mul(*out[i], *g[i], G2C[i]);
    o = r;
}

// complex squaring: (A + Bw)^2 = (A^2 + vB^2) + 2ABw, via
// (A+B)(A+vB) - AB - vAB; 2 fp6_mul instead of 3.
static void fp12_sqr_fast(Fp12& o, const Fp12& a) {
    Fp6 ab, vb, s, t, abv;
    fp6_mul(ab, a.c0, a.c1);
    fp6_mul_by_v(vb, a.c1);
    Fp6 apb, apvb;
    fp6_add(apb, a.c0, a.c1);
    fp6_add(apvb, a.c0, vb);
    fp6_mul(s, apb, apvb);
    fp6_mul_by_v(abv, ab);
    fp6_sub(t, s, ab);
    fp6_sub(o.c0, t, abv);
    fp6_add(o.c1, ab, ab);
}

static void fp12_pow_u64(Fp12& o, const Fp12& a, uint64_t e) {
    Fp12 r = fp12_one();
    bool started = false;
    for (int i = 63; i >= 0; i--) {
        if (started) fp12_sqr_fast(r, r);
        if ((e >> i) & 1) {
            if (started) fp12_mul(r, r, a);
            else { r = a; started = true; }
        }
    }
    o = r;
}

// Line value as Fp12: sparse at w^0, w^3, w^5 (the untwisted tangent /
// chord through T scaled by Fp2 constants — see the derivation in the
// dbl/add steps).
static void line_to_fp12(Fp12& o, const Fp2& l0, const Fp2& l3,
                         const Fp2& l5) {
    memset(&o, 0, sizeof(o));
    o.c0.c0 = l0;
    o.c1.c1 = l3;
    o.c1.c2 = l5;
}

inline void fp2_scale_fp(Fp2& o, const Fp2& a, const Fp& s) {
    fp_mul(o.c0, a.c0, s);
    fp_mul(o.c1, a.c1, s);
}

struct TwistJac { Fp2 X, Y, Z; };

// Tangent line at T evaluated at P, with T <- 2T (Jacobian, a = 0).
// Derivation: with untwist x = a w^-2, y = b w^-3 (a = X/Z^2, b = Y/Z^3),
// lambda = (3a^2/2b) w^-1, and l = yp - y_T - lambda (xp - x_T); scaling
// by the Fp2 constant 2b Z^6 xi gives
//   L0 = 2 Y Z^3 xi yp,  L3 = 3X^3 - 2Y^2,  L5 = -3 X^2 Z^2 xp.
static void dbl_step(TwistJac& t, Fp12& l, const Fp& px, const Fp& py) {
    Fp2 X2, Y2, Z2;
    fp2_sqr(X2, t.X);
    fp2_sqr(Y2, t.Y);
    fp2_sqr(Z2, t.Z);
    Fp2 X3c, tmp;
    fp2_mul(X3c, X2, t.X);
    Fp2 L3;
    fp2_add(tmp, X3c, X3c);
    fp2_add(tmp, tmp, X3c);        // 3X^3
    Fp2 twoY2;
    fp2_add(twoY2, Y2, Y2);
    fp2_sub(L3, tmp, twoY2);
    Fp2 Z3p, YZ3;
    fp2_mul(Z3p, Z2, t.Z);
    fp2_mul(YZ3, t.Y, Z3p);
    Fp2 L0;
    fp2_add(L0, YZ3, YZ3);
    fp2_mul_by_xi(L0, L0);
    fp2_scale_fp(L0, L0, py);
    Fp2 X2Z2, L5;
    fp2_mul(X2Z2, X2, Z2);
    fp2_add(tmp, X2Z2, X2Z2);
    fp2_add(tmp, tmp, X2Z2);       // 3 X^2 Z^2
    fp2_neg(L5, tmp);
    fp2_scale_fp(L5, L5, px);
    line_to_fp12(l, L0, L3, L5);
    // dbl-2009-l (a = 0): X3 = 9X^4 - 8XY^2 etc. via A/B/C/D/E/F
    Fp2 C, XpB, D, E, F, X3n, Y3n, Z3n, C8;
    fp2_sqr(C, Y2);                // Y^4
    fp2_add(XpB, t.X, Y2);
    fp2_sqr(D, XpB);
    fp2_sub(D, D, X2);
    fp2_sub(D, D, C);
    fp2_add(D, D, D);              // D = 2((X+Y^2)^2 - X^2 - Y^4)
    fp2_add(E, X2, X2);
    fp2_add(E, E, X2);             // 3X^2
    fp2_sqr(F, E);
    fp2_sub(X3n, F, D);
    fp2_sub(X3n, X3n, D);
    fp2_mul(Z3n, t.Y, t.Z);
    fp2_add(Z3n, Z3n, Z3n);        // 2YZ
    fp2_sub(Y3n, D, X3n);
    fp2_mul(Y3n, E, Y3n);
    fp2_add(C8, C, C);
    fp2_add(C8, C8, C8);
    fp2_add(C8, C8, C8);           // 8Y^4
    fp2_sub(Y3n, Y3n, C8);
    t.X = X3n;
    t.Y = Y3n;
    t.Z = Z3n;
}

// Chord line through T and affine Q evaluated at P, with T <- T + Q
// (Jacobian mixed add).  lambda = r/(ZH) on the twist; scaling l by
// Z3 = ZH (times xi) gives
//   L0 = Z3 xi yp,  L3 = r qx - Z3 qy,  L5 = -r xp.
// Returns false on a degenerate chord (T = +/-Q): callers fall back to
// the reference path, matching its mid-loop-infinity semantics.
static bool add_step(TwistJac& t, Fp12& l, const Fp2& qx, const Fp2& qy,
                     const Fp& px, const Fp& py) {
    Fp2 Z1Z1, U2, S2, H, r;
    fp2_sqr(Z1Z1, t.Z);
    fp2_mul(U2, qx, Z1Z1);
    fp2_mul(S2, qy, t.Z);
    fp2_mul(S2, S2, Z1Z1);
    fp2_sub(H, U2, t.X);
    fp2_sub(r, S2, t.Y);
    if (fp2_is_zero(H)) return false;
    Fp2 HH, HHH, V, r2, X3, Z3, Y3, tmp, YH3;
    fp2_sqr(HH, H);
    fp2_mul(HHH, HH, H);
    fp2_mul(V, t.X, HH);
    fp2_sqr(r2, r);
    fp2_sub(X3, r2, HHH);
    fp2_sub(X3, X3, V);
    fp2_sub(X3, X3, V);
    fp2_mul(Z3, t.Z, H);
    fp2_sub(tmp, V, X3);
    fp2_mul(Y3, r, tmp);
    fp2_mul(YH3, t.Y, HHH);
    fp2_sub(Y3, Y3, YH3);
    Fp2 L0, L3, L5, ra, zb;
    fp2_mul_by_xi(L0, Z3);
    fp2_scale_fp(L0, L0, py);
    fp2_mul(ra, r, qx);
    fp2_mul(zb, Z3, qy);
    fp2_sub(L3, ra, zb);
    fp2_neg(L5, r);
    fp2_scale_fp(L5, L5, px);
    line_to_fp12(l, L0, L3, L5);
    t.X = X3;
    t.Y = Y3;
    t.Z = Z3;
    return true;
}

// Fast Miller function: same divisor as miller_loop (conjugated for
// x < 0), value equal up to Fp2 factors that the final exponentiation
// kills.  Returns false on degenerate chains -> reference fallback.
static bool miller_loop_fast(Fp12& o, const Fp& px, const Fp& py,
                             const Fp2& qx, const Fp2& qy) {
    TwistJac t;
    t.X = qx;
    t.Y = qy;
    memset(&t.Z, 0, sizeof(t.Z));
    t.Z.c0 = FP_ONE;
    Fp12 f = fp12_one();
    int top = 63;
    while (!((BLS_X_ABS >> top) & 1)) top--;
    for (int i = top - 1; i >= 0; i--) {
        Fp12 l;
        fp12_sqr_fast(f, f);
        dbl_step(t, l, px, py);
        if (fp2_is_zero(t.Z)) return false;
        fp12_mul(f, f, l);
        if ((BLS_X_ABS >> i) & 1) {
            if (!add_step(t, l, qx, qy, px, py)) return false;
            if (fp2_is_zero(t.Z)) return false;
            fp12_mul(f, f, l);
        }
    }
    fp12_conj(o, f);  // x < 0
    return true;
}

// Exact final exponentiation f^((p^12-1)/r): easy part, then the hard
// part via e = ((x-1)^2/3)(x+p)(x^2+p^2-1) + 1 (verified identity; x
// negative, u = |x|, conjugation = inversion in the cyclotomic
// subgroup).  Value-identical to fp12_pow_be by the hard exponent.
static void final_exp_fast(Fp12& o, const Fp12& fin) {
    init_frobenius();
    Fp12 c, i1, f, f2;
    fp12_conj(c, fin);
    fp12_inv(i1, fin);
    fp12_mul(f, c, i1);            // f^(p^6 - 1)
    fp12_frob2(f2, f);
    fp12_mul(f, f2, f);            // ^(p^2 + 1)
    const uint64_t U = BLS_X_ABS;
    const uint64_t K = 0x460055555555aaabULL;  // (u+1)/3
    Fp12 a, b, t, af;
    fp12_pow_u64(a, f, K);
    fp12_pow_u64(a, a, U + 1);     // a = f^((x-1)^2/3)
    fp12_pow_u64(t, a, U);
    fp12_conj(t, t);               // a^x
    fp12_frob1(af, a);             // a^p
    fp12_mul(b, t, af);            // b = a^(x+p)
    Fp12 bu, bf, bc, r;
    fp12_pow_u64(bu, b, U);
    fp12_pow_u64(bu, bu, U);       // b^(x^2)
    fp12_frob2(bf, b);             // b^(p^2)
    fp12_conj(bc, b);              // b^(-1)
    fp12_mul(r, bu, bf);
    fp12_mul(r, r, bc);            // b^(x^2+p^2-1)
    fp12_mul(o, r, f);             // f^e = (...) * f
}

}  // namespace

// ---------------------------------------------------------------------------
// Group arithmetic: Jacobian points over Fp (G1) and Fp2 (G2 twist),
// generic via overloads.  Serves the verify-side host ops that were
// Python stand-ins (refimpl g1_msm / g2_mul / point add): the analog of
// the reference's blst scalar-mul calls at src/engine/piano.rs:321-347,
// 402-410.
// ---------------------------------------------------------------------------

inline void fe_add(Fp& o, const Fp& a, const Fp& b) { fp_add(o, a, b); }
inline void fe_sub(Fp& o, const Fp& a, const Fp& b) { fp_sub(o, a, b); }
inline void fe_mul(Fp& o, const Fp& a, const Fp& b) { fp_mul(o, a, b); }
inline void fe_sqr(Fp& o, const Fp& a) { fp_sqr(o, a); }
inline void fe_neg(Fp& o, const Fp& a) { fp_neg(o, a); }
inline bool fe_is_zero(const Fp& a) { return fp_is_zero(a); }
inline bool fe_eq(const Fp& a, const Fp& b) { return fp_eq(a, b); }
inline void fe_add(Fp2& o, const Fp2& a, const Fp2& b) { fp2_add(o, a, b); }
inline void fe_sub(Fp2& o, const Fp2& a, const Fp2& b) { fp2_sub(o, a, b); }
inline void fe_mul(Fp2& o, const Fp2& a, const Fp2& b) { fp2_mul(o, a, b); }
inline void fe_sqr(Fp2& o, const Fp2& a) { fp2_sqr(o, a); }
inline void fe_neg(Fp2& o, const Fp2& a) { fp2_neg(o, a); }
inline bool fe_is_zero(const Fp2& a) { return fp2_is_zero(a); }
inline bool fe_eq(const Fp2& a, const Fp2& b) { return fp2_eq(a, b); }

template <typename F>
struct JacPt {
    F x, y, z;
    bool inf;
};

template <typename F>
static void jac_dbl(JacPt<F>& o, const JacPt<F>& p) {
    if (p.inf) { o = p; return; }
    F a, b, c, d, e, f, t, x3, y3, z3;
    fe_sqr(a, p.x);
    fe_sqr(b, p.y);
    fe_sqr(c, b);
    fe_add(t, p.x, b);
    fe_sqr(t, t);
    fe_sub(t, t, a);
    fe_sub(t, t, c);
    fe_add(d, t, t);               // D = 2((X+B)^2 - A - C)
    fe_add(e, a, a);
    fe_add(e, e, a);               // E = 3A
    fe_sqr(f, e);
    fe_add(t, d, d);
    fe_sub(x3, f, t);              // X3 = F - 2D
    fe_sub(t, d, x3);
    fe_mul(y3, e, t);
    fe_add(c, c, c); fe_add(c, c, c); fe_add(c, c, c);  // 8C
    fe_sub(y3, y3, c);
    fe_mul(z3, p.y, p.z);
    fe_add(z3, z3, z3);
    o.x = x3; o.y = y3; o.z = z3; o.inf = false;
}

template <typename F>
static void jac_add(JacPt<F>& o, const JacPt<F>& p, const JacPt<F>& q) {
    if (p.inf) { o = q; return; }
    if (q.inf) { o = p; return; }
    F z1z1, z2z2, u1, u2, s1, s2, t;
    fe_sqr(z1z1, p.z);
    fe_sqr(z2z2, q.z);
    fe_mul(u1, p.x, z2z2);
    fe_mul(u2, q.x, z1z1);
    fe_mul(t, q.z, z2z2);
    fe_mul(s1, p.y, t);
    fe_mul(t, p.z, z1z1);
    fe_mul(s2, q.y, t);
    if (fe_eq(u1, u2)) {
        if (fe_eq(s1, s2)) { jac_dbl(o, p); return; }
        o.inf = true; return;      // P + (-P)
    }
    F h, i, j, rr, v, x3, y3, z3;
    fe_sub(h, u2, u1);
    fe_add(i, h, h);
    fe_sqr(i, i);                  // I = (2H)^2
    fe_mul(j, h, i);
    fe_sub(rr, s2, s1);
    fe_add(rr, rr, rr);
    fe_mul(v, u1, i);
    fe_sqr(x3, rr);
    fe_sub(x3, x3, j);
    fe_sub(x3, x3, v);
    fe_sub(x3, x3, v);
    fe_sub(t, v, x3);
    fe_mul(y3, rr, t);
    fe_mul(t, s1, j);
    fe_add(t, t, t);
    fe_sub(y3, y3, t);
    fe_add(t, p.z, q.z);
    fe_sqr(t, t);
    fe_sub(t, t, z1z1);
    fe_sub(t, t, z2z2);
    fe_mul(z3, t, h);
    o.x = x3; o.y = y3; o.z = z3; o.inf = false;
}

template <typename F>
static void jac_mul_be(JacPt<F>& o, const JacPt<F>& p,
                       const uint8_t* k, int64_t len) {
    JacPt<F> r;
    r.inf = true;
    bool started = false;
    for (int64_t i = 0; i < len; i++) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) jac_dbl(r, r);
            if ((k[i] >> bit) & 1) {
                jac_add(r, r, p);
                started = true;
            }
        }
    }
    o = r;
}

inline void fe_inv(Fp& o, const Fp& a) { fp_inv(o, a); }
inline void fe_inv(Fp2& o, const Fp2& a) { fp2_inv(o, a); }

template <typename F>
static void jac_affine(F& ox, F& oy, const JacPt<F>& p) {
    F zi, zi2, zi3;
    fe_inv(zi, p.z);
    fe_sqr(zi2, zi);
    fe_mul(zi3, zi2, zi);
    fe_mul(ox, p.x, zi2);
    fe_mul(oy, p.y, zi3);
}

static void fp_to_be(uint8_t* out, const Fp& a) {
    Fp one_raw, canon;
    memset(&one_raw, 0, sizeof(one_raw));
    one_raw.v[0] = 1;
    fp_mul(canon, a, one_raw);  // from Montgomery
    for (int i = 0; i < 6; i++) {
        uint64_t w = canon.v[5 - i];
        for (int j = 0; j < 8; j++) out[i * 8 + j] = (w >> (56 - 8 * j)) & 0xff;
    }
}

static bool g1_from_be(JacPt<Fp>& o, const uint8_t* b) {
    bool inf = true;
    for (int i = 0; i < 96 && inf; i++) inf = b[i] == 0;
    o.inf = inf;
    if (inf) return true;
    fp_from_be(o.x, b);
    fp_from_be(o.y, b + 48);
    o.z = FP_ONE;
    return true;
}

static void g1_to_be(uint8_t* out, const JacPt<Fp>& p) {
    if (p.inf) { memset(out, 0, 96); return; }
    Fp ax, ay;
    jac_affine(ax, ay, p);
    fp_to_be(out, ax);
    fp_to_be(out + 48, ay);
}

static bool g2_from_be(JacPt<Fp2>& o, const uint8_t* b) {
    bool inf = true;
    for (int i = 0; i < 192 && inf; i++) inf = b[i] == 0;
    o.inf = inf;
    if (inf) return true;
    fp_from_be(o.x.c0, b);
    fp_from_be(o.x.c1, b + 48);
    fp_from_be(o.y.c0, b + 96);
    fp_from_be(o.y.c1, b + 144);
    o.z.c0 = FP_ONE;
    o.z.c1 = FP_ZERO;
    return true;
}

static void g2_to_be(uint8_t* out, const JacPt<Fp2>& p) {
    if (p.inf) { memset(out, 0, 192); return; }
    Fp2 ax, ay;
    jac_affine(ax, ay, p);
    fp_to_be(out, ax.c0);
    fp_to_be(out + 48, ax.c1);
    fp_to_be(out + 96, ay.c0);
    fp_to_be(out + 144, ay.c1);
}

extern "C" {

// Product-of-pairings check: prod_i e(P_i, Q_i) == 1.
//
// g1s: n * 96 bytes  (x||y canonical big-endian Fp; all-zero = infinity)
// g2s: n * 192 bytes (x_c0||x_c1||y_c0||y_c1 canonical big-endian)
// p2_be / hard_be: big-endian bytes of p^2 and (p^4 - p^2 + 1)/r.
// Returns 1 (accept), 0 (reject), -1 (degenerate chain: caller must fall
// back to the reference implementation, which errors on such inputs).
int fw_pairings_check(const uint8_t* g1s, const uint8_t* g2s, int64_t n,
                      const uint8_t* p2_be, int64_t p2_len,
                      const uint8_t* hard_be, int64_t hard_len) {
    (void)p2_be; (void)p2_len; (void)hard_be; (void)hard_len;
    init_constants();
    init_twist_constants();
    init_frobenius();  // pre-warm before spawning threads
    // The n Miller loops are independent; run them concurrently (the
    // serve-path check is n=2 or 3 — reference src/engine/piano.rs
    // :358-388,422-464 — so this roughly halves the check latency).
    std::vector<Fp12> ms((size_t)n);
    std::vector<int> status((size_t)n, 1);  // 1 ok, 0 degenerate
    // char, not bool: vector<bool> packs bits, so concurrent writes to
    // neighbouring entries from the worker threads would race.
    std::vector<char> skip((size_t)n, 0);
    auto work = [&](int64_t k) {
        const uint8_t* g1 = g1s + 96 * k;
        const uint8_t* g2 = g2s + 192 * k;
        bool g1_inf = true, g2_inf = true;
        for (int i = 0; i < 96 && g1_inf; i++) g1_inf = g1[i] == 0;
        for (int i = 0; i < 192 && g2_inf; i++) g2_inf = g2[i] == 0;
        if (g1_inf || g2_inf) {  // e(O, Q) = e(P, O) = 1
            skip[(size_t)k] = 1;
            return;
        }
        Fp px, py;
        fp_from_be(px, g1);
        fp_from_be(py, g1 + 48);
        Fp2 qx, qy;
        fp_from_be(qx.c0, g2);
        fp_from_be(qx.c1, g2 + 48);
        fp_from_be(qy.c0, g2 + 96);
        fp_from_be(qy.c1, g2 + 144);
        if (!miller_loop_fast(ms[(size_t)k], px, py, qx, qy))
            status[(size_t)k] = 0;
    };
    if (n > 1) {
        std::vector<std::thread> th;
        th.reserve((size_t)n);
        for (int64_t k = 0; k < n; k++) th.emplace_back(work, k);
        for (auto& t : th) t.join();
    } else {
        for (int64_t k = 0; k < n; k++) work(k);
    }
    Fp12 f = fp12_one();
    for (int64_t k = 0; k < n; k++) {
        if (!status[(size_t)k]) return -1;
        if (!skip[(size_t)k]) fp12_mul(f, f, ms[(size_t)k]);
    }
    final_exp_fast(f, f);
    return fp12_is_one(f) ? 1 : 0;
}

// Debug/test export: full pairing e(P, Q), written as 12*48 canonical BE
// bytes (tower order c0..c1, each Fp6 c0.c0,c0.c1,c1.c0,... matching the
// Python refimpl field order).
static void write_fp12_be(uint8_t* out, const Fp12& f);

int fw_pairing(const uint8_t* g1, const uint8_t* g2,
               const uint8_t* p2_be, int64_t p2_len,
               const uint8_t* hard_be, int64_t hard_len, uint8_t* out) {
    (void)p2_be; (void)p2_len; (void)hard_be; (void)hard_len;
    init_constants();
    Fp px, py;
    fp_from_be(px, g1);
    fp_from_be(py, g1 + 48);
    Fp2 qx, qy;
    fp_from_be(qx.c0, g2);
    fp_from_be(qx.c1, g2 + 48);
    fp_from_be(qy.c0, g2 + 96);
    fp_from_be(qy.c1, g2 + 144);
    Fp12 f;
    if (!miller_loop_fast(f, px, py, qx, qy)) return -1;
    final_exp_fast(f, f);
    write_fp12_be(out, f);
    return 0;
}

// Reference-path pairing (affine Fp12 Miller loop + generic pow final
// exp, mirroring refimpl/pairing.py) — kept as a cross-check oracle for
// the fast path; tests assert fw_pairing == fw_pairing_ref.
int fw_pairing_ref(const uint8_t* g1, const uint8_t* g2,
                   const uint8_t* p2_be, int64_t p2_len,
                   const uint8_t* hard_be, int64_t hard_len, uint8_t* out) {
    init_constants();
    Fp px, py;
    fp_from_be(px, g1);
    fp_from_be(py, g1 + 48);
    Fp2 qx, qy;
    fp_from_be(qx.c0, g2);
    fp_from_be(qx.c1, g2 + 48);
    fp_from_be(qy.c0, g2 + 96);
    fp_from_be(qy.c1, g2 + 144);
    Fp12 f;
    if (!miller_loop(f, px, py, qx, qy)) return -1;
    Fp12 conj, inv, t;
    fp12_conj(conj, f);
    fp12_inv(inv, f);
    fp12_mul(f, conj, inv);
    fp12_pow_be(t, f, p2_be, p2_len);
    fp12_mul(f, t, f);
    fp12_pow_be(f, f, hard_be, hard_len);
    write_fp12_be(out, f);
    return 0;
}

static void write_fp12_be(uint8_t* out, const Fp12& f) {
    const Fp* fps[12] = {
        &f.c0.c0.c0, &f.c0.c0.c1, &f.c0.c1.c0, &f.c0.c1.c1,
        &f.c0.c2.c0, &f.c0.c2.c1, &f.c1.c0.c0, &f.c1.c0.c1,
        &f.c1.c1.c0, &f.c1.c1.c1, &f.c1.c2.c0, &f.c1.c2.c1,
    };
    for (int k = 0; k < 12; k++) {
        // from Montgomery: multiply by 1
        Fp one_raw;
        memset(&one_raw, 0, sizeof(one_raw));
        one_raw.v[0] = 1;
        Fp canon;
        fp_mul(canon, *fps[k], one_raw);
        for (int i = 0; i < 6; i++) {
            uint64_t w = canon.v[5 - i];
            for (int j = 0; j < 8; j++)
                out[48 * k + 8 * i + j] = (uint8_t)(w >> (8 * (7 - j)));
        }
    }
}

// G1 MSM: out = sum_i scalars[i] * P_i.  Affine BE in/out (96 B per
// point, all-zero = infinity); scalars 32-byte BE.  Double-and-add per
// point — the verify path's MSMs are tiny (M <= 2^m points).
int fw_g1_msm(const uint8_t* pts, const uint8_t* scalars, int64_t n,
              uint8_t* out) {
    init_constants();
    JacPt<Fp> acc;
    acc.inf = true;
    for (int64_t i = 0; i < n; i++) {
        JacPt<Fp> p, t;
        g1_from_be(p, pts + 96 * i);
        if (p.inf) continue;
        jac_mul_be(t, p, scalars + 32 * i, 32);
        jac_add(acc, acc, t);
    }
    g1_to_be(out, acc);
    return 0;
}

// G1 linear combine of two points: out = a (+/-) b.
int fw_g1_add(const uint8_t* a, const uint8_t* b, int negate_b,
              uint8_t* out) {
    init_constants();
    JacPt<Fp> pa, pb;
    g1_from_be(pa, a);
    g1_from_be(pb, b);
    if (negate_b && !pb.inf) fp_neg(pb.y, pb.y);
    JacPt<Fp> r;
    jac_add(r, pa, pb);
    g1_to_be(out, r);
    return 0;
}

// G2 scalar multiple: out = k * Q (192-byte BE affine, 32-byte BE k).
int fw_g2_mul(const uint8_t* pt, const uint8_t* k, uint8_t* out) {
    init_constants();
    JacPt<Fp2> q, r;
    g2_from_be(q, pt);
    if (q.inf) { memset(out, 0, 192); return 0; }
    jac_mul_be(r, q, k, 32);
    g2_to_be(out, r);
    return 0;
}

// G2 combine: out = a (+/-) b.
int fw_g2_add(const uint8_t* a, const uint8_t* b, int negate_b,
              uint8_t* out) {
    init_constants();
    JacPt<Fp2> pa, pb;
    g2_from_be(pa, a);
    g2_from_be(pb, b);
    if (negate_b && !pb.inf) fp2_neg(pb.y, pb.y);
    JacPt<Fp2> r;
    jac_add(r, pa, pb);
    g2_to_be(out, r);
    return 0;
}

}  // extern "C"
