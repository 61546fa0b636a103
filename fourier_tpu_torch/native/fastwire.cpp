// Native wire-marshalling kernels: base64 <-> bytes <-> 16-bit limbs.
//
// The reference's runtime is native end-to-end (Rust + blst); its wire
// cost is dominated by per-coefficient base64 and byte-order conversion
// (rpc.rs handlers, kzg::io_utils::batch_reader).  Here the TPU owns the
// math and the host owns marshalling; this translation unit is the
// host-side hot path: batch base64 decode/encode and big-endian byte <->
// little-endian limb conversion, with canonicality checking fused in.
//
// C ABI only (consumed via ctypes).  Build: make native  (g++ -O3 -shared).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int8_t DECODE_TABLE[256];
const char ENCODE_TABLE[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

struct TableInit {
    TableInit() {
        memset(DECODE_TABLE, -1, sizeof(DECODE_TABLE));
        for (int i = 0; i < 64; i++) DECODE_TABLE[(uint8_t)ENCODE_TABLE[i]] = (int8_t)i;
    }
} table_init;

// Decode one STRICT unpadded base64 string into exactly out_len bytes.
// Matches the reference's STANDARD_NO_PAD engine: '=' padding, invalid
// symbols, and nonzero unused trailing bits in the last symbol are all
// rejected, so each byte string has exactly one accepted encoding.
// Returns 0 on success.
int decode_one(const char* s, int64_t len, uint8_t* out, int64_t out_len) {
    if ((len * 3) / 4 != out_len || len % 4 == 1) return 1;
    int64_t oi = 0;
    uint32_t buf = 0;
    int bits = 0;
    for (int64_t i = 0; i < len; i++) {
        int8_t v = DECODE_TABLE[(uint8_t)s[i]];
        if (v < 0) return 2;  // includes '=' (never in the table)
        buf = (buf << 6) | (uint32_t)v;
        bits += 6;
        if (bits >= 8) {
            bits -= 8;
            out[oi++] = (uint8_t)(buf >> bits);
        }
    }
    if (bits > 0 && (buf & ((1u << bits) - 1)) != 0) return 4;
    return oi == out_len ? 0 : 3;
}

void encode_one(const uint8_t* in, int64_t in_len, char* out, int64_t* out_len) {
    int64_t oi = 0;
    int64_t i = 0;
    for (; i + 3 <= in_len; i += 3) {
        uint32_t v = (in[i] << 16) | (in[i + 1] << 8) | in[i + 2];
        out[oi++] = ENCODE_TABLE[(v >> 18) & 63];
        out[oi++] = ENCODE_TABLE[(v >> 12) & 63];
        out[oi++] = ENCODE_TABLE[(v >> 6) & 63];
        out[oi++] = ENCODE_TABLE[v & 63];
    }
    int64_t rem = in_len - i;
    if (rem == 1) {
        uint32_t v = in[i] << 16;
        out[oi++] = ENCODE_TABLE[(v >> 18) & 63];
        out[oi++] = ENCODE_TABLE[(v >> 12) & 63];
    } else if (rem == 2) {
        uint32_t v = (in[i] << 16) | (in[i + 1] << 8);
        out[oi++] = ENCODE_TABLE[(v >> 18) & 63];
        out[oi++] = ENCODE_TABLE[(v >> 12) & 63];
        out[oi++] = ENCODE_TABLE[(v >> 6) & 63];
    }
    *out_len = oi;
}

// Thread cap for par_chunks: FOURIER_WIRE_THREADS overrides (containers
// can report 0 or the whole host via hardware_concurrency, and N
// concurrent large-body RPC handlers each spawn their own batch — the
// cap bounds total oversubscription at N * cap).
static int64_t wire_thread_cap() {
    static int64_t cap = [] {
        const char* s = getenv("FOURIER_WIRE_THREADS");
        if (s && *s) {
            long v = atol(s);
            if (v >= 1 && v <= 256) return (int64_t)v;
        }
        unsigned hw = std::thread::hardware_concurrency();
        int64_t nt = (int64_t)(hw ? hw : 1);
        return nt > 8 ? (int64_t)8 : nt;
    }();
    return cap;
}

// Data-parallel batch driver: ctypes releases the GIL for the whole
// call, so the wire kernels below fan their item loops over threads
// (the RPC body for a scale-20 worker is ~24 MB of base64 — the decode
// was the largest single serving-path cost after the MSM itself).
template <class F>
static void par_chunks(int64_t n, F f) {
    int64_t nt = wire_thread_cap();
    if (n < 8192 || nt <= 1) {
        f((int64_t)0, n);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (n + nt - 1) / nt;
    for (int64_t t = 0; t < nt; t++) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        ts.emplace_back([=] { f(lo, hi); });
    }
    for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Decode n base64 items (concatenated, offsets[n+1] delimits) into
// n * item_len bytes.  Returns -1 on success, else the index of the first
// malformed item.
int64_t fw_b64decode_many(const char* data, const int64_t* offsets, int64_t n,
                          uint8_t* out, int64_t item_len) {
    std::atomic<int64_t> bad(-1);
    par_chunks(n, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            if (decode_one(data + offsets[k], offsets[k + 1] - offsets[k],
                           out + k * item_len, item_len) != 0) {
                int64_t cur = bad.load();
                while ((cur == -1 || k < cur) &&
                       !bad.compare_exchange_weak(cur, k)) {}
                return;
            }
        }
    });
    return bad.load();
}

// Encode n items of item_len bytes as unpadded base64, '\n'-separated is
// not used: fixed stride out_stride = ceil(item_len*4/3) (unpadded length).
void fw_b64encode_many(const uint8_t* data, int64_t n, int64_t item_len,
                       char* out, int64_t out_stride) {
    par_chunks(n, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            int64_t written = 0;
            encode_one(data + k * item_len, item_len, out + k * out_stride,
                       &written);
        }
    });
}

// Big-endian nbytes-wide values -> little-endian 16-bit limbs in uint32.
// out shape: [n, n_limbs] row-major.
void fw_be_to_limbs(const uint8_t* in, int64_t n, int64_t nbytes,
                    uint32_t* out, int64_t n_limbs) {
    const int64_t pairs = nbytes / 2;
    par_chunks(n, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            const uint8_t* row = in + k * nbytes;
            uint32_t* o = out + k * n_limbs;
            for (int64_t l = 0; l < n_limbs; l++) {
                if (l < pairs) {
                    int64_t hi_idx = nbytes - 2 - 2 * l;
                    o[l] = ((uint32_t)row[hi_idx] << 8) | row[hi_idx + 1];
                } else {
                    o[l] = 0;
                }
            }
        }
    });
}

// Little-endian 16-bit limbs -> big-endian nbytes encodings.
void fw_limbs_to_be(const uint32_t* in, int64_t n, int64_t n_limbs,
                    uint8_t* out, int64_t nbytes) {
    par_chunks(n, [&](int64_t lo, int64_t hi) {
        for (int64_t k = lo; k < hi; k++) {
            const uint32_t* row = in + k * n_limbs;
            uint8_t* o = out + k * nbytes;
            memset(o, 0, nbytes);
            for (int64_t l = 0; l < n_limbs && 2 * l + 1 < nbytes; l++) {
                o[nbytes - 1 - 2 * l] = (uint8_t)(row[l] & 0xff);
                o[nbytes - 2 - 2 * l] = (uint8_t)((row[l] >> 8) & 0xff);
            }
        }
    });
}

// Fused scalar wire decode: base64 -> 32B BE -> [n, n_limbs] limbs with a
// canonicality check against the (BE) modulus bytes.  Returns -1 on
// success, else the index of the first bad item (malformed or >= modulus).
int64_t fw_decode_scalars(const char* data, const int64_t* offsets, int64_t n,
                          const uint8_t* modulus_be, uint32_t* out,
                          int64_t n_limbs) {
    std::atomic<int64_t> bad(-1);
    par_chunks(n, [&](int64_t lo, int64_t hi) {
        uint8_t buf[32];
        for (int64_t k = lo; k < hi; k++) {
            // canonical: buf < modulus (big-endian lexicographic)
            if (decode_one(data + offsets[k], offsets[k + 1] - offsets[k],
                           buf, 32) != 0 ||
                memcmp(buf, modulus_be, 32) >= 0) {
                int64_t cur = bad.load();
                while ((cur == -1 || k < cur) &&
                       !bad.compare_exchange_weak(cur, k)) {}
                return;
            }
            uint32_t* o = out + k * n_limbs;
            for (int64_t l = 0; l < n_limbs; l++) {
                if (2 * l + 1 < 32) {
                    o[l] = ((uint32_t)buf[32 - 2 - 2 * l] << 8) |
                           buf[32 - 1 - 2 * l];
                } else {
                    o[l] = 0;
                }
            }
        }
    });
    return bad.load();
}

}  // extern "C"
