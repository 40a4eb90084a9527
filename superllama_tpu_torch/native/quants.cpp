// Native quant codecs of superllama_tpu_torch: decode, encode and the
// load-path repack of the ggml block formats (the format layouts of
// ggml/src/ggml-quants.c). Bit-identical to the numpy codecs in
// gguf/quants.py, gguf/kquant_search.py and ops/qtensor.py::_extract, which
// stay the plain version it is tested against. A type this library does not
// cover (slq_supported returns 0) takes the numpy codec; a failed build or
// load raises (native/__init__.py).
//
// Build (native/__init__.py does it at first use):
//   g++ -O3 -ffp-contract=off -std=c++17 -shared -fPIC -pthread quants.cpp
// -ffp-contract=off keeps the weighted K-quant searches bit-identical to
// numpy: a fused multiply-add would change their sums and flip decisions.
//
// Every entry point takes `threads`: the host threads it may use (0: every
// core). The loader repacks several tensors at once and divides the cores
// among them.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// ----------------------------- half conversion ------------------------------

inline float half_to_float(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FFu;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {  // subnormal: value = man · 2^-24 → normalize
            int s = 0;
            uint32_t m = man;
            while (!(m & 0x400u)) { m <<= 1; s++; }
            m &= 0x3FFu;
            bits = sign | (uint32_t)(113 - s) << 23 | (m << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

inline uint16_t float_to_half(float f) {  // round-to-nearest-even
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    uint32_t fexp = (x >> 23) & 0xFFu;
    uint32_t man = x & 0x7FFFFFu;
    if (fexp == 0xFF) return (uint16_t)(sign | 0x7C00u | (man ? 0x200u : 0));
    int32_t exp = (int32_t)fexp - 127 + 15;
    if (exp >= 31) return (uint16_t)(sign | 0x7C00u);
    if (exp <= 0) {
        if (exp < -10) return (uint16_t)sign;
        man |= 0x800000u;
        uint32_t shift = (uint32_t)(14 - exp);
        uint32_t hman = man >> shift;
        uint32_t rem = man & ((1u << shift) - 1);
        uint32_t halfway = 1u << (shift - 1);
        if (rem > halfway || (rem == halfway && (hman & 1))) hman++;
        return (uint16_t)(sign | hman);
    }
    uint16_t h = (uint16_t)(sign | ((uint32_t)exp << 10) | (man >> 13));
    uint32_t rem = man & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (h & 1))) h++;
    return h;
}

inline uint16_t rd_u16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
inline uint32_t rd_u32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline void wr_u16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }
inline void wr_u32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }

inline float h2f(const uint8_t* p) { return half_to_float(rd_u16(p)); }
inline void f2h(uint8_t* p, float f) { wr_u16(p, float_to_half(f)); }

// np.round: half to even
inline float npround(float x) { return std::nearbyintf(x); }

const float KV_MXFP4[16] = {0, 1, 2, 3, 4, 6, 8, 12,
                            0, -1, -2, -3, -4, -6, -8, -12};
const float KV_IQ4NL[16] = {-127, -104, -83, -65, -49, -35, -22, -10,
                            1, 13, 25, 38, 53, 69, 89, 113};

inline float e8m0_half(uint8_t e) {
    uint32_t bits = e < 2 ? (0x00200000u << e) : ((uint32_t)(e - 1) << 23);
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

inline uint8_t fp32_to_e8m0_half(float d) {
    if (!(d > 0)) return 0;
    float e = std::ceil(std::log2f(d)) + 128.0f;
    if (e < 0) e = 0;
    if (e > 254) e = 254;
    return (uint8_t)e;
}

// ------------------------------- dequantizers --------------------------------
// Each operates on ONE block; the driver loops/threads over blocks.

void deq_q4_0(const uint8_t* b, float* y) {
    float d = h2f(b);
    for (int i = 0; i < 16; i++) {
        y[i] = (float)((int)(b[2 + i] & 0x0F) - 8) * d;
        y[16 + i] = (float)((int)(b[2 + i] >> 4) - 8) * d;
    }
}

void deq_q4_1(const uint8_t* b, float* y) {
    float d = h2f(b), m = h2f(b + 2);
    for (int i = 0; i < 16; i++) {
        y[i] = (float)(b[4 + i] & 0x0F) * d + m;
        y[16 + i] = (float)(b[4 + i] >> 4) * d + m;
    }
}

void deq_q5_0(const uint8_t* b, float* y) {
    float d = h2f(b);
    uint32_t qh = rd_u32(b + 2);
    for (int i = 0; i < 16; i++) {
        uint32_t xh0 = ((qh >> i) << 4) & 0x10;
        uint32_t xh1 = (qh >> (i + 12)) & 0x10;
        y[i] = (float)((int)((b[6 + i] & 0x0F) | xh0) - 16) * d;
        y[16 + i] = (float)((int)((b[6 + i] >> 4) | xh1) - 16) * d;
    }
}

void deq_q5_1(const uint8_t* b, float* y) {
    float d = h2f(b), m = h2f(b + 2);
    uint32_t qh = rd_u32(b + 4);
    for (int i = 0; i < 16; i++) {
        uint32_t xh0 = ((qh >> i) << 4) & 0x10;
        uint32_t xh1 = (qh >> (i + 12)) & 0x10;
        y[i] = (float)((b[8 + i] & 0x0F) | xh0) * d + m;
        y[16 + i] = (float)((b[8 + i] >> 4) | xh1) * d + m;
    }
}

void deq_q8_0(const uint8_t* b, float* y) {
    float d = h2f(b);
    for (int i = 0; i < 32; i++) y[i] = (float)(int8_t)b[2 + i] * d;
}

void deq_mxfp4(const uint8_t* b, float* y) {
    float d = e8m0_half(b[0]);
    for (int i = 0; i < 16; i++) {
        y[i] = KV_MXFP4[b[1 + i] & 0x0F] * d;
        y[16 + i] = KV_MXFP4[b[1 + i] >> 4] * d;
    }
}

void deq_iq4_nl(const uint8_t* b, float* y) {
    float d = h2f(b);
    for (int i = 0; i < 16; i++) {
        y[i] = KV_IQ4NL[b[2 + i] & 0x0F] * d;
        y[16 + i] = KV_IQ4NL[b[2 + i] >> 4] * d;
    }
}

inline void unpack_scale_min_k4(const uint8_t* s, uint8_t* sc, uint8_t* mn) {
    for (int j = 0; j < 4; j++) {
        sc[j] = s[j] & 63;
        mn[j] = s[j + 4] & 63;
    }
    for (int j = 4; j < 8; j++) {
        sc[j] = (s[j + 4] & 0x0F) | ((s[j - 4] >> 6) << 4);
        mn[j] = (s[j + 4] >> 4) | ((s[j] >> 6) << 4);
    }
}

inline void pack_scale_min_k4(const uint8_t* sc, const uint8_t* mn, uint8_t* out) {
    for (int j = 0; j < 4; j++) {
        out[j] = (sc[j] & 63) | ((sc[j + 4] >> 4) << 6);
        out[j + 4] = (mn[j] & 63) | ((mn[j + 4] >> 4) << 6);
        out[j + 8] = (sc[j + 4] & 0x0F) | ((mn[j + 4] & 0x0F) << 4);
    }
}

void deq_q4_k(const uint8_t* b, float* y) {
    float d = h2f(b), dmin = h2f(b + 2);
    uint8_t sc[8], mn[8];
    unpack_scale_min_k4(b + 4, sc, mn);
    const uint8_t* qs = b + 16;
    for (int j = 0; j < 4; j++) {
        float d1 = d * sc[2 * j], m1 = dmin * mn[2 * j];
        float d2 = d * sc[2 * j + 1], m2 = dmin * mn[2 * j + 1];
        for (int i = 0; i < 32; i++) {
            uint8_t q = qs[j * 32 + i];
            y[j * 64 + i] = d1 * (float)(q & 0x0F) - m1;
            y[j * 64 + 32 + i] = d2 * (float)(q >> 4) - m2;
        }
    }
}

void deq_q5_k(const uint8_t* b, float* y) {
    float d = h2f(b), dmin = h2f(b + 2);
    uint8_t sc[8], mn[8];
    unpack_scale_min_k4(b + 4, sc, mn);
    const uint8_t* qh = b + 16;
    const uint8_t* ql = b + 48;
    for (int j = 0; j < 4; j++) {
        float d1 = d * sc[2 * j], m1 = dmin * mn[2 * j];
        float d2 = d * sc[2 * j + 1], m2 = dmin * mn[2 * j + 1];
        uint8_t u1 = 1 << (2 * j), u2 = 2 << (2 * j);
        for (int i = 0; i < 32; i++) {
            uint8_t q = ql[j * 32 + i];
            float h1 = (qh[i] & u1) ? 16.0f : 0.0f;
            float h2 = (qh[i] & u2) ? 16.0f : 0.0f;
            y[j * 64 + i] = d1 * ((float)(q & 0x0F) + h1) - m1;
            y[j * 64 + 32 + i] = d2 * ((float)(q >> 4) + h2) - m2;
        }
    }
}

void deq_q6_k(const uint8_t* b, float* y) {
    const uint8_t* ql = b;
    const uint8_t* qh = b + 128;
    const int8_t* sc = (const int8_t*)(b + 192);
    float d = h2f(b + 208);
    for (int n = 0; n < 256; n += 128) {
        const uint8_t* lq = ql + n / 2;
        const uint8_t* hq = qh + n / 4;
        const int8_t* s = sc + n / 16;
        for (int l = 0; l < 32; l++) {
            int is = l / 16;
            int q1 = (int)((lq[l] & 0x0F) | (((hq[l] >> 0) & 3) << 4)) - 32;
            int q2 = (int)((lq[l + 32] & 0x0F) | (((hq[l] >> 2) & 3) << 4)) - 32;
            int q3 = (int)((lq[l] >> 4) | (((hq[l] >> 4) & 3) << 4)) - 32;
            int q4 = (int)((lq[l + 32] >> 4) | (((hq[l] >> 6) & 3) << 4)) - 32;
            y[n + l] = d * (float)s[is] * (float)q1;
            y[n + l + 32] = d * (float)s[is + 2] * (float)q2;
            y[n + l + 64] = d * (float)s[is + 4] * (float)q3;
            y[n + l + 96] = d * (float)s[is + 6] * (float)q4;
        }
    }
}

void deq_q2_k(const uint8_t* b, float* y) {
    const uint8_t* scales = b;
    const uint8_t* qs = b + 16;
    float d = h2f(b + 80), dmin = h2f(b + 82);
    int out = 0, is = 0;
    for (int n = 0; n < 256; n += 128) {
        const uint8_t* q = qs + n / 4;
        for (int shift = 0; shift < 8; shift += 2) {
            for (int half = 0; half < 32; half += 16) {
                float dl = d * (float)(scales[is] & 0x0F);
                float ml = dmin * (float)(scales[is] >> 4);
                for (int i = 0; i < 16; i++) {
                    y[out + i] = dl * (float)((q[half + i] >> shift) & 3) - ml;
                }
                out += 16;
                is++;
            }
        }
    }
}

inline void q3k_unpack_scales(const uint8_t* s, int8_t* sc) {
    // 12 bytes → 16 6-bit values (dequantize_row_q3_K kmask unpack; matches
    // gguf/quants.py _q3k_unpack_scales byte-for-byte)
    for (int c = 0; c < 4; c++) {
        sc[c]      = (int8_t)((s[c] & 0x0F)     | (((s[8 + c] >> 0) & 3) << 4));
        sc[4 + c]  = (int8_t)((s[4 + c] & 0x0F) | (((s[8 + c] >> 2) & 3) << 4));
        sc[8 + c]  = (int8_t)((s[c] >> 4)       | (((s[8 + c] >> 4) & 3) << 4));
        sc[12 + c] = (int8_t)((s[4 + c] >> 4)   | (((s[8 + c] >> 6) & 3) << 4));
    }
}

inline void q3k_pack_scales(const uint8_t* ls, uint8_t* out) {
    // inverse of q3k_unpack_scales: 16 values [0,63] → 12 bytes
    for (int c = 0; c < 4; c++) {
        out[c]     = (uint8_t)((ls[c] & 0x0F) | ((ls[8 + c] & 0x0F) << 4));
        out[4 + c] = (uint8_t)((ls[4 + c] & 0x0F) | ((ls[12 + c] & 0x0F) << 4));
        out[8 + c] = (uint8_t)((ls[c] >> 4) | ((ls[4 + c] >> 4) << 2) |
                               ((ls[8 + c] >> 4) << 4) | ((ls[12 + c] >> 4) << 6));
    }
}

void deq_q3_k(const uint8_t* b, float* y) {
    const uint8_t* hm = b;
    const uint8_t* qs = b + 32;
    int8_t sc[16];
    q3k_unpack_scales(b + 96, sc);
    float d = h2f(b + 108);
    int out = 0, is = 0, m = 1;
    for (int n = 0; n < 256; n += 128) {
        const uint8_t* q = qs + n / 4;
        for (int shift = 0; shift < 8; shift += 2) {
            for (int half = 0; half < 32; half += 16) {
                float dl = d * ((float)sc[is] - 32.0f);
                for (int i = 0; i < 16; i++) {
                    int low = (q[half + i] >> shift) & 3;
                    int hbit = (hm[half + i] & m) ? 0 : 4;
                    y[out + i] = dl * (float)(low - hbit);
                }
                out += 16;
                is++;
            }
            m <<= 1;
        }
    }
}

void deq_q8_k(const uint8_t* b, float* y) {
    float d;
    std::memcpy(&d, b, 4);
    const int8_t* q = (const int8_t*)(b + 4);
    for (int i = 0; i < 256; i++) y[i] = d * (float)q[i];
}

void deq_iq4_xs(const uint8_t* b, float* y) {
    float d = h2f(b);
    uint16_t scales_h = rd_u16(b + 2);
    const uint8_t* scales_l = b + 4;
    const uint8_t* qs = b + 8;
    for (int ib = 0; ib < 8; ib++) {
        int ls = ((scales_l[ib / 2] >> (4 * (ib % 2))) & 0x0F) |
                 (((scales_h >> (2 * ib)) & 3) << 4);
        float dl = d * ((float)ls - 32.0f);
        const uint8_t* q = qs + ib * 16;
        for (int i = 0; i < 16; i++) {
            y[ib * 32 + i] = dl * KV_IQ4NL[q[i] & 0x0F];
            y[ib * 32 + 16 + i] = dl * KV_IQ4NL[q[i] >> 4];
        }
    }
}

void deq_tq1_0(const uint8_t* b, float* y) {
    // ternary base-3: 5 trits/byte for qs, 4 trits/byte for qh
    // (dequantize_row_tq1_0)
    const uint8_t* qs = b;
    const uint8_t* qh = b + 48;
    float d = h2f(b + 52);
    static const int pow3[5] = {1, 3, 9, 27, 81};
    int pos = 0;
    static const int starts[2] = {0, 32}, widths[2] = {32, 16};
    for (int s = 0; s < 2; s++) {
        for (int m = 0; m < 5; m++) {
            for (int i = 0; i < widths[s]; i++) {
                int q = ((qs[starts[s] + i] * pow3[m]) & 0xFF) * 3 / 256;
                y[pos + i] = ((float)q - 1.0f) * d;
            }
            pos += widths[s];
        }
    }
    for (int m = 0; m < 4; m++) {
        for (int i = 0; i < 4; i++) {
            int q = ((qh[i] * pow3[m]) & 0xFF) * 3 / 256;
            y[pos + i] = ((float)q - 1.0f) * d;
        }
        pos += 4;
    }
}

void deq_tq2_0(const uint8_t* b, float* y) {
    const uint8_t* qs = b;
    float d = h2f(b + 64);
    int pos = 0;
    for (int j = 0; j < 64; j += 32) {
        for (int shift = 0; shift < 8; shift += 2) {
            for (int i = 0; i < 32; i++)
                y[pos + i] = ((float)((qs[j + i] >> shift) & 3) - 1.0f) * d;
            pos += 32;
        }
    }
}

// ----------------------- codebook i-quants (decode) --------------------------
// Lattice grids are injected at load time from gguf/iq_grids.npz via
// slq_set_iq_grids (the shared ecosystem tables; ggml-common.h iq*_grid).

uint8_t g_iq2xxs[256 * 8], g_iq2xs[512 * 8], g_iq2s[1024 * 8];
uint8_t g_iq3xxs[256 * 4], g_iq3s[512 * 4];
int8_t g_iq1s[2048 * 8];
bool g_grids = false;

inline float mulsgn(float x, uint8_t sbyte, int j) {
    // x * (bit ? -1 : +1) with x86 mulss NaN semantics (return the NaN
    // operand unchanged) — gcc folds a literal *-1.0f into a sign-bit flip,
    // which would diverge from the numpy reference on NaN-scaled blocks
    if (((sbyte >> j) & 1) == 0) return x;
    return std::isnan(x) ? x : -x;
}

inline uint8_t ksign(uint8_t i) {  // ksigns_iq2xs: index | odd-parity bit
    return (uint8_t)(i | ((__builtin_popcount(i) & 1) << 7));
}

void deq_iq2_xxs(const uint8_t* bp, float* y) {
    float d = h2f(bp);
    const uint8_t* q = bp + 2;
    for (int g = 0; g < 8; g++) {
        uint16_t w[4];
        std::memcpy(w, q + 8 * g, 8);
        uint32_t aux0 = w[0] | ((uint32_t)w[1] << 16);
        uint32_t aux1 = w[2] | ((uint32_t)w[3] << 16);
        float db = d * (0.5f + (float)(aux1 >> 28)) * 0.25f;
        for (int l = 0; l < 4; l++) {
            const uint8_t* vals = g_iq2xxs + ((aux0 >> (8 * l)) & 255) * 8;
            uint8_t sb = ksign((uint8_t)((aux1 >> (7 * l)) & 127));
            for (int j = 0; j < 8; j++)
                y[g * 32 + l * 8 + j] = mulsgn(db * (float)vals[j], sb, j);
        }
    }
}

void deq_iq2_xs(const uint8_t* bp, float* y) {
    float d = h2f(bp);
    uint16_t q16[32];
    std::memcpy(q16, bp + 2, 64);
    const uint8_t* sc = bp + 66;
    for (int g = 0; g < 8; g++) {
        float db0 = d * (0.5f + (float)(sc[g] & 0x0F)) * 0.25f;
        float db1 = d * (0.5f + (float)(sc[g] >> 4)) * 0.25f;
        for (int l = 0; l < 4; l++) {
            uint16_t w = q16[g * 4 + l];
            const uint8_t* vals = g_iq2xs + (w & 511) * 8;
            uint8_t sb = ksign((uint8_t)(w >> 9));
            float db = l < 2 ? db0 : db1;
            for (int j = 0; j < 8; j++)
                y[g * 32 + l * 8 + j] = mulsgn(db * (float)vals[j], sb, j);
        }
    }
}

void deq_iq2_s(const uint8_t* bp, float* y) {
    float d = h2f(bp);
    const uint8_t* qs = bp + 2;
    const uint8_t* signs = bp + 34;
    const uint8_t* qh = bp + 66;
    const uint8_t* sc = bp + 74;
    for (int g = 0; g < 8; g++) {
        float db0 = d * (0.5f + (float)(sc[g] & 0x0F)) * 0.25f;
        float db1 = d * (0.5f + (float)(sc[g] >> 4)) * 0.25f;
        for (int l = 0; l < 4; l++) {
            uint16_t idx = (uint16_t)qs[g * 4 + l] |
                           (((uint16_t)qh[g] << (8 - 2 * l)) & 0x300);
            const uint8_t* vals = g_iq2s + idx * 8;
            uint8_t sb = signs[g * 4 + l];
            float db = l < 2 ? db0 : db1;
            for (int j = 0; j < 8; j++)
                y[g * 32 + l * 8 + j] = mulsgn(db * (float)vals[j], sb, j);
        }
    }
}

void deq_iq3_xxs(const uint8_t* bp, float* y) {
    float d = h2f(bp);
    const uint8_t* qs = bp + 2;
    for (int g = 0; g < 8; g++) {
        uint32_t sas;
        std::memcpy(&sas, bp + 66 + 4 * g, 4);
        float db = d * (0.5f + (float)(sas >> 28)) * 0.5f;
        for (int l = 0; l < 4; l++) {
            const uint8_t* v0 = g_iq3xxs + qs[g * 8 + l * 2] * 4;
            const uint8_t* v1 = g_iq3xxs + qs[g * 8 + l * 2 + 1] * 4;
            uint8_t sb = ksign((uint8_t)((sas >> (7 * l)) & 127));
            for (int j = 0; j < 4; j++) {
                y[g * 32 + l * 8 + j] = mulsgn(db * (float)v0[j], sb, j);
                y[g * 32 + l * 8 + 4 + j] = mulsgn(db * (float)v1[j], sb, 4 + j);
            }
        }
    }
}

void deq_iq3_s(const uint8_t* bp, float* y) {
    float d = h2f(bp);
    const uint8_t* qs = bp + 2;
    const uint8_t* qh = bp + 66;
    const uint8_t* signs = bp + 74;
    const uint8_t* sc = bp + 106;
    for (int g = 0; g < 8; g++) {
        int ls = (g % 2 == 0) ? (sc[g / 2] & 0x0F) : (sc[g / 2] >> 4);
        float db = d * (1.0f + 2.0f * (float)ls);
        for (int l = 0; l < 4; l++) {
            uint16_t i1 = (uint16_t)qs[g * 8 + l * 2] |
                          (((uint16_t)qh[g] << (8 - 2 * l)) & 256);
            uint16_t i2 = (uint16_t)qs[g * 8 + l * 2 + 1] |
                          (((uint16_t)qh[g] << (7 - 2 * l)) & 256);
            const uint8_t* v0 = g_iq3s + i1 * 4;
            const uint8_t* v1 = g_iq3s + i2 * 4;
            uint8_t sb = signs[g * 4 + l];
            for (int j = 0; j < 4; j++) {
                y[g * 32 + l * 8 + j] = mulsgn(db * (float)v0[j], sb, j);
                y[g * 32 + l * 8 + 4 + j] = mulsgn(db * (float)v1[j], sb, 4 + j);
            }
        }
    }
}

void deq_iq1_s(const uint8_t* bp, float* y) {
    float d = h2f(bp);
    const uint8_t* qs = bp + 2;
    for (int g = 0; g < 8; g++) {
        uint16_t qh;
        std::memcpy(&qh, bp + 34 + 2 * g, 2);
        float dl = d * (2.0f * (float)((qh >> 12) & 7) + 1.0f);
        float delta = (qh & 0x8000) ? -0.125f : 0.125f;
        for (int l = 0; l < 4; l++) {
            uint16_t idx = (uint16_t)qs[g * 4 + l] |
                           (uint16_t)(((qh >> (3 * l)) & 7) << 8);
            const int8_t* vals = g_iq1s + idx * 8;
            for (int j = 0; j < 8; j++)
                y[g * 32 + l * 8 + j] = dl * ((float)vals[j] + delta);
        }
    }
}

void deq_iq1_m(const uint8_t* bp, float* y) {
    const uint8_t* qs = bp;
    const uint8_t* qh = bp + 32;
    uint16_t sc[4];
    std::memcpy(sc, bp + 48, 8);
    uint16_t d16 = (uint16_t)((sc[0] >> 12) | ((sc[1] >> 8) & 0x00F0) |
                              ((sc[2] >> 4) & 0x0F00) | (sc[3] & 0xF000));
    float d = half_to_float(d16);
    for (int g = 0; g < 8; g++) {
        int sh = 6 * (g % 2);
        uint16_t s = sc[g / 2];
        float dlA = d * (2.0f * (float)((s >> sh) & 7) + 1.0f);
        float dlB = d * (2.0f * (float)((s >> (sh + 3)) & 7) + 1.0f);
        uint8_t h0 = qh[g * 2], h1 = qh[g * 2 + 1];
        uint16_t idx[4] = {
            (uint16_t)(qs[g * 4 + 0] | (((uint16_t)h0 << 8) & 0x700)),
            (uint16_t)(qs[g * 4 + 1] | (((uint16_t)h0 << 4) & 0x700)),
            (uint16_t)(qs[g * 4 + 2] | (((uint16_t)h1 << 8) & 0x700)),
            (uint16_t)(qs[g * 4 + 3] | (((uint16_t)h1 << 4) & 0x700))};
        uint8_t hb[4] = {(uint8_t)(h0 & 0x08), (uint8_t)(h0 & 0x80),
                         (uint8_t)(h1 & 0x08), (uint8_t)(h1 & 0x80)};
        for (int l = 0; l < 4; l++) {
            float dl = (l < 2) ? dlA : dlB;
            float delta = hb[l] ? -0.125f : 0.125f;
            const int8_t* vals = g_iq1s + idx[l] * 8;
            for (int j = 0; j < 8; j++)
                y[g * 32 + l * 8 + j] = dl * ((float)vals[j] + delta);
        }
    }
}

// -------------------------------- quantizers ---------------------------------

void q_q8_0(const float* v, uint8_t* b) {
    float amax = 0;
    for (int i = 0; i < 32; i++) amax = std::max(amax, std::fabs(v[i]));
    float d = amax / 127.0f;
    float inv = d != 0 ? 1.0f / d : 0.0f;
    f2h(b, d);
    for (int i = 0; i < 32; i++) b[2 + i] = (uint8_t)(int8_t)npround(v[i] * inv);
}

void q_q4_0(const float* v, uint8_t* b) {
    float amax = 0, mx = 0;
    for (int i = 0; i < 32; i++) {
        float a = std::fabs(v[i]);
        if (a > amax) { amax = a; mx = v[i]; }
    }
    float d = mx / -8.0f;
    float inv = d != 0 ? 1.0f / d : 0.0f;
    f2h(b, d);
    for (int i = 0; i < 16; i++) {
        float lo = npround(v[i] * inv) + 8.0f;
        float hi = npround(v[16 + i] * inv) + 8.0f;
        uint8_t l = (uint8_t)std::clamp(lo, 0.0f, 15.0f);
        uint8_t h = (uint8_t)std::clamp(hi, 0.0f, 15.0f);
        b[2 + i] = l | (h << 4);
    }
}

void q_q4_1(const float* v, uint8_t* b) {
    float mn = v[0], mx = v[0];
    for (int i = 1; i < 32; i++) { mn = std::min(mn, v[i]); mx = std::max(mx, v[i]); }
    float d = (mx - mn) / 15.0f;
    float inv = d != 0 ? 1.0f / d : 0.0f;
    f2h(b, d);
    f2h(b + 2, mn);
    for (int i = 0; i < 16; i++) {
        uint8_t l = (uint8_t)std::clamp(npround((v[i] - mn) * inv), 0.0f, 15.0f);
        uint8_t h = (uint8_t)std::clamp(npround((v[16 + i] - mn) * inv), 0.0f, 15.0f);
        b[4 + i] = l | (h << 4);
    }
}

void q_q5_0(const float* v, uint8_t* b) {
    float amax = 0, mx = 0;
    for (int i = 0; i < 32; i++) {
        float a = std::fabs(v[i]);
        if (a > amax) { amax = a; mx = v[i]; }
    }
    float d = mx / -16.0f;
    float inv = d != 0 ? 1.0f / d : 0.0f;
    f2h(b, d);
    uint32_t qh = 0;
    for (int i = 0; i < 16; i++) {
        uint8_t lo5 = (uint8_t)std::clamp(npround(v[i] * inv) + 16.0f, 0.0f, 31.0f);
        uint8_t hi5 = (uint8_t)std::clamp(npround(v[16 + i] * inv) + 16.0f, 0.0f, 31.0f);
        b[6 + i] = (lo5 & 0x0F) | ((hi5 & 0x0F) << 4);
        qh |= (uint32_t)(lo5 >> 4) << i;
        qh |= (uint32_t)(hi5 >> 4) << (i + 16);
    }
    wr_u32(b + 2, qh);
}

void q_q5_1(const float* v, uint8_t* b) {
    float mn = v[0], mx = v[0];
    for (int i = 1; i < 32; i++) { mn = std::min(mn, v[i]); mx = std::max(mx, v[i]); }
    float d = (mx - mn) / 31.0f;
    float inv = d != 0 ? 1.0f / d : 0.0f;
    f2h(b, d);
    f2h(b + 2, mn);
    uint32_t qh = 0;
    for (int i = 0; i < 16; i++) {
        uint8_t lo5 = (uint8_t)std::clamp(npround((v[i] - mn) * inv), 0.0f, 31.0f);
        uint8_t hi5 = (uint8_t)std::clamp(npround((v[16 + i] - mn) * inv), 0.0f, 31.0f);
        b[8 + i] = (lo5 & 0x0F) | ((hi5 & 0x0F) << 4);
        qh |= (uint32_t)(lo5 >> 4) << i;
        qh |= (uint32_t)(hi5 >> 4) << (i + 16);
    }
    wr_u32(b + 4, qh);
}

void q_mxfp4(const float* v, uint8_t* b) {
    float amax = 0;
    for (int i = 0; i < 32; i++) amax = std::max(amax, std::fabs(v[i]));
    uint8_t e = fp32_to_e8m0_half(amax / 12.0f);
    float d = e8m0_half(e);
    b[0] = e;
    for (int i = 0; i < 16; i++) {
        uint8_t code[2];
        for (int half = 0; half < 2; half++) {
            float s = d > 0 ? v[i + 16 * half] / d : 0.0f;
            int best = 0;
            float bd = std::fabs(s - KV_MXFP4[0]);
            for (int k = 1; k < 16; k++) {
                float dist = std::fabs(s - KV_MXFP4[k]);
                if (dist < bd) { bd = dist; best = k; }
            }
            code[half] = (uint8_t)best;
        }
        b[1 + i] = code[0] | (code[1] << 4);
    }
}

void q_iq4_nl(const float* v, uint8_t* b) {
    float amax = 0, mx = 0;
    for (int i = 0; i < 32; i++) {
        float a = std::fabs(v[i]);
        if (a > amax) { amax = a; mx = v[i]; }
    }
    float d = mx / -127.0f;
    f2h(b, d);
    for (int i = 0; i < 16; i++) {
        uint8_t code[2];
        for (int half = 0; half < 2; half++) {
            float s = d != 0 ? v[i + 16 * half] / d : 0.0f;
            int best = 0;
            float bd = std::fabs(s - KV_IQ4NL[0]);
            for (int k = 1; k < 16; k++) {
                float dist = std::fabs(s - KV_IQ4NL[k]);
                if (dist < bd) { bd = dist; best = k; }
            }
            code[half] = (uint8_t)best;
        }
        b[2 + i] = code[0] | (code[1] << 4);
    }
}

// ------------- weighted K-quant searches (ggml make_q* analogs) -------------
// Per-group scale/min searches matching gguf/kquant_search.py BIT-FOR-BIT:
// operation order mirrors the numpy reference (zero-initialized sequential
// f32 accumulation, left-associated products), and the library is built with
// -ffp-contract=off so no FMA contraction can change results.

static const float kGroupMaxEps = 1e-15f;

// make_qkx2/qkx3 semantics: grid of candidate inverse scales + weighted LS
// (scale, min≤0) refit per candidate, accepted on weighted-error improvement
// evaluated against the incumbent's updated min. L out: ints in [0, nmax].
inline float qkx_search(const float* x, const float* w, int n, int nmax,
                        double rmin, double rdelta, int nstep, bool use_mad,
                        int* L, float* the_min) {
    float xmin = x[0], xmax = x[0];
    for (int i = 1; i < n; i++) {
        xmin = std::min(xmin, x[i]);
        xmax = std::max(xmax, x[i]);
    }
    xmin = std::min(xmin, 0.0f);
    if (xmax <= xmin) {
        for (int i = 0; i < n; i++) L[i] = 0;
        *the_min = -xmin;
        return 0.0f;
    }
    float sum_w = 0, sum_x = 0;
    for (int i = 0; i < n; i++) sum_w = sum_w + w[i];
    for (int i = 0; i < n; i++) sum_x = sum_x + w[i] * x[i];
    float rng = xmax - xmin;
    float nmaxf = (float)nmax;
    float iscale = nmaxf / rng;
    float scale = 1.0f / iscale;
    float cur_min = xmin;
    float best = 0;
    for (int i = 0; i < n; i++) {
        int l = (int)npround(iscale * (x[i] - xmin));
        L[i] = std::clamp(l, 0, nmax);
        float diff = (scale * (float)L[i] + cur_min) - x[i];
        float err = use_mad ? std::fabs(diff) : diff * diff;
        best = best + w[i] * err;
    }
    int laux[64];
    for (int step = 0; step <= nstep; step++) {
        float isc = (float)(rmin + rdelta * (double)step) + nmaxf;
        isc = isc / rng;
        float sum_l = 0, sum_l2 = 0, sum_xl = 0;
        for (int i = 0; i < n; i++) {
            int l = std::clamp((int)npround(isc * (x[i] - cur_min)), 0, nmax);
            laux[i] = l;
            float lf = (float)l;
            sum_l = sum_l + w[i] * lf;
            sum_l2 = sum_l2 + (w[i] * lf) * lf;
            sum_xl = sum_xl + (w[i] * lf) * x[i];
        }
        float D = sum_w * sum_l2 - sum_l * sum_l;
        if (!(D > 0)) continue;
        float this_scale = (sum_w * sum_xl - sum_x * sum_l) / D;
        float this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D;
        if (this_min > 0) {
            this_min = 0;
            this_scale = sum_xl / sum_l2;
        }
        float cur = 0;
        for (int i = 0; i < n; i++) {
            float diff = (this_scale * (float)laux[i] + this_min) - x[i];
            float err = use_mad ? std::fabs(diff) : diff * diff;
            cur = cur + w[i] * err;
        }
        if (cur < best) {
            for (int i = 0; i < n; i++) L[i] = laux[i];
            best = cur;
            scale = this_scale;
            cur_min = this_min;
        }
    }
    *the_min = -cur_min;
    return scale;
}

// make_qx_quants (rmse_type=1) semantics. L out BIASED by +nmax; all-zero
// groups return 0 with raw L=0.
inline float qx_search(const float* x, const float* qw, int n, int nmax,
                       int* L) {
    float amax = 0, maxv = 0;
    for (int i = 0; i < n; i++) {
        float a = std::fabs(x[i]);
        if (a > amax) { amax = a; maxv = x[i]; }
    }
    if (amax < kGroupMaxEps) {
        for (int i = 0; i < n; i++) L[i] = 0;
        return 0.0f;
    }
    float w[64];
    for (int i = 0; i < n; i++) w[i] = qw ? qw[i] : x[i] * x[i];
    float iscale = -(float)nmax / maxv;
    float sumlx = 0, suml2 = 0;
    for (int i = 0; i < n; i++) {
        int l = std::clamp((int)npround(iscale * x[i]), -nmax, nmax - 1);
        L[i] = l;
        float lf = (float)l;
        sumlx = sumlx + (w[i] * x[i]) * lf;
        suml2 = suml2 + (w[i] * lf) * lf;
    }
    float scale = suml2 != 0 ? sumlx / suml2 : 0.0f;
    float best = scale * sumlx;
    int laux[64];
    for (int step = -9; step <= 9; step++) {
        if (step == 0) continue;
        float isc = -((float)nmax + 0.1f * (float)step) / maxv;
        float slx = 0, sl2 = 0;
        for (int i = 0; i < n; i++) {
            int l = std::clamp((int)npround(isc * x[i]), -nmax, nmax - 1);
            laux[i] = l;
            float lf = (float)l;
            slx = slx + (w[i] * x[i]) * lf;
            sl2 = sl2 + (w[i] * lf) * lf;
        }
        if (sl2 > 0 && slx * slx > best * sl2) {
            for (int i = 0; i < n; i++) L[i] = laux[i];
            scale = slx / sl2;
            best = scale * slx;
        }
    }
    for (int i = 0; i < n; i++) L[i] += nmax;
    return scale;
}

// make_qp_quants semantics (non-negative fit + coordinate descent); L out in
// [0, nmax].
inline float qp_search(const float* x, const float* sw, int n, int nmax,
                       int* L) {
    float maxv = 0;
    for (int i = 0; i < n; i++) maxv = std::max(maxv, x[i]);
    if (maxv < kGroupMaxEps) {
        for (int i = 0; i < n; i++) L[i] = 0;
        return 0.0f;
    }
    float iscale = (float)nmax / maxv;
    float scale = 1.0f / iscale;
    float best_mse = 0;
    for (int i = 0; i < n; i++) {
        int l = (int)npround(iscale * x[i]);
        float diff = x[i] - scale * (float)l;
        best_mse = best_mse + (sw[i] * diff) * diff;
    }
    for (int step = -4; step <= 4; step++) {
        if (step == 0) continue;
        float isc = (0.1f * (float)step + (float)nmax) / maxv;
        float sc = 1.0f / isc;
        float mse = 0;
        for (int i = 0; i < n; i++) {
            int l = std::min((int)npround(isc * x[i]), nmax);
            float diff = x[i] - sc * (float)l;
            mse = mse + (sw[i] * diff) * diff;
        }
        if (mse < best_mse) {
            best_mse = mse;
            iscale = isc;
        }
    }
    float sumlx = 0, suml2 = 0;
    for (int i = 0; i < n; i++) {
        int l = std::min((int)npround(iscale * x[i]), nmax);
        L[i] = l;
        float lf = (float)l;
        sumlx = sumlx + (sw[i] * x[i]) * lf;
        suml2 = suml2 + (sw[i] * lf) * lf;
    }
    for (int itry = 0; itry < 5; itry++) {
        for (int i = 0; i < n; i++) {
            float wi = sw[i], xi = x[i], li = (float)L[i];
            float slx = sumlx - (wi * xi) * li;
            float sl2 = suml2 - (wi * li) * li;
            if (!(slx > 0 && sl2 > 0)) continue;
            int new_l = std::min((int)npround((xi * sl2) / slx), nmax);
            if (new_l == L[i]) continue;
            float nf = (float)new_l;
            float slx2 = slx + (wi * xi) * nf;
            float sl22 = sl2 + (wi * nf) * nf;
            if ((slx2 * slx2) * suml2 > (sumlx * sumlx) * sl22) {
                L[i] = new_l;
                sumlx = slx2;
                suml2 = sl22;
            }
        }
    }
    return suml2 > 0 ? sumlx / suml2 : 0.0f;
}

// make_q3_quants do_rmse semantics (symmetric x²-weighted + coordinate
// descent). L out BIASED by +nmax; all-zero groups raw L=0.
inline float q3_search(const float* x, int n, int nmax, int* L) {
    float amax = 0, maxv = 0;
    for (int i = 0; i < n; i++) {
        float a = std::fabs(x[i]);
        if (a > amax) { amax = a; maxv = x[i]; }
    }
    if (amax < kGroupMaxEps) {
        for (int i = 0; i < n; i++) L[i] = 0;
        return 0.0f;
    }
    float iscale = -(float)nmax / maxv;
    float sumlx = 0, suml2 = 0;
    for (int i = 0; i < n; i++) {
        int l = std::clamp((int)npround(iscale * x[i]), -nmax, nmax - 1);
        L[i] = l;
        float w = x[i] * x[i];
        float lf = (float)l;
        sumlx = sumlx + (w * x[i]) * lf;
        suml2 = suml2 + (w * lf) * lf;
    }
    for (int itry = 0; itry < 5; itry++) {
        for (int i = 0; i < n; i++) {
            float wi = x[i] * x[i], xi = x[i], li = (float)L[i];
            float slx = sumlx - (wi * xi) * li;
            if (!(slx > 0)) continue;
            float sl2 = suml2 - (wi * li) * li;
            int new_l = std::clamp((int)npround((xi * sl2) / slx), -nmax, nmax - 1);
            if (new_l == L[i]) continue;
            float nf = (float)new_l;
            float slx2 = slx + (wi * xi) * nf;
            float sl22 = sl2 + (wi * nf) * nf;
            if (sl22 > 0 && (slx2 * slx2) * suml2 > (sumlx * sumlx) * sl22) {
                L[i] = new_l;
                sumlx = slx2;
                suml2 = sl22;
            }
        }
    }
    for (int i = 0; i < n; i++) L[i] += nmax;
    return suml2 > 0 ? sumlx / suml2 : 0.0f;
}

void q_q4_k(const float* v, uint8_t* b) {
    // quantize_row_q4_K_ref semantics: weighted qkx2 search per 32-group
    float scales[8], mins[8];
    int L[8][32];
    for (int j = 0; j < 8; j++) {
        const float* g = v + j * 32;
        float sumx2 = 0;
        for (int i = 0; i < 32; i++) sumx2 = sumx2 + g[i] * g[i];
        float av = std::sqrt(sumx2 / 32.0f);
        float w[32];
        for (int i = 0; i < 32; i++) w[i] = av + std::fabs(g[i]);
        scales[j] = qkx_search(g, w, 32, 15, -1.0, 0.1, 20, false,
                               L[j], &mins[j]);
    }
    float max_scale = scales[0], max_min = mins[0];
    for (int j = 1; j < 8; j++) {
        if (scales[j] > max_scale) max_scale = scales[j];
        if (mins[j] > max_min) max_min = mins[j];
    }
    float inv_scale = max_scale > 0 ? 63.0f / max_scale : 0.0f;
    float inv_min = max_min > 0 ? 63.0f / max_min : 0.0f;
    uint8_t ls[8], lm[8];
    for (int j = 0; j < 8; j++) {
        ls[j] = (uint8_t)std::min<int>((uint8_t)(int)npround(inv_scale * scales[j]), 63);
        lm[j] = (uint8_t)std::min<int>((uint8_t)(int)npround(inv_min * mins[j]), 63);
    }
    float d = max_scale / 63.0f, dmin = max_min / 63.0f;
    f2h(b, d);
    f2h(b + 2, dmin);
    float d16 = half_to_float(float_to_half(d));
    float m16 = half_to_float(float_to_half(dmin));
    pack_scale_min_k4(ls, lm, b + 4);
    uint8_t q[8][32];
    for (int j = 0; j < 8; j++) {
        float dl = d16 * (float)ls[j], ml = m16 * (float)lm[j];
        const float* g = v + j * 32;
        for (int i = 0; i < 32; i++) {
            if (dl != 0) {
                int l = (int)npround((g[i] + ml) / dl);
                q[j][i] = (uint8_t)std::clamp(l, 0, 15);
            } else {
                q[j][i] = (uint8_t)L[j][i];
            }
        }
    }
    for (int j = 0; j < 4; j++)
        for (int i = 0; i < 32; i++)
            b[16 + j * 32 + i] = q[2 * j][i] | (q[2 * j + 1][i] << 4);
}

void q_q5_k(const float* v, uint8_t* b) {
    // quantize_row_q5_K_ref semantics: weighted qkx2 search per 32-group
    float scales[8], mins[8];
    int L[8][32];
    for (int j = 0; j < 8; j++) {
        const float* g = v + j * 32;
        float sumx2 = 0;
        for (int i = 0; i < 32; i++) sumx2 = sumx2 + g[i] * g[i];
        float av = std::sqrt(sumx2 / 32.0f);
        float w[32];
        for (int i = 0; i < 32; i++) w[i] = av + std::fabs(g[i]);
        scales[j] = qkx_search(g, w, 32, 31, -0.5, 0.1, 15, false,
                               L[j], &mins[j]);
    }
    float max_scale = scales[0], max_min = mins[0];
    for (int j = 1; j < 8; j++) {
        if (scales[j] > max_scale) max_scale = scales[j];
        if (mins[j] > max_min) max_min = mins[j];
    }
    float inv_scale = max_scale > 0 ? 63.0f / max_scale : 0.0f;
    float inv_min = max_min > 0 ? 63.0f / max_min : 0.0f;
    uint8_t ls[8], lm[8];
    for (int j = 0; j < 8; j++) {
        ls[j] = (uint8_t)std::min<int>((uint8_t)(int)npround(inv_scale * scales[j]), 63);
        lm[j] = (uint8_t)std::min<int>((uint8_t)(int)npround(inv_min * mins[j]), 63);
    }
    float d = max_scale / 63.0f, dmin = max_min / 63.0f;
    f2h(b, d);
    f2h(b + 2, dmin);
    float d16 = half_to_float(float_to_half(d));
    float m16 = half_to_float(float_to_half(dmin));
    pack_scale_min_k4(ls, lm, b + 4);
    uint8_t q[8][32];
    for (int j = 0; j < 8; j++) {
        float dl = d16 * (float)ls[j], ml = m16 * (float)lm[j];
        const float* g = v + j * 32;
        for (int i = 0; i < 32; i++) {
            if (dl != 0) {
                int l = (int)npround((g[i] + ml) / dl);
                q[j][i] = (uint8_t)std::clamp(l, 0, 31);
            } else {
                q[j][i] = (uint8_t)L[j][i];
            }
        }
    }
    uint8_t* qh = b + 16;
    uint8_t* ql = b + 48;
    std::memset(qh, 0, 32);
    for (int j = 0; j < 4; j++) {
        for (int i = 0; i < 32; i++) {
            uint8_t q1 = q[2 * j][i], q2 = q[2 * j + 1][i];
            ql[j * 32 + i] = (q1 & 0x0F) | ((q2 & 0x0F) << 4);
            if (q1 & 16) qh[i] |= (uint8_t)(1 << (2 * j));
            if (q2 & 16) qh[i] |= (uint8_t)(2 << (2 * j));
        }
    }
}

void q_q6_k(const float* v, uint8_t* b) {
    // quantize_row_q6_K_ref semantics: make_qx weighted search per 16-group
    float scales[16];
    int L[16][16];
    for (int j = 0; j < 16; j++)
        scales[j] = qx_search(v + j * 16, nullptr, 16, 32, L[j]);
    float absmax = 0, max_scale = 0;
    for (int j = 0; j < 16; j++) {
        float a = std::fabs(scales[j]);
        if (a > absmax) { absmax = a; max_scale = scales[j]; }
    }
    if (absmax < kGroupMaxEps) {            // dead superblock: all zeros
        std::memset(b, 0, 210);
        return;
    }
    float iscale = -128.0f / max_scale;
    float d = 1.0f / iscale;
    int lsi[16];
    for (int j = 0; j < 16; j++)
        lsi[j] = std::min((int)npround(iscale * scales[j]), 127);
    int8_t ls[16];
    for (int j = 0; j < 16; j++) ls[j] = (int8_t)(lsi[j] & 0xFF);
    float d16 = half_to_float(float_to_half(d));
    uint8_t q[256];
    for (int j = 0; j < 16; j++) {
        float dl = d16 * (float)lsi[j];
        const float* g = v + j * 16;
        for (int i = 0; i < 16; i++) {
            if (dl != 0) {
                int l = std::clamp((int)npround(g[i] / dl), -32, 31);
                q[j * 16 + i] = (uint8_t)(l + 32);
            } else {
                q[j * 16 + i] = (uint8_t)L[j][i];
            }
        }
    }
    uint8_t* ql = b;
    uint8_t* qh = b + 128;
    std::memset(ql, 0, 128);
    std::memset(qh, 0, 64);
    for (int n = 0; n < 256; n += 128) {
        const uint8_t* q1 = q + n;
        const uint8_t* q2 = q + n + 32;
        const uint8_t* q3 = q + n + 64;
        const uint8_t* q4 = q + n + 96;
        for (int i = 0; i < 32; i++) {
            ql[n / 2 + i] = (q1[i] & 0x0F) | ((q3[i] & 0x0F) << 4);
            ql[n / 2 + 32 + i] = (q2[i] & 0x0F) | ((q4[i] & 0x0F) << 4);
            qh[n / 4 + i] = (uint8_t)((q1[i] >> 4) | ((q2[i] >> 4) << 2) |
                                      ((q3[i] >> 4) << 4) | ((q4[i] >> 4) << 6));
        }
    }
    std::memcpy(b + 192, ls, 16);
    f2h(b + 208, d);
}

void q_q2_k(const float* v, uint8_t* b) {
    // quantize_row_q2_K_ref semantics: |x|-weighted qkx2 MAD search
    float scales[16], mins[16];
    int L[16][16];
    for (int g = 0; g < 16; g++) {
        const float* gr = v + g * 16;
        float w[16];
        for (int i = 0; i < 16; i++) w[i] = std::fabs(gr[i]);
        scales[g] = qkx_search(gr, w, 16, 3, -0.5, 0.1, 15, true,
                               L[g], &mins[g]);
    }
    float max_scale = scales[0], max_min = mins[0];
    for (int g = 1; g < 16; g++) {
        if (scales[g] > max_scale) max_scale = scales[g];
        if (mins[g] > max_min) max_min = mins[g];
    }
    float d = max_scale > 0 ? max_scale / 15.0f : 0.0f;
    float dmin = max_min > 0 ? max_min / 15.0f : 0.0f;
    float inv_scale = max_scale > 0 ? 15.0f / max_scale : 0.0f;
    float inv_min = max_min > 0 ? 15.0f / max_min : 0.0f;
    uint8_t ls[16], lm[16];
    for (int g = 0; g < 16; g++) {
        ls[g] = max_scale > 0 ? (uint8_t)(int)npround(inv_scale * scales[g]) : 0;
        lm[g] = max_min > 0 ? (uint8_t)(int)npround(inv_min * mins[g]) : 0;
    }
    float d16 = half_to_float(float_to_half(d));
    float m16 = half_to_float(float_to_half(dmin));
    // C stores the full ls byte then ORs lm<<4 (a negative searched scale
    // wraps into the high nibble — kquant_search.py emulates the same)
    for (int g = 0; g < 16; g++) b[g] = (uint8_t)(ls[g] | (lm[g] << 4));
    uint8_t q[16][16];
    for (int g = 0; g < 16; g++) {
        float dl = d16 * (float)(b[g] & 0x0F), ml = m16 * (float)(b[g] >> 4);
        const float* gr = v + g * 16;
        for (int i = 0; i < 16; i++) {
            if (dl != 0) {
                int l = (int)npround((gr[i] + ml) / dl);
                q[g][i] = (uint8_t)std::clamp(l, 0, 3);
            } else {
                q[g][i] = (uint8_t)L[g][i];
            }
        }
    }
    std::memset(b + 16, 0, 64);
    int is = 0;
    for (int n = 0; n < 256; n += 128) {
        int base = 16 + n / 4;
        for (int shift = 0; shift < 8; shift += 2) {
            for (int half = 0; half < 32; half += 16) {
                for (int i = 0; i < 16; i++)
                    b[base + half + i] |= (uint8_t)(q[is][i] << shift);
                is++;
            }
        }
    }
    f2h(b + 80, d);
    f2h(b + 82, dmin);
}

void q_q3_k(const float* v, uint8_t* b) {
    // quantize_row_q3_K_ref semantics: make_q3 rmse search per 16-group
    float scales[16];
    int L[16][16];
    for (int g = 0; g < 16; g++)
        scales[g] = q3_search(v + g * 16, 16, 4, L[g]);
    float absmax = 0, max_scale = 0;
    for (int g = 0; g < 16; g++) {
        float a = std::fabs(scales[g]);
        if (a > absmax) { absmax = a; max_scale = scales[g]; }
    }
    uint8_t ls[16];
    float d;
    if (max_scale != 0) {
        float iscale = -32.0f / max_scale;
        for (int g = 0; g < 16; g++)
            ls[g] = (uint8_t)(std::clamp((int)npround(iscale * scales[g]), -32, 31) + 32);
        d = 1.0f / iscale;
    } else {
        for (int g = 0; g < 16; g++) ls[g] = 0;
        d = 0.0f;
    }
    float d16 = half_to_float(float_to_half(d));
    int8_t q[16][16];
    for (int g = 0; g < 16; g++) {
        float dl = d16 * (float)((int)ls[g] - 32);
        for (int i = 0; i < 16; i++) {
            if (dl != 0) {
                q[g][i] = (int8_t)(std::clamp((int)npround(v[g * 16 + i] / dl), -4, 3) + 4);
            } else {
                q[g][i] = (int8_t)L[g][i];
            }
        }
    }
    std::memset(b, 0, 96);
    int is = 0, m = 1;
    for (int n = 0; n < 256; n += 128) {
        int base = 32 + n / 4;
        for (int shift = 0; shift < 8; shift += 2) {
            for (int half = 0; half < 32; half += 16) {
                for (int i = 0; i < 16; i++) {
                    uint8_t grp = (uint8_t)q[is][i];
                    b[base + half + i] |= (uint8_t)((grp & 3) << shift);
                    if (grp & 4) b[half + i] |= (uint8_t)m;
                }
                is++;
            }
            m <<= 1;
        }
    }
    q3k_pack_scales(ls, b + 96);
    f2h(b + 108, d);
}

void q_q8_k(const float* v, uint8_t* b) {
    float amax = 0;
    for (int i = 0; i < 256; i++) amax = std::max(amax, std::fabs(v[i]));
    float d = amax / 127.0f;
    float ds = d == 0 ? 1.0f : d;
    int8_t q[256];
    for (int i = 0; i < 256; i++) {
        float t = std::clamp(npround(v[i] / ds), -127.0f, 127.0f);
        q[i] = d == 0 ? (int8_t)0 : (int8_t)t;
    }
    std::memcpy(b, &d, 4);
    std::memcpy(b + 4, q, 256);
    for (int g = 0; g < 16; g++) {
        int32_t s = 0;
        for (int i = 0; i < 16; i++) s += q[g * 16 + i];
        int16_t s16 = (int16_t)s;
        std::memcpy(b + 260 + 2 * g, &s16, 2);
    }
}

void q_tq1_0(const float* v, uint8_t* b) {
    float amax = 0;
    for (int i = 0; i < 256; i++) amax = std::max(amax, std::fabs(v[i]));
    float d = amax, ds = d == 0 ? 1.0f : d;
    int q[256];
    for (int i = 0; i < 256; i++)
        q[i] = (int)std::clamp(npround(v[i] / ds), -1.0f, 1.0f) + 1;
    int pos = 0;
    static const int starts[2] = {0, 32}, widths[2] = {32, 16};
    for (int s = 0; s < 2; s++) {
        int acc[32] = {0};
        for (int m = 0; m < 5; m++) {
            for (int i = 0; i < widths[s]; i++)
                acc[i] = acc[i] * 3 + q[pos + i];
            pos += widths[s];
        }
        for (int i = 0; i < widths[s]; i++)
            b[starts[s] + i] = (uint8_t)((acc[i] * 256 + 242) / 243);
    }
    int acc4[4] = {0};
    for (int m = 0; m < 4; m++) {
        for (int i = 0; i < 4; i++) acc4[i] = acc4[i] * 3 + q[pos + i];
        pos += 4;
    }
    for (int i = 0; i < 4; i++)
        b[48 + i] = (uint8_t)((acc4[i] * 256 + 80) / 81);
    f2h(b + 52, d);
}

void q_tq2_0(const float* v, uint8_t* b) {
    float amax = 0;
    for (int i = 0; i < 256; i++) amax = std::max(amax, std::fabs(v[i]));
    float d = amax, ds = d == 0 ? 1.0f : d;
    std::memset(b, 0, 64);
    int pos = 0;
    for (int j = 0; j < 64; j += 32) {
        for (int shift = 0; shift < 8; shift += 2) {
            for (int i = 0; i < 32; i++) {
                int q = (int)std::clamp(npround(v[pos + i] / ds), -1.0f, 1.0f) + 1;
                b[j + i] |= (uint8_t)(q << shift);
            }
            pos += 32;
        }
    }
    f2h(b + 64, d);
}

// ------------------------------ block drivers --------------------------------

struct Fmt {
    int type_size;
    int block_size;
    void (*deq)(const uint8_t*, float*);
    void (*enc)(const float*, uint8_t*);
};

// indexed by GGMLType enum value (constants.py / ggml.h)
Fmt fmt_for(int ttype) {
    switch (ttype) {
        case 2: return {18, 32, deq_q4_0, q_q4_0};     // Q4_0
        case 3: return {20, 32, deq_q4_1, q_q4_1};     // Q4_1
        case 6: return {22, 32, deq_q5_0, q_q5_0};     // Q5_0
        case 7: return {24, 32, deq_q5_1, q_q5_1};     // Q5_1
        case 8: return {34, 32, deq_q8_0, q_q8_0};     // Q8_0
        case 10: return {84, 256, deq_q2_k, q_q2_k};   // Q2_K
        case 11: return {110, 256, deq_q3_k, q_q3_k};  // Q3_K
        case 12: return {144, 256, deq_q4_k, q_q4_k};  // Q4_K
        case 13: return {176, 256, deq_q5_k, q_q5_k};  // Q5_K
        case 14: return {210, 256, deq_q6_k, q_q6_k};  // Q6_K
        case 15: return {292, 256, deq_q8_k, q_q8_k};  // Q8_K
        // codebook i-quants: decode only (enc is the offline numpy
        // scale-search); requires slq_set_iq_grids first
        case 16: return {66, 256, deq_iq2_xxs, nullptr};  // IQ2_XXS
        case 17: return {74, 256, deq_iq2_xs, nullptr};   // IQ2_XS
        case 18: return {98, 256, deq_iq3_xxs, nullptr};  // IQ3_XXS
        case 19: return {50, 256, deq_iq1_s, nullptr};    // IQ1_S
        case 20: return {18, 32, deq_iq4_nl, q_iq4_nl};// IQ4_NL
        case 21: return {110, 256, deq_iq3_s, nullptr};   // IQ3_S
        case 22: return {82, 256, deq_iq2_s, nullptr};    // IQ2_S
        case 29: return {56, 256, deq_iq1_m, nullptr};    // IQ1_M
        case 23: return {136, 256, deq_iq4_xs, nullptr}; // IQ4_XS (enc: numpy
                 // codebook scale-search — offline quantize path only)
        case 34: return {54, 256, deq_tq1_0, q_tq1_0}; // TQ1_0
        case 35: return {66, 256, deq_tq2_0, q_tq2_0}; // TQ2_0
        case 39: return {17, 32, deq_mxfp4, q_mxfp4};  // MXFP4
        default: return {0, 0, nullptr, nullptr};
    }
}

// Run fn over [0, nb) in contiguous ranges on up to `threads` threads (0:
// every core), each thread taking at least `grain` units.
template <typename F>
void parallel_blocks(int64_t nb, int threads, int64_t grain, F&& fn) {
    unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    unsigned cap = threads > 0 ? (unsigned)threads : hw;
    unsigned nt = std::min<unsigned>(cap,
                                     (unsigned)std::max<int64_t>(nb / grain, 1));
    if (nt <= 1) {
        fn(0, nb);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (nb + nt - 1) / nt;
    for (unsigned t = 0; t < nt; t++) {
        int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, nb);
        if (lo >= hi) break;
        ts.emplace_back([&, lo, hi] { fn(lo, hi); });
    }
    for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

int slq_supported(int ttype, int for_encode) {
    Fmt f = fmt_for(ttype);
    if (!f.type_size) return 0;
    bool is_grid = (ttype >= 16 && ttype <= 22 && ttype != 20) || ttype == 29;
    if (is_grid && !g_grids) return 0;
    return for_encode ? (f.enc != nullptr) : 1;
}

// inject the shared lattice codebooks (gguf/iq_grids.npz, viewed as byte
// rows): iq2xxs 256x8, iq2xs 512x8, iq2s 1024x8, iq3xxs 256x4, iq3s 512x4,
// iq1s 2048x8 (int8)
int slq_set_iq_grids(const uint8_t* iq2xxs, const uint8_t* iq2xs,
                     const uint8_t* iq2s, const uint8_t* iq3xxs,
                     const uint8_t* iq3s, const int8_t* iq1s) {
    std::memcpy(g_iq2xxs, iq2xxs, sizeof g_iq2xxs);
    std::memcpy(g_iq2xs, iq2xs, sizeof g_iq2xs);
    std::memcpy(g_iq2s, iq2s, sizeof g_iq2s);
    std::memcpy(g_iq3xxs, iq3xxs, sizeof g_iq3xxs);
    std::memcpy(g_iq3s, iq3s, sizeof g_iq3s);
    std::memcpy(g_iq1s, iq1s, sizeof g_iq1s);
    g_grids = true;
    return 0;
}

// raw: nb * type_size bytes → out: nb * block_size floats
int slq_dequantize(int ttype, const uint8_t* raw, int64_t nbytes, float* out,
                   int threads) {
    Fmt f = fmt_for(ttype);
    if (!f.type_size || nbytes % f.type_size) return -1;
    int64_t nb = nbytes / f.type_size;
    parallel_blocks(nb, threads, 4096, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++)
            f.deq(raw + i * f.type_size, out + i * f.block_size);
    });
    return 0;
}

// x: n floats (n % block_size == 0) → out: (n/block_size)*type_size bytes
int slq_quantize(int ttype, const float* x, int64_t n, uint8_t* out,
                 int threads) {
    Fmt f = fmt_for(ttype);
    if (!f.type_size || !f.enc || n % f.block_size) return -1;
    int64_t nb = n / f.block_size;
    // a thread encodes at least 128K values (the K-quant searches are heavy)
    parallel_blocks(nb, threads, 131072 / f.block_size, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++)
            f.enc(x + i * f.block_size, out + i * f.type_size);
    });
    return 0;
}

}  // extern "C"

// ----------------------------- repack (load path) ---------------------------
// Wire blocks (row-major N x K/bs) -> the SoA QTensor planes of
// ops/qtensor.py, bit-identical: codes nibble-packed (K/2, N) for
// Q4_0/Q4_K or int8 (K, N) otherwise; scales/adds f32 (K/gs, N).
// This is the model-load hot loop (ggml-cpu/repack.cpp role).

namespace {

void rep_q4_0(const uint8_t* b, int64_t n, int64_t bi, int64_t N,
              uint8_t* codes, float* scales, float* adds) {
    (void)adds;
    scales[bi * N + n] = h2f(b);
    // group-local nibble pack == the wire layout for Q4_0 (lo nibbles are
    // elements 0-15, hi nibbles 16-31)
    for (int t = 0; t < 16; t++) codes[(bi * 16 + t) * N + n] = b[2 + t];
}

void rep_q8_0(const uint8_t* b, int64_t n, int64_t bi, int64_t N,
              uint8_t* codes, float* scales, float* adds) {
    (void)adds;
    scales[bi * N + n] = h2f(b);
    for (int e = 0; e < 32; e++) codes[(bi * 32 + e) * N + n] = b[2 + e];
}

void rep_q4_k(const uint8_t* b, int64_t n, int64_t bi, int64_t N,
              uint8_t* codes, float* scales, float* adds) {
    float d = h2f(b), dmin = h2f(b + 2);
    uint8_t sc[8], mn[8];
    unpack_scale_min_k4(b + 4, sc, mn);
    for (int j = 0; j < 8; j++) {
        scales[(bi * 8 + j) * N + n] = d * (float)sc[j];
        adds[(bi * 8 + j) * N + n] = -(dmin * (float)mn[j]);
    }
    const uint8_t* qs = b + 16;
    uint8_t out[128] = {0};
    for (int e = 0; e < 256; e++) {
        int c = e >> 6, w = e & 63;
        uint8_t q = qs[c * 32 + (w & 31)];
        uint8_t val = (w < 32) ? (uint8_t)(q & 0x0F) : (uint8_t)(q >> 4);
        int m = e & 31;
        int r = (e >> 5) * 16 + (m & 15);
        out[r] |= (uint8_t)(val << (m >= 16 ? 4 : 0));
    }
    for (int r = 0; r < 128; r++) codes[(bi * 128 + r) * N + n] = out[r];
}

void rep_q5_k(const uint8_t* b, int64_t n, int64_t bi, int64_t N,
              uint8_t* codes, float* scales, float* adds) {
    float d = h2f(b), dmin = h2f(b + 2);
    uint8_t sc[8], mn[8];
    unpack_scale_min_k4(b + 4, sc, mn);
    for (int j = 0; j < 8; j++) {
        scales[(bi * 8 + j) * N + n] = d * (float)sc[j];
        adds[(bi * 8 + j) * N + n] = -(dmin * (float)mn[j]);
    }
    const uint8_t* qh = b + 16;
    const uint8_t* ql = b + 48;
    int8_t out[256];
    for (int j = 0; j < 4; j++) {
        uint8_t u1 = (uint8_t)(1u << (2 * j)), u2 = (uint8_t)(2u << (2 * j));
        for (int i = 0; i < 32; i++) {
            uint8_t q = ql[j * 32 + i];
            out[j * 64 + i] = (int8_t)((q & 0x0F) + ((qh[i] & u1) ? 16 : 0));
            out[j * 64 + 32 + i] = (int8_t)((q >> 4) + ((qh[i] & u2) ? 16 : 0));
        }
    }
    for (int e = 0; e < 256; e++)
        codes[(bi * 256 + e) * N + n] = (uint8_t)out[e];
}

void rep_q6_k(const uint8_t* b, int64_t n, int64_t bi, int64_t N,
              uint8_t* codes, float* scales, float* adds) {
    (void)adds;
    const uint8_t* ql = b;
    const uint8_t* qh = b + 128;
    const int8_t* sc8 = (const int8_t*)(b + 192);
    float d = h2f(b + 208);
    for (int j = 0; j < 16; j++)
        scales[(bi * 16 + j) * N + n] = d * (float)sc8[j];
    int8_t out[256];
    for (int half = 0; half < 2; half++) {
        const uint8_t* lq = ql + half * 64;
        const uint8_t* hq = qh + half * 32;
        int n0 = half * 128;
        for (int i = 0; i < 32; i++) {
            out[n0 + i] = (int8_t)(((lq[i] & 0x0F) | (((hq[i] >> 0) & 3) << 4)) - 32);
            out[n0 + 32 + i] = (int8_t)(((lq[32 + i] & 0x0F) | (((hq[i] >> 2) & 3) << 4)) - 32);
            out[n0 + 64 + i] = (int8_t)(((lq[i] >> 4) | (((hq[i] >> 4) & 3) << 4)) - 32);
            out[n0 + 96 + i] = (int8_t)(((lq[32 + i] >> 4) | (((hq[i] >> 6) & 3) << 4)) - 32);
        }
    }
    for (int e = 0; e < 256; e++)
        codes[(bi * 256 + e) * N + n] = (uint8_t)out[e];
}

using rep_fn = void (*)(const uint8_t*, int64_t, int64_t, int64_t,
                        uint8_t*, float*, float*);

inline rep_fn rep_for(int ttype) {
    switch (ttype) {
        case 2: return rep_q4_0;   // Q4_0
        case 8: return rep_q8_0;   // Q8_0
        case 12: return rep_q4_k;  // Q4_K
        case 13: return rep_q5_k;  // Q5_K
        case 14: return rep_q6_k;  // Q6_K
        default: return nullptr;
    }
}
}  // namespace

// One unit of work is a k-block over a slice of REPACK_COLS columns, so a
// tensor spreads over the threads whatever its K (an 8B weight has 16-56
// k-blocks a row); a thread's units run along a slice's rows of the planes.
constexpr int64_t REPACK_COLS = 256;

extern "C" int slq_repack(int ttype, const uint8_t* raw, int64_t N, int64_t K,
                          uint8_t* codes, float* scales, float* adds,
                          int threads) {
    rep_fn fn = rep_for(ttype);
    Fmt f = fmt_for(ttype);
    if (!fn || !f.type_size || K % f.block_size) return -1;
    int64_t nbr = K / f.block_size;
    int64_t ts = f.type_size;
    int64_t nsl = (N + REPACK_COLS - 1) / REPACK_COLS;
    parallel_blocks(nbr * nsl, threads, 16, [&](int64_t lo, int64_t hi) {
        for (int64_t u = lo; u < hi; u++) {
            int64_t bi = u / nsl, n0 = (u % nsl) * REPACK_COLS;
            int64_t n1 = std::min<int64_t>(n0 + REPACK_COLS, N);
            for (int64_t n = n0; n < n1; n++)
                fn(raw + (n * nbr + bi) * ts, n, bi, N, codes, scales, adds);
        }
    });
    return 0;
}
