// qmv: int8-activation grouped GEMV over repacked quantized weights, M <= 16
// rows a launch: every matmul of a decode step.
//
// Replaces the TPU kernel _qmv_kernel (superllama_tpu/ops/qmatmul.py:235,
// launched by _qmatmul_mv). It computes, in the same association,
//
//   y[m,n] = sum_g ig[m,g,n]*(sx[m,g]*s[g,n]) + sum_g xs[m,g]*c[g,n]
//
// with ig the exact integer dot of a group's int8 activation codes with its
// weight codes and c = a - offset*s, the activations quantized per weight
// group exactly as quantize_acts (ops/qmatmul.py) and _quantize_acts do:
// inv = 127/amax by true division, codes rintf(x*inv), xs = sum(codes)*sx.
//
// What bounds it on the H100: bytes. At decode each weight byte is read once
// and used by M <= 16 rows (Q4_K: 0.59 bytes a weight, 16 int8 products a
// byte at M 8), far under the card's ops-per-byte balance: gate/up of an 8B
// model (K 4096, N 14336) needs 0.0105 ms at 3.35 TB/s. The design:
//  - One launch a call. Each block quantizes the K range it owns of x's rows
//    into shared memory itself (a thread a (row, 32-group): amax, codes
//    rounded by adding 1.5 * 2^23, the code sum an exact integer), laid out
//    as the B fragments of the tensor-core product.
//    No quantizer kernel, no reduce kernel, no partials in device memory.
//  - The group dots on the int8 tensor cores: mma.sync m16n8k32 s8 -> s32
//    with the weights as A (16 columns) and x as B (8 rows; two fragments at
//    M 9-16), so one product is one 32-group's exact dot for 16 columns x 8
//    rows; Q6_K's 16-groups take m16n8k16. The codes need no dequantize:
//    a lane reads code rows t, t+4, t+8, t+12 of its 4 columns (32-bit
//    shared loads, conflict-free at a row stride of 32 mod 64 bytes) and a
//    byte transpose gives one column's 4 codes a register; the low nibbles
//    are elements t+4i, the high ones 16+t+4i, and x's codes are laid out
//    in that k order. Each product is then scaled in f32 by sx*s and the
//    group-sum correction added, per lane 4 columns x 2 rows a fragment.
//  - The weight planes of a block's column tile stream through a ring of
//    NST stages (3; 4 for Q4_K at 8 rows; 2 for Q6_K's and IQ1_M's larger
//    tiles) of 4-8 32-groups: a producer warp fills a stage with
//    16-byte cp.async copies (4-byte ones when N is not a multiple of 16),
//    pointer increments down each lane's column, completed on the stage's
//    `full` mbarrier; the 8 consumer warps (column slabs x k warps) free it
//    on `empty`. Up to 112 KB a block, two blocks an SM, are in flight.
//  - A grid that fills the card at every decode shape: qmv_plan (in
//    ops/qmatmul.py, a function of (fmt, K, N) only) picks the column tile
//    (128, 64 or 32) and a thread block cluster of up to 8 blocks along K,
//    counting rounds of the blocks the card holds at once for that cluster
//    size (8 ranks fit 240 of 264 slots); the ranks' f32 sums are added in rank
//    order through distributed shared memory, the k warps' in warp order
//    before them. No atomics: every sum runs in a fixed order, so two calls
//    give the same bits and a row's output does not depend on how many rows
//    share the call. A block alone skips the cluster barriers.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py --qmv-times; PERF.md
// section 6): at gate/up (K 4096, N 14336, M 8) the kernel reads 0.020 ms against
// a 0.0105 ms bound; a copy without the weight copies reads 0.0157 and one
// without the quantizer and the products 0.0159, so the copies and the
// work on them each set about the same time and overlap only in part.
// Edges: columns past N and rows past M compute on stale shared memory or
// zero codes and are never stored.
//
// Weight formats (FMT), every layout of ops/qtensor.py's repack:
//   0 int8 codes (K, N), f32 scale plane (K/32, N): Q8_0, Q5_0, MXFP4,
//     IQ4_NL, IQ4_XS, IQ2_XXS, IQ3_XXS, IQ3_S;
//   1 Q4_K compact (nibbles, u8 sc/mn, f32 d/dmin per 256, gs 32);
//   2 Q6_K compact (nibbles + 2-bit hi plane, i8 sc, f32 d per 256, gs 16,
//     offset 32);
//   3 int8, gs 32, an f32 adds plane: Q5_1, IQ1_S;
//   4 int8, gs 16, adds where present: Q3_K, IQ2_XS, IQ2_S, Q2_K (adds);
//   5 int8, gs 8, adds: IQ1_M;
//   6 int8, gs 256: Q8_K, TQ1_0, TQ2_0;
//   7 nibbles (K/2, N) in Q4_K's group-local layout, f32 scales per 32,
//     offset 8 (Q4_0) or adds (Q4_1);
//   8 Q5_K compact: Q4_K's planes and a 1-bit hi plane (element e of a
//     32-group in hi row e % 4, bit e / 4).
// The correction c = a - offset*s of FMT 3, 4, 5 and 7 (adds plane and
// offset given at run time) is added once a group, as FMT 1 adds its mins.
// gs 16 groups take two m16n8k16 products a 32-group (Q6_K's), gs 8 four,
// each with x's B fragment holding one 8-group's codes and zeros in the
// other half. A gs-256 group's eight m16n8k32 products accumulate in s32
// before its one scale (the JAX kernel's ig * (sx * s)): there each k warp
// owns whole 256-groups and a stage holds P 32-groups of each k warp's
// group, so the dot never leaves one warp's registers. Its |dot| <=
// 256 * 128 * 127 = 4,161,536 < 2^22, inside the magic conversion's range.

#include "ptx.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;
using namespace ptx;

constexpr int NCW = 8;               // consumer warps
constexpr int NTC = NCW * 32;        // consumer threads
constexpr int NT = NTC + 32;         // and the producer warp
constexpr int MAXR = 16;             // rows a launch
constexpr int NFMT = 9;              // weight formats
constexpr uint32_t M4 = 0x0F0F0F0Fu;

struct Args {
  int M, K, N, per;                  // per: K units (superblocks; 32-groups) a rank
  const void* x; int x_bf16;
  const uint8_t* codes; const uint8_t* hi; const float* scales;
  const uint8_t* sc; const uint8_t* mn; const float* d; const float* dmin;
  const float* adds; int offset;     // FMT 3, 4, 5, 7: adds plane or null, code offset
  void* out; int out_bf16;
  int wide;                          // 16-byte copies, else 4-byte
};

// a format's layout
template <int FMT>
struct Fmt {
  static constexpr bool COMPACT = FMT == 1 || FMT == 2 || FMT == 8;   // sub-scales x d a superblock
  static constexpr bool NIB = COMPACT || FMT == 7;                    // 4-bit codes
  static constexpr int HIB = FMT == 2 ? 2 : FMT == 8 ? 1 : 0;         // hi-plane bits
  static constexpr bool MINS = FMT == 1 || FMT == 8;                  // u8 mins x dmin
  static constexpr bool ADDS = FMT == 3 || FMT == 4 || FMT == 5 || FMT == 7;   // c = a - offset*s
  static constexpr int GS = FMT == 2 || FMT == 4 ? 16 : FMT == 5 ? 8 : FMT == 6 ? 256 : 32;
  static constexpr int UPG = COMPACT || FMT == 6 ? 8 : 1;             // 32-groups a K unit
  static constexpr int CR = NIB ? 16 : 32;                            // code rows a 32-group
};

// one instantiation's geometry: format, BN columns, NB n8 fragments of rows.
// ops/qmatmul.py::_qmv_smem mirrors SMEM: change both together.
template <int FMT, int BN, int NB>
struct Geo {
  using F = Fmt<FMT>;
  static constexpr int NS = BN / 32;                        // column slabs
  static constexpr int KW = NCW / NS;                       // k warps
  static constexpr int GT = F::NIB || BN == 32 ? 8 : 4;     // 32-groups a tile
  static constexpr int P = GT / KW;                         // FMT 6: of each k warp's group
  static constexpr int NST = FMT == 2 || (FMT == 5 && BN == 128) ? 2
                             : FMT == 1 && NB == 1 ? 4 : 3;   // ring stages
  static constexpr int XG = FMT == 5 ? 16 : FMT == 2 || FMT == 4 || FMT >= 7 ? 32 : 64;   // 32-groups of x a chunk
  static constexpr int QG = F::GS >= 32 ? 1 : 32 / F::GS;   // quantizer groups a 32-group
  static constexpr int XQ = F::GS == 256 ? XG / 8 : XG * QG;   // quantizer groups a chunk
  static constexpr int ROW = BN == 32 ? 32 : BN + 32;       // code / hi row stride
  static constexpr int CODE_ROWS = GT * F::CR;
  static constexpr int HI_ROWS = GT * 4 * F::HIB;
  static constexpr int SC_ROWS = FMT == 2 ? 2 * GT : F::COMPACT ? GT : 0;
  static constexpr int SR = FMT == 6 ? KW : F::COMPACT ? 0 : GT * QG;   // f32 scale rows
  // byte offsets inside one ring stage (all multiples of 16)
  static constexpr int HI = CODE_ROWS * ROW;
  static constexpr int SC = HI + HI_ROWS * ROW;
  static constexpr int MN = SC + SC_ROWS * BN;
  static constexpr int D = MN + (F::MINS ? GT * BN : 0);
  static constexpr int DMIN = D + (F::COMPACT ? BN * 4 : 0);
  static constexpr int SCL = DMIN + (F::MINS ? BN * 4 : 0);
  static constexpr int ADD = SCL + SR * BN * 4;
  static constexpr int STAGE = ADD + (F::ADDS ? SR * BN * 4 : 0);
  // after the ring: x's codes as B fragments, then (sx, xs) pairs at
  // (quantizer group, row)
  static constexpr int XC = NST * STAGE;
  static constexpr int SXS = XC + XG * NB * 256;
  static constexpr int BAR = SXS + XQ * 8 * NB * 8;
  static constexpr int SMEM = BAR + 2 * NST * 8;
  // the end's sums reuse the ring and x: the k warps' (KW, 8 NB, BN) f32,
  // then the block's (8 NB, BN)
  static constexpr int PART = KW * 8 * NB * BN * 4;
  static_assert(PART + 8 * NB * BN * 4 <= BAR, "the sums outgrow the ring");
  static_assert(XG % GT == 0 && (FMT != 6 || XG % (8 * KW) == 0), "a tile straddles x's chunks");
  static_assert(SMEM <= 113 * 1024, "two blocks an SM");
};

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 4x4 byte transpose: r[i] holds row i of 4 columns; out[j] packs column j
// of the four rows (row 0 in the low byte)
__device__ __forceinline__ void transpose4(const uint32_t r[4], uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// byte j of w as 2^23 + byte, an exact f32
__device__ __forceinline__ float u8_biased(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + j));
}

// the products start from 1.5 * 2^23's bit pattern, so each integer dot
// |v| < 2^22 comes out as the bits of 1.5 * 2^23 + v: one exact subtraction
// makes it an f32 (no conversion instruction)
constexpr int MAGIC_BITS = 0x4B400000;
__device__ __forceinline__ float i2f(int bits) { return __int_as_float(bits) - 12582912.f; }

// ------------------------------------------------------------ the producer

// n rows from src (row stride sstride) into dst (row stride dstride), of
// which `valid` bytes a row (the ragged tile's columns) are copied; W is a
// full tile row's bytes. Each lane keeps one chunk column and steps down its
// rows by pointer increments.
template <int W>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dstride,
                                          const unsigned char* src, long sstride, int n,
                                          int valid, bool wide, int lane) {
  if (wide) {
    constexpr int CPR = W / 16;   // 16-byte chunks a row: 2 .. 32
    constexpr int RPP = CPR >= 32 ? 1 : 32 / CPR;
    const int q = CPR >= 32 ? lane : lane % CPR, r0 = CPR >= 32 ? 0 : lane / CPR;
    if (q * 16 >= valid) return;
    src += r0 * sstride + q * 16;
    dst += r0 * dstride + q * 16;
    for (int r = r0; r < n; r += RPP, src += RPP * sstride, dst += RPP * dstride)
      cp_async16(dst, src);
  } else {
    constexpr int WPR = W / 4;    // 4-byte words a row: 8 .. 128
    if constexpr (WPR >= 32) {
      for (int r = 0; r < n; ++r, src += sstride, dst += dstride)
        for (int q = lane; q * 4 < valid; q += 32) cp_async4(dst + q * 4, src + q * 4);
    } else {
      constexpr int RPP = 32 / WPR;
      const int q = lane % WPR, r0 = lane / WPR;
      if (q * 4 >= valid) return;
      src += r0 * sstride + q * 4;
      dst += r0 * dstride + q * 4;
      for (int r = r0; r < n; r += RPP, src += RPP * sstride, dst += RPP * dstride)
        cp_async4(dst, src);
    }
  }
}

// The tiles of a rank's 32-groups [g0, g1): tile i holds 32-groups
// g0 + i GT .. (a short last one at K's end). FMT 6 streams each k warp's
// own 256-group instead: round r gives k warp w the group g0 + 8 (r KW + w),
// and tile i = r T + p of a round holds 32-groups p P .. p P + P - 1 of each
// of its KW groups (a group past g1 is neither copied nor read).
template <int FMT, int BN, int NB>
struct Tiles {
  using G = Geo<FMT, BN, NB>;
  static constexpr int T = 8 / G::P;   // FMT 6: tiles a round
  __device__ static int count(int g0, int g1) {
    return FMT == 6 ? (g1 - g0 + 8 * G::KW - 1) / (8 * G::KW) * T : (g1 - g0 + G::GT - 1) / G::GT;
  }
  // the first 32-group of x tile i reads (x's chunks hold whole tiles)
  __device__ static int start(int g0, int i) {
    return FMT == 6 ? g0 + i / T * 8 * G::KW : g0 + i * G::GT;
  }
};

template <int FMT, int BN, int NB>
__device__ __forceinline__ void produce(const Args& a, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int n0, int ncol, int g0, int g1,
                                        int nt, int lane) {
  using G = Geo<FMT, BN, NB>;
  using F = Fmt<FMT>;
  const long N = a.N;
  const bool wide = a.wide;
  // a plane's rows from row0 (esz-byte elements), at this tile's columns
  auto plane = [&](const void* p, int esz, long row0) {
    return reinterpret_cast<const unsigned char*>(p) + (row0 * N + n0) * esz;
  };
  for (int i = 0; i < nt; ++i) {
    const int st = i % G::NST;
    if (i >= G::NST) mbar_wait(&empty[st], (i / G::NST - 1) & 1);
    unsigned char* s = smem + st * G::STAGE;
    if constexpr (FMT == 6) {
      constexpr int T = Tiles<FMT, BN, NB>::T;
      const int r = i / T, p = i % T;
      for (int w = 0; w < G::KW; ++w) {
        const int grp = g0 + (r * G::KW + w) * 8;   // k warp w's 256-group
        if (grp >= g1) break;
        copy_rows<BN>(s + w * G::P * 32 * G::ROW, G::ROW,
                      plane(a.codes, 1, (grp + p * G::P) * 32L), N, G::P * 32, ncol, wide, lane);
        if (p == T - 1)
          copy_rows<BN * 4>(s + G::SCL + w * BN * 4, BN * 4, plane(a.scales, 4, grp / 8), N * 4,
                            1, ncol * 4, wide, lane);
      }
    } else {
      const int gt0 = g0 + i * G::GT, gn = min(G::GT, g1 - gt0);
      copy_rows<BN>(s, G::ROW, plane(a.codes, 1, gt0 * (long)F::CR), N, gn * F::CR, ncol, wide,
                    lane);
      if constexpr (F::HIB > 0)
        copy_rows<BN>(s + G::HI, G::ROW, plane(a.hi, 1, gt0 * 4L * F::HIB), N, gn * 4 * F::HIB,
                      ncol, wide, lane);
      if constexpr (F::COMPACT) {
        constexpr int SPG = FMT == 2 ? 2 : 1;   // sub-scale rows a 32-group
        copy_rows<BN * 4>(s + G::D, BN * 4, plane(a.d, 4, gt0 / 8), N * 4, 1, ncol * 4, wide,
                          lane);
        copy_rows<BN>(s + G::SC, BN, plane(a.sc, 1, (long)gt0 * SPG), N, gn * SPG, ncol, wide,
                      lane);
        if constexpr (F::MINS) {
          copy_rows<BN>(s + G::MN, BN, plane(a.mn, 1, gt0), N, gn, ncol, wide, lane);
          copy_rows<BN * 4>(s + G::DMIN, BN * 4, plane(a.dmin, 4, gt0 / 8), N * 4, 1, ncol * 4,
                            wide, lane);
        }
      } else {
        copy_rows<BN * 4>(s + G::SCL, BN * 4, plane(a.scales, 4, (long)gt0 * G::QG), N * 4,
                          gn * G::QG, ncol * 4, wide, lane);
        if constexpr (F::ADDS)
          if (a.adds != nullptr)
            copy_rows<BN * 4>(s + G::ADD, BN * 4, plane(a.adds, 4, (long)gt0 * G::QG), N * 4,
                              gn * G::QG, ncol * 4, wide, lane);
      }
    }
    cp_async_arrive_noinc(&full[st]);
  }
}

// ------------------------------------------------------------ the quantizer

// x's rows m < 8 NB over the chunk's 32-groups [c0, c0 + cn) into shared
// memory: int8 codes as B fragments (32-group grp, fragment m / 8, lane
// (m % 8) * 4 + t, register h: elements 16 h + t + 4 i, i = 0..3, so a
// (row, group)'s 8 words are contiguous), (sx, xs) at (quantizer group,
// row). One thread a (row, 32-group), rows fastest (gs 256: 8 adjacent
// lanes a (row, 256-group), their amax and code sum by shuffles; the items
// of a warp are all live or all past the end, as R cn is a multiple of 64);
// rows past M get zero codes, sx and xs. The codes round by adding 1.5 *
// 2^23 (round half to even, as rintf), their low bytes are the int8 codes
// and the sum of the bit patterns less 1.5 * 2^23 each is the exact code
// sum.
template <int FMT, int NB>
__device__ __forceinline__ void quantize(const Args& a, uint32_t* xc, float2* sxs, int c0,
                                         int cn, int tid) {
  constexpr int R = 8 * NB;
  constexpr int GS = Fmt<FMT>::GS;
  constexpr int QS = GS > 32 ? 32 : GS;    // elements of a quantizer group in one thread
  constexpr int QG = 32 / QS;
  constexpr float MAGIC = 12582912.f;      // 1.5 * 2^23
  for (int it = tid; it < R * cn; it += NTC) {
    int m, grp;
    if constexpr (GS == 256) {
      m = (it >> 3) % R;
      grp = (it >> 3) / R * 8 + (it & 7);
    } else {
      m = it % R;
      grp = it / R;
    }
    float v[32];
    if (m < a.M) {
      const long k = (long)m * a.K + (c0 + grp) * 32L;
      if (a.x_bf16) {
        const uint4* src = reinterpret_cast<const uint4*>(
            reinterpret_cast<const __nv_bfloat16*>(a.x) + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 w = __ldg(src + q);
          const uint32_t ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[8 * q + 2 * e] = __uint_as_float(ww[e] << 16);
            v[8 * q + 2 * e + 1] = __uint_as_float(ww[e] & 0xffff0000u);
          }
        }
      } else {
        const float4* src = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(a.x) + k);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 w = __ldg(src + q);
          v[4 * q] = w.x; v[4 * q + 1] = w.y; v[4 * q + 2] = w.z; v[4 * q + 3] = w.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) v[e] = 0.f;
    }
    uint32_t b[32];
#pragma unroll
    for (int h0 = 0; h0 < 32; h0 += QS) {
      float amax = 0.f;
#pragma unroll
      for (int e = h0; e < h0 + QS; ++e) amax = fmaxf(amax, fabsf(v[e]));
      if constexpr (GS == 256) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      }
      const float sx = amax / 127.0f;
      const float inv = amax > 0.f ? 127.0f / amax : 0.f;
      uint32_t sum = 0;
#pragma unroll
      for (int e = h0; e < h0 + QS; ++e) {
        b[e] = __float_as_uint(__fadd_rn(__fmul_rn(v[e], inv), MAGIC));
        sum += b[e];
      }
      sum -= (uint32_t)QS * 0x4B400000u;   // exact modulo 2^32
      if constexpr (GS == 256) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if ((it & 7) == 0) sxs[grp / 8 * R + m] = make_float2(sx, __fmul_rn((float)(int)sum, sx));
      } else {
        sxs[(grp * QG + h0 / QS) * R + m] = make_float2(sx, __fmul_rn((float)(int)sum, sx));
      }
    }
    uint32_t w[8];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 16 * h + t;
        w[2 * t + h] = __byte_perm(__byte_perm(b[e], b[e + 4], 0x0040),
                                   __byte_perm(b[e + 8], b[e + 12], 0x0040), 0x5410);
      }
    uint4* dst = reinterpret_cast<uint4*>(xc + ((grp * NB + (m >> 3)) * 32 + (m & 7) * 4) * 2);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// ------------------------------------------------------------ the kernel

// a Q5_K hi word's column j (byte j: bit i the hi bit of element t + 4 i,
// bit 4 + i that of 16 + t + 4 i) as bit 4 of each code byte: lo for the
// low nibbles' codes, hi for the high nibbles'
__device__ __forceinline__ void q5_hi(uint32_t hw, int j, uint32_t& lo, uint32_t& hi) {
  const uint32_t rep = __byte_perm(hw, 0, 0x1111u * j);   // byte j in every byte
  // byte i holds 0 or 2^i (<= 8): adding 0x7F sets its bit 7 iff it is set
  lo = (((rep & 0x08040201u) + 0x7F7F7F7Fu) & 0x80808080u) >> 3;
  hi = ((((rep & 0x80402010u) >> 4) + 0x7F7F7F7Fu) & 0x80808080u) >> 3;
}

template <int FMT, int BN, int NB>
__global__ void __launch_bounds__(NT, 2) qmv_kernel(Args a) {
  using G = Geo<FMT, BN, NB>;
  using F = Fmt<FMT>;
  using TL = Tiles<FMT, BN, NB>;
  constexpr int R = 8 * NB;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR);
  uint64_t* empty = full + G::NST;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, cl = gridDim.x;       // the cluster spans grid x
  const int n0 = blockIdx.y * BN, ncol = min(BN, a.N - n0);
  const int n_units = a.K / (32 * F::UPG);
  const int g0 = min(rank * a.per, n_units) * F::UPG;       // this block's 32-groups
  const int g1 = min((rank + 1) * a.per, n_units) * F::UPG;
  const int nt = TL::count(g0, g1);
  if (tid == 0) {
    for (int i = 0; i < G::NST; ++i) { mbar_init(&full[i], 32); mbar_init(&empty[i], NCW); }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // lane (g, t) of consumer warp (slab, kw) owns tile columns cw .. cw + 3
  // (A rows g <-> cw + 2f, g + 8 <-> cw + 2f + 1 of fragment f) and rows
  // 8 nb + 2t, 2t + 1 of x (the products' columns)
  const int slab = warp % G::NS, kw = warp / G::NS, g = lane >> 2, t = lane & 3;
  const int cw = slab * 32 + 4 * g;
  float acc[NB][4][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nb][j][0] = acc[nb][j][1] = 0.f;
  // the correction c = a - offset * s at run time (FMT 3, 4, 5, 7)
  const bool has_adds = F::ADDS && a.adds != nullptr;
  const bool corr = F::MINS || has_adds || (F::ADDS && a.offset != 0);
  const float noff = -(float)a.offset;

  // acc += each product's exact dot (as 1.5 * 2^23 + dot) times sx * s,
  // and once a group xs * c; sxs at the quantizer group's (row 2t, 2t + 1)
  auto scale_add = [&](int nb, const int (&dd)[2][4], const float2* q, const float (&sj)[4],
                       const float (&cj)[4], bool with_c) {
    const float4 v = *reinterpret_cast<const float4*>(q + 8 * nb + 2 * t);
    const float sx[2] = {v.x, v.z}, xs[2] = {v.y, v.w};
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 2 * f + (e >> 1), rr = e & 1;
        acc[nb][j][rr] = fmaf(i2f(dd[f][e]), sx[rr] * sj[j], acc[nb][j][rr]);
        if (with_c) acc[nb][j][rr] = fmaf(xs[rr], cj[j], acc[nb][j][rr]);
      }
  };

  if (warp == NCW) {
    produce<FMT, BN, NB>(a, smem, full, empty, n0, ncol, g0, g1, nt, lane);
  } else {
    uint32_t* xc = reinterpret_cast<uint32_t*>(smem + G::XC);
    float2* sxs = reinterpret_cast<float2*>(smem + G::SXS);
    int dacc[NB][2][4];   // FMT 6: this warp's 256-group's dots, as 1.5 * 2^23 + dot
    int i = 0;
    for (int c0 = g0; c0 < g1; c0 += G::XG) {
      const int cn = min(G::XG, g1 - c0);
      if (c0 != g0) asm volatile("bar.sync 1, %0;\n" ::"r"(NTC) : "memory");
      quantize<FMT, NB>(a, xc, sxs, c0, cn, tid);
      asm volatile("bar.sync 1, %0;\n" ::"r"(NTC) : "memory");
      for (; i < nt && TL::start(g0, i) < c0 + cn; ++i) {
        const int st = i % G::NST;
        mbar_wait(&full[st], (i / G::NST) & 1);
        __syncwarp();
        const unsigned char* s = smem + st * G::STAGE;
        if constexpr (FMT == 6) {
          const int r = i / TL::T, p = i % TL::T;
          const int grp = g0 + (r * G::KW + kw) * 8;   // this warp's 256-group
          if (grp < g1) {
            if (p == 0) {
#pragma unroll
              for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                for (int f = 0; f < 2; ++f)
#pragma unroll
                  for (int e = 0; e < 4; ++e) dacc[nb][f][e] = MAGIC_BITS;
            }
#pragma unroll
            for (int u = 0; u < G::P; ++u) {
              const int xg = grp + p * G::P + u - c0;
              const unsigned char* cr = s + ((kw * G::P + u) * 32 + t) * G::ROW + cw;
              uint32_t r4[4], col[4], colh[4], A[2][4];
#pragma unroll
              for (int k = 0; k < 4; ++k) r4[k] = lds32(cr + 4 * k * G::ROW);
              transpose4(r4, col);
#pragma unroll
              for (int k = 0; k < 4; ++k) r4[k] = lds32(cr + (16 + 4 * k) * G::ROW);
              transpose4(r4, colh);
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                A[f][0] = col[2 * f]; A[f][1] = col[2 * f + 1];
                A[f][2] = colh[2 * f]; A[f][3] = colh[2 * f + 1];
              }
#pragma unroll
              for (int nb = 0; nb < NB; ++nb) {
                const uint2 b = *reinterpret_cast<const uint2*>(xc + ((xg * NB + nb) * 32 + lane) * 2);
#pragma unroll
                for (int f = 0; f < 2; ++f) mma_s8(dacc[nb][f], A[f], b.x, b.y);
              }
            }
            if (p == TL::T - 1) {   // the group's one scale
              const float4 v = *reinterpret_cast<const float4*>(s + G::SCL + (kw * BN + cw) * 4);
              const float sj[4] = {v.x, v.y, v.z, v.w}, cj[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int nb = 0; nb < NB; ++nb)
                scale_add(nb, dacc[nb], sxs + (grp - c0) / 8 * R, sj, cj, false);
            }
          }
        } else {
          const int gt0 = g0 + i * G::GT, gn = min(G::GT, g1 - gt0);
          // the superblock's d (and dmin), and -2^23 times them: fma(2^23 + b,
          // d, -2^23 d) rounds b d once, so it is fmul_rn(d, b) (d is an f16
          // value: no overflow)
          float dv[4] = {0.f, 0.f, 0.f, 0.f}, dn[4], mv[4] = {0.f, 0.f, 0.f, 0.f}, mnn[4];
          if constexpr (F::COMPACT) {
            const float4 d4 = *reinterpret_cast<const float4*>(s + G::D + cw * 4);
            dv[0] = d4.x; dv[1] = d4.y; dv[2] = d4.z; dv[3] = d4.w;
            if constexpr (F::MINS) {
              const float4 m4 = *reinterpret_cast<const float4*>(s + G::DMIN + cw * 4);
              mv[0] = m4.x; mv[1] = m4.y; mv[2] = m4.z; mv[3] = m4.w;
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) { dn[j] = -8388608.f * dv[j]; mnn[j] = -8388608.f * mv[j]; }
#pragma unroll
          for (int u = 0; u < G::GT / G::KW; ++u) {
            const int gi = kw + u * G::KW;
            if (gi >= gn) break;                 // a tile past K
            const int xg = gt0 + gi - c0;        // the group in x's chunk
            uint2 b[NB];
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              b[nb] = *reinterpret_cast<const uint2*>(xc + ((xg * NB + nb) * 32 + lane) * 2);
            // this lane's codes: rows t + 4i (and 16 + t + 4i for int8) of
            // its 4 columns, one column's 4 codes a register
            uint32_t r4[4], col[4];
            const unsigned char* cr = s + (gi * F::CR + t) * G::ROW + cw;
#pragma unroll
            for (int k = 0; k < 4; ++k) r4[k] = lds32(cr + 4 * k * G::ROW);
            transpose4(r4, col);
            if constexpr (FMT == 2) {
              // Q6_K: two 16-groups of the 32-group, each its own scale
              const unsigned char* hr = s + G::HI + (gi * 8 + t) * G::ROW + cw;
              const uint32_t h0 = lds32(hr), h1 = lds32(hr + 4 * G::ROW);
              uint32_t q[2][4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                // element t + 4i's 2 high bits: hi row t + 4 (i & 1), field i >> 1
                // (16 + t + 4i: field 2 + (i >> 1))
                const uint32_t pp = __byte_perm(h0, h1, j | ((j + 4) << 4) | (j << 8) | ((j + 4) << 12));
                q[0][j] = (col[j] & M4) | ((__byte_perm(pp, pp >> 2, 0x7610) & 0x03030303u) << 4);
                q[1][j] = ((col[j] >> 4) & M4) |
                          ((__byte_perm(pp >> 4, pp >> 6, 0x7610) & 0x03030303u) << 4);
              }
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                // the signed sub-scales: 2^23 + (sc ^ 0x80) less 2^23 + 128, exact
                const uint32_t scw = lds32(s + G::SC + (2 * gi + h) * BN + cw) ^ 0x80808080u;
                float sj[4], cj[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  sj[j] = dv[j] * (u8_biased(scw, j) - 8388736.f);
                  cj[j] = -32.0f * sj[j];
                }
#pragma unroll
                for (int nb = 0; nb < NB; ++nb) {
                  int dd[2][4];
#pragma unroll
                  for (int f = 0; f < 2; ++f)
                    mma_s8_k16_c(dd[f], q[h][2 * f], q[h][2 * f + 1], h ? b[nb].y : b[nb].x,
                                 MAGIC_BITS);
                  scale_add(nb, dd, sxs + (2 * xg + h) * R, sj, cj, true);
                }
              }
            } else {
              // the 32-group's codes as two A fragments: A[f][0..1] elements
              // t + 4i of columns cw + 2f, cw + 2f + 1, A[f][2..3] 16 + t + 4i
              uint32_t A[2][4];
              if constexpr (!F::NIB) {
                uint32_t colh[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) r4[k] = lds32(cr + (16 + 4 * k) * G::ROW);
                transpose4(r4, colh);
#pragma unroll
                for (int f = 0; f < 2; ++f) {
                  A[f][0] = col[2 * f]; A[f][1] = col[2 * f + 1];
                  A[f][2] = colh[2 * f]; A[f][3] = colh[2 * f + 1];
                }
              } else {
                uint32_t lo[4], hi[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) { lo[j] = col[j] & M4; hi[j] = (col[j] >> 4) & M4; }
                if constexpr (F::HIB == 1) {
                  // Q5_K: element e's bit 4 in hi row e % 4, bit e / 4
                  const uint32_t hw = lds32(s + G::HI + (gi * 4 + t) * G::ROW + cw);
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    uint32_t l5, h5;
                    q5_hi(hw, j, l5, h5);
                    lo[j] |= l5;
                    hi[j] |= h5;
                  }
                }
#pragma unroll
                for (int f = 0; f < 2; ++f) {
                  A[f][0] = lo[2 * f]; A[f][1] = lo[2 * f + 1];
                  A[f][2] = hi[2 * f]; A[f][3] = hi[2 * f + 1];
                }
              }
              if constexpr (F::GS == 32) {
                float sj[4], cj[4] = {0.f, 0.f, 0.f, 0.f};
                if constexpr (F::COMPACT) {
                  const uint32_t scw = lds32(s + G::SC + gi * BN + cw);
                  const uint32_t mnw = lds32(s + G::MN + gi * BN + cw);
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    sj[j] = __fmaf_rn(u8_biased(scw, j), dv[j], dn[j]);     // d * sc
                    cj[j] = -__fmaf_rn(u8_biased(mnw, j), mv[j], mnn[j]);   // -dmin * mn
                  }
                } else {
                  const float4 v = *reinterpret_cast<const float4*>(s + G::SCL + (gi * BN + cw) * 4);
                  sj[0] = v.x; sj[1] = v.y; sj[2] = v.z; sj[3] = v.w;
                  if constexpr (F::ADDS) {
                    if (has_adds) {
                      const float4 w = *reinterpret_cast<const float4*>(s + G::ADD + (gi * BN + cw) * 4);
                      cj[0] = w.x; cj[1] = w.y; cj[2] = w.z; cj[3] = w.w;
                    }
#pragma unroll
                    for (int j = 0; j < 4; ++j) cj[j] = __fadd_rn(cj[j], noff * sj[j]);
                  }
                }
#pragma unroll
                for (int nb = 0; nb < NB; ++nb) {
                  int dd[2][4];
#pragma unroll
                  for (int f = 0; f < 2; ++f) mma_s8_c(dd[f], A[f], b[nb].x, b[nb].y, MAGIC_BITS);
                  scale_add(nb, dd, sxs + xg * R, sj, cj, corr);
                }
              } else {
                // gs 16: the two halves' m16n8k16 products; gs 8: each half's
                // two 8-groups, x's codes of the other 8 masked to zero
#pragma unroll
                for (int q = 0; q < G::QG; ++q) {
                  const int h = F::GS == 16 ? q : q >> 1;
                  const uint32_t mask = F::GS == 16 ? 0xFFFFFFFFu : q & 1 ? 0xFFFF0000u : 0x0000FFFFu;
                  const int row = gi * G::QG + q;
                  const float4 v = *reinterpret_cast<const float4*>(s + G::SCL + (row * BN + cw) * 4);
                  const float sj[4] = {v.x, v.y, v.z, v.w};
                  float cj[4] = {0.f, 0.f, 0.f, 0.f};
                  if (has_adds) {
                    const float4 w = *reinterpret_cast<const float4*>(s + G::ADD + (row * BN + cw) * 4);
                    cj[0] = w.x; cj[1] = w.y; cj[2] = w.z; cj[3] = w.w;
                  }
#pragma unroll
                  for (int j = 0; j < 4; ++j) cj[j] = __fadd_rn(cj[j], noff * sj[j]);
#pragma unroll
                  for (int nb = 0; nb < NB; ++nb) {
                    int dd[2][4];
                    const uint32_t bx = (h ? b[nb].y : b[nb].x) & mask;
#pragma unroll
                    for (int f = 0; f < 2; ++f)
                      mma_s8_k16_c(dd[f], A[f][2 * h], A[f][2 * h + 1], bx, MAGIC_BITS);
                    scale_add(nb, dd, sxs + (xg * G::QG + q) * R, sj, cj, corr);
                  }
                }
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    }
  }

  // every tile issued has been consumed: the ring and x are free. The k
  // warps' sums, added in warp order, then the cluster's in rank order
  // (rank r stores the output quads e = r (mod cl) of the tile).
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (warp < NCW) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          red[((kw * NB + nb) * 8 + 2 * t + rr) * BN + cw + j] = acc[nb][j][rr];
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem + G::PART);
  for (int e = tid; e < 8 * NB * BN / 4; e += NT) {
    float4 v = reinterpret_cast<const float4*>(red)[e];
    for (int k = 1; k < G::KW; ++k) {
      const float4 w = reinterpret_cast<const float4*>(red)[k * 8 * NB * BN / 4 + e];
      v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
    }
    reinterpret_cast<float4*>(part)[e] = v;
  }
  // a block alone needs no cluster barrier
  if (cl > 1) cluster.sync();
  else __syncthreads();
  const int c4n = ncol / 4, units = a.M * c4n;
  for (int e = rank * NT + tid; e < units; e += cl * NT) {
    const int m = e / c4n, c4 = e - m * c4n;
    float4 v = reinterpret_cast<const float4*>(part)[m * BN / 4 + c4];
    if (cl > 1) {
      v = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0))[m * BN / 4 + c4];
      for (int k = 1; k < cl; ++k) {
        const float4 w =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(part, k))[m * BN / 4 + c4];
        v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
      }
    }
    const long o = (long)m * a.N + n0 + 4 * c4;
    if (a.out_bf16)
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(a.out) + o) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    else
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(a.out) + o) = v;
  }
  if (cl > 1) cluster.sync();   // the other ranks have read this block's sums
}

template <int FMT, int BN, int NB>
cudaError_t launch(const Args& a, int cl, cudaStream_t st) {
  using G = Geo<FMT, BN, NB>;
  static bool attr_set = false;   // set once, never under graph capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmv_kernel<FMT, BN, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, (a.N + BN - 1) / BN, 1);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, qmv_kernel<FMT, BN, NB>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int FMT, int BN>
cudaError_t launch_rows(const Args& a, int cl, cudaStream_t st) {
  return a.M <= 8 ? launch<FMT, BN, 1>(a, cl, st) : launch<FMT, BN, 2>(a, cl, st);
}

template <int FMT>
cudaError_t launch_bn(const Args& a, int bn, int cl, cudaStream_t st) {
  if (bn == 128) return launch_rows<FMT, 128>(a, cl, st);
  if (bn == 64) return launch_rows<FMT, 64>(a, cl, st);
  return launch_rows<FMT, 32>(a, cl, st);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// blocks of clusters of cl the card holds at once, or a negative cudaError_t
template <int FMT, int BN, int NB>
int resident(int cl) {
  using G = Geo<FMT, BN, NB>;
  cudaError_t e = cudaFuncSetAttribute(qmv_kernel<FMT, BN, NB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = G::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, qmv_kernel<FMT, BN, NB>, &cfg);
  return e == cudaSuccess ? n * cl : -(int)e;
}

template <int FMT>
int resident_bn(int bn, int nb, int cl) {
  if (bn == 128) return nb == 1 ? resident<FMT, 128, 1>(cl) : resident<FMT, 128, 2>(cl);
  if (bn == 64) return nb == 1 ? resident<FMT, 64, 1>(cl) : resident<FMT, 64, 2>(cl);
  return nb == 1 ? resident<FMT, 32, 1>(cl) : resident<FMT, 32, 2>(cl);
}

// the format's instantiation: f(std::integral_constant<int, FMT>)
template <typename Fn>
auto by_fmt(int fmt, Fn f) {
  switch (fmt) {
    case 0: return f(std::integral_constant<int, 0>());
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    default: return f(std::integral_constant<int, 8>());
  }
}

}  // namespace

// fmt 0-8 (the formats above); x (M <= 16, K) f32 or bf16, 16-byte
// aligned; out (M, N) f32 or bf16; adds (FMT 3, 4, 5, 7) an f32 (K/gs, N)
// plane or null, offset the codes' (Q6_K: 32; FMT 3, 4, 5, 7: any; else 0).
// The plan (qmv_plan): column tile bn (128, 64 or 32), a cluster of cl <= 8
// blocks along K, per K units (superblocks; 32-groups) a rank, every rank
// holding at least one. One launch; returns its cudaError_t.
extern "C" int slt_qmv(int fmt, int M, int K, int N, const void* x, int x_bf16,
                       const void* codes, const void* hi, const void* scales, const void* sc,
                       const void* mn, const void* d, const void* dmin, const void* adds,
                       int offset, int bn, int cl, int per, void* out, int out_bf16,
                       void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool planar_c = fmt == 3 || fmt == 4 || fmt == 5 || fmt == 7;   // adds and offset
  const int unit = fmt == 1 || fmt == 2 || fmt == 6 || fmt == 8 ? 256 : 32, n_units = K / unit;
  if (fmt < 0 || fmt >= NFMT || M < 1 || M > MAXR || N < 4 || N % 4 || K % unit || K < unit ||
      (bn != 128 && bn != 64 && bn != 32) || cl < 1 || cl > 8 || per < 1 ||
      (long)cl * per < n_units || (long)(cl - 1) * per >= n_units || !aligned16(x) ||
      (N + bn - 1) / bn > 65535 || (adds != nullptr && !planar_c) ||
      offset != (fmt == 2 ? 32 : planar_c ? offset : 0))
    return (int)cudaErrorInvalidValue;
  const void* planes[] = {codes, hi, scales, sc, mn, d, dmin, adds};
  bool wide = N % 16 == 0;
  for (const void* p : planes) wide = wide && (p == nullptr || aligned16(p));
  Args a{M, K, N, per, x, x_bf16, (const uint8_t*)codes, (const uint8_t*)hi,
         (const float*)scales, (const uint8_t*)sc, (const uint8_t*)mn, (const float*)d,
         (const float*)dmin, (const float*)adds, offset, out, out_bf16, wide ? 1 : 0};
  return (int)by_fmt(fmt, [&](auto f) { return launch_bn<decltype(f)::value>(a, bn, cl, st); });
}

// Blocks of the kernel for fmt, column tile bn and up to `rows` rows that the
// card holds at once in clusters of cl (cudaOccupancyMaxActiveClusters x cl;
// qmv_plan's table assumes the H100's), or a negative cudaError_t.
extern "C" int slt_qmv_resident(int fmt, int bn, int rows, int cl) {
  if (fmt < 0 || fmt >= NFMT || (bn != 128 && bn != 64 && bn != 32) || rows < 1 ||
      rows > MAXR || cl < 1 || cl > 8)
    return -(int)cudaErrorInvalidValue;
  const int nb = rows <= 8 ? 1 : 2;
  return by_fmt(fmt, [&](auto f) { return resident_bn<decltype(f)::value>(bn, nb, cl); });
}
