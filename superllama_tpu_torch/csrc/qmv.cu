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
//    NST stages (3; 4 for Q4_K at 8 rows; 2 for Q6_K's larger tiles) of
//    one superblock (Q8_0: 4-8 groups): a producer warp fills a stage with
//    16-byte cp.async copies (4-byte ones when N is not a multiple of 16),
//    pointer increments down each lane's column, completed on the stage's
//    `full` mbarrier; the 8 consumer warps (column slabs x k warps) free it
//    on `empty`. Up to 94 KB a block, two blocks an SM, are in flight.
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
// Weight formats (FMT): 0 = Q8_0 (int8 codes, f32 scale plane, gs 32),
// 1 = Q4_K compact (nibbles, u8 sc/mn, f32 d/dmin per 256, gs 32),
// 2 = Q6_K compact (nibbles + 2-bit hi plane, i8 sc, f32 d per 256, gs 16,
// offset 32).

#include "ptx.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using namespace ptx;

constexpr int NCW = 8;               // consumer warps
constexpr int NTC = NCW * 32;        // consumer threads
constexpr int NT = NTC + 32;         // and the producer warp
constexpr int MAXR = 16;             // rows a launch
constexpr uint32_t M4 = 0x0F0F0F0Fu;

struct Args {
  int M, K, N, per;                  // per: K units (superblocks; Q8_0 groups) a rank
  const void* x; int x_bf16;
  const uint8_t* codes; const uint8_t* hi; const float* scales;
  const uint8_t* sc; const uint8_t* mn; const float* d; const float* dmin;
  void* out; int out_bf16;
  int wide;                          // 16-byte copies, else 4-byte
};

// one instantiation's geometry: format, BN columns, NB n8 fragments of rows.
// ops/qmatmul.py::_qmv_smem mirrors SMEM: change both together.
template <int FMT, int BN, int NB>
struct Geo {
  static constexpr int NS = BN / 32;                        // column slabs
  static constexpr int KW = NCW / NS;                       // k warps
  static constexpr int GT = FMT == 0 ? (BN == 32 ? 8 : 4) : 8;   // 32-groups a tile
  static constexpr int UPG = FMT == 0 ? 1 : 8;              // 32-groups a K unit
  static constexpr int NST = FMT == 2 ? 2 : FMT == 1 && NB == 1 ? 4 : 3;   // ring stages
  static constexpr int XG = FMT == 2 ? 32 : 64;             // 32-groups of x a chunk
  static constexpr int QG = FMT == 2 ? 2 : 1;               // quantizer groups a 32-group
  static constexpr int ROW = BN == 32 ? 32 : BN + 32;       // code / hi row stride
  static constexpr int CODE_ROWS = FMT == 0 ? GT * 32 : GT * 16;
  static constexpr int HI_ROWS = FMT == 2 ? GT * 8 : 0;
  static constexpr int SC_ROWS = FMT == 1 ? GT : FMT == 2 ? 2 * GT : 0;
  // byte offsets inside one ring stage (all multiples of 16)
  static constexpr int HI = CODE_ROWS * ROW;
  static constexpr int SC = HI + HI_ROWS * ROW;
  static constexpr int MN = SC + SC_ROWS * BN;
  static constexpr int D = MN + (FMT == 1 ? GT * BN : 0);
  static constexpr int DMIN = D + (FMT == 0 ? 0 : BN * 4);
  static constexpr int SCL = DMIN + (FMT == 1 ? BN * 4 : 0);
  static constexpr int STAGE = SCL + (FMT == 0 ? GT * BN * 4 : 0);
  // after the ring: x's codes as B fragments, then (sx, xs) pairs at
  // (quantizer group, row)
  static constexpr int XC = NST * STAGE;
  static constexpr int SXS = XC + XG * NB * 256;
  static constexpr int BAR = SXS + XG * QG * 8 * NB * 8;
  static constexpr int SMEM = BAR + 2 * NST * 8;
  // the end's sums reuse the ring and x: the k warps' (KW, 8 NB, BN) f32,
  // then the block's (8 NB, BN)
  static constexpr int PART = KW * 8 * NB * BN * 4;
  static_assert(PART + 8 * NB * BN * 4 <= BAR, "the sums outgrow the ring");
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

template <int FMT, int BN, int NB>
__device__ __forceinline__ void produce(const Args& a, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int n0, int ncol, int g0, int g1,
                                        int nt, int lane) {
  using G = Geo<FMT, BN, NB>;
  const long N = a.N;
  const bool wide = a.wide;
  // a plane's rows from row0 (esz-byte elements), at this tile's columns
  auto plane = [&](const void* p, int esz, long row0) {
    return reinterpret_cast<const unsigned char*>(p) + (row0 * N + n0) * esz;
  };
  for (int i = 0; i < nt; ++i) {
    const int st = i % G::NST;
    if (i >= G::NST) mbar_wait(&empty[st], (i / G::NST - 1) & 1);
    const int gt0 = g0 + i * G::GT, gn = min(G::GT, g1 - gt0);
    unsigned char* s = smem + st * G::STAGE;
    if constexpr (FMT == 0) {
      copy_rows<BN>(s, G::ROW, plane(a.codes, 1, gt0 * 32L), N, gn * 32, ncol, wide, lane);
      copy_rows<BN * 4>(s + G::SCL, BN * 4, plane(a.scales, 4, gt0), N * 4, gn, ncol * 4,
                        wide, lane);
    } else {
      copy_rows<BN>(s, G::ROW, plane(a.codes, 1, gt0 * 16L), N, gn * 16, ncol, wide, lane);
      copy_rows<BN * 4>(s + G::D, BN * 4, plane(a.d, 4, gt0 / 8), N * 4, 1, ncol * 4, wide,
                        lane);
      if constexpr (FMT == 1) {
        copy_rows<BN>(s + G::SC, BN, plane(a.sc, 1, gt0), N, gn, ncol, wide, lane);
        copy_rows<BN>(s + G::MN, BN, plane(a.mn, 1, gt0), N, gn, ncol, wide, lane);
        copy_rows<BN * 4>(s + G::DMIN, BN * 4, plane(a.dmin, 4, gt0 / 8), N * 4, 1, ncol * 4,
                          wide, lane);
      } else {
        copy_rows<BN>(s + G::HI, G::ROW, plane(a.hi, 1, gt0 * 8L), N, gn * 8, ncol, wide, lane);
        copy_rows<BN>(s + G::SC, BN, plane(a.sc, 1, gt0 * 2L), N, gn * 2, ncol, wide, lane);
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
// row). One thread a (row, 32-group), rows fastest; rows past M get zero
// codes, sx and xs. The codes round by adding 1.5 * 2^23 (round half to
// even, as rintf), their low bytes are the int8 codes and the sum of the
// bit patterns less 1.5 * 2^23 each is the exact code sum.
template <int FMT, int NB>
__device__ __forceinline__ void quantize(const Args& a, uint32_t* xc, float2* sxs, int c0,
                                         int cn, int tid) {
  constexpr int R = 8 * NB;
  constexpr int GS = FMT == 2 ? 16 : 32;   // elements a quantizer group
  constexpr float MAGIC = 12582912.f;      // 1.5 * 2^23
  for (int it = tid; it < R * cn; it += NTC) {
    const int m = it % R, grp = it / R;
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
    for (int h0 = 0; h0 < 32; h0 += GS) {
      float amax = 0.f;
#pragma unroll
      for (int e = h0; e < h0 + GS; ++e) amax = fmaxf(amax, fabsf(v[e]));
      const float sx = amax / 127.0f;
      const float inv = amax > 0.f ? 127.0f / amax : 0.f;
      uint32_t sum = 0;
#pragma unroll
      for (int e = h0; e < h0 + GS; ++e) {
        b[e] = __float_as_uint(__fadd_rn(__fmul_rn(v[e], inv), MAGIC));
        sum += b[e];
      }
      sum -= (uint32_t)GS * 0x4B400000u;   // exact modulo 2^32
      const int qg = FMT == 2 ? 2 * grp + h0 / 16 : grp;
      sxs[qg * R + m] = make_float2(sx, __fmul_rn((float)(int)sum, sx));
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

template <int FMT, int BN, int NB>
__global__ void __launch_bounds__(NT, 2) qmv_kernel(Args a) {
  using G = Geo<FMT, BN, NB>;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR);
  uint64_t* empty = full + G::NST;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, cl = gridDim.x;       // the cluster spans grid x
  const int n0 = blockIdx.y * BN, ncol = min(BN, a.N - n0);
  const int n_units = FMT == 0 ? a.K / 32 : a.K / 256;
  const int g0 = min(rank * a.per, n_units) * G::UPG;       // this block's 32-groups
  const int g1 = min((rank + 1) * a.per, n_units) * G::UPG;
  const int nt = (g1 - g0 + G::GT - 1) / G::GT;
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

  if (warp == NCW) {
    produce<FMT, BN, NB>(a, smem, full, empty, n0, ncol, g0, g1, nt, lane);
  } else {
    uint32_t* xc = reinterpret_cast<uint32_t*>(smem + G::XC);
    float2* sxs = reinterpret_cast<float2*>(smem + G::SXS);
    int i = 0;
    for (int c0 = g0; c0 < g1; c0 += G::XG) {
      const int cn = min(G::XG, g1 - c0);
      if (c0 != g0) asm volatile("bar.sync 1, %0;\n" ::"r"(NTC) : "memory");
      quantize<FMT, NB>(a, xc, sxs, c0, cn, tid);
      asm volatile("bar.sync 1, %0;\n" ::"r"(NTC) : "memory");
      for (; i < nt && g0 + i * G::GT < c0 + cn; ++i) {
        const int st = i % G::NST;
        mbar_wait(&full[st], (i / G::NST) & 1);
        __syncwarp();
        const unsigned char* s = smem + st * G::STAGE;
        const int gt0 = g0 + i * G::GT, gn = min(G::GT, g1 - gt0);
        // the superblock's d (and dmin), and -2^23 times them: fma(2^23 + b,
        // d, -2^23 d) rounds b d once, so it is fmul_rn(d, b) (d is an f16
        // value: no overflow)
        float dv[4] = {0.f, 0.f, 0.f, 0.f}, dn[4], mv[4] = {0.f, 0.f, 0.f, 0.f}, mnn[4];
        if constexpr (FMT != 0) {
          const float4 d4 = *reinterpret_cast<const float4*>(s + G::D + cw * 4);
          dv[0] = d4.x; dv[1] = d4.y; dv[2] = d4.z; dv[3] = d4.w;
          if constexpr (FMT == 1) {
            const float4 m4 = *reinterpret_cast<const float4*>(s + G::DMIN + cw * 4);
            mv[0] = m4.x; mv[1] = m4.y; mv[2] = m4.z; mv[3] = m4.w;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) { dn[j] = -8388608.f * dv[j]; mnn[j] = -8388608.f * mv[j]; }
#pragma unroll
        for (int u = 0; u < G::GT / G::KW; ++u) {
          const int gi = kw + u * G::KW;
          if (FMT == 0 && gi >= gn) break;   // a Q8_0 tile past K
          const int xg = gt0 + gi - c0;      // the group in x's chunk
          uint2 b[NB];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            b[nb] = *reinterpret_cast<const uint2*>(xc + ((xg * NB + nb) * 32 + lane) * 2);
          // this lane's codes: rows t + 4i (and 16 + t + 4i for Q8_0) of
          // its 4 columns, one column's 4 codes a register
          uint32_t r[4], col[4];
          const unsigned char* cr = s + (gi * (FMT == 0 ? 32 : 16) + t) * G::ROW + cw;
#pragma unroll
          for (int k = 0; k < 4; ++k) r[k] = lds32(cr + 4 * k * G::ROW);
          transpose4(r, col);
          if constexpr (FMT == 2) {
            // Q6_K: two 16-groups of the 32-group, each its own scale
            const unsigned char* hr = s + G::HI + (gi * 8 + t) * G::ROW + cw;
            const uint32_t h0 = lds32(hr), h1 = lds32(hr + 4 * G::ROW);
            uint32_t q[2][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              // element t + 4i's 2 high bits: hi row t + 4 (i & 1), field i >> 1
              // (16 + t + 4i: field 2 + (i >> 1))
              const uint32_t p = __byte_perm(h0, h1, j | ((j + 4) << 4) | (j << 8) | ((j + 4) << 12));
              q[0][j] = (col[j] & M4) | ((__byte_perm(p, p >> 2, 0x7610) & 0x03030303u) << 4);
              q[1][j] = ((col[j] >> 4) & M4) |
                        ((__byte_perm(p >> 4, p >> 6, 0x7610) & 0x03030303u) << 4);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // the signed sub-scales: 2^23 + (sc ^ 0x80) less 2^23 + 128, exact
              const uint32_t scw = lds32(s + G::SC + (2 * gi + h) * BN + cw) ^ 0x80808080u;
              float sj[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) sj[j] = dv[j] * (u8_biased(scw, j) - 8388736.f);
              const int qg = 2 * xg + h;
#pragma unroll
              for (int nb = 0; nb < NB; ++nb) {
                int dd[2][4];
#pragma unroll
                for (int f = 0; f < 2; ++f)
                  mma_s8_k16_c(dd[f], q[h][2 * f], q[h][2 * f + 1], h ? b[nb].y : b[nb].x,
                               MAGIC_BITS);
                const float4 v = *reinterpret_cast<const float4*>(sxs + qg * 8 * NB + 8 * nb + 2 * t);
                const float sx[2] = {v.x, v.z}, xs[2] = {v.y, v.w};
#pragma unroll
                for (int f = 0; f < 2; ++f)
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const int j = 2 * f + (e >> 1), rr = e & 1;
                    acc[nb][j][rr] = fmaf(i2f(dd[f][e]), sx[rr] * sj[j], acc[nb][j][rr]);
                    acc[nb][j][rr] = fmaf(xs[rr], -32.0f * sj[j], acc[nb][j][rr]);
                  }
              }
            }
          } else {
            uint32_t A[2][4];
            if constexpr (FMT == 0) {
              uint32_t colh[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) r[k] = lds32(cr + (16 + 4 * k) * G::ROW);
              transpose4(r, colh);
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                A[f][0] = col[2 * f]; A[f][1] = col[2 * f + 1];
                A[f][2] = colh[2 * f]; A[f][3] = colh[2 * f + 1];
              }
            } else {
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                A[f][0] = col[2 * f] & M4; A[f][1] = col[2 * f + 1] & M4;
                A[f][2] = (col[2 * f] >> 4) & M4; A[f][3] = (col[2 * f + 1] >> 4) & M4;
              }
            }
            float sj[4], cm[4] = {0.f, 0.f, 0.f, 0.f};
            if constexpr (FMT == 0) {
              const float4 v = *reinterpret_cast<const float4*>(s + G::SCL + (gi * BN + cw) * 4);
              sj[0] = v.x; sj[1] = v.y; sj[2] = v.z; sj[3] = v.w;
            } else {
              const uint32_t scw = lds32(s + G::SC + gi * BN + cw);
              const uint32_t mnw = lds32(s + G::MN + gi * BN + cw);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                sj[j] = __fmaf_rn(u8_biased(scw, j), dv[j], dn[j]);    // d * sc
                cm[j] = __fmaf_rn(u8_biased(mnw, j), mv[j], mnn[j]);   // dmin * mn = -c
              }
            }
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              int dd[2][4];
#pragma unroll
              for (int f = 0; f < 2; ++f) mma_s8_c(dd[f], A[f], b[nb].x, b[nb].y, MAGIC_BITS);
              const float4 v = *reinterpret_cast<const float4*>(sxs + xg * 8 * NB + 8 * nb + 2 * t);
              const float sx[2] = {v.x, v.z}, xs[2] = {v.y, v.w};
#pragma unroll
              for (int f = 0; f < 2; ++f)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int j = 2 * f + (e >> 1), rr = e & 1;
                  acc[nb][j][rr] = fmaf(i2f(dd[f][e]), sx[rr] * sj[j], acc[nb][j][rr]);
                  if constexpr (FMT == 1) acc[nb][j][rr] = fmaf(xs[rr], -cm[j], acc[nb][j][rr]);
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

// ------------------------------------------- the planar and Q5_K kernel
//
// The other formats of the JAX package (ops/qtensor.py), in one kernel of
// runtime group size, offset and adds (the same sums as above, the same
// activation quantizer at the weights' group size):
//   FAM 3: int8 codes (K, N), f32 scales (K/gs, N), optional f32 adds;
//          gs 8 (IQ1_M), 16 (Q2_K, Q3_K, IQ2_XS, IQ2_S), 32 (Q5_0, Q5_1,
//          MXFP4, IQ4_NL, IQ4_XS, IQ2_XXS, IQ3_XXS, IQ3_S, IQ1_S) or 256
//          (Q8_K, TQ1_0, TQ2_0);
//   FAM 4: nibbles (K/2, N) in the group-local layout, f32 scales per 32,
//          offset 8 (Q4_0) or f32 adds (Q4_1);
//   FAM 5: Q5_K compact (Q4_K's planes and a 1-bit hi plane, element e of a
//          32-group in hi row e % 4, bit e / 4).
// A block of 8 warps owns BN columns and one split of K (qmv_planar_plan:
// where the column tiles alone give too few blocks, up to 8 splits, whose
// f32 partials qmv_planar_reduce adds in split order; no thread block
// cluster: a cluster of two cost this kernel about 0.02 ms a call on the
// H100, PERF.md section 6). For each chunk of KC elements of its
// range it quantizes x's rows into shared memory (a team of gs/8 threads
// a (row, group), 8 elements a thread, every item's x loaded first: amax
// and the code sum by shuffles in a fixed order), then each thread takes
// 4 adjacent columns and 32-element k blocks in turn (k slice ks takes
// blocks ks, ks + KS, ..): its 32-bit loads of the block's code rows all
// issued first, straight from device memory, a byte transpose to one
// column's 4 codes a word, dp4a against x's codes, a group's exact integer
// dot scaled by sx * s in f32, the correction xs * (a - offset * s) once a
// group. The k slices' sums are added in a fixed order (shuffles, then the
// warps' in warp order). A simple kernel: correct first; its speed is
// later work.

constexpr int PNT = 256;             // threads of a planar block
constexpr int KC = 1024;             // x elements a chunk

struct PArgs {
  int M, K, N, per, unit, gs, offset;   // per: K units (unit elements) a split
  const void* x; int x_bf16;
  const uint8_t* codes; const uint8_t* hi; const float* scales; const float* adds;
  const uint8_t* sc; const uint8_t* mn; const float* d; const float* dmin;
  float* part;                          // (splits, M, N) f32 partials, or null
  void* out; int out_bf16;
};

template <int MR>
struct PGeo {
  static constexpr int XQ = 0;                          // int8 codes (MR, KC)
  static constexpr int SXS = XQ + MR * KC;              // (sx, xs) (MR, KC / 8)
  static constexpr int PART = SXS + MR * (KC / 8) * 8;  // f32 sums (MR, BN <= 64)
  static constexpr int RED = PART + MR * 64 * 4;        // each warp's (MR, BN)
  static constexpr int SMEM = RED + (PNT / 32) * MR * 64 * 4;
};

// x's rows m < MR over [c0, c0 + cn) quantized at group size gs: codes to
// xq (row stride KC), (sx, xs) to sxs at (row, group in the chunk). Each
// thread takes items (row, 8 elements) tid, tid + PNT, ..: every item's x
// is loaded first, then quantized (a team of gs/8 lanes a group).
template <int MR>
__device__ __forceinline__ void quantize_planar(const PArgs& a, int8_t* xq, float2* sxs, int c0,
                                                int cn, int tid) {
  constexpr int NI = (MR * KC / 8 + PNT - 1) / PNT;   // items a thread at most
  const int T = a.gs >= 256 ? 32 : a.gs / 8;          // threads a (row, group)
  const int per_row = cn / 8, items = MR * per_row;
  uint4 raw[NI][2];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int it = tid + i * PNT, m = it / per_row, k = c0 + (it - m * per_row) * 8;
    raw[i][0] = raw[i][1] = make_uint4(0u, 0u, 0u, 0u);
    if (it < items && m < a.M) {
      if (a.x_bf16) {
        raw[i][0] = __ldg(reinterpret_cast<const uint4*>(
            reinterpret_cast<const __nv_bfloat16*>(a.x) + (long)m * a.K + k));
      } else {
        const uint4* src = reinterpret_cast<const uint4*>(reinterpret_cast<const float*>(a.x) +
                                                          (long)m * a.K + k);
        raw[i][0] = __ldg(src);
        raw[i][1] = __ldg(src + 1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    // block-uniform: past the last warp that holds an item, none computes
    if (i * PNT >= (items + 31) / 32 * 32) break;
    const int it = tid + i * PNT, m = it / per_row, e8 = it - m * per_row;
    float v[8];
    if (a.x_bf16) {
      const uint32_t ww[4] = {raw[i][0].x, raw[i][0].y, raw[i][0].z, raw[i][0].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[2 * e] = __uint_as_float(ww[e] << 16);
        v[2 * e + 1] = __uint_as_float(ww[e] & 0xffff0000u);
      }
    } else {
      const uint32_t ww[8] = {raw[i][0].x, raw[i][0].y, raw[i][0].z, raw[i][0].w,
                              raw[i][1].x, raw[i][1].y, raw[i][1].z, raw[i][1].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(ww[e]);
    }
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    for (int o = T / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sx = __fdiv_rn(amax, 127.0f);
    const float inv = amax > 0.f ? __fdiv_rn(127.0f, amax) : 0.f;
    int c[8], sum = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      c[e] = __float2int_rn(__fmul_rn(v[e], inv));
      sum += c[e];
    }
    for (int o = T / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (it < items) {
      *reinterpret_cast<uint2*>(xq + m * KC + e8 * 8) =
          make_uint2(pack_s8(c[0], c[1], c[2], c[3]), pack_s8(c[4], c[5], c[6], c[7]));
      if (e8 % T == 0)
        sxs[m * (KC / 8) + (e8 * 8) / a.gs] = make_float2(sx, __fmul_rn((float)sum, sx));
    }
  }
}

template <int FAM, int BN, int MR>
__global__ void __launch_bounds__(PNT, MR > 8 ? 1 : 2) qmv_planar_kernel(PArgs a) {
  using G = PGeo<MR>;
  constexpr int QW = BN / 4;               // column quads: lanes along a row
  constexpr int KS = PNT / QW;             // k slices of a block
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem + G::XQ);
  float2* sxs = reinterpret_cast<float2*>(smem + G::SXS);
  float* part = reinterpret_cast<float*>(smem + G::PART);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x;         // the K split
  const int n0 = blockIdx.y * BN, ncol = min(BN, a.N - n0);
  const int n_units = a.K / a.unit;
  const int kb0 = min(rank * a.per, n_units) * a.unit;
  const int kb1 = min((rank + 1) * a.per, n_units) * a.unit;
  const int cq = tid % QW, ks = tid / QW;  // this thread's column quad and k slice
  const int n = n0 + 4 * cq;
  const bool live = 4 * cq < ncol;
  const long N = a.N;
  const int gsb = a.gs < 32 ? a.gs : 32;   // elements of a group piece in a k block
  const int np = 32 / gsb;                 // group pieces a k block
  const bool has_adds = FAM == 5 || a.adds != nullptr;
  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int c0 = kb0; c0 < kb1; c0 += KC) {
    const int cn = min(KC, kb1 - c0);
    __syncthreads();   // the last chunk's codes are read
    quantize_planar<MR>(a, xq, sxs, c0, cn, tid);
    __syncthreads();
    if (!live) continue;
    for (int j = ks; j < cn / 32; j += KS) {
      const int kl = 32 * j, k = c0 + kl;
      // every code row of the k block first (32 int8 rows, or 16 nibble
      // rows and Q5_K's 4 hi rows), then the scales: all in flight at once
      uint32_t w[32];
      if constexpr (FAM == 3) {
        const uint8_t* p = a.codes + (long)k * N + n;
#pragma unroll
        for (int r = 0; r < 32; ++r) w[r] = __ldg(reinterpret_cast<const uint32_t*>(p + r * N));
      } else {
        const uint8_t* p = a.codes + (long)(k / 2) * N + n;
#pragma unroll
        for (int r = 0; r < 16; ++r) w[r] = __ldg(reinterpret_cast<const uint32_t*>(p + r * N));
        if constexpr (FAM == 5) {
          const uint8_t* h = a.hi + (long)(k / 8) * N + n;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            w[16 + r] = __ldg(reinterpret_cast<const uint32_t*>(h + r * N));
        }
      }
      // the group pieces of the k block (4 of gs 8, 2 of gs 16, else 1):
      // their scales and corrections, the correction only at a group's
      // first k block
      float s[4][4], cr[4][4];
      bool corr[4];
#pragma unroll
      for (int pc = 0; pc < 4; ++pc) {
        corr[pc] = false;
#pragma unroll
        for (int c = 0; c < 4; ++c) s[pc][c] = cr[pc][c] = 0.f;
        if (pc >= np) continue;
        const int g = (k + pc * gsb) / a.gs;
        corr[pc] = (has_adds || a.offset) && (k + pc * gsb) % a.gs == 0;
        if constexpr (FAM == 5) {
          const float4 dv = __ldg(reinterpret_cast<const float4*>(a.d + (k / 256) * N + n));
          const float4 mv = __ldg(reinterpret_cast<const float4*>(a.dmin + (k / 256) * N + n));
          const uint32_t scw = __ldg(reinterpret_cast<const uint32_t*>(a.sc + g * N + n));
          const uint32_t mnw = __ldg(reinterpret_cast<const uint32_t*>(a.mn + g * N + n));
          const float dd[4] = {dv.x, dv.y, dv.z, dv.w}, dm[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[pc][c] = __fmul_rn(dd[c], (float)((scw >> (8 * c)) & 255u));
            cr[pc][c] = -__fmul_rn(dm[c], (float)((mnw >> (8 * c)) & 255u));
          }
        } else {
          const float4 sv = __ldg(reinterpret_cast<const float4*>(a.scales + g * N + n));
          s[pc][0] = sv.x; s[pc][1] = sv.y; s[pc][2] = sv.z; s[pc][3] = sv.w;
          if (a.adds != nullptr) {
            const float4 av = __ldg(reinterpret_cast<const float4*>(a.adds + g * N + n));
            cr[pc][0] = av.x; cr[pc][1] = av.y; cr[pc][2] = av.z; cr[pc][3] = av.w;
          }
          if (a.offset) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              cr[pc][c] = __fadd_rn(cr[pc][c], -(float)a.offset * s[pc][c]);
          }
        }
      }
      // this thread's 4 columns' codes: word q of column c holds elements
      // 4q .. 4q + 3 of the k block
      uint32_t col[4][8];
      if constexpr (FAM == 3) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          uint32_t t[4];
          transpose4(w + 4 * q, t);
#pragma unroll
          for (int c = 0; c < 4; ++c) col[c][q] = t[c];
        }
      } else {
        // byte row e < 16 of the group holds element e (low nibble) and
        // 16 + e (high nibble)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t t[4];
          transpose4(w + 4 * q, t);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            col[c][q] = t[c] & M4;
            col[c][4 + q] = (t[c] >> 4) & M4;
          }
        }
        if constexpr (FAM == 5) {
          uint32_t t[4];
          transpose4(w + 16, t);
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int q = 0; q < 8; ++q) col[c][q] |= ((t[c] >> q) & 0x01010101u) << 4;
        }
      }
      const int gl0 = kl / a.gs;   // x's group of the first piece, in the chunk
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int* xr = reinterpret_cast<const int*>(xq + m * KC + kl);
        // the exact dot of each 8-element piece, then of each group piece
        int d8[4][4];
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          const int x0 = xr[2 * pr], x1 = xr[2 * pr + 1];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            d8[pr][c] = __dp4a((int)col[c][2 * pr + 1], x1, __dp4a((int)col[c][2 * pr], x0, 0));
        }
#pragma unroll
        for (int pc = 0; pc < 4; ++pc) {
          if (pc >= np) break;
          const float2 v = sxs[m * (KC / 8) + gl0 + pc];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int dot = gsb == 8 ? d8[pc][c]
                            : gsb == 16 ? d8[(2 * pc) & 3][c] + d8[(2 * pc + 1) & 3][c]
                                        : d8[0][c] + d8[1][c] + d8[2][c] + d8[3][c];
            acc[m][c] = fmaf((float)dot, v.x * s[pc][c], acc[m][c]);
            if (corr[pc]) acc[m][c] = fmaf(v.y, cr[pc][c], acc[m][c]);
          }
        }
      }
    }
  }

  // the k slices' sums: within a warp by shuffles (a fixed tree), each
  // warp's into its slot of red, then the warps' added in warp order
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      for (int o = 16; o >= QW; o >>= 1) acc[m][c] += __shfl_down_sync(0xffffffffu, acc[m][c], o);
  float* red = reinterpret_cast<float*>(smem + G::RED);
  if (lane < QW) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
      *reinterpret_cast<float4*>(red + (warp * MR + m) * BN + 4 * cq) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  for (int e = tid; e < MR * BN / 4; e += PNT) {
    float4 v = reinterpret_cast<const float4*>(red)[e];
    for (int w = 1; w < PNT / 32; ++w) {
      const float4 u = reinterpret_cast<const float4*>(red)[w * MR * BN / 4 + e];
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    reinterpret_cast<float4*>(part)[e] = v;
  }
  __syncthreads();
  // the block's sums: this split's partials, or the output
  const int c4n = ncol / 4;
  for (int e = tid; e < a.M * c4n; e += PNT) {
    const int m = e / c4n, c4 = e - m * c4n;
    const float4 v = reinterpret_cast<const float4*>(part)[m * BN / 4 + c4];
    const long o = (long)m * a.N + n0 + 4 * c4;
    if (a.part != nullptr)
      *reinterpret_cast<float4*>(a.part + (long)rank * a.M * a.N + o) = v;
    else if (a.out_bf16)
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(a.out) + o) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    else
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(a.out) + o) = v;
  }
}

// the splits' partials (splits, M, N) added in split order; 4 outputs a thread
__global__ void qmv_planar_reduce(const float* part, int splits, long MN, void* out,
                                  int out_bf16) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= MN) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = *reinterpret_cast<const float4*>(part + (long)sp * MN + i);
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  if (out_bf16)
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + i) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  else
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + i) = acc;
}


template <int FAM, int BN, int MR>
cudaError_t launch_planar(const PArgs& a, int splits, cudaStream_t st) {
  constexpr int smem = PGeo<MR>::SMEM;
  static bool attr_set = false;   // set once, never under graph capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmv_planar_kernel<FAM, BN, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(splits, (a.N + BN - 1) / BN);
  qmv_planar_kernel<FAM, BN, MR><<<grid, PNT, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long MN = (long)a.M * a.N;
  qmv_planar_reduce<<<(unsigned)((MN / 4 + 255) / 256), 256, 0, st>>>(a.part, splits, MN,
                                                                      a.out, a.out_bf16);
  return cudaGetLastError();
}

template <int FAM, int BN>
cudaError_t launch_planar_rows(const PArgs& a, int splits, cudaStream_t st) {
  if (a.M == 1) return launch_planar<FAM, BN, 1>(a, splits, st);
  return a.M <= 8 ? launch_planar<FAM, BN, 8>(a, splits, st)
                  : launch_planar<FAM, BN, 16>(a, splits, st);
}

template <int FAM>
cudaError_t launch_planar_bn(const PArgs& a, int bn, int splits, cudaStream_t st) {
  if (bn == 64) return launch_planar_rows<FAM, 64>(a, splits, st);
  return launch_planar_rows<FAM, 32>(a, splits, st);
}

}  // namespace

// fmt: 0 Q8_0, 1 Q4_K, 2 Q6_K; x (M <= 16, K) f32 or bf16, 16-byte aligned;
// out (M, N) f32 or bf16. The plan (qmv_plan): column tile bn (128, 64 or
// 32), a cluster of cl <= 8 blocks along K, per K units (superblocks; Q8_0
// groups) a rank, every rank holding at least one. One launch; returns its
// cudaError_t.
extern "C" int slt_qmv(int fmt, int M, int K, int N, const void* x, int x_bf16,
                       const void* codes, const void* hi, const void* scales, const void* sc,
                       const void* mn, const void* d, const void* dmin, int bn, int cl, int per,
                       void* out, int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int unit = fmt == 0 ? 32 : 256, n_units = K / unit;
  if (fmt < 0 || fmt > 2 || M < 1 || M > MAXR || N < 4 || N % 4 || K % unit || K < unit ||
      (bn != 128 && bn != 64 && bn != 32) || cl < 1 || cl > 8 || per < 1 ||
      (long)cl * per < n_units || (long)(cl - 1) * per >= n_units || !aligned16(x) ||
      (N + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  const void* planes[] = {codes, hi, scales, sc, mn, d, dmin};
  bool wide = N % 16 == 0;
  for (const void* p : planes) wide = wide && (p == nullptr || aligned16(p));
  Args a{M, K, N, per, x, x_bf16, (const uint8_t*)codes, (const uint8_t*)hi,
         (const float*)scales, (const uint8_t*)sc, (const uint8_t*)mn, (const float*)d,
         (const float*)dmin, out, out_bf16, wide ? 1 : 0};
  cudaError_t e;
  if (fmt == 0) e = launch_bn<0>(a, bn, cl, st);
  else if (fmt == 1) e = launch_bn<1>(a, bn, cl, st);
  else e = launch_bn<2>(a, bn, cl, st);
  return (int)e;
}

// Blocks of the kernel for fmt, column tile bn and up to `rows` rows that the
// card holds at once in clusters of cl (cudaOccupancyMaxActiveClusters x cl;
// qmv_plan's table assumes the H100's), or a negative cudaError_t.
extern "C" int slt_qmv_resident(int fmt, int bn, int rows, int cl) {
  if (fmt < 0 || fmt > 2 || (bn != 128 && bn != 64 && bn != 32) || rows < 1 || rows > MAXR ||
      cl < 1 || cl > 8)
    return -(int)cudaErrorInvalidValue;
  const int nb = rows <= 8 ? 1 : 2;
  if (fmt == 0) return resident_bn<0>(bn, nb, cl);
  if (fmt == 1) return resident_bn<1>(bn, nb, cl);
  return resident_bn<2>(bn, nb, cl);
}

// The planar and Q5_K formats (fmt 3 int8 planar, 4 nibble planar, 5 Q5_K
// compact): x (M <= 16, K) f32 or bf16, 16-byte aligned; gs 8, 16, 32 or
// 256 (fmt 4, 5: 32); offset subtracted from the codes; adds f32 (K/gs, N)
// or null; unit 32 or 256 (gs 256 and fmt 5) K elements, per of them a
// split of `splits` <= 8 along K, bn 64 or 32 columns a block
// (qmv_planar_plan); part holds splits * M * N f32 when splits > 1. The
// kernel's launch, and the reduce's when splits > 1; returns the
// cudaError_t.
extern "C" int slt_qmv_planar(int fmt, int M, int K, int N, const void* x, int x_bf16,
                              const void* codes, const void* hi, const void* scales,
                              const void* adds, const void* sc, const void* mn, const void* d,
                              const void* dmin, int gs, int offset, int unit, int bn,
                              int splits, int per, void* part, void* out, int out_bf16,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool gs_ok = fmt == 3 ? (gs == 8 || gs == 16 || gs == 32 || gs == 256) : gs == 32;
  const bool unit_ok = unit == ((gs == 256 || fmt == 5) ? 256 : 32);
  if (fmt < 3 || fmt > 5 || !gs_ok || !unit_ok || M < 1 || M > MAXR || N < 4 || N % 4 ||
      K % unit || K < unit || (bn != 64 && bn != 32) || splits < 1 ||
      splits > 8 || per < 1 || (long)splits * per < K / unit ||
      (long)(splits - 1) * per >= K / unit || (splits > 1 && part == nullptr) ||
      !aligned16(x) || (N + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  PArgs a{M, K, N, per, unit, gs, offset, x, x_bf16, (const uint8_t*)codes, (const uint8_t*)hi,
          (const float*)scales, (const float*)adds, (const uint8_t*)sc, (const uint8_t*)mn,
          (const float*)d, (const float*)dmin, splits > 1 ? (float*)part : nullptr, out,
          out_bf16};
  cudaError_t e;
  if (fmt == 3) e = launch_planar_bn<3>(a, bn, splits, st);
  else if (fmt == 4) e = launch_planar_bn<4>(a, bn, splits, st);
  else e = launch_planar_bn<5>(a, bn, splits, st);
  return (int)e;
}
