// qmm: fused dequant + matmul over repacked quantized weights (17-32 rows,
// or any M when forced).
//
// Replaces the TPU kernel _qmm_kernel (superllama_tpu/ops/qmatmul.py:94,
// launched by _qmatmul_2d). Codes stay packed in device memory and each
// weight element is dequantized as the plain version does,
//   w = bf16(fadd_rn(fmul_rn(code - offset, s), a))
// with s = d * sc (Q4_K, Q6_K) or the f32 scale plane (Q8_0) and a =
// -(dmin * mn) (Q4_K only), then multiplied with f32 accumulation. The
// products of bf16 operands are exact in f32, so only the order of the f32
// sums differs from qmm_plain.
//
// Which dtype takes which path:
//  - bf16 x (the main path: every matmul of a lone <= 32-token prompt chunk)
//    with N a multiple of 16: qmm_tc_kernel, the tensor-core kernel below;
//  - f32 x (no TF32: the plain version's f32 products are exact), or N not
//    a multiple of 16: qmm_kernel, the CUDA-core kernel of the first port
//    (f32 FMA on operands rounded to the compute type).
//
// What bounds it on the H100, and what qmm_tc_kernel does about it. At M 32
// the product is 64 flops per weight element against 0.56 bytes (Q4_K):
// under the tensor cores' balance point, so bytes (0.0108 ms at K 4096,
// N 14336) and the integer unpack, about five ALU operations per element
// (also ~0.01 ms there), set the pace; the CUDA cores' f32 rate would not
// (56 us). So:
//  - mma.sync m16n8k16 bf16 -> f32. A block covers 32 rows (two m16
//    fragments; one when M <= 16) by 128 columns, so at M <= 32 every weight
//    element is dequantized exactly once on the card. 8 consumer warps: 4
//    column warps of 32 columns x 2 k warps, each taking two of a k-tile's
//    four 32-groups; the two k warps' sums are added in a fixed order at
//    the end.
//  - Dequantized straight into the B fragments' registers, never into
//    shared memory: a lane owns 4 adjacent columns (one per n8 fragment; the
//    output columns follow that permutation) and rows 2t, 2t+1, 2t+8, 2t+9
//    of a group's 16 packed-code rows, so one 32-bit shared load gives 4
//    columns of a k pair and the low nibbles are k-step 0 of the group, the
//    high nibbles k-step 1, in the natural k order (x's A fragments come by
//    plain ldmatrix). Nibbles by mask, code to float by __byte_perm into the
//    exponent of 2^23 and one exact subtraction (no I2F), cvt.rn.bf16x2 to
//    pack; for Q4_K the code's product with s is one exact fma (deq). Each
//    group's d/dmin/sc/mn (Q4_K), d/sc/hi (Q6_K) or scales
//    (Q8_0) are read once per column and lane, not per element.
//  - The packed planes and x stream through a ring of NST stages of one
//    k-tile (128 deep): a producer warp fills a stage with 16-byte cp.async
//    copies, completed on the stage's `full` mbarrier through
//    cp.async.mbarrier.arrive, once every consumer warp has arrived on its
//    `empty` mbarrier. No block-wide barrier sits in the loop; up to NST
//    tiles are in flight. Each lane keeps one 16-byte column of each plane
//    and steps down its rows by pointer increments: the producer's
//    instructions a tile set the pace at first (K 4096, N 14336 on an H100
//    80GB HBM3 at 700 W: one cp.async.bulk per plane row, 106 copies of
//    128-256 bytes a tile, read 0.112 ms; cp.async with divisions in the
//    address math 0.086 ms; without them 0.037 ms).
//  - Enough blocks at every shape: where N alone gives too few, the K range
//    is split (qmm_plan in ops/qmatmul.py, a function of (K, N) only, so a
//    row's sums never depend on M: one block a SM where a block then holds
//    at most 16 k-tiles, else two an SM); the splits' f32 partials are
//    added in split order by one qmm_reduce launch. No float atomics: two
//    runs give the same bits.
// Edges: rows >= M and columns >= N hold stale shared memory, which reaches
// only their own (unstored) outputs; a k-tile past K (a format of 32-element
// blocks) is cut to whole 32-groups and the warps skip the groups beyond it.
//
// Weight layouts (FMT), the nine of ops/qmatmul.py::qmv_fmt that qmv.cu reads
// too, every type of ops/qtensor.py's repack:
//   0 int8 codes (K, N), f32 scales per 32: Q8_0, and on the same path Q5_0,
//     MXFP4, IQ4_NL, IQ4_XS, IQ2_XXS, IQ3_XXS, IQ3_S (no adds, offset 0:
//     their element is Q8_0's);
//   1 Q4_K compact (nibbles, u8 sc/mn, f32 d/dmin per 256);
//   2 Q6_K compact (nibbles + 2-bit hi plane, i8 sc per 16, f32 d);
//   3 int8, gs 32, an f32 adds plane: Q5_1, IQ1_S;
//   4 int8, gs 16, adds where present: Q3_K, IQ2_XS, IQ2_S, Q2_K (adds);
//   5 int8, gs 8, adds: IQ1_M;
//   6 int8, gs 256: Q8_K, TQ1_0, TQ2_0;
//   7 nibbles (K/2, N) in Q4_K's group-local layout, f32 scales per 32,
//     offset 8 (Q4_0) or adds (Q4_1);
//   8 Q5_K compact: Q4_K's planes and a 1-bit hi plane.
// Group size is a compile-time parameter of each layout, and so are the f32
// adds (layouts 4 and 7 are instantiated with and without them): each lane
// reads one float4 of scales (and one of adds) for its 4 columns a piece of
// 8 code rows a group covers, with no division and no per-element branch
// (one a 32-group at gs >= 32, two at gs 16, four at gs 8). A stage holds
// only the scale and add rows its layout reads, and each instantiation's
// ring has as many stages as fit in 113 KB, two blocks an SM (Stage, mirrored
// by ops/qmatmul.py::_qmm_smem): 3 for the int8 layouts at gs 32 and 16, 4
// at gs 256, 5 for the nibbles, 2 at gs 8. The element of layouts 3-7 is
// bf16(fadd_rn(fmul_rn(code - offset, s), a)), as the plain version's.
// The CUDA-core kernel reads the same layout ids through its own int8,
// nibble and compact paths.
// Measured at gate/up (K 4096, N 14336, M 32) on an H100 80GB HBM3 at 700 W
// (chip_smoke.py --format-times on copies of this kernel): the int8
// layouts' time is set by their copies (IQ4_XS 0.038 ms; without the
// consumers' work 0.034, the weight planes alone 0.033 against a 0.020
// bound; IQ1_M 0.054, 0.050, 0.050 against 0.035), the nibble layouts' by
// the consumers (Q4_0 0.034; the copies alone 0.025). TMA boxes of the code
// plane (128-byte swizzle), and of the code and f32 planes, read 5-10 %
// slower than this cp.async ring; a 64-deep k-tile for IQ1_M (5 stages)
// 3 % slower than 2 stages of 128; L2 prefetch hints no faster.

#include "ptx.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 32, BN = 64, BK = 32, TPB = 256;

struct Args {
  const void* x; int x_bf16;
  int M, K, N;
  const uint8_t* codes; const uint8_t* hi; const float* scales;
  const uint8_t* sc; const uint8_t* mn; const float* d; const float* dmin;
  void* out; int out_bf16;
  const float* adds; int gs, offset;   // the planar families (FMT 3, 4)
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int FMT>
__device__ __forceinline__ float dequant(const Args& a, int k, int n) {
  const long N = a.N;
  float q, s, add = 0.f, off = 0.f;
  bool has_add = false;
  if (FMT == 0 || FMT == 3) {
    q = (float)(int8_t)a.codes[(long)k * N + n];
    s = a.scales[(long)(k / (FMT == 0 ? 32 : a.gs)) * N + n];
  } else {
    const int e = k % 32, row = (k / 32) * 16 + (e % 16);
    const uint8_t byte = a.codes[(long)row * N + n];
    int code = e < 16 ? (byte & 0x0F) : (byte >> 4);
    if (FMT == 5) code |= ((a.hi[(long)((k / 32) * 4 + e % 4) * N + n] >> (e / 4)) & 1) << 4;
    if (FMT == 4) {
      s = a.scales[(long)(k / 32) * N + n];
    } else if (FMT == 1 || FMT == 5) {
      const int g = k / 32;
      s = a.d[(long)(k / 256) * N + n] * (float)a.sc[(long)g * N + n];
      add = -(a.dmin[(long)(k / 256) * N + n] * (float)a.mn[(long)g * N + n]);
      has_add = true;
    } else {
      const uint8_t h = a.hi[(long)((k / 32) * 8 + e % 8) * N + n];
      code |= ((h >> (2 * (e / 8))) & 3) << 4;
      s = a.d[(long)(k / 256) * N + n] * (float)(int8_t)a.sc[(long)(k / 16) * N + n];
      off = 32.f;
    }
    q = (float)code;
  }
  if (FMT == 3 || FMT == 4) {
    off = (float)a.offset;
    if (a.adds != nullptr) {
      add = a.adds[(long)(k / a.gs) * N + n];
      has_add = true;
    }
  }
  float w = __fmul_rn(__fsub_rn(q, off), s);
  if (has_add) w = __fadd_rn(w, add);
  return w;
}

template <int FMT>
__global__ void __launch_bounds__(TPB) qmm_kernel(Args a) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tr = (tid / 16) * 2, tc = (tid % 16) * 4;     // 2 rows x 4 cols out
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < a.K; k0 += BK) {
    // x tile: BM x BK, 4 elements a thread
    for (int i = tid; i < BM * BK; i += TPB) {
      const int r = i / BK, c = i % BK, m = m0 + r;
      float v = 0.f;
      if (m < a.M) {
        const long idx = (long)m * a.K + k0 + c;
        v = a.x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.x)[idx])
                     : reinterpret_cast<const float*>(a.x)[idx];
      }
      xs[r][c] = v;
    }
    // weight tile: BK x BN, column-coalesced, 8 elements a thread
    {
      const int cc = tid % BN, kb = (tid / BN) * 8, n = n0 + cc;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float w = 0.f;
        if (n < a.N) {
          w = dequant<FMT>(a, k0 + kb + i, n);
          if (a.x_bf16) w = bf16_round(w);
        }
        ws[kb + i][cc] = w;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float x0 = xs[tr][k], x1 = xs[tr + 1][k];
      const float4 w = *reinterpret_cast<const float4*>(&ws[k][tc]);
      acc[0][0] = fmaf(x0, w.x, acc[0][0]); acc[0][1] = fmaf(x0, w.y, acc[0][1]);
      acc[0][2] = fmaf(x0, w.z, acc[0][2]); acc[0][3] = fmaf(x0, w.w, acc[0][3]);
      acc[1][0] = fmaf(x1, w.x, acc[1][0]); acc[1][1] = fmaf(x1, w.y, acc[1][1]);
      acc[1][2] = fmaf(x1, w.z, acc[1][2]); acc[1][3] = fmaf(x1, w.w, acc[1][3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + tr + r;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc + j;
      if (n >= a.N) continue;
      const long o = (long)m * a.N + n;
      if (a.out_bf16) reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(acc[r][j]);
      else reinterpret_cast<float*>(a.out)[o] = acc[r][j];
    }
  }
}

}  // namespace

// ------------------------------------------------- the tensor-core kernel

namespace tc {

using namespace ptx;

constexpr int BM = 32, BN = 128, BK = 128;   // block tile, k-tile
constexpr int NCW = 8;                       // consumer warps: 4 column x 2 k
constexpr int NT = (NCW + 1) * 32;           // and the producer warp
constexpr int XROW = BK * 2 + 16;            // bytes of an x row in shared memory
constexpr int CROW = BN + 16;                // bytes of a code-plane row
constexpr int BLOCK_SMEM = 113 * 1024;       // a block's share of an SM at two blocks an SM
constexpr int NLAYOUT = 9;

struct Args {
  int M, K, N, per;                          // per: k-tiles a split
  const __nv_bfloat16* x;
  const uint8_t* codes; const uint8_t* hi; const float* scales;
  const uint8_t* sc; const uint8_t* mn; const float* d; const float* dmin;
  float* part; void* out; int out_bf16;
  const float* adds; int offset;             // the f32 adds plane (ADDS), the codes' offset
};

// One ring stage of layout L (ops/qmatmul.py::qmv_fmt, csrc/qmv.cu's
// numbering): the tile's x rows, code rows, and only the scale, add, hi and
// sub-scale rows the layout reads (byte offsets, multiples of 16). NST: as
// many stages as fit in a block's share at two blocks an SM (Q4_K keeps 4:
// five read no faster on the H100). ops/qmatmul.py::_qmm_smem mirrors SMEM
// and NST: change them together.
template <int L, bool ADDS>
struct Stage {
  static constexpr bool COMPACT = L == 1 || L == 2 || L == 8;   // sub-scales x d a superblock
  static constexpr bool KQ = L == 1 || L == 8;                  // Q4_K's planes
  static constexpr bool PLANAR = L >= 3 && L <= 7;              // f32 scale plane, offset
  static constexpr bool I8 = L == 0 || (PLANAR && L != 7);      // int8 code rows
  static constexpr int GS = L == 2 || L == 4 ? 16 : L == 5 ? 8 : L == 6 ? 256 : 32;
  static constexpr int NP = GS >= 32 ? 1 : 32 / GS;             // scale pieces a 32-group
  static constexpr int CODE_ROWS = I8 ? BK : BK / 2;
  static constexpr int HI_ROWS = L == 2 ? BK / 4 : L == 8 ? BK / 8 : 0;
  static constexpr int SC_ROWS = KQ ? BK / 32 : L == 2 ? BK / 16 : 0;
  static constexpr int MN_ROWS = KQ ? BK / 32 : 0;
  static constexpr int SCL_ROWS = COMPACT ? 0 : GS == 256 ? 1 : BK / GS;
  static constexpr int ADD_ROWS = ADDS ? SCL_ROWS : 0;
  static constexpr int X = 0;
  static constexpr int CODES = X + BM * XROW;
  static constexpr int HI = CODES + CODE_ROWS * CROW;
  static constexpr int SC = HI + HI_ROWS * CROW;
  static constexpr int MN = SC + SC_ROWS * BN;
  static constexpr int D = MN + MN_ROWS * BN;
  static constexpr int DMIN = D + (COMPACT ? BN * 4 : 0);
  static constexpr int SCL = DMIN + (KQ ? BN * 4 : 0);
  static constexpr int ADD = SCL + SCL_ROWS * BN * 4;
  static constexpr int BYTES = ADD + ADD_ROWS * BN * 4;
  static constexpr int NST = L == 1 ? 4 : BLOCK_SMEM / (BYTES + 16);
  static constexpr int SMEM = NST * BYTES + 2 * NST * 8;
  static_assert(NST >= 2 && SMEM <= BLOCK_SMEM, "a ring of two stages, two blocks an SM");
};

// code byte j of nib (values < 256), dequantized: f = 2^23 + byte is
// exact in f32. Q8_0 / Q6_K: one exact subtraction gives byte - bias, then
// fmul_rn by s. Q4_K / Q5_K (no bias): fma_rn(f, s, c) with c = -2^23 s
// (exact: a power-of-two multiple) rounds f s + c = byte s once, so it is
// fmul_rn(byte, s) in one instruction; then fadd_rn of a.
template <int L>
__device__ __forceinline__ float deq(uint32_t nib, int j, float s, float c, float a) {
  constexpr float BIAS = L == 0 ? 8388608.f + 128.f : 8388608.f + 32.f;
  const float f = __uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7440u + j));
  if constexpr (L == 1 || L == 8) return __fadd_rn(__fmaf_rn(f, s, c), a);
  return __fmul_rn(f - BIAS, s);
}

// the planar layouts: bias = 2^23 + the byte's bias (128 for int8 codes)
// + offset, exact; then fmul_rn by s and, with adds, fadd_rn of a
template <bool ADDS>
__device__ __forceinline__ float deq_planar(uint32_t nib, int j, float bias, float s, float a) {
  const float f = __uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7440u + j));
  const float w = __fmul_rn(f - bias, s);
  if constexpr (ADDS) return __fadd_rn(w, a);
  return w;
}

template <int L, bool ADDS>
__global__ void __launch_bounds__(NT, 2) qmm_tc_kernel(Args a) {
  using S = Stage<L, ADDS>;
  constexpr int NST = S::NST;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NST * S::BYTES);
  uint64_t* empty = full + NST;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int n_tiles = (a.K + BK - 1) / BK;
  const int t0 = split * a.per, nt = min(t0 + a.per, n_tiles) - t0;
  const int ncol = min(BN, a.N - n0), mrows = min(BM, a.M - m0);
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) { mbar_init(&full[i], 32); mbar_init(&empty[i], NCW); }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCW) {
    // producer: the tile's rows of each plane in 16-byte cp.async chunks.
    // Each lane keeps one chunk column of each plane and steps down its
    // rows, so the loop is pointer increments (no divisions): byte planes
    // 8 chunks a row, lane & 7, rows lane >> 3 + 4i; f32 planes 32 chunks a
    // row, one a lane; x 16 chunks a row, lane & 15, rows lane >> 4 + 2i.
    const long N = a.N;
    const int cpr = ncol / 16;   // chunks of a byte-plane row in this column tile
    const int q8 = lane & 7, r8 = lane >> 3, q16 = lane & 15, r16 = lane >> 4;
    const bool c8 = q8 < cpr, c32 = lane < 4 * cpr;
    for (int i = 0; i < nt; ++i) {
      const int st = i % NST;
      if (i >= NST) mbar_wait(&empty[st], (i / NST - 1) & 1);
      const int k0 = (t0 + i) * BK, kv = min(BK, a.K - k0);   // kv: whole 32-groups
      unsigned char* s = smem + st * S::BYTES;
      if (q16 < kv / 8)
        for (int r = r16; r < mrows; r += 2)
          cp_async16(s + S::X + r * XROW + q16 * 16, a.x + (long)(m0 + r) * a.K + k0 + q16 * 8);
      // n rows of a byte plane from row0, into shared rows of `stride` bytes
      auto rows8 = [&](int off, int stride, const uint8_t* plane, long row0, int n) {
        if (!c8) return;
        const uint8_t* src = plane + (row0 + r8) * N + n0 + q8 * 16;
        unsigned char* dst = s + off + r8 * stride + q8 * 16;
        for (int r = r8; r < n; r += 4, src += 4 * N, dst += 4 * stride) cp_async16(dst, src);
      };
      // n rows of an f32 plane from row0
      auto rows32 = [&](int off, const float* plane, long row0, int n) {
        if (!c32) return;
        for (int r = 0; r < n; ++r)
          cp_async16(s + off + r * BN * 4 + lane * 16, plane + (row0 + r) * N + n0 + lane * 4);
      };
      if constexpr (L == 0) {
        rows8(S::CODES, CROW, a.codes, k0, kv);
        rows32(S::SCL, a.scales, k0 / 32, kv / 32);
      } else if constexpr (S::PLANAR) {
        // the tile's scale (and add) rows: kv / gs of them, one at gs 256
        const int nr = S::GS == 256 ? 1 : kv / S::GS;
        rows8(S::CODES, CROW, a.codes, S::I8 ? k0 : k0 / 2, S::I8 ? kv : kv / 2);
        rows32(S::SCL, a.scales, k0 / S::GS, nr);
        if constexpr (ADDS) rows32(S::ADD, a.adds, k0 / S::GS, nr);
      } else {
        rows8(S::CODES, CROW, a.codes, k0 / 2, kv / 2);
        rows32(S::D, a.d, k0 / 256, 1);
        if constexpr (L == 8) rows8(S::HI, CROW, a.hi, k0 / 8, kv / 8);
        if constexpr (S::KQ) {
          rows8(S::SC, BN, a.sc, k0 / 32, kv / 32);
          rows8(S::MN, BN, a.mn, k0 / 32, kv / 32);
          rows32(S::DMIN, a.dmin, k0 / 256, 1);
        } else {
          rows8(S::HI, CROW, a.hi, k0 / 4, kv / 4);
          rows8(S::SC, BN, a.sc, k0 / 16, kv / 16);
        }
      }
      cp_async_arrive_noinc(&full[st]);
    }
    return;
  }

  // consumers: lane (g, t) of column warp wn owns tile columns cb .. cb + 3,
  // one in each n8 fragment j (fragment slot g <-> column cb + j)
  const int wn = warp & 3, kw = warp >> 2, g = lane >> 2, t = lane & 3;
  const int cb = wn * 32 + 4 * g;
  const float bias = 8388608.f + (S::I8 ? 128.f : 0.f) + (float)a.offset;   // PLANAR
  const bool two = mrows > 16;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int st = i % NST;
    mbar_wait(&full[st], (i / NST) & 1);
    __syncwarp();
    const unsigned char* s = smem + st * S::BYTES;
    const int ng = min(BK, a.K - (t0 + i) * BK) / 32;   // groups in this tile
#pragma unroll
    for (int gq = 0; gq < 2; ++gq) {
      const int gi = kw * 2 + gq;
      if (gi >= ng) break;   // a tile past K (32-element formats)
      // this lane's code words: rows 2t, 2t+1, 2t+8, 2t+9 of the group's 16
      // packed rows (int8: of each 16-row half, k-step h at rows 16h + ..)
      const int crow = (S::I8 ? gi * 32 : gi * 16) + 2 * t;
      const unsigned char* cw = s + S::CODES + crow * CROW + cb;
      uint32_t w[2][4];
#pragma unroll
      for (int h = 0; h < (S::I8 ? 2 : 1); ++h) {
        const unsigned char* c = cw + h * 16 * CROW;
        w[h][0] = *reinterpret_cast<const uint32_t*>(c);
        w[h][1] = *reinterpret_cast<const uint32_t*>(c + CROW);
        w[h][2] = *reinterpret_cast<const uint32_t*>(c + 8 * CROW);
        w[h][3] = *reinterpret_cast<const uint32_t*>(c + 9 * CROW);
      }
      // per-column scales of the group (of each 16-half for Q6_K)
      float sc[2][4], cs[4] = {0.f, 0.f, 0.f, 0.f}, ad[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t hw[2] = {0u, 0u};
      // the planar layouts: scale (and add) of each of the group's NP
      // pieces for the lane's 4 columns, one float4 a piece (the one row of
      // the tile at gs 256)
      float ps[S::NP][4], pa[S::NP][4] = {};
      if constexpr (S::PLANAR) {
#pragma unroll
        for (int p = 0; p < S::NP; ++p) {
          const int row = S::GS == 256 ? 0 : gi * S::NP + p;
          const float4 v = *reinterpret_cast<const float4*>(s + S::SCL + row * BN * 4 + cb * 4);
          ps[p][0] = v.x; ps[p][1] = v.y; ps[p][2] = v.z; ps[p][3] = v.w;
          if constexpr (ADDS) {
            const float4 u = *reinterpret_cast<const float4*>(s + S::ADD + row * BN * 4 + cb * 4);
            pa[p][0] = u.x; pa[p][1] = u.y; pa[p][2] = u.z; pa[p][3] = u.w;
          }
        }
      } else if constexpr (L == 0) {
        const float4 v = *reinterpret_cast<const float4*>(s + S::SCL + gi * BN * 4 + cb * 4);
        sc[0][0] = sc[1][0] = v.x; sc[0][1] = sc[1][1] = v.y;
        sc[0][2] = sc[1][2] = v.z; sc[0][3] = sc[1][3] = v.w;
      } else {
        const float4 dv = *reinterpret_cast<const float4*>(s + S::D + cb * 4);
        const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
        if constexpr (S::KQ) {
          const float4 mv = *reinterpret_cast<const float4*>(s + S::DMIN + cb * 4);
          const float dm[4] = {mv.x, mv.y, mv.z, mv.w};
          const uint32_t scw = *reinterpret_cast<const uint32_t*>(s + S::SC + gi * BN + cb);
          const uint32_t mnw = *reinterpret_cast<const uint32_t*>(s + S::MN + gi * BN + cb);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[0][j] = sc[1][j] = __fmul_rn(dd[j], (float)((scw >> (8 * j)) & 255u));
            cs[j] = -8388608.f * sc[0][j];
            ad[j] = -__fmul_rn(dm[j], (float)((mnw >> (8 * j)) & 255u));
          }
          if constexpr (L == 8) {
            // element e's hi bit: hi row e % 4, bit e / 4; the lane's rows
            // 2t + (q & 1) (mod 4) of the group's 4
            const unsigned char* hp = s + S::HI + gi * 4 * CROW + cb;
            hw[0] = *reinterpret_cast<const uint32_t*>(hp + ((2 * t) & 3) * CROW);
            hw[1] = *reinterpret_cast<const uint32_t*>(hp + ((2 * t + 1) & 3) * CROW);
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t scw =
                *reinterpret_cast<const uint32_t*>(s + S::SC + (2 * gi + h) * BN + cb);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sc[h][j] = __fmul_rn(dd[j], (float)(int8_t)((scw >> (8 * j)) & 255u));
          }
          const unsigned char* hp = s + S::HI + (gi * 8 + 2 * t) * CROW + cb;
          hw[0] = *reinterpret_cast<const uint32_t*>(hp);
          hw[1] = *reinterpret_cast<const uint32_t*>(hp + CROW);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the code bytes of k-step h: rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1)
        uint32_t nib[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (S::I8) {
            nib[q] = w[h][q] ^ 0x80808080u;   // int8 -> biased byte
          } else {
            nib[q] = (h ? w[0][q] >> 4 : w[0][q]) & 0x0F0F0F0Fu;
            if constexpr (L == 2)   // element e's 2 high bits: hi row e % 8, field e / 8
              nib[q] |= ((hw[q & 1] >> (4 * h + 2 * (q >> 1))) & 0x03030303u) << 4;
            if constexpr (L == 8)   // row 2t + q (+ 8 for q > 1): bit 4h + 2 (q >> 1) + t / 2
              nib[q] |= ((hw[q & 1] >> (4 * h + 2 * (q >> 1) + (t >> 1))) & 0x01010101u) << 4;
          }
        }
        uint32_t bf[4][2];
        if constexpr (S::PLANAR) {
          // b0's rows lie in 8-row piece 2h of the group, b1's in 2h + 1
          const int p0 = S::NP == 1 ? 0 : S::NP == 2 ? h : 2 * h;
          const int p1 = S::NP == 4 ? 2 * h + 1 : p0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bf[j][0] = pack_bf16(deq_planar<ADDS>(nib[0], j, bias, ps[p0][j], pa[p0][j]),
                                 deq_planar<ADDS>(nib[1], j, bias, ps[p0][j], pa[p0][j]));
            bf[j][1] = pack_bf16(deq_planar<ADDS>(nib[2], j, bias, ps[p1][j], pa[p1][j]),
                                 deq_planar<ADDS>(nib[3], j, bias, ps[p1][j], pa[p1][j]));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bf[j][0] = pack_bf16(deq<L>(nib[0], j, sc[h][j], cs[j], ad[j]),
                                 deq<L>(nib[1], j, sc[h][j], cs[j], ad[j]));
            bf[j][1] = pack_bf16(deq<L>(nib[2], j, sc[h][j], cs[j], ad[j]),
                                 deq<L>(nib[3], j, sc[h][j], cs[j], ad[j]));
          }
        }
        const int kk = gi * 32 + h * 16 + (lane >> 4) * 8;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi == 1 && !two) break;
          uint32_t af[4];
          const unsigned char* xa = s + S::X + (mi * 16 + (lane & 15)) * XROW + kk * 2;
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(af[0]), "=r"(af[1]), "=r"(af[2]), "=r"(af[3])
                       : "r"(smem_addr(xa)));
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mi][j], af, bf[j][0], bf[j][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the two k warps' sums, added in order (the ring is free: every tile
  // issued has been consumed)
  asm volatile("bar.sync 1, %0;\n" ::"r"(NCW * 32) : "memory");
  float* red = reinterpret_cast<float*>(smem) + (wn * 32 + lane) * 32;
  if (kw == 1) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(mi * 4 + j) * 4 + e] = acc[mi][j][e];
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(NCW * 32) : "memory");
  if (kw == 1) return;
  // lane (g, t) holds, for rows g and g + 8 of each m16 fragment, the 8
  // adjacent columns 8t .. 8t + 7 of its warp's 32 (c0 of fragment j at
  // 8t + j, c1 at 8t + 4 + j)
  const int col = n0 + wn * 32 + 8 * t;
  if (col >= a.N) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + mi * 16 + g + 8 * hr;
      if (m >= a.M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mi][j][2 * hr] + red[(mi * 4 + j) * 4 + 2 * hr];
        v[4 + j] = acc[mi][j][2 * hr + 1] + red[(mi * 4 + j) * 4 + 2 * hr + 1];
      }
      const long o = (long)m * a.N + col;
      if (a.part != nullptr) {
        float4* p = reinterpret_cast<float4*>(a.part + (long)split * a.M * a.N + o);
        p[0] = make_float4(v[0], v[1], v[2], v[3]);
        p[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else if (a.out_bf16) {
        uint4 u = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                             pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(a.out) + o) = u;
      } else {
        float4* p = reinterpret_cast<float4*>(reinterpret_cast<float*>(a.out) + o);
        p[0] = make_float4(v[0], v[1], v[2], v[3]);
        p[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

// the splits' partials (n_split, M, N) added in split order; 4 outputs a thread
__global__ void qmm_reduce(const float* part, int n_split, long MN, void* out, int out_bf16) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= MN) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int sp = 1; sp < n_split; ++sp) {
    const float4 v = *reinterpret_cast<const float4*>(part + (long)sp * MN + i);
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  if (out_bf16) {
    uint2 u = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + i) = u;
  } else {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + i) = acc;
  }
}

template <int L, bool ADDS>
cudaError_t launch(const Args& a, int n_split, cudaStream_t st) {
  using S = Stage<L, ADDS>;
  static bool attr_set = false;   // set once, never under graph capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_tc_kernel<L, ADDS>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, n_split);
  qmm_tc_kernel<L, ADDS><<<grid, NT, S::SMEM, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  const long MN = (long)a.M * a.N;
  qmm_reduce<<<(unsigned)((MN / 4 + 255) / 256), 256, 0, st>>>(a.part, n_split, MN, a.out,
                                                               a.out_bf16);
  return cudaGetLastError();
}

// blocks of layout (L, ADDS) the card holds on one SM, and its shared bytes
template <int L, bool ADDS>
int resident(int* smem) {
  using S = Stage<L, ADDS>;
  *smem = S::SMEM;
  cudaError_t e = cudaFuncSetAttribute(qmm_tc_kernel<L, ADDS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, qmm_tc_kernel<L, ADDS>, NT, S::SMEM);
  return e == cudaSuccess ? n : -(int)e;
}

// f(integral_constant L, bool_constant ADDS) for a layout and whether its
// weight has an adds plane: the eleven instantiations (adds fixed by layouts
// 0-3, 5, 6 and 8, either way for 4 and 7)
template <class F>
auto with_layout(int fmt, bool adds, F&& f) {
  using std::integral_constant;
  using T = std::true_type;
  using Fa = std::false_type;
  switch (fmt) {
    case 0: return f(integral_constant<int, 0>{}, Fa{});
    case 1: return f(integral_constant<int, 1>{}, Fa{});
    case 2: return f(integral_constant<int, 2>{}, Fa{});
    case 3: return f(integral_constant<int, 3>{}, T{});
    case 4: return adds ? f(integral_constant<int, 4>{}, T{}) : f(integral_constant<int, 4>{}, Fa{});
    case 5: return f(integral_constant<int, 5>{}, T{});
    case 6: return f(integral_constant<int, 6>{}, Fa{});
    case 7: return adds ? f(integral_constant<int, 7>{}, T{}) : f(integral_constant<int, 7>{}, Fa{});
    default: return f(integral_constant<int, 8>{}, Fa{});
  }
}

}  // namespace tc

namespace {

// a layout's group size, and whether its weights' adds plane (null or not)
// and offset fit it
bool layout_ok(int fmt, int gs, const void* adds, int offset) {
  constexpr int GS[tc::NLAYOUT] = {32, 32, 16, 32, 16, 8, 256, 32, 32};
  if (fmt < 0 || fmt >= tc::NLAYOUT || gs != GS[fmt]) return false;
  if (fmt == 3 || fmt == 5) return adds != nullptr;
  return (adds == nullptr || fmt == 4 || fmt == 7) && (fmt != 0 || offset == 0);
}

}  // namespace

// fmt: the weight's layout (ops/qmatmul.py::qmv_fmt: 0 int8 gs 32, 1 Q4_K,
// 2 Q6_K, 3 int8 gs 32 adds, 4 int8 gs 16, 5 int8 gs 8 adds, 6 int8 gs 256,
// 7 nibbles with f32 scales, 8 Q5_K); adds (K/gs, N) f32 or null, gs and
// offset of the planar layouts. The CUDA-core kernel reads the int8 layouts
// through its int8 path (Q8_0's for layout 0), the nibbles and Q5_K through
// theirs. x (M, K) f32 or bf16; out (M, N) f32 or bf16. Returns the
// cudaError_t of the launch.
extern "C" int slt_qmm(int fmt, int M, int K, int N, const void* x, int x_bf16,
                       const void* codes, const void* hi, const void* scales,
                       const void* sc, const void* mn, const void* d, const void* dmin,
                       const void* adds, int gs, int offset, void* out, int out_bf16,
                       void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!layout_ok(fmt, gs, adds, offset)) return (int)cudaErrorInvalidValue;
  Args a{x, x_bf16, M, K, N, (const uint8_t*)codes, (const uint8_t*)hi,
         (const float*)scales, (const uint8_t*)sc, (const uint8_t*)mn,
         (const float*)d, (const float*)dmin, out, out_bf16, (const float*)adds, gs, offset};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  // the CUDA-core kernel's own families: 0 Q8_0, 1 Q4_K, 2 Q6_K, 3 int8
  // planar, 4 nibble planar, 5 Q5_K
  constexpr int FAMILY[tc::NLAYOUT] = {0, 1, 2, 3, 3, 3, 3, 4, 5};
  switch (FAMILY[fmt]) {
    case 0: qmm_kernel<0><<<grid, TPB, 0, st>>>(a); break;
    case 1: qmm_kernel<1><<<grid, TPB, 0, st>>>(a); break;
    case 2: qmm_kernel<2><<<grid, TPB, 0, st>>>(a); break;
    case 3: qmm_kernel<3><<<grid, TPB, 0, st>>>(a); break;
    case 4: qmm_kernel<4><<<grid, TPB, 0, st>>>(a); break;
    default: qmm_kernel<5><<<grid, TPB, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The tensor-core kernel for bf16 x, N a multiple of 16 and 16-byte aligned
// planes: fmt, adds, gs and offset as above; the K range is cut into
// n_split splits of per 128-deep k-tiles (qmm_plan), part holds
// n_split * M * N f32 when n_split > 1. Returns the cudaError_t of the
// launches.
extern "C" int slt_qmm_tc(int fmt, int M, int K, int N, const void* x, const void* codes,
                          const void* hi, const void* scales, const void* sc, const void* mn,
                          const void* d, const void* dmin, const void* adds, int gs, int offset,
                          int n_split, int per, void* part, void* out, int out_bf16,
                          void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (N % 16 || K % 32 || n_split < 1 || (n_split > 1 && part == nullptr) ||
      !layout_ok(fmt, gs, adds, offset) || (fmt == 6 && K % 256))
    return (int)cudaErrorInvalidValue;
  const tc::Args a{M, K, N, per, (const __nv_bfloat16*)x, (const uint8_t*)codes,
                   (const uint8_t*)hi, (const float*)scales, (const uint8_t*)sc,
                   (const uint8_t*)mn, (const float*)d, (const float*)dmin,
                   n_split > 1 ? (float*)part : nullptr, out, out_bf16, (const float*)adds,
                   offset};
  return (int)tc::with_layout(fmt, adds != nullptr, [&](auto L, auto A) {
    return tc::launch<decltype(L)::value, decltype(A)::value>(a, n_split, st);
  });
}

// Blocks of the tensor-core kernel of layout fmt (with an adds plane or
// not) that the card holds on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// the plan assumes two), or a negative cudaError_t; *smem gets the
// instantiation's shared bytes (ops/qmatmul.py::_qmm_smem mirrors them).
extern "C" int slt_qmm_resident(int fmt, int adds, int* smem) {
  if (fmt < 0 || fmt >= tc::NLAYOUT) return -(int)cudaErrorInvalidValue;
  return tc::with_layout(fmt, adds != 0, [&](auto L, auto A) {
    return tc::resident<decltype(L)::value, decltype(A)::value>(smem);
  });
}
