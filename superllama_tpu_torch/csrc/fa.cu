// fa: flash attention with positional masking, GQA, softcap, sinks and
// optional Q8_0 K/V.
//
// Replaces the TPU kernel _fa_kernel (superllama_tpu/ops/flash_attention.py:36,
// wrapper flash_attention). For each query row it computes the online
// softmax over the cache slots with an f32 running max, denominator and
// accumulator:
//  - the G query heads of one kv head are processed together (GQA), so each
//    K/V tile is read once per group;
//  - masking is positional: slot visible iff 0 <= kv_pos <= q_pos (and
//    kv_pos > q_pos - swa for a sliding window), applied as the additive
//    -1e9 * (min(0, qp-kp) + min(0, kp) [+ min(0, kp-qp+swa-1)]) penalty of
//    the TPU kernel, never -inf, so padded rows stay finite;
//  - logit softcap, and sinks as logit #0 (running max starts at the sink,
//    denominator at 1);
//  - Q8_0 K/V: int8 codes times per-row f32 scales, V rounded to bf16;
//  - out = acc / max(l, 1e-30).
// The dot types follow the TPU kernel: QK^T in bf16 (f32-exact products)
// when q is bf16, else f32; p is rounded to V's type before P.V.
//
// Two kernels, chosen by fa_plan (ops/flash_attention.py):
//  - fa_tc_kernel (namespace tc below): bf16 q over bf16 or Q8_0 K/V, every
//    prefill chunk of the main path, on the tensor cores;
//  - fa_kernel: f32 q, or bf16 q over f32 V (an f32 cache), where the TPU
//    kernel runs QK^T or P.V in f32 and TF32 would not be exact enough: both
//    products on the CUDA cores from shared memory, f32 FMA.
//
// What bounds fa on the H100, and what fa_tc_kernel does about it:
//  - at the serving wave's shape (B 8, T 128, prompts of 100 and 32 tokens
//    over a 2048-slot cache) bytes: the visible K/V rows once per kv head,
//    3.25 us at 3.35 TB/s, so a block must skip what no row sees and keep
//    its copies in flight. Before the loop it reads its batch row's kv_pos
//    once and builds the list of visible tiles (a warp ballot a 32-slot run,
//    a prefix sum by ballot counts); positions need not be sorted. Only
//    listed tiles are copied: 16-byte cp.async (4-byte or byte copies where
//    rows, strides or bases are not 16-byte multiples) into a ring of 3
//    stages, one tile in compute while two load, one block barrier a tile.
//    Each thread keeps a fixed column of each row and steps down the rows
//    by pointer increments (no divisions in the copy loop);
//  - at T >= 512 operations (8.6 GFLOP visible at T 1024, S 2048: 8.7 us
//    at 989 TFLOP/s): both products run as mma.sync m16n8k16 bf16 -> f32.
//    A block is 4 warps over 64 query rows (t, g) of one kv head, a warp
//    one m16 tile; Q is loaded once and held as A fragments in registers
//    (D <= 128; re-read from shared memory above); K's B fragments come by
//    ldmatrix, V's by ldmatrix.trans, from rows padded by 16 bytes so the 8
//    rows of a fragment fall in distinct banks. The logits stay in the
//    products' C fragments: scale, softcap and the penalty (kv_pos from the
//    stage, q_pos in a register) are applied there, the row max and sum
//    take two quad shuffles, and p, rounded to bf16 against the tile's
//    running max, is packed straight into P.V's A fragments. Row tiles are
//    handed out longest-first (the last positions of a causal prompt see the
//    most tiles). Two blocks fit an SM at D <= 128.
//  - Q8_0 K/V: codes and scales are copied as they are; the block
//    dequantizes each tile into one bf16 K and one bf16 V tile in the TPU
//    kernel's order (code times scale in f32, rounded to bf16), behind a
//    second barrier.
// Skipping a tile is exact for valid rows: a tile no row of the block sees
// contributes exp(-1e9) = 0. A block whose rows are all padding writes
// zeros and leaves. Every sum is taken in a fixed order: two calls give the
// same bits.
//
// Head sizes: any D <= 256, Dv <= 256. fa_tc_kernel pads D and Dv to whole
// 16s (zero columns) and is instantiated for widths up to 64, 128 and 256
// (64-slot tiles, 32 above 128); fa_kernel instantiates Dv at 16, 32, 64,
// 96, 128, 192 and 256 columns and pads up to the next of them (the padding
// lanes read zero V and write nothing, so the unpadded part is exact).
//
// Layout: q (B,T,H,D) contiguous; k (B,Hkv,S,D), v (B,Hkv,S,Dv) with rows
// contiguous and caller-given batch/head strides; out (B,T,H,Dv) in q's type.

#include "ptx.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int ROWS = 64;   // query rows (t, g) per block
constexpr int BS = 64;     // cache slots per tile
constexpr int TPB = 256;   // 4 threads per row

enum { KV_F32 = 0, KV_BF16 = 1, KV_Q8 = 2 };

struct Args {
  int B, T, H, Hkv, S, D, Dv, G, BT;
  const void* q; int q_bf16;
  const void* k; const void* v; int kv_kind;
  long k_sb, k_sh, v_sb, v_sh;
  const float* k_scale; const float* v_scale; long s_sb, s_sh;
  const int* q_pos; const int* kv_pos; long kvpos_sb;
  const float* sinks; float scale; int swa; float softcap;
  void* out;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_kv(const void* p, int kind, long i, float row_scale) {
  if (kind == KV_F32) return reinterpret_cast<const float*>(p)[i];
  if (kind == KV_BF16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  return __fmul_rn((float)reinterpret_cast<const int8_t*>(p)[i], row_scale);
}

template <int DV4>
__global__ void __launch_bounds__(TPB) fa_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, Dv = a.Dv, G = a.G;
  float* Qs = smem;                      // ROWS x (D+1)
  float* Ks = Qs + ROWS * (D + 1);       // BS x (D+1)
  constexpr int DVP = 4 * DV4;           // Dv padded to the instantiation
  float* Vs = Ks + BS * (D + 1);         // BS x DVP, zero past Dv
  float* Ps = Vs + BS * DVP;             // ROWS x (BS+1)
  int* kp_s = reinterpret_cast<int*>(Ps + ROWS * (BS + 1));   // BS
  int* qlim = kp_s + BS;                 // [max q_pos, min q_pos] of the block

  const int tid = threadIdx.x, r = tid >> 2, l4 = tid & 3;
  const int b = blockIdx.z, hk = blockIdx.y, t0 = blockIdx.x * a.BT;
  const int R = a.BT * G;
  const int t = t0 + r / G, h = hk * G + r % G;
  const bool active = r < R && t < a.T;
  const int qp = active ? a.q_pos[(long)b * a.T + t] : -1;
  const bool cdt_bf16 = a.q_bf16;
  const bool v_bf16 = a.kv_kind != KV_F32;

  if (tid == 0) { qlim[0] = INT_MIN; qlim[1] = INT_MAX; }
  for (int i = tid; i < ROWS * D; i += TPB) {
    const int rr = i / D, dd = i % D, tt = t0 + rr / G;
    float val = 0.f;
    if (rr < R && tt < a.T) {
      const long qi = (((long)b * a.T + tt) * a.H + hk * G + rr % G) * D + dd;
      val = a.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.q)[qi])
                     : reinterpret_cast<const float*>(a.q)[qi];
    }
    Qs[rr * (D + 1) + dd] = val;
  }
  __syncthreads();
  if (l4 == 0 && active && qp >= 0) { atomicMax(&qlim[0], qp); atomicMin(&qlim[1], qp); }
  __syncthreads();
  const int qmax = qlim[0], qmin = qlim[1];

  float m_run = -1e30f, l_run = 0.f;
  if (a.sinks != nullptr && active) { m_run = a.sinks[h]; l_run = 1.f; }
  float acc[DV4];
#pragma unroll
  for (int i = 0; i < DV4; ++i) acc[i] = 0.f;
  const float qpf = (float)qp;

  for (int s0 = 0; s0 < a.S; s0 += BS) {
    int vis = 0;
    if (tid < BS) {
      const int s = s0 + tid;
      const int kp = s < a.S ? a.kv_pos[(long)b * a.kvpos_sb + s] : -1;
      kp_s[tid] = kp;
      vis = kp >= 0 && kp <= qmax && (a.swa <= 0 || kp > qmin - a.swa);
    }
    if (!__syncthreads_or(vis)) continue;

    const long kb = (long)b * a.k_sb + (long)hk * a.k_sh;
    const long vb = (long)b * a.v_sb + (long)hk * a.v_sh;
    const long sb = (long)b * a.s_sb + (long)hk * a.s_sh;
    for (int i = tid; i < BS * D; i += TPB) {
      const int j = i / D, dd = i % D, s = s0 + j;
      float val = 0.f;
      if (s < a.S) {
        val = load_kv(a.k, a.kv_kind, kb + (long)s * D + dd,
                      a.kv_kind == KV_Q8 ? a.k_scale[sb + s] : 0.f);
        if (cdt_bf16) val = bf16_round(val);
      }
      Ks[j * (D + 1) + dd] = val;
    }
    for (int i = tid; i < BS * DVP; i += TPB) {
      const int j = i / DVP, dd = i % DVP, s = s0 + j;
      float val = 0.f;
      if (s < a.S && dd < Dv) {
        val = load_kv(a.v, a.kv_kind, vb + (long)s * Dv + dd,
                      a.kv_kind == KV_Q8 ? a.v_scale[sb + s] : 0.f);
        if (a.kv_kind == KV_Q8) val = bf16_round(val);
      }
      Vs[j * DVP + dd] = val;
    }
    __syncthreads();

    // logits of this row for slots j = l4 + 4*i
    float lg[BS / 4];
#pragma unroll
    for (int i = 0; i < BS / 4; ++i) lg[i] = 0.f;
    const float* qrow = Qs + r * (D + 1);
    for (int dd = 0; dd < D; ++dd) {
      const float qv = qrow[dd];
#pragma unroll
      for (int i = 0; i < BS / 4; ++i) lg[i] = fmaf(qv, Ks[(l4 + 4 * i) * (D + 1) + dd], lg[i]);
    }
    float mx = -3.402823466e38f;
#pragma unroll
    for (int i = 0; i < BS / 4; ++i) {
      float x = lg[i] * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      const float kpf = (float)kp_s[l4 + 4 * i];
      float pen = fminf(0.f, qpf - kpf) + fminf(0.f, kpf);
      if (a.swa > 0) pen += fminf(0.f, kpf - qpf + (float)a.swa - 1.f);
      x = x + pen * 1e9f;
      lg[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float psum = 0.f;
    float* prow = Ps + r * (BS + 1);
#pragma unroll
    for (int i = 0; i < BS / 4; ++i) {
      const float p = expf(lg[i] - m_new);
      psum += p;
      prow[l4 + 4 * i] = v_bf16 ? bf16_round(p) : p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();

    float tsum[DV4];
#pragma unroll
    for (int i = 0; i < DV4; ++i) tsum[i] = 0.f;
    for (int j = 0; j < BS; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * DVP + l4;
#pragma unroll
      for (int i = 0; i < DV4; ++i) tsum[i] = fmaf(p, vrow[4 * i], tsum[i]);
    }
#pragma unroll
    for (int i = 0; i < DV4; ++i) acc[i] = acc[i] * alpha + tsum[i];
    __syncthreads();
  }

  if (!active) return;
  const float denom = fmaxf(l_run, 1e-30f);
  const long o = (((long)b * a.T + t) * a.H + h) * Dv + l4;
#pragma unroll
  for (int i = 0; i < DV4; ++i) {
    if (l4 + 4 * i >= Dv) break;   // padding lanes write nothing
    const float val = acc[i] / denom;
    if (a.q_bf16) reinterpret_cast<__nv_bfloat16*>(a.out)[o + 4 * i] = __float2bfloat16_rn(val);
    else reinterpret_cast<float*>(a.out)[o + 4 * i] = val;
  }
}

template <int DV4>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)ROWS * (a.D + 1) + (size_t)BS * (a.D + 1) +
                                       (size_t)BS * 4 * DV4 + (size_t)ROWS * (BS + 1)) +
                      sizeof(int) * (BS + 2);
  cudaError_t e = cudaFuncSetAttribute(fa_kernel<DV4>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + a.BT - 1) / a.BT, a.Hkv, a.B);
  fa_kernel<DV4><<<grid, TPB, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------- the tensor-core kernel

namespace tc {

using namespace ptx;

constexpr int NW = 4, NT = NW * 32;   // four warps, one m16 tile of query rows each
constexpr int ROWS = NW * 16;          // query rows (t, g) a block
constexpr int NST = 3;                 // ring stages
enum { COPY_16 = 0, COPY_4 = 1, COPY_1 = 2 };   // as copy_mode in ops/flash_attention.py

__host__ __device__ inline int up16(int n) { return (n + 15) / 16 * 16; }

// A block's shared memory, in bytes. NST ring stages, each a tile's K rows,
// V rows (bf16 at strides of the 16-padded width plus 16 bytes; Q8_0: codes
// at 16-byte multiples, then the K and V scales) and kv_pos; for Q8_0 the
// dequantized bf16 K and V tiles; Q's 64 rows, in the last stage's K rows
// (or the bf16 K tile) where a tile holds 64 rows, since Q is in registers
// before those are first written, else apart; the list of visible tiles.
// fa_plan in ops/flash_attention.py computes the same numbers.
struct Layout {
  int bs, krow, vrow, kcrow, vcrow, stage, off_v, off_ks, off_vs, off_pos;
  int off_kb, off_vb, off_q, off_list, bytes;
};

inline Layout make_layout(int D, int Dv, int S, bool q8) {
  Layout L{};
  const int dk = up16(D), dv = up16(Dv);
  L.bs = (dk > 128 || dv > 128) ? 32 : 64;
  L.krow = 2 * dk + 16;
  L.vrow = 2 * dv + 16;
  L.kcrow = q8 ? dk : L.krow;
  L.vcrow = q8 ? dv : L.vrow;
  L.off_v = L.bs * L.kcrow;
  L.off_ks = L.off_v + L.bs * L.vcrow;
  L.off_vs = L.off_ks + (q8 ? 4 * L.bs : 0);
  L.off_pos = L.off_vs + (q8 ? 4 * L.bs : 0);
  L.stage = L.off_pos + 4 * L.bs;
  int off = NST * L.stage;
  L.off_kb = off;
  if (q8) off += L.bs * L.krow;
  L.off_vb = off;
  if (q8) off += L.bs * L.vrow;
  if (L.bs == ROWS) {
    L.off_q = q8 ? L.off_kb : (NST - 1) * L.stage;
  } else {
    L.off_q = off;
    off += ROWS * L.krow;
  }
  L.off_list = off;
  L.bytes = off + up16(4 * ((S + L.bs - 1) / L.bs));
  return L;
}

struct Args {
  int B, T, H, Hkv, S, D, Dv, G, BT, n_rt, ntiles;
  const unsigned char* q; int q_copy;
  const unsigned char* k; const unsigned char* v; int kv_copy;
  long k_sb, k_sh, v_sb, v_sh;          // element strides
  const float* k_scale; const float* v_scale; long s_sb, s_sh;
  const int* q_pos; const int* kv_pos; long kvpos_sb;
  const float* sinks; float scale; int swa; float softcap;
  __nv_bfloat16* out;
  Layout L;
};

// global -> shared through L2, n of the 16 (4) bytes read, the rest zero
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the SFU (exp(x) = 2^(x log2 e)); results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// One thread's share of copying a tile's rows: `bytes` a row in global
// memory (rows contiguous), `sstride` apart in shared memory. 16- or 4-byte
// pieces: the thread keeps one piece column and takes every rstep-th row
// from r0, so the loop is pointer increments; rows of odd size go byte by
// byte. Rows at or past cnt (beyond the cache) read as zeros.
struct RowCopy {
  int mode, bytes, sstride, r0, rstep, off;

  __device__ void init(int mode_, int bytes_, int sstride_) {
    mode = mode_;
    bytes = bytes_;
    sstride = sstride_;
    const int piece = mode == COPY_16 ? 16 : 4;
    const int per = mode == COPY_1 ? 1 : bytes / piece;
    rstep = NT / per;
    r0 = threadIdx.x / per;
    if (r0 >= rstep) r0 = 1 << 20;   // threads past whole rows idle
    off = (threadIdx.x % per) * piece;
  }

  __device__ void copy(unsigned char* dst, const unsigned char* src, int n, int cnt) const {
    if (mode == COPY_1) {
      for (int i = threadIdx.x; i < n * bytes; i += NT) {
        const int r = i / bytes, c = i - r * bytes;
        dst[r * sstride + c] = r < cnt ? src[(long)r * bytes + c] : 0;
      }
      return;
    }
    const unsigned char* s = src + (long)r0 * bytes + off;
    unsigned char* d = dst + r0 * sstride + off;
    const long sstep = (long)rstep * bytes;
    const int dstep = rstep * sstride;
    for (int r = r0; r < n; r += rstep, s += sstep, d += dstep) {
      const bool in = r < cnt;
      if (mode == COPY_16) cp16(d, in ? s : src, in ? 16 : 0);
      else cp4(d, in ? s : src, in ? 4 : 0);
    }
  }
};

// Q8_0: codes (rows of n at crow bytes) times their row's scale in f32,
// rounded to bf16, into rows of drow bytes, 8 columns a store; columns n ..
// w16 (the 16-padded width) zero
__device__ void dequant(unsigned char* dst, int drow, const unsigned char* codes, int crow,
                        const float* scales, int n, int w16, int rows) {
  const int per = w16 / 8, rstep = NT / per, c0 = (threadIdx.x % per) * 8;
  if ((int)threadIdx.x >= rstep * per) return;   // past whole rows
  for (int r = threadIdx.x / per; r < rows; r += rstep) {
    const uint2 w = *reinterpret_cast<const uint2*>(codes + r * crow + c0);
    const float s = scales[r];
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t word = e < 2 ? w.x : w.y;
      const int sh = 16 * (e & 1);
      const float lo = c0 + 2 * e < n ? __fmul_rn((float)(int8_t)(word >> sh), s) : 0.f;
      const float hi = c0 + 2 * e + 1 < n ? __fmul_rn((float)(int8_t)(word >> (sh + 8)), s) : 0.f;
      o[e] = pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(dst + r * drow + 2 * c0) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// DM: D and Dv padded to whole 16s are at most DM; BS: slots a tile
template <int DM, int BS, bool Q8>
__global__ void __launch_bounds__(NT, DM <= 128 ? 2 : 1) fa_tc_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_q[2][2], s_nvis;   // q_pos max / least valid q_pos of warps 0, 1
  constexpr int KPR = 16;            // kv_pos a thread reads in a round of 2048 slots
  constexpr float L2E = 1.4426950408889634f;
  constexpr int NKS = DM / 16;       // k-steps of QK^T at most
  constexpr int NVT = DM / 8;        // n8 column tiles of P.V at most
  constexpr int NS8 = BS / 8;        // n8 slot tiles of a logit tile
  constexpr bool QREG = DM <= 128;   // Q's A fragments held in registers
  const Layout& L = a.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  // longest row tiles first: block i takes kv head i % Hkv of row tile
  // n_rt - 1 - i / Hkv (a causal prompt's last rows see the most tiles)
  const int lin = blockIdx.x + blockIdx.y * gridDim.x;
  const int hk = lin % a.Hkv, b = blockIdx.z;
  const int t0 = (a.n_rt - 1 - lin / a.Hkv) * a.BT;
  const int G = a.G, R = a.BT * G;
  const int nks = (a.D + 15) >> 4, nvt = ((a.Dv + 15) >> 4) * 2;

  // what needs nothing else goes out at once: the block's q_pos (a token a
  // thread), Q's rows (cp.async), the first 2048 kv_pos (16 a thread)
  const int qp_t = tid < a.BT && t0 + tid < a.T ? a.q_pos[(long)b * a.T + t0 + tid] : -1;
  unsigned char* qs = smem + L.off_q;
  {   // Q's rows (t0 + r / G, head hk * G + r % G), zero past R or T
    const int piece = a.q_copy == COPY_16 ? 16 : a.q_copy == COPY_4 ? 4 : 1;
    const int per = 2 * a.D / piece;
    for (int i = tid; i < ROWS * per; i += NT) {
      const int r = i / per, c = (i - r * per) * piece, t = t0 + r / G;
      const bool in = r < R && t < a.T;
      const unsigned char* src =
          a.q + (in ? (((long)b * a.T + t) * a.H + hk * G + r % G) * a.D * 2 + c : 0);
      unsigned char* dst = qs + r * L.krow + c;
      if (piece == 16) cp16(dst, src, in ? 16 : 0);
      else if (piece == 4) cp4(dst, src, in ? 4 : 0);
      else *dst = in ? *src : 0;
    }
  }
  commit();
  // the list of visible tiles (flags first)
  int* list = reinterpret_cast<int*>(smem + L.off_list);
  for (int i = tid; i < a.ntiles; i += NT) list[i] = 0;
  const int* kpr = a.kv_pos + (long)b * a.kvpos_sb;
  int kp[KPR];
#pragma unroll
  for (int u = 0; u < KPR; ++u) {
    const int s = u * NT + tid;
    kp[u] = s < a.S ? __ldg(kpr + s) : -1;
  }
  if (warp < 2) {   // the block's tokens are threads 0 .. BT - 1 <= 63
    const int hi = __reduce_max_sync(0xffffffffu, qp_t);
    const int lo = __reduce_min_sync(0xffffffffu, qp_t >= 0 ? qp_t : INT_MAX);
    if (lane == 0) {
      s_q[warp][0] = hi;
      s_q[warp][1] = lo;
    }
  }
  __syncthreads();
  const int qmax = max(s_q[0][0], s_q[1][0]), qmin = min(s_q[0][1], s_q[1][1]);
  if (qmax < 0) {
    // padding rows only: the zeros of an empty softmax. A token's G rows
    // are G * Dv adjacent outputs.
    wait_groups<0>();
    const int run = G * a.Dv;
    for (int i = tid; i < a.BT * run; i += NT) {
      const int t = t0 + i / run;
      if (t < a.T)
        a.out[(((long)b * a.T + t) * a.H + hk * G) * a.Dv + i % run] = __float2bfloat16_rn(0.f);
    }
    return;
  }

  // a slot is visible to some row of the block iff 0 <= kp <= qmax (and
  // kp > qmin - swa); positions in any order. Each warp takes 32-slot runs,
  // which lie in one tile.
  for (int c0 = 0; c0 < a.S; c0 += KPR * NT) {
    if (c0 > 0) {
#pragma unroll
      for (int u = 0; u < KPR; ++u) {
        const int s = c0 + u * NT + tid;
        kp[u] = s < a.S ? __ldg(kpr + s) : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < KPR; ++u) {
      const bool vis = kp[u] >= 0 && kp[u] <= qmax && (a.swa <= 0 || kp[u] > qmin - a.swa);
      if (__any_sync(0xffffffffu, vis) && lane == 0) list[(c0 + u * NT + warp * 32) / BS] = 1;
    }
  }
  __syncthreads();
  if (warp == 0) {   // compact the flags into the list, in tile order
    int n = 0;
    for (int base = 0; base < a.ntiles; base += 32) {
      const bool f = base + lane < a.ntiles && list[base + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(m & ((1u << lane) - 1u))] = base + lane;
      n += __popc(m);
    }
    if (lane == 0) s_nvis = n;
  }

  // padding columns (D and Dv up to whole 16s) are never copied: zero them
  const int kpad = L.krow - 16 - 2 * a.D, vpad = L.vrow - 16 - 2 * a.Dv;
  if (kpad > 0) {
    for (int i = tid; i < ROWS * kpad; i += NT) qs[(i / kpad) * L.krow + 2 * a.D + i % kpad] = 0;
    if (!Q8)
      for (int i = tid; i < NST * BS * kpad; i += NT)
        smem[(i / (BS * kpad)) * L.stage + (i / kpad % BS) * L.krow + 2 * a.D + i % kpad] = 0;
  }
  if (vpad > 0 && !Q8)
    for (int i = tid; i < NST * BS * vpad; i += NT)
      smem[(i / (BS * vpad)) * L.stage + L.off_v + (i / vpad % BS) * L.vrow + 2 * a.Dv + i % vpad] =
          0;
  __syncthreads();
  const int nvis = s_nvis;

  const int esz = Q8 ? 1 : 2;
  RowCopy kc, vc;
  kc.init(a.kv_copy, a.D * esz, L.kcrow);
  vc.init(a.kv_copy, a.Dv * esz, L.vcrow);
  const unsigned char* kbase = a.k + ((long)b * a.k_sb + (long)hk * a.k_sh) * esz;
  const unsigned char* vbase = a.v + ((long)b * a.v_sb + (long)hk * a.v_sh) * esz;
  const long sbh = (long)b * a.s_sb + (long)hk * a.s_sh;
  auto load_tile = [&](int tile, int st) {
    const int s0 = tile * BS, cnt = min(BS, a.S - s0);
    unsigned char* sb = smem + st * L.stage;
    kc.copy(sb, kbase + (long)s0 * a.D * esz, BS, cnt);
    vc.copy(sb + L.off_v, vbase + (long)s0 * a.Dv * esz, BS, cnt);
    int* pos = reinterpret_cast<int*>(sb + L.off_pos);
    if (tid < BS) {
      if (tid < cnt) cp4(pos + tid, kpr + s0 + tid, 4);
      else pos[tid] = -1;
    }
    if constexpr (Q8) {
      const int j = tid < BS ? tid : tid - BS;
      if (tid < 2 * BS) {
        const float* src = (tid < BS ? a.k_scale : a.v_scale) + sbh + s0;
        cp4(sb + (tid < BS ? L.off_ks : L.off_vs) + 4 * j, src + (j < cnt ? j : 0),
            j < cnt ? 4 : 0);
      }
    }
  };
  for (int i = 0; i < NST - 1; ++i) {
    if (i < nvis) load_tile(list[i], i);
    commit();
  }

  // this thread's two rows: g and g + 8 of the warp's m16 tile
  float qpf[2], m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh, t = t0 + r / G;
    const bool valid = r < R && t < a.T;
    qpf[hh] = valid ? (float)a.q_pos[(long)b * a.T + t] : -1.f;
    m[hh] = -1e30f;
    l[hh] = 0.f;
    if (a.sinks != nullptr && valid) {   // the sink is logit #0
      m[hh] = a.sinks[hk * G + r % G];
      l[hh] = t4 == 0 ? 1.f : 0.f;       // l is summed over the quad at the end
    }
  }
  wait_groups<NST - 1>();   // Q's group
  __syncthreads();
  const unsigned char* qa = qs + (warp * 16 + (lane & 15)) * L.krow + (lane >> 4) * 16;
  uint32_t qf[QREG ? NKS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      if (ks < nks) ldsm4(qf[ks], qa + ks * 32);
  }
  float o[NVT][4];
#pragma unroll
  for (int n = 0; n < NVT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // ldmatrix row addresses of this lane: K (non-transposed, slot rows
  // 8j + (lane & 7) + 8 (lane >> 4), k half (lane >> 3) & 1) and V
  // (transposed, slot rows 16kk + (lane & 7) + 8 ((lane >> 3) & 1), column
  // half lane >> 4)
  const int krow_l = ((lane & 7) + 8 * (lane >> 4)) * L.krow + ((lane >> 3) & 1) * 16;
  const int vrow_l = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.vrow + (lane >> 4) * 16;

  for (int it = 0; it < nvis; ++it) {
    wait_groups<NST - 2>();
    __syncthreads();   // tile it landed; every warp is done with tile it - 1
    if (it + NST - 1 < nvis) load_tile(list[it + NST - 1], (it + NST - 1) % NST);
    commit();
    const unsigned char* sb = smem + (it % NST) * L.stage;
    const unsigned char* kt = sb;
    const unsigned char* vt = sb + L.off_v;
    if constexpr (Q8) {
      dequant(smem + L.off_kb, L.krow, sb, L.kcrow, reinterpret_cast<const float*>(sb + L.off_ks),
              a.D, up16(a.D), BS);
      dequant(smem + L.off_vb, L.vrow, sb + L.off_v, L.vcrow,
              reinterpret_cast<const float*>(sb + L.off_vs), a.Dv, up16(a.Dv), BS);
      __syncthreads();
      kt = smem + L.off_kb;
      vt = smem + L.off_vb;
    }
    const int* pos = reinterpret_cast<const int*>(sb + L.off_pos);

    // logits = Q K^T: C fragments, slot tile j holds rows g / g + 8 at
    // slots 8j + 2 t4, + 1
    float sc[NS8][4];
#pragma unroll
    for (int j = 0; j < NS8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if (ks >= nks) break;
      uint32_t qr[4];
      const uint32_t* af = qr;
      if constexpr (QREG) af = qf[ks];
      else ldsm4(qr, qa + ks * 32);
#pragma unroll
      for (int j = 0; j < NS8; j += 2) {
        uint32_t bk[4];
        ldsm4(bk, kt + 8 * j * L.krow + krow_l + ks * 32);
        mma_bf16(sc[j], af, bk[0], bk[1]);
        mma_bf16(sc[j + 1], af, bk[2], bk[3]);
      }
    }

    // scale, softcap, positional penalty; the running max
    float mx[2] = {-3.402823466e38f, -3.402823466e38f};
#pragma unroll
    for (int j = 0; j < NS8; ++j) {
      const int2 kp2 = *reinterpret_cast<const int2*>(pos + 8 * j + 2 * t4);
      const float kpf[2] = {(float)kp2.x, (float)kp2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const float qp = qpf[e >> 1], kpv = kpf[e & 1];
        float pen = fminf(0.f, qp - kpv) + fminf(0.f, kpv);
        if (a.swa > 0) pen += fminf(0.f, kpv - qp + (float)a.swa - 1.f);
        x = x + pen * 1e9f;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m[hh], mx[hh]);
      alpha[hh] = ex2((m[hh] - mn) * L2E);
      m[hh] = mn;
    }
    // p = exp(x - m) = 2^((x - m) log2 e) against the running max (x - m
    // first: a penalized row's logits are ~1e12, and x log2 e - m log2 e
    // would keep their rounding), f32 into l, rounded to bf16 straight into
    // the A fragments of P.V (slots 16kk .. 16kk + 15: tiles 2kk, 2kk + 1)
    uint32_t pa[BS / 16][4];
#pragma unroll
    for (int j = 0; j < NS8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2((sc[j][e] - m[e >> 1]) * L2E);
        ps[e >> 1] += p[e];
      }
      pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
#pragma unroll
    for (int n = 0; n < NVT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: V's B fragments by ldmatrix.trans, two column tiles a load
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NVT; n += 2) {
        if (n >= nvt) break;
        uint32_t bv[4];
        ldsm4t(bv, vt + 16 * kk * L.vrow + vrow_l + n * 16);
        mma_bf16(o[n], pa[kk], bv[0], bv[1]);
        mma_bf16(o[n + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }

  // out = O / max(l, 1e-30); l summed over the quad in a fixed order
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh, t = t0 + r / G;
    if (r >= R || t >= a.T) continue;
    const float den = fmaxf(l[hh], 1e-30f);
    __nv_bfloat16* orow = a.out + (((long)b * a.T + t) * a.H + hk * G + r % G) * a.Dv;
#pragma unroll
    for (int n = 0; n < NVT; ++n) {
      if (n >= nvt) break;
      const int c = 8 * n + 2 * t4;
      const float v0 = o[n][2 * hh] / den, v1 = o[n][2 * hh + 1] / den;
      if (c + 1 < a.Dv && (a.Dv & 1) == 0) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(v0, v1);
      } else {
        if (c < a.Dv) orow[c] = __float2bfloat16_rn(v0);
        if (c + 1 < a.Dv) orow[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int DM, int BS, bool Q8>
cudaError_t launch(const Args& a, cudaStream_t st) {
  static int attr = 0;   // the largest dynamic shared memory set so far
  if (a.L.bytes > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_tc_kernel<DM, BS, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.L.bytes);
    if (e != cudaSuccess) return e;
    attr = a.L.bytes;
  }
  fa_tc_kernel<DM, BS, Q8><<<dim3(a.n_rt, a.Hkv, a.B), NT, a.L.bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

// kv_kind: 0 f32, 1 bf16, 2 int8 codes with per-row f32 scales (Q8_0).
// k_sb/k_sh/v_sb/v_sh/s_sb/s_sh/kvpos_sb are element strides. D <= 256,
// Dv <= 256, H / Hkv <= 64. Returns the cudaError_t.
extern "C" int slt_fa(int B, int T, int H, int Hkv, int S, int D, int Dv,
                      const void* q, int q_bf16, const void* k, const void* v, int kv_kind,
                      long k_sb, long k_sh, long v_sb, long v_sh,
                      const void* k_scale, const void* v_scale, long s_sb, long s_sh,
                      const void* q_pos, const void* kv_pos, long kvpos_sb,
                      const void* sinks, float scale, int swa, float softcap,
                      void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  Args a{B, T, H, Hkv, S, D, Dv, G, ROWS / G, q, q_bf16, k, v, kv_kind,
         k_sb, k_sh, v_sb, v_sh, (const float*)k_scale, (const float*)v_scale, s_sb, s_sh,
         (const int*)q_pos, (const int*)kv_pos, kvpos_sb, (const float*)sinks,
         scale, swa, softcap, out};
  cudaError_t e;
  // Dv padded up to the next instantiated width (padding lanes read zero V
  // and write nothing, so the result on the unpadded part is unchanged)
  if (D > 256 || D < 1 || Dv < 1) e = cudaErrorInvalidValue;
  else if (Dv <= 16) e = launch<4>(a, st);
  else if (Dv <= 32) e = launch<8>(a, st);
  else if (Dv <= 64) e = launch<16>(a, st);
  else if (Dv <= 96) e = launch<24>(a, st);
  else if (Dv <= 128) e = launch<32>(a, st);
  else if (Dv <= 192) e = launch<48>(a, st);
  else if (Dv <= 256) e = launch<64>(a, st);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

// The tensor-core kernel: bf16 q over bf16 K/V or Q8_0 codes (q8 = 1, with
// f32 k_scale/v_scale). q_copy / kv_copy: copy modes of q's and K/V's rows
// (0 16-byte, 1 4-byte, 2 bytes; copy_mode in ops/flash_attention.py).
// bs, n_rt and smem are fa_plan's slots a tile, row tiles and shared-memory
// bytes: a launch that disagrees with the kernel's own layout is refused.
// Returns the cudaError_t.
extern "C" int slt_fa_tc(int B, int T, int H, int Hkv, int S, int D, int Dv, const void* q,
                         int q_copy, const void* k, const void* v, int q8, int kv_copy,
                         long k_sb, long k_sh, long v_sb, long v_sh, const void* k_scale,
                         const void* v_scale, long s_sb, long s_sh, const void* q_pos,
                         const void* kv_pos, long kvpos_sb, const void* sinks, float scale,
                         int swa, float softcap, int bs, int n_rt, int smem, void* out,
                         void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || Hkv < 1 || H % Hkv || H / Hkv > tc::ROWS)
    return (int)cudaErrorInvalidValue;
  const tc::Layout L = tc::make_layout(D, Dv, S, q8 != 0);
  const int G = H / Hkv, BT = tc::ROWS / G;
  if (bs != L.bs || smem != L.bytes || n_rt != (T + BT - 1) / BT)
    return (int)cudaErrorInvalidValue;
  tc::Args a{B, T, H, Hkv, S, D, Dv, G, BT, n_rt, (S + L.bs - 1) / L.bs,
             (const unsigned char*)q, q_copy, (const unsigned char*)k,
             (const unsigned char*)v, kv_copy, k_sb, k_sh, v_sb, v_sh,
             (const float*)k_scale, (const float*)v_scale, s_sb, s_sh,
             (const int*)q_pos, (const int*)kv_pos, kvpos_sb, (const float*)sinks,
             scale, swa, softcap, (__nv_bfloat16*)out, L};
  const int dm = tc::up16(D) > tc::up16(Dv) ? tc::up16(D) : tc::up16(Dv);
  cudaError_t e;
  if (dm <= 64) e = q8 ? tc::launch<64, 64, true>(a, st) : tc::launch<64, 64, false>(a, st);
  else if (dm <= 128) e = q8 ? tc::launch<128, 64, true>(a, st) : tc::launch<128, 64, false>(a, st);
  else e = q8 ? tc::launch<256, 32, true>(a, st) : tc::launch<256, 32, false>(a, st);
  return (int)e;
}
