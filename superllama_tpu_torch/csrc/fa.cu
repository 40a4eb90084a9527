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
//  - fa_tc_kernel (fa_tc.cuh, shared with paged.cu): bf16 q over bf16 or
//    Q8_0 K/V, every prefill chunk of the main path, on the tensor cores;
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

#include "fa_tc.cuh"

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
