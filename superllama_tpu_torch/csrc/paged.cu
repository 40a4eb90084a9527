// paged: flash attention over a page pool through per-row page tables.
//
// Replaces the TPU kernel _paged_dma_kernel
// (superllama_tpu/ops/paged_attention.py:138, wrapper paged_flash_attention).
// K/V live in a pool of pages (N, Hkv, P, D) shared by every sequence; row
// b's logical page lg sits in pool page table[b, lg], and an absent entry
// (-1) reads page 0, the NULL page, whose positions are all -1. Semantics:
//  - the G query heads of one kv head share each K/V tile (GQA);
//  - masking is fa's positional -1e9 penalty from the page positions;
//  - sinks enter the max and the denominator (exp(sink - m)); softcap;
//  - QK^T in bf16 (K rounded) when q is bf16, else f32; p is rounded to V's
//    type before P.V; out = acc / max(l, 1e-30);
//  - a tile that no query row can see is skipped before K/V are read, so
//    absent pages, empty page tails and the SWA-hidden past cost only their
//    positions. A block of padding rows only gives 0, as the TPU kernel does.
//
// Three kernels, one launch per call, chosen by paged_plan
// (ops/paged_attention.py):
//  - decode shapes (T*G <= 32, every decode step): decode_common.cuh's
//    cluster kernel. One cluster of cl = min(8, tiles in the row) blocks per
//    (kv head, batch row) divides the row's MAXP * P slots, nb a block
//    (ceil(MAXP * P / cl) rounded up to whole 8 KB tiles: 32 slots in bf16
//    at D 128); each tile comes in by one bulk copy per page it touches
//    (a 256-token page is 8 such tiles). The cluster takes each row's max
//    over the whole row before p, as the plain version does; a block whose
//    share exceeds its logits buffer (nbmax slots: 2048 at T*G 4) runs
//    passes with a running max. 512 blocks at B 8, 64 at B 1 for 2048 slots.
//  - prefill shapes (T*G > 32: every chunk of a page-chunked prefill), bf16
//    q over bf16 pages: fa's tensor-core kernel (fa_tc.cuh) addressed
//    through the page table (PAGED). Four warps over 64 query rows of one
//    kv head, mma.sync for both products, a 3-stage cp.async ring of only
//    the visible 64-slot tiles (32 above 128 columns), each copied in runs
//    that stay inside one page; the row's table is staged in shared memory.
//    A block of padding rows only (seven of the eight rows of a serving
//    chunk ride along on the NULL page) writes zeros and leaves after
//    reading q_pos.
//  - prefill shapes with f32 q or f32 pages, where the TPU kernel runs QK^T
//    or P.V in f32 and TF32 would not be exact enough: paged_kernel below,
//    one block per (tile of 64 query rows, kv head, batch row) walking the
//    table in 64-slot tiles with an f32 online softmax on the CUDA cores.
// Both prefill kernels take 64-slot tiles aligned to the row's logical
// slots and round p relative to each tile's running max (the TPU kernel
// takes pages four at a time with a running max per chunk).
//
// What bounds it on the H100: bytes at decode shapes (K and V of the
// occupied pages, 67.1 MB in bf16 at B 8, 2048 slots, 8 kv heads, D 128:
// 0.020 ms at 3.35 TB/s); decode_common.cuh says how the decode path keeps
// bytes in flight. At a serving chunk (B 8, T 128, one prompt of 100
// tokens) bytes too: the prompt's page, q of its rows, the whole output,
// 3.1 us; the tensor-core kernel's 448 padding blocks leave at once and 56
// copy one or two tiles each. At a long prompt's 256-token chunk
// operations (3.76 GFLOP visible, 3.8 us at 989 TFLOP/s); fa.cu says how
// the tensor-core kernel keeps its products fed.
//
// The host changes tables and page positions between steps with ordinary
// (stream-ordered) copies before this launch.
//
// Head sizes: any D <= 256; Dv <= 256. The tensor-core kernel pads both to
// whole 16s (instantiated for widths up to 64, 128 and 256); paged_kernel
// instantiates Dv at 16, 32, 64, 96, 128, 192 and 256 columns and pads up
// to the next of them (the padding lanes read zero V and write nothing, so
// the unpadded part is exact).
//
// Layout: q (B,T,H,D) contiguous; k_pages (N,Hkv,P,D), v_pages (N,Hkv,P,Dv)
// with rows contiguous and caller-given page/head strides; page_pos (N,P)
// int32 contiguous; table (B,MAXP) int32 contiguous; out (B,T,H,Dv) in q's
// type.

#include "decode_common.cuh"
#include "fa_tc.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int ROWS = 64;   // query rows (t, g) per block
constexpr int BS = 64;     // cache slots per tile
constexpr int TPB = 256;   // 4 threads per row

enum { KV_F32 = 0, KV_BF16 = 1 };

struct Args {
  int B, T, H, Hkv, P, MAXP, D, Dv, G, BT;
  const void* q; int q_bf16;
  const void* k; const void* v; int kv_kind;
  long k_sp, k_sh, v_sp, v_sh;
  const int* q_pos; const int* page_pos; const int* table;
  const float* sinks; float scale; int swa; float softcap;
  void* out;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_kv(const void* p, int kind, long i) {
  if (kind == KV_F32) return reinterpret_cast<const float*>(p)[i];
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

template <int DV4>
__global__ void __launch_bounds__(TPB) paged_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, Dv = a.Dv, G = a.G, P = a.P;
  float* Qs = smem;                      // ROWS x (D+1)
  float* Ks = Qs + ROWS * (D + 1);       // BS x (D+1)
  constexpr int DVP = 4 * DV4;           // Dv padded to the instantiation
  float* Vs = Ks + BS * (D + 1);         // BS x DVP, zero past Dv
  float* Ps = Vs + BS * DVP;             // ROWS x (BS+1)
  int* kp_s = reinterpret_cast<int*>(Ps + ROWS * (BS + 1));   // BS positions
  int* pg_s = kp_s + BS;                 // BS pool pages
  int* qlim = pg_s + BS;                 // [max q_pos, min q_pos] of the block

  const int tid = threadIdx.x, r = tid >> 2, l4 = tid & 3;
  const int b = blockIdx.z, hk = blockIdx.y, t0 = blockIdx.x * a.BT;
  const int R = a.BT * G;
  const int t = t0 + r / G, h = hk * G + r % G;
  const bool active = r < R && t < a.T;
  const int qp = active ? a.q_pos[(long)b * a.T + t] : -1;
  const bool cdt_bf16 = a.q_bf16;
  const bool v_bf16 = a.kv_kind == KV_BF16;
  const int S = a.MAXP * P;

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

  for (int s0 = 0; s0 < S; s0 += BS) {
    int vis = 0;
    if (tid < BS) {
      const int s = s0 + tid;
      int kp = -1, pg = 0;
      if (s < S) {
        pg = a.table[(long)b * a.MAXP + s / P];
        pg = pg > 0 ? pg : 0;
        kp = a.page_pos[(long)pg * P + s % P];
      }
      kp_s[tid] = kp;
      pg_s[tid] = pg;
      vis = kp >= 0 && kp <= qmax && (a.swa <= 0 || kp > qmin - a.swa);
    }
    if (!__syncthreads_or(vis)) continue;

    for (int i = tid; i < BS * D; i += TPB) {
      const int j = i / D, dd = i % D, s = s0 + j;
      float val = 0.f;
      if (s < S) {
        val = load_kv(a.k, a.kv_kind, (long)pg_s[j] * a.k_sp + (long)hk * a.k_sh +
                                          (long)(s % P) * D + dd);
        if (cdt_bf16) val = bf16_round(val);
      }
      Ks[j * (D + 1) + dd] = val;
    }
    for (int i = tid; i < BS * DVP; i += TPB) {
      const int j = i / DVP, dd = i % DVP, s = s0 + j;
      Vs[j * DVP + dd] = s < S && dd < Dv ? load_kv(a.v, a.kv_kind, (long)pg_s[j] * a.v_sp +
                                                            (long)hk * a.v_sh +
                                                            (long)(s % P) * Dv + dd)
                              : 0.f;
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
                      sizeof(int) * (2 * BS + 2);
  cudaError_t e = cudaFuncSetAttribute(paged_kernel<DV4>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + a.BT - 1) / a.BT, a.Hkv, a.B);
  paged_kernel<DV4><<<grid, TPB, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// kv_kind: 0 f32, 1 bf16. k_sp/k_sh/v_sp/v_sh are element strides of a page
// and a head in the pools. D <= 256, Dv <= 256, H / Hkv <= 64; copy is the
// decode path's copy mode of the page rows (decode_common.cuh).
// T*G <= 32 takes the cluster kernel with the wrapper's plan (R query rows,
// cl blocks a cluster, nb slots a block, ts slots a tile, nbmax slots a
// pass), larger T*G paged_kernel (the wrapper sends bf16 q over bf16 pages
// there to slt_paged_tc instead). Returns the cudaError_t.
extern "C" int slt_paged(int B, int T, int H, int Hkv, int P, int MAXP, int D, int Dv,
                         int R, int cl, int nb, int ts, int nbmax, int copy,
                         const void* q, int q_bf16, const void* k, const void* v, int kv_kind,
                         long k_sp, long k_sh, long v_sp, long v_sh,
                         const void* q_pos, const void* page_pos, const void* table,
                         const void* sinks, float scale, int swa, float softcap,
                         void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (T * G <= 32) {
    const int es = kv_kind == KV_F32 ? 4 : 2;
    decode::Args d{};
    d.B = B; d.T = T; d.H = H; d.Hkv = Hkv; d.D = D; d.Dv = Dv; d.G = G; d.TG = T * G;
    d.R = R; d.n_rt = (T * G + R - 1) / R; d.cl = cl; d.nb = nb; d.ts = ts; d.nbmax = nbmax;
    d.npass = (nb + nbmax - 1) / nbmax; d.n_s = 1; d.bs = MAXP * P; d.S = MAXP * P;
    d.q = q; d.q_bf16 = q_bf16; d.q_pos = (const int*)q_pos;
    d.k = k; d.v = v; d.k_sb = k_sp; d.k_sh = k_sh; d.v_sb = v_sp; d.v_sh = v_sh;
    d.krow = D * es; d.vrow = Dv * es; d.copy = copy;
    d.page_pos = (const int*)page_pos; d.table = (const int*)table; d.P = P; d.MAXP = MAXP;
    d.sinks = (const float*)sinks; d.scale = scale; d.swa = swa; d.softcap = softcap;
    d.out = out;
    const cudaError_t e = kv_kind == KV_F32 ? decode::launch<decode::KIND_F32, true>(d, st)
                                            : decode::launch<decode::KIND_BF16, true>(d, st);
    return (int)e;
  }
  Args a{B, T, H, Hkv, P, MAXP, D, Dv, G, ROWS / G, q, q_bf16, k, v, kv_kind,
         k_sp, k_sh, v_sp, v_sh, (const int*)q_pos, (const int*)page_pos,
         (const int*)table, (const float*)sinks, scale, swa, softcap, out};
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

// The tensor-core prefill kernel: bf16 q over bf16 pages. q_copy / kv_copy:
// copy modes of q's rows and of the pools' rows (0 16-byte, 1 4-byte, 2
// bytes; copy_mode in ops/flash_attention.py); k_sp/k_sh/v_sp/v_sh element
// strides of a page and a head. bs, n_rt and smem are paged_plan's slots a
// tile, row tiles and shared-memory bytes: a launch that disagrees with the
// kernel's own layout is refused. split (1 or 2) blocks of a cluster share a
// row tile's visible tiles. Returns the cudaError_t.
extern "C" int slt_paged_tc(int B, int T, int H, int Hkv, int P, int MAXP, int D, int Dv,
                            const void* q, int q_copy, const void* k, const void* v, int kv_copy,
                            long k_sp, long k_sh, long v_sp, long v_sh, const void* q_pos,
                            const void* page_pos, const void* table, const void* sinks,
                            float scale, int swa, float softcap, int bs, int n_rt, int smem,
                            int split, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || Hkv < 1 || H % Hkv || H / Hkv > tc::ROWS ||
      P < 1 || MAXP < 1)
    return (int)cudaErrorInvalidValue;
  const int S = MAXP * P;
  const tc::Layout L = tc::make_layout(D, Dv, S, false, MAXP);
  const int G = H / Hkv, BT = tc::ROWS / G;
  if (bs != L.bs || smem != L.bytes || n_rt != (T + BT - 1) / BT || (split != 1 && split != 2))
    return (int)cudaErrorInvalidValue;
  tc::Args a{B, T, H, Hkv, S, D, Dv, G, BT, n_rt, (S + L.bs - 1) / L.bs,
             (const unsigned char*)q, q_copy, (const unsigned char*)k,
             (const unsigned char*)v, kv_copy, k_sp, k_sh, v_sp, v_sh, nullptr, nullptr, 0, 0,
             (const int*)q_pos, (const int*)page_pos, 0, (const float*)sinks, scale, swa,
             softcap, (__nv_bfloat16*)out, L, (const int*)table, P, MAXP};
  const int dm = tc::up16(D) > tc::up16(Dv) ? tc::up16(D) : tc::up16(Dv);
  cudaError_t e;
  if (dm <= 64)
    e = split == 2 ? tc::launch<64, 64, false, true, 2>(a, st)
                   : tc::launch<64, 64, false, true>(a, st);
  else if (dm <= 128)
    e = split == 2 ? tc::launch<128, 64, false, true, 2>(a, st)
                   : tc::launch<128, 64, false, true>(a, st);
  else
    e = split == 2 ? tc::launch<256, 32, false, true, 2>(a, st)
                   : tc::launch<256, 32, false, true>(a, st);
  return (int)e;
}
