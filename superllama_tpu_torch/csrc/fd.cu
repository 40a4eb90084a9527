// fd: split-KV flash decode over a float, Q8_0 or Q4_0 KV cache.
//
// Replaces the TPU kernel _fd_kernel (superllama_tpu/ops/flash_attention.py:326,
// wrapper flash_decode_attention). Decode shapes: few query rows (T*G) per kv
// head against a long cache, so the work is split across the cache: one block
// per (chunk of block_s slots, kv head, batch row, tile of query rows) writes
// its partial (m, l, acc) per query row, and a second kernel combines the
// chunks (the TPU kernel carried them across its sequential grid instead).
//
// Three modes, each with the TPU kernel's arithmetic:
//  - f:  float K/V; the dot runs in bf16 when q is bf16 (K rounded to bf16),
//        else in f32; p is rounded to V's type before P.V.
//  - q8: int8 codes with per-slot f32 scales. q is quantized per row to int8
//        (amax / 127, round half to even); logits = int dot * (qs * scale) * ks.
//        p * vs is quantized to int8 per query row over the whole chunk
//        (pmax / 127) and dotted with the V codes in int32, times pmax / 127.
//        That quantization depends on how slots are grouped, so one block
//        owns one block_s chunk whole.
//  - q4: nibble-packed codes (byte j: element 2j low nibble, 2j+1 high), one
//        f32 scale per 32-group; K and V dequantize to bf16 as
//        bf16((c - 8) * bf16(scale)), q is rounded to bf16, dots in f32.
// Masking is the positional -1e9 penalty of fa (never -inf); sinks enter the
// combine as m = sink, l = 1, and each chunk's max includes the sink so a
// single chunk computes exactly the TPU kernel's probabilities; logit softcap.
// A chunk that no row of the batch row can see (the TPU kernel's tile skip)
// writes m = -1e30, l = 0, acc = 0.
//
// What bounds it on the H100: bytes. At B 8, S 2048, 8 kv heads, D 128 the
// cache is 34.6 MB in Q8_0 (0.010 ms at 3.35 TB/s) and the arithmetic is
// small. This simple version keeps a chunk's logits in shared memory (so K
// is read once), dots on the CUDA cores from shared-memory tiles of 64
// slots, and leaves tensor cores and a finer split for later.
//
// Layout: q (B,T,H,D) contiguous; k (B,Hkv,S,Dk), v (B,Hkv,S,Dvk) rows
// contiguous with caller-given batch/head strides (Dk = D, or D/2 bytes in
// q4); scales (B,Hkv,S) in q8 or (B,Hkv,S,D/32) in q4 with contiguous slots;
// part (B,Hkv,n_s,T*G,Dv+2) f32 scratch; out (B,T,H,Dv) in q's type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <type_traits>

namespace {

constexpr int TPB = 256;
constexpr int NWARP = TPB / 32;
constexpr int BS = 64;             // slots per shared-memory tile
constexpr int MAX_OUT = 32;        // outputs per thread: R * Dv <= 32 * 256
constexpr int BIG = 1 << 30;
constexpr size_t SMEM_LIMIT = 227 * 1024;

enum { MODE_F = 0, MODE_Q8 = 1, MODE_Q4 = 2 };
enum { KV_F32 = 0, KV_BF16 = 1 };

struct Args {
  int B, T, H, Hkv, S, D, Dv, G, TG, bs, n_s, R, n_rt;
  const void* q; int q_bf16;
  const void* k; const void* v; int kv_kind;
  long k_sb, k_sh, v_sb, v_sh;
  const float* k_scale; const float* v_scale; long ks_sb, ks_sh, vs_sb, vs_sh;
  const int* q_pos; const int* kv_pos; long kvpos_sb;
  const float* sinks; float scale; int swa; float softcap;
  float* part; void* out;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// element d of the cache row starting at element offset off, as the mode's
// dot operand: f32 value (bf16-rounded on request), int8 code, or the bf16
// q4 dequant with the row's 32-group scales gs
template <int MODE>
__device__ __forceinline__ float kv_elem(const void* base, int kind, long off, int d,
                                         const float* gs, bool round_bf16) {
  if (MODE == MODE_Q8) return (float)reinterpret_cast<const int8_t*>(base)[off + d];
  if (MODE == MODE_Q4) {
    const uint8_t byte = reinterpret_cast<const uint8_t*>(base)[off + d / 2];
    const int c = (d & 1) ? (byte >> 4) : (byte & 15);
    return bf16r((float)(c - 8) * bf16r(gs[d / 32]));
  }
  const float x = kind == KV_F32
      ? reinterpret_cast<const float*>(base)[off + d]
      : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[off + d]);
  return round_bf16 ? bf16r(x) : x;
}

template <int MODE>
__global__ void __launch_bounds__(TPB) fd_chunk(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, Dv = a.Dv, R = a.R, DP = D + 1;
  const int TW = DP > Dv ? DP : Dv;
  float* Qs = smem;                                   // R x (D+1)
  float* Ts = Qs + R * DP;                            // BS x TW: a K or V tile
  float* Ls = Ts + BS * TW;                           // R x bs: logits, then p
  float* m_s = Ls + (size_t)R * a.bs;                 // R: chunk max
  float* l_s = m_s + R;                               // R: sum of p
  float* x_s = l_s + R;                               // R: q8 pmax
  float* qs_s = x_s + R;                              // R: q8 qs * scale
  int* qp_s = reinterpret_cast<int*>(qs_s + R);       // R: query positions
  int* kp_s = qp_s + R;                               // bs: slot positions
  __shared__ int red[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x % a.n_s, rt = blockIdx.x / a.n_s;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int s0 = c * a.bs, n = min(a.bs, a.S - s0);
  const int r0 = rt * R, nr = min(R, a.TG - r0);
  const int G = a.G;
  float* part = a.part + ((((long)b * a.Hkv + hk) * a.n_s + c) * a.TG + r0) * (Dv + 2);

  // visibility of the chunk to any query row of batch row b
  int qmax = INT_MIN, qmin = BIG;
  for (int t = 0; t < a.T; ++t) {
    const int qp = a.q_pos[(long)b * a.T + t];
    qmax = max(qmax, qp);
    if (qp >= 0) qmin = min(qmin, qp);
  }
  if (tid == 0) { red[0] = BIG; red[1] = -BIG; }
  if (tid < nr) qp_s[tid] = a.q_pos[(long)b * a.T + (r0 + tid) / G];
  __syncthreads();
  int lmin = BIG, lmax = -BIG;
  for (int j = tid; j < n; j += TPB) {
    const int kp = a.kv_pos[(long)b * a.kvpos_sb + s0 + j];
    kp_s[j] = kp;
    if (kp >= 0) { lmin = min(lmin, kp); lmax = max(lmax, kp); }
  }
  atomicMin(&red[0], lmin);
  atomicMax(&red[1], lmax);
  __syncthreads();
  bool vis = red[0] <= qmax;
  if (a.swa > 0) vis = vis && red[1] > qmin - a.swa;
  if (!vis) {
    for (int i = tid; i < nr * (Dv + 2); i += TPB) {
      const int j = i % (Dv + 2);
      part[i] = j == 0 ? -1e30f : 0.f;
    }
    return;
  }

  // query rows (t, g) of this tile, as the mode's dot operand
  for (int i = tid; i < R * D; i += TPB) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r < nr) {
      const int rg = r0 + r;
      const long qi = (((long)b * a.T + rg / G) * a.H + hk * G + rg % G) * D + d;
      val = a.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.q)[qi])
                     : reinterpret_cast<const float*>(a.q)[qi];
      if (MODE == MODE_Q4) val = bf16r(val);
    }
    Qs[r * DP + d] = val;
  }
  __syncthreads();
  if (MODE == MODE_Q8) {
    for (int r = warp; r < R; r += NWARP) {
      float am = 0.f;
      for (int d = lane; d < D; d += 32) am = fmaxf(am, fabsf(Qs[r * DP + d]));
      am = warp_max(am);
      const float inv = am > 0.f ? 127.f / am : 0.f;
      for (int d = lane; d < D; d += 32) Qs[r * DP + d] = rintf(Qs[r * DP + d] * inv);
      if (lane == 0) qs_s[r] = (am / 127.f) * a.scale;
    }
    __syncthreads();
  }

  const long kb = (long)b * a.k_sb + (long)hk * a.k_sh;
  const long vb = (long)b * a.v_sb + (long)hk * a.v_sh;
  const float* ksb = a.k_scale + (MODE != MODE_F ? (long)b * a.ks_sb + (long)hk * a.ks_sh : 0);
  const float* vsb = a.v_scale + (MODE != MODE_F ? (long)b * a.vs_sb + (long)hk * a.vs_sh : 0);
  const bool k_round = MODE == MODE_F && a.q_bf16 && a.kv_kind == KV_F32;
  const int kw = MODE == MODE_Q4 ? D / 2 : D, vw = MODE == MODE_Q4 ? Dv / 2 : Dv;

  // pass 1: logits of the chunk into shared memory
  for (int j0 = 0; j0 < n; j0 += BS) {
    const int nj = min(BS, n - j0);
    for (int i = tid; i < BS * D; i += TPB) {
      const int j = i / D, d = i % D;
      float val = 0.f;
      if (j < nj) {
        const long s = s0 + j0 + j;
        val = kv_elem<MODE>(a.k, a.kv_kind, kb + s * kw, d,
                            MODE == MODE_Q4 ? ksb + s * (D / 32) : nullptr, k_round);
      }
      Ts[j * DP + d] = val;
    }
    __syncthreads();
    for (int i = tid; i < R * BS; i += TPB) {
      const int r = i / BS, j = i % BS;
      if (r >= nr || j >= nj) continue;
      const float* qr = Qs + r * DP;
      const float* kr = Ts + j * DP;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float x = MODE == MODE_Q8 ? dot * qs_s[r] * ksb[s0 + j0 + j] : dot * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      const float qpf = (float)qp_s[r], kpf = (float)kp_s[j0 + j];
      float pen = fminf(0.f, qpf - kpf) + fminf(0.f, kpf);
      if (a.swa > 0) pen += fminf(0.f, kpf - qpf + (float)a.swa - 1.f);
      Ls[(size_t)r * a.bs + j0 + j] = x + pen * 1e9f;
    }
    __syncthreads();
  }

  // pass 2: per row max (with the sink), p, its sum; q8 quantizes p * vs
  const bool p_bf16 = MODE == MODE_Q4 || (MODE == MODE_F && a.kv_kind == KV_BF16);
  for (int r = warp; r < nr; r += NWARP) {
    float* lr = Ls + (size_t)r * a.bs;
    float mx = -3.402823466e38f;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, lr[j]);
    mx = warp_max(mx);
    if (a.sinks != nullptr) mx = fmaxf(mx, a.sinks[hk * G + (r0 + r) % G]);
    float sum = 0.f, pm = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(lr[j] - mx);
      lr[j] = p;
      sum += p;
      if (MODE == MODE_Q8) pm = fmaxf(pm, fabsf(p * vsb[s0 + j]));
    }
    sum = warp_sum(sum);
    if (MODE == MODE_Q8) {
      pm = warp_max(pm);
      const float inv = pm > 0.f ? 127.f / pm : 0.f;
      for (int j = lane; j < n; j += 32) lr[j] = rintf(lr[j] * vsb[s0 + j] * inv);
    } else if (p_bf16) {
      for (int j = lane; j < n; j += 32) lr[j] = bf16r(lr[j]);
    }
    if (lane == 0) { m_s[r] = mx; l_s[r] = sum; x_s[r] = pm; }
  }
  __syncthreads();

  // pass 3: P.V over tiles of V; integer sums in q8
  using Acc = typename std::conditional<MODE == MODE_Q8, int, float>::type;
  Acc acc[MAX_OUT];
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) acc[o] = 0;
  const int nout = (R * Dv + TPB - 1) / TPB;
  for (int j0 = 0; j0 < n; j0 += BS) {
    const int nj = min(BS, n - j0);
    for (int i = tid; i < BS * Dv; i += TPB) {
      const int j = i / Dv, d = i % Dv;
      float val = 0.f;
      if (j < nj) {
        const long s = s0 + j0 + j;
        val = kv_elem<MODE>(a.v, a.kv_kind, vb + s * vw, d,
                            MODE == MODE_Q4 ? vsb + s * (Dv / 32) : nullptr, false);
      }
      Ts[j * Dv + d] = val;
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o) {
      if (o >= nout) break;
      const int idx = tid + TPB * o, r = idx / Dv, cc = idx % Dv;
      if (r >= nr) continue;
      const float* pr = Ls + (size_t)r * a.bs + j0;
      if (MODE == MODE_Q8) {
        int s = 0;
        for (int j = 0; j < nj; ++j) s += __float2int_rn(pr[j]) * __float2int_rn(Ts[j * Dv + cc]);
        acc[o] += s;
      } else {
        float s = 0.f;
        for (int j = 0; j < nj; ++j) s = fmaf(pr[j], Ts[j * Dv + cc], s);
        acc[o] += s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) {
    if (o >= nout) break;
    const int idx = tid + TPB * o, r = idx / Dv, cc = idx % Dv;
    if (r >= nr) continue;
    part[r * (Dv + 2) + 2 + cc] =
        MODE == MODE_Q8 ? (float)acc[o] * (x_s[r] / 127.f) : (float)acc[o];
  }
  if (tid < nr) {
    part[tid * (Dv + 2)] = m_s[tid];
    part[tid * (Dv + 2) + 1] = l_s[tid];
  }
}

// one block per output row (b, t, h): combine the chunks' (m, l, acc)
__global__ void fd_combine(Args a) {
  const int row = blockIdx.x;
  const int h = row % a.H, t = (row / a.H) % a.T, b = row / (a.H * a.T);
  const int hk = h / a.G, rg = t * a.G + h % a.G, Dv = a.Dv;
  const long cs = (long)a.TG * (Dv + 2);
  const float* p = a.part + (((long)b * a.Hkv + hk) * a.n_s * a.TG + rg) * (Dv + 2);
  const bool sk = a.sinks != nullptr;
  float M = sk ? a.sinks[h] : -1e30f;
  for (int c = 0; c < a.n_s; ++c) M = fmaxf(M, p[c * cs]);
  float l = sk ? expf(a.sinks[h] - M) : 0.f;
  for (int c = 0; c < a.n_s; ++c) l = __fadd_rn(l, __fmul_rn(p[c * cs + 1], expf(p[c * cs] - M)));
  const float denom = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < Dv; d += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < a.n_s; ++c)
      acc = __fadd_rn(acc, __fmul_rn(p[c * cs + 2 + d], expf(p[c * cs] - M)));
    const float val = acc / denom;
    const long o = (long)row * Dv + d;
    if (a.q_bf16) reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(val);
    else reinterpret_cast<float*>(a.out)[o] = val;
  }
}

size_t smem_bytes(const Args& a, int R) {
  const int DP = a.D + 1, TW = DP > a.Dv ? DP : a.Dv;
  return sizeof(float) * ((size_t)R * DP + (size_t)BS * TW + (size_t)R * a.bs + 4 * (size_t)R) +
         sizeof(int) * ((size_t)R + a.bs);
}

template <int MODE>
cudaError_t launch(Args a, cudaStream_t st) {
  int R = a.TG < 32 ? a.TG : 32;
  while (R > 1 && smem_bytes(a, R) > SMEM_LIMIT) R = (R + 1) / 2;
  const size_t smem = smem_bytes(a, R);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  a.R = R;
  a.n_rt = (a.TG + R - 1) / R;
  cudaError_t e = cudaFuncSetAttribute(fd_chunk<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fd_chunk<MODE><<<dim3(a.n_s * a.n_rt, a.Hkv, a.B), TPB, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fd_combine<<<a.B * a.T * a.H, a.Dv < 128 ? a.Dv : 128, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 f (kv_kind 0 f32 / 1 bf16), 1 q8, 2 q4. Strides are in elements of
// the tensor's type (bytes for the int8/uint8 codes). D, Dv <= 256 (and
// multiples of 32 in q4). part holds B*Hkv*n_s*T*G*(Dv+2) floats, n_s =
// ceil(S / bs). Returns the cudaError_t of the launches.
extern "C" int slt_fd(int B, int T, int H, int Hkv, int S, int D, int Dv, int bs, int mode,
                      const void* q, int q_bf16, const void* k, const void* v, int kv_kind,
                      long k_sb, long k_sh, long v_sb, long v_sh,
                      const void* k_scale, const void* v_scale,
                      long ks_sb, long ks_sh, long vs_sb, long vs_sh,
                      const void* q_pos, const void* kv_pos, long kvpos_sb,
                      const void* sinks, float scale, int swa, float softcap,
                      void* part, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  Args a{B, T, H, Hkv, S, D, Dv, G, T * G, bs, (S + bs - 1) / bs, 0, 0,
         q, q_bf16, k, v, kv_kind, k_sb, k_sh, v_sb, v_sh,
         (const float*)k_scale, (const float*)v_scale, ks_sb, ks_sh, vs_sb, vs_sh,
         (const int*)q_pos, (const int*)kv_pos, kvpos_sb, (const float*)sinks,
         scale, swa, softcap, (float*)part, out};
  cudaError_t e;
  switch (mode) {
    case MODE_F: e = launch<MODE_F>(a, st); break;
    case MODE_Q8: e = launch<MODE_Q8>(a, st); break;
    case MODE_Q4: e = launch<MODE_Q4>(a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
