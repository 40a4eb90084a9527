// qmv: int8-activation grouped GEMV over repacked quantized weights, M <= 16.
//
// Replaces the TPU kernel _qmv_kernel (superllama_tpu/ops/qmatmul.py:235,
// launched by _qmatmul_mv). It computes
//
//   y[m,n] = sum_g sx[m,g]*s[g,n]*(sum_{k in g} xq[m,k]*q[k,n])
//          + sum_g xs[m,g]*(a[g,n] - offset*s[g,n])
//
// with the activations quantized per weight group exactly as _quantize_acts
// does (inv = 127/amax first, round half to even, xs = sum(xq)*sx). The group
// dots are exact integer arithmetic (__dp4a on packed int8).
//
// What bounds it on the H100: bytes. At decode every weight byte is read once
// and used by M <= 16 rows, far below the card's ops-per-byte balance. The
// design keeps the weight codes packed (0.5 B/weight for Q4_K nibbles) and
// reads each (K, N) row coalesced: a thread owns 4 adjacent columns and loads
// one 32-bit word per code row, so a warp reads 128 contiguous bytes. A
// block of 256 threads is 4 k-slices x 64 column threads; the slices split the
// block's K range and are summed through shared memory in a fixed order. When
// N alone gives too few blocks, the grid also splits K and a second kernel
// sums the f32 partials in split order. The split depends only on (K, N), so
// a row's result does not depend on how many rows share the launch.
//
// Weight formats (FMT): 0 = Q8_0 (int8 codes, f32 scale plane, gs 32),
// 1 = Q4_K compact (nibbles, u8 sc/mn, f32 d/dmin per 256, gs 32),
// 2 = Q6_K compact (nibbles + 2-bit hi plane, i8 sc, f32 d per 256, gs 16,
// offset 32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;      // threads per block
constexpr int KS = 4;         // k-slices per block
constexpr int CT = TPB / KS;  // column threads per slice (4 columns each)

__device__ __forceinline__ float load_x(const void* x, int bf16, long i) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i])
              : reinterpret_cast<const float*>(x)[i];
}

// One thread per (row, group): int8 codes, scale and dequantized group sum.
__global__ void quantize_acts_kernel(const void* __restrict__ x, int x_bf16, int M,
                                     int K, int gs, int8_t* __restrict__ xq,
                                     float* __restrict__ sx, float* __restrict__ xs) {
  const int G = K / gs;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * G) return;
  const long base = (long)(idx / G) * K + (long)(idx % G) * gs;
  float amax = 0.f;
  for (int i = 0; i < gs; ++i) amax = fmaxf(amax, fabsf(load_x(x, x_bf16, base + i)));
  const float s = amax / 127.0f;
  const float inv = amax > 0.f ? 127.0f / amax : 0.f;
  int sum = 0;
  for (int i = 0; i < gs; ++i) {
    const int q = (int)rintf(__fmul_rn(load_x(x, x_bf16, base + i), inv));
    xq[base + i] = (int8_t)q;
    sum += q;
  }
  sx[idx] = s;
  xs[idx] = __fmul_rn((float)sum, s);
}

// 4x4 byte transpose: rows r0..r3 hold 4 columns each; out[j] packs column j
// of the four rows (row 0 in the low byte), the k-order __dp4a expects.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3, int out[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
  out[0] = (int)__byte_perm(t0, t1, 0x5410);
  out[1] = (int)__byte_perm(t0, t1, 0x7632);
  out[2] = (int)__byte_perm(t2, t3, 0x5410);
  out[3] = (int)__byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float f4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

struct Args {
  const int8_t* xq; const float* sx; const float* xs;
  int M, K, N;
  const uint8_t* codes; const uint8_t* hi; const float* scales;
  const uint8_t* sc; const uint8_t* mn; const float* d; const float* dmin;
  int units_per_split;  // 256-element superblocks (K-quants) or 32-groups (Q8_0)
  float* part;          // (n_split, M, N) partial sums, or null
  void* out; int out_bf16;
};

// Accumulate one 32-element code group (packed words p[q][j]: quad q of
// column j) against the activation words of every row.
template <int MB>
__device__ __forceinline__ void dot_rows(const Args& a, int k0, int g_lo, int g_hi,
                                         const int p[8][4], const float s_lo[4],
                                         const float s_hi[4], const float c_lo[4],
                                         const float c_hi[4], bool corr,
                                         float acc[MB][4]) {
  const int G = a.K / (g_lo == g_hi ? 32 : 16);
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (m >= a.M) break;
    const int4* xw = reinterpret_cast<const int4*>(a.xq + (long)m * a.K + k0);
    const int4 x0 = __ldg(xw), x1 = __ldg(xw + 1);
    const int xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float sx_lo = __ldg(a.sx + (long)m * G + g_lo), sx_hi = __ldg(a.sx + (long)m * G + g_hi);
    const float xs_lo = __ldg(a.xs + (long)m * G + g_lo), xs_hi = __ldg(a.xs + (long)m * G + g_hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int d_lo = 0, d_hi = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) d_lo = __dp4a(p[q][j], xv[q], d_lo);
#pragma unroll
      for (int q = 4; q < 8; ++q) d_hi = __dp4a(p[q][j], xv[q], d_hi);
      if (g_lo == g_hi) {   // one 32-group: one scale
        acc[m][j] += (float)(d_lo + d_hi) * (sx_lo * s_lo[j]);
        if (corr) acc[m][j] += xs_lo * c_lo[j];
      } else {              // two 16-groups
        acc[m][j] += (float)d_lo * (sx_lo * s_lo[j]);
        acc[m][j] += (float)d_hi * (sx_hi * s_hi[j]);
        if (corr) acc[m][j] += xs_lo * c_lo[j] + xs_hi * c_hi[j];
      }
    }
  }
}

template <int FMT, int MB>
__global__ void __launch_bounds__(TPB) qmv_kernel(Args a) {
  __shared__ float red[(KS - 1) * MB * 4 * CT];
  const int ct = threadIdx.x % CT, ks = threadIdx.x / CT;
  const int c0 = (blockIdx.x * CT + ct) * 4;
  const bool valid = c0 < a.N;
  const long N = a.N;
  const int n_units = FMT == 0 ? a.K / 32 : a.K / 256;
  const int u0 = blockIdx.y * a.units_per_split;
  const int u1 = min(n_units, u0 + a.units_per_split);

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int u = u0 + ks; valid && u < u1; u += KS) {
    if (FMT == 0) {
      // Q8_0: 32 int8 code rows, f32 scale plane, no adds, offset 0
      const int k0 = u * 32;
      uint32_t w[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) w[r] = ld32(a.codes + (k0 + r) * N + c0);
      int p[8][4];
#pragma unroll
      for (int q = 0; q < 8; ++q) transpose4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3], p[q]);
      const float4 s4 = ld4(a.scales + (long)u * N + c0);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      dot_rows<MB>(a, k0, u, u, p, s, s, s, s, false, acc);
    } else if (FMT == 1) {
      // Q4_K: per 32-group u8 sub-scale/min, f32 d/dmin per superblock
      const float4 d4 = ld4(a.d + (long)u * N + c0), m4 = ld4(a.dmin + (long)u * N + c0);
      for (int gi = 0; gi < 8; ++gi) {
        const int g = u * 8 + gi, k0 = g * 32;
        const uint32_t sc4 = ld32(a.sc + (long)g * N + c0), mn4 = ld32(a.mn + (long)g * N + c0);
        float s[4], c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j] = f4(d4, j) * (float)((sc4 >> (8 * j)) & 0xFF);
          c[j] = -(f4(m4, j) * (float)((mn4 >> (8 * j)) & 0xFF));
        }
        uint32_t w[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) w[r] = ld32(a.codes + (long)(k0 / 2 + r) * N + c0);
        int p[8][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          transpose4(w[4 * q] & 0x0F0F0F0F, w[4 * q + 1] & 0x0F0F0F0F,
                     w[4 * q + 2] & 0x0F0F0F0F, w[4 * q + 3] & 0x0F0F0F0F, p[q]);
          transpose4((w[4 * q] >> 4) & 0x0F0F0F0F, (w[4 * q + 1] >> 4) & 0x0F0F0F0F,
                     (w[4 * q + 2] >> 4) & 0x0F0F0F0F, (w[4 * q + 3] >> 4) & 0x0F0F0F0F,
                     p[4 + q]);
        }
        dot_rows<MB>(a, k0, g, g, p, s, s, c, c, true, acc);
      }
    } else {
      // Q6_K: nibbles + 2-bit hi plane, signed i8 sub-scale per 16-group,
      // codes offset by 32 (folded into the group-sum correction)
      const float4 d4 = ld4(a.d + (long)u * N + c0);
      for (int gi = 0; gi < 8; ++gi) {
        const int k0 = u * 256 + gi * 32, g16 = k0 / 16;
        const uint32_t sl = ld32(a.sc + (long)g16 * N + c0), sh = ld32(a.sc + (long)(g16 + 1) * N + c0);
        float s_lo[4], s_hi[4], c_lo[4], c_hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s_lo[j] = f4(d4, j) * (float)(int8_t)((sl >> (8 * j)) & 0xFF);
          s_hi[j] = f4(d4, j) * (float)(int8_t)((sh >> (8 * j)) & 0xFF);
          c_lo[j] = -32.0f * s_lo[j];
          c_hi[j] = -32.0f * s_hi[j];
        }
        uint32_t w[16], h[8];
#pragma unroll
        for (int r = 0; r < 16; ++r) w[r] = ld32(a.codes + (long)(k0 / 2 + r) * N + c0);
#pragma unroll
        for (int r = 0; r < 8; ++r) h[r] = ld32(a.hi + (long)(k0 / 4 + r) * N + c0);
        int p[8][4];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          uint32_t rows[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * q + i;                       // element of the 32-group
            const uint32_t nib = q < 4 ? (w[e] & 0x0F0F0F0F) : ((w[e - 16] >> 4) & 0x0F0F0F0F);
            const uint32_t hb = (h[e % 8] >> (2 * (e / 8))) & 0x03030303;
            rows[i] = nib | (hb << 4);
          }
          transpose4(rows[0], rows[1], rows[2], rows[3], p[q]);
        }
        dot_rows<MB>(a, k0, g16, g16 + 1, p, s_lo, s_hi, c_lo, c_hi, true, acc);
      }
    }
  }

  // sum the k-slices in a fixed order: slice 0 + 1 + 2 + 3
  if (ks > 0) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(((ks - 1) * MB + m) * 4 + j) * CT + ct] = acc[m][j];
  }
  __syncthreads();
  if (ks != 0 || !valid) return;
  for (int m = 0; m < MB && m < a.M; ++m) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int s = 0; s < KS - 1; ++s) v += red[((s * MB + m) * 4 + j) * CT + ct];
      o[j] = v;
    }
    if (a.part) {
      float* dst = a.part + ((long)blockIdx.y * a.M + m) * N + c0;
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else if (a.out_bf16) {
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(a.out) + (long)m * N + c0;
      for (int j = 0; j < 4; ++j) dst[j] = __float2bfloat16_rn(o[j]);
    } else {
      float* dst = reinterpret_cast<float*>(a.out) + (long)m * N + c0;
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Sum the K-split partials in split order and cast to the output type.
__global__ void reduce_splits_kernel(const float* __restrict__ part, int n_split, long MN,
                                     void* out, int out_bf16) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int s = 0; s < n_split; ++s) v += part[s * MN + i];
  if (out_bf16) reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else reinterpret_cast<float*>(out)[i] = v;
}

template <int FMT>
void launch_fmt(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.M <= 1) qmv_kernel<FMT, 1><<<grid, TPB, 0, st>>>(a);
  else if (a.M <= 2) qmv_kernel<FMT, 2><<<grid, TPB, 0, st>>>(a);
  else if (a.M <= 4) qmv_kernel<FMT, 4><<<grid, TPB, 0, st>>>(a);
  else if (a.M <= 8) qmv_kernel<FMT, 8><<<grid, TPB, 0, st>>>(a);
  else qmv_kernel<FMT, 16><<<grid, TPB, 0, st>>>(a);
}

}  // namespace

// fmt: 0 Q8_0, 1 Q4_K, 2 Q6_K. xq/sx/xs/part are caller-allocated scratch:
// xq (M, K) int8, sx/xs (M, K/gs) f32, part (n_split, M, N) f32 when
// n_split > 1. Returns the cudaError_t of the launches.
extern "C" int slt_qmv(int fmt, int M, int K, int N, const void* x, int x_bf16,
                       void* xq, void* sx, void* xs, const void* codes, const void* hi,
                       const void* scales, const void* sc, const void* mn, const void* d,
                       const void* dmin, int n_split, int units_per_split, void* part,
                       void* out, int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int gs = fmt == 2 ? 16 : 32;
  const int nq = M * (K / gs);
  quantize_acts_kernel<<<(nq + 255) / 256, 256, 0, st>>>(
      x, x_bf16, M, K, gs, (int8_t*)xq, (float*)sx, (float*)xs);
  Args a{(const int8_t*)xq, (const float*)sx, (const float*)xs, M, K, N,
         (const uint8_t*)codes, (const uint8_t*)hi, (const float*)scales,
         (const uint8_t*)sc, (const uint8_t*)mn, (const float*)d, (const float*)dmin,
         units_per_split, n_split > 1 ? (float*)part : nullptr, out, out_bf16};
  dim3 grid((N / 4 + CT - 1) / CT, n_split);
  if (fmt == 0) launch_fmt<0>(a, grid, st);
  else if (fmt == 1) launch_fmt<1>(a, grid, st);
  else launch_fmt<2>(a, grid, st);
  if (n_split > 1) {
    const long MN = (long)M * N;
    reduce_splits_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
        (const float*)part, n_split, MN, out, out_bf16);
  }
  return (int)cudaGetLastError();
}
