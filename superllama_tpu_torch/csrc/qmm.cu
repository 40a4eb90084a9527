// qmm: fused dequant + matmul over repacked quantized weights (17-32 rows,
// or any M when forced).
//
// Replaces the TPU kernel _qmm_kernel (superllama_tpu/ops/qmatmul.py:94,
// launched by _qmatmul_2d). Codes stay packed in device memory; each weight
// tile is dequantized per group into shared memory,
//   w = (code - offset) * s + a      (s, a from the f32 planes or d*sc, -dmin*mn)
// rounded to the compute type (bf16 when x is bf16, else f32), and multiplied
// into an f32 accumulator. Output in the requested type.
//
// What bounds it on the H100: at M = 32 the product does 64 flops per weight
// element against 0.56-1.06 bytes read, so it sits near the card's balance
// point; this simple version runs the product on the CUDA cores (f32 FMA on
// bf16-exact operands), which makes it compute-bound well above the memory
// bound. The design keeps what the TPU kernel keeps out of device memory (the
// dequantized weight lives only in shared memory); tensor-core wgmma tiles
// are later work. Edges: rows >= M read x = 0, columns >= N read w = 0 and
// are not stored; K is a multiple of the 32-element group, so no k-tile is
// partial.
//
// Weight formats (FMT): 0 = Q8_0, 1 = Q4_K compact, 2 = Q6_K compact.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 32, BN = 64, BK = 32, TPB = 256;

struct Args {
  const void* x; int x_bf16;
  int M, K, N;
  const uint8_t* codes; const uint8_t* hi; const float* scales;
  const uint8_t* sc; const uint8_t* mn; const float* d; const float* dmin;
  void* out; int out_bf16;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int FMT>
__device__ __forceinline__ float dequant(const Args& a, int k, int n) {
  const long N = a.N;
  float q, s, add = 0.f, off = 0.f;
  bool has_add = false;
  if (FMT == 0) {
    q = (float)(int8_t)a.codes[(long)k * N + n];
    s = a.scales[(long)(k / 32) * N + n];
  } else {
    const int e = k % 32, row = (k / 32) * 16 + (e % 16);
    const uint8_t byte = a.codes[(long)row * N + n];
    int code = e < 16 ? (byte & 0x0F) : (byte >> 4);
    if (FMT == 1) {
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

// fmt: 0 Q8_0, 1 Q4_K, 2 Q6_K. x (M, K) f32 or bf16; out (M, N) f32 or bf16.
// Returns the cudaError_t of the launch.
extern "C" int slt_qmm(int fmt, int M, int K, int N, const void* x, int x_bf16,
                       const void* codes, const void* hi, const void* scales,
                       const void* sc, const void* mn, const void* d, const void* dmin,
                       void* out, int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Args a{x, x_bf16, M, K, N, (const uint8_t*)codes, (const uint8_t*)hi,
         (const float*)scales, (const uint8_t*)sc, (const uint8_t*)mn,
         (const float*)d, (const float*)dmin, out, out_bf16};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (fmt == 0) qmm_kernel<0><<<grid, TPB, 0, st>>>(a);
  else if (fmt == 1) qmm_kernel<1><<<grid, TPB, 0, st>>>(a);
  else qmm_kernel<2><<<grid, TPB, 0, st>>>(a);
  return (int)cudaGetLastError();
}
