// qmv_probe: four formulations of the Q4_K int8-activation GEMV, M <= 16,
// for the GEMV-variant probe (superllama_tpu_torch/tools/qmv_probe.py).
//
// Replaces the TPU kernels of superllama_tpu/tools/qmv_probe.py:
//   v1  _kern_v1 (:53)  codes unpacked to one [lo||hi] 32-code buffer per
//                       column with 32-bit integer ops, eight __dp4a against
//                       the (G, M, 32) activations;
//   v2  _kern_v2 (:64)  no concat: the 16 raw code bytes of a column are
//                       byte-transposed once, then four __dp4a of the masked
//                       low words against xl and four of the shifted high
//                       words against xh (separate (G, M, 16) planes);
//   v4  _kern_v4 (:78)  v1's concat with the nibble mask done in the 8-bit
//                       lanes of the loaded row words (SWAR & 0x0F0F0F0F,
//                       (w >> 4) & 0x0F0F0F0F), then byte-transposed;
//   v3  _kern_v3 (:91)  v1's dot with a k-split grid: blockIdx.y is a
//                       1024-element K chunk; each chunk writes its reduced
//                       f32 partial (correction included) to (K/1024, M, N)
//                       and a second kernel adds the partials in chunk order,
//                       so the sum does not depend on scheduling (no atomics).
//
// Every variant computes, with s = d*sc, a = -(dmin*mn) per 32-group g,
//   y[m,n] = sum_g (ig[g,m,n]*s[g,n])*sx[m,g] + sum_g xs[m,g]*a[g,n]
// where ig is the exact integer group dot of the int8 activation codes with
// the 4-bit weight codes; the products keep the reference's association
// ((ig*s)*sx, rounded products, no fused multiply-add) and only the order of
// the f32 sums differs. Output f32.
//
// What bounds it on the H100: bytes. Each weight byte is read once and used
// by M <= 16 rows (0.56 bytes per weight for Q4_K with its scale planes),
// far below the card's ops-per-byte balance. Loads follow csrc/qmv.cu: a
// thread owns 4 adjacent columns and reads one 32-bit word per code row,
// sc/mn as 32-bit words (4 columns), d/dmin as float4.
//
// Grid choice. The TPU grid (ceil(N/512),) is 28 blocks at N 14336, which
// would leave most of the 132 SMs idle. Here a block of 256 threads covers
// 64 columns (16 column threads x 4 columns) and splits its K range into 16
// k-slices (one half-warp each, so a half-warp reads 64 contiguous bytes of a
// code row): ceil(N/64) blocks, 224 at N 14336 and 64 at N 4096 for
// v1/v2/v4, times K/1024 for v3 (256 at K = N = 4096). The k-slices are
// summed in a fixed order: the two halves of a warp by one shuffle, then the
// eight warps through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;             // threads per block
constexpr int CT = 16;               // column threads per k-slice (4 columns each)
constexpr int KS = TPB / CT;         // k-slices per block
constexpr int WARPS = TPB / 32;
constexpr int CHUNK_G = 32;          // v3: 32-groups per 1024-element K chunk
constexpr uint32_t LO = 0x0F0F0F0Fu;

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float f4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
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

struct Args {
  const int8_t* xa;     // v1/v3/v4: xg (G, M, 32); v2: xl (G, M, 16)
  const int8_t* xh;     // v2: xh (G, M, 16)
  const float* sx;      // (M, G); v3: (K/1024, M, 32)
  const float* xs;      // as sx
  const uint8_t* codes; const uint8_t* sc; const uint8_t* mn;
  const float* d; const float* dmin;
  int M, K, N;
  float* out;           // (M, N); v3: partials (K/1024, M, N)
};

// One 32-group g of the thread's 4 columns, accumulated into acc for every
// row. V selects the unpack and dot formulation (1, 2 or 4; v3 uses 1).
// sxp/xsp point at row 0's scale and group sum of g, ld is their row stride.
template <int V, int MB>
__device__ __forceinline__ void group_dot(const Args& a, int g, int c0, const float* sxp,
                                          const float* xsp, int ld, float acc[MB][4]) {
  const long N = a.N;
  const float4 d4 = ld4(a.d + (long)(g >> 3) * N + c0);
  const float4 m4 = ld4(a.dmin + (long)(g >> 3) * N + c0);
  const uint32_t sc4 = ld32(a.sc + (long)g * N + c0), mn4 = ld32(a.mn + (long)g * N + c0);
  float s[4], ad[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = __fmul_rn(f4(d4, j), (float)((sc4 >> (8 * j)) & 0xFFu));
    ad[j] = -__fmul_rn(f4(m4, j), (float)((mn4 >> (8 * j)) & 0xFFu));
  }
  uint32_t w[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) w[r] = ld32(a.codes + (long)(g * 16 + r) * N + c0);

  // q[j][0..3]: column j's low-nibble words (elements 0..15), q[j][4..7]: its
  // high-nibble words (elements 16..31), each 4 codes in k-order
  int q[4][8];
  if constexpr (V == 1) {
    // per byte through 32-bit integer ops into the [lo||hi] buffer
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t b = (w[4 * qd + i] >> (8 * j)) & 0xFFu;
          lo |= (b & 0x0Fu) << (8 * i);
          hi |= (b >> 4) << (8 * i);
        }
        q[j][qd] = (int)lo;
        q[j][4 + qd] = (int)hi;
      }
  } else if constexpr (V == 4) {
    // SWAR mask of the row words, then the transpose into [lo||hi]
#pragma unroll
    for (int qd = 0; qd < 4; ++qd) {
      int pl[4], ph[4];
      transpose4(w[4 * qd] & LO, w[4 * qd + 1] & LO, w[4 * qd + 2] & LO, w[4 * qd + 3] & LO, pl);
      transpose4((w[4 * qd] >> 4) & LO, (w[4 * qd + 1] >> 4) & LO, (w[4 * qd + 2] >> 4) & LO,
                 (w[4 * qd + 3] >> 4) & LO, ph);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j][qd] = pl[j];
        q[j][4 + qd] = ph[j];
      }
    }
  } else {
    // v2: one transpose of the raw bytes, masked and shifted after it
#pragma unroll
    for (int qd = 0; qd < 4; ++qd) {
      int t[4];
      transpose4(w[4 * qd], w[4 * qd + 1], w[4 * qd + 2], w[4 * qd + 3], t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j][qd] = (int)((uint32_t)t[j] & LO);
        q[j][4 + qd] = (int)(((uint32_t)t[j] >> 4) & LO);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (m >= a.M) break;
    int xv[8];
    if constexpr (V == 2) {
      const int4 xl = __ldg(reinterpret_cast<const int4*>(a.xa + ((long)g * a.M + m) * 16));
      const int4 xh = __ldg(reinterpret_cast<const int4*>(a.xh + ((long)g * a.M + m) * 16));
      xv[0] = xl.x; xv[1] = xl.y; xv[2] = xl.z; xv[3] = xl.w;
      xv[4] = xh.x; xv[5] = xh.y; xv[6] = xh.z; xv[7] = xh.w;
    } else {
      const int4* xp = reinterpret_cast<const int4*>(a.xa + ((long)g * a.M + m) * 32);
      const int4 x0 = __ldg(xp), x1 = __ldg(xp + 1);
      xv[0] = x0.x; xv[1] = x0.y; xv[2] = x0.z; xv[3] = x0.w;
      xv[4] = x1.x; xv[5] = x1.y; xv[6] = x1.z; xv[7] = x1.w;
    }
    const float sxm = __ldg(sxp + (long)m * ld), xsm = __ldg(xsp + (long)m * ld);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int ig;
      if constexpr (V == 2) {   // dot(x_lo, lo) + dot(x_hi, hi)
        int dl = 0, dh = 0;
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) dl = __dp4a(q[j][qd], xv[qd], dl);
#pragma unroll
        for (int qd = 4; qd < 8; ++qd) dh = __dp4a(q[j][qd], xv[qd], dh);
        ig = dl + dh;
      } else {
        ig = 0;
#pragma unroll
        for (int qd = 0; qd < 8; ++qd) ig = __dp4a(q[j][qd], xv[qd], ig);
      }
      acc[m][j] += __fmul_rn(__fmul_rn((float)ig, s[j]), sxm);
      acc[m][j] += __fmul_rn(xsm, ad[j]);
    }
  }
}

// SPLIT = false: blockIdx.x covers 64 columns over all of K (v1, v2, v4).
// SPLIT = true: blockIdx.y is a 1024-element K chunk (v3), partials out.
template <int V, int MB, bool SPLIT>
__global__ void __launch_bounds__(TPB) probe_kernel(Args a) {
  __shared__ float red[(WARPS - 1) * MB * 4 * CT];
  const int ct = threadIdx.x % CT, ks = threadIdx.x / CT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = (blockIdx.x * CT + ct) * 4;
  const bool valid = c0 < a.N;
  const int G = a.K / 32;

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  if constexpr (SPLIT) {
    const int k = blockIdx.y, g0 = k * CHUNK_G;
    const float* sx3 = a.sx + (long)k * a.M * CHUNK_G;
    const float* xs3 = a.xs + (long)k * a.M * CHUNK_G;
    for (int gi = ks; valid && gi < CHUNK_G; gi += KS)
      group_dot<1, MB>(a, g0 + gi, c0, sx3 + gi, xs3 + gi, CHUNK_G, acc);
  } else {
    for (int g = ks; valid && g < G; g += KS)
      group_dot<V, MB>(a, g, c0, a.sx + g, a.xs + g, G, acc);
  }

  // fixed-order slice sum: the warp's two halves, then warps 0 + 1 + ... + 7
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] += __shfl_xor_sync(0xFFFFFFFFu, acc[m][j], 16);
  if (warp > 0 && lane < CT) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(((warp - 1) * MB + m) * 4 + j) * CT + ct] = acc[m][j];
  }
  __syncthreads();
  if (warp != 0 || lane >= CT || !valid) return;
  const long N = a.N;
  float* dst0 = SPLIT ? a.out + (long)blockIdx.y * a.M * N : a.out;
  for (int m = 0; m < MB && m < a.M; ++m) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int w = 0; w < WARPS - 1; ++w) v += red[((w * MB + m) * 4 + j) * CT + ct];
      o[j] = v;
    }
    *reinterpret_cast<float4*>(dst0 + (long)m * N + c0) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// v3's second pass: out[i] = 0 + part[0][i] + part[1][i] + ... in chunk order.
__global__ void sum_chunks_kernel(const float* __restrict__ part, int n_k, long MN,
                                  float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int k = 0; k < n_k; ++k) v += part[k * MN + i];
  out[i] = v;
}

template <int V, bool SPLIT>
void launch(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.M <= 1) probe_kernel<V, 1, SPLIT><<<grid, TPB, 0, st>>>(a);
  else if (a.M <= 2) probe_kernel<V, 2, SPLIT><<<grid, TPB, 0, st>>>(a);
  else if (a.M <= 4) probe_kernel<V, 4, SPLIT><<<grid, TPB, 0, st>>>(a);
  else if (a.M <= 8) probe_kernel<V, 8, SPLIT><<<grid, TPB, 0, st>>>(a);
  else probe_kernel<V, 16, SPLIT><<<grid, TPB, 0, st>>>(a);
}

Args make_args(int M, int K, int N, const void* xa, const void* xh, const void* sx,
               const void* xs, const void* codes, const void* sc, const void* mn,
               const void* d, const void* dmin, void* out) {
  return Args{(const int8_t*)xa, (const int8_t*)xh, (const float*)sx, (const float*)xs,
              (const uint8_t*)codes, (const uint8_t*)sc, (const uint8_t*)mn,
              (const float*)d, (const float*)dmin, M, K, N, (float*)out};
}

dim3 col_grid(int N, int n_k) { return dim3((N / 4 + CT - 1) / CT, n_k); }

}  // namespace

// The caller (tools/qmv_probe.py) has quantized the activations and laid
// them out; M <= 16, K % 256 == 0, N % 4 == 0. Each entry point returns the
// cudaError_t of its launches.

// xg (K/32, M, 32) int8; sx, xs (M, K/32) f32; out (M, N) f32.
extern "C" int slt_qmv_probe_v1(int M, int K, int N, const void* xg, const void* sx,
                                const void* xs, const void* codes, const void* sc,
                                const void* mn, const void* d, const void* dmin, void* out,
                                void* stream) {
  Args a = make_args(M, K, N, xg, nullptr, sx, xs, codes, sc, mn, d, dmin, out);
  launch<1, false>(a, col_grid(N, 1), reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// xl, xh (K/32, M, 16) int8: the low and high halves of each group.
extern "C" int slt_qmv_probe_v2(int M, int K, int N, const void* xl, const void* xh,
                                const void* sx, const void* xs, const void* codes,
                                const void* sc, const void* mn, const void* d,
                                const void* dmin, void* out, void* stream) {
  Args a = make_args(M, K, N, xl, xh, sx, xs, codes, sc, mn, d, dmin, out);
  launch<2, false>(a, col_grid(N, 1), reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

extern "C" int slt_qmv_probe_v4(int M, int K, int N, const void* xg, const void* sx,
                                const void* xs, const void* codes, const void* sc,
                                const void* mn, const void* d, const void* dmin, void* out,
                                void* stream) {
  Args a = make_args(M, K, N, xg, nullptr, sx, xs, codes, sc, mn, d, dmin, out);
  launch<4, false>(a, col_grid(N, 1), reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K % 1024 == 0; sx3, xs3 (K/1024, M, 32) f32; part (K/1024, M, N) f32
// scratch; out (M, N) f32.
extern "C" int slt_qmv_probe_v3(int M, int K, int N, const void* xg, const void* sx3,
                                const void* xs3, const void* codes, const void* sc,
                                const void* mn, const void* d, const void* dmin, void* part,
                                void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_k = K / (CHUNK_G * 32);
  Args a = make_args(M, K, N, xg, nullptr, sx3, xs3, codes, sc, mn, d, dmin, part);
  launch<1, true>(a, col_grid(N, n_k), st);
  const long MN = (long)M * N;
  sum_chunks_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>((const float*)part, n_k,
                                                                   MN, (float*)out);
  return (int)cudaGetLastError();
}
