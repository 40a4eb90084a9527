// gmm: grouped matrix product, the expert GEMM of a sparse mixture of experts.
//
// Replaces no Pallas kernel: the JAX package's _experts_apply
// (superllama_tpu/models/llama.py:194, :199, :206) calls
// jax.lax.ragged_dot(xs, w, group_sizes, preferred_element_type=f32), which
// XLA lowers to its own grouped matmul. The port needs a kernel of its own
// there: every decode block and prompt chunk is captured as a CUDA graph,
// and a loop of per-expert products needs each expert's row count on the
// host, which a graph cannot read; the dense form computes all E experts,
// E/K times the work (16x for Qwen3-30B-A3B).
//
//   out[r, :] = xs[r, :] @ w[g]      for off[g] <= r < off[g + 1]
//
// xs (R, K) rows sorted by group, w (G, K, N), off (G + 1) int32 on the
// device (off[0] = 0, off[G] = R), out (R, N) f32. Operands bf16 (the
// serving type) or f32; sums in f32. A group of 0 rows writes nothing.
//
// Capturable and deterministic: the grid depends only on R, N, G and the
// tile sizes. Row tile t of the grid finds its group on the device: warp 0
// walks the offsets 32 groups at a time, counting each group's tiles of BM
// rows (a shuffle prefix sum), so tile t is some group's i-th tile or past
// the last tile, and then the block leaves at once. At most ceil(R / BM) +
// min(G, R) row tiles exist. No atomics, no split K: each output element is
// one block's sum in a fixed order, so a replayed graph equals the eager
// call bit for bit.
//
// A block: 128 threads, BM 32 rows of one group by BN 64 columns, K in
// tiles of BK 32 through a ring of NST 3 stages of 16-byte cp.async copies
// (zero-filled past the group's rows and K's end). bf16: mma.sync m16n8k16
// with f32 accumulators, four warps of 32 rows x 16 columns (the second m16
// fragment only when the tile holds more than 16 rows: at decode most
// tiles hold one or two). f32: the CUDA cores, 4 x 4 outputs a thread in
// fmaf, as the plain version's f32 products are not rounded to TF32.
// Without 16-byte alignment (K or N not a multiple of 16 bytes' elements,
// or an unaligned pointer) the same ring is filled by plain loads.
//
// What bounds it on the H100: bytes. At Qwen3-30B-A3B's decode (8 rows x
// top 8 = 64 rows over 128 experts of (2048, 768)) a call reads the banks of
// the experts the rows picked, about 52 on random routing, 3.1 MB each
// (0.049 ms at 3.35 TB/s), for 0.2 GFLOP; a 256-token chunk (2048 rows)
// reads all 128 (403 MB, 0.12 ms) for 6.4 GFLOP (0.0065 ms at 989 TFLOP/s).
// So the design keeps bytes in flight (three stages a block, up to eight
// blocks an SM) and reads every weight element once a column tile; making
// it fast (TMA, wgmma, a persistent tile walk that shares an expert's rows
// across its column tiles) is later work.

#include "ptx.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32, BN = 64, BK = 32, NST = 3, NT = 128;

template <typename T>
struct Tile {
  static constexpr int EPC = 16 / sizeof(T);   // elements a 16-byte copy
  static constexpr int AS = BK + EPC;          // row strides, padded by 16 bytes
  static constexpr int BS = BN + EPC;
  T a[NST][BM][AS];
  T b[NST][BK][BS];
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(ptx::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// stage s <- rows [r0, r1) of xs and w[g], k tile kt, columns [n0, n0 + BN)
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(Tile<T>& sm, int s, const T* __restrict__ xs,
                                          const T* __restrict__ wg, int r0, int r1, int kt,
                                          int n0, int K, int N) {
  constexpr int EPC = Tile<T>::EPC;
  const int k0 = kt * BK;
  if constexpr (VEC) {
    for (int c = threadIdx.x; c < BM * BK / EPC; c += NT) {
      const int r = c / (BK / EPC), k = (c % (BK / EPC)) * EPC;
      const bool ok = r0 + r < r1 && k0 + k < K;
      cp_async16_zfill(&sm.a[s][r][k], ok ? xs + (size_t)(r0 + r) * K + k0 + k : xs,
                       ok ? 16 : 0);
    }
    for (int c = threadIdx.x; c < BK * BN / EPC; c += NT) {
      const int k = c / (BN / EPC), n = (c % (BN / EPC)) * EPC;
      const bool ok = k0 + k < K && n0 + n < N;
      cp_async16_zfill(&sm.b[s][k][n], ok ? wg + (size_t)(k0 + k) * N + n0 + n : wg,
                       ok ? 16 : 0);
    }
  } else {
    const T z = zero<T>();
    for (int e = threadIdx.x; e < BM * BK; e += NT) {
      const int r = e / BK, k = e % BK;
      sm.a[s][r][k] = (r0 + r < r1 && k0 + k < K) ? xs[(size_t)(r0 + r) * K + k0 + k] : z;
    }
    for (int e = threadIdx.x; e < BK * BN; e += NT) {
      const int k = e / BN, n = e % BN;
      sm.b[s][k][n] = (k0 + k < K && n0 + n < N) ? wg[(size_t)(k0 + k) * N + n0 + n] : z;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT) gmm_kernel(const T* __restrict__ xs,
                                                 const T* __restrict__ w,
                                                 const int* __restrict__ off,
                                                 float* __restrict__ out, int K, int N, int G) {
  __shared__ __align__(16) Tile<T> sm;
  __shared__ int s_g, s_r0, s_r1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // which group's which tile of BM rows this block computes
  if (warp == 0) {
    const int t = blockIdx.x;
    int base = 0, g = -1, r0 = 0, r1 = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int gi = g0 + lane;
      int lo = 0, n = 0;
      if (gi < G) {
        lo = off[gi];
        n = off[gi + 1] - lo;
      }
      const int tiles = (n + BM - 1) / BM;
      int inc = tiles;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += v;
      }
      const int excl = base + inc - tiles;
      const unsigned hit = __ballot_sync(0xffffffffu, t >= excl && t < base + inc);
      if (hit) {
        const int src = __ffs(hit) - 1;
        g = __shfl_sync(0xffffffffu, gi, src);
        r0 = __shfl_sync(0xffffffffu, lo + (t - excl) * BM, src);
        r1 = __shfl_sync(0xffffffffu, lo + n, src);
        break;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) {
      s_g = g;
      s_r0 = r0;
      s_r1 = min(r0 + BM, r1);
    }
  }
  __syncthreads();
  const int g = s_g;
  if (g < 0) return;            // past the last tile
  const int r0 = s_r0, r1 = s_r1, rows = r1 - r0;
  const int n0 = blockIdx.y * BN;
  const T* wg = w + (size_t)g * K * N;
  const int nk = (K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nk) load_tile<T, VEC>(sm, s, xs, wg, r0, r1, s, n0, K, N);
    commit();
  }

  if constexpr (sizeof(T) == 2) {
    // bf16: warp w owns columns [w*16, w*16 + 16) of the tile, all 32 rows
    float acc[2][2][4] = {};
    const bool two = rows > 16;
    for (int kt = 0; kt < nk; ++kt) {
      wait_groups<NST - 2>();
      __syncthreads();
      if (kt + NST - 1 < nk)
        load_tile<T, VEC>(sm, (kt + NST - 1) % NST, xs, wg, r0, r1, kt + NST - 1, n0, K, N);
      commit();
      const int s = kt % NST;
      const unsigned short* Bs = reinterpret_cast<const unsigned short*>(&sm.b[s][0][0]);
      const unsigned short* A16 = reinterpret_cast<const unsigned short*>(&sm.a[s][0][0]);
      constexpr int AS = Tile<T>::AS, BS = Tile<T>::BS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t b[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = warp * 16 + nt * 8 + (lane >> 2), k = kk + (lane & 3) * 2;
          b[nt][0] = (uint32_t)Bs[k * BS + n] | ((uint32_t)Bs[(k + 1) * BS + n] << 16);
          b[nt][1] = (uint32_t)Bs[(k + 8) * BS + n] | ((uint32_t)Bs[(k + 9) * BS + n] << 16);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt == 1 && !two) break;
          const int r = mt * 16 + (lane >> 2), c = kk + (lane & 3) * 2;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(A16 + r * AS + c);
          a[1] = *reinterpret_cast<const uint32_t*>(A16 + (r + 8) * AS + c);
          a[2] = *reinterpret_cast<const uint32_t*>(A16 + r * AS + c + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(A16 + (r + 8) * AS + c + 8);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) ptx::mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
    wait_groups<0>();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + (lane >> 2) + h * 8;
          const int n = n0 + warp * 16 + nt * 8 + (lane & 3) * 2;
          if (r >= rows) continue;
          float* o = out + (size_t)(r0 + r) * N + n;
          if (n < N) o[0] = acc[mt][nt][2 * h];
          if (n + 1 < N) o[1] = acc[mt][nt][2 * h + 1];
        }
  } else {
    // f32: thread (ty, tx) owns rows ty*4.. +4 and columns tx*4.. +4
    const int tx = tid & 15, ty = tid >> 4;
    float acc[4][4] = {};
    const bool live = ty * 4 < rows;
    for (int kt = 0; kt < nk; ++kt) {
      wait_groups<NST - 2>();
      __syncthreads();
      if (kt + NST - 1 < nk)
        load_tile<T, VEC>(sm, (kt + NST - 1) % NST, xs, wg, r0, r1, kt + NST - 1, n0, K, N);
      commit();
      const int s = kt % NST;
      if (live) {
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sm.a[s][ty * 4 + i][k];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = sm.b[s][k][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    wait_groups<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N) out[(size_t)(r0 + r) * N + n] = acc[i][j];
      }
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch(int R, int K, int N, int G, const void* xs, const void* w, const int* off,
                   float* out, cudaStream_t st) {
  const long tiles = (R + BM - 1) / BM + (G < R ? G : R);
  const dim3 grid((unsigned)tiles, (unsigned)((N + BN - 1) / BN));
  gmm_kernel<T, VEC><<<grid, NT, 0, st>>>(reinterpret_cast<const T*>(xs),
                                          reinterpret_cast<const T*>(w), off, out, K, N, G);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16; vec: 1 when K and N are multiples of 16 bytes'
// elements and xs, w are 16-byte aligned (the cp.async ring), else 0.
extern "C" int slt_gmm(int R, int K, int N, int G, int dtype, int vec, const void* xs,
                       const void* w, const void* off, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (R < 1 || K < 1 || N < 1 || G < 1 || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const int* o = reinterpret_cast<const int*>(off);
  float* y = reinterpret_cast<float*>(out);
  if (dtype == 1)
    return (int)(vec ? launch<__nv_bfloat16, true>(R, K, N, G, xs, w, o, y, st)
                     : launch<__nv_bfloat16, false>(R, K, N, G, xs, w, o, y, st));
  if (dtype == 0)
    return (int)(vec ? launch<float, true>(R, K, N, G, xs, w, o, y, st)
                     : launch<float, false>(R, K, N, G, xs, w, o, y, st));
  return (int)cudaErrorInvalidValue;
}
