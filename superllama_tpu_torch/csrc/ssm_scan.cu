// ssm_scan: the selective scan of the Mamba-1, Mamba-2 and PLaMo-2 mixers.
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as a
// jax.lax.scan of a step function (superllama_tpu/models/mamba.py:73 mamba1,
// :134 mamba2, :197 plamo2), which XLA lowers to a loop of its own. On the
// card a Python loop over T costs several launches a token a layer, and
// every decode block and prompt chunk is captured as a CUDA graph, so the
// port runs the recurrence as one kernel (llama.cpp's ggml_ssm_scan is one
// too).
//
// One form covers the three mixers: the state is (B, nh, hd, ds) and, for
// each row b, head h, channel p and state s, at each step t:
//
//   dA  = exp(dt[b,t,h] * A[h,s])   (mamba1: nh = d_inner, hd = 1, A (nh, ds))
//       = exp(dt[b,t,h] * A[h])     (mamba2, plamo2: a scalar decay a head)
//   st  = st * dA + (dt[b,t,h] * x[b,t,h,p]) * B[b,t,g,s]
//   y[b,t,h,p] = sum_s st * C[b,t,g,s]        g = h / (nh / G)
//
// in f32, the state read from and written back to its cache type (f32 or
// bf16, rounded to nearest even as torch's cast rounds); x, dt, A, B, C and y
// f32. The products and sums are rounded one by one (__fmul_rn, __fadd_rn),
// as the plain version's separate tensor ops round them; y's sum over s
// runs in another order than the plain einsum's.
//
// Rows: ``active`` (B int32, or null for all rows) marks the rows whose
// pos[:, 0] >= 0. An inactive row keeps its state (nothing is written) and
// gets y = 0: the JAX engine masks such rows back to their old state after
// the step (cache_policy.mask_rows), and the port, which writes the cache in
// place, does it here.
//
// Threads: a group of LANES threads per state row (b, h, p), each holding
// ns = ds / LANES consecutive states in registers (ns 16 at d_state 16 and
// 128: LANES 1 for mamba1, 8 for Bamba's mamba2), looping over T; the
// group's partial dots meet by XOR shuffles. A block is NT threads of one
// row b (grid (groups * LANES / NT, B)), so an inactive row leaves a whole
// block at once and no warp spans two rows. With ns 16 and 16-byte aligned
// pointers the state and B / C load as 16-byte vectors (VEC).
//
// Capturable and deterministic: the grid depends only on the shapes, there
// are no atomics, and each sum runs in a fixed order, so a replayed graph
// equals the eager call bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;     // threads a block
constexpr int MAXS = 16;    // states a thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 16 consecutive values into f32 registers (VEC: 16-byte loads)
template <bool VEC>
__device__ __forceinline__ void load16(const float* p, float* out, int n) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < MAXS; ++i)
      if (i < n) out[i] = p[i];
  }
}

template <bool VEC>
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out, int n) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        out[8 * i + 2 * j] = f.x;
        out[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MAXS; ++i)
      if (i < n) out[i] = __bfloat162float(p[i]);
  }
}

template <typename ST, bool VEC>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(ST* __restrict__ state, const float* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const int* __restrict__ active, float* __restrict__ y, int T, int nh,
                int hd, int ds, int G, int lanes, int ns, int a_per_state) {
  const int b = blockIdx.y;
  const int tid = blockIdx.x * NT + threadIdx.x;     // thread of this row
  const int n_grp = nh * hd;
  const int grp = tid / lanes;                       // the state row (h, p)
  const int lane = tid % lanes;
  const bool valid = grp < n_grp;                    // the tail still shuffles
  const int gi = valid ? grp : n_grp - 1;
  const int h = gi / hd;
  const int g = h / (nh / G);
  const int s0 = lane * ns;
  const size_t row = (size_t)n_grp;                  // x / y elements a step
  if (active != nullptr && active[b] == 0) {         // uniform over the block
    if (valid && lane == 0)
      for (int t = 0; t < T; ++t) y[((size_t)b * T + t) * row + gi] = 0.f;
    return;
  }
  float st[MAXS], a[MAXS], bv[MAXS], cv[MAXS];
  ST* sp = state + ((size_t)b * n_grp + gi) * ds + s0;
  load16<VEC>(sp, st, ns);
  float a0 = 0.f;
  if (a_per_state)
    load16<VEC>(A + (size_t)h * ds + s0, a, ns);
  else
    a0 = A[h];
  for (int t = 0; t < T; ++t) {
    const size_t bt = (size_t)b * T + t;
    const float dtv = dt[bt * nh + h];
    const float dx = __fmul_rn(dtv, x[bt * row + gi]);
    const size_t bc = (bt * G + g) * ds + s0;
    load16<VEC>(Bm + bc, bv, ns);
    load16<VEC>(Cm + bc, cv, ns);
    const float dA0 = a_per_state ? 0.f : expf(__fmul_rn(dtv, a0));
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < MAXS; ++i) {
      if (i < ns) {
        const float dA = a_per_state ? expf(__fmul_rn(dtv, a[i])) : dA0;
        st[i] = __fadd_rn(__fmul_rn(st[i], dA), __fmul_rn(dx, bv[i]));
        acc = __fadd_rn(acc, __fmul_rn(st[i], cv[i]));
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (valid && lane == 0) y[bt * row + gi] = acc;
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < MAXS; ++i)
      if (i < ns) put(sp + i, st[i]);
  }
}

template <typename ST, bool VEC>
cudaError_t launch(int Bt, int T, int nh, int hd, int ds, int G, int lanes, int ns,
                   int a_per_state, void* state, const float* x, const float* dt,
                   const float* A, const float* Bm, const float* Cm, const int* active,
                   float* y, cudaStream_t st) {
  const long threads = (long)nh * hd * lanes;
  const dim3 grid((unsigned)((threads + NT - 1) / NT), (unsigned)Bt);
  ssm_scan_kernel<ST, VEC><<<grid, NT, 0, st>>>(reinterpret_cast<ST*>(state), x, dt, A, Bm,
                                                Cm, active, y, T, nh, hd, ds, G, lanes, ns,
                                                a_per_state);
  return cudaGetLastError();
}

}  // namespace

// st_kind: 0 f32 state, 1 bf16; a_per_state: 1 for mamba1's A (nh, ds), 0
// for a scalar decay a head; vec: 1 when ns is 16 and every pointer is
// 16-byte aligned. ds = lanes * ns, lanes a power of two <= 32, ns <= 16.
// active: null, or B int32 flags.
extern "C" int slt_ssm_scan(int Bt, int T, int nh, int hd, int ds, int G, int lanes, int ns,
                            int a_per_state, int st_kind, int vec, void* state,
                            const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* active, void* y, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (Bt < 1 || T < 1 || nh < 1 || hd < 1 || G < 1 || nh % G || ns < 1 || ns > MAXS ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || lanes * ns != ds || Bt > 65535 ||
      (vec && ns != MAXS))
    return (int)cudaErrorInvalidValue;
  const float* xf = reinterpret_cast<const float*>(x);
  const float* dtf = reinterpret_cast<const float*>(dt);
  const float* Af = reinterpret_cast<const float*>(A);
  const float* Bf = reinterpret_cast<const float*>(Bm);
  const float* Cf = reinterpret_cast<const float*>(Cm);
  const int* act = reinterpret_cast<const int*>(active);
  float* yf = reinterpret_cast<float*>(y);
#define SLT_SCAN(ST, V) \
  launch<ST, V>(Bt, T, nh, hd, ds, G, lanes, ns, a_per_state, state, xf, dtf, Af, Bf, Cf, act, yf, s)
  if (st_kind == 0) return (int)(vec ? SLT_SCAN(float, true) : SLT_SCAN(float, false));
  if (st_kind == 1)
    return (int)(vec ? SLT_SCAN(__nv_bfloat16, true) : SLT_SCAN(__nv_bfloat16, false));
#undef SLT_SCAN
  return (int)cudaErrorInvalidValue;
}
