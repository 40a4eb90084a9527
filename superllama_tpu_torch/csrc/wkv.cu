// wkv: the linear-attention recurrences of RWKV-6 (wkv6), qrwkv (gla),
// RWKV-7 (wkv7) and Qwen3-Next's gated delta net (delta).
//
// Replaces no Pallas kernel: the JAX package runs each recurrence as a
// jax.lax.scan of a step function (superllama_tpu/models/rwkv.py:39 wkv6,
// :58 wkv7, :78 gla; superllama_tpu/models/qwen3next.py:41 delta_net), which
// XLA lowers to a loop of its own. On the card a Python loop over T costs
// several launches a token a layer, and every decode block and prompt chunk
// is captured as a CUDA graph, so the port runs each recurrence as one
// kernel (llama.cpp's ggml_rwkv_wkv6 / wkv7 / gated_linear_attn are one
// each too).
//
// The four share one shape: a (B, H, D, D) state whose vectors evolve
// independently of each other under step vectors shared by the head. For a
// row b, head h, step t and the state vector c:
//
//   wkv6  (S[i=key, j=val], vector = column j, c = j):
//         y_j = sum_i r_i (S_ij + u_i k_i v_j);   S_ij <- w_i S_ij + k_i v_j
//   gla   (column j):  S_ij <- w_i S_ij + k_i v_j;   y_j = sum_i (scale r_i) S_ij
//   wkv7  (S[i=val, j=key], vector = row i, c = i):
//         sa = sum_j a_j S_ij;   S_ij <- w_j S_ij + v_i k_j + sa b_j;
//         y_i = sum_j S_ij r_j
//   delta (S[i=key, j=val], column j; q, k l2-normalised, q / sqrt(D) and
//          sigma(beta) by the wrapper):
//         S <- e^g S;   kv = sum_i k_i S_ij;   d = (v_j - kv) sigma(beta);
//         S_ij += k_i d;   y_j = sum_i q_i S_ij
//
// in f32, the state read from and written back to its cache type (f32, or
// bf16 rounded to nearest even as torch's cast rounds); the step vectors and
// y f32, (B, T, H, D) each, as the JAX functions lay them out.
//
// Rows: ``active`` (B int32, or null for all rows) marks the rows whose
// pos[:, 0] >= 0. An inactive row keeps its state (nothing is written) and
// gets y = 0: the JAX engine masks such rows back after the step
// (cache_policy.mask_rows); the port, which writes the cache in place, does
// it here.
//
// Threads: a group of LANES = D / 16 threads holds one state vector in
// registers across T, 16 values a lane (D 64: 4 lanes, D 128: 8; D <= 16:
// one lane of D); the group's dots meet by XOR shuffles. A block is NT
// threads over NT / LANES vectors of one (b, h) (grid (D / vectors a block,
// H, B)), so an inactive row leaves whole blocks. The step vectors of a
// tile of TT steps are staged once in shared memory by the whole block and
// read by every group. What bounds it: at a decode step the state's bytes
// (read and written once); at a prompt chunk the operations, of which this
// simple form keeps the tensor cores out (ROADMAP §2 holds the chunked
// form).
//
// Capturable and deterministic: the grid depends only on the shapes, there
// are no atomics, and each sum runs in a fixed order, so a replayed graph
// equals the eager call bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;     // threads a block
constexpr int MAXS = 16;    // state values a thread
constexpr int TT = 8;       // steps a staged tile
constexpr int MAXD = 128;   // the largest head size
constexpr int NV = 6;       // step vectors at most (wkv7's r, w, k, v, a, b)

enum Rule { WKV6 = 0, GLA = 1, WKV7 = 2, DELTA = 3 };

// the step vectors each rule reads, in the order the wrapper passes them
__host__ __device__ constexpr int n_vec(int rule) {
  return rule == WKV7 ? 6 : rule == DELTA ? 3 : 4;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Args {
  const float* vec[NV];   // (B, T, H, D) each: wkv6 / gla r k v w; wkv7 r w k v a b; delta q k v
  const float* u;         // wkv6's bonus (H, D)
  const float* g;         // delta's log-decay (B, T, H)
  const float* beta;      // delta's sigma(beta) (B, T, H)
  const int* active;      // (B) or null
  float* y;               // (B, T, H, D)
  int T, H, D, lanes, ns;
  float scale;            // gla's read-out scale
};

__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int RULE, typename ST>
__global__ void __launch_bounds__(NT) wkv_kernel(ST* __restrict__ state, const Args a) {
  __shared__ float sv[n_vec(RULE)][TT][MAXD];
  __shared__ float ssc[2][TT];
  const int b = blockIdx.z, h = blockIdx.y;
  const int T = a.T, H = a.H, D = a.D, lanes = a.lanes, ns = a.ns;
  const int per_block = NT / lanes;
  const int grp = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int col = blockIdx.x * per_block + grp;
  const bool valid = col < D;                       // the tail still shuffles
  const int c = valid ? col : D - 1;
  const int i0 = lane * ns;
  const size_t row_step = (size_t)H * D;            // elements of a (b, t)
  if (a.active != nullptr && a.active[b] == 0) {    // uniform over the block
    if (valid && lane == 0)
      for (int t = 0; t < T; ++t) a.y[((size_t)b * T + t) * row_step + (size_t)h * D + c] = 0.f;
    return;
  }
  // the state vector: a column (stride D) or, for wkv7, a row (contiguous)
  ST* sp = state + ((size_t)b * H + h) * D * D;
  const size_t e0 = RULE == WKV7 ? (size_t)c * D + i0 : (size_t)i0 * D + c;
  const size_t es = RULE == WKV7 ? 1 : (size_t)D;
  float st[MAXS], uu[MAXS];
#pragma unroll
  for (int k = 0; k < MAXS; ++k) {
    st[k] = k < ns ? to_f(sp[e0 + k * es]) : 0.f;
    uu[k] = (RULE == WKV6 && k < ns) ? a.u[(size_t)h * D + i0 + k] : 0.f;
  }
  constexpr int NVR = n_vec(RULE);
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int tn = min(TT, T - t0);
    __syncthreads();                                // the last tile's readers are done
    for (int e = threadIdx.x; e < NVR * tn * D; e += NT) {
      const int v = e / (tn * D), rem = e % (tn * D), tt = rem / D, d = rem % D;
      sv[v][tt][d] = a.vec[v][((size_t)b * T + t0 + tt) * row_step + (size_t)h * D + d];
    }
    if constexpr (RULE == DELTA) {
      if (threadIdx.x < tn) {
        const size_t gi = ((size_t)b * T + t0 + threadIdx.x) * H + h;
        ssc[0][threadIdx.x] = a.g[gi];
        ssc[1][threadIdx.x] = a.beta[gi];
      }
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      float acc = 0.f;
      if constexpr (RULE == WKV6) {
        const float vj = sv[2][tt][c];
#pragma unroll
        for (int k = 0; k < MAXS; ++k) {
          if (k < ns) {
            const int i = i0 + k;
            const float kv = sv[1][tt][i] * vj;
            acc += sv[0][tt][i] * (st[k] + uu[k] * kv);
            st[k] = st[k] * sv[3][tt][i] + kv;
          }
        }
        acc = group_sum(acc, lanes);
      } else if constexpr (RULE == GLA) {
        const float vj = sv[2][tt][c];
#pragma unroll
        for (int k = 0; k < MAXS; ++k) {
          if (k < ns) {
            const int i = i0 + k;
            st[k] = st[k] * sv[3][tt][i] + sv[1][tt][i] * vj;
            acc += (sv[0][tt][i] * a.scale) * st[k];
          }
        }
        acc = group_sum(acc, lanes);
      } else if constexpr (RULE == WKV7) {
        float sa = 0.f;
#pragma unroll
        for (int k = 0; k < MAXS; ++k)
          if (k < ns) sa += sv[4][tt][i0 + k] * st[k];
        sa = group_sum(sa, lanes);
        const float vi = sv[3][tt][c];
#pragma unroll
        for (int k = 0; k < MAXS; ++k) {
          if (k < ns) {
            const int j = i0 + k;
            st[k] = st[k] * sv[1][tt][j] + vi * sv[2][tt][j] + sa * sv[5][tt][j];
            acc += st[k] * sv[0][tt][j];
          }
        }
        acc = group_sum(acc, lanes);
      } else {                                       // DELTA
        const float eg = expf(ssc[0][tt]);
        float kv = 0.f;
#pragma unroll
        for (int k = 0; k < MAXS; ++k) {
          if (k < ns) {
            st[k] *= eg;
            kv += sv[1][tt][i0 + k] * st[k];
          }
        }
        kv = group_sum(kv, lanes);
        const float d = (sv[2][tt][c] - kv) * ssc[1][tt];
#pragma unroll
        for (int k = 0; k < MAXS; ++k) {
          if (k < ns) {
            const int i = i0 + k;
            st[k] += sv[1][tt][i] * d;
            acc += sv[0][tt][i] * st[k];
          }
        }
        acc = group_sum(acc, lanes);
      }
      if (valid && lane == 0)
        a.y[((size_t)b * T + t0 + tt) * row_step + (size_t)h * D + c] = acc;
    }
  }
  if (valid) {
#pragma unroll
    for (int k = 0; k < MAXS; ++k)
      if (k < ns) put(sp + e0 + k * es, st[k]);
  }
}

template <int RULE, typename ST>
cudaError_t launch(int Bt, void* state, const Args& a, cudaStream_t s) {
  const int per_block = NT / a.lanes;
  const dim3 grid((unsigned)((a.D + per_block - 1) / per_block), (unsigned)a.H, (unsigned)Bt);
  wkv_kernel<RULE, ST><<<grid, NT, 0, s>>>(reinterpret_cast<ST*>(state), a);
  return cudaGetLastError();
}

template <typename ST>
cudaError_t dispatch(int rule, int Bt, void* state, const Args& a, cudaStream_t s) {
  switch (rule) {
    case WKV6: return launch<WKV6, ST>(Bt, state, a, s);
    case GLA: return launch<GLA, ST>(Bt, state, a, s);
    case WKV7: return launch<WKV7, ST>(Bt, state, a, s);
    case DELTA: return launch<DELTA, ST>(Bt, state, a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// rule: 0 wkv6, 1 gla, 2 wkv7, 3 delta; st_kind: 0 f32 state, 1 bf16.
// D = lanes * ns: lanes a power of two <= 8 with ns 16, or lanes 1 with
// ns = D <= 16. v0..v5: the rule's step vectors (unused ones null); u
// wkv6's bonus, g / beta delta's scalars, active null or B int32 flags.
extern "C" int slt_wkv(int rule, int st_kind, int Bt, int T, int H, int D, int lanes, int ns,
                       float scale, void* state, const void* v0, const void* v1, const void* v2,
                       const void* v3, const void* v4, const void* v5, const void* u,
                       const void* g, const void* beta, const void* active, void* y,
                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (rule < 0 || rule > 3 || Bt < 1 || Bt > 65535 || T < 1 || H < 1 || H > 65535 || D < 1 ||
      D > MAXD || ns < 1 || ns > MAXS || lanes < 1 || lanes > 8 || (lanes & (lanes - 1)) ||
      lanes * ns != D || (lanes > 1 && ns != MAXS))
    return (int)cudaErrorInvalidValue;
  const void* vs[NV] = {v0, v1, v2, v3, v4, v5};
  Args a;
  for (int i = 0; i < NV; ++i) {
    a.vec[i] = reinterpret_cast<const float*>(vs[i]);
    if (i < n_vec(rule) && vs[i] == nullptr) return (int)cudaErrorInvalidValue;
  }
  a.u = reinterpret_cast<const float*>(u);
  a.g = reinterpret_cast<const float*>(g);
  a.beta = reinterpret_cast<const float*>(beta);
  if ((rule == WKV6 && !u) || (rule == DELTA && (!g || !beta))) return (int)cudaErrorInvalidValue;
  a.active = reinterpret_cast<const int*>(active);
  a.y = reinterpret_cast<float*>(y);
  a.T = T; a.H = H; a.D = D; a.lanes = lanes; a.ns = ns; a.scale = scale;
  if (st_kind == 0) return (int)dispatch<float>(rule, Bt, state, a, s);
  if (st_kind == 1) return (int)dispatch<__nv_bfloat16>(rule, Bt, state, a, s);
  return (int)cudaErrorInvalidValue;
}
