// decode_common.cuh: the decode-attention kernel shared by fd.cu and
// paged.cu (few query rows against a long cache), built for the H100.
//
// What bounds decode attention on this card is bytes: at T*G = 4 the dots do
// 4 FLOP per byte of bf16 K/V, far under what the CUDA cores allow. The card
// needs about 2.3 MB of loads outstanding (3.35 TB/s x ~0.7 us) to run at its
// memory rate, about 18 KB per SM. The design follows from that:
//  - A thread block cluster of up to 8 blocks splits one chunk of the cache
//    (fd: a block_s chunk; paged: a batch row's whole page table): block
//    `rank` owns nb consecutive slots. The wrapper's plan (decode_plan in
//    ops/flash_attention.py) picks the cluster size, nb, the tile size and
//    the number of passes, and passes them in: 8 blocks a cluster whenever
//    the chunk holds 8 tiles, so B 8 at S 2048 runs 512 blocks and B 1 64.
//  - Each block streams its K tiles, then its V tiles, through a ring of
//    NST = 3 stages of 8 KB. Thread 0 fills a stage with bulk copies
//    (cp.async.bulk, 16-byte aligned runs of contiguous cache rows: a fd
//    tile is one copy, a paged tile one copy per page it touches) completed
//    on the stage's `full` mbarrier; every warp, done with a stage, arrives
//    on its `empty` mbarrier, and thread 0 refills it NST tiles ahead. No
//    block-wide barrier sits between one tile's load and the next: up to
//    NST x 8 KB per block are in flight, and V's first tiles load while the
//    cluster exchanges the row max.
//  - A tile that no query row of the batch row can see (every slot empty,
//    in the future of all rows, or behind the sliding window) is neither
//    loaded nor computed: its probabilities are exp(-1e9 ...) = 0 exactly for
//    every row that sees some slot, as in the plain version.
//  - Logits of the block's slots stay in shared memory. The cluster takes
//    each row's max over the whole chunk (and the sink) through distributed
//    shared memory (barrier.cluster + map_shared_rank) before any p is
//    formed, so p and its bf16 rounding are the plain version's; in q8 it
//    takes the chunk's pmax of |p * vs| the same way before p is quantized.
//  - After P.V each block leaves its (l, acc) partial in its shared memory;
//    block `rank` then adds the partials of its share of the outputs over
//    the blocks in rank order (q8's are int32 and add exactly) and writes
//    the output itself (fd at n_s = 1, paged), or the chunk's (m, l, acc)
//    for fd_combine (fd at n_s > 1). No float atomics: every reduction runs
//    in a fixed order and two runs give the same bits.
//  - When a block's share of its chunk exceeds what its logits buffer holds
//    (8,192 floats: rows x slots), it runs several passes. paged (its
//    chunk is a whole page-table row) takes each pass's K then V with its
//    own cluster max and rescales its sums between passes (the running max
//    of the TPU kernel's chunks). fd, whose q8 quantization and bf16
//    rounding of p need the whole chunk's max first, takes the K tiles of
//    every pass and leaves their logits in a global workspace (the
//    wrapper's, R x nb floats a block, mostly L2-resident), exchanges the
//    chunk's max (and pmax) once, then reloads each pass's logits and takes
//    its V tiles: the same p as in one pass, at the cost of writing and
//    reading the logits once more. block_s 2048 (the forward's) is one pass
//    at every T*G <= 32.
// Arithmetic (128 threads, 5 blocks an SM): where the dot's operands are
// bf16 or int8 values (bf16 q, q4's bf16 dequant, q8's codes) QK^T and P.V
// run on the tensor cores with mma.sync (m16n8k16 bf16 -> f32, m16n8k32
// s8 -> s32: the products are exact, q8's sums are exact int32); a warp
// takes 8 slots (QK^T) or 8 output columns (P.V) against 16 query rows.
// f32 q and f32 V stay on the CUDA cores: in QK^T 8 lanes share a slot,
// each taking 16-byte units of the K row, reduced with shuffles; in P.V
// each thread owns 4 output columns of one row and walks the tile's slots.
// QK^T leaves raw dots in shared memory; the row pass scales, softcaps and
// masks them. A row that sees no slot of the cache at all has an undefined
// output (its chunk's max then comes from skipped tiles).
//
// Layout of a cache row: krow / vrow bytes, any length (head sizes up to
// 256). In shared memory every row sits at a 16-byte stride, its tail zero,
// and q at the K row's padded width, so the dots read whole 16-byte units.
// The copy mode is the wrapper's (copy_mode in ops/flash_attention.py):
// bulk copies when rows, strides and bases are 16-byte multiples (every
// head size divisible by 8 in bf16, 16 in Q8_0); otherwise the warp that
// issues copies moves the rows itself, 4-byte cp.async when they are 4-byte
// multiples (D 100: 100-byte Q8_0 and 200-byte bf16 rows), bytes when not.
// A second copy path rather than one bulk copy of padded tiles: a tile's
// rows are not 16-byte aligned in the cache, and the compute wants each
// row aligned in shared memory; the odd sizes are not the main path.

#pragma once

#include "ptx.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <type_traits>

namespace decode {

namespace cg = cooperative_groups;
using namespace ptx;

constexpr int NT = 128;                 // threads per block
constexpr int NW = NT / 32;
constexpr int NST = 3;                  // ring stages
constexpr float NEG = -3.0e38f;         // logit of a skipped slot
constexpr int BIG = 1 << 30;

enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_Q8 = 2, KIND_Q4 = 3 };

struct Args {
  int B, T, H, Hkv, D, Dv, G, TG;
  int R, n_rt, cl, nb, ts, nbmax, npass, n_s, bs, S;
  const void* q; int q_bf16;
  const int* q_pos;
  const void* k; const void* v;
  long k_sb, k_sh, v_sb, v_sh;  // fd: batch/head strides; paged: page/head (elements)
  int krow, vrow;               // bytes of one cache row
  const float* k_scale; const float* v_scale; long ks_sb, ks_sh, vs_sb, vs_sh;
  const int* kv_pos; long kvpos_sb;          // fd
  const int* page_pos; const int* table; int P, MAXP;   // paged
  const float* sinks; float scale; int swa; float softcap;
  float* part; void* out;
  int copy;                     // COPY_BULK, COPY_WORDS or COPY_BYTES (the wrapper's copy_mode)
  float* ws;                    // fd at npass > 1: each block's logits, R x nb floats
};

enum { COPY_BULK = 0, COPY_WORDS = 1, COPY_BYTES = 2 };

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// elements of a 16-byte unit of a K row; q rows are held at the K row's
// padded width, ceil(krow / 16) units, so every unit load stays aligned
__host__ __device__ inline int q_stride(const Args& a, int kind) {
  const int epu = kind == KIND_F32 ? 4 : kind == KIND_BF16 ? 8 : kind == KIND_Q4 ? 32 : 16;
  return (int)(align16((size_t)a.krow) / 16) * epu;
}

// byte offsets of the shared-memory regions (host and device agree)
struct Layout {
  size_t ring, stage, mbar, qf, qc, lg, lgs, kp, aux, pages, tiles, rows, part, total;
};

// dq: q's row stride (q_stride; the plain D where rows are 16-byte multiples)
__host__ __device__ inline Layout layout(const Args& a, int kind, int dq) {
  Layout L;
  const int ns = a.nb < a.nbmax ? a.nb : a.nbmax;     // slots of one pass
  const int row = a.krow > a.vrow ? a.krow : a.vrow;
  L.stage = (size_t)a.ts * align16((size_t)row);   // rows at 16-byte strides
  size_t o = 0;
  L.ring = o; o += NST * L.stage;
  L.mbar = o; o += 2 * NST * 8;
  const size_t r16 = (size_t)(a.R + 15) / 16 * 16;   // rows of the mma A operand
  L.qf = o; o = align16(o + (size_t)a.R * dq * 4);
  L.qc = o; o = align16(o + (kind == KIND_Q8 ? r16 * dq : r16 * dq * 2));
  L.lgs = ns + 1;
  L.lg = o; o = align16(o + (size_t)a.R * L.lgs * 4);
  L.kp = o; o = align16(o + (size_t)ns * 4);
  size_t aux = 0;
  if (kind == KIND_Q8) aux = 2 * (size_t)ns * 4;
  if (kind == KIND_Q4) aux = (size_t)ns * (a.D / 32 + a.Dv / 32) * 4;
  L.aux = o; o = align16(o + aux);
  L.pages = o; o = align16(o + (a.P > 0 ? ((size_t)ns / a.P + 2) * 4 : 0));
  L.tiles = o; o = align16(o + ((size_t)ns / a.ts + 2) * 4);
  L.rows = o; o = align16(o + (size_t)a.R * 12 * 4 + 4 * 4);
  L.part = o; o = align16(o + (size_t)a.R * (a.Dv + 1) * 4);
  L.total = o;
  return L;
}

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

// the copy path of rows that are not 16-byte multiples: the 32 lanes of a
// warp copy n rows of `row` bytes (contiguous from src) into shared rows of
// rst = align16(row) bytes, zero-filling each row's tail, so the compute
// reads the same 16-byte-aligned units as after a bulk copy. COPY_WORDS:
// 4-byte cp.async (rows, strides and bases multiples of 4), each lane's
// copies completing on bar through cp.async.mbarrier.arrive (which raises
// the barrier's pending count as it is issued, so the phase cannot complete
// before them); COPY_BYTES: byte loads and stores, visible to the barrier's
// waiters through the arrive that follows the warp's __syncwarp.
__device__ __forceinline__ void copy_rows(unsigned char* dst, const unsigned char* src, int n,
                                          int row, int rst, int mode, int lane) {
  if (mode == COPY_WORDS) {
    const int wpr = rst / 4;
    for (int w = lane; w < n * wpr; w += 32) {
      const int r = w / wpr, c = (w - r * wpr) * 4;
      const bool in = c < row;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst + r * rst + c)),
                   "l"(src + (in ? (long)r * row + c : 0)), "r"(in ? 4 : 0)
                   : "memory");
    }
  } else {
    for (int i = lane; i < n * rst; i += 32) {
      const int r = i / rst, c = i - r * rst;
      dst[r * rst + c] = c < row ? __ldg(src + (long)r * row + c) : (unsigned char)0;
    }
  }
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// one query row's dot with the K row whose lane-held part is kf / ku:
// elements d = (sub + 8k) * EPU + i of 16-byte unit k of this lane
template <int KIND>
struct KUnits {
  static constexpr int EPU = KIND == KIND_F32 ? 4 : KIND == KIND_BF16 ? 8 : KIND == KIND_Q4 ? 32 : 16;
  static constexpr int UPL = KIND == KIND_Q8 ? 2 : 32 / EPU;   // units a lane holds at most
};

// GEN: the general instantiation, with the row copy path and fd's
// multi-pass chunks; the main path's (bulk-copyable rows, one pass a
// chunk) is compiled without them, so they cost its registers nothing
template <int KIND, bool PAGED, bool GEN>
__global__ void __launch_bounds__(NT, 5) decode_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout(a, KIND, GEN ? q_stride(a, KIND) : a.D);
  unsigned char* ring = smem + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.mbar);
  uint64_t* empty = full + NST;
  float* qf = reinterpret_cast<float*>(smem + L.qf);
  int8_t* qc = reinterpret_cast<int8_t*>(smem + L.qc);                  // q8: q codes
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem + L.qc);    // else: bf16 q
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  int* lgi = reinterpret_cast<int*>(lg);
  const int lgs = (int)L.lgs;
  int* kp_s = reinterpret_cast<int*>(smem + L.kp);
  float* aux = reinterpret_cast<float*>(smem + L.aux);
  int* pg_s = reinterpret_cast<int*>(smem + L.pages);
  int* tl = reinterpret_cast<int*>(smem + L.tiles);
  int* qp_s = reinterpret_cast<int*>(smem + L.rows);        // R query positions
  float* qs_s = reinterpret_cast<float*>(qp_s + a.R);       // R: q8 qs * scale
  float* mrun = qs_s + a.R;                                 // R: running max (with the sink)
  float* lrun = mrun + a.R;                                 // R: running sum of p
  float* alpha = lrun + a.R;                                // R: rescale of this pass
  float* pmx = alpha + a.R;                                 // R: q8 chunk pmax
  float* xmax = pmx + a.R;                                  // 2 x R: exchanged row max
  float* xpm = xmax + 2 * a.R;                              // 2 x R: exchanged q8 pmax
  int* misc = reinterpret_cast<int*>(xpm + 2 * a.R);        // qmax, qmin, visible tiles
  float* part_s = reinterpret_cast<float*>(smem + L.part);  // R x (Dv + 1): l, acc

  using KU = KUnits<KIND>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / a.cl;
  const int c = cid % a.n_s, rt = cid / a.n_s;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.G, D = a.D, Dv = a.Dv, R = a.R;
  const int cs0 = c * a.bs, cn = min(a.bs, a.S - cs0);
  const int lo = cs0 + min(rank * a.nb, cn), hi = cs0 + min((rank + 1) * a.nb, cn);
  const int r0 = rt * R, nr = min(R, a.TG - r0);
  const int ns = a.nb < a.nbmax ? a.nb : a.nbmax;
  const long es = KIND == KIND_F32 ? 4 : KIND == KIND_BF16 ? 2 : 1;
  const unsigned char* kbase = reinterpret_cast<const unsigned char*>(a.k) +
      (PAGED ? (long)hk * a.k_sh * es : ((long)b * a.k_sb + (long)hk * a.k_sh) * es);
  const unsigned char* vbase = reinterpret_cast<const unsigned char*>(a.v) +
      (PAGED ? (long)hk * a.v_sh * es : ((long)b * a.v_sb + (long)hk * a.v_sh) * es);
  const bool k_round = KIND == KIND_F32 && a.q_bf16;
  const bool p_bf16 = KIND == KIND_Q4 || KIND == KIND_BF16;
  const int nq = D / 32, nvq = Dv / 32;   // q4 scale groups of a K / V row
  // rows, q's row stride and the output groups of 4 columns, padded in
  // the general instantiation; the main path's rows are 16-byte multiples,
  // where they equal the plain values (kept as parameters, not registers)
  const int UK = GEN ? (a.krow + 15) / 16 : a.krow / 16;   // 16-byte units of a K row
  const int kst = GEN ? (int)align16(a.krow) : a.krow;     // shared row strides
  const int vst = GEN ? (int)align16(a.vrow) : a.vrow;
  const int Dq = GEN ? q_stride(a, KIND) : D;              // zero past D
  const int Dv4 = GEN ? (Dv + 3) / 4 : Dv / 4;

  if (tid == 0) {
    for (int i = 0; i < NST; ++i) { mbar_init(&full[i], 1); mbar_init(&empty[i], NW); }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the batch row's query positions bound the tile skip
  if (warp == 0) {
    int qmax = INT_MIN, qmin = BIG;
    for (int t = lane; t < a.T; t += 32) {
      const int qp = __ldg(a.q_pos + (long)b * a.T + t);
      qmax = max(qmax, qp);
      if (qp >= 0) qmin = min(qmin, qp);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    }
    if (lane == 0) { misc[0] = qmax; misc[1] = qmin; }
  }
  for (int r = tid; r < R; r += NT) {
    qp_s[r] = r < nr ? __ldg(a.q_pos + (long)b * a.T + (r0 + r) / G) : -1;
    mrun[r] = -1e30f;
    lrun[r] = 0.f;
  }
  // query rows (t, g) of this tile as the dot operand
  for (int i0 = 0; i0 < R * Dq; i0 += 4 * NT) {
    float val[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * NT + tid, r = i / Dq, d = i % Dq;
      val[k] = 0.f;
      if (i < R * Dq && r < nr && d < D) {
        const int rg = r0 + r;
        const long qi = (((long)b * a.T + rg / G) * a.H + hk * G + rg % G) * D + d;
        val[k] = a.q_bf16
            ? __bfloat162float(__ldg(reinterpret_cast<const __nv_bfloat16*>(a.q) + qi))
            : __ldg(reinterpret_cast<const float*>(a.q) + qi);
        if (KIND == KIND_Q4) val[k] = bf16r(val[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k * NT + tid < R * Dq) qf[i0 + k * NT + tid] = val[k];
  }
  __syncthreads();
  if constexpr (KIND == KIND_Q8) {
    // q per row to int8: amax / 127, round half to even
    for (int r = warp; r < R; r += NW) {
      float am = 0.f;
      for (int d = lane; d < D; d += 32) am = fmaxf(am, fabsf(qf[r * Dq + d]));
      am = warp_max(am);
      const float inv = am > 0.f ? 127.f / am : 0.f;
      for (int d = lane; d < Dq; d += 32) qc[r * Dq + d] = (int8_t)rintf(qf[r * Dq + d] * inv);
      if (lane == 0) qs_s[r] = (am / 127.f) * a.scale;
    }
  }
  // the tensor cores' A operand: 16-row tiles of q, rows past nr zero
  const int r16 = (R + 15) / 16 * 16;
  if constexpr (KIND == KIND_Q8) {
    for (int i = R * Dq + tid; i < r16 * Dq; i += NT) qc[i] = 0;
  } else {
    for (int i = tid; i < r16 * Dq; i += NT) qb[i] = __float2bfloat16_rn(i < R * Dq ? qf[i] : 0.f);
  }
  // tensor cores where the dot's operands are bf16 or int8 values
  const bool mma_k = (KIND == KIND_Q8 ? D % 32 == 0 : D % 16 == 0) &&
                     (KIND == KIND_Q8 || KIND == KIND_Q4 || a.q_bf16);
  const bool mma_v = nr <= 16 && Dv % 8 == 0 && KIND != KIND_F32;
  const int qmax = misc[0], qmin = misc[1];

  // P.V sums live in part_s (int32 bits in q8): each output group of 4
  // columns of one row belongs to one thread, which adds each tile's sums
  using Acc = typename std::conditional<KIND == KIND_Q8, int, float>::type;
  Acc* acc_s = reinterpret_cast<Acc*>(part_s);
  for (int i = tid; i < R * (Dv + 1); i += NT) acc_s[i] = 0;
  const int ngrp = nr * Dv4;   // output groups of 4 columns (the last may be part past Dv)

  // the tensor cores' A fragments of q (16 rows from m0, head dims kk..)
  constexpr int KSTEP = KIND == KIND_Q8 ? 32 : 16;
  constexpr int AQ = 128 / KSTEP;
  auto afrag = [&](int m0, int kk, uint32_t* af) {
    if constexpr (KIND == KIND_Q8) {
      const int8_t* qa = qc + (m0 + (lane >> 2)) * Dq + kk + (lane & 3) * 4;
      af[0] = *reinterpret_cast<const uint32_t*>(qa);
      af[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * Dq);
      af[2] = *reinterpret_cast<const uint32_t*>(qa + 16);
      af[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * Dq + 16);
    } else {
      const __nv_bfloat16* qa = qb + (m0 + (lane >> 2)) * Dq + kk + (lane & 3) * 2;
      af[0] = *reinterpret_cast<const uint32_t*>(qa);
      af[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * Dq);
      af[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
      af[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * Dq + 8);
    }
  };
  // stale rows of a part-filled stage meet zero p in P.V: keep them finite
  for (int i = tid; i < (int)(NST * L.stage / 16); i += NT)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // fd with a chunk longer than one pass (spill): iterations 0..npass-1
  // take the passes' K tiles and leave their logits in the block's part of
  // a.ws (R x nb floats, mostly L2-resident); one exchange then gives the
  // chunk's row max, and in q8 its pmax, over all of them; iterations
  // npass..2npass-1 reload each pass's logits, form p against that max and
  // take its V tiles. p is then the plain version's, as in one pass. Every
  // other call (paged's long rows included) takes K then V in each pass,
  // with a running max between passes.
  const bool spill = GEN && !PAGED && a.npass > 1;
  float* wsb = spill ? a.ws + (((long)b * a.Hkv + hk) * gridDim.x + blockIdx.x) * (long)R * a.nb
                     : nullptr;
  int g = 0;   // tiles through the ring so far
  for (int it = 0; it < (spill ? 2 : 1) * a.npass; ++it) {
    const int pass = spill && it >= a.npass ? it - a.npass : it;
    const bool do_k = !spill || it < a.npass, do_v = !spill || it >= a.npass;
    const int plo = min(lo + pass * a.nbmax, hi), phi = min(plo + a.nbmax, hi);
    const int np = phi - plo, pp = it & 1;
    const int ntile = (np + a.ts - 1) / a.ts;
    __syncthreads();   // the previous pass is done with lg, kp_s, aux, tl
    int lp0 = 0;
    if (PAGED && np > 0) {
      lp0 = plo / a.P;
      const int npg = (phi - 1) / a.P - lp0 + 1;
      for (int i = tid; i < npg; i += NT) {
        const int pg = __ldg(a.table + (long)b * a.MAXP + lp0 + i);
        pg_s[i] = pg > 0 ? pg : 0;     // absent: the NULL page
      }
    }
    for (int t = tid; t < ntile; t += NT) tl[t] = 0;
    if (do_k) {
      for (int i = tid; i < R * lgs; i += NT) lg[i] = NEG;
    } else {   // spill: this pass's logits back from the workspace
      for (int i = tid; i < R * lgs; i += NT) {
        const int r = i / lgs, j = i - r * lgs;
        lg[i] = r >= nr || j >= np ? NEG : wsb[(long)r * a.nb + (plo - lo) + j];
      }
    }
    __syncthreads();
    // slot positions (and scales) of the pass: every load of a slot is
    // issued before its stores, so they are in flight together
    for (int j = tid; j < np; j += NT) {
      const int s = plo + j;
      int kp;
      if (PAGED) {
        kp = __ldg(a.page_pos + (long)pg_s[s / a.P - lp0] * a.P + s % a.P);
      } else {
        kp = __ldg(a.kv_pos + (long)b * a.kvpos_sb + s);
        if constexpr (KIND == KIND_Q8) {
          const float ks = __ldg(a.k_scale + (long)b * a.ks_sb + (long)hk * a.ks_sh + s);
          const float vs = __ldg(a.v_scale + (long)b * a.vs_sb + (long)hk * a.vs_sh + s);
          aux[j] = ks;
          aux[ns + j] = vs;
        }
        if constexpr (KIND == KIND_Q4) {
          const float* ks = a.k_scale + (long)b * a.ks_sb + (long)hk * a.ks_sh + (long)s * nq;
          const float* vs = a.v_scale + (long)b * a.vs_sb + (long)hk * a.vs_sh + (long)s * nvq;
          float kv[16];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            kv[i] = i < nq ? __ldg(ks + i) : 0.f;
            kv[8 + i] = i < nvq ? __ldg(vs + i) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i < nq) aux[j * (nq + nvq) + i] = bf16r(kv[i]);
            if (i < nvq) aux[j * (nq + nvq) + nq + i] = bf16r(kv[8 + i]);
          }
        }
      }
      kp_s[j] = kp;
      // a tile is loaded when some query row of the batch row sees one of its slots
      if (kp >= 0 && kp <= qmax && (a.swa <= 0 || kp > qmin - a.swa)) tl[j / a.ts] = 1;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int t = 0; t < ntile; ++t)
        if (tl[t]) tl[n++] = t;
      misc[2] = n;
    }
    __syncthreads();
    const int ntl = misc[2];
    const int nk = do_k ? ntl : 0, nv = do_v ? ntl : 0;
    const int g0 = g, gend = g + nk + nv;

    // warp 0: fill the stage of ring tile gs (this iteration's K tiles, then
    // its V tiles) once every warp is done with the stage's previous tile.
    // Rows at 16-byte multiples go in by lane 0's bulk copies (one per
    // contiguous run); other rows by the warp's copy_rows into rows padded
    // to 16 bytes.
    auto issue = [&](int gs) {
      const int st = gs % NST, use = gs / NST;
      if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
      const int qi = gs - g0;
      const bool isv = qi >= nk;
      const int t = tl[isv ? qi - nk : qi];
      const int s0 = plo + t * a.ts, s1 = min(s0 + a.ts, phi);
      const int row = isv ? a.vrow : a.krow;
      unsigned char* dst = ring + st * L.stage;
      if (!GEN || a.copy == COPY_BULK) {   // thread 0 alone
        mbar_expect_tx(&full[st], (uint32_t)((s1 - s0) * row));
        if (PAGED) {
          const unsigned char* base = isv ? vbase : kbase;
          const long pstride = (isv ? a.v_sb : a.k_sb) * es;
          for (int s = s0; s < s1;) {
            const int off = s % a.P, len = min(a.P - off, s1 - s);
            const long pg = pg_s[s / a.P - lp0];
            bulk_copy(dst + (long)(s - s0) * row, base + pg * pstride + (long)off * row,
                      (uint32_t)(len * row), &full[st]);
            s += len;
          }
        } else {
          bulk_copy(dst, (isv ? vbase : kbase) + (long)s0 * row, (uint32_t)((s1 - s0) * row),
                    &full[st]);
        }
        return;
      }
      // the whole of warp 0: rows padded to rst bytes in shared memory
      const int rst = isv ? vst : kst;
      if (PAGED) {
        const unsigned char* base = isv ? vbase : kbase;
        const long pstride = (isv ? a.v_sb : a.k_sb) * es;
        for (int s = s0; s < s1;) {
          const int off = s % a.P, len = min(a.P - off, s1 - s);
          const long pg = pg_s[s / a.P - lp0];
          copy_rows(dst + (long)(s - s0) * rst, base + pg * pstride + (long)off * row, len, row,
                    rst, a.copy, lane);
          s += len;
        }
      } else {
        copy_rows(dst, (isv ? vbase : kbase) + (long)s0 * row, s1 - s0, row, rst, a.copy, lane);
      }
      if (a.copy == COPY_WORDS) cp_async_arrive(&full[st]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[st]);
    };
    // the issuing thread: lane 0 of warp 0 for bulk copies, warp 0 otherwise
    // (evaluated where used: a bool kept across the loops costs the main path a register)
    auto issuer = [&] { return GEN && a.copy != COPY_BULK ? warp == 0 : tid == 0; };
    if (issuer())
      for (int gs = g0; gs < min(g0 + NST, gend); ++gs) issue(gs);

    // QK^T: logits of the visible tiles into lg
    const int grp = tid >> 3, sub = tid & 7;
    uint32_t aq[AQ][4];   // A fragments of query rows 0-15 at D <= 128
#pragma unroll
    for (int s = 0; s < AQ; ++s)
      if (mma_k && s * KSTEP < D && D <= 128) afrag(0, s * KSTEP, aq[s]);
    for (int qi = 0; qi < nk; ++qi) {
      const int gs = g0 + qi, st = gs % NST;
      mbar_wait(&full[st], (gs / NST) & 1);
      __syncwarp();   // converged for mma.sync
      const unsigned char* buf = ring + st * L.stage;
      const int s0 = plo + tl[qi] * a.ts, cnt = min(a.ts, phi - s0), jb = s0 - plo;
      if (mma_k) {
        // warp w takes slots 8w.. of every 32: B = 8 K rows, A = 16 query rows;
        // the raw dots go to lg, the row pass scales and masks them
        for (int n0 = warp * 8; n0 < cnt; n0 += NW * 8) {
          const int nb_ = min(n0 + (lane >> 2), cnt - 1);   // this lane's K row
          const unsigned char* kr = buf + (size_t)nb_ * kst;
          // B fragment of K row nb_ at head dims d0.. (KSTEP apart)
          auto bfrag = [&](int d0, uint32_t* b) {
            if constexpr (KIND == KIND_Q8) {
              b[0] = *reinterpret_cast<const uint32_t*>(kr + d0);
              b[1] = *reinterpret_cast<const uint32_t*>(kr + d0 + 16);
            } else {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int d = d0 + 8 * h;
                if constexpr (KIND == KIND_BF16) {
                  b[h] = *reinterpret_cast<const uint32_t*>(kr + d * 2);
                } else if constexpr (KIND == KIND_F32) {   // K rounded to bf16
                  const float2 f = *reinterpret_cast<const float2*>(kr + d * 4);
                  b[h] = pack_bf16(f.x, f.y);
                } else {   // q4: elements d, d+1 are the nibbles of byte d / 2
                  const uint32_t byte = kr[d >> 1];
                  const float sc = aux[(jb + nb_) * (nq + nvq) + (d >> 5)];
                  b[h] = pack_bf16((float)((int)(byte & 15u) - 8) * sc,
                                   (float)((int)(byte >> 4) - 8) * sc);
                }
              }
            }
          };
          for (int m0 = 0; m0 < nr; m0 += 16) {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            int ci[4] = {0, 0, 0, 0};
            if (m0 == 0 && D <= 128) {
#pragma unroll
              for (int s = 0; s < AQ; ++s) {
                if (s * KSTEP < D) {
                  uint32_t b[2];
                  bfrag(s * KSTEP + (lane & 3) * (KIND == KIND_Q8 ? 4 : 2), b);
                  if constexpr (KIND == KIND_Q8) mma_s8(ci, aq[s], b[0], b[1]);
                  else mma_bf16(c, aq[s], b[0], b[1]);
                }
              }
            } else {
              for (int kk = 0; kk < D; kk += KSTEP) {
                uint32_t af[4], b[2];
                afrag(m0, kk, af);
                bfrag(kk + (lane & 3) * (KIND == KIND_Q8 ? 4 : 2), b);
                if constexpr (KIND == KIND_Q8) mma_s8(ci, af, b[0], b[1]);
                else mma_bf16(c, af, b[0], b[1]);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = m0 + (lane >> 2) + 8 * (e >> 1), j = n0 + (lane & 3) * 2 + (e & 1);
              if (r < nr && j < cnt) lg[r * lgs + jb + j] = KIND == KIND_Q8 ? (float)ci[e] : c[e];
            }
          }
        }
      } else
      for (int j0 = 0; j0 < cnt; j0 += NT / 8) {
        const int j = j0 + grp;
        const bool act = j < cnt;
        const int jp = jb + (act ? j : 0);
        uint4 u[KU::UPL];
#pragma unroll
        for (int k = 0; k < KU::UPL; ++k) {
          const int un = sub + 8 * k;
          u[k] = act && un < UK
                     ? *reinterpret_cast<const uint4*>(buf + (size_t)j * kst + un * 16)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
        // the lane's K elements as the dot operand (not for q8: int8 codes)
        float kf[KIND == KIND_Q8 ? 1 : 32];
        if constexpr (KIND != KIND_Q8) {
#pragma unroll
          for (int k = 0; k < KU::UPL; ++k) {
            const uint32_t w[4] = {u[k].x, u[k].y, u[k].z, u[k].w};
            if constexpr (KIND == KIND_F32) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float x = __uint_as_float(w[i]);
                kf[k * 4 + i] = k_round ? bf16r(x) : x;
              }
            } else if constexpr (KIND == KIND_BF16) {
#pragma unroll
              for (int i = 0; i < 4; ++i) unpack_bf16x2(w[i], kf[k * 8 + 2 * i], kf[k * 8 + 2 * i + 1]);
            } else {   // q4: unit k = 0 is the lane's one 32-group
              const float sc = (act && sub < UK) ? aux[jp * (nq + nvq) + sub] : 0.f;
#pragma unroll
              for (int i = 0; i < 16; ++i) {
                const uint32_t byte = (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
                kf[2 * i] = bf16r((float)((int)(byte & 15u) - 8) * sc);
                kf[2 * i + 1] = bf16r((float)((int)(byte >> 4) - 8) * sc);
              }
            }
          }
        }
        // four query rows at a time: independent sums, shuffles in flight together
        for (int rc = 0; rc < nr; rc += 4) {
          float dot[4] = {0.f, 0.f, 0.f, 0.f};
          int idot[4] = {0, 0, 0, 0};
#pragma unroll
          for (int k = 0; k < KU::UPL; ++k) {
            const int un = sub + 8 * k;
            if (un < UK) {
#pragma unroll
              for (int rr = 0; rr < 4; ++rr) {
                if (rc + rr < nr) {
                  const int r = rc + rr;
                  if constexpr (KIND == KIND_Q8) {
                    const int4 qw = *reinterpret_cast<const int4*>(qc + r * Dq + un * 16);
                    idot[rr] = __dp4a((int)u[k].x, qw.x, idot[rr]);
                    idot[rr] = __dp4a((int)u[k].y, qw.y, idot[rr]);
                    idot[rr] = __dp4a((int)u[k].z, qw.z, idot[rr]);
                    idot[rr] = __dp4a((int)u[k].w, qw.w, idot[rr]);
                  } else {
                    const float4* qv = reinterpret_cast<const float4*>(qf + r * Dq + un * KU::EPU);
#pragma unroll
                    for (int i = 0; i < KU::EPU / 4; ++i) {
                      const float4 qq = qv[i];
                      const float* kk = kf + k * KU::EPU + 4 * i;
                      dot[rr] = fmaf(qq.x, kk[0], dot[rr]);
                      dot[rr] = fmaf(qq.y, kk[1], dot[rr]);
                      dot[rr] = fmaf(qq.z, kk[2], dot[rr]);
                      dot[rr] = fmaf(qq.w, kk[3], dot[rr]);
                    }
                  }
                }
              }
            }
          }
#pragma unroll
          for (int o = 4; o > 0; o >>= 1)
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              if constexpr (KIND == KIND_Q8) idot[rr] += __shfl_xor_sync(0xffffffffu, idot[rr], o);
              else dot[rr] += __shfl_xor_sync(0xffffffffu, dot[rr], o);
            }
          if (sub == 0 && act) {
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              const int r = rc + rr;
              if (r < nr) lg[r * lgs + jp] = KIND == KIND_Q8 ? (float)idot[rr] : dot[rr];
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (issuer() && gs + NST < gend) issue(gs + NST);
    }

    // the chunk's row max over the cluster (and the sink), then p
    __syncthreads();
    for (int r = warp; r < R && do_k; r += NW) {
      float mx = -1e30f;
      if (r < nr) {
        // logits from the raw dots: scale, softcap, the positional penalty
        const float qpf = (float)qp_s[r], sr = KIND == KIND_Q8 ? qs_s[r] : a.scale;
        float* wr = spill ? wsb + (long)r * a.nb + (plo - lo) : nullptr;
        for (int j = lane; j < np; j += 32) {
          const float v = lg[r * lgs + j];
          if (v == NEG) {   // a tile no row sees
            if (spill) wr[j] = NEG;
            continue;
          }
          float x = KIND == KIND_Q8 ? v * sr * aux[j] : v * sr;
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          const float kpf = (float)kp_s[j];
          float pen = fminf(0.f, qpf - kpf) + fminf(0.f, kpf);
          if (a.swa > 0) pen += fminf(0.f, kpf - qpf + (float)a.swa - 1.f);
          x = x + pen * 1e9f;
          lg[r * lgs + j] = x;
          if (spill) wr[j] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = warp_max(mx);
      // spill: the block's max over its passes so far, exchanged after the last
      if (lane == 0) xmax[spill ? r : pp * R + r] = spill && pass > 0 ? fmaxf(xmax[r], mx) : mx;
    }
    if (spill) {
      if (it == a.npass - 1) {
        // the chunk's row max, then the sums of p (and q8's pmax) over every
        // pass's logits; each block's own logits come back from a.ws
        cluster.sync();
        for (int r = tid; r < nr; r += NT) {
          float M = -1e30f;
          for (int k = 0; k < a.cl; ++k) M = fmaxf(M, cluster.map_shared_rank(xmax, k)[r]);
          if (a.sinks != nullptr) M = fmaxf(M, a.sinks[hk * G + (r0 + r) % G]);
          mrun[r] = M;
        }
        __syncthreads();
        for (int r = warp; r < nr; r += NW) {
          const float M = mrun[r];
          float sum = 0.f, pm = 0.f;
          for (int j = lane; j < hi - lo; j += 32) {
            const float p = expf(wsb[(long)r * a.nb + j] - M);
            sum += p;
            if constexpr (KIND == KIND_Q8)
              pm = fmaxf(pm, fabsf(p * __ldg(a.v_scale + (long)b * a.vs_sb + (long)hk * a.vs_sh +
                                            lo + j)));
          }
          sum = warp_sum(sum);
          if (lane == 0) lrun[r] = sum;
          if constexpr (KIND == KIND_Q8) {
            pm = warp_max(pm);
            if (lane == 0) xpm[r] = pm;
          }
        }
        if constexpr (KIND == KIND_Q8) {
          cluster.sync();
          for (int r = tid; r < nr; r += NT) {
            float pm = 0.f;
            for (int k = 0; k < a.cl; ++k) pm = fmaxf(pm, cluster.map_shared_rank(xpm, k)[r]);
            pmx[r] = pm;
          }
        }
      }
      if (!do_v) {
        g = gend;
        continue;
      }
      // p of this pass against the chunk's max, rounded or quantized as in
      // one pass; the sums above already hold it
      __syncthreads();
      for (int r = warp; r < nr; r += NW) {
        const float M = mrun[r];
        const float inv = KIND == KIND_Q8 && pmx[r] > 0.f ? 127.f / pmx[r] : 0.f;
        for (int j = lane; j < np; j += 32) {
          const float p = expf(lg[r * lgs + j] - M);
          if constexpr (KIND == KIND_Q8) lgi[r * lgs + j] = __float2int_rn(rintf(p * aux[ns + j] * inv));
          else lg[r * lgs + j] = p_bf16 ? bf16r(p) : p;
        }
      }
      __syncthreads();
    } else {
      cluster.sync();
      for (int r = tid; r < nr; r += NT) {
        float M = -1e30f;
        for (int k = 0; k < a.cl; ++k) M = fmaxf(M, cluster.map_shared_rank(xmax, k)[pp * R + r]);
        if (a.sinks != nullptr) M = fmaxf(M, a.sinks[hk * G + (r0 + r) % G]);
        const float mn = fmaxf(mrun[r], M);
        alpha[r] = expf(mrun[r] - mn);
        mrun[r] = mn;
      }
      __syncthreads();
      for (int r = warp; r < nr; r += NW) {
        const float M = mrun[r];
        float sum = 0.f, pm = 0.f;
        for (int j = lane; j < np; j += 32) {
          const float p = expf(lg[r * lgs + j] - M);
          lg[r * lgs + j] = p;
          sum += p;
          if (KIND == KIND_Q8) pm = fmaxf(pm, fabsf(p * aux[ns + j]));
        }
        sum = warp_sum(sum);
        if constexpr (KIND == KIND_Q8) {
          pm = warp_max(pm);
          if (lane == 0) xpm[pp * R + r] = pm;
        } else if (p_bf16) {
          for (int j = lane; j < np; j += 32) lg[r * lgs + j] = bf16r(lg[r * lgs + j]);
        }
        if (lane == 0) lrun[r] = lrun[r] * alpha[r] + sum;
      }
      if constexpr (KIND == KIND_Q8) {
        // p * vs to int8 per row over the whole chunk: pmax / 127
        cluster.sync();
        for (int r = tid; r < nr; r += NT) {
          float pm = 0.f;
          for (int k = 0; k < a.cl; ++k) pm = fmaxf(pm, cluster.map_shared_rank(xpm, k)[pp * R + r]);
          pmx[r] = pm;
        }
        __syncthreads();
        for (int r = warp; r < nr; r += NW) {
          const float inv = pmx[r] > 0.f ? 127.f / pmx[r] : 0.f;
          for (int j = lane; j < np; j += 32)
            lgi[r * lgs + j] = __float2int_rn(rintf(lg[r * lgs + j] * aux[ns + j] * inv));
        }
      }
      __syncthreads();
      if constexpr (KIND != KIND_Q8) {
        for (int gi = tid; gi < ngrp; gi += NT) {
          const int r = gi / Dv4, c0 = 4 * (gi % Dv4);
          float* o = part_s + r * (Dv + 1) + 1 + c0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!GEN || c0 + e < Dv) o[e] *= alpha[r];
        }
      }
    }

    // P.V over the visible tiles
    Acc accv[8][4];   // the tensor-core path's sums of this pass
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) accv[i][e] = 0;
    for (int qi = nk; qi < nk + nv; ++qi) {
      const int gs = g0 + qi, st = gs % NST;
      mbar_wait(&full[st], (gs / NST) & 1);
      __syncwarp();
      const unsigned char* buf = ring + st * L.stage;
      const int s0 = plo + tl[qi - nk] * a.ts, cnt = min(a.ts, phi - s0), jb = s0 - plo;
      if (mma_v) {
        // A = p (16 query rows x slots), B = V (slots x 8 columns): warp w
        // takes column tiles w, w + 4, ...; slots past cnt count as 0
        const int g = lane >> 2, t4 = lane & 3;
        constexpr int KS = KIND == KIND_Q8 ? 32 : 16;
        for (int ks = 0; ks < cnt; ks += KS) {
          uint32_t af[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int r = g + 8 * (h & 1);
            if constexpr (KIND == KIND_Q8) {
              const int j = ks + 4 * t4 + 16 * (h >> 1);
              int pc[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) pc[e] = r < nr && j + e < cnt ? lgi[r * lgs + jb + j + e] : 0;
              af[h] = pack_s8(pc[0], pc[1], pc[2], pc[3]);
            } else {
              const int j = ks + 2 * t4 + 8 * (h >> 1);
              af[h] = pack_bf16(r < nr && j < cnt ? lg[r * lgs + jb + j] : 0.f,
                                r < nr && j + 1 < cnt ? lg[r * lgs + jb + j + 1] : 0.f);
            }
          }
          if constexpr (KIND == KIND_BF16) {
            // two column tiles a time: ldmatrix.trans of 16 V rows gives B
            const int q8r = lane & 7, mi = lane >> 3;
            const unsigned char* vrow = buf + (size_t)(ks + q8r + 8 * (mi & 1)) * vst;
#pragma unroll
            for (int i = 0; i < 8; i += 2) {
              const int nn = warp + NW * i;
              if (nn * 8 < Dv) {
                const int nn2 = (nn + NW) * 8 < Dv ? nn + NW : nn;
                uint32_t b[4];
                asm volatile(
                    "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                    : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                    : "r"(smem_addr(vrow + 16 * (mi < 2 ? nn : nn2))));
                mma_bf16(reinterpret_cast<float*>(accv[i]), af, b[0], b[1]);
                if (nn2 != nn) mma_bf16(reinterpret_cast<float*>(accv[i + 1]), af, b[2], b[3]);
              }
            }
            continue;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int nn = warp + NW * i, c = nn * 8 + g;
            if (nn * 8 < Dv) {
              uint32_t b[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if constexpr (KIND == KIND_Q8) {
                  const int j = ks + 4 * t4 + 16 * h;
                  int v[4];
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    v[e] = j + e < cnt ? (int)reinterpret_cast<const int8_t*>(buf)[(size_t)(j + e) * vst + c] : 0;
                  b[h] = pack_s8(v[0], v[1], v[2], v[3]);
                } else if constexpr (KIND == KIND_BF16) {
                  const int j = ks + 2 * t4 + 8 * h;
                  const uint32_t v0 = j < cnt ? *reinterpret_cast<const uint16_t*>(buf + (size_t)j * vst + 2 * c) : 0u;
                  const uint32_t v1 = j + 1 < cnt ? *reinterpret_cast<const uint16_t*>(buf + (size_t)(j + 1) * vst + 2 * c) : 0u;
                  b[h] = v0 | (v1 << 16);
                } else {   // q4: column c is nibble c & 1 of byte c / 2
                  const int j = ks + 2 * t4 + 8 * h;
                  float v[2];
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    v[e] = 0.f;
                    if (j + e < cnt) {
                      const uint32_t byte = buf[(size_t)(j + e) * vst + (c >> 1)];
                      const int code = (int)((c & 1) ? byte >> 4 : byte & 15u) - 8;
                      v[e] = (float)code * aux[(jb + j + e) * (nq + nvq) + nq + (c >> 5)];
                    }
                  }
                  b[h] = pack_bf16(v[0], v[1]);
                }
              }
              if constexpr (KIND == KIND_Q8) mma_s8(reinterpret_cast<int*>(accv[i]), af, b[0], b[1]);
              else mma_bf16(reinterpret_cast<float*>(accv[i]), af, b[0], b[1]);
            }
          }
        }
      } else
      for (int gi = tid; gi < ngrp; gi += NT) {
        {
          const int r = gi / Dv4, cg4 = gi % Dv4;
          const float* pr = lg + r * lgs + jb;
          const int* pri = lgi + r * lgs + jb;
          Acc t[4] = {0, 0, 0, 0};
#pragma unroll 8
          for (int j = 0; j < cnt; ++j) {
            const unsigned char* vr = buf + (size_t)j * vst;
            if constexpr (KIND == KIND_F32) {
              const float4 vv = *reinterpret_cast<const float4*>(vr + cg4 * 16);
              const float p = pr[j];
              t[0] = fmaf(p, vv.x, t[0]);
              t[1] = fmaf(p, vv.y, t[1]);
              t[2] = fmaf(p, vv.z, t[2]);
              t[3] = fmaf(p, vv.w, t[3]);
            } else if constexpr (KIND == KIND_BF16) {
              const uint2 w = *reinterpret_cast<const uint2*>(vr + cg4 * 8);
              float v0, v1, v2, v3;
              unpack_bf16x2(w.x, v0, v1);
              unpack_bf16x2(w.y, v2, v3);
              const float p = pr[j];
              t[0] = fmaf(p, v0, t[0]);
              t[1] = fmaf(p, v1, t[1]);
              t[2] = fmaf(p, v2, t[2]);
              t[3] = fmaf(p, v3, t[3]);
            } else if constexpr (KIND == KIND_Q8) {
              const uint32_t w = *reinterpret_cast<const uint32_t*>(vr + cg4 * 4);
              const int p = pri[j];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                t[e] += p * (int)(int8_t)((w >> (8 * e)) & 0xffu);
            } else {
              const uint32_t w = *reinterpret_cast<const uint16_t*>(vr + cg4 * 2);
              const float sc = aux[(jb + j) * (nq + nvq) + nq + cg4 / 8];
              const float p = pr[j];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int cc = (int)((w >> (4 * e)) & 15u) - 8;
                t[e] = fmaf(p, bf16r((float)cc * sc), t[e]);
              }
            }
          }
          Acc* o = acc_s + r * (Dv + 1) + 1 + 4 * cg4;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!GEN || 4 * cg4 + e < Dv) o[e] += t[e];   // columns past Dv read the zero tail
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (issuer() && gs + NST < gend) issue(gs + NST);
    }
    if (mma_v) {
      __syncthreads();   // the rescale above ran on other threads
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int nn = warp + NW * i;
        if (nn * 8 < Dv) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = (lane >> 2) + 8 * (e >> 1), col = nn * 8 + 2 * (lane & 3) + (e & 1);
            if (r < nr) acc_s[r * (Dv + 1) + 1 + col] += accv[i][e];
          }
        }
      }
    }
    g = gend;
  }

  // the cluster's partials, added in rank order
  for (int r = tid; r < nr; r += NT) part_s[r * (Dv + 1)] = lrun[r];
  cluster.sync();
  for (int e = rank * NT + tid; e < nr * Dv; e += a.cl * NT) {
    const int r = e / Dv, cc = e % Dv;
    float lt = 0.f;
    Acc sum = 0;
    for (int k = 0; k < a.cl; ++k) {
      const float* ps = cluster.map_shared_rank(part_s, k) + r * (Dv + 1);
      lt += ps[0];
      if constexpr (KIND == KIND_Q8) sum += __float_as_int(ps[1 + cc]);
      else sum += ps[1 + cc];
    }
    const float val = KIND == KIND_Q8 ? (float)sum * (pmx[r] / 127.f) : (float)sum;
    const float m = mrun[r];
    const int rg = r0 + r, h = hk * G + rg % G;
    if (a.n_s > 1) {
      float* pp = a.part + ((((long)b * a.Hkv + hk) * a.n_s + c) * a.TG + rg) * (Dv + 2);
      if (cc == 0) { pp[0] = m; pp[1] = lt; }
      pp[2 + cc] = val;
    } else {
      // fd_combine of one chunk: m already holds the sink
      const float l = __fadd_rn(a.sinks != nullptr ? expf(a.sinks[h] - m) : 0.f, lt);
      const float o = val / fmaxf(l, 1e-30f);
      const long oi = (((long)b * a.T + rg / G) * a.H + h) * Dv + cc;
      if (a.q_bf16) reinterpret_cast<__nv_bfloat16*>(a.out)[oi] = __float2bfloat16_rn(o);
      else reinterpret_cast<float*>(a.out)[oi] = o;
    }
  }
  cluster.sync();   // the other blocks have read this block's partials
}

constexpr size_t SMEM_LIMIT = 227 * 1024;

template <int KIND, bool PAGED, bool GEN>
cudaError_t launch_kernel(const Args& a, size_t smem, cudaStream_t st) {
  static size_t smem_set = 0;   // the attribute is set once per size, never under capture
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<KIND, PAGED, GEN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_s * a.n_rt * a.cl, a.Hkv, a.B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_kernel<KIND, PAGED, GEN>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// one launch of a cluster of a.cl blocks per (chunk, row tile), kv head and
// batch row, the general instantiation only where the rows or the passes
// need it; returns the cudaError_t of the launch
template <int KIND, bool PAGED>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const size_t smem = layout(a, KIND, q_stride(a, KIND)).total;
  if (smem > SMEM_LIMIT || a.cl < 1 || a.cl > 8 || a.R > 32 || a.D > 256 || a.Dv > 256 ||
      (!PAGED && a.npass > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  if (a.copy != COPY_BULK || (!PAGED && a.npass > 1))
    return launch_kernel<KIND, PAGED, true>(a, smem, st);
  return launch_kernel<KIND, PAGED, false>(a, smem, st);
}

}  // namespace decode
