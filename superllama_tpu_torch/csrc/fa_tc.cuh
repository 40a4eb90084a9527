// fa_tc.cuh: the tensor-core flash-attention kernel shared by fa.cu (dense
// caches) and paged.cu (page pools), tc::fa_tc_kernel. fa.cu's opening
// comment says what it computes, what bounds it on the H100 and how its
// design meets that.
//
// The addressing of a cache slot is a compile-time parameter, so each
// caller's instantiations carry none of the other's code:
//  - dense (PAGED false, fa): slot s of batch row b is K row
//    k + b * k_sb + hk * k_sh + s * D, its position kv_pos[b * kvpos_sb + s];
//  - paged (PAGED true, paged): the row's logical slot s lies in logical
//    page lg = s / P at offset s % P, in pool page pg = max(table[b, lg], 0)
//    (an absent entry, -1, reads the NULL page 0, whose positions are all
//    -1); its K row is k + pg * k_sb + hk * k_sh + (s % P) * D (k_sb is the
//    page stride) and its position kv_pos[pg * P + s % P] (kv_pos is the
//    pool's page positions). Tiles stay aligned to the row's logical slots
//    (s0 = BS * i), so p is rounded against the same running maxima however
//    the row's pages lie. A block stages the row's page table in shared
//    memory and copies a tile in runs of rows that stay inside one page
//    (one division by P a tile, none in the copy loop): one run at P 256,
//    several where P is smaller than a tile or does not divide it. A block
//    of padding rows only reads q_pos, writes zeros and leaves before
//    anything else is read.
// A page pool's grid is cut for a page-chunked prefill, where one batch row
// is a prompt's chunk and the others ride along as padding (paged_plan in
// ops/paged_attention.py): there the valid row's few (row tile, kv head)
// blocks leave most SMs idle, and one block's chain of tiles (about 5 us a
// tile at one block an SM) sets the time. So SPLIT = 2 blocks of a cluster
// share a (row tile, kv head)'s list of visible tiles, each half with its
// own running max, and rank 0 adds rank 1's partial softmax state (m, l and
// O, read from rank 1's shared memory) to its own before it writes. The
// split depends only on the row's logical list, so two pools that lay a
// row's pages out differently still give the same bits. Padding blocks
// write their zeros with 16-byte stores.
// Layout: q (B,T,H,D) contiguous; out (B,T,H,Dv) bf16.

#pragma once

#include "ptx.cuh"

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>

namespace tc {

namespace cg = cooperative_groups;
using namespace ptx;

constexpr int NW = 4, NT = NW * 32;   // four warps, one m16 tile of query rows each
constexpr int ROWS = NW * 16;          // query rows (t, g) a block
constexpr int NST = 3;                 // ring stages
enum { COPY_16 = 0, COPY_4 = 1, COPY_1 = 2 };   // as copy_mode in ops/flash_attention.py

__host__ __device__ inline int up16(int n) { return (n + 15) / 16 * 16; }

// A block's shared memory, in bytes. NST ring stages, each a tile's K rows,
// V rows (bf16 at strides of the 16-padded width plus 16 bytes; Q8_0: codes
// at 16-byte multiples, then the K and V scales) and kv_pos; for Q8_0 the
// dequantized bf16 K and V tiles; Q's 64 rows, in the last stage's K rows
// (or the bf16 K tile) where a tile holds 64 rows, since Q is in registers
// before those are first written, else apart; the list of visible tiles;
// for a page pool (maxp > 0) the row's maxp pool pages. prefill_plan in
// ops/flash_attention.py computes the same numbers.
struct Layout {
  int bs, krow, vrow, kcrow, vcrow, stage, off_v, off_ks, off_vs, off_pos;
  int off_kb, off_vb, off_q, off_list, bytes, off_pg;
};

inline Layout make_layout(int D, int Dv, int S, bool q8, int maxp = 0) {
  Layout L{};
  const int dk = up16(D), dv = up16(Dv);
  L.bs = (dk > 128 || dv > 128) ? 32 : 64;
  L.krow = 2 * dk + 16;
  L.vrow = 2 * dv + 16;
  L.kcrow = q8 ? dk : L.krow;
  L.vcrow = q8 ? dv : L.vrow;
  L.off_v = L.bs * L.kcrow;
  L.off_ks = L.off_v + L.bs * L.vcrow;
  L.off_vs = L.off_ks + (q8 ? 4 * L.bs : 0);
  L.off_pos = L.off_vs + (q8 ? 4 * L.bs : 0);
  L.stage = L.off_pos + 4 * L.bs;
  int off = NST * L.stage;
  L.off_kb = off;
  if (q8) off += L.bs * L.krow;
  L.off_vb = off;
  if (q8) off += L.bs * L.vrow;
  if (L.bs == ROWS) {
    L.off_q = q8 ? L.off_kb : (NST - 1) * L.stage;
  } else {
    L.off_q = off;
    off += ROWS * L.krow;
  }
  L.off_list = off;
  L.off_pg = off + up16(4 * ((S + L.bs - 1) / L.bs));
  L.bytes = L.off_pg + up16(4 * maxp);
  return L;
}

struct Args {
  int B, T, H, Hkv, S, D, Dv, G, BT, n_rt, ntiles;
  const unsigned char* q; int q_copy;
  const unsigned char* k; const unsigned char* v; int kv_copy;
  long k_sb, k_sh, v_sb, v_sh;          // element strides
  const float* k_scale; const float* v_scale; long s_sb, s_sh;
  const int* q_pos; const int* kv_pos; long kvpos_sb;
  const float* sinks; float scale; int swa; float softcap;
  __nv_bfloat16* out;
  Layout L;
  // page pools (PAGED): k_sb / v_sb are page strides, kv_pos the pool's
  // page positions (N, P), table the rows' page tables (B, MAXP)
  const int* table; int P, MAXP;
};

// global -> shared through L2, n of the 16 (4) bytes read, the rest zero
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the SFU (exp(x) = 2^(x log2 e)); results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// One thread's share of copying a tile's rows: `bytes` a row in global
// memory (rows contiguous), `sstride` apart in shared memory. 16- or 4-byte
// pieces: the thread keeps one piece column and takes every rstep-th row
// from r0, so the loop is pointer increments; rows of odd size go byte by
// byte. Rows at or past cnt (beyond the cache) read as zeros.
struct RowCopy {
  int mode, bytes, sstride, r0, rstep, off;

  __device__ void init(int mode_, int bytes_, int sstride_) {
    mode = mode_;
    bytes = bytes_;
    sstride = sstride_;
    const int piece = mode == COPY_16 ? 16 : 4;
    const int per = mode == COPY_1 ? 1 : bytes / piece;
    rstep = NT / per;
    r0 = threadIdx.x / per;
    if (r0 >= rstep) r0 = 1 << 20;   // threads past whole rows idle
    off = (threadIdx.x % per) * piece;
  }

  __device__ void copy(unsigned char* dst, const unsigned char* src, int n, int cnt) const {
    if (mode == COPY_1) {
      for (int i = threadIdx.x; i < n * bytes; i += NT) {
        const int r = i / bytes, c = i - r * bytes;
        dst[r * sstride + c] = r < cnt ? src[(long)r * bytes + c] : 0;
      }
      return;
    }
    const unsigned char* s = src + (long)r0 * bytes + off;
    unsigned char* d = dst + r0 * sstride + off;
    const long sstep = (long)rstep * bytes;
    const int dstep = rstep * sstride;
    for (int r = r0; r < n; r += rstep, s += sstep, d += dstep) {
      const bool in = r < cnt;
      if (mode == COPY_16) cp16(d, in ? s : src, in ? 16 : 0);
      else cp4(d, in ? s : src, in ? 4 : 0);
    }
  }
};

// Q8_0: codes (rows of n at crow bytes) times their row's scale in f32,
// rounded to bf16, into rows of drow bytes, 8 columns a store; columns n ..
// w16 (the 16-padded width) zero
__device__ void dequant(unsigned char* dst, int drow, const unsigned char* codes, int crow,
                        const float* scales, int n, int w16, int rows) {
  const int per = w16 / 8, rstep = NT / per, c0 = (threadIdx.x % per) * 8;
  if ((int)threadIdx.x >= rstep * per) return;   // past whole rows
  for (int r = threadIdx.x / per; r < rows; r += rstep) {
    const uint2 w = *reinterpret_cast<const uint2*>(codes + r * crow + c0);
    const float s = scales[r];
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t word = e < 2 ? w.x : w.y;
      const int sh = 16 * (e & 1);
      const float lo = c0 + 2 * e < n ? __fmul_rn((float)(int8_t)(word >> sh), s) : 0.f;
      const float hi = c0 + 2 * e + 1 < n ? __fmul_rn((float)(int8_t)(word >> (sh + 8)), s) : 0.f;
      o[e] = pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(dst + r * drow + 2 * c0) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// DM: D and Dv padded to whole 16s are at most DM; BS: slots a tile;
// PAGED: K/V and positions through the page table (bf16 pools only);
// SPLIT: blocks of a cluster that share a row tile's list of visible tiles
template <int DM, int BS, bool Q8, bool PAGED = false, int SPLIT = 1>
__global__ void __launch_bounds__(NT, DM <= 128 ? 2 : 1) fa_tc_kernel(Args a) {
  static_assert(!(PAGED && Q8), "page pools hold float K/V");
  static_assert(SPLIT == 1 || PAGED, "only a page pool's grid splits a row tile's tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_q[2][2], s_nvis;   // q_pos max / least valid q_pos of warps 0, 1
  constexpr int KPR = 16;            // kv_pos a thread reads in a round of 2048 slots
  constexpr float L2E = 1.4426950408889634f;
  constexpr int NKS = DM / 16;       // k-steps of QK^T at most
  constexpr int NVT = DM / 8;        // n8 column tiles of P.V at most
  constexpr int NS8 = BS / 8;        // n8 slot tiles of a logit tile
  constexpr bool QREG = DM <= 128;   // Q's A fragments held in registers
  const Layout& L = a.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  // longest row tiles first: block i takes kv head i % Hkv of row tile
  // n_rt - 1 - i / Hkv (a causal prompt's last rows see the most tiles); a
  // page pool's block is rank blockIdx.x % SPLIT of its row tile's cluster
  const int rank = (int)(blockIdx.x % SPLIT);
  const int lin = blockIdx.x / SPLIT + blockIdx.y * (gridDim.x / SPLIT);
  const int hk = lin % a.Hkv, b = blockIdx.z;
  const int t0 = (a.n_rt - 1 - lin / a.Hkv) * a.BT;
  const int G = a.G, R = a.BT * G;
  const int nks = (a.D + 15) >> 4, nvt = ((a.Dv + 15) >> 4) * 2;

  // what needs nothing else goes out at once: the block's q_pos (a token a
  // thread), Q's rows (cp.async), the first 2048 kv_pos (16 a thread). A
  // page pool's block reads Q and the positions only once it knows that a
  // row of it is valid: most of a page-chunked prefill's blocks are padding
  const int qp_t = tid < a.BT && t0 + tid < a.T ? a.q_pos[(long)b * a.T + t0 + tid] : -1;
  unsigned char* qs = smem + L.off_q;
  auto load_q = [&]() {   // Q's rows (t0 + r / G, head hk * G + r % G), zero past R or T
    const int piece = a.q_copy == COPY_16 ? 16 : a.q_copy == COPY_4 ? 4 : 1;
    const int per = 2 * a.D / piece;
    for (int i = tid; i < ROWS * per; i += NT) {
      const int r = i / per, c = (i - r * per) * piece, t = t0 + r / G;
      const bool in = r < R && t < a.T;
      const unsigned char* src =
          a.q + (in ? (((long)b * a.T + t) * a.H + hk * G + r % G) * a.D * 2 + c : 0);
      unsigned char* dst = qs + r * L.krow + c;
      if (piece == 16) cp16(dst, src, in ? 16 : 0);
      else if (piece == 4) cp4(dst, src, in ? 4 : 0);
      else *dst = in ? *src : 0;
    }
    commit();
  };
  // the list of visible tiles (flags first)
  int* list = reinterpret_cast<int*>(smem + L.off_list);
  int* pgs = reinterpret_cast<int*>(smem + L.off_pg);   // PAGED: the row's pool pages
  const int* kpr = a.kv_pos + (PAGED ? 0 : (long)b * a.kvpos_sb);
  const int* tbl = PAGED ? a.table + (long)b * a.MAXP : nullptr;
  int kp[KPR];
  auto load_kp = [&](int c0) {   // the positions of slots c0 + u * NT + tid
#pragma unroll
    for (int u = 0; u < KPR; ++u) {
      const int s = c0 + u * NT + tid;
      if constexpr (PAGED) {
        const int lg = s / a.P;
        kp[u] = s < a.S ? __ldg(kpr + (long)max(__ldg(tbl + lg), 0) * a.P + (s - lg * a.P))
                        : -1;
      } else {
        kp[u] = s < a.S ? __ldg(kpr + s) : -1;
      }
    }
  };
  if constexpr (!PAGED) load_q();
  for (int i = tid; i < a.ntiles; i += NT) list[i] = 0;
  if constexpr (!PAGED) load_kp(0);
  if (warp < 2) {   // the block's tokens are threads 0 .. BT - 1 <= 63
    const int hi = __reduce_max_sync(0xffffffffu, qp_t);
    const int lo = __reduce_min_sync(0xffffffffu, qp_t >= 0 ? qp_t : INT_MAX);
    if (lane == 0) {
      s_q[warp][0] = hi;
      s_q[warp][1] = lo;
    }
  }
  __syncthreads();
  const int qmax = max(s_q[0][0], s_q[1][0]), qmin = min(s_q[0][1], s_q[1][1]);
  if (qmax < 0) {
    // padding rows only: the zeros of an empty softmax, shared by the
    // cluster's blocks. A token's G rows are G * Dv adjacent outputs.
    if constexpr (!PAGED) wait_groups<0>();
    const int run = G * a.Dv;
    if (PAGED && a.Dv % 8 == 0) {   // 16-byte stores: every run starts at a 16-byte multiple
      const int run8 = run / 8;
      for (int i = tid + rank * NT; i < a.BT * run8; i += NT * SPLIT) {
        const int t = t0 + i / run8;
        uint4* orow =
            reinterpret_cast<uint4*>(a.out + (((long)b * a.T + t) * a.H + hk * G) * a.Dv);
        if (t < a.T) orow[i % run8] = make_uint4(0u, 0u, 0u, 0u);
      }
      return;
    }
    for (int i = tid + rank * NT; i < a.BT * run; i += NT * SPLIT) {
      const int t = t0 + i / run;
      if (t < a.T)
        a.out[(((long)b * a.T + t) * a.H + hk * G) * a.Dv + i % run] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  if constexpr (PAGED) {
    load_q();
    for (int i = tid; i < a.MAXP; i += NT) pgs[i] = max(__ldg(tbl + i), 0);
    load_kp(0);
  }

  // a slot is visible to some row of the block iff 0 <= kp <= qmax (and
  // kp > qmin - swa); positions in any order. Each warp takes 32-slot runs,
  // which lie in one tile.
  for (int c0 = 0; c0 < a.S; c0 += KPR * NT) {
    if (c0 > 0) load_kp(c0);
#pragma unroll
    for (int u = 0; u < KPR; ++u) {
      const bool vis = kp[u] >= 0 && kp[u] <= qmax && (a.swa <= 0 || kp[u] > qmin - a.swa);
      if (__any_sync(0xffffffffu, vis) && lane == 0) list[(c0 + u * NT + warp * 32) / BS] = 1;
    }
  }
  __syncthreads();
  if (warp == 0) {   // compact the flags into the list, in tile order
    int n = 0;
    for (int base = 0; base < a.ntiles; base += 32) {
      const bool f = base + lane < a.ntiles && list[base + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(m & ((1u << lane) - 1u))] = base + lane;
      n += __popc(m);
    }
    if (lane == 0) s_nvis = n;
  }

  // padding columns (D and Dv up to whole 16s) are never copied: zero them
  const int kpad = L.krow - 16 - 2 * a.D, vpad = L.vrow - 16 - 2 * a.Dv;
  if (kpad > 0) {
    for (int i = tid; i < ROWS * kpad; i += NT) qs[(i / kpad) * L.krow + 2 * a.D + i % kpad] = 0;
    if (!Q8)
      for (int i = tid; i < NST * BS * kpad; i += NT)
        smem[(i / (BS * kpad)) * L.stage + (i / kpad % BS) * L.krow + 2 * a.D + i % kpad] = 0;
  }
  if (vpad > 0 && !Q8)
    for (int i = tid; i < NST * BS * vpad; i += NT)
      smem[(i / (BS * vpad)) * L.stage + L.off_v + (i / vpad % BS) * L.vrow + 2 * a.Dv +
           i % vpad] = 0;
  __syncthreads();
  // this block's share of the list: tiles first .. first + nvis - 1 of it
  const int first = s_nvis * rank / SPLIT, nvis = s_nvis * (rank + 1) / SPLIT - first;

  const int esz = Q8 ? 1 : 2;
  RowCopy kc, vc;
  kc.init(a.kv_copy, a.D * esz, L.kcrow);
  vc.init(a.kv_copy, a.Dv * esz, L.vcrow);
  const unsigned char* kbase = a.k + ((PAGED ? 0 : (long)b * a.k_sb) + (long)hk * a.k_sh) * esz;
  const unsigned char* vbase = a.v + ((PAGED ? 0 : (long)b * a.v_sb) + (long)hk * a.v_sh) * esz;
  const long sbh = (long)b * a.s_sb + (long)hk * a.s_sh;
  auto load_tile = [&](int tile, int st) {
    const int s0 = tile * BS, cnt = min(BS, a.S - s0);
    unsigned char* sb = smem + st * L.stage;
    int* pos = reinterpret_cast<int*>(sb + L.off_pos);
    if constexpr (PAGED) {
      // rows r .. r + n - 1 of the tile: slots off .. off + n - 1 of logical
      // page lg, one run a page the tile touches; rows past the row's last
      // page read as zeros at position -1
      int lg = s0 / a.P, off = s0 - lg * a.P;
      for (int r = 0; r < cnt; lg++, off = 0) {
        const int n = min(cnt - r, a.P - off);
        const long pg = pgs[lg];
        kc.copy(sb + r * L.kcrow, kbase + (pg * a.k_sb + (long)off * a.D) * esz, n, n);
        vc.copy(sb + L.off_v + r * L.vcrow, vbase + (pg * a.v_sb + (long)off * a.Dv) * esz, n,
                n);
        if (tid >= r && tid < r + n) cp4(pos + tid, kpr + pg * a.P + off + (tid - r), 4);
        r += n;
      }
      if (cnt < BS) {
        kc.copy(sb + cnt * L.kcrow, kbase, BS - cnt, 0);
        vc.copy(sb + L.off_v + cnt * L.vcrow, vbase, BS - cnt, 0);
        if (tid >= cnt && tid < BS) pos[tid] = -1;
      }
    } else {
      kc.copy(sb, kbase + (long)s0 * a.D * esz, BS, cnt);
      vc.copy(sb + L.off_v, vbase + (long)s0 * a.Dv * esz, BS, cnt);
      if (tid < BS) {
        if (tid < cnt) cp4(pos + tid, kpr + s0 + tid, 4);
        else pos[tid] = -1;
      }
    }
    if constexpr (Q8) {
      const int j = tid < BS ? tid : tid - BS;
      if (tid < 2 * BS) {
        const float* src = (tid < BS ? a.k_scale : a.v_scale) + sbh + s0;
        cp4(sb + (tid < BS ? L.off_ks : L.off_vs) + 4 * j, src + (j < cnt ? j : 0),
            j < cnt ? 4 : 0);
      }
    }
  };
  for (int i = 0; i < NST - 1; ++i) {
    if (i < nvis) load_tile(list[first + i], i);
    commit();
  }

  // this thread's two rows: g and g + 8 of the warp's m16 tile
  float qpf[2], m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh, t = t0 + r / G;
    const bool valid = r < R && t < a.T;
    qpf[hh] = valid ? (float)a.q_pos[(long)b * a.T + t] : -1.f;
    m[hh] = -1e30f;
    l[hh] = 0.f;
    if (a.sinks != nullptr && valid && rank == 0) {   // the sink is logit #0
      m[hh] = a.sinks[hk * G + r % G];
      l[hh] = t4 == 0 ? 1.f : 0.f;       // l is summed over the quad at the end
    }
  }
  wait_groups<NST - 1>();   // Q's group
  __syncthreads();
  const unsigned char* qa = qs + (warp * 16 + (lane & 15)) * L.krow + (lane >> 4) * 16;
  uint32_t qf[QREG ? NKS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      if (ks < nks) ldsm4(qf[ks], qa + ks * 32);
  }
  float o[NVT][4];
#pragma unroll
  for (int n = 0; n < NVT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // ldmatrix row addresses of this lane: K (non-transposed, slot rows
  // 8j + (lane & 7) + 8 (lane >> 4), k half (lane >> 3) & 1) and V
  // (transposed, slot rows 16kk + (lane & 7) + 8 ((lane >> 3) & 1), column
  // half lane >> 4)
  const int krow_l = ((lane & 7) + 8 * (lane >> 4)) * L.krow + ((lane >> 3) & 1) * 16;
  const int vrow_l = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.vrow + (lane >> 4) * 16;

  for (int it = 0; it < nvis; ++it) {
    wait_groups<NST - 2>();
    __syncthreads();   // tile it landed; every warp is done with tile it - 1
    if (it + NST - 1 < nvis) load_tile(list[first + it + NST - 1], (it + NST - 1) % NST);
    commit();
    const unsigned char* sb = smem + (it % NST) * L.stage;
    const unsigned char* kt = sb;
    const unsigned char* vt = sb + L.off_v;
    if constexpr (Q8) {
      dequant(smem + L.off_kb, L.krow, sb, L.kcrow, reinterpret_cast<const float*>(sb + L.off_ks),
              a.D, up16(a.D), BS);
      dequant(smem + L.off_vb, L.vrow, sb + L.off_v, L.vcrow,
              reinterpret_cast<const float*>(sb + L.off_vs), a.Dv, up16(a.Dv), BS);
      __syncthreads();
      kt = smem + L.off_kb;
      vt = smem + L.off_vb;
    }
    const int* pos = reinterpret_cast<const int*>(sb + L.off_pos);

    // logits = Q K^T: C fragments, slot tile j holds rows g / g + 8 at
    // slots 8j + 2 t4, + 1
    float sc[NS8][4];
#pragma unroll
    for (int j = 0; j < NS8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if (ks >= nks) break;
      uint32_t qr[4];
      const uint32_t* af = qr;
      if constexpr (QREG) af = qf[ks];
      else ldsm4(qr, qa + ks * 32);
#pragma unroll
      for (int j = 0; j < NS8; j += 2) {
        uint32_t bk[4];
        ldsm4(bk, kt + 8 * j * L.krow + krow_l + ks * 32);
        mma_bf16(sc[j], af, bk[0], bk[1]);
        mma_bf16(sc[j + 1], af, bk[2], bk[3]);
      }
    }

    // scale, softcap, positional penalty; the running max
    float mx[2] = {-3.402823466e38f, -3.402823466e38f};
#pragma unroll
    for (int j = 0; j < NS8; ++j) {
      const int2 kp2 = *reinterpret_cast<const int2*>(pos + 8 * j + 2 * t4);
      const float kpf[2] = {(float)kp2.x, (float)kp2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const float qp = qpf[e >> 1], kpv = kpf[e & 1];
        float pen = fminf(0.f, qp - kpv) + fminf(0.f, kpv);
        if (a.swa > 0) pen += fminf(0.f, kpv - qp + (float)a.swa - 1.f);
        x = x + pen * 1e9f;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m[hh], mx[hh]);
      alpha[hh] = ex2((m[hh] - mn) * L2E);
      m[hh] = mn;
    }
    // p = exp(x - m) = 2^((x - m) log2 e) against the running max (x - m
    // first: a penalized row's logits are ~1e12, and x log2 e - m log2 e
    // would keep their rounding), f32 into l, rounded to bf16 straight into
    // the A fragments of P.V (slots 16kk .. 16kk + 15: tiles 2kk, 2kk + 1)
    uint32_t pa[BS / 16][4];
#pragma unroll
    for (int j = 0; j < NS8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2((sc[j][e] - m[e >> 1]) * L2E);
        ps[e >> 1] += p[e];
      }
      pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
#pragma unroll
    for (int n = 0; n < NVT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: V's B fragments by ldmatrix.trans, two column tiles a load
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NVT; n += 2) {
        if (n >= nvt) break;
        uint32_t bv[4];
        ldsm4t(bv, vt + 16 * kk * L.vrow + vrow_l + n * 16);
        mma_bf16(o[n], pa[kk], bv[0], bv[1]);
        mma_bf16(o[n + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }

  if constexpr (SPLIT > 1) {
    // the cluster's partial softmax states: rank k > 0 leaves its m, l
    // and O in its ring (a thread's values NT floats apart), rank 0 adds
    // them to its own in rank order and writes the output
    cg::cluster_group cluster = cg::this_cluster();
    float* xs = reinterpret_cast<float*>(smem);
    __syncthreads();   // every warp is done with the ring
    if (rank > 0) {
#pragma unroll
      for (int n = 0; n < NVT; ++n) {
        if (n >= nvt) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[(4 * n + e) * NT + tid] = o[n][e];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        xs[(4 * NVT + hh) * NT + tid] = m[hh];
        xs[(4 * NVT + 2 + hh) * NT + tid] = l[hh];
      }
    }
    cluster.sync();
    if (rank == 0) {
      for (int k = 1; k < SPLIT; ++k) {
        const float* rx = cluster.map_shared_rank(xs, k);
        float a0[2], a1[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mk = rx[(4 * NVT + hh) * NT + tid];
          const float mn = fmaxf(m[hh], mk);
          a0[hh] = ex2((m[hh] - mn) * L2E);
          a1[hh] = ex2((mk - mn) * L2E);
          l[hh] = l[hh] * a0[hh] + rx[(4 * NVT + 2 + hh) * NT + tid] * a1[hh];
          m[hh] = mn;
        }
#pragma unroll
        for (int n = 0; n < NVT; ++n) {
          if (n >= nvt) break;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n][e] = o[n][e] * a0[e >> 1] + rx[(4 * n + e) * NT + tid] * a1[e >> 1];
        }
      }
    }
    cluster.sync();   // rank k's shared memory stays until rank 0 has read it
    if (rank > 0) return;
  }

  // out = O / max(l, 1e-30); l summed over the quad in a fixed order
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh, t = t0 + r / G;
    if (r >= R || t >= a.T) continue;
    const float den = fmaxf(l[hh], 1e-30f);
    __nv_bfloat16* orow = a.out + (((long)b * a.T + t) * a.H + hk * G + r % G) * a.Dv;
#pragma unroll
    for (int n = 0; n < NVT; ++n) {
      if (n >= nvt) break;
      const int c = 8 * n + 2 * t4;
      const float v0 = o[n][2 * hh] / den, v1 = o[n][2 * hh + 1] / den;
      if (c + 1 < a.Dv && (a.Dv & 1) == 0) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(v0, v1);
      } else {
        if (c < a.Dv) orow[c] = __float2bfloat16_rn(v0);
        if (c + 1 < a.Dv) orow[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// the bytes of a cluster's exchange of partial softmax states, at the
// start of the ring
constexpr int xchg_bytes(int dm) { return (4 * (dm / 8) + 4) * NT * 4; }

template <int DM, int BS, bool Q8, bool PAGED = false, int SPLIT = 1>
cudaError_t launch(const Args& a, cudaStream_t st) {
  static int attr = 0;   // the largest dynamic shared memory set so far
  if (a.L.bytes > attr) {
    const cudaError_t e = cudaFuncSetAttribute(fa_tc_kernel<DM, BS, Q8, PAGED, SPLIT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               a.L.bytes);
    if (e != cudaSuccess) return e;
    attr = a.L.bytes;
  }
  const dim3 grid(a.n_rt * SPLIT, a.Hkv, a.B);
  if constexpr (SPLIT == 1) {
    fa_tc_kernel<DM, BS, Q8, PAGED, SPLIT><<<grid, NT, a.L.bytes, st>>>(a);
  } else {
    if (xchg_bytes(DM) > NST * a.L.stage) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = a.L.bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr_c[1];
    attr_c[0].id = cudaLaunchAttributeClusterDimension;
    attr_c[0].val.clusterDim.x = SPLIT;
    attr_c[0].val.clusterDim.y = 1;
    attr_c[0].val.clusterDim.z = 1;
    cfg.attrs = attr_c;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, fa_tc_kernel<DM, BS, Q8, PAGED, SPLIT>, a);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace tc
