// fd: split-KV flash decode over a float, Q8_0 or Q4_0 KV cache.
//
// Replaces the TPU kernel _fd_kernel (superllama_tpu/ops/flash_attention.py:326,
// wrapper flash_decode_attention). Decode shapes: few query rows (T*G) per kv
// head against a long cache, so the work is split across the cache: the
// cache is cut into chunks of block_s slots, each attended by one thread
// block cluster (decode_common.cuh), which writes the output itself when
// there is one chunk, and otherwise its chunk's (m, l, acc) per query row
// for a second kernel, fd_combine, that adds the chunks in order (the TPU
// kernel carried them across its sequential grid instead).
//
// Three modes, each with the TPU kernel's arithmetic:
//  - f:  float K/V; the dot runs in bf16 when q is bf16 (K rounded to bf16),
//        else in f32; p is rounded to V's type before P.V.
//  - q8: int8 codes with per-slot f32 scales. q is quantized per row to int8
//        (amax / 127, round half to even); logits = int dot * (qs * scale) * ks.
//        p * vs is quantized to int8 per query row over the whole chunk
//        (pmax / 127) and dotted with the V codes in int32, times pmax / 127.
//        That quantization depends on how slots are grouped, so one cluster
//        owns one block_s chunk whole and exchanges the chunk's row max and
//        pmax between its blocks before any p is quantized.
//  - q4: nibble-packed codes (byte j: element 2j low nibble, 2j+1 high), one
//        f32 scale per 32-group; K and V dequantize to bf16 as
//        bf16((c - 8) * bf16(scale)), q is rounded to bf16, dots in f32.
// Masking is the positional -1e9 penalty of fa (never -inf); sinks enter the
// combine as m = sink, l = 1, and each chunk's max includes the sink so a
// single chunk computes exactly the TPU kernel's probabilities; logit softcap.
// A chunk that no row of the batch row can see (the TPU kernel's tile skip)
// adds nothing; inside a chunk, tiles no row can see are not read.
//
// What bounds it on the H100: bytes. At B 8, S 2048, 8 kv heads, D 128 the
// cache is 34.6 MB in Q8_0 (0.010 ms at 3.35 TB/s) and the arithmetic is
// small (decode_common.cuh says how the design keeps the bytes moving).
// Geometry (the wrapper's decode_plan): a cluster of cl = min(8, tiles in
// a chunk) blocks per (chunk, row tile of up to 32 query rows, kv head,
// batch row), each block nb = ceil(block_s / cl) slots rounded up to whole
// tiles of 8 KB (64 slots in q8 at D 128, 32 in bf16, 16 in f32, 128 in q4):
// 512 blocks at B 8, 64 at B 1 for S 2048. One launch when S <= block_s,
// two (with fd_combine) otherwise.
//
// Layout: q (B,T,H,D) contiguous; k (B,Hkv,S,Dk), v (B,Hkv,S,Dvk) rows
// contiguous with caller-given batch/head strides (Dk = D, or D/2 bytes in
// q4; any row length, see decode_common.cuh); scales (B,Hkv,S) in q8 or (B,Hkv,S,D/32)
// in q4 with contiguous slots; part (B,Hkv,n_s,T*G,Dv+2) f32 scratch when
// n_s > 1; out (B,T,H,Dv) in q's type.

#include "decode_common.cuh"

namespace {

using decode::Args;

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

}  // namespace

// mode: 0 f (kv_kind 0 f32 / 1 bf16), 1 q8, 2 q4. Strides are in elements of
// the tensor's type (bytes for the int8/uint8 codes). The plan (R query rows
// a tile, cl blocks a cluster, nb slots a block, ts slots a tile, nbmax
// slots a pass, npass passes) comes from the wrapper, as does the copy
// mode of the cache rows; ws holds B*Hkv*n_s*n_rt*cl*R*nb floats when
// npass > 1, part B*Hkv*n_s*T*G*(Dv+2) when n_s = ceil(S / bs) > 1.
// Returns the cudaError_t of the launches.
extern "C" int slt_fd(int B, int T, int H, int Hkv, int S, int D, int Dv, int bs, int mode,
                      int R, int cl, int nb, int ts, int nbmax,
                      const void* q, int q_bf16, const void* k, const void* v, int kv_kind,
                      long k_sb, long k_sh, long v_sb, long v_sh,
                      const void* k_scale, const void* v_scale,
                      long ks_sb, long ks_sh, long vs_sb, long vs_sh,
                      const void* q_pos, const void* kv_pos, long kvpos_sb,
                      const void* sinks, float scale, int swa, float softcap,
                      int npass, int copy, void* ws, void* part, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = H / Hkv, TG = T * G;
  const int kind = mode == 1 ? decode::KIND_Q8 : mode == 2 ? decode::KIND_Q4
                   : kv_kind == 0 ? decode::KIND_F32 : decode::KIND_BF16;
  const int es = kind == decode::KIND_F32 ? 4 : kind == decode::KIND_BF16 ? 2 : 1;
  Args a{};
  a.B = B; a.T = T; a.H = H; a.Hkv = Hkv; a.D = D; a.Dv = Dv; a.G = G; a.TG = TG;
  a.R = R; a.n_rt = (TG + R - 1) / R; a.cl = cl; a.nb = nb; a.ts = ts; a.nbmax = nbmax;
  a.npass = npass; a.n_s = (S + bs - 1) / bs; a.bs = bs; a.S = S;
  a.q = q; a.q_bf16 = q_bf16; a.q_pos = (const int*)q_pos;
  a.k = k; a.v = v; a.k_sb = k_sb; a.k_sh = k_sh; a.v_sb = v_sb; a.v_sh = v_sh;
  a.krow = kind == decode::KIND_Q4 ? D / 2 : D * es;
  a.vrow = kind == decode::KIND_Q4 ? Dv / 2 : Dv * es;
  a.k_scale = (const float*)k_scale; a.v_scale = (const float*)v_scale;
  a.ks_sb = ks_sb; a.ks_sh = ks_sh; a.vs_sb = vs_sb; a.vs_sh = vs_sh;
  a.kv_pos = (const int*)kv_pos; a.kvpos_sb = kvpos_sb;
  a.sinks = (const float*)sinks; a.scale = scale; a.swa = swa; a.softcap = softcap;
  a.part = (float*)part; a.out = out; a.copy = copy; a.ws = (float*)ws;
  cudaError_t e;
  switch (kind) {
    case decode::KIND_F32: e = decode::launch<decode::KIND_F32, false>(a, st); break;
    case decode::KIND_BF16: e = decode::launch<decode::KIND_BF16, false>(a, st); break;
    case decode::KIND_Q8: e = decode::launch<decode::KIND_Q8, false>(a, st); break;
    default: e = decode::launch<decode::KIND_Q4, false>(a, st); break;
  }
  if (e != cudaSuccess || a.n_s == 1) return (int)e;
  fd_combine<<<B * T * H, Dv < 128 ? Dv : 128, 0, st>>>(a);
  return (int)cudaGetLastError();
}
