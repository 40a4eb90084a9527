"""Flash attention with positional masking (ggml_flash_attn_ext semantics).

Counterpart of the JAX package's ``flash_attention``: GQA, positional
causal / sliding-window / empty-slot masking from ``q_pos`` and ``kv_pos``
as additive −1e9-per-position penalties, logit softcap, attention sinks and
optional Q8_0 K/V (int8 codes with per-row f32 scales). Inputs keep the JAX
layout: q (B, T, H, D), k/v (B, Hkv, S, D).

On CUDA tensors ``flash_attention`` launches one of the two hand-written
kernels of ``csrc/fa.cu`` that ``fa_plan`` picks: the tensor-core kernel
for bf16 q over bf16 or Q8_0 K/V (counted in
``flash_attention.launches_tc``), the CUDA-core kernel for f32 q or f32
K/V (``flash_attention.launches``); on CPU tensors it runs
``flash_attention_plain``.

``flash_decode_attention`` is the decode-shape counterpart (the JAX
package's split-KV ``flash_decode_attention``): float, Q8_0 or Q4_0 K/V,
split across the cache in ``block_s`` chunks whose partial softmax states are
combined at the end. CUDA tensors run ``csrc/fd.cu``, CPU tensors
``flash_decode_plain``; launches are counted in
``flash_decode_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..runtime.kv_cache import q4_dequant
from . import _build
from .ref import quant_scale

_NEG = 1e9  # per-unit positional penalty; violations are >= 1 position apart

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_ARGTYPES = [_I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _L, _L, _L, _L,
             _P, _P, _L, _L, _P, _P, _L, _P, _F, _I, _F, _P, _P]
_TC_ARGTYPES = [_I] * 7 + [_P, _I, _P, _P, _I, _I, _L, _L, _L, _L, _P, _P, _L, _L, _P, _P, _L,
                          _P, _F, _I, _F, _I, _I, _I, _P, _P]
_FD_ARGTYPES = [_I] * 14 + [_P, _I, _P, _P, _I, _L, _L, _L, _L, _P, _P, _L, _L, _L, _L,
                            _P, _P, _L, _P, _F, _I, _F, _I, _I, _P, _P, _P, _P]
_FD_MODES = {"f": 0, "q8": 1, "q4": 2}
FD_BLOCK_S = 2048   # default cache slots per chunk, as in the JAX package

# geometry of the decode kernel of csrc/decode_common.cuh
_STAGE_BYTES = 8192    # one stage of a block's ring of K/V tiles
_LOGIT_FLOATS = 8192   # logits a block holds in one pass: rows x slots
_CLUSTER = 8           # blocks a cluster at most (the portable size)
_ROWS = 32             # query rows a block at most


@dataclass(frozen=True)
class DecodePlan:
    """How the decode kernel cuts one call: n_s chunks of bs slots, each
    taken by a cluster of cl blocks per (row tile of R query rows, kv head,
    batch row); block ``rank`` of a cluster owns nb slots of its chunk, in
    tiles of ts slots, npass passes of at most nbmax slots (fd keeps the
    logits of a multi-pass chunk in a workspace of R x nb floats a block)."""

    R: int
    n_rt: int
    cl: int
    nb: int
    ts: int
    nbmax: int
    npass: int
    n_s: int
    bs: int


def decode_plan(S: int, bs: int, TG: int, krow: int, vrow: int) -> DecodePlan:
    """Geometry of the decode kernel for a cache of S slots cut into chunks
    of bs, T*G query rows per kv head and K/V rows of krow/vrow bytes: tiles
    of one 8 KB ring stage (rows held at 16-byte strides), 8 blocks a
    cluster whenever a chunk holds 8 tiles (B 8 at S 2048: 512 blocks; B 1:
    64), each block's share of the chunk a whole number of tiles. A tile of
    16 slots or more is a whole number of 16 (P.V's bf16 ldmatrix reads V
    16 rows at a time, up to the end of the stage)."""
    R = min(TG, _ROWS)
    ts = max(1, _STAGE_BYTES // (-(-max(krow, vrow) // 16) * 16))
    if ts >= 16:
        ts -= ts % 16
    per = -(-bs // _CLUSTER)
    nb = -(-per // ts) * ts
    cl = -(-bs // nb)
    nbmax = max(ts, (_LOGIT_FLOATS // R) // ts * ts)
    return DecodePlan(R=R, n_rt=-(-TG // R), cl=cl, nb=nb, ts=ts, nbmax=nbmax,
                      npass=-(-nb // nbmax), n_s=-(-S // bs), bs=bs)


COPY_BULK, COPY_WORDS, COPY_BYTES = 0, 1, 2   # decode_common.cuh's copy modes


def copy_mode(*tensors) -> int:
    """How the decode kernel copies these caches' rows into shared memory:
    bulk copies when rows, batch/page and head strides and base addresses
    are all multiples of 16 bytes, 4-byte cp.async when they are multiples
    of 4 (a Q8_0 row of 100 codes), byte copies otherwise."""
    sizes = []
    for t in tensors:
        es = t.element_size()
        sizes += [t.shape[-1] * es, t.data_ptr()]
        sizes += [t.stride(i) * es for i in range(t.ndim - 1)]
    if all(n % 16 == 0 for n in sizes):
        return COPY_BULK
    return COPY_WORDS if all(n % 4 == 0 for n in sizes) else COPY_BYTES


# the prefill kernels of csrc/fa.cu
FA_ROWS = 64            # query rows (t, g) a block, both kernels
FA_STAGES = 3           # the tensor-core kernel's ring stages
SMEM_MAX = 232448       # dynamic shared memory a block may take (H100)
_FA_DV = (16, 32, 64, 96, 128, 192, 256)   # the CUDA-core kernel's Dv widths


@dataclass(frozen=True)
class FaPlan:
    """How the prefill kernel takes one call: ``kernel`` "tc" (tensor cores)
    or "cc" (CUDA cores); a block of ``rows`` query rows, ``bt`` tokens of
    one kv head's G heads; tiles of ``bs`` cache slots through ``nst`` ring
    stages; head sizes padded to ``dk`` / ``dv``; ``smem`` bytes of dynamic
    shared memory; ``grid`` (row tiles × split, kv heads, batch rows);
    ``split`` blocks of a cluster share a row tile's visible tiles."""

    kernel: str
    rows: int
    bt: int
    bs: int
    nst: int
    dk: int
    dv: int
    smem: int
    grid: tuple
    split: int = 1


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def prefill_plan(q_dtype, kv_dtype, B: int, T: int, H: int, Hkv: int, S: int, D: int,
                 Dv: int, maxp: int = 0, sms: int = 0) -> FaPlan:
    """The prefill kernel and its geometry for B rows of T tokens of H heads
    over S cache slots a row of Hkv kv heads; ``maxp`` > 0: a page pool's
    call, its rows' page tables of maxp pages (paged.cu's kernels), on a
    card of ``sms`` streaming multiprocessors (0: no card, no split).
    bf16 q over bf16 K/V or Q8_0 codes goes to the tensor-core kernel: D and
    Dv padded to whole 16s, tiles of 64 slots (32 where either is above
    128), and the shared memory of csrc/fa_tc.cuh's tc::make_layout (a page
    pool's block also holds its row's table). f32 q, or f32 K/V (the JAX
    package's QK^T or P.V in f32), goes to the CUDA-core kernel, its Dv
    padded to the next of 16, 32, 64, 96, 128, 192, 256 (paged_kernel also
    stages a tile's pool pages).

    A page pool's tensor-core grid is cut for the engine's page-chunked
    prefill, one row a call (B 1): a cluster of two blocks shares each
    (row tile, kv head)'s visible tiles when two blocks for each of the
    row's units still fit one resident wave of the card's SMs (two blocks
    an SM up to 128 columns, one above). A call of several rows is not
    split: where its rows are all valid, a split would run twice the
    blocks it needs."""
    bt = FA_ROWS // (H // Hkv)
    grid = (-(-T // bt), Hkv, B)
    if q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8):
        q8 = kv_dtype == torch.int8
        dk, dv = _up16(D), _up16(Dv)
        bs = 32 if max(dk, dv) > 128 else 64
        krow, vrow = 2 * dk + 16, 2 * dv + 16
        if q8:   # codes at 16-byte multiples, K and V scales; the bf16 tiles
            stage = bs * (dk + dv) + 12 * bs
            extra = bs * (krow + vrow)
        else:
            stage = bs * (krow + vrow) + 4 * bs
            extra = 0
        if bs < FA_ROWS:   # Q's rows apart from the tiles
            extra += FA_ROWS * krow
        # + the tile list, + the row's page table
        smem = FA_STAGES * stage + extra + _up16(4 * -(-S // bs)) + _up16(4 * maxp)
        split = 1
        if maxp and B == 1 and 2 * grid[0] * Hkv <= sms * (2 if max(dk, dv) <= 128 else 1):
            split = 2
            grid = (2 * grid[0], Hkv, B)
        return FaPlan("tc", FA_ROWS, bt, bs, FA_STAGES, dk, dv, smem, grid, split)
    dv = next(w for w in _FA_DV if w >= Dv)
    smem = 4 * (2 * FA_ROWS * (D + 1) + FA_ROWS * dv + FA_ROWS * (FA_ROWS + 1)) + 4 * (FA_ROWS + 2)
    if maxp:
        smem += 4 * FA_ROWS
    return FaPlan("cc", FA_ROWS, bt, FA_ROWS, 1, D, dv, smem, grid)


def fa_plan(q, k, v) -> FaPlan:
    """The prefill kernel and its geometry for one flash_attention call
    (``prefill_plan`` of its shapes and types)."""
    B, T, H, D = q.shape
    return prefill_plan(q.dtype, k.dtype, B, T, H, k.shape[1], k.shape[2], D, v.shape[3])


def _positional_penalty(q_pos: torch.Tensor, kv_pos: torch.Tensor, G: int,
                        swa: int) -> torch.Tensor:
    """(B, 1, T·G, S) penalty in position units: visible ⇔ 0 ≤ kp ≤ qp
    (∧ kp > qp − swa)."""
    qp = torch.repeat_interleave(q_pos, G, dim=1).to(torch.float32)[:, None, :, None]
    kp = kv_pos.to(torch.float32)[:, None, None, :]
    pen = torch.clamp(qp - kp, max=0.0) + torch.clamp(kp, max=0.0)
    if swa > 0:
        pen = pen + torch.clamp(kp - qp + float(swa) - 1.0, max=0.0)
    return pen


def flash_attention_plain(q, k, v, q_pos, kv_pos, scale=None, swa_window=0,
                          logit_softcap=0.0, sinks=None, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """Plain version of the fa kernel (one-shot softmax of the same logits)."""
    B, T, H, D = q.shape
    Hkv, S, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    cdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    if k_scale is not None:
        k = k.to(torch.float32) * k_scale[..., None]
        v = (v.to(torch.float32) * v_scale[..., None]).to(torch.bfloat16)
    qg = (q.reshape(B, T, Hkv, G, D).permute(0, 2, 1, 3, 4)
          .reshape(B, Hkv, T * G, D))
    logits = torch.matmul(qg.to(cdt).to(torch.float32),
                          k.to(cdt).to(torch.float32).transpose(2, 3)) * scale
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    logits = logits + _positional_penalty(q_pos, kv_pos, G, swa_window) * _NEG
    m = torch.amax(logits, dim=-1, keepdim=True)
    if sinks is not None:
        sink = sinks.to(torch.float32).reshape(1, Hkv, 1, G)
        sink = sink.expand(B, Hkv, T, G).reshape(B, Hkv, T * G, 1)
        m = torch.maximum(m, sink)
    p = torch.exp(logits - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    if sinks is not None:
        denom = denom + torch.exp(sink - m)
    out = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    out = out / torch.clamp(denom, min=1e-30)
    return (out.reshape(B, Hkv, T, G, Dv).permute(0, 2, 1, 3, 4)
            .reshape(B, T, H, Dv).to(q.dtype))


def flash_attention(q, k, v, q_pos, kv_pos, scale=None, swa_window=0,
                    logit_softcap=0.0, sinks=None, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """q (B,T,H,D); k (B,Hkv,S,D); v (B,Hkv,S,Dv); q_pos (B,T) int32 (−1 =
    padding row); kv_pos (B,S) int32 (−1 = empty slot); sinks (H,);
    k_scale/v_scale (B,Hkv,S) for Q8_0 K/V. Returns (B,T,H,Dv) in q's type."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, scale, swa_window,
                                     logit_softcap, sinks, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    B, T, H, D = q.shape
    Hkv, S, Dv = k.shape[1], k.shape[2], v.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    quantized = k_scale is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    kind = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}.get(k.dtype)
    if kind is None or v.dtype != k.dtype or (kind == 2) != quantized:
        raise TypeError(f"unsupported K/V types {k.dtype}/{v.dtype} "
                        f"(quantized={quantized})")
    if H % Hkv or H // Hkv > 64 or D > 256 or Dv > 256:
        raise ValueError(f"unsupported attention shape H={H} Hkv={Hkv} D={D} Dv={Dv}")
    for t, width in ((k, D), (v, Dv)):
        if t.stride(-1) != 1 or t.stride(-2) != width:
            raise ValueError("K/V rows must be contiguous")
    if kv_pos.stride(-1) != 1:
        raise ValueError("kv_pos rows must be contiguous")
    q = q.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32)
    if sinks is not None:
        sinks = sinks.to(torch.float32).contiguous()
    ks = k_scale.to(torch.float32) if quantized else None
    vs = v_scale.to(torch.float32) if quantized else None
    if quantized and (ks.stride() != vs.stride() or ks.stride(-1) != 1):
        raise ValueError("k_scale/v_scale need matching strides with contiguous rows")
    plan = fa_plan(q, k, v)
    lib = _build.load("fa")
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    scales = (ks.data_ptr() if quantized else None, vs.data_ptr() if quantized else None,
              ks.stride(0) if quantized else 0, ks.stride(1) if quantized else 0)
    tail = (q_pos.data_ptr(), kv_pos.data_ptr(), kv_pos.stride(0),
            sinks.data_ptr() if sinks is not None else None,
            float(scale), int(swa_window), float(logit_softcap))
    strides = (k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    if plan.kernel == "tc":
        fn = lib.slt_fa_tc
        if fn.argtypes is None:
            fn.argtypes = _TC_ARGTYPES
            fn.restype = ctypes.c_int
        err = fn(B, T, H, Hkv, S, D, Dv, q.data_ptr(), copy_mode(q), k.data_ptr(),
                 v.data_ptr(), int(quantized), copy_mode(k, v), *strides, *scales, *tail,
                 plan.bs, plan.grid[0], plan.smem, out.data_ptr(), _build.stream_ptr(q.device))
        _build.check(err, "fa_tc")
        flash_attention.launches_tc += 1
        return out
    fn = lib.slt_fa
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    err = fn(B, T, H, Hkv, S, D, Dv, q.data_ptr(), int(q.dtype == torch.bfloat16),
             k.data_ptr(), v.data_ptr(), kind, *strides, *scales, *tail,
             out.data_ptr(), _build.stream_ptr(q.device))
    _build.check(err, "fa")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0      # the CUDA-core kernel
flash_attention.launches_tc = 0   # the tensor-core kernel


# ----------------------------------------------------------- decode (split-KV)


def _fd_mode(k_scale) -> str:
    if k_scale is None:
        return "f"
    return "q4" if k_scale.ndim == 4 else "q8"


def flash_decode_plain(q, k, v, q_pos, kv_pos, scale=None, swa_window=0,
                       logit_softcap=0.0, sinks=None, k_scale=None, v_scale=None,
                       block_s=None) -> torch.Tensor:
    """Plain version of the fd kernel: the same chunks, roundings and
    combine, one chunk at a time."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    mode = _fd_mode(k_scale)
    Dv = v.shape[3] * (2 if mode == "q4" else 1)
    G = H // Hkv
    TG = T * G
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    qg = q.reshape(B, T, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(B, Hkv, TG, D)
    if mode == "q8":
        qf = qg.to(f32)
        qs, inv = quant_scale(torch.amax(torch.abs(qf), dim=-1, keepdim=True), 127.0)
        qd = torch.round(qf * inv).to(f64)
        qsc = qs * scale
    elif mode == "q4":
        qd = qg.to(bf16).to(f32)
    else:
        qd = qg.to(bf16 if q.dtype == bf16 else f32).to(f32)
    q_pos = q_pos.to(torch.int32)
    qpf = torch.repeat_interleave(q_pos, G, dim=1).to(f32)[:, None, :, None]
    big = 1 << 30
    qmax = q_pos.amax(dim=1)
    qmin = torch.where(q_pos < 0, big, q_pos).amin(dim=1)
    sink = None
    if sinks is not None:
        sink = (sinks.to(f32).reshape(1, Hkv, 1, G).expand(B, Hkv, T, G)
                .reshape(B, Hkv, TG, 1))
    def q4_operand(codes, scales):   # bf16((c - 8) · bf16(scale)), held in f32
        return q4_dequant(codes, scales.to(bf16).to(f32), bf16).to(f32)

    bs = min(S, block_s or FD_BLOCK_S)
    parts = []
    for s0 in range(0, S, bs):
        sl = slice(s0, min(S, s0 + bs))
        kp = kv_pos[:, sl].to(torch.int32)
        vis = torch.where(kp < 0, big, kp).amin(dim=1) <= qmax
        if swa_window > 0:
            vis &= torch.where(kp < 0, -big, kp).amax(dim=1) > qmin - swa_window
        kc, vc = k[:, :, sl], v[:, :, sl]
        if mode == "q8":
            ks, vs = k_scale[:, :, sl].to(f32), v_scale[:, :, sl].to(f32)
            ii = torch.matmul(qd, kc.to(f64).transpose(2, 3)).to(f32)
            logits = ii * qsc * ks[:, :, None, :]
        elif mode == "q4":
            kd = q4_operand(kc, k_scale[:, :, sl])
            logits = torch.matmul(qd, kd.transpose(2, 3)) * scale
        else:
            kd = kc.to(bf16 if q.dtype == bf16 else f32).to(f32)
            logits = torch.matmul(qd, kd.transpose(2, 3)) * scale
        if logit_softcap > 0.0:
            logits = logit_softcap * torch.tanh(logits / logit_softcap)
        kpf = kp.to(f32)[:, None, None, :]
        pen = torch.clamp(qpf - kpf, max=0.0) + torch.clamp(kpf, max=0.0)
        if swa_window > 0:
            pen = pen + torch.clamp(kpf - qpf + float(swa_window) - 1.0, max=0.0)
        logits = logits + pen * _NEG
        m = torch.amax(logits, dim=-1, keepdim=True)
        if sink is not None:
            m = torch.maximum(m, sink)
        p = torch.exp(logits - m)
        l = torch.sum(p, dim=-1, keepdim=True)
        if mode == "q8":
            pv = p * vs[:, :, None, :]
            ps, inv = quant_scale(torch.amax(torch.abs(pv), dim=-1, keepdim=True), 127.0)
            p8 = torch.round(pv * inv).to(f64)
            acc = torch.matmul(p8, vc.to(f64)).to(f32) * ps
        elif mode == "q4":
            vd = q4_operand(vc, v_scale[:, :, sl])
            acc = torch.matmul(p.to(bf16).to(f32), vd)
        else:
            acc = torch.matmul(p.to(v.dtype).to(f32), vc.to(f32))
        seen = vis[:, None, None, None]
        parts.append((torch.where(seen, m, torch.full_like(m, -1e30)),
                      torch.where(seen, l, torch.zeros_like(l)),
                      torch.where(seen, acc, torch.zeros_like(acc))))
    M = sink if sink is not None else torch.full((B, Hkv, TG, 1), -1e30, dtype=f32,
                                                 device=q.device)
    for m, _, _ in parts:
        M = torch.maximum(M, m)
    l = torch.exp(sink - M) if sink is not None else torch.zeros_like(M)
    acc = torch.zeros((B, Hkv, TG, Dv), dtype=f32, device=q.device)
    for m, lc, ac in parts:
        e = torch.exp(m - M)
        l = l + lc * e
        acc = acc + ac * e
    out = acc / torch.clamp(l, min=1e-30)
    return (out.reshape(B, Hkv, T, G, Dv).permute(0, 2, 1, 3, 4)
            .reshape(B, T, H, Dv).to(q.dtype))


def fd_plan(q, k, v, block_s=None) -> DecodePlan:
    """The decode kernel's geometry for one flash_decode_attention call."""
    T, H = q.shape[1], q.shape[2]
    Hkv, S = k.shape[1], k.shape[2]
    return decode_plan(S, min(S, block_s or FD_BLOCK_S), T * (H // Hkv),
                       k.shape[3] * k.element_size(), v.shape[3] * v.element_size())


def flash_decode_attention(q, k, v, q_pos, kv_pos, scale=None, swa_window=0,
                           logit_softcap=0.0, sinks=None, k_scale=None,
                           v_scale=None, block_s=None) -> torch.Tensor:
    """q (B,T,H,D); k/v (B,Hkv,S,D) float, int8 (Q8_0) or uint8 (Q4_0,
    S × D/2 packed bytes); q_pos (B,T) int32 (−1 = padding row); kv_pos
    (B,S) int32 (−1 = empty slot); k_scale/v_scale (B,Hkv,S) for Q8_0 or
    (B,Hkv,S,D/32) for Q4_0; block_s: cache slots per chunk (default 2048).
    Returns (B,T,H,Dv) in q's type; rows with q_pos < 0 are undefined."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, q_pos, kv_pos, scale, swa_window,
                                  logit_softcap, sinks, k_scale, v_scale, block_s)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention runs on cuda or cpu tensors, not {q.device}")
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    mode = _fd_mode(k_scale)
    Dv = v.shape[3] * (2 if mode == "q4" else 1)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    want = {"q8": torch.int8, "q4": torch.uint8}.get(mode)
    kind = 0
    if want is None:
        kind = {torch.float32: 0, torch.bfloat16: 1}.get(k.dtype)
        if kind is None or v.dtype != k.dtype:
            raise TypeError(f"unsupported float K/V types {k.dtype}/{v.dtype}")
    elif k.dtype != want or v.dtype != want or v_scale is None:
        raise TypeError(f"{mode} K/V need {want} codes and both scales")
    if H % Hkv or D > 256 or Dv > 256 or (mode == "q4" and (D % 32 or Dv % 32)):
        raise ValueError(f"unsupported decode shape H={H} Hkv={Hkv} D={D} Dv={Dv}")
    for t in (k, v):
        if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
            raise ValueError("K/V rows must be contiguous")
    if kv_pos.stride(-1) != 1:
        raise ValueError("kv_pos rows must be contiguous")
    if mode != "f":
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.stride(-1) != 1 or (
                    mode == "q4" and t.stride(-2) != t.shape[-1]):
                raise ValueError("K/V scales must be f32 with contiguous slots")
    plan = fd_plan(q, k, v, block_s)
    lib = _build.load("fd")
    fn = lib.slt_fd
    if fn.argtypes is None:
        fn.argtypes = _FD_ARGTYPES
        fn.restype = ctypes.c_int
    q = q.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32)
    if sinks is not None:
        sinks = sinks.to(torch.float32).contiguous()
    part = ws = None
    if plan.npass > 1:   # the chunk's logits between its K and V passes
        ws = torch.empty(B * Hkv * plan.n_s * plan.n_rt * plan.cl * plan.R * plan.nb,
                         dtype=torch.float32, device=q.device)
    if plan.n_s > 1:
        part = torch.empty((B, Hkv, plan.n_s, T * (H // Hkv), Dv + 2), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    quant = mode != "f"
    err = fn(B, T, H, Hkv, S, D, Dv, plan.bs, _FD_MODES[mode],
             plan.R, plan.cl, plan.nb, plan.ts, plan.nbmax,
             q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(), kind,
             k.stride(0), k.stride(1), v.stride(0), v.stride(1),
             k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
             k_scale.stride(0) if quant else 0, k_scale.stride(1) if quant else 0,
             v_scale.stride(0) if quant else 0, v_scale.stride(1) if quant else 0,
             q_pos.data_ptr(), kv_pos.data_ptr(), kv_pos.stride(0),
             sinks.data_ptr() if sinks is not None else None,
             float(scale), int(swa_window), float(logit_softcap), plan.npass,
             copy_mode(k, v), ws.data_ptr() if ws is not None else None,
             part.data_ptr() if part is not None else None, out.data_ptr(),
             _build.stream_ptr(q.device))
    _build.check(err, "fd")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
