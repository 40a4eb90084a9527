"""Flash attention with positional masking (ggml_flash_attn_ext semantics).

Counterpart of the JAX package's ``flash_attention``: GQA, positional
causal / sliding-window / empty-slot masking from ``q_pos`` and ``kv_pos``
as additive −1e9-per-position penalties, logit softcap, attention sinks and
optional Q8_0 K/V (int8 codes with per-row f32 scales). Inputs keep the JAX
layout: q (B, T, H, D), k/v (B, Hkv, S, D).

On CUDA tensors ``flash_attention`` launches the hand-written kernel of
``csrc/fa.cu``; on CPU tensors it runs ``flash_attention_plain``. Launches
are counted in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG = 1e9  # per-unit positional penalty; violations are >= 1 position apart

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_ARGTYPES = [_I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _L, _L, _L, _L,
             _P, _P, _L, _L, _P, _P, _L, _P, _F, _I, _F, _P, _P]


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
    if H % Hkv or H // Hkv > 64 or D > 256 or Dv not in (16, 32, 64, 128):
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
    lib = _build.load("fa")
    fn = lib.slt_fa
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    err = fn(B, T, H, Hkv, S, D, Dv, q.data_ptr(), int(q.dtype == torch.bfloat16),
             k.data_ptr(), v.data_ptr(), kind, k.stride(0), k.stride(1),
             v.stride(0), v.stride(1),
             ks.data_ptr() if quantized else None,
             vs.data_ptr() if quantized else None,
             ks.stride(0) if quantized else 0, ks.stride(1) if quantized else 0,
             q_pos.data_ptr(), kv_pos.data_ptr(), kv_pos.stride(0),
             sinks.data_ptr() if sinks is not None else None,
             float(scale), int(swa_window), float(logit_softcap),
             out.data_ptr(), _build.stream_ptr(q.device))
    _build.check(err, "fa")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
