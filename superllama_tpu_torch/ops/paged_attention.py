"""Paged flash attention: attention over a page pool through page tables.

Counterpart of the JAX package's ``ops/paged_attention.py``: K/V live in a
pool ``(N_pages, H_kv, P, D)`` shared by every sequence, row b's logical page
lg sits in pool page ``page_table[b, lg]`` (−1 = absent), and pool page 0 is
the NULL page whose positions are all −1, so absent pages mask themselves
arithmetically. Masking, sinks, softcap and the dot types are those of
``flash_attention``.

On CUDA tensors ``paged_flash_attention`` launches the hand-written kernel of
``csrc/paged.cu`` that ``paged_plan`` picks: the decode cluster kernel at
T·G ≤ 32; above that, fa's tensor-core kernel addressed through the page
table for bf16 q over bf16 pages (counted in
``paged_flash_attention.launches_tc``), the CUDA-core prefill kernel for f32
q or f32 pages. The decode and CUDA-core launches are counted in
``paged_flash_attention.launches``. On CPU tensors it runs
``paged_flash_attention_plain``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import (DecodePlan, FaPlan, copy_mode, decode_plan,
                              flash_attention_plain, prefill_plan)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_ARGTYPES = [_I] * 14 + [_P, _I, _P, _P, _I, _L, _L, _L, _L, _P, _P, _P, _P, _F, _I, _F,
                         _P, _P]
_TC_ARGTYPES = [_I] * 8 + [_P, _I, _P, _P, _I, _L, _L, _L, _L, _P, _P, _P, _P, _F, _I, _F,
                           _I, _I, _I, _I, _P, _P]
DECODE_ROWS = 32   # T·G up to which a call takes the decode cluster kernel


def paged_plan(q, k_pages, v_pages, page_table, sms=None) -> DecodePlan | FaPlan:
    """The kernel and its geometry for one paged_flash_attention call. At
    T·G ≤ 32 the decode kernel's (one chunk: the row's MAXP·P slots,
    divided among a cluster's blocks); above, the prefill kernel's
    (``prefill_plan`` over the row's MAXP·P logical slots: "tc" for bf16 q
    over bf16 pages, "cc" for f32 q or f32 pages), its cluster split sized
    to ``sms`` streaming multiprocessors: by default those of q's card, none
    for CPU tensors."""
    B, T, H, D = q.shape
    Hkv, P = k_pages.shape[1], k_pages.shape[2]
    MAXP = page_table.shape[1]
    S = MAXP * P
    if T * (H // Hkv) > DECODE_ROWS:
        if sms is None:
            sms = _build.sm_count(q.device) if q.device.type == "cuda" else 0
        return prefill_plan(q.dtype, k_pages.dtype, B, T, H, Hkv, S, D, v_pages.shape[3],
                            maxp=MAXP, sms=sms)
    return decode_plan(S, S, T * (H // Hkv), k_pages.shape[3] * k_pages.element_size(),
                       v_pages.shape[3] * v_pages.element_size())


def paged_flash_attention_plain(q, k_pages, v_pages, q_pos, page_pos, page_table,
                                scale=None, swa_window=0, logit_softcap=0.0,
                                sinks=None) -> torch.Tensor:
    """Plain version of the paged kernel: gather each row's pages (absent
    ones read the NULL page) into a dense cache and attend over it."""
    B = q.shape[0]
    N, Hkv, P, D = k_pages.shape
    tbl = torch.clamp(page_table.to(torch.int64), min=0)            # (B, MAXP)
    k = k_pages[tbl].permute(0, 2, 1, 3, 4).reshape(B, Hkv, -1, D)
    v = v_pages[tbl].permute(0, 2, 1, 3, 4).reshape(B, Hkv, -1, v_pages.shape[-1])
    kv_pos = page_pos[tbl].reshape(B, -1)
    return flash_attention_plain(q, k, v, q_pos, kv_pos, scale, swa_window,
                                 logit_softcap, sinks)


def paged_flash_attention(q, k_pages, v_pages, q_pos, page_pos, page_table,
                          scale=None, swa_window=0, logit_softcap=0.0,
                          sinks=None) -> torch.Tensor:
    """q (B,T,H,D); k_pages (N,Hkv,P,D); v_pages (N,Hkv,P,Dv) f32/bf16;
    q_pos (B,T) int32 (−1 = padding row); page_pos (N,P) int32 (−1 = empty);
    page_table (B,MAXP) int32 (−1 = absent); sinks (H,). Returns (B,T,H,Dv)
    in q's type; rows with q_pos < 0 are undefined."""
    if q.device.type == "cpu":
        return paged_flash_attention_plain(q, k_pages, v_pages, q_pos, page_pos,
                                           page_table, scale, swa_window,
                                           logit_softcap, sinks)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention runs on cuda or cpu tensors, not {q.device}")
    B, T, H, D = q.shape
    Hkv, P, Dv = k_pages.shape[1], k_pages.shape[2], v_pages.shape[3]
    MAXP = page_table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    kind = {torch.float32: 0, torch.bfloat16: 1}.get(k_pages.dtype)
    if kind is None or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"unsupported page types {k_pages.dtype}/{v_pages.dtype}")
    if H % Hkv or H // Hkv > 64 or D > 256 or Dv > 256:
        raise ValueError(f"unsupported attention shape H={H} Hkv={Hkv} D={D} Dv={Dv}")
    for t, width in ((k_pages, D), (v_pages, Dv)):
        if t.stride(-1) != 1 or t.stride(-2) != width:
            raise ValueError("page rows must be contiguous")
    lib = _build.load("paged")
    plan = paged_plan(q, k_pages, v_pages, page_table)
    q = q.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    page_pos = page_pos.to(torch.int32).contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    if sinks is not None:
        sinks = sinks.to(torch.float32).contiguous()
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    strides = (k_pages.stride(0), k_pages.stride(1), v_pages.stride(0), v_pages.stride(1))
    tail = (q_pos.data_ptr(), page_pos.data_ptr(), page_table.data_ptr(),
            sinks.data_ptr() if sinks is not None else None,
            float(scale), int(swa_window), float(logit_softcap))
    if isinstance(plan, FaPlan) and plan.kernel == "tc":
        fn = lib.slt_paged_tc
        if fn.argtypes is None:
            fn.argtypes = _TC_ARGTYPES
            fn.restype = ctypes.c_int
        err = fn(B, T, H, Hkv, P, MAXP, D, Dv, q.data_ptr(), copy_mode(q),
                 k_pages.data_ptr(), v_pages.data_ptr(), copy_mode(k_pages, v_pages), *strides,
                 *tail, plan.bs, plan.grid[0] // plan.split, plan.smem, plan.split,
                 out.data_ptr(), _build.stream_ptr(q.device))
        _build.check(err, "paged_tc")
        paged_flash_attention.launches_tc += 1
        return out
    geo = (0, 0, 0, 0, 0, 0)
    if isinstance(plan, DecodePlan):
        geo = (plan.R, plan.cl, plan.nb, plan.ts, plan.nbmax, copy_mode(k_pages, v_pages))
    fn = lib.slt_paged
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    err = fn(B, T, H, Hkv, P, MAXP, D, Dv, *geo, q.data_ptr(), int(q.dtype == torch.bfloat16),
             k_pages.data_ptr(), v_pages.data_ptr(), kind, *strides, *tail,
             out.data_ptr(), _build.stream_ptr(q.device))
    _build.check(err, "paged")
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0      # the decode and CUDA-core prefill kernels
paged_flash_attention.launches_tc = 0   # the tensor-core prefill kernel
