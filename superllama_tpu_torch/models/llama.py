"""Llama-family forward pass (llama / llama2 / llama3 / mistral / qwen2 /
qwen3 dense models).

Counterpart of the JAX package's ``models/llama.py::llama_forward`` for the
dense path: RMSNorm, RoPE, grouped-query attention over the KV cache,
SwiGLU FFN, output head. Weights are plain tensors (in, out) or QTensors;
matmuls dispatch through ``qmatmul``. Attention follows the JAX routing:

 - paged cache (``PagedKVCache``): every step, prefill chunk or decode, runs
   the paged flash-attention kernel over the page tables;
 - prefill-sized steps on the GPU (T ≥ 32) run the flash-attention kernel,
   fed Q8_0 codes and scales straight from a Q8_0 cache (a Q4_0 cache is
   dequantized first);
 - decode-sized steps (T·G ≤ 32) on the GPU, or with ``hp.extra
   ["flash_decode"]``, run the split-KV decode kernel on a Q8_0 cache, and
   on a float or Q4_0 cache when ``hp.extra["flash_decode_float"]`` is set;
   ``hp.extra["flash_decode_off"]`` turns it off;
 - a step with ``attn_mask`` (lookahead's tree mask) turns flash and the
   decode kernel off and takes the plain path with that mask, as in JAX;
 - everything else takes the plain grouped-query path over the
   (dequantized) cache.
The KV cache is updated in place.

Not ported yet (they raise NotImplementedError): MoE, ALiBi, LayerNorm
models, llama4 / chameleon / deci extras, M-RoPE.
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..ops.flash_attention import flash_attention, flash_decode_attention
from ..ops.paged_attention import paged_flash_attention
from ..ops.qmatmul import qmatmul
from ..ops.qtensor import QTensor
from ..runtime.kv_cache import (KVCache, causal_mask, kv_advance, kv_layer,
                                kv_update_layer, kv_write_slots)
from ..runtime.paged_kv import PagedKVCache, paged_advance, paged_update_layer
from .hparams import ROPE_SCALING_YARN, HParams


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul dispatch: dense (in, out) tensor or QTensor. Decode-sized
    batches (≤ 16 rows) take the int8-activation GEMV."""
    if isinstance(w, QTensor):
        rows = x.numel() // x.shape[-1]
        return qmatmul(x, w, act_quant=rows <= 16)
    return x @ w


def _norm(x: torch.Tensor, obj: dict, key: str, hp: HParams) -> torch.Tensor:
    """RMSNorm by the weight under ``key`` (no weight: no norm)."""
    w = obj.get(key)
    if w is None:
        return x
    out = ops.rms_norm(x, w, hp.rms_eps)
    b = obj.get(key + "_b")
    return out if b is None else out + b


def _im(imx: dict | None, key: str, x: torch.Tensor) -> None:
    """Imatrix hook: accumulate the per-input-channel Σx² and the row count
    of the weight named ``key`` (IMatrixCollector::collect_imatrix's
    statistics, tools/imatrix/imatrix.cpp:219). Without a dict it does
    nothing, so the forward runs no extra operation."""
    if imx is None:
        return
    xf = x.to(torch.float32).reshape(-1, x.shape[-1])
    imx[key] = imx.get(key, 0) + torch.sum(xf * xf, dim=0)
    imx[key + ".__count"] = imx.get(key + ".__count", 0) + xf.shape[0]


def dense_ffn(x: torch.Tensor, layer: dict, hp: HParams, imx: dict | None = None,
              pfx: str = "") -> torch.Tensor:
    if "ffn_gate" not in layer:
        raise NotImplementedError("gate-less FFNs are not ported yet")
    _im(imx, pfx + "ffn_up.weight", x)
    gate = mm(x, layer["ffn_gate"])
    up = mm(x, layer["ffn_up"])
    if "ffn_up_b" in layer:
        up = up + layer["ffn_up_b"]
    if "ffn_gate_b" in layer:
        gate = gate + layer["ffn_gate_b"]
    act = ops.GLU_FNS[hp.act](gate, up)
    _im(imx, pfx + "ffn_down.weight", act)
    out = mm(act, layer["ffn_down"])
    if "ffn_down_b" in layer:
        out = out + layer["ffn_down_b"]
    return out


def rope_setup(params: dict, hp: HParams, device):
    """Rope frequency tables for full-attention and SWA layers:
    (inv_freq, mscale, inv_freq_swa, mscale_swa), with yarn / linear scaling
    and llama-3.1 per-dim frequency factors (rope_freqs)."""
    D = hp.head_dim
    if hp.rope_scaling == ROPE_SCALING_YARN and hp.rope_orig_ctx > 0:
        inv_freq, mscale = ops.rope_frequencies(
            D, hp.n_rot, hp.rope_freq_base, 1.0 / hp.rope_scale_factor,
            ext_factor=1.0, attn_factor=hp.rope_attn_factor,
            orig_ctx=hp.rope_orig_ctx, device=device)
    else:
        scale = 1.0 / hp.rope_scale_factor if hp.rope_scaling == "linear" else 1.0
        inv_freq, mscale = ops.rope_frequencies(D, hp.n_rot, hp.rope_freq_base,
                                                scale, device=device)
    if params.get("rope_freqs") is not None:
        inv_freq = inv_freq / params["rope_freqs"].to(inv_freq.dtype)
    if hp.rope_freq_base_swa > 0.0:
        inv_freq_swa, mscale_swa = ops.rope_frequencies(
            D, hp.n_rot, hp.rope_freq_base_swa, 1.0, device=device)
    else:
        inv_freq_swa, mscale_swa = inv_freq, mscale
    return inv_freq, mscale, inv_freq_swa, mscale_swa


_UNPORTED_EXTRA = ("llama4", "mrope_sections", "imrope", "swin_norm",
                   "logit_suppress", "rope_swa_only", "no_rope_mod_zero",
                   "qk_norm_post_rope", "moe_dense_parallel_scale")


def _check_supported(params: dict, hp: HParams) -> None:
    unported = [name for name, on in (
        ("alibi", hp.alibi), ("LayerNorm", hp.norm_type == "ln"),
        ("parallel residual", hp.parallel_residual),
        ("per-layer head counts", hp.n_head_arr is not None),
        ("MoE", hp.n_expert > 0),
        ("learned positions", params.get("position_embd") is not None),
        *((f"hparams extra {k!r}", k in hp.extra) for k in _UNPORTED_EXTRA))
        if on]
    if unported:
        raise NotImplementedError(f"{hp.arch}: {', '.join(unported)} not ported yet")


def llama_forward(
    params: dict,
    hp: HParams,
    tokens: torch.Tensor,     # (B, T) int
    pos: torch.Tensor,        # (B, T) int32; -1 marks padding
    cache: KVCache | PagedKVCache,
    flash: bool | None = None,
    s_window: int | None = None,
    attn_mask: torch.Tensor | None = None,
    imatrix: dict | None = None,
) -> tuple[torch.Tensor, KVCache | PagedKVCache]:
    """One forward step (prefill or decode). Returns (logits (B, T, V), cache);
    the cache is updated in place.

    ``s_window``: cap on how many cache slots attention reads (the engine's
    decode-length bucketing); every valid slot index must be below it. Dense
    caches only.

    ``attn_mask``: an additive (B, 1, T, S) mask that replaces the causal
    mask (tree attention); it turns flash and the decode kernel off. Dense
    caches only.

    ``imatrix``: a dict to accumulate each matmul weight's input Σx² and
    row count in, keyed by GGUF weight name (``tools/imatrix.py``); None
    (the default) adds no operation.

    ``flash=None`` selects the flash-attention kernel for prefill-sized
    steps on the GPU (T ≥ 32); see the module docstring for the rest."""
    _check_supported(params, hp)
    B, T = tokens.shape
    on_gpu = tokens.device.type == "cuda"
    if flash is None:
        flash = on_gpu and T >= 32
    if attn_mask is not None:
        if isinstance(cache, PagedKVCache):
            raise ValueError("attn_mask needs a dense KV cache")
        flash = False       # a custom mask rides the additive-mask path
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v
    pos = pos.to(torch.int32)
    paged = isinstance(cache, PagedKVCache)
    # split-KV decode kernel: decode-sized steps on a Q8_0 cache, and on any
    # other dense cache when flash_decode_float asks for it
    fdec = (not flash and not paged and attn_mask is None
            and not hp.extra.get("flash_decode_off")
            and (on_gpu or bool(hp.extra.get("flash_decode")))
            and T * (H // Hkv) <= 32
            and ((cache.quantized and not cache.q4)
                 or bool(hp.extra.get("flash_decode_float"))))

    inv_freq, mscale, inv_freq_swa, mscale_swa = rope_setup(params, hp, tokens.device)
    kq_scale = hp.f_attn_scale if hp.f_attn_scale > 0.0 else 1.0 / (D ** 0.5)
    safe_pos = torch.clamp(pos, min=0)
    x = params["token_embd"][tokens.to(torch.int64)] * hp.f_embedding_scale

    if paged:
        pslots, poffs = paged_advance(cache, pos)
    else:
        slots = kv_write_slots(cache, T)
        kv_advance(cache, slots, pos)
        S = cache.max_seq
        if s_window is not None and s_window >= S:
            s_window = None
        Sw = s_window or S
        wpos = cache.positions(Sw)
        if attn_mask is not None:
            mask_full = mask_swa = attn_mask.to(torch.float32)
        elif not flash and not fdec:
            mask_full = causal_mask(wpos, pos)
            mask_swa = causal_mask(wpos, pos, hp.swa_window) if hp.swa_window else mask_full

    for il, layer in enumerate(params["layers"]):
        pfx = f"blk.{il}."
        h = _norm(x, layer, "attn_norm", hp)
        _im(imatrix, pfx + "attn_q.weight", h)
        q = mm(h, layer["wq"])
        k = mm(h, layer["wk"])
        v = mm(h, layer["wv"])
        if "bq" in layer:
            q = q + layer["bq"]
        if "bk" in layer:
            k = k + layer["bk"]
        if "bv" in layer:
            v = v + layer["bv"]
        if hp.f_clamp_kqv > 0.0:
            c = hp.f_clamp_kqv
            q, k, v = (torch.clamp(t, -c, c) for t in (q, k, v))
        qn = layer.get("attn_q_norm")
        if qn is not None and qn.ndim != 1:
            raise NotImplementedError("per-head LayerNorm q/k norms are not ported yet")
        full_width_qk_norm = qn is not None and qn.shape[-1] == H * D
        if full_width_qk_norm:           # olmo2-style, before the head split
            q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
            k = ops.rms_norm(k, layer["attn_k_norm"], hp.rms_eps)
        q = q.reshape(B, T, H, D)
        k = k.reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, Dv)
        if qn is not None and not full_width_qk_norm:   # qwen3 per-head norms
            q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
            k = ops.rms_norm(k, layer["attn_k_norm"], hp.rms_eps)

        swa = hp.swa_window if hp.is_swa_layer(il) else 0
        f, ms = (inv_freq_swa, mscale_swa) if swa else (inv_freq, mscale)
        nope = (hp.n_no_rope_layer_step > 0
                and (il + 1) % hp.n_no_rope_layer_step == 0)
        if hp.rope_type >= 0 and hp.n_rot > 0 and not nope:
            q = ops.apply_rope(q, safe_pos, f, hp.rope_type, ms)
            k = ops.apply_rope(k, safe_pos, f, hp.rope_type, ms)

        sinks = layer.get("attn_sinks")
        akw = dict(scale=kq_scale, swa_window=swa, logit_softcap=hp.attn_logit_softcap,
                   sinks=sinks)
        if paged:
            paged_update_layer(cache, il, pslots, poffs, k, v)
            attn = paged_flash_attention(q, cache.k_pages[il], cache.v_pages[il], pos,
                                         cache.page_pos, cache.table, **akw)
        else:
            kv_update_layer(cache, il, slots, k, v)
            if fdec or (flash and cache.quantized and not cache.q4):
                ck, cv, ks, vs = cache.layer(il, Sw)   # codes and scales as stored
            else:
                (ck, cv), ks, vs = kv_layer(cache, il, k.dtype, Sw), None, None
            if fdec:
                attn = flash_decode_attention(q, ck, cv, pos, wpos, k_scale=ks,
                                              v_scale=vs, **akw)
            elif flash:
                attn = flash_attention(q, ck, cv, pos, wpos, k_scale=ks, v_scale=vs,
                                       **akw)
            else:
                # grouped-query path when K/V traffic dominates (long context
                # or multi-row batches), the repeat-KV reference otherwise
                attn_fn = (ops.attention_gqa if (ck.shape[2] >= 1024 or B >= 2)
                           else ops.attention_ref)
                attn = attn_fn(q, ck, cv, mask_swa if swa else mask_full, scale=kq_scale,
                               logit_softcap=hp.attn_logit_softcap, sinks=sinks)
        attn = attn.reshape(B, T, H * Dv)
        _im(imatrix, pfx + "attn_output.weight", attn)
        attn = mm(attn, layer["wo"])
        if "bo" in layer:
            attn = attn + layer["bo"]
        attn = _norm(attn, layer, "attn_post_norm", hp)
        x = x + attn * hp.f_residual_scale
        ffn = dense_ffn(_norm(x, layer, "ffn_norm", hp), layer, hp, imatrix, pfx)
        ffn = _norm(ffn, layer, "ffn_post_norm", hp)
        x = x + ffn * hp.f_residual_scale

    x = _norm(x, params, "output_norm", hp)
    w_out = params.get("output")
    logits = mm(x, w_out) if w_out is not None else x @ params["token_embd"].T
    if params.get("output_b") is not None:
        logits = logits + params["output_b"]
    if hp.logit_scale != 1.0:
        logits = logits * hp.logit_scale
    if hp.final_logit_softcap > 0.0:
        logits = hp.final_logit_softcap * torch.tanh(
            logits.to(torch.float32) / hp.final_logit_softcap).to(logits.dtype)
    return logits, cache
