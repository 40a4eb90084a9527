"""LFM2 / LFM2-MoE forward: a hybrid stack of short-conv mixer layers and
GQA attention layers (the per-layer head_count_kv selects), each followed
by a dense or MoE FFN.

Counterpart of the JAX package's ``models/lfm2.py`` (src/models/lfm2.cpp):
the short conv's in-projection gives [b, c, x]; b⊙x runs through a
depthwise causal conv over time (kernel ``shortconv_conv``, L_cache long)
whose rolling state is the last L_cache − 1 columns; y = out_proj(c ⊙ conv).
Attention layers norm q / k per head before a NEOX rope and attend on the
plain path over the whole flat cache, as in JAX (``ops.attention_ref``). The
FFN is ``moe_ffn`` (the hand-written grouped matmul) where the layer has
experts, else dense. The final norm ships as ``token_embd_norm``; the loader
moves it to ``output_norm``.

The short conv stays plain torch (a cat, L_cache products and adds), like
``models/mamba.py::_conv``: it has no JAX kernel (ROADMAP §2 holds its
fusion). Its state, and the KV cache, are written in place; rows whose
pos[:, 0] < 0 keep their conv state.
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..runtime.recurrent import HybridCache
from .hparams import HParams
from .jamba import attn_step, cached_attention, hybrid_layer_split
from .llama import dense_ffn, mm, moe_ffn
from .mamba import _store, head, row_active


def shortconv_mixer(layer: dict, h: torch.Tensor, conv_state: torch.Tensor,
                    active: torch.Tensor | None = None) -> torch.Tensor:
    """One short-conv block over (B, T, E); conv_state (B, L − 1, E) in the
    cache's type, written in place (kept on inactive rows). Returns y."""
    B, T, E = h.shape
    bcx = mm(h, layer["shortconv_in"])                        # (B, T, 3E)
    b, c, x = bcx[..., :E], bcx[..., E:2 * E], bcx[..., 2 * E:]
    bx = b * x
    full = torch.cat([conv_state.to(bx.dtype), bx], dim=1)
    kernel = layer["shortconv_conv"]                          # (L_cache, E)
    L = kernel.shape[0]
    out = torch.zeros_like(bx)
    for j in range(L):                                        # depthwise causal conv
        out = out + kernel[j][None, None, :] * full[:, j:j + T]
    _store(conv_state, full[:, -(L - 1):], active)
    return mm(c * out, layer["shortconv_out"])


def lfm2_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                 cache: HybridCache, flash: bool | None = None,
                 s_window: int | None = None) -> tuple[torch.Tensor, HybridCache]:
    """One step over (B, T) tokens of lfm2 / lfm2moe; returns (logits,
    cache), the cache updated in place. ``flash`` and ``s_window`` are
    accepted and ignored."""
    B, T = tokens.shape
    attn_layers, rec_layers = hybrid_layer_split(hp)
    aidx = {il: i for i, il in enumerate(attn_layers)}
    ridx = {il: i for i, il in enumerate(rec_layers)}
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v
    pos = pos.to(torch.int32)
    active = row_active(pos, B)
    inv_freq, mscale = ops.rope_frequencies(
        D, hp.n_rot, hp.rope_freq_base,
        1.0 / hp.rope_scale_factor if hp.rope_scaling == "linear" else 1.0,
        device=tokens.device)
    safe_pos = torch.clamp(pos, min=0)
    kv, rec = cache.attn, cache.rec
    slots, mask = attn_step(kv, pos)

    x = params["token_embd"][tokens.to(torch.int64)]
    for il, layer in enumerate(params["layers"]):
        h = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        if hp.is_recurrent_layer(il):
            y = shortconv_mixer(layer, h, rec.conv[ridx[il]], active)
        else:
            q = mm(h, layer["wq"]).reshape(B, T, H, D)
            k = mm(h, layer["wk"]).reshape(B, T, Hkv, D)
            v = mm(h, layer["wv"]).reshape(B, T, Hkv, Dv)
            q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
            k = ops.rms_norm(k, layer["attn_k_norm"], hp.rms_eps)
            q = ops.apply_rope(q, safe_pos, inv_freq, hp.rope_type, mscale)
            k = ops.apply_rope(k, safe_pos, inv_freq, hp.rope_type, mscale)
            a = cached_attention(kv, aidx[il], slots, q, k, v, mask, 1.0 / (D ** 0.5))
            y = mm(a.reshape(B, T, H * Dv), layer["wo"])
        x = x + y
        h2 = ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        x = x + (moe_ffn(h2, layer, hp) if "ffn_gate_exps" in layer else dense_ffn(h2, layer, hp))
    return head(params, hp, x), cache
