"""Mamba-2 hybrid forwards: granitehybrid (Granite-4, Bamba), nemotron_h,
nemotron_h_moe and falcon-h1.

Counterpart of the JAX package's ``models/hybrid.py``:

 - granitehybrid (src/models/granite-hybrid.cpp): per layer Mamba-2 or
   attention (the per-layer head_count_kv array), Granite's four
   multipliers (embedding, residual, attention, logits), rope only when
   ``rope_finetuned`` (bamba), a dense or MoE FFN after every layer;
 - nemotron_h / nemotron_h_moe (src/models/nemotron-h.cpp): per layer
   exactly one of {Mamba-2, attention, FFN}: n_head_kv(il) == 0 and
   n_ff(il) == 0 is an SSM layer, n_head_kv(il) > 0 an attention layer,
   the rest relu² FFN layers (nemotron_h_moe's: gate-less relu² experts
   through the grouped matmul, beside a gate-less shared expert); no rope;
 - falcon-h1 (src/models/falcon-h1.cpp): every layer runs roped attention
   and a Mamba-2 mixer on the same normed input, summed into the residual,
   then a silu-gated FFN.

The memory is a ``HybridCache`` (KV slots for the attention layers, every
layer's for falcon-h1; conv + SSM state for the recurrent ones). Attention
takes the plain path over the whole flat cache, as in JAX (a speed item,
ROADMAP §2).
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..runtime.kv_cache import KVCache
from ..runtime.recurrent import HybridCache
from .hparams import HParams
from .jamba import attn_step, cached_attention, hybrid_layer_split
from .llama import dense_ffn, mm, moe_ffn
from .mamba import head, mamba_mixer, row_active


def _attn(layer: dict, hp: HParams, h: torch.Tensor, kv: KVCache, li: int,
          slots: torch.Tensor, mask: torch.Tensor, rope=None, safe_pos=None,
          kq_scale: float | None = None) -> torch.Tensor:
    """q / k / v (with their biases), the optional rope, the cached plain
    attention and the out-projection (with its bias)."""
    B, T, _ = h.shape
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v
    q, k, v = mm(h, layer["wq"]), mm(h, layer["wk"]), mm(h, layer["wv"])
    if "bq" in layer:
        q = q + layer["bq"]
    if "bk" in layer:
        k = k + layer["bk"]
    if "bv" in layer:
        v = v + layer["bv"]
    q, k, v = q.reshape(B, T, H, D), k.reshape(B, T, Hkv, D), v.reshape(B, T, Hkv, Dv)
    if rope is not None:
        inv_freq, mscale = rope
        q = ops.apply_rope(q, safe_pos, inv_freq, hp.rope_type, mscale)
        k = ops.apply_rope(k, safe_pos, inv_freq, hp.rope_type, mscale)
    a = cached_attention(kv, li, slots, q, k, v, mask, kq_scale or 1.0 / (D ** 0.5))
    out = mm(a.reshape(B, T, H * Dv), layer["wo"])
    if "bo" in layer:
        out = out + layer["bo"]
    return out


def hybrid_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                   cache: HybridCache, flash: bool | None = None,
                   s_window: int | None = None) -> tuple[torch.Tensor, HybridCache]:
    """One step over (B, T) tokens; returns (logits, cache), the cache
    updated in place. ``flash`` and ``s_window`` are accepted and ignored."""
    B = tokens.shape[0]
    arch = hp.arch
    attn_layers, rec_layers = hybrid_layer_split(hp)
    aidx = {il: i for i, il in enumerate(attn_layers)}
    ridx = {il: i for i, il in enumerate(rec_layers)}
    parallel_ssm = arch == "falcon-h1"        # attention and SSM in every layer
    pos = pos.to(torch.int32)
    active = row_active(pos, B)
    safe_pos = torch.clamp(pos, min=0)
    rope = None
    if parallel_ssm or hp.rope_finetuned:
        rope = ops.rope_frequencies(
            hp.head_dim, hp.n_rot, hp.rope_freq_base,
            1.0 / hp.rope_scale_factor if hp.rope_scaling == "linear" else 1.0,
            device=tokens.device)
    kq_scale = hp.f_attn_scale if hp.f_attn_scale > 0.0 else None    # granite
    res = hp.f_residual_scale
    kv, rec = cache.attn, cache.rec
    slots, mask = attn_step(kv, pos)

    x = params["token_embd"][tokens.to(torch.int64)] * hp.f_embedding_scale
    for il, layer in enumerate(params["layers"]):
        h = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        if parallel_ssm:
            a = _attn(layer, hp, h, kv, aidx[il], slots, mask, rope, safe_pos, kq_scale)
            li = ridx[il]
            s = mamba_mixer(layer, hp, h, rec.conv[li], rec.ssm[li], active)
            x = x + a + s
            x = x + dense_ffn(ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps), layer, hp)
            continue
        if hp.is_recurrent_layer(il):
            li = ridx[il]
            y = mamba_mixer(layer, hp, h, rec.conv[li], rec.ssm[li], active)
        elif il in aidx:
            y = _attn(layer, hp, h, kv, aidx[il], slots, mask, rope, safe_pos, kq_scale)
        else:                                  # nemotron_h's FFN layer
            y = moe_ffn(h, layer, hp) if "ffn_gate_inp" in layer else dense_ffn(h, layer, hp)
        x = x + y * res
        if arch.startswith("granite"):         # an FFN after every layer
            h = ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps)
            ffn = moe_ffn(h, layer, hp) if "ffn_gate_exps" in layer else dense_ffn(h, layer, hp)
            x = x + ffn * res
    logits = head(params, hp, x)
    if hp.logit_scale != 1.0:                  # granite's logits divisor
        logits = logits * hp.logit_scale
    return logits, cache
