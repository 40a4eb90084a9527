"""PLaMo-2 forward: PLaMo-2 mamba layers (per-layer head_count_kv 0) and
fused-qkv attention layers, each mixer and FFN between pre- and post-RMS
norms, and a gate ∥ up SwiGLU FFN split by the loader.

Counterpart of the JAX package's ``models/plamo2.py`` (src/models/plamo2.cpp):
attention with per-head q / k RMS norms before a NEOX rope and a
1 / sqrt(head_dim_v) scale; an attention layer with fewer KV heads than the
cache pads its K / V heads with zeros into the cache and reads back only its
own. The mamba layers are ``models/mamba.py::plamo2_mixer``. The memory is
a ``HybridCache``; attention takes the plain path over the whole flat
cache, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import ref as ops
from ..runtime.recurrent import HybridCache
from .hparams import HParams
from .jamba import attn_step, cached_attention, hybrid_layer_split
from .llama import mm
from .mamba import head, plamo2_mixer, row_active


def plamo2_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                   cache: HybridCache, flash: bool | None = None,
                   s_window: int | None = None) -> tuple[torch.Tensor, HybridCache]:
    """One step over (B, T) tokens; returns (logits, cache), the cache
    updated in place. ``flash`` and ``s_window`` are accepted and ignored."""
    B, T = tokens.shape
    attn_layers, rec_layers = hybrid_layer_split(hp)
    aidx = {il: i for i, il in enumerate(attn_layers)}
    ridx = {il: i for i, il in enumerate(rec_layers)}
    Hkv, D, Dv = hp.n_head_kv, hp.head_dim, hp.head_dim_v
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
            li = ridx[il]
            y = plamo2_mixer(layer, hp, h, rec.conv[li], rec.ssm[li], active)
        else:
            H_l, Hkv_l = hp.n_head_il(il), hp.n_head_kv_il(il)
            q = mm(h, layer["wq"]).reshape(B, T, H_l, D)
            k = mm(h, layer["wk"]).reshape(B, T, Hkv_l, D)
            v = mm(h, layer["wv"]).reshape(B, T, Hkv_l, Dv)
            q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
            k = ops.rms_norm(k, layer["attn_k_norm"], hp.rms_eps)
            q = ops.apply_rope(q, safe_pos, inv_freq, hp.rope_type, mscale)
            k = ops.apply_rope(k, safe_pos, inv_freq, hp.rope_type, mscale)
            if Hkv_l < Hkv:                   # pad the heads into the cache
                k = F.pad(k, (0, 0, 0, Hkv - Hkv_l))
                v = F.pad(v, (0, 0, 0, Hkv - Hkv_l))
            a = cached_attention(kv, aidx[il], slots, q, k, v, mask, 1.0 / (Dv ** 0.5),
                                 n_kv=Hkv_l)
            y = mm(a.reshape(B, T, H_l * Dv), layer["wo"])
        x = x + ops.rms_norm(y, layer["attn_post_norm"], hp.rms_eps)
        h2 = ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        ffn = mm(ops.silu(mm(h2, layer["ffn_gate"])) * mm(h2, layer["ffn_up"]),
                 layer["ffn_down"])
        x = x + ops.rms_norm(ffn, layer["ffn_post_norm"], hp.rms_eps)
    return head(params, hp, x), cache
