"""Jamba-family hybrid forward: attention and Mamba-1 layers interleaved,
with a dense or MoE FFN.

Counterpart of the JAX package's ``models/jamba.py`` (src/models/jamba.cpp):
per layer, n_head_kv(il) == 0 routes to the Mamba-1 mixer (with jamba's
dt / B / C RMS norms), any other layer to rope-less attention; the FFN is
``moe_ffn`` where the layer has experts (the hand-written grouped matmul),
else dense. The memory is a ``HybridCache``: a flat KV cache over the
attention layers and a recurrent store over the SSM layers, each indexed by
its own compact layer list (``hybrid_layer_split``).

Attention takes the plain path over the whole flat cache, as the JAX
forward does (``ops.attention_ref``); moving it onto the fa / fd kernels is
a speed item (ROADMAP §2). Rows whose pos[:, 0] < 0 keep their recurrent
state (``models/mamba.py``). The KV cache must be a float one: the hybrid
memory refuses a quantized cache (``cache_policy.make_cache``).
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..runtime.kv_cache import (KVCache, causal_mask, kv_advance, kv_cache_init,
                                kv_update_layer, kv_write_slots)
from ..runtime.recurrent import HybridCache, recurrent_cache_init
from .hparams import HParams
from .llama import dense_ffn, mm, moe_ffn
from .mamba import _mamba_mixer, head, row_active


def hybrid_layer_split(hp: HParams) -> tuple[list[int], list[int]]:
    """(attention layers, SSM layers). falcon-h1 runs both in every layer;
    nemotron_h has pure-FFN layers in neither list."""
    if hp.arch == "falcon-h1":
        alls = list(range(hp.n_layer))
        return alls, list(alls)
    if hp.arch == "qwen3next":   # head counts are uniform: split by formula
        rec = [il for il in range(hp.n_layer) if hp.is_recurrent_layer(il)]
        return [il for il in range(hp.n_layer) if il not in rec], rec
    attn = [il for il in range(hp.n_layer) if hp.n_head_kv_il(il) > 0]
    rec = [il for il in range(hp.n_layer) if hp.is_recurrent_layer(il)]
    return attn, rec


def hybrid_cache_init(hp: HParams, batch: int, max_seq: int, dtype=torch.float32,
                      device="cpu") -> HybridCache:
    """The hybrid memory of hp: KV over the attention layers, conv + SSM
    state over the recurrent ones (lfm2's short conv: rolling conv columns
    of n_embd, no SSM state)."""
    attn, rec = hybrid_layer_split(hp)
    if hp.shortconv_l_cache > 0:
        rec_cache = recurrent_cache_init(len(rec), batch, hp.shortconv_l_cache, 1, 1, dtype,
                                         conv_dim=hp.n_embd, device=device)
    else:
        rec_cache = recurrent_cache_init(len(rec), batch, hp.ssm_d_conv, hp.ssm_d_inner,
                                         hp.ssm_d_state, dtype, conv_dim=hp.ssm_conv_dim,
                                         device=device)
    return HybridCache(attn=kv_cache_init(len(attn), batch, max_seq, hp.n_head_kv,
                                          hp.head_dim, hp.head_dim_v, dtype=dtype,
                                          device=device),
                       rec=rec_cache)


def attn_step(kv: KVCache, pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The step's write slots (recorded with their positions, cursors
    advanced, in place) and the causal mask over the whole cache."""
    if kv.quantized:
        raise ValueError("the hybrid forwards need a float KV cache, as the JAX ones read "
                         "the cache's K / V as stored")
    slots = kv_write_slots(kv, pos.shape[1])
    kv_advance(kv, slots, pos)
    return slots, causal_mask(kv.positions(), pos)


def cached_attention(kv: KVCache, li: int, slots: torch.Tensor, q: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                     scale: float, n_kv: int | None = None) -> torch.Tensor:
    """Write k / v at the slots of cache layer li and attend q over the
    layer's first n_kv heads (all by default), the plain path."""
    kv_update_layer(kv, li, slots, k, v)
    S = kv.max_seq
    return ops.attention_ref(q, kv.k[li][:, :n_kv, :S], kv.v[li][:, :n_kv, :S], mask,
                             scale=scale)


def jamba_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                  cache: HybridCache, flash: bool | None = None,
                  s_window: int | None = None) -> tuple[torch.Tensor, HybridCache]:
    """One step over (B, T) tokens; returns (logits, cache), the cache
    updated in place. ``flash`` and ``s_window`` are accepted and ignored."""
    B, T = tokens.shape
    attn_layers, rec_layers = hybrid_layer_split(hp)
    aidx = {il: i for i, il in enumerate(attn_layers)}
    ridx = {il: i for i, il in enumerate(rec_layers)}
    pos = pos.to(torch.int32)
    active = row_active(pos, B)
    kv, rec = cache.attn, cache.rec
    slots, mask = attn_step(kv, pos)
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v

    x = params["token_embd"][tokens.to(torch.int64)]
    for il, layer in enumerate(params["layers"]):
        h = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        if hp.n_head_kv_il(il) == 0:
            li = ridx[il]
            y = _mamba_mixer(layer, hp, h, rec.conv[li], rec.ssm[li], active)
        else:                                 # no rope (jamba.cpp:44)
            q = mm(h, layer["wq"]).reshape(B, T, H, D)
            k = mm(h, layer["wk"]).reshape(B, T, Hkv, D)
            v = mm(h, layer["wv"]).reshape(B, T, Hkv, Dv)
            a = cached_attention(kv, aidx[il], slots, q, k, v, mask, 1.0 / (D ** 0.5))
            y = mm(a.reshape(B, T, H * Dv), layer["wo"])
        x = x + y
        h = ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        x = x + (moe_ffn(h, layer, hp) if "ffn_gate_exps" in layer else dense_ffn(h, layer, hp))
    return head(params, hp, x), cache
