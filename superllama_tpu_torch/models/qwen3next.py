"""Qwen3-Next forward: a hybrid of gated-delta-net linear-attention layers
(3 of every 4) and gated full-attention layers, with a MoE (and a
sigmoid-gated shared expert) after every layer.

Counterpart of the JAX package's ``models/qwen3next.py``
(src/models/qwen3next.cpp):

 - linear layers: the fused ``ssm_in`` projects a k-head group's
   interleaved [q | k | v | z] (or the ecosystem's ``ssm_qkv`` gives
   head-contiguous [q | k | v] streams and ``attn_gate`` z); ``ssm_ba``
   a group's [beta | alpha]; the decay g = softplus(alpha + dt_bias) · A
   (``ssm_a`` stores −exp(A_log)); [q | k | v] through a depthwise causal
   conv + silu with a rolling state; q / k repeated to the v heads; the
   delta rule (``ops/wkv.py::delta_net``: the hand-written kernel on the
   card); the output RMS-normed a head and gated by silu(z);
 - attention layers: ``wq`` emits a head's interleaved [q | gate]; q / k
   RMS-normed a head, a partial NEOX rope, σ(gate) on the output, the plain
   path over the whole flat cache, as in JAX;
 - every layer: x += mixer(rms(x)); x += ffn(rms(x, attn_post_norm)).

The conv (plain torch, ``models/mamba.py::_conv``) and the delta rule keep
their states in the cache's type (the delta rule in f32 inside), written in
place; rows whose pos[:, 0] < 0 keep both.
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..ops.wkv import delta_net
from ..runtime.recurrent import HybridCache
from .hparams import HParams
from .jamba import attn_step, cached_attention, hybrid_layer_split
from .llama import dense_ffn, mm, moe_ffn
from .mamba import _conv, _softplus, head, row_active


def _linear_layer(layer: dict, hp: HParams, h: torch.Tensor, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """One gated-delta-net layer over (B, T, E); conv_state (B, dc − 1, C)
    and ssm_state (B, Hv·Dv, Dk) in the cache's type, written in place.
    Returns y (B, T, E)."""
    B, T, E = h.shape
    Dk = Dv = hp.ssm_d_state
    Hk, Hv = hp.ssm_n_group, hp.ssm_dt_rank
    R = Hv // Hk
    if "ssm_qkv" in layer:          # ecosystem layout: [q | k | v] streams, z apart
        qkv = mm(h, layer["ssm_qkv"])
        z = mm(h, layer["attn_gate"]).reshape(B, T, Hv, Dv)
    else:                           # fused ssm_in: a k-head's interleaved [q|k|v|z]
        qkvz = mm(h, layer["ssm_in"]).reshape(B, T, Hk, 2 * Dk + 2 * Dv * R)
        q = qkvz[..., :Dk].reshape(B, T, Hk * Dk)
        k = qkvz[..., Dk:2 * Dk].reshape(B, T, Hk * Dk)
        v = qkvz[..., 2 * Dk:2 * Dk + Dv * R].reshape(B, T, Hv * Dv)
        z = qkvz[..., 2 * Dk + Dv * R:].reshape(B, T, Hv, Dv)
        qkv = torch.cat([q, k, v], dim=-1)

    ba = mm(h, layer["ssm_beta_alpha"]).reshape(B, T, Hk, 2 * R)
    beta = ba[..., :R].reshape(B, T, Hv)
    alpha = ba[..., R:].reshape(B, T, Hv)
    # decay: softplus(alpha + dt_bias) · A  (A = −exp(A_log), stored)
    g = (_softplus(alpha.to(torch.float32) + layer["ssm_dt_b"].to(torch.float32))
         * layer["ssm_a"].to(torch.float32).reshape(Hv))

    qkv = _conv(layer, qkv, conv_state, active)          # silu(conv(+ bias))
    q = qkv[..., :Hk * Dk].reshape(B, T, Hk, Dk)
    k = qkv[..., Hk * Dk:2 * Hk * Dk].reshape(B, T, Hk, Dk)
    v = qkv[..., 2 * Hk * Dk:].reshape(B, T, Hv, Dv)
    if R > 1:
        q = torch.repeat_interleave(q, R, dim=2)
        k = torch.repeat_interleave(k, R, dim=2)
    y = delta_net(q, k, v, g, beta, ssm_state.view(B, Hv, Dk, Dv), hp.rms_eps, active)
    y = ops.rms_norm(y.to(h.dtype), layer["ssm_norm"], hp.rms_eps) * ops.silu(z)
    return mm(y.reshape(B, T, Hv * Dv), layer["ssm_out"])


def qwen3next_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                      cache: HybridCache, flash: bool | None = None,
                      s_window: int | None = None) -> tuple[torch.Tensor, HybridCache]:
    """One step over (B, T) tokens; returns (logits, cache), the cache
    updated in place. ``flash`` and ``s_window`` are accepted and ignored."""
    B, T = tokens.shape
    attn_layers, rec_layers = hybrid_layer_split(hp)
    aidx = {il: i for i, il in enumerate(attn_layers)}
    ridx = {il: i for i, il in enumerate(rec_layers)}
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v
    pos = pos.to(torch.int32)
    active = row_active(pos, B)
    inv_freq, ms = ops.rope_frequencies(D, hp.n_rot, hp.rope_freq_base, device=tokens.device)
    safe_pos = torch.clamp(pos, min=0)
    kv, rec = cache.attn, cache.rec
    slots, mask = attn_step(kv, pos)
    scale = hp.f_attn_scale if hp.f_attn_scale > 0.0 else 1.0 / (D ** 0.5)

    x = params["token_embd"][tokens.to(torch.int64)]
    for il, layer in enumerate(params["layers"]):
        h = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        if hp.is_recurrent_layer(il):
            li = ridx[il]
            y = _linear_layer(layer, hp, h, rec.conv[li], rec.ssm[li], active)
        else:               # gated attention: wq emits a head's [q | gate]
            qfull = mm(h, layer["wq"]).reshape(B, T, H, 2 * D)
            q, gate = qfull[..., :D], qfull[..., D:]
            q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
            k = ops.rms_norm(mm(h, layer["wk"]).reshape(B, T, Hkv, D), layer["attn_k_norm"],
                             hp.rms_eps)
            v = mm(h, layer["wv"]).reshape(B, T, Hkv, Dv)
            q = ops.apply_rope(q, safe_pos, inv_freq, hp.rope_type, ms)
            k = ops.apply_rope(k, safe_pos, inv_freq, hp.rope_type, ms)
            a = cached_attention(kv, aidx[il], slots, q, k, v, mask, scale)
            y = mm((a * torch.sigmoid(gate)).reshape(B, T, H * Dv), layer["wo"])
        x = x + y
        h2 = ops.rms_norm(x, layer["attn_post_norm"], hp.rms_eps)
        x = x + (moe_ffn(h2, layer, hp) if "ffn_gate_inp" in layer else dense_ffn(h2, layer, hp))
    return head(params, hp, x), cache
