"""DeepSeek-V2 family forward pass: multi-head latent attention (MLA).

Counterpart of the JAX package's ``models/deepseek2.py::deepseek2_forward``
(src/models/deepseek2.cpp), serving deepseek2, minicpm3 and plm. As in JAX,
the compressed KV latent is up-projected and the full per-head K / V are
cached in the flat KV cache (K of width d_nope + d_rope, V of d_v):

  q:  h → wq, or the q LoRA h → wq_a → attn_q_a_norm → wq_b; (H, d_nope + d_rope)
  kv: h → wkv_a = latent ∥ k_pe; latent → attn_kv_a_norm → wkv_b → k_nope ∥ v
  rope on the d_rope slices only; k_pe is one head, broadcast to all H.

The residual is scaled by ``f_residual_scale`` (minicpm3's muP), the first
``n_layer_dense_lead`` layers run the dense FFN and the rest ``moe_ffn``
(the router, the hand-written grouped matmul, the shared experts), and the
head applies ``logit_scale``. Matmuls dispatch through ``qmatmul`` (qmv /
qmm on QTensors).

Attention takes the plain path over the whole cache, as the JAX forward
does; moving MLA onto the fa / fd kernels (D 192, Dv 128) or the
absorbed-weight latent cache is a speed item (ROADMAP §2). The JAX forward
reads the cache's stored K / V as they are, so on a Q8_0 / Q4_0 cache it
attends over codes without their scales, and it cannot take a paged cache:
this one refuses those caches (``ValueError``) rather than serve them
(ROADMAP §3). Its rope is the JAX package's: linear scaling only, no YaRN
and no YaRN mscale in the kq scale, a fault of the reference that the port
keeps (ROADMAP §3). No step reads the host, so a step is captured as a CUDA
graph like ``llama_forward``'s.
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..runtime.kv_cache import (KVCache, causal_mask, kv_advance, kv_update_layer,
                                kv_write_slots)
from .hparams import HParams
from .llama import dense_ffn, mm, moe_ffn


def _check_cache(cache) -> None:
    """Refuse every cache but a flat float one (ROADMAP §3)."""
    if not isinstance(cache, KVCache):
        raise ValueError(f"deepseek2_forward needs a flat dense KV cache, not "
                         f"{type(cache).__name__}: the JAX forward writes and reads "
                         f"KVCache fields only")
    if cache.quantized:
        raise ValueError("deepseek2_forward needs a float KV cache: the JAX forward attends "
                         "over a Q8_0 / Q4_0 cache's codes without their scales")


def deepseek2_forward(
    params: dict,
    hp: HParams,
    tokens: torch.Tensor,     # (B, T) int
    pos: torch.Tensor,        # (B, T) int32; -1 marks padding
    cache: KVCache,
    flash: bool | None = None,
    s_window: int | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One forward step (prefill or decode). Returns (logits (B, T, V),
    cache); the cache is updated in place. ``flash`` and ``s_window`` (the
    engine's read cap) are accepted and ignored: attention reads the whole
    cache on the plain path, as in JAX."""
    _check_cache(cache)
    B, T = tokens.shape
    dev = tokens.device
    H = hp.n_head
    d_rope = hp.n_rot
    d_nope = hp.head_dim - d_rope
    d_v = hp.head_dim_v
    pos = pos.to(torch.int32)

    inv_freq, mscale = ops.rope_frequencies(
        d_rope, d_rope, hp.rope_freq_base,
        1.0 / hp.rope_scale_factor if hp.rope_scaling == "linear" else 1.0, device=dev)
    kq_scale = hp.f_attn_scale if hp.f_attn_scale > 0.0 else 1.0 / (hp.head_dim ** 0.5)
    rt = hp.rope_type if hp.rope_type >= 0 else ops.ROPE_TYPE_NORM

    x = params["token_embd"][tokens.to(torch.int64)] * hp.f_embedding_scale
    slots = kv_write_slots(cache, T)
    kv_advance(cache, slots, pos)
    mask = causal_mask(cache.positions(), pos)
    safe_pos = torch.clamp(pos, min=0)
    S = cache.max_seq

    for il, layer in enumerate(params["layers"]):
        h = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        if "wq_a" in layer:     # the query LoRA
            qc = ops.rms_norm(mm(h, layer["wq_a"]), layer["attn_q_a_norm"], hp.rms_eps)
            q = mm(qc, layer["wq_b"])
        else:
            q = mm(h, layer["wq"])
        q = q.reshape(B, T, H, d_nope + d_rope)
        q_nope, q_pe = q[..., :d_nope], q[..., d_nope:]

        ckv = mm(h, layer["wkv_a"])                       # (B, T, rank_kv + d_rope)
        kv_c, k_pe = ckv[..., :-d_rope], ckv[..., -d_rope:]
        kv = mm(ops.rms_norm(kv_c, layer["attn_kv_a_norm"], hp.rms_eps), layer["wkv_b"])
        kv = kv.reshape(B, T, H, d_nope + d_v)
        k_nope, v = kv[..., :d_nope], kv[..., d_nope:]

        q_pe = ops.apply_rope(q_pe, safe_pos, inv_freq, rt, mscale)
        k_pe = ops.apply_rope(k_pe[:, :, None, :], safe_pos, inv_freq, rt, mscale)
        k = torch.cat([k_nope, k_pe.expand(B, T, H, d_rope)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)

        kv_update_layer(cache, il, slots, k, v)
        attn = ops.attention_ref(q, cache.k[il][:, :, :S], cache.v[il][:, :, :S], mask,
                                 scale=kq_scale)
        attn = mm(attn.reshape(B, T, H * d_v), layer["wo"])
        x = x + attn * hp.f_residual_scale             # minicpm3: 1.4 / sqrt(n_layer)

        h = ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        if "ffn_gate_exps" in layer and il >= hp.n_layer_dense_lead:
            ffn = moe_ffn(h, layer, hp)
        else:
            ffn = dense_ffn(h, layer, hp)
        x = x + ffn * hp.f_residual_scale

    x = ops.rms_norm(x, params["output_norm"], hp.rms_eps)
    w_out = params.get("output")
    logits = mm(x, w_out) if w_out is not None else x @ params["token_embd"].T
    if hp.logit_scale != 1.0:     # minicpm3: n_embd_base / n_embd
        logits = logits * hp.logit_scale
    return logits, cache
