"""LLaDA / Dream / RND1 diffusion-LM forward: llama / qwen2-style blocks with
non-causal attention and no KV cache (every demasking step evaluates the
whole masked window again).

Counterpart of the JAX package's ``models/llada.py::llada_forward``: the
llama family's block math with bidirectional plain attention (an einsum and
an f32 softmax, as in JAX; no Pallas kernel there, so none here), Dream's
per-head q/k norms, and llada-moe's and rnd1's experts through the port's
``moe_ffn`` (the ``gmm`` kernel on a CUDA tensor). Matmuls go through
``llama.mm``: a packed weight at a window of ≤ 16 tokens takes ``qmv``, of
17-32 ``qmm``.
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from .hparams import HParams
from .llama import dense_ffn, mm, moe_ffn


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """q (B, T, H, D), k (B, T, Hkv, D), v (B, T, Hkv, Dv) → (B, T, H · Dv):
    every position over every position, f32 scores and softmax, the
    probabilities in v's type (the JAX forward's einsums)."""
    B, T, H, _ = q.shape
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if kh.shape[1] != H:
        kh = torch.repeat_interleave(kh, H // kh.shape[1], dim=1)
        vh = torch.repeat_interleave(vh, H // vh.shape[1], dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", qh.to(torch.float32),
                          kh.to(torch.float32)) * scale
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", p, vh).transpose(1, 2).reshape(B, T, -1)


def llada_forward(params: dict, hp: HParams, tokens: torch.Tensor,
                  pos: torch.Tensor | None = None, cache=None) -> tuple[torch.Tensor, None]:
    """tokens (B, T) → (logits (B, T, V), None); ``cache`` is unused."""
    B, T = tokens.shape
    dev = tokens.device
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v
    if pos is None:
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    inv_freq, mscale = ops.rope_frequencies(
        D, hp.n_rot, hp.rope_freq_base,
        1.0 / hp.rope_scale_factor if hp.rope_scaling == "linear" else 1.0, device=dev)
    scale = 1.0 / (D ** 0.5)

    x = params["token_embd"][tokens.to(torch.int64)]
    for layer in params["layers"]:
        h = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        q = mm(h, layer["wq"])
        k = mm(h, layer["wk"])
        v = mm(h, layer["wv"])
        if "bq" in layer:
            q = q + layer["bq"]
        if "bk" in layer:
            k = k + layer["bk"]
        if "bv" in layer:
            v = v + layer["bv"]
        q = q.reshape(B, T, H, D)
        k = k.reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, Dv)
        if "attn_q_norm" in layer:       # Dream's (qwen-style) per-head norms
            q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
            k = ops.rms_norm(k, layer["attn_k_norm"], hp.rms_eps)
        q = ops.apply_rope(q, pos, inv_freq, hp.rope_type, mscale)
        k = ops.apply_rope(k, pos, inv_freq, hp.rope_type, mscale)

        x = x + mm(bidirectional_attention(q, k, v, scale), layer["wo"])

        h = ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        x = x + (moe_ffn(h, layer, hp) if "ffn_gate_exps" in layer else dense_ffn(h, layer, hp))

    x = ops.rms_norm(x, params["output_norm"], hp.rms_eps)
    w_out = params.get("output")
    logits = mm(x, w_out) if w_out is not None else x @ params["token_embd"].T
    return logits, None
