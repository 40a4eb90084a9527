"""T5 encoder-decoder (t5, flan-t5, t5encoder).

Counterpart of the JAX package's ``models/t5.py`` (the reference's
t5-enc.cpp and t5-dec.cpp; the relative attention bias of
llama_relative_position_bucket): ``t5_encode`` runs the encoder stack once,
``t5_cross_kv`` the decoder layers' cross K / V from its output, and
``t5_decode`` one decoder step over the port's flat ``KVCache`` (causal
self-attention with the relative bias, cross-attention, the FFN), the
cache written in place. ``T5Model.generate`` is the greedy loop.

Attention is unscaled (kq_scale 1) and plain torch, as in JAX (an einsum and
an f32 softmax). Matmuls go through ``llama.mm``: a packed model's decode
step (one row) takes ``qmv``, an encoder pass of 17-32 tokens ``qmm``.

The bucket of a relative position is computed from an f32 log as in JAX,
the division by log(max_distance / max_exact) a true division by a tensor:
torch turns a division by a Python scalar into a multiplication by its
reciprocal on CUDA, which would move a position lying on a bucket edge
(rel = 8, 16, 32, 64 with 32 buckets) into the bucket below.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import ref as ops
from ..runtime.kv_cache import (KVCache, causal_mask, kv_advance, kv_cache_init,
                                kv_update_layer, kv_write_slots)
from .hparams import HParams
from .llama import mm

T5_MAX_DISTANCE = 128  # fixed in the reference (llama-graph.cpp)


def relative_position_bucket(rel: torch.Tensor, n_buckets: int,
                             bidirectional: bool) -> torch.Tensor:
    """Bucket index (int32) of each relative position rel = k_pos − q_pos
    (llama_relative_position_bucket's, = HF T5's)."""
    rel = rel.to(torch.int32)
    bucket = torch.zeros_like(rel)
    if bidirectional:
        n_buckets //= 2
        bucket = (rel > 0).to(torch.int32) * n_buckets
        rel = torch.abs(rel)
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = n_buckets // 2
    x = torch.clamp(rel, min=1).to(torch.float32)
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=rel.device)  # noqa: E731
    large = max_exact + (torch.log(x / f32(max_exact))
                         / f32(math.log(T5_MAX_DISTANCE / max_exact))
                         * f32(n_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=n_buckets - 1)
    return bucket + torch.where(rel < max_exact, rel, large)


def _pos_bias(rel_b: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
              n_buckets: int, bidirectional: bool) -> torch.Tensor:
    """(B, H, T, S) additive attention bias from the (n_buckets, H) table."""
    rel = k_pos[:, None, :] - q_pos[:, :, None]           # (B, T, S)
    buckets = relative_position_bucket(rel, n_buckets, bidirectional)
    return rel_b[buckets.to(torch.int64)].permute(0, 3, 1, 2)


def _attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
          n_head: int) -> torch.Tensor:
    """Unscaled multi-head attention with an additive mask and bias."""
    B, T, E = q.shape
    S = k.shape[1]
    D = E // n_head
    H = n_head
    Hkv = k.shape[-1] // D
    qh = q.reshape(B, T, H, D).transpose(1, 2)
    kh = k.reshape(B, S, Hkv, D).transpose(1, 2)
    vh = v.reshape(B, S, Hkv, D).transpose(1, 2)
    if Hkv != H:
        kh = torch.repeat_interleave(kh, H // Hkv, dim=1)
        vh = torch.repeat_interleave(vh, H // Hkv, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", qh.to(torch.float32), kh.to(torch.float32))
    p = torch.softmax(scores + mask, dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bhsd->bhtd", p, vh.to(q.dtype))
    return out.transpose(1, 2).reshape(B, T, E)


def _ffn(x: torch.Tensor, layer: dict, sfx: str = "") -> torch.Tensor:
    gate = layer.get("ffn_gate" + sfx)
    up = mm(x, layer["ffn_up" + sfx])
    if gate is not None:                  # flan-t5: tanh-GELU gated
        act = ops.gelu(mm(x, gate)) * up
    else:                                 # t5: ReLU
        act = torch.relu(up)
    return mm(act, layer["ffn_down" + sfx])


def t5_encode(params: dict, hp: HParams, tokens: torch.Tensor) -> torch.Tensor:
    """The encoder stack → (B, S, E) (llm_build_t5_enc); the first layer's
    relative bias table serves the layers that ship none."""
    B, S = tokens.shape
    x = params["token_embd"][tokens.to(torch.int64)]
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    rel_b0 = None
    for layer in params["enc_layers"]:
        rel_b = layer.get("attn_rel_b_enc", rel_b0)
        if "attn_rel_b_enc" in layer and rel_b0 is None:
            rel_b0 = layer["attn_rel_b_enc"]
        bias = _pos_bias(rel_b, pos, pos, hp.n_rel_attn_bkts, True)
        h = ops.rms_norm(x, layer["attn_norm_enc"], hp.rms_eps)
        attn = _attn(mm(h, layer["wq_enc"]), mm(h, layer["wk_enc"]), mm(h, layer["wv_enc"]),
                     bias, hp.n_head)
        x = x + mm(attn, layer["wo_enc"])
        h = ops.rms_norm(x, layer["ffn_norm_enc"], hp.rms_eps)
        x = x + _ffn(h, layer, "_enc")
    return ops.rms_norm(x, params["output_norm_enc"], hp.rms_eps)


def t5_cross_kv(params: dict, hp: HParams, enc_out: torch.Tensor) -> list[dict]:
    """Each decoder layer's cross-attention K / V of the encoder output."""
    return [{"k": mm(enc_out, layer["wk_cross"]), "v": mm(enc_out, layer["wv_cross"])}
            for layer in params["dec_layers"]]


def t5_decode(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
              cache: KVCache, cross_kv: list[dict],
              enc_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, KVCache]:
    """One decoder step (llm_build_t5_dec) over (B, T) tokens at positions
    ``pos``: self-attention over the cache (causal, with the relative bias),
    cross-attention into the encoder output, the FFN. Returns (logits,
    cache), the cache updated in place."""
    B, T = tokens.shape
    dev = tokens.device
    x = params["token_embd"][tokens.to(torch.int64)]
    pos = pos.to(torch.int32)
    slots = kv_write_slots(cache, T)
    kv_advance(cache, slots, pos)
    S = cache.max_seq
    cpos = cache.positions()
    mask_self = causal_mask(cpos, pos)                    # (B, 1, T, S)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if enc_mask is None:
        cross_mask = zero.reshape(1, 1, 1, 1)
    else:
        cross_mask = torch.where(enc_mask[:, None, None, :].bool(), zero,
                                 torch.full_like(zero, float("-inf")))

    rel_b0 = None
    safe_pos = torch.clamp(pos, min=0)
    cache_pos = torch.clamp(cpos, min=0)
    Hkv = hp.n_head_kv or hp.n_head
    D = hp.head_dim
    for il, layer in enumerate(params["dec_layers"]):
        rel_b = layer.get("attn_rel_b", rel_b0)
        if "attn_rel_b" in layer and rel_b0 is None:
            rel_b0 = layer["attn_rel_b"]
        bias = _pos_bias(rel_b, safe_pos, cache_pos, hp.n_rel_attn_bkts, False)

        h = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        q = mm(h, layer["wq"])
        k = mm(h, layer["wk"])
        v = mm(h, layer["wv"])
        kv_update_layer(cache, il, slots, k.reshape(B, T, Hkv, D), v.reshape(B, T, Hkv, D))
        kc = cache.k[il][:, :, :S].transpose(1, 2).reshape(B, S, Hkv * D)
        vc = cache.v[il][:, :, :S].transpose(1, 2).reshape(B, S, Hkv * D)
        attn = _attn(q, kc, vc, mask_self + bias, hp.n_head)
        x = x + mm(attn, layer["wo"])

        h = ops.rms_norm(x, layer["attn_norm_cross"], hp.rms_eps)
        attn = _attn(mm(h, layer["wq_cross"]), cross_kv[il]["k"], cross_kv[il]["v"],
                     cross_mask, hp.n_head)
        x = x + mm(attn, layer["wo_cross"])

        h = ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        x = x + _ffn(h, layer)

    x = ops.rms_norm(x, params["output_norm"], hp.rms_eps)
    w_out = params.get("output")
    if w_out is not None:
        logits = mm(x, w_out)
    else:               # tied embeddings: T5 scales by d_model^-0.5
        logits = (x * hp.n_embd ** -0.5) @ params["token_embd"].T
    return logits, cache


class T5Model:
    """Encode once, then greedy-decode over a flat KV cache (the decoder
    loop llama-cli runs for T5), eagerly on the model's device. The cache
    holds the decoder's K / V in f32, as the JAX one does."""

    def __init__(self, model, n_ctx: int = 512):
        self.model = model
        self.hp = model.hparams
        self.n_ctx = n_ctx
        self.device = model.params["token_embd"].device

    @torch.no_grad()
    def generate(self, input_ids: list[int], n_gen: int = 32) -> list[int]:
        hp, params, dev = self.hp, self.model.params, self.device
        enc = t5_encode(params, hp, torch.as_tensor(np.asarray([input_ids]),
                                                    dtype=torch.int64, device=dev))
        ckv = t5_cross_kv(params, hp, enc)
        cache = kv_cache_init(hp.dec_n_layer, 1, self.n_ctx, hp.n_head_kv or hp.n_head,
                              hp.head_dim, hp.head_dim_v, dtype=torch.float32, device=dev)
        tok = hp.dec_start_token_id
        out = []
        eos = self.model.tokenizer.vocab.eos_id if self.model.tokenizer else -1
        for i in range(n_gen):
            logits, cache = t5_decode(
                params, hp, torch.full((1, 1), tok, dtype=torch.int64, device=dev),
                torch.full((1, 1), i, dtype=torch.int32, device=dev), cache, ckv)
            tok = int(torch.argmax(logits[0, -1]))
            if tok == eos:
                break
            out.append(tok)
        return out
