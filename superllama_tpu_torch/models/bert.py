"""Encoder-family forwards: the BERT variants, ModernBERT, NeoBERT and
EmbeddingGemma, all bidirectional and without a KV cache, for the
embeddings and rerank pipeline (``runtime/embedder.py``).

Counterpart of the JAX package's ``models/bert.py``: ``bert_forward`` covers
bert (learned positions, token types, post-norm LayerNorms with biases, a
GELU FFN with biases), nomic-bert (NEOX rope, fused qkv, SiLU-gated FFN),
nomic-bert-moe (a gate-less GELU MoE on every n-th layer), jina-bert-v2
(bidirectional ALiBi, a GELU-gated FFN, a second attention norm over a
double residual), jina-bert-v3 (rope, GELU FFN), modern-bert (pre-norm
LayerNorm, symmetric sliding windows with their own rope base, fused GEGLU)
and neo-bert (pre-norm RMS, fused SwiGLU, ``enc.output_norm``);
``gemma_embedding_forward`` runs the gemma3 block bidirectionally.

Attention is the plain torch ``attention_ref`` with an additive mask (key
padding, ALiBi, the symmetric window), as in JAX; its kernel form is a held
item of ROADMAP §2. Matmuls go through ``llama.mm``, so packed weights reach
``qmv`` (≤ 16 rows) and ``qmm`` (17-32 rows). nomic-bert-moe's experts: on
a CUDA tensor the rows sorted by expert through ``grouped_matmul`` (the
``gmm`` kernel), since the JAX form gathers whole expert matrices per token
((B, T, K, E, F) floats: about 150 GB for a batch of 8 × 512 at
nomic-embed-text-v2-moe's widths); on a CPU tensor that gather form, which
the parity tests hold against the JAX package.

A padded query row under a symmetric window sees no key, so its softmax is
NaN: every layer zeroes the padded rows first (``x = where(live, x, 0)``) so
that a masked value row (weight 0 · NaN) cannot poison a real row, and
``pool`` zeroes them again, exactly as the JAX code does.
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from .hparams import HParams
from .llama import _experts_apply, _topk, mm

PRE_NORM_ENCODERS = {"modern-bert", "neo-bert"}
ROPE_ENCODERS = {"nomic-bert", "nomic-bert-moe", "jina-bert-v3",
                 "modern-bert", "neo-bert", "gemma-embedding"}
ENCODER_ARCHS = {"bert", "nomic-bert", "nomic-bert-moe", "jina-bert-v2",
                 "jina-bert-v3", "modern-bert", "neo-bert", "gemma-embedding"}


def _alibi_bias(hp: HParams, T: int, device) -> torch.Tensor:
    """(H, T, T) bidirectional ALiBi bias −slope·|q − k| (jina-bert-v2), the
    slopes rounded to f32 from the JAX package's Python floats."""
    H = hp.n_head
    n2 = 1 << (H.bit_length() - 1)
    m0 = 2.0 ** (-hp.max_alibi_bias / n2)
    m1 = 2.0 ** (-hp.max_alibi_bias / (2 * n2))
    slopes = torch.tensor([m0 ** (i + 1) if i < n2 else m1 ** (2 * (i - n2) + 1)
                           for i in range(H)], dtype=torch.float32, device=device)
    i = torch.arange(T, device=device)
    d = torch.abs(i[:, None] - i[None, :]).to(torch.float32)
    return -slopes[:, None, None] * d[None]


def _enc_masks(hp: HParams, attn_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(full, swa) additive bidirectional masks (B, 1 or H, 1 or T, T): key
    padding (-inf), jina-bert-v2's ALiBi, and on the swa mask the symmetric
    window: a key is visible iff |q − k| ≤ n_swa / 2."""
    T = attn_mask.shape[1]
    dev = attn_mask.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ninf = torch.full_like(zero, float("-inf"))
    full = torch.where(attn_mask[:, None, None, :] > 0, zero, ninf)
    if hp.arch == "jina-bert-v2":
        full = full + _alibi_bias(hp, T, dev)[None]
    if hp.swa_window > 0:
        i = torch.arange(T, device=dev)
        d = torch.abs(i[:, None] - i[None, :])
        swa = torch.where(d <= hp.swa_window // 2, zero, ninf)[None, None]
        return full, full + swa
    return full, full


def _enc_moe_gather(layer: dict, x: torch.Tensor, top_w: torch.Tensor,
                    top_i: torch.Tensor) -> torch.Tensor:
    """The JAX form of the experts: each token's K expert matrices gathered
    whole, two einsums in f32."""
    up = layer["ffn_up_exps"][top_i]               # (B, T, K, E, F)
    down = layer["ffn_down_exps"][top_i]
    h = torch.einsum("btd,btkdf->btkf", x.to(torch.float32), up.to(torch.float32))
    h = ops.gelu(h.to(x.dtype))
    o = torch.einsum("btkf,btkfo->btko", h.to(torch.float32), down.to(torch.float32))
    return torch.einsum("btko,btk->bto", o, top_w).to(x.dtype)


def _enc_moe(layer: dict, hp: HParams, x: torch.Tensor) -> torch.Tensor:
    """nomic-bert-moe: gate-less GELU (tanh) experts, softmax top-k,
    unnormalized weights (the reference's build_moe_ffn with norm_w false).
    A CUDA tensor takes the grouped route (``grouped_matmul``), a CPU tensor
    the gather form."""
    probs = torch.softmax(mm(x, layer["ffn_gate_inp"]).to(torch.float32), dim=-1)
    top_w, top_i = _topk(probs, hp.n_expert_used)
    if x.is_cuda:
        return _experts_apply(x, top_w, top_i, layer, hp, activation="gelu_tanh")
    return _enc_moe_gather(layer, x, top_w, top_i)


def _enc_ffn(layer: dict, hp: HParams, x: torch.Tensor, il: int) -> torch.Tensor:
    """Encoder FFN: the MoE on nomic-bert-moe's every n-th layer; gated
    (SiLU for nomic-bert and neo-bert, tanh GELU otherwise; the fused
    tensors were split at load) or a gate-less tanh GELU; biases."""
    n = hp.extra.get("moe_every_n_layers", 0)
    if n > 0 and il % n == 1 and "ffn_up_exps" in layer:
        return _enc_moe(layer, hp, x)
    up = mm(x, layer["ffn_up"])
    if "ffn_up_b" in layer:
        up = up + layer["ffn_up_b"]
    if "ffn_gate" in layer:
        gate = mm(x, layer["ffn_gate"])
        actf = ops.silu if hp.arch in ("nomic-bert", "neo-bert") else ops.gelu
        act = actf(gate) * up
    else:
        act = ops.gelu(up)
    out = mm(act, layer["ffn_down"])
    if "ffn_down_b" in layer:
        out = out + layer["ffn_down_b"]
    return out


def _rope_tables(hp: HParams, device):
    """(inv_freq, mscale, inv_freq of the SWA layers)."""
    D = hp.head_dim
    inv_freq, mscale = ops.rope_frequencies(D, hp.n_rot, hp.rope_freq_base, device=device)
    if hp.rope_freq_base_swa > 0.0:
        inv_freq_swa, _ = ops.rope_frequencies(D, hp.n_rot, hp.rope_freq_base_swa,
                                               device=device)
    else:
        inv_freq_swa = inv_freq
    return inv_freq, mscale, inv_freq_swa


def bert_forward(params: dict, hp: HParams, tokens: torch.Tensor,
                 attn_mask: torch.Tensor) -> torch.Tensor:
    """tokens (B, T), attn_mask (B, T) (1 a real token, 0 padding) → the
    final hidden states (B, T, E)."""
    arch = hp.arch
    if arch == "gemma-embedding":
        return gemma_embedding_forward(params, hp, tokens, attn_mask)
    B, T = tokens.shape
    dev = tokens.device
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v
    prenorm = arch in PRE_NORM_ENCODERS
    rms = hp.norm_type == "rms"

    def norm(v, w, b=None):
        return ops.rms_norm(v, w, hp.rms_eps) if rms else ops.layer_norm(v, w, b, hp.norm_eps)

    tokens = tokens.to(torch.int64)
    x = params["token_embd"][tokens]
    if params.get("token_types") is not None:
        x = x + params["token_types"][0]
    if arch == "bert" and params.get("position_embd") is not None:
        x = x + params["position_embd"][:T][None]
    if params.get("token_embd_norm") is not None:
        x = norm(x, params["token_embd_norm"], params.get("token_embd_norm_b"))

    mask_full, mask_swa = _enc_masks(hp, attn_mask)
    rope = arch in ROPE_ENCODERS and hp.rope_type >= 0
    if rope:
        inv_freq, mscale, inv_freq_swa = _rope_tables(hp, dev)
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    live = attn_mask[..., None] > 0

    for il, layer in enumerate(params["layers"]):
        swa = hp.swa_window > 0 and hp.is_swa_layer(il)
        x = torch.where(live, x, torch.zeros_like(x))
        h = x
        if prenorm and "attn_norm" in layer:     # modern-bert's layer 0 has none
            h = norm(h, layer["attn_norm"], layer.get("attn_norm_b"))
        q = mm(h, layer["wq"])
        k = mm(h, layer["wk"])
        v = mm(h, layer["wv"])
        if "bq" in layer:
            q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
        if "attn_q_norm" in layer:               # full-width LayerNorms (bert family)
            q = norm(q, layer["attn_q_norm"], layer.get("attn_q_norm_b"))
            k = norm(k, layer["attn_k_norm"], layer.get("attn_k_norm_b"))
        q = q.reshape(B, T, H, D)
        k = k.reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, Dv)
        if rope:
            f = inv_freq_swa if swa else inv_freq
            q = ops.apply_rope(q, pos, f, hp.rope_type, mscale)
            k = ops.apply_rope(k, pos, f, hp.rope_type, mscale)
        attn = ops.attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                 mask_swa if swa else mask_full, scale=1.0 / (D ** 0.5))
        attn = mm(attn.reshape(B, T, H * Dv), layer["wo"])
        if "bo" in layer:
            attn = attn + layer["bo"]

        if prenorm:
            x = x + attn
            h2 = norm(x, layer["ffn_norm"], layer.get("ffn_norm_b"))
            x = x + _enc_ffn(layer, hp, h2, il)
            continue
        # post-norm (bert family)
        x_in = x
        x = norm(x + attn, layer["attn_post_norm"], layer.get("attn_post_norm_b"))
        if "attn_norm_2" in layer:               # jina-v2's double residual
            x = norm(x + x_in, layer["attn_norm_2"], layer.get("attn_norm_2_b"))
        ff = _enc_ffn(layer, hp, x, il)
        x = norm(x + ff, layer["ffn_post_norm"], layer.get("ffn_post_norm_b"))

    if params.get("output_norm") is not None:
        x = norm(x, params["output_norm"], params.get("output_norm_b"))
    return x


def gemma_embedding_forward(params: dict, hp: HParams, tokens: torch.Tensor,
                            attn_mask: torch.Tensor) -> torch.Tensor:
    """EmbeddingGemma: the gemma3 block run bidirectionally (symmetric SWA,
    per-head q/k RMS norms, the SWA layers' rope base, q × f_attention_scale
    with kq_scale 1, a GELU-gated FFN, both post-norms)."""
    B, T = tokens.shape
    dev = tokens.device
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v
    mask_full, mask_swa = _enc_masks(hp, attn_mask)
    inv_freq, mscale, inv_freq_swa = _rope_tables(hp, dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    qscale = hp.f_attn_scale if hp.f_attn_scale > 0.0 else 1.0 / (D ** 0.5)

    x = params["token_embd"][tokens.to(torch.int64)] * (hp.n_embd ** 0.5)
    live = attn_mask[..., None] > 0     # see bert_forward: NaN containment
    for il, layer in enumerate(params["layers"]):
        swa = hp.swa_window > 0 and hp.is_swa_layer(il)
        x = torch.where(live, x, torch.zeros_like(x))
        h = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        q = mm(h, layer["wq"]).reshape(B, T, H, D)
        k = mm(h, layer["wk"]).reshape(B, T, Hkv, D)
        v = mm(h, layer["wv"]).reshape(B, T, Hkv, Dv)
        q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
        k = ops.rms_norm(k, layer["attn_k_norm"], hp.rms_eps)
        f = inv_freq_swa if swa else inv_freq
        q = ops.apply_rope(q, pos, f, hp.rope_type, mscale)
        k = ops.apply_rope(k, pos, f, hp.rope_type, mscale)
        q = q * qscale
        attn = ops.attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                 mask_swa if swa else mask_full, scale=1.0)
        attn = mm(attn.reshape(B, T, H * Dv), layer["wo"])
        if "attn_post_norm" in layer:
            attn = ops.rms_norm(attn, layer["attn_post_norm"], hp.rms_eps)
        x = x + attn
        h2 = ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        ff = mm(ops.gelu(mm(h2, layer["ffn_gate"])) * mm(h2, layer["ffn_up"]),
                layer["ffn_down"])
        if "ffn_post_norm" in layer:
            ff = ops.rms_norm(ff, layer["ffn_post_norm"], hp.rms_eps)
        x = x + ff
    return ops.rms_norm(x, params["output_norm"], hp.rms_eps)


def pool(hidden: torch.Tensor, attn_mask: torch.Tensor, pooling: str = "mean",
         normalize: bool = True) -> torch.Tensor:
    """Sequence pooling (MEAN / CLS / LAST), optionally L2-normalized; mean
    pooling zeroes the padded rows first (they may be NaN, see above)."""
    m = attn_mask.to(hidden.dtype)[..., None]
    if pooling == "mean":
        out = (torch.where(m > 0, hidden, torch.zeros_like(hidden)).sum(1)
               / torch.clamp(m.sum(1), min=1e-9))
    elif pooling == "cls":
        out = hidden[:, 0]
    elif pooling == "last":
        idx = attn_mask.sum(1).to(torch.int64) - 1
        out = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    if normalize:
        out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-9)
    return out


def rerank_score(params: dict, hidden: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
    """The classification head's score of each sequence on its CLS token
    (``cls`` with tanh, then ``cls_out``)."""
    x = hidden[:, 0]
    if params.get("cls") is not None:
        x = torch.tanh(mm(x, params["cls"]) + params["cls_b"])
    if params.get("cls_out") is not None:
        x = mm(x, params["cls_out"])
        if params.get("cls_out_b") is not None:
            x = x + params["cls_out_b"]
    return x[..., 0]
