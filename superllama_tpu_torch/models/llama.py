"""Llama-family forward pass: every architecture the JAX package sends to
``llama_forward``.

Counterpart of the JAX package's ``models/llama.py::llama_forward`` and its
MoE functions: RMSNorm or LayerNorm (with biases, or non-parametric),
RoPE (NORM / NEOX, YaRN, per-dim factors, NoPE layers by step, by
``rope_swa_only`` or ``no_rope_mod_zero``), M-RoPE / IMROPE, ALiBi, learned
positions and an embedding LayerNorm, fused or split q/k/v with biases and
clamps, q/k norms (per head, full width, per-head LayerNorm, after rope),
grouped-query attention over the KV cache with sinks, softcaps and sliding
windows, per-layer head counts (attention-free, "linear attention" and
FFN-free layers; phantom kv heads padded into the cache and stripped),
``attn_gate`` and the bitnet sub-norms, gated or gate-less FFNs (xIELU),
post-norms, chameleon's swin norms, parallel residual, control vectors and
the per-layer taps, llama4's L2 q/k norm on rope layers, temperature tuning
on NoPE layers and chunked attention, then the output head with its bias,
scale, softcap and logit suppression. Weights are plain tensors (in, out) or
QTensors; matmuls dispatch through ``qmatmul``. Attention follows the JAX
routing:

 - paged cache (``PagedKVCache``): every step, prefill chunk or decode, runs
   the paged flash-attention kernel over the page tables; an ALiBi model
   refuses the paged cache, as in JAX, and so does llama4's chunked
   attention (the kernel has no chunk bound);
 - iSWA cache (``ISWACache``): full-attention layers append to the full
   tier, sliding-window layers write ring slots pos % S_swa of the SWA tier;
   prefill-sized steps on the GPU run the flash-attention kernel over the
   layer's tier (its positions as kv_pos, the ring read whole, in any slot
   order), everything else the plain path over the tier with its mask; the
   decode kernel and the ``s_window`` read cap stay off, as in JAX;
 - prefill-sized steps on the GPU (T ≥ 32) run the flash-attention kernel,
   fed Q8_0 codes and scales straight from a Q8_0 cache (a Q4_0 cache is
   dequantized first);
 - decode-sized steps (T·G ≤ 32) on the GPU, or with ``hp.extra
   ["flash_decode"]``, run the split-KV decode kernel on a Q8_0 cache, and
   on a float or Q4_0 cache when ``hp.extra["flash_decode_float"]`` is set;
   ``hp.extra["flash_decode_off"]`` turns it off, and a layer with fewer kv
   heads than the cache takes the plain path;
 - ALiBi, or a step with ``attn_mask`` (lookahead's tree mask), turns flash
   and the decode kernel off and takes the plain path with the additive
   mask (ALiBi's per-head bias added to it);
 - llama4 with ``hp.extra["llama4"]["chunk"]`` > 0: the rope layers take
   the plain path with the chunk mask at every T (the JAX TPU path runs
   them on flash without it, ROADMAP §3), the NoPE layers the normal
   routes; the decode kernel stays off, as in JAX;
 - everything else takes the plain grouped-query path over the
   (dequantized) cache.
The KV cache is updated in place. Every constant the step needs (ALiBi
slopes, M-RoPE tables, rope frequencies) is computed on the device, so a
step captured as a CUDA graph copies nothing from the host.

Sparse mixture-of-experts FFNs (``moe_ffn``): the router (softmax or
sigmoid gating, DeepSeek-V3's selection bias, grouped selection, top-k on
raw logits), the routed experts as three grouped matmuls (the hand-written
kernel of ``ops/grouped_matmul.py`` in place of ``ragged_dot``), the shared
expert with its gate, grovemoe's chunk experts, arctic's parallel MoE
branch, the router's pre-norm input (smallthinker) and grok's dense plus
MoE FFN. Top-k picks the lower index first among equal values, as ``jax.lax.top_k``. No routed
step reads a count on the host, so a MoE step is captured in a CUDA graph
like any other.

Not ported yet (it raises NotImplementedError): the expert-parallel MoE of
``hp.extra["moe_mesh"]`` (ROADMAP §1 item 9).
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..ops.flash_attention import flash_attention, flash_decode_attention
from ..ops.grouped_matmul import grouped_matmul
from ..ops.paged_attention import paged_flash_attention
from ..ops.qmatmul import qmatmul
from ..ops.qtensor import QTensor
from ..runtime.kv_cache import (ISWACache, KVCache, causal_mask, iswa_layer_split,
                                kv_advance, kv_layer, kv_ring_advance, kv_ring_slots,
                                kv_update_layer, kv_write_slots)
from ..runtime.paged_kv import PagedKVCache, paged_advance, paged_update_layer
from .hparams import ROPE_SCALING_YARN, HParams
from .qwen2vl import mrope_apply


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul dispatch: dense (in, out) tensor or QTensor. Decode-sized
    batches (≤ 16 rows) take the int8-activation GEMV."""
    if isinstance(w, QTensor):
        rows = x.numel() // x.shape[-1]
        return qmatmul(x, w, act_quant=rows <= 16)
    return x @ w


def _norm(x: torch.Tensor, obj: dict, key: str, hp: HParams) -> torch.Tensor:
    """Norm by ``hp.norm_type``: LayerNorm with the weight and bias under
    ``key`` (non-parametric without them), or RMSNorm (no weight: no norm;
    a bias is added after it, as phimoe's)."""
    w = obj.get(key)
    if hp.norm_type == "ln":
        return ops.layer_norm(x, w, obj.get(key + "_b"), hp.norm_eps)
    if w is None:
        return x
    out = ops.rms_norm(x, w, hp.rms_eps)
    b = obj.get(key + "_b")
    return out if b is None else out + b


def _glu(gate: torch.Tensor, up: torch.Tensor, hp: HParams) -> torch.Tensor:
    if hp.act == "swiglu_oai":
        return ops.swiglu_oai(gate, up, hp.swiglu_alpha, hp.swiglu_limit)
    return ops.GLU_FNS[hp.act](gate, up)


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
    """Gated FFN (``hp.act``'s GLU), or gate-less by ``ops.ACT_FNS`` or the
    layer's xIELU; bitnet's ``ffn_sub_norm`` before the down-projection."""
    _im(imx, pfx + "ffn_up.weight", x)
    gate = mm(x, layer["ffn_gate"]) if "ffn_gate" in layer else None
    up = mm(x, layer["ffn_up"])
    if "ffn_up_b" in layer:
        up = up + layer["ffn_up_b"]
    if gate is not None:
        if "ffn_gate_b" in layer:
            gate = gate + layer["ffn_gate_b"]
        act = _glu(gate, up, hp)
    elif "xielu" in layer:       # apertus: (alpha_n, alpha_p, beta, eps) floats
        act = ops.xielu(up, *layer["xielu"])
    else:
        act = ops.ACT_FNS[hp.act](up)
    if "ffn_sub_norm" in layer:
        act = ops.rms_norm(act, layer["ffn_sub_norm"], hp.rms_eps)
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


def _check_supported(hp: HParams) -> None:
    """Refuse the expert-parallel MoE of a mesh (ROADMAP §1 item 9)."""
    if hp.extra.get("moe_mesh") is not None:
        raise NotImplementedError(
            f"{hp.arch}: the expert-parallel MoE of moe_mesh not ported yet (ROADMAP §1 item 9)")


def _topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise): a stable descending sort."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _moe_route(x: torch.Tensor, layer: dict, hp: HParams,
               router_x: torch.Tensor | None = None):
    """Router: (probs, top-k combine weights, top-k expert ids), f32 weights.
    Softmax or sigmoid gating; DeepSeek-V3's ``exp_probs_b`` added for the
    selection only; grouped selection (each group scored by its top-2 sum,
    the groups not among the top ``n_group_used`` masked); llama4's top-k on
    raw logits with the sigmoid after; renormalisation and
    ``expert_weights_scale``."""
    logits = mm(x if router_x is None else router_x, layer["ffn_gate_inp"])   # (B, T, E)
    if "ffn_gate_inp_b" in layer:
        logits = logits + layer["ffn_gate_inp_b"]
    lf = logits.to(torch.float32)
    if hp.extra.get("moe_topk_raw"):
        probs = torch.sigmoid(lf)
        top_l, top_i = _topk(lf, hp.n_expert_used)
        top_w = torch.sigmoid(top_l)
    else:
        probs = torch.softmax(lf, dim=-1) if hp.expert_gating_softmax else torch.sigmoid(lf)
        sel = probs
        if "exp_probs_b" in layer:
            sel = sel + layer["exp_probs_b"].to(torch.float32)
        if hp.n_expert_groups > 1:
            B, T, E = sel.shape
            G = hp.n_expert_groups
            gsel = sel.reshape(B, T, G, E // G)
            gscore = _topk(gsel, min(2, E // G))[0].sum(-1)              # (B, T, G)
            gi = _topk(gscore, hp.n_group_used)[1]
            keep = torch.zeros((B, T, G), dtype=torch.bool, device=sel.device).scatter_(
                -1, gi, True)
            sel = torch.where(keep[..., None], gsel,
                              torch.full_like(gsel, -torch.inf)).reshape(B, T, E)
        top_i = _topk(sel, hp.n_expert_used)[1]
        top_w = torch.gather(probs, -1, top_i)
    if hp.expert_weights_norm:
        top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    if hp.expert_weights_scale != 1.0:
        top_w = top_w * hp.expert_weights_scale
    return probs, top_w, top_i


def _moe_shared_expert(x: torch.Tensor, layer: dict, hp: HParams,
                       out: torch.Tensor) -> torch.Tensor:
    """out plus the always-on shared expert, if the layer has one, times
    the sigmoid of its gate (a 1-D gate: one scalar a row)."""
    if "ffn_up_shexp" not in layer:
        return out
    shexp = {k: layer[f"{k}_shexp"] for k in ("ffn_gate", "ffn_up", "ffn_down")
             if f"{k}_shexp" in layer}
    sh = dense_ffn(x, shexp, hp)
    if "ffn_gate_inp_shexp" in layer:
        gsig = torch.sigmoid(mm(x, layer["ffn_gate_inp_shexp"]))
        if gsig.ndim == sh.ndim - 1:
            gsig = gsig[..., None]
        sh = sh * gsig
    return out + sh


def _experts_apply(x: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor, layer: dict,
                   hp: HParams, bank: str = "exps", n_expert: int | None = None,
                   activation: str | None = None) -> torch.Tensor:
    """The routed experts of ``layer[f"ffn_*_{bank}"]`` over x for the
    selection (top_w, top_i): the S·K (token, expert) rows sorted by expert
    (a stable sort: token order within an expert), the group bounds found
    on the device (``searchsorted``, no count on the host), up / gate / down
    as grouped matmuls in f32 (up and gate cast to x's type before the GLU),
    per-expert biases, the router weights (on the expert input with
    ``expert_weights_before_ffn``, llama4). The combine undoes the sort and
    adds each token's K rows in top-k order: the JAX package's scatter-add
    in another order, with no atomics, so a replayed graph equals the eager
    step bit for bit. Duplicate ids of a token (grovemoe's chunk ids) add up."""
    B, T, Dm = x.shape
    E = n_expert or hp.n_expert
    K = top_i.shape[-1]
    S = B * T
    xf = x.reshape(S, Dm)
    ei = top_i.reshape(S * K)
    order = torch.argsort(ei, stable=True)
    tok = order // K                             # source token of each sorted row
    ei_s = ei[order]
    xs = xf[tok]
    w_s = top_w.reshape(S * K)[order]
    before = bool(hp.extra.get("expert_weights_before_ffn"))
    if before:
        xs = xs * w_s[:, None].to(xs.dtype)
    offsets = torch.searchsorted(
        ei_s, torch.arange(E + 1, dtype=ei_s.dtype, device=ei_s.device)).to(torch.int32)
    up = grouped_matmul(xs, layer[f"ffn_up_{bank}"], offsets)
    if f"ffn_up_{bank}_b" in layer:
        up = up + layer[f"ffn_up_{bank}_b"][ei_s]
    if f"ffn_gate_{bank}" in layer:
        gate = grouped_matmul(xs, layer[f"ffn_gate_{bank}"], offsets)
        if f"ffn_gate_{bank}_b" in layer:
            gate = gate + layer[f"ffn_gate_{bank}_b"][ei_s]
        act = _glu(gate.to(x.dtype), up.to(x.dtype), hp)
    else:        # gate-less experts
        act = ops.ACT_FNS[activation or hp.act](up.to(x.dtype))
    down = grouped_matmul(act, layer[f"ffn_down_{bank}"], offsets)
    if f"ffn_down_{bank}_b" in layer:
        down = down + layer[f"ffn_down_{bank}_b"][ei_s]
    contrib = down if before else down * w_s[:, None]
    rows = torch.empty_like(contrib).index_copy_(0, order, contrib)   # back to (token, k)
    y = rows.reshape(S, K, -1).sum(dim=1)
    return y.to(x.dtype).reshape(B, T, -1)


def moe_ffn_sparse(x: torch.Tensor, layer: dict, hp: HParams,
                   router_x: torch.Tensor | None = None) -> torch.Tensor:
    """Only the K routed experts a token: S·K·D·F products, not S·E·D·F."""
    _, top_w, top_i = _moe_route(x, layer, hp, router_x)
    out = _experts_apply(x, top_w, top_i, layer, hp)
    return _moe_shared_expert(x, layer, hp, out)


def grove_moe(x: torch.Tensor, layer: dict, hp: HParams,
              router_x: torch.Tensor | None = None) -> torch.Tensor:
    """GroveMoE: selection on sigmoid(logits), weights from softmax(logits)
    renormalised; then the chunk ("adjugate") bank on the first pass's
    output, routed by big-expert id // n_group_experts with the softmax
    weights at the chunk ids, renormalised, added times expert_group_scale."""
    g = hp.extra["grove"]
    ng, scale = g["n_group_experts"], g["scale"]
    E, K = hp.n_expert, hp.n_expert_used
    n_chunk = E // ng
    logits = mm(x if router_x is None else router_x,
                layer["ffn_gate_inp"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    sel = torch.sigmoid(logits)
    ti = _topk(sel, K)[1]
    w = torch.gather(probs, -1, ti)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    first = _experts_apply(x, w, ti, layer, hp)
    ci = _topk(sel, min(K, n_chunk))[1] // ng     # chunk expert of each selection
    w2 = torch.gather(probs, -1, ci)
    w2 = w2 / torch.sum(w2, dim=-1, keepdim=True)
    second = _experts_apply(first, w2, ci, layer, hp, bank="chexps", n_expert=n_chunk)
    return first + scale * second


def moe_ffn(x: torch.Tensor, layer: dict, hp: HParams,
            router_x: torch.Tensor | None = None) -> torch.Tensor:
    """Mixture-of-experts FFN: grovemoe's two passes where the layer has a
    chunk bank, else the sparse form."""
    if "ffn_up_chexps" in layer:
        return grove_moe(x, layer, hp, router_x)
    return moe_ffn_sparse(x, layer, hp, router_x)


def alibi_slopes(n_head: int, max_bias: float, device) -> torch.Tensor:
    """(H,) f32 ALiBi slopes, ggml's schedule: m0^(i+1) for the first n2 heads
    (n2 the largest power of two ≤ H), m1^(2(i−n2)+1) after. Computed on the
    device in f64, then rounded to f32 as the JAX package's Python floats."""
    n2 = 1 << (n_head.bit_length() - 1)
    m0 = 2.0 ** (-max_bias / n2)
    m1 = 2.0 ** (-max_bias / (2 * n2))
    i = torch.arange(n_head, dtype=torch.float64, device=device)
    return torch.where(i < n2, torch.pow(m0, i + 1),
                       torch.pow(m1, 2 * (i - n2) + 1)).to(torch.float32)


def _nope_layer(hp: HParams, il: int) -> bool:
    """True where layer il skips rope: the full-attention layers of a
    ``rope_swa_only`` model, il % step == 0 with ``no_rope_mod_zero``, else
    (il + 1) % step == 0 (smollm3)."""
    if hp.extra.get("rope_swa_only") and hp.swa_window > 0:
        return not hp.is_swa_layer(il)
    step = hp.n_no_rope_layer_step
    if hp.extra.get("no_rope_mod_zero"):
        return step > 0 and il % step == 0
    return step > 0 and (il + 1) % step == 0


def _llama4_qk(q: torch.Tensor, k: torch.Tensor, safe_pos: torch.Tensor, hp: HParams,
               nope: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """llama4's extras after rope: the L2 q/k norm (Llama4TextL2Norm) on rope
    layers; on NoPE layers, temperature tuning of q by log1p(floor((pos + 1)
    / floor_scale)) · attn_scale + 1."""
    l4 = hp.extra["llama4"]
    if not nope:
        def l2(t):
            return t * torch.rsqrt(torch.mean(t.to(torch.float32) ** 2, -1, keepdim=True)
                                   + 1e-6).to(t.dtype)
        return l2(q), l2(k)
    if l4.get("temp_tuning"):
        ts = (torch.log1p(torch.floor((safe_pos.to(torch.float32) + 1.0) / l4["floor_scale"]))
              * l4["attn_scale"] + 1.0)
        q = (q * ts[:, :, None, None]).to(q.dtype)
    return q, k


def _chunk_mask(mask: torch.Tensor, kv_pos: torch.Tensor, pos: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """llama4's chunked attention: ``mask`` plus -inf where the key's and the
    query's positions lie in different chunks of ``chunk``."""
    kc = torch.div(torch.clamp(kv_pos, min=0), chunk, rounding_mode="floor")[:, None, None, :]
    qc = torch.div(torch.clamp(pos, min=0), chunk, rounding_mode="floor")[:, None, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return mask + torch.where(kc == qc, zero, torch.full_like(zero, float("-inf")))


def _layer_out(x: torch.Tensor, params: dict, il: int, sink: list | None) -> torch.Tensor:
    """The control vector's add (llama_adapter_cvec::apply_to) and the
    per-layer tap ``cvector-generator`` reads."""
    cv = params.get("cvec")
    if cv is not None:
        x = x + cv[il]
    if sink is not None:
        sink.append(x)
    return x


def llama_forward(
    params: dict,
    hp: HParams,
    tokens: torch.Tensor,     # (B, T) int
    pos: torch.Tensor,        # (B, T) int32; -1 marks padding
    cache: KVCache | ISWACache | PagedKVCache,
    flash: bool | None = None,
    s_window: int | None = None,
    attn_mask: torch.Tensor | None = None,
    imatrix: dict | None = None,
    embeds: torch.Tensor | None = None,
    hidden_sink: list | None = None,
    mrope_pos3: torch.Tensor | None = None,
    deepstack_add: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache | ISWACache | PagedKVCache]:
    """One forward step (prefill or decode). Returns (logits (B, T, V), cache);
    the cache is updated in place.

    ``s_window``: cap on how many cache slots attention reads (the engine's
    decode-length bucketing); every valid slot index must be below it. Flat
    dense caches only (ignored on an iSWA cache, as in JAX).

    ``attn_mask``: an additive (B, 1, T, S) mask that replaces the causal
    mask (tree attention); it turns flash and the decode kernel off. Flat
    dense caches only.

    ``imatrix``: a dict to accumulate each matmul weight's input Σx² and
    row count in, keyed by GGUF weight name (``tools/imatrix.py``); None
    (the default) adds no operation.

    ``embeds``: (B, T, E) input embeddings in place of the token lookup
    (``tokens`` then gives only the shape). ``hidden_sink``: a list that
    receives each layer's output hidden state (``cvector-generator``).
    ``mrope_pos3``: (3, B, T) M-RoPE position streams. ``deepstack_add``:
    (n, B, T, E) added to the first n layers' outputs (Qwen3-VL DeepStack).
    ``params["cvec"]`` (n_layer, E), when present, is added after each layer.

    ``flash=None`` selects the flash-attention kernel for prefill-sized
    steps on the GPU (T ≥ 32); see the module docstring for the rest."""
    _check_supported(hp)
    B, T = tokens.shape
    dev = tokens.device
    on_gpu = dev.type == "cuda"
    if flash is None:
        flash = on_gpu and T >= 32
    paged = isinstance(cache, PagedKVCache)
    iswa = isinstance(cache, ISWACache)
    if attn_mask is not None and (paged or iswa):
        raise ValueError("attn_mask needs a flat dense KV cache")
    if hp.alibi and (paged or iswa):
        raise NotImplementedError("alibi models need the regular KV cache")
    l4c = (hp.extra.get("llama4") or {}).get("chunk", 0)
    if l4c and paged:
        raise NotImplementedError("llama4's chunked attention needs a dense KV cache: the "
                                  "paged kernel has no chunk bound")
    if hp.alibi or attn_mask is not None:
        flash = False       # an additive bias or custom mask rides the plain path
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v
    pos = pos.to(torch.int32)
    # split-KV decode kernel: decode-sized steps on a Q8_0 cache, and on any
    # other dense cache when flash_decode_float asks for it
    fdec = (not flash and not paged and not iswa and not l4c and attn_mask is None
            and not hp.alibi and not hp.extra.get("flash_decode_off")
            and (on_gpu or bool(hp.extra.get("flash_decode")))
            and Hkv > 0 and T * (H // max(Hkv, 1)) <= 32
            and ((cache.quantized and not cache.q4)
                 or bool(hp.extra.get("flash_decode_float"))))

    inv_freq, mscale, inv_freq_swa, mscale_swa = rope_setup(params, hp, dev)
    kq_scale = hp.f_attn_scale if hp.f_attn_scale > 0.0 else 1.0 / (D ** 0.5)
    safe_pos = torch.clamp(pos, min=0)
    if embeds is not None:
        x = embeds.to(params["token_embd"].dtype) * hp.f_embedding_scale
    else:
        x = params["token_embd"][tokens.to(torch.int64)] * hp.f_embedding_scale
    if params.get("position_embd") is not None:       # learned positions (gpt2)
        x = x + params["position_embd"][safe_pos.to(torch.int64)]
    if params.get("token_embd_norm") is not None:     # bloom's embedding LayerNorm
        x = ops.layer_norm(x, params["token_embd_norm"], params.get("token_embd_norm_b"),
                           hp.norm_eps)

    mask_chunk = None
    if paged:
        pslots, poffs = paged_advance(cache, pos)
    elif iswa:
        # full layers append; SWA layers write their ring slots pos % S_swa
        full_layers, swa_layers = iswa_layer_split(hp)
        tier_of = {**{il: (cache.full, i) for i, il in enumerate(full_layers)},
                   **{il: (cache.swa, i) for i, il in enumerate(swa_layers)}}
        slots_full = kv_write_slots(cache.full, T)
        slots_swa = kv_ring_slots(pos, cache.swa.max_seq)
        kv_advance(cache.full, slots_full, pos)
        kv_ring_advance(cache.swa, slots_swa, pos)
        wpos = cache.full.positions()
        if not flash or l4c:
            mask_full = causal_mask(wpos, pos)
            mask_swa = causal_mask(cache.swa.positions(), pos, hp.swa_window)
    else:
        slots = kv_write_slots(cache, T)
        kv_advance(cache, slots, pos)
        S = cache.max_seq
        if s_window is not None and s_window >= S:
            s_window = None
        Sw = s_window or S
        wpos = cache.positions(Sw)
        # a layer with fewer kv heads than the cache leaves the decode kernel
        fdec_all = fdec and all(hp.n_head_kv_il(il) in (0, Hkv) for il in range(hp.n_layer))
        if attn_mask is not None:
            mask_full = mask_swa = attn_mask.to(torch.float32)
        elif (not flash and not fdec_all) or l4c:
            mask_full = causal_mask(wpos, pos)
            mask_swa = causal_mask(wpos, pos, hp.swa_window) if hp.swa_window else mask_full
        if hp.alibi:
            # ALiBi as a per-head additive bias slope·k_pos (the shift-invariant
            # form of −slope·(q_pos − k_pos))
            kp = torch.clamp(wpos, min=0).to(torch.float32)
            mask_full = mask_full + (alibi_slopes(H, hp.max_alibi_bias, dev)[None, :, None, None]
                                     * kp[:, None, None, :])
            mask_swa = mask_full
    if l4c:
        # llama4: rope layers see only their own chunk of positions
        mask_chunk = _chunk_mask(mask_full, wpos, pos, l4c)

    swin = bool(hp.extra.get("swin_norm"))     # chameleon: norms after the blocks
    for il, layer in enumerate(params["layers"]):
        pfx = f"blk.{il}."
        x_in = x                 # the pre-attention residual (arctic, the router's pre-norm)
        # per-layer head and FFN widths (deci / openelm: GGUF array KVs)
        H_l, Hkv_l = hp.n_head_il(il), hp.n_head_kv_il(il)
        if hp.n_head_arr is not None and hp.n_ff_il(il) == 0 and H_l > 0:
            # deci FFN-free layer: the reference computes attention and drops
            # it before the residual add (deci.cpp:96-99), a no-op
            continue
        h = x if swin else _norm(x, layer, "attn_norm", hp)
        if hp.n_head_arr is not None and (H_l == 0 or Hkv_l == 0):
            # deci attention-free layer (FFN on the raw input), or "linear
            # attention" (wo over the attn-norm output, normal residual)
            ffn_inp = x if H_l == 0 else x + mm(h, layer["wo"])
            h2 = _norm(ffn_inp, layer, "ffn_norm", hp)
            x = _layer_out(ffn_inp + dense_ffn(h2, layer, hp, imatrix, pfx), params, il,
                           hidden_sink)
            continue

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
        per_head_qk_norm = cham_qk_norm = False
        if qn is not None and qn.ndim == 2:
            cham_qk_norm = True          # chameleon: per-head LayerNorm (H, D)
        elif qn is not None and qn.shape[-1] == H * D:   # olmo2: before the split
            q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
            k = ops.rms_norm(k, layer["attn_k_norm"], hp.rms_eps)
        else:
            per_head_qk_norm = qn is not None
        q = q.reshape(B, T, H_l, D)
        k = k.reshape(B, T, Hkv_l, D)
        v = v.reshape(B, T, Hkv_l, Dv)
        if Hkv_l < Hkv:       # phantom kv heads up to the cache width
            k = torch.nn.functional.pad(k, (0, 0, 0, Hkv - Hkv_l))
            v = torch.nn.functional.pad(v, (0, 0, 0, Hkv - Hkv_l))
        qk_post_rope = hp.extra.get("qk_norm_post_rope")    # maincoder
        if per_head_qk_norm and not qk_post_rope:           # qwen3-style
            q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
            k = ops.rms_norm(k, layer["attn_k_norm"], hp.rms_eps)
        elif cham_qk_norm:
            q = ops.layer_norm(q, layer["attn_q_norm"], layer.get("attn_q_norm_b"), hp.norm_eps)
            k = ops.layer_norm(k, layer["attn_k_norm"], layer.get("attn_k_norm_b"), hp.norm_eps)

        swa = hp.swa_window if hp.is_swa_layer(il) else 0
        f, ms = (inv_freq_swa, mscale_swa) if swa else (inv_freq, mscale)
        nope = _nope_layer(hp, il)
        if mrope_pos3 is not None or (hp.extra.get("imrope") and not nope):
            # M-RoPE; IMROPE text positions replicate into t/h/w
            sec = tuple(hp.extra["mrope_sections"])
            inter = bool(hp.extra.get("imrope"))
            p3 = mrope_pos3 if mrope_pos3 is not None else safe_pos[None].expand(3, B, T)
            q = mrope_apply(q, p3, f, sec, interleaved=inter)
            k = mrope_apply(k, p3, f, sec, interleaved=inter)
        elif hp.rope_type >= 0 and hp.n_rot > 0 and not nope:
            q = ops.apply_rope(q, safe_pos, f, hp.rope_type, ms)
            k = ops.apply_rope(k, safe_pos, f, hp.rope_type, ms)
        if "llama4" in hp.extra:
            q, k = _llama4_qk(q, k, safe_pos, hp, nope)
        if per_head_qk_norm and qk_post_rope:
            q = ops.rms_norm(q, layer["attn_q_norm"], hp.rms_eps)
            k = ops.rms_norm(k, layer["attn_k_norm"], hp.rms_eps)

        sinks = layer.get("attn_sinks")
        akw = dict(scale=kq_scale, swa_window=swa, logit_softcap=hp.attn_logit_softcap,
                   sinks=sinks)
        if paged:
            paged_update_layer(cache, il, pslots, poffs, k, v)
            attn = paged_flash_attention(q, cache.k_pages[il], cache.v_pages[il], pos,
                                         cache.page_pos, cache.table, **akw)
        else:
            if iswa:          # the layer's tier, read whole (the ring in any slot order)
                tier, li = tier_of[il]
                wslots = slots_swa if swa else slots_full
                n_read, lpos = None, tier.positions()
            else:
                tier, li, wslots, n_read, lpos = cache, il, slots, Sw, wpos
            kv_update_layer(tier, li, wslots, k, v)
            fdec_l = fdec and Hkv_l == Hkv
            # llama4's chunked rope layers take the plain path at every T
            flash_l = flash and not (mask_chunk is not None and not nope)
            if fdec_l or (flash_l and tier.quantized and not tier.q4):
                ck, cv, ks, vs = tier.layer(li, n_read)   # codes and scales as stored
            else:
                (ck, cv), ks, vs = kv_layer(tier, li, k.dtype, n_read), None, None
            if Hkv_l < Hkv:   # strip the phantom kv heads
                ck, cv = ck[:, :Hkv_l], cv[:, :Hkv_l]
                if ks is not None:
                    ks, vs = ks[:, :Hkv_l], vs[:, :Hkv_l]
            if fdec_l:
                attn = flash_decode_attention(q, ck, cv, pos, lpos, k_scale=ks,
                                              v_scale=vs, **akw)
            elif flash_l:
                attn = flash_attention(q, ck, cv, pos, lpos, k_scale=ks, v_scale=vs,
                                       **akw)
            else:
                # grouped-query path when K/V traffic dominates (long context
                # or multi-row batches), the repeat-KV reference otherwise
                attn_fn = (ops.attention_gqa if (ck.shape[2] >= 1024 or B >= 2)
                           else ops.attention_ref)
                use_mask = mask_swa if swa else mask_full
                if mask_chunk is not None and not nope:
                    use_mask = mask_chunk
                attn = attn_fn(q, ck, cv, use_mask, scale=kq_scale,
                               logit_softcap=hp.attn_logit_softcap, sinks=sinks)
        attn = attn.reshape(B, T, H_l * Dv)
        if "attn_gate" in layer:      # σ-gated attention output before wo
            attn = attn * torch.sigmoid(mm(h, layer["attn_gate"]))
        if "attn_sub_norm" in layer:  # bitnet: RMS before the out-projection
            attn = ops.rms_norm(attn, layer["attn_sub_norm"], hp.rms_eps)
        _im(imatrix, pfx + "attn_output.weight", attn)
        attn = mm(attn, layer["wo"])
        if "bo" in layer:
            attn = attn + layer["bo"]
        if "attn_post_norm" in layer:
            attn = _norm(attn, layer, "attn_post_norm", hp)
        if swin:
            attn = _norm(attn, layer, "attn_norm", hp)

        if "ffn_norm_exps" in layer:
            # arctic: a dense FFN on the attention residual plus a parallel
            # MoE branch normed from the pre-attention input
            ffn_inp = x_in + attn
            dense = dense_ffn(_norm(ffn_inp, layer, "ffn_norm", hp), layer, hp, imatrix, pfx)
            moe_in = ops.rms_norm(x_in, layer["ffn_norm_exps"], hp.rms_eps)
            x = _layer_out((ffn_inp + dense) + moe_ffn(moe_in, layer, hp), params, il,
                           hidden_sink)
            continue

        # parallel residual (gptneox / falcon / phi2 / command-r): the FFN
        # reads its own norm of x when the model ships one, else the shared
        # attn-norm output; one residual add
        if hp.parallel_residual:
            h2 = _norm(x, layer, "ffn_norm", hp) if "ffn_norm" in layer else h
        else:
            x = x + attn * hp.f_residual_scale
            h2 = x if swin else _norm(x, layer, "ffn_norm", hp)
        if "ffn_gate_exps" in layer:
            _im(imatrix, pfx + "ffn_up_exps.weight", h2)
            ffn = moe_ffn(h2, layer, hp,
                          router_x=x_in if hp.extra.get("moe_router_prenorm") else None)
            mdp = hp.extra.get("moe_dense_parallel_scale")
            if mdp and "ffn_up" in layer:
                # grok: a dense FFN and the MoE on one input, summed, scaled by sqrt(2)/2
                ffn = (ffn + dense_ffn(h2, layer, hp)) * mdp
        else:
            ffn = dense_ffn(h2, layer, hp, imatrix, pfx)
        if "ffn_post_norm" in layer:
            ffn = _norm(ffn, layer, "ffn_post_norm", hp)
        if swin:
            ffn = _norm(ffn, layer, "ffn_norm", hp)
        if hp.parallel_residual:
            x = x + attn + ffn
        else:
            x = x + ffn * hp.f_residual_scale
        x = _layer_out(x, params, il, hidden_sink)
        if deepstack_add is not None and il < deepstack_add.shape[0]:
            x = x + deepstack_add[il].to(x.dtype)

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
    sup = hp.extra.get("logit_suppress")
    if sup is not None and T == 1:
        # chameleon: image-token ids to -FLT_MAX; the reference reaches only
        # the first logits row (chameleon.cpp:147-156), so decode steps only
        logits[..., sup[0]:sup[1]] = torch.finfo(torch.float32).min
    return logits, cache
