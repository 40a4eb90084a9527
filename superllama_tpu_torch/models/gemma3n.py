"""Gemma3n (MatFormer E2B / E4B) forward: the AltUp multi-stream hidden
state, the LAUREL low-rank residual, per-layer input embeddings, activation
sparsity and the shared-KV tail layers, on the iSWA two-tier cache.

Counterpart of the JAX package's ``models/gemma3n.py``
(src/models/gemma3n-iswa.cpp, with HF's Gemma3n AltUp index order):

 - the hidden state is a stack of n_altup streams; each layer predicts all
   of them from the active one (a router → per-pair coefficients), runs
   attention and the FFN on the active prediction only, then corrects
   every stream with the innovation;
 - LAUREL: a low-rank residual (laurel_l · laurel_r, a post norm) added to
   the attention output, scaled 1/√2;
 - per-layer inputs: a second embedding table (n_embd_altup a layer)
   merged with a projection of the input embedding, gating the correction
   added to the other streams;
 - activation sparsity on the first layers' FFN gate: relu(x − (mean +
   k·std)), the biased std;
 - layers ≥ n_layer_kv_from_start compute q only and attend the cache of
   the last KV layer of their kind (n_kv_from_start − 2 for SWA, − 1 full);
 - attention: q / k RMS-normed a head, a non-parametric RMS norm on v, kq
   scale 1, iSWA with a separate SWA rope base, the plain path over each
   tier as in JAX; a final logit softcap.

No recurrence and no kernel of its own: the projections go through ``mm``
(qmv / qmm on packed weights). The cache is written in place.
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..runtime.kv_cache import (ISWACache, causal_mask, iswa_layer_split, kv_advance,
                                kv_ring_advance, kv_ring_slots, kv_update_layer,
                                kv_write_slots)
from .hparams import HParams
from .llama import mm


def _magnitude(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))


def _modalities(layer: dict, hp: HParams, x: torch.Tensor) -> torch.Tensor:
    ri = ops.rms_norm(x, layer["altup_router_norm"], hp.rms_eps) / hp.n_embd
    return torch.tanh(mm(ri, layer["altup_router"]).to(torch.float32)).to(x.dtype)


def _altup_predict(layer: dict, hp: HParams, X: torch.Tensor, i_act: int) -> torch.Tensor:
    """X (A, B, T, E) → predictions (A, B, T, E) (Gemma3nTextAltUp.predict)."""
    A = X.shape[0]
    mod = _modalities(layer, hp, X[i_act])                       # (B, T, A)
    coefs = mm(mod, layer["altup_predict_coef"])                 # (B, T, A²)
    coefs = coefs.reshape(*mod.shape[:-1], A, A).transpose(-1, -2)
    pred = torch.einsum("ibte,btij->jbte", X.to(torch.float32),
                        coefs.to(torch.float32)).to(X.dtype)
    return pred + X


def _altup_correct(layer: dict, hp: HParams, pred: torch.Tensor, activated: torch.Tensor,
                   i_act: int) -> torch.Tensor:
    """Every stream gets innovation · (coef + 1) (Gemma3nTextAltUp.correct)."""
    mod = _modalities(layer, hp, activated)                      # (B, T, A)
    innovation = activated - pred[i_act]
    coefs = mm(mod, layer["altup_correct_coef"]) + 1.0           # (B, T, A)
    return pred + innovation[None] * torch.movedim(coefs, -1, 0)[..., None]


def _laurel(layer: dict, hp: HParams, x: torch.Tensor) -> torch.Tensor:
    t = mm(mm(x, layer["laurel_l"]), layer["laurel_r"])
    return ops.rms_norm(t, layer["laurel_post_norm"], hp.rms_eps) + x


def _gaussian_topk(x: torch.Tensor, std_mul: float) -> torch.Tensor:
    """relu(x − (mean + std_mul · std)), the biased std (HF and the JAX
    package; ggml's /(N − 1) differs only at small widths)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    std = torch.sqrt(torch.mean(torch.square(x - mean), dim=-1, keepdim=True))
    return torch.relu(x - (mean + std_mul * std))


def gemma3n_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                    cache: ISWACache, flash: bool | None = None,
                    s_window: int | None = None) -> tuple[torch.Tensor, ISWACache]:
    """One step over (B, T) tokens on the iSWA cache; returns (logits,
    cache), the cache updated in place. ``flash`` and ``s_window`` are
    accepted and ignored (each tier is read whole, as in JAX)."""
    if not isinstance(cache, ISWACache):
        raise ValueError(f"gemma3n runs on the iSWA two-tier cache, not {type(cache).__name__}")
    B, T = tokens.shape
    g = hp.extra["gemma3n"]
    A, EA, i_act = g["n_altup"], g["n_embd_altup"], g["i_altup_act"]
    n_kv_layers = g["n_layer_kv_from_start"]
    E, L = hp.n_embd, hp.n_layer
    H, Hkv, D, Dv = hp.n_head, hp.n_head_kv, hp.head_dim, hp.head_dim_v
    dev = tokens.device
    pos = pos.to(torch.int32)
    safe_pos = torch.clamp(pos, min=0)
    inv_freq, ms = ops.rope_frequencies(D, hp.n_rot, hp.rope_freq_base, device=dev)
    inv_freq_swa = (ops.rope_frequencies(D, hp.n_rot, hp.rope_freq_base_swa, device=dev)[0]
                    if hp.rope_freq_base_swa > 0.0 else inv_freq)

    full_layers, swa_layers = iswa_layer_split(hp)
    fidx = {il: i for i, il in enumerate(full_layers)}
    sidx = {il: i for i, il in enumerate(swa_layers)}
    slots_full = kv_write_slots(cache.full, T)
    slots_swa = kv_ring_slots(pos, cache.swa.max_seq)
    kv_advance(cache.full, slots_full, pos)
    kv_ring_advance(cache.swa, slots_swa, pos)
    mask_full = causal_mask(cache.full.positions(), pos)
    mask_swa = causal_mask(cache.swa.positions(), pos, hp.swa_window)

    tok = tokens.to(torch.int64)
    x0 = params["token_embd"][tok] * (E ** 0.5)                  # (B, T, E)
    # per-layer inputs (B, T, L, EA) (project_per_layer_inputs)
    pl_embd = params["per_layer_token_embd"][tok].reshape(B, T, L, EA) * (EA ** 0.5)
    pl_proj = (mm(x0, params["per_layer_model_proj"]) / (E ** 0.5)).reshape(B, T, L, EA)
    pl_proj = ops.rms_norm(pl_proj, params["per_layer_proj_norm"], hp.rms_eps)
    per_layer = (pl_proj + pl_embd) * (2.0 ** -0.5)
    # n_altup streams, magnitude-matched to the embedding
    target_mag = _magnitude(x0)
    added = torch.einsum("bte,jeo->jbto", x0, params["altup_proj"])
    added = added * target_mag[None] / torch.clamp(_magnitude(added), min=1e-30)
    X = torch.cat([x0[None], added], dim=0)                      # (A, B, T, E)

    for il, layer in enumerate(params["layers"]):
        is_swa = hp.is_swa_layer(il)
        pred = _altup_predict(layer, hp, X, i_act)
        act = pred[i_act]
        h = ops.rms_norm(act, layer["attn_norm"], hp.rms_eps)
        laurel_out = _laurel(layer, hp, h)

        f = inv_freq_swa if is_swa else inv_freq
        q = ops.rms_norm(mm(h, layer["wq"]).reshape(B, T, H, D), layer["attn_q_norm"],
                         hp.rms_eps)
        q = ops.apply_rope(q, safe_pos, f, hp.rope_type, ms)
        if il < n_kv_layers:
            k = ops.rms_norm(mm(h, layer["wk"]).reshape(B, T, Hkv, D), layer["attn_k_norm"],
                             hp.rms_eps)
            k = ops.apply_rope(k, safe_pos, f, hp.rope_type, ms)
            v = ops.rms_norm(mm(h, layer["wv"]).reshape(B, T, Hkv, Dv), None, hp.rms_eps)
            kv_il = il
            if is_swa:
                kv_update_layer(cache.swa, sidx[il], slots_swa, k, v)
            else:
                kv_update_layer(cache.full, fidx[il], slots_full, k, v)
        else:   # the shared-KV tail: the last KV layer of the same kind
            kv_il = n_kv_layers - (2 if is_swa else 1)
        tier, li, mask = ((cache.swa, sidx[kv_il], mask_swa) if is_swa
                          else (cache.full, fidx[kv_il], mask_full))
        S = tier.max_seq
        attn = ops.attention_ref(q, tier.k[li][:, :, :S], tier.v[li][:, :, :S], mask, scale=1.0)
        attn = ops.rms_norm(mm(attn.reshape(B, T, H * Dv), layer["wo"]),
                            layer["attn_post_norm"], hp.rms_eps) + act
        attn_laurel = (attn + laurel_out) * (2.0 ** -0.5)

        h2 = ops.rms_norm(attn_laurel, layer["ffn_norm"], hp.rms_eps)
        gate = mm(h2, layer["ffn_gate"])
        if g["sparsity"][il] > 0.0:
            gate = _gaussian_topk(gate, g["sparsity"][il])
        ffn = mm(ops.gelu(gate) * mm(h2, layer["ffn_up"]), layer["ffn_down"])
        gated = ops.rms_norm(ffn, layer["ffn_post_norm"], hp.rms_eps) + attn_laurel

        corrected = _altup_correct(layer, hp, pred, gated, i_act)
        fp = corrected[i_act] * layer["altup_correct_scale"]
        fp = ops.gelu(mm(fp, layer["per_layer_inp_gate"])) * per_layer[:, :, il]
        fp = ops.rms_norm(mm(fp, layer["per_layer_proj"]), layer["per_layer_post_norm"],
                          hp.rms_eps)
        X = torch.cat([corrected[:1], corrected[1:] + fp[None]], dim=0)

    # merge: the active stream + the magnitude-matched unembeddings of the rest
    target_mag = _magnitude(X[i_act])
    unembd = torch.einsum("jbte,jeo->jbto", X[1:], params["altup_unembd_proj"])
    unembd = unembd * target_mag[None] / torch.clamp(_magnitude(unembd), min=1e-30)
    x = (X[0] + unembd.sum(dim=0)) / A
    x = ops.rms_norm(x, params["output_norm"], hp.rms_eps)
    w_out = params.get("output")
    logits = mm(x, w_out) if w_out is not None else x @ params["token_embd"].T
    cap = hp.final_logit_softcap
    if cap > 0.0:
        logits = cap * torch.tanh(logits.to(torch.float32) / cap).to(logits.dtype)
    return logits, cache
