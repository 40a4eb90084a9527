"""RWKV-6 ("Finch"), RWKV-7 ("Goose"), ARWKV-7 and RWKV6-in-Qwen2 forwards.

Counterpart of the JAX package's ``models/rwkv.py`` (src/models/rwkv6.cpp,
rwkv7.cpp, arwkv7.cpp, rwkv6qwen2.cpp): per layer a token-shift time mix
(the lerps, low-rank stacks, decay and the wkv recurrence) and a channel
mix (or a silu-gated FFN for the two qwen-style hybrids), with the state in
an ``RWKVCache`` (the two token-shift vectors and the (H, D, D) wkv state a
layer, f32).

The recurrences run in ``ops/wkv.py`` (the hand-written CUDA kernel on the
card, the plain loop on the CPU); the lerps, norms and projections stay
plain torch and ``mm`` (qmv / qmm on packed weights). The forwards update
the cache in place: rows whose pos[:, 0] < 0 keep their shift and wkv
state (the JAX engine's ``mask_rows``; here inside the step, so a step is
captured in a CUDA graph like any other). ``pos`` marks only those rows:
the state has no positions.
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..ops.wkv import gla, wkv6, wkv7
from ..runtime.recurrent import RWKVCache
from .hparams import HParams
from .llama import dense_ffn, mm
from .mamba import _store, row_active


def _group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, n_head: int,
                eps: float = 64e-5) -> torch.Tensor:
    """ggml_norm over head-size groups + affine (time_mix_ln)."""
    B, T, E = x.shape
    g = x.reshape(B, T, n_head, E // n_head).to(torch.float32)
    mu = g.mean(dim=-1, keepdim=True)
    var = torch.square(g - mu).mean(dim=-1, keepdim=True)
    g = ((g - mu) * torch.rsqrt(var + eps)).reshape(B, T, E).to(x.dtype)
    return g * weight + bias


def _token_shift(x_norm: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Each position's previous input; the first from the carried shift."""
    return torch.cat([shift[:, None, :].to(x_norm.dtype), x_norm[:, :-1, :]], dim=1)


def _rwkv6_time_mix(layer: dict, hp: HParams, cur: torch.Tensor, x_prev: torch.Tensor,
                    state: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """RWKV-6's time mix, or qrwkv's (no ``time_mix_first``: sigmoid gate,
    GQA k / v, k·(1−w), the gated linear attention, no group norm); the wkv
    state (B, H, D, D) updated in place."""
    B, T, E = cur.shape
    D = hp.wkv_head_size
    H = E // D
    sx = x_prev - cur
    xxx = cur + sx * layer["time_mix_lerp_x"].reshape(E)
    xxx = torch.tanh(mm(xxx, layer["time_mix_w1"]))             # (B, T, 5·ed)
    ed = xxx.shape[-1] // 5
    xxx = torch.einsum("btif,ifo->btio", xxx.reshape(B, T, 5, ed), layer["time_mix_w2"])
    if "time_mix_lerp_fused" in layer:
        fused = layer["time_mix_lerp_fused"].reshape(5, E)
        mixed = cur[:, :, None, :] + (xxx + fused) * sx[:, :, None, :]
        xw, xk, xv, xr, xg = (mixed[:, :, i, :] for i in range(5))
    else:
        lerps = [layer["time_mix_lerp_" + n].reshape(E) for n in ("w", "k", "v", "r", "g")]
        xw, xk, xv, xr, xg = (cur + (xxx[:, :, i, :] + lerps[i]) * sx for i in range(5))

    qrwkv = "time_mix_first" not in layer
    r = mm(xr, layer["time_mix_receptance"])
    k = mm(xk, layer["time_mix_key"])
    v = mm(xv, layer["time_mix_value"])
    if "time_mix_receptance_b" in layer:
        r = r + layer["time_mix_receptance_b"]
    if "time_mix_key_b" in layer:
        k = k + layer["time_mix_key_b"]
    if "time_mix_value_b" in layer:
        v = v + layer["time_mix_value_b"]
    gate = mm(xg, layer["time_mix_gate"])
    g = torch.sigmoid(gate) if qrwkv else ops.silu(gate)
    if k.shape[-1] != E:                       # GQA: repeat the kv heads
        Hkv = k.shape[-1] // D
        k = torch.repeat_interleave(k.reshape(B, T, Hkv, D), H // Hkv, dim=2).reshape(B, T, E)
        v = torch.repeat_interleave(v.reshape(B, T, Hkv, D), H // Hkv, dim=2).reshape(B, T, E)

    w = mm(torch.tanh(mm(xw, layer["time_mix_decay_w1"])), layer["time_mix_decay_w2"])
    w = w + layer["time_mix_decay"].reshape(E)
    w = torch.exp(-torch.exp(w.to(torch.float32)))

    shp = (B, T, H, D)
    if qrwkv:
        k = k * (1.0 - w).to(k.dtype)
        y = gla(r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp), state,
                D ** -0.5, active)
        y = y.reshape(B, T, E).to(cur.dtype)
    else:
        u = layer["time_mix_first"].reshape(H, D).to(torch.float32)
        y = wkv6(r.reshape(shp), k.reshape(shp), v.reshape(shp), u, w.reshape(shp), state,
                 active)
        y = _group_norm(y.reshape(B, T, E).to(cur.dtype), layer["time_mix_ln"],
                        layer["time_mix_ln_b"], H)
    return mm(y * g, layer["time_mix_output"])


def _rwkv7_time_mix(layer: dict, hp: HParams, cur: torch.Tensor, x_prev: torch.Tensor,
                    state: torch.Tensor, v_first: torch.Tensor | None,
                    active: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-7's time mix: the v_first residual toward layer 0's values, the
    l2-normed kk, the r_k bonus and the optional gate; returns (y,
    v_first), the wkv state updated in place."""
    B, T, E = cur.shape
    D = hp.wkv_head_size
    H = E // D
    has_gating = "time_mix_g1" in layer
    sx = x_prev - cur
    n_mix = 6 if has_gating else 5
    fused = layer["time_mix_lerp_fused"].reshape(n_mix, E)
    mixed = cur[:, :, None, :] + fused * sx[:, :, None, :]      # (B, T, n, E)
    xr, xw, xk, xv, xa = (mixed[:, :, i, :] for i in range(5))
    xg = mixed[:, :, 5, :] if has_gating else None

    r = mm(xr, layer["time_mix_receptance"])
    w = mm(torch.tanh(mm(xw, layer["time_mix_w1"])), layer["time_mix_w2"])
    w = w + layer["time_mix_w0"].reshape(E)
    # decay in (exp(-0.606531), 1): exp(-e^-0.5 · sigmoid(w)) (rwkv7-base.cpp:69)
    w = torch.exp(-0.606531 * torch.sigmoid(w.to(torch.float32)))

    k = mm(xk, layer["time_mix_key"])
    v = mm(xv, layer["time_mix_value"])
    if v_first is None:
        v_first = v
    else:                   # residual value mixing toward the first layer's values
        lv = mm(mm(xv, layer["time_mix_v1"]), layer["time_mix_v2"])
        v = v + (v_first - v) * torch.sigmoid(lv + layer["time_mix_v0"].reshape(E))
    a = torch.sigmoid(mm(mm(xa, layer["time_mix_a1"]), layer["time_mix_a2"])
                      + layer["time_mix_a0"].reshape(E))

    kk = (k * layer["time_mix_k_k"].reshape(E)).reshape(B, T, H, D)
    kk = kk * torch.rsqrt(torch.sum(torch.square(kk.to(torch.float32)), dim=-1, keepdim=True)
                          + 1e-12).to(kk.dtype)             # l2 norm a head
    ka = k * layer["time_mix_k_a"].reshape(E)
    k = k + a * ka - ka

    shp = (B, T, H, D)
    y = wkv7(r.reshape(shp), w.reshape(shp), k.reshape(shp), v.reshape(shp), -kk,
             kk * a.reshape(shp), state, active)
    y = y.reshape(B, T, E).to(cur.dtype)
    if "time_mix_ln" in layer:
        y = _group_norm(y, layer["time_mix_ln"], layer["time_mix_ln_b"], H)
    # bonus: a head's (r·k·r_k) scalar times v (rwkv7-base.cpp:124-126)
    rk = torch.sum((k * r).reshape(shp) * layer["time_mix_r_k"].reshape(H, D), dim=-1,
                   keepdim=True)
    y = y + (v.reshape(shp) * rk).reshape(B, T, E)
    if has_gating:
        y = y * mm(torch.sigmoid(mm(xg, layer["time_mix_g1"])), layer["time_mix_g2"])
    return mm(y, layer["time_mix_output"]), v_first


def _channel_mix(layer: dict, cur: torch.Tensor, x_prev: torch.Tensor,
                 v7: bool) -> torch.Tensor:
    sx = x_prev - cur
    xk = cur + sx * layer["channel_mix_lerp_k"].reshape(-1)
    k = torch.square(torch.relu(mm(xk, layer["channel_mix_key"])))
    if v7:
        return mm(k, layer["channel_mix_value"])
    xr = cur + sx * layer["channel_mix_lerp_r"].reshape(-1)
    return torch.sigmoid(mm(xr, layer["channel_mix_receptance"])) * mm(
        k, layer["channel_mix_value"])


def _head(params: dict, hp: HParams, x: torch.Tensor, rms: bool) -> torch.Tensor:
    if rms:
        x = ops.rms_norm(x, params["output_norm"], hp.rms_eps)
    else:
        x = ops.layer_norm(x, params["output_norm"], params.get("output_norm_b"), hp.norm_eps)
    w_out = params.get("output")
    return mm(x, w_out) if w_out is not None else x @ params["token_embd"].T


def _rwkv_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                  cache: RWKVCache, v7: bool) -> tuple[torch.Tensor, RWKVCache]:
    active = row_active(pos, tokens.shape[0])
    x = params["token_embd"][tokens.to(torch.int64)]
    x = ops.layer_norm(x, params["token_embd_norm"], params.get("token_embd_norm_b"),
                       hp.norm_eps)
    v_first = None
    for il, layer in enumerate(params["layers"]):
        att_norm = ops.layer_norm(x, layer["attn_norm"], layer.get("attn_norm_b"), hp.norm_eps)
        x_prev = _token_shift(att_norm, cache.shift[il, :, 0])
        if v7:
            y, v_first = _rwkv7_time_mix(layer, hp, att_norm, x_prev, cache.wkv[il], v_first,
                                         active)
        else:
            y = _rwkv6_time_mix(layer, hp, att_norm, x_prev, cache.wkv[il], active)
        x = x + y
        ffn_norm = ops.layer_norm(x, layer["attn_norm_2"], layer.get("attn_norm_2_b"),
                                  hp.norm_eps)
        x_prev = _token_shift(ffn_norm, cache.shift[il, :, 1])
        x = x + _channel_mix(layer, ffn_norm, x_prev, v7)
        _store(cache.shift[il, :, 0], att_norm[:, -1], active)     # the active rows' shifts
        _store(cache.shift[il, :, 1], ffn_norm[:, -1], active)
        if hp.rescale_every_n_layers and (il + 1) % hp.rescale_every_n_layers == 0:
            x = x * 0.5
    return _head(params, hp, x, rms=False), cache


def _qwen_hybrid_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                         cache: RWKVCache, v7: bool) -> tuple[torch.Tensor, RWKVCache]:
    """arwkv7 / rwkv6qwen2: the time mix between RMS norms and a silu-gated
    FFN; one token-shift stream (both shift slots hold it); no embedding
    norm."""
    active = row_active(pos, tokens.shape[0])
    x = params["token_embd"][tokens.to(torch.int64)]
    v_first = None
    for il, layer in enumerate(params["layers"]):
        att_norm = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        x_prev = _token_shift(att_norm, cache.shift[il, :, 0])
        if v7:
            y, v_first = _rwkv7_time_mix(layer, hp, att_norm, x_prev, cache.wkv[il], v_first,
                                         active)
        else:
            y = _rwkv6_time_mix(layer, hp, att_norm, x_prev, cache.wkv[il], active)
        x = x + y
        x = x + dense_ffn(ops.rms_norm(x, layer["ffn_norm"], hp.rms_eps), layer, hp)
        _store(cache.shift[il, :, 0], att_norm[:, -1], active)
        _store(cache.shift[il, :, 1], att_norm[:, -1], active)
    return _head(params, hp, x, rms=True), cache


def rwkv6_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                  cache: RWKVCache, flash: bool | None = None,
                  s_window: int | None = None) -> tuple[torch.Tensor, RWKVCache]:
    """One step over (B, T) tokens; returns (logits, cache), the cache
    updated in place. ``flash`` and ``s_window`` are accepted and ignored."""
    return _rwkv_forward(params, hp, tokens, pos, cache, v7=False)


def rwkv7_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                  cache: RWKVCache, flash: bool | None = None,
                  s_window: int | None = None) -> tuple[torch.Tensor, RWKVCache]:
    return _rwkv_forward(params, hp, tokens, pos, cache, v7=True)


def arwkv7_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                   cache: RWKVCache, flash: bool | None = None,
                   s_window: int | None = None) -> tuple[torch.Tensor, RWKVCache]:
    """ARWKV-7 (src/models/arwkv7.cpp): RWKV-7's time mix in a qwen block."""
    return _qwen_hybrid_forward(params, hp, tokens, pos, cache, v7=True)


def rwkv6qwen2_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                       cache: RWKVCache, flash: bool | None = None,
                       s_window: int | None = None) -> tuple[torch.Tensor, RWKVCache]:
    """RWKV6-in-Qwen2 (src/models/rwkv6qwen2.cpp): qrwkv's time mix in a
    qwen block."""
    return _qwen_hybrid_forward(params, hp, tokens, pos, cache, v7=False)
