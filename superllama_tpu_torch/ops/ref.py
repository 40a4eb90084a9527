"""Plain PyTorch reference ops.

The numerical semantics of the port, counterpart of the JAX package's
``ops/jnp_ref.py``: the models call these directly, and the kernels are held
against them. Reductions run in f32.

 - rms_norm: ggml_rms_norm; layer_norm: ggml_norm (+ weight, bias)
 - rope: ggml_rope_ext NORM/NEOX modes incl. YaRN
 - attention: ggml_flash_attn_ext semantics with an f32 softmax
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ----------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm; weight=None → non-parametric."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.to(torch.float32)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm; weight=None → non-parametric (olmo), bias=None → none."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


# ----------------------------------------------------------------- rope

ROPE_TYPE_NONE = -1
ROPE_TYPE_NORM = 0     # rotate adjacent pairs (2i, 2i+1): llama-style GGUF layout
ROPE_TYPE_NEOX = 2     # rotate split halves (i, i + n/2)


def rope_frequencies(
    head_dim: int,
    n_rot: int,
    freq_base: float = 10000.0,
    freq_scale: float = 1.0,
    *,
    ext_factor: float = 0.0,
    attn_factor: float = 1.0,
    beta_fast: float = 32.0,
    beta_slow: float = 1.0,
    orig_ctx: int = 0,
    device=None,
) -> tuple[torch.Tensor, float]:
    """Per-dimension inverse frequencies + magnitude scale, incl. YaRN ramp.

    Returns (inv_freq[n_rot//2] f32, mscale). Linear scaling is freq_scale < 1
    with ext_factor == 0."""
    dims = torch.arange(0, n_rot, 2, dtype=torch.float32, device=device)
    # a fill, not a host-to-device copy: a CUDA graph may capture this
    theta = torch.pow(torch.full((), freq_base, dtype=torch.float32,
                                 device=device), -dims / n_rot)
    if ext_factor == 0.0:
        return theta * freq_scale, attn_factor

    def corr_dim(n_orig_ctx, beta):
        return n_rot * math.log(n_orig_ctx / (beta * 2 * math.pi)) / (2 * math.log(freq_base))

    low = max(0.0, math.floor(corr_dim(orig_ctx, beta_fast)))
    high = min(n_rot - 1.0, math.ceil(corr_dim(orig_ctx, beta_slow)))
    ramp = torch.clamp((dims / 2.0 - low / 2.0) / max((high - low) / 2.0, 1e-3),
                       0.0, 1.0)
    ramp = 1.0 - ramp
    theta_interp = theta * freq_scale
    theta_mix = theta_interp * (1.0 - ramp * ext_factor) + theta * (ramp * ext_factor)
    mscale = (attn_factor * (1.0 + 0.1 * math.log(1.0 / freq_scale))
              if freq_scale < 1.0 else attn_factor)
    return theta_mix, mscale


def apply_rope(
    x: torch.Tensor,         # (..., T, H, D)
    pos: torch.Tensor,       # (..., T)
    inv_freq: torch.Tensor,  # (n_rot//2,)
    rope_type: int = ROPE_TYPE_NORM,
    mscale: float = 1.0,
) -> torch.Tensor:
    """Rotary position embedding over the first n_rot dims of each head."""
    n_rot = inv_freq.shape[0] * 2
    d = x.shape[-1]
    angles = pos[..., None].to(torch.float32) * inv_freq     # (..., T, n_rot/2)
    cos = (torch.cos(angles) * mscale)[..., None, :]         # (..., T, 1, n_rot/2)
    sin = (torch.sin(angles) * mscale)[..., None, :]
    xf = x.to(torch.float32)
    rot, rest = xf[..., :n_rot], xf[..., n_rot:]
    if rope_type == ROPE_TYPE_NEOX:
        x1, x2 = rot[..., : n_rot // 2], rot[..., n_rot // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    else:  # NORM: adjacent pairs
        x1 = rot[..., 0::2]
        x2 = rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(rot.shape)
    if d > n_rot:
        out = torch.cat([out, rest], dim=-1)
    return out.to(x.dtype)


def quant_scale(amax: torch.Tensor, top: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(amax / top, top / amax or 0 where amax is 0) by true division, as the
    JAX package computes a quantizer's scale and its inverse: torch turns
    ``scalar / tensor`` into a multiplication by a reciprocal, and on CUDA a
    division by a Python scalar too, which moves a code by one now and then."""
    t = torch.full_like(amax, top)
    return amax / t, torch.where(amax > 0, t / amax, torch.zeros_like(amax))


# ----------------------------------------------------------------- attention


def attention_ref(
    q: torch.Tensor,        # (B, T, H, D)
    k: torch.Tensor,        # (B, H_kv, S, D): KV-cache layout
    v: torch.Tensor,        # (B, H_kv, S, Dv)
    mask: torch.Tensor,     # (B, 1, T, S) additive, -inf for masked
    scale: float | None = None,
    logit_softcap: float = 0.0,
    sinks: torch.Tensor | None = None,  # (H,) per-head sink logit
) -> torch.Tensor:
    """Scaled-dot-product attention with GQA broadcast, f32 softmax.

    ``sinks`` is a learned per-head logit that joins the softmax
    normalization but contributes no value."""
    B, T, H, D = q.shape
    H_kv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    rep = H // H_kv
    qf = q.to(torch.float32).transpose(1, 2)                         # (B,H,T,D)
    kf = torch.repeat_interleave(k.to(torch.float32), rep, dim=1)    # (B,H,S,D)
    vf = torch.repeat_interleave(v.to(torch.float32), rep, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    logits = logits + mask.to(torch.float32)      # (B, 1 or H, T, S)
    if sinks is not None:
        sink = sinks.to(torch.float32).reshape(1, H, 1, 1)
        m = torch.maximum(torch.amax(logits, dim=-1, keepdim=True), sink)
        p = torch.exp(logits - m)
        probs = p / (torch.sum(p, dim=-1, keepdim=True) + torch.exp(sink - m))
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", probs, vf)                  # (B,H,T,Dv)
    return out.transpose(1, 2).to(q.dtype)


def attention_gqa(
    q: torch.Tensor,        # (B, T, H, D)
    k: torch.Tensor,        # (B, H_kv, S, D)
    v: torch.Tensor,        # (B, H_kv, S, Dv)
    mask: torch.Tensor,     # (B, 1 or H, T, S) additive
    scale: float | None = None,
    logit_softcap: float = 0.0,
    sinks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Grouped-query attention without repeating K/V to H heads: dots in the
    stored dtype with f32 accumulation, f32 softmax."""
    B, T, H, D = q.shape
    H_kv, S = k.shape[1], k.shape[2]
    G = H // H_kv
    Dv = v.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = (q.reshape(B, T, H_kv, G, D).permute(0, 2, 3, 1, 4)
          .reshape(B, H_kv, G * T, D))
    # products of stored-dtype values are exact in f32: an f32 matmul is the
    # stored-dtype dot with f32 accumulation
    logits = torch.matmul(qg.to(torch.float32),
                          k.to(torch.float32).transpose(2, 3)) * scale
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    if mask.shape[1] == 1:
        mrow = torch.broadcast_to(mask.to(torch.float32),
                                  (B, G, T, S)).reshape(B, 1, G * T, S)
    else:   # a per-head mask (ALiBi): rows grouped by kv head
        mrow = mask.to(torch.float32).reshape(B, H_kv, G * T, S)
    logits = logits + mrow
    if sinks is not None:
        sink = torch.broadcast_to(
            sinks.to(torch.float32).reshape(H_kv, G, 1), (H_kv, G, T)
        ).reshape(1, H_kv, G * T, 1)
        m = torch.maximum(torch.amax(logits, dim=-1, keepdim=True), sink)
        p = torch.exp(logits - m)
        probs = p / (torch.sum(p, dim=-1, keepdim=True) + torch.exp(sink - m))
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return (out.reshape(B, H_kv, G, T, Dv).permute(0, 3, 1, 2, 4)
            .reshape(B, T, H, Dv).to(q.dtype))


# ----------------------------------------------------------------- activations


def silu(x):
    xf = x.to(torch.float32)
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def gelu(x):
    xf = x.to(torch.float32)
    return (0.5 * xf * (1.0 + torch.tanh(0.7978845608028654 * (xf + 0.044715 * xf ** 3)))).to(x.dtype)


def gelu_erf(x):
    xf = x.to(torch.float32)
    return (0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def relu(x):
    return torch.clamp(x, min=0)


def relu_sq(x):
    r = torch.clamp(x, min=0)
    return r * r


def xielu(x, alpha_n_raw: float, alpha_p_raw: float, beta: float, eps: float):
    """xIELU (apertus; ggml_xielu) over the raw GGUF parameters, which are
    log-space: alpha_p = softplus(raw), alpha_n = beta + softplus(raw).
    Positive branch alpha_p·x² + beta·x, negative (expm1(min(x, eps)) − x)
    ·alpha_n + beta·x. The parameters are Python floats, so a captured step
    copies nothing to the device."""
    xf = x.to(torch.float32)
    a_p = _softplus_f32(alpha_p_raw)
    a_n = float(np.float32(beta) + np.float32(_softplus_f32(alpha_n_raw)))
    pos = a_p * xf * xf + beta * xf
    neg = (torch.expm1(torch.clamp(xf, max=eps)) - xf) * a_n + beta * xf
    return torch.where(xf > 0, pos, neg).to(x.dtype)


def _softplus_f32(v: float) -> float:
    """softplus in f32, as the JAX package computes it on a traced f32."""
    return float(np.logaddexp(np.float32(v), np.float32(0.0)))


def quick_gelu(x):
    xf = x.to(torch.float32)
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def swiglu(gate, up):
    return silu(gate) * up


def geglu(gate, up):
    return gelu(gate) * up


def swiglu_oai(gate, up, alpha: float = 1.702, limit: float = 7.0):
    """gpt-oss clamped swiglu: (up + 1)·gate·σ(α·gate), gate ≤ limit,
    |up| ≤ limit."""
    g = torch.clamp(gate.to(torch.float32), max=limit)
    u = torch.clamp(up.to(torch.float32), -limit, limit)
    return ((u + 1.0) * g * torch.sigmoid(alpha * g)).to(gate.dtype)


# gated (gate, up) -> act; "gelu"/"gelu_tanh" name the tanh approximation
GLU_FNS = {
    "silu": swiglu,
    "gelu": geglu,
    "gelu_tanh": geglu,
    "gelu_erf": lambda g, u: gelu_erf(g) * u,
    "relu": lambda g, u: relu(g) * u,
    "relu2": lambda g, u: relu_sq(g) * u,
}
# gate-less FFN activations (gpt2, falcon, bloom, starcoder, nemotron…)
ACT_FNS = {"silu": silu, "gelu": gelu, "gelu_tanh": gelu, "gelu_erf": gelu_erf,
           "relu": relu, "relu2": relu_sq}


# ----------------------------------------------------------------- softmax


def softmax_ext(x: torch.Tensor, mask: torch.Tensor | None = None,
                scale: float = 1.0) -> torch.Tensor:
    """ggml_soft_max_ext semantics (scale + optional additive mask), f32."""
    xf = x.to(torch.float32) * scale
    if mask is not None:
        xf = xf + mask.to(torch.float32)
    return torch.softmax(xf, dim=-1).to(x.dtype)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """All but the top-k logits masked to -inf (ties at the k-th value kept)."""
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.full_like(logits, -math.inf), logits)


# ----------------------------------------------------------------- grouped matmul


def grouped_matmul_plain(xs: torch.Tensor, w: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of ``ops/grouped_matmul.py``'s kernel, the counterpart
    of ``jax.lax.ragged_dot(xs, w, group_sizes, preferred_element_type=f32)``:
    rows offsets[g]:offsets[g + 1] of xs (R, K) times w[g] (G, K, N), in f32
    (bf16 products are exact there), a loop over the groups with their
    bounds read on the host. Returns (R, N) f32."""
    out = torch.zeros((xs.shape[0], w.shape[2]), dtype=torch.float32, device=xs.device)
    off = offsets.tolist()
    for g in range(w.shape[0]):
        lo, hi = off[g], off[g + 1]
        if hi > lo:
            out[lo:hi] = xs[lo:hi].to(torch.float32) @ w[g].to(torch.float32)
    return out


# ----------------------------------------------------------------- selective scan


def ssm_scan_plain(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   active: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``ops/ssm_scan.py``'s kernel: a loop over T of the
    JAX mixers' ``step`` functions (``superllama_tpu/models/mamba.py``
    :64-70 mamba1, :123-131 mamba2, :186-194 plamo2), in f32.

    state (B, nh, hd, ds) in its cache type, updated in place; x (B, T, nh,
    hd), dt (B, T, nh), A (nh, ds) (mamba1, whose nh is d_inner and hd 1) or
    (nh,) (a scalar decay a head), Bm / Cm (B, T, G, ds), head h reading
    group h // (nh / G); all f32. ``active`` (B,) bool: a row that is False
    keeps its state and gets y 0. Returns y (B, T, nh, hd) f32."""
    Bt, T, nh, hd = x.shape
    rep = nh // Bm.shape[2]
    b_h = torch.repeat_interleave(Bm, rep, dim=2)          # (B, T, nh, ds)
    c_h = torch.repeat_interleave(Cm, rep, dim=2)
    st = state.to(torch.float32)
    ys = []
    for t in range(T):
        dt_t = dt[:, t]                                     # (B, nh)
        if A.ndim == 2:
            dA = torch.exp(dt_t[..., None] * A)[:, :, None, :]
        else:
            dA = torch.exp(dt_t * A)[..., None, None]
        dBx = (dt_t[..., None] * x[:, t])[..., None] * b_h[:, t][:, :, None, :]
        st = st * dA + dBx
        ys.append(torch.einsum("bhps,bhs->bhp", st, c_h[:, t]))
    y = torch.stack(ys, dim=1)
    if active is None:
        state.copy_(st.to(state.dtype))
        return y
    keep = active.reshape(-1, 1, 1, 1)
    state.copy_(torch.where(keep, st.to(state.dtype), state))
    return torch.where(keep, y, torch.zeros_like(y))


def _rec_done(state: torch.Tensor, st: torch.Tensor, y: torch.Tensor,
              active: torch.Tensor | None) -> torch.Tensor:
    """Write a recurrence's final f32 state back into ``state`` (its cache
    type) and return y; rows whose ``active`` flag is False keep their state
    and get y 0."""
    if active is None:
        state.copy_(st.to(state.dtype))
        return y
    keep = active.reshape(-1, 1, 1, 1)
    state.copy_(torch.where(keep, st.to(state.dtype), state))
    return torch.where(keep, y, torch.zeros_like(y))


def _steps(*xs: torch.Tensor) -> list[torch.Tensor]:
    return [x.to(torch.float32) for x in xs]


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
               w: torch.Tensor, state: torch.Tensor,
               active: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``ops/wkv.py::wkv6``: the JAX ``wkv6`` step
    (``superllama_tpu/models/rwkv.py:39``) looped over T in f32.

    r / k / v / w (B, T, H, D), u (H, D); state (B, H, D, D) [i=key, j=val]
    in its cache type, updated in place. ``active`` (B,) bool: a False row
    keeps its state and gets y 0. Returns y (B, T, H, D) f32."""
    r, k, v, w, u = _steps(r, k, v, w, u)
    S = state.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # key_i ⊗ val_j
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u[None, :, :, None] * kv))
        S = S * w[:, t, :, :, None] + kv
    return _rec_done(state, S, torch.stack(ys, dim=1), active)


def gla_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              state: torch.Tensor, scale: float,
              active: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``ops/wkv.py::gla``: the JAX ``gla`` step
    (``superllama_tpu/models/rwkv.py:78``), the state updated before the
    read-out y = scale·r·S, no bonus; layouts as ``wkv6_plain``."""
    r, k, v, w = _steps(r, k, v, w)
    S = state.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        S = S * w[:, t, :, :, None] + k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t] * scale, S))
    return _rec_done(state, S, torch.stack(ys, dim=1), active)


def wkv7_plain(r: torch.Tensor, w: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               a: torch.Tensor, b: torch.Tensor, state: torch.Tensor,
               active: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``ops/wkv.py::wkv7``: the JAX ``wkv7`` step
    (``superllama_tpu/models/rwkv.py:58``) looped over T in f32. All of r /
    w / k / v / a / b (B, T, H, D); state (B, H, D, D) [i=val, j=key]."""
    r, w, k, v, a, b = _steps(r, w, k, v, a, b)
    S = state.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        sa = torch.einsum("bhj,bhij->bhi", a[:, t], S)
        S = (S * w[:, t, :, None, :] + v[:, t, :, :, None] * k[:, t, :, None, :]
             + sa[..., None] * b[:, t, :, None, :])
        ys.append(torch.einsum("bhij,bhj->bhi", S, r[:, t]))
    return _rec_done(state, S, torch.stack(ys, dim=1), active)


def l2norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x / max(‖x‖, eps) over the last axis (qwen3next.py's ``_l2norm``)."""
    n = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def delta_inputs(q: torch.Tensor, k: torch.Tensor, beta: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gated delta rule's step inputs as the JAX ``delta_net`` makes them
    (``superllama_tpu/models/qwen3next.py:46-48``): q and k l2-normalised in
    f32, q scaled by 1/√D, σ(β)."""
    D = q.shape[-1]
    return (l2norm(q.to(torch.float32), eps) / (D ** 0.5), l2norm(k.to(torch.float32), eps),
            torch.sigmoid(beta.to(torch.float32)))


def delta_net_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    beta: torch.Tensor, state: torch.Tensor, eps: float,
                    active: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``ops/wkv.py::delta_net``: the JAX ``delta_net``
    (``superllama_tpu/models/qwen3next.py:41``) looped over T in f32. q / k
    / v (B, T, H, D), g (log-decay) and beta (pre-sigmoid) (B, T, H); state
    (B, H, D, D) [i=key, j=val] in its cache type (f32 or bf16), updated in
    place."""
    q, k, b = delta_inputs(q, k, beta, eps)
    v, g = _steps(v, g)
    S = state.to(torch.float32)
    ys = []
    for t in range(q.shape[1]):
        S = S * torch.exp(g[:, t])[..., None, None]
        kv = torch.einsum("bhi,bhij->bhj", k[:, t], S)
        delta = (v[:, t] - kv) * b[:, t][..., None]
        S = S + k[:, t, :, :, None] * delta[:, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", q[:, t], S))
    return _rec_done(state, S, torch.stack(ys, dim=1), active)
