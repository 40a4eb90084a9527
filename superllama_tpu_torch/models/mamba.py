"""Mamba (selective state-space) mixers and forward pass.

Counterpart of the JAX package's ``models/mamba.py`` (src/models/mamba.cpp,
graph-context-mamba.cpp): per layer a gated in-projection, a depthwise
causal conv over time, the data-dependent (dt, B, C) selection, the
exp(dt·A) state recurrence, the skip D, the silu gate and the
out-projection. Three mixers:

 - ``_mamba_mixer`` (Mamba-1): x | z in-projection, the conv over x, the
   selection through ``ssm_x`` and ``ssm_dt``; jamba's RMS norms on the
   dt / B / C streams, or falcon-mamba's non-parametric ones
   (``ssm_dt_b_c_rms``); A (d_inner, d_state);
 - ``_mamba2_mixer`` (Mamba-2): one [z | xBC | dt] in-projection, the conv
   over [x, B, C], a scalar decay per head, B / C in G groups (head h reads
   group h // (n_head / G)), the grouped output RMS norm;
 - ``plamo2_mixer``: per-head-interleaved z | x, the conv over x (no bias),
   [B | C | dt] from ``ssm_x``, each RMS-normed, dt projected per head, one
   B / C group.

The recurrence runs in ``ops/ssm_scan.py`` (the hand-written CUDA kernel on
the card, the plain loop on the CPU); the depthwise conv (d_conv
multiply-adds a channel) and the norms stay plain torch, the projections go
through ``mm`` (qmv / qmm on packed weights). ``ssm_a`` is stored already as
A = -exp(A_log), the ecosystem's convention.

State: each mixer takes its layer's conv state (B, d_conv - 1, conv_dim)
and SSM state (B, d_inner, d_state), views into the cache in its type
(kv_dtype), and writes both in place; the recurrence runs in f32. Rows whose
``active`` flag is False keep both states (the JAX engine's ``mask_rows``
after the step; the cache here is written in place, so the step keeps them
itself). The forwards pass active = pos[:, 0] >= 0, a device tensor, so no
step reads the host and a step is captured in a CUDA graph like any other.
"""

from __future__ import annotations

import torch

from ..ops import ref as ops
from ..ops.ssm_scan import ssm_scan
from ..runtime.recurrent import RecurrentCache
from .hparams import HParams
from .llama import mm


def _conv(layer: dict, xs: torch.Tensor, conv_state: torch.Tensor,
          active: torch.Tensor | None, bias: bool = True) -> torch.Tensor:
    """The depthwise causal conv over time of xs (B, T, C): the state
    carries the last d_conv - 1 inputs, written back in place (kept on
    inactive rows); returns silu(conv (+ its bias))."""
    T = xs.shape[1]
    seq = torch.cat([conv_state.to(xs.dtype), xs], dim=1)        # (B, dc - 1 + T, C)
    w = layer["ssm_conv1d"]                                       # (dc, C)
    y = sum(seq[:, j:j + T] * w[j] for j in range(w.shape[0]))
    if bias and "ssm_conv1d_b" in layer:
        y = y + layer["ssm_conv1d_b"]
    _store(conv_state, seq[:, T:], active)
    return ops.silu(y)


def _store(dst: torch.Tensor, new: torch.Tensor, active: torch.Tensor | None) -> None:
    new = new.to(dst.dtype)
    if active is not None:
        new = torch.where(active.reshape(-1, *(1,) * (dst.ndim - 1)), new, dst)
    dst.copy_(new)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log1p(exp(-|v|)) + max(v, 0), f32."""
    return torch.log1p(torch.exp(-torch.abs(v))) + torch.clamp(v, min=0)


def _mamba_mixer(layer: dict, hp: HParams, x_in: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """One Mamba-1 mixer over (B, T, E); returns y (B, T, E)."""
    B, T, _ = x_in.shape
    di, ds, rank = hp.ssm_d_inner, hp.ssm_d_state, hp.ssm_dt_rank
    xz = mm(x_in, layer["ssm_in"])                       # (B, T, 2·di)
    x, z = xz[..., :di], xz[..., di:]
    x = _conv(layer, x, conv_state, active)

    sel = mm(x, layer["ssm_x"])                          # (B, T, rank + 2·ds)
    dt = sel[..., :rank]
    Bm = sel[..., rank:rank + ds].to(torch.float32)
    Cm = sel[..., rank + ds:].to(torch.float32)
    if "ssm_dt_norm" in layer:          # jamba: RMS-normed dt / B / C streams
        dt = ops.rms_norm(dt, layer["ssm_dt_norm"], hp.rms_eps)
        Bm = ops.rms_norm(Bm, layer["ssm_b_norm"], hp.rms_eps)
        Cm = ops.rms_norm(Cm, layer["ssm_c_norm"], hp.rms_eps)
    elif hp.extra.get("ssm_dt_b_c_rms"):     # falcon-mamba: non-parametric
        dt = ops.rms_norm(dt, None, hp.rms_eps)
        Bm = ops.rms_norm(Bm, None, hp.rms_eps)
        Cm = ops.rms_norm(Cm, None, hp.rms_eps)
    dt = _softplus((mm(dt, layer["ssm_dt"]) + layer["ssm_dt_b"]).to(torch.float32))

    xf = x.to(torch.float32)
    ys = ssm_scan(ssm_state.view(B, di, 1, ds), xf[..., None], dt,
                  layer["ssm_a"].to(torch.float32), Bm[:, :, None, :], Cm[:, :, None, :],
                  active)[..., 0]                        # (B, T, di)
    y = ys + xf * layer["ssm_d"].to(torch.float32).reshape(di)
    y = y.to(x.dtype) * ops.silu(z)
    return mm(y, layer["ssm_out"])


def _mamba2_mixer(layer: dict, hp: HParams, x_in: torch.Tensor, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """One Mamba-2 mixer over (B, T, E) (build_mamba2_layer); the flat
    (B, d_inner, d_state) state is (B, n_head, head_dim, d_state)."""
    B, T, _ = x_in.shape
    di, ds = hp.ssm_d_inner, hp.ssm_d_state
    nh, G = hp.ssm_dt_rank, hp.ssm_n_group
    hd = di // nh
    conv_dim = di + 2 * G * ds
    zxbcdt = mm(x_in, layer["ssm_in"])                   # (B, T, 2·di + 2·G·ds + nh)
    z = zxbcdt[..., :di]
    xBC = _conv(layer, zxbcdt[..., di:di + conv_dim], conv_state, active)
    dt = zxbcdt[..., di + conv_dim:]

    x = xBC[..., :di].to(torch.float32).reshape(B, T, nh, hd)
    Bm = xBC[..., di:di + G * ds].to(torch.float32).reshape(B, T, G, ds)
    Cm = xBC[..., di + G * ds:].to(torch.float32).reshape(B, T, G, ds)
    dt = _softplus(dt.to(torch.float32) + layer["ssm_dt_b"].to(torch.float32))
    A = layer["ssm_a"].to(torch.float32).reshape(nh)

    y = ssm_scan(ssm_state.view(B, nh, hd, ds), x, dt, A, Bm, Cm, active)
    y = y + x * layer["ssm_d"].to(torch.float32).reshape(nh, 1)
    y = y.reshape(B, T, di) * ops.silu(z.to(torch.float32))
    if "ssm_norm" in layer:             # grouped RMS norm, d_inner / G a group
        y = ops.rms_norm(y.reshape(B, T, G, di // G),
                         layer["ssm_norm"].reshape(G, di // G), hp.rms_eps).reshape(B, T, di)
    return mm(y.to(x_in.dtype), layer["ssm_out"])


def plamo2_mixer(layer: dict, hp: HParams, x_in: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """PLaMo-2's mamba layer (build_plamo2_mamba_layer): z | x interleaved a
    head, the conv over x without a bias, [B | C | dt] RMS-normed, dt
    projected a head (+ bias), one B / C group, no output norm."""
    B, T, E = x_in.shape
    di, ds, nh = hp.ssm_d_inner, hp.ssm_d_state, hp.ssm_dt_rank
    hd = di // nh
    zx = mm(x_in, layer["ssm_in"]).reshape(B, T, nh, 2 * hd)
    z = zx[..., :hd].reshape(B, T, di)
    x = _conv(layer, zx[..., hd:].reshape(B, T, di), conv_state, active, bias=False)

    bcdt = mm(x, layer["ssm_x"])                         # (B, T, 2·ds + dt_dim)
    Bm = ops.rms_norm(bcdt[..., :ds], layer["ssm_b_norm"], hp.rms_eps)
    Cm = ops.rms_norm(bcdt[..., ds:2 * ds], layer["ssm_c_norm"], hp.rms_eps)
    dt = ops.rms_norm(bcdt[..., 2 * ds:], layer["ssm_dt_norm"], hp.rms_eps)
    dt = _softplus((mm(dt, layer["ssm_dt"]) + layer["ssm_dt_b"]).to(torch.float32))
    A = layer["ssm_a"].to(torch.float32).reshape(nh)

    xh = x.to(torch.float32).reshape(B, T, nh, hd)
    y = ssm_scan(ssm_state.view(B, nh, hd, ds), xh, dt, A,
                 Bm.to(torch.float32)[:, :, None, :], Cm.to(torch.float32)[:, :, None, :],
                 active)
    y = y + xh * layer["ssm_d"].to(torch.float32).reshape(nh, 1)
    y = ops.silu(z.to(torch.float32)) * y.reshape(B, T, di)
    return mm(y.to(x_in.dtype), layer["ssm_out"])


def mamba_mixer(layer: dict, hp: HParams, x_in: torch.Tensor, conv_state: torch.Tensor,
                ssm_state: torch.Tensor, active: torch.Tensor | None = None) -> torch.Tensor:
    """The version by the hparams: ssm_n_group > 0 selects Mamba-2."""
    mixer = _mamba2_mixer if hp.ssm_n_group > 0 else _mamba_mixer
    return mixer(layer, hp, x_in, conv_state, ssm_state, active)


def row_active(pos: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch,) bool: the rows whose first position is valid (a (1, T) pos
    covers every row)."""
    return (pos[:, 0] >= 0).expand(batch)


def head(params: dict, hp: HParams, x: torch.Tensor) -> torch.Tensor:
    """The output norm and head (tied to the embedding without ``output``)."""
    x = ops.rms_norm(x, params["output_norm"], hp.rms_eps)
    w_out = params.get("output")
    return mm(x, w_out) if w_out is not None else x @ params["token_embd"].T


def mamba_forward(params: dict, hp: HParams, tokens: torch.Tensor, pos: torch.Tensor,
                  cache: RecurrentCache, flash: bool | None = None,
                  s_window: int | None = None) -> tuple[torch.Tensor, RecurrentCache]:
    """One step over (B, T) tokens of a pure mamba / mamba2 model; returns
    (logits, cache), the cache updated in place. The state has no
    positions: ``pos`` only marks the idle rows (pos[:, 0] < 0), which keep
    their state. ``flash`` and ``s_window`` are accepted and ignored."""
    B = tokens.shape[0]
    active = row_active(pos, B)
    x = params["token_embd"][tokens.to(torch.int64)]
    for il, layer in enumerate(params["layers"]):
        h = ops.rms_norm(x, layer["attn_norm"], hp.rms_eps)
        x = x + mamba_mixer(layer, hp, h, cache.conv[il], cache.ssm[il], active)
    return head(params, hp, x), cache
