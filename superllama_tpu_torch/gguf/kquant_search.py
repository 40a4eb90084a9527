"""Weighted K-quant encoders: per-block scale/min search, plain + imatrix.

The reference's K-quant encoders are not one-shot min/max rounds — each
16/32-element group runs a weighted RMSE search over candidate scales
(ggml-quants.c: make_qkx2_quants:622 for scale+min formats, make_qx_quants:451
for symmetric formats), and the imatrix variants re-weight the error by
importance×sqrt(sigma²+x²) and re-derive the superblock scales with an
iterative non-negative fit (make_qkx3_quants:816, make_qp_quants:899, wired
per-type at src/llama-quant.cpp:431-457).

This module re-implements those searches VECTORIZED over every group of the
tensor at once (numpy, float32): the candidate-grid loops and the
coordinate-descent refinements run as short python loops over 9–37
candidates / 16–32 lanes while the block axis (~10⁵–10⁶ groups for an LLM
matrix) rides as one array op.  Inner reductions accumulate sequentially in
float32 (a python loop over the 16/32 group lanes) so results are
bit-reproducible against the native C++ encoder in native/quants.cpp, which
follows the same operation order.

Entry points: quant_q{2,3,4,5,6}_k_search(x, qw=None) → packed wire bytes
(same layouts as gguf/quants.py's decoders, which are oracle-bit-exact).
``qw`` is the per-column imatrix importance row (as in llama.cpp's
--imatrix), broadcast over the tensor's rows by the caller.
"""

from __future__ import annotations

import numpy as np

from .quants import (
    _pack_scale_min_k4,
    _q3k_pack_scales,
    _to_f16_bytes,
)

F32 = np.float32
GROUP_MAX_EPS = F32(1e-15)


def _f16_round(x: np.ndarray) -> np.ndarray:
    """f32 → f16 → f32 (the GGML_FP32_TO_FP16/FP16_TO_FP32 round-trip)."""
    return x.astype(np.float16).astype(F32)


def _seqsum(t: np.ndarray) -> np.ndarray:
    """Sequential f32 sum over the last axis (C accumulation order — numpy's
    pairwise np.sum would diverge in the last ulp and flip search decisions
    vs the native encoder)."""
    acc = np.zeros(t.shape[:-1], F32)
    for i in range(t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def _rint(x: np.ndarray) -> np.ndarray:
    """ggml nearest_int: round half to even."""
    return np.rint(x).astype(np.int32)


# --------------------------------------------------------------------------
# search primitives (each vectorized over a leading block axis B)
# --------------------------------------------------------------------------

def qkx_search(x: np.ndarray, weights: np.ndarray, nmax: int, rmin: float,
               rdelta: float, nstep: int, use_mad: bool
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scale+min grid search (make_qkx2/qkx3 semantics).

    x, weights: (B, n) f32 → (scale (B,), the_min (B,), L (B, n) int32).
    Candidate inverse scales sweep (rmin + rdelta·step + nmax)/(max−min);
    each candidate gets a weighted least-squares (scale, min) refit with
    min clamped ≤ 0, and wins only if its weighted error (MAD or MSE)
    beats the incumbent — against the incumbent's *updated* min, exactly
    like the reference's running-state loop."""
    x = np.ascontiguousarray(x, F32)
    w = np.ascontiguousarray(weights, F32)
    B, n = x.shape
    nmaxf = F32(nmax)
    xmin = np.minimum(x.min(axis=1), F32(0.0))
    xmax = x.max(axis=1)
    sum_w = _seqsum(w)
    sum_x = _seqsum(w * x)
    degen = xmax <= xmin                      # constant (or all-0) group
    rng = np.where(degen, F32(1.0), xmax - xmin).astype(F32)

    iscale = nmaxf / rng
    scale = F32(1.0) / iscale
    cur_min = xmin.copy()
    L = np.clip(_rint(iscale[:, None] * (x - xmin[:, None])), 0, nmax)
    diff = scale[:, None] * L.astype(F32) + cur_min[:, None] - x
    err = np.abs(diff) if use_mad else diff * diff
    best = _seqsum(w * err)

    for step in range(nstep + 1):
        isc = (F32(rmin + rdelta * step) + nmaxf) / rng
        l = np.clip(_rint(isc[:, None] * (x - cur_min[:, None])), 0, nmax)
        lf = l.astype(F32)
        sum_l = _seqsum(w * lf)
        sum_l2 = _seqsum(w * lf * lf)
        sum_xl = _seqsum(w * lf * x)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = (sum_w * sum_xl - sum_x * sum_l) / D
            this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D
            alt_scale = sum_xl / sum_l2
        pos = this_min > 0
        this_min = np.where(pos, F32(0.0), this_min)
        this_scale = np.where(pos, alt_scale, this_scale)
        diff = this_scale[:, None] * lf + this_min[:, None] - x
        err = np.abs(diff) if use_mad else diff * diff
        cur = _seqsum(w * err)
        upd = (D > 0) & (cur < best)
        L = np.where(upd[:, None], l, L)
        best = np.where(upd, cur, best)
        scale = np.where(upd, this_scale, scale)
        cur_min = np.where(upd, this_min, cur_min)

    scale = np.where(degen, F32(0.0), scale)
    L = np.where(degen[:, None], 0, L)
    the_min = np.where(degen, -xmin, -cur_min)
    return scale.astype(F32), the_min.astype(F32), L


def qx_search(x: np.ndarray, qw: np.ndarray | None, nmax: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric weighted scale search (make_qx_quants, rmse_type=1).

    → (scale (B,), L (B, n) int32 BIASED by +nmax; all-zero groups return
    scale 0 with raw L=0, matching the reference's early-out)."""
    x = np.ascontiguousarray(x, F32)
    B, n = x.shape
    absx = np.abs(x)
    amax = absx.max(axis=1)
    idx = absx.argmax(axis=1)                 # first max, like the C scan
    maxv = x[np.arange(B), idx]
    zero = amax < GROUP_MAX_EPS
    safe_max = np.where(zero, F32(1.0), maxv)
    w = (x * x if qw is None else np.ascontiguousarray(qw, F32))

    def sums(l):
        lf = l.astype(F32)
        return _seqsum(w * x * lf), _seqsum(w * lf * lf)

    iscale = -F32(nmax) / safe_max
    L = np.clip(_rint(iscale[:, None] * x), -nmax, nmax - 1)
    sumlx, suml2 = sums(L)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(suml2 != 0, sumlx / suml2, F32(0.0)).astype(F32)
    best = scale * sumlx
    for step in range(-9, 10):
        if step == 0:
            continue
        isc = -(F32(nmax) + F32(0.1) * F32(step)) / safe_max
        l = np.clip(_rint(isc[:, None] * x), -nmax, nmax - 1)
        slx, sl2 = sums(l)
        upd = (sl2 > 0) & (slx * slx > best * sl2)
        L = np.where(upd[:, None], l, L)
        with np.errstate(divide="ignore", invalid="ignore"):
            new_scale = slx / sl2
        scale = np.where(upd, new_scale, scale).astype(F32)
        best = np.where(upd, scale * slx, best)

    Lout = np.where(zero[:, None], 0, L + nmax)
    scale = np.where(zero, F32(0.0), scale)
    return scale.astype(F32), Lout


def qp_search(x: np.ndarray, sw: np.ndarray, nmax: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Non-negative weighted fit with coordinate descent (make_qp_quants):
    used for the 6-bit superblock scale/min planes of the imatrix variants.
    → (scale (B,), L (B, n) int32 in [0, nmax])."""
    x = np.ascontiguousarray(x, F32)
    sw = np.ascontiguousarray(sw, F32)
    B, n = x.shape
    maxv = x.max(axis=1)
    zero = maxv < GROUP_MAX_EPS
    safe_max = np.where(zero, F32(1.0), maxv)

    iscale = F32(nmax) / safe_max
    scale = F32(1.0) / iscale
    L = _rint(iscale[:, None] * x)
    diff = x - scale[:, None] * L.astype(F32)
    best_mse = _seqsum(sw * diff * diff)
    for step in range(-4, 5):
        if step == 0:
            continue
        isc = (F32(0.1) * F32(step) + F32(nmax)) / safe_max
        sc = F32(1.0) / isc
        l = np.minimum(_rint(isc[:, None] * x), nmax)
        diff = x - sc[:, None] * l.astype(F32)
        mse = _seqsum(sw * diff * diff)
        upd = mse < best_mse
        best_mse = np.where(upd, mse, best_mse)
        iscale = np.where(upd, isc, iscale)

    L = np.minimum(_rint(iscale[:, None] * x), nmax)
    lf = L.astype(F32)
    sumlx = _seqsum(sw * x * lf)
    suml2 = _seqsum(sw * lf * lf)
    for _ in range(5):
        for i in range(n):
            w = sw[:, i]
            xi = x[:, i]
            li = L[:, i].astype(F32)
            slx = sumlx - w * xi * li
            sl2 = suml2 - w * li * li
            ok = (slx > 0) & (sl2 > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                cand = _rint(xi * sl2 / np.where(ok, slx, F32(1.0)))
            new_l = np.minimum(cand, nmax)
            changed = ok & (new_l != L[:, i])
            nf = new_l.astype(F32)
            slx2 = slx + w * xi * nf
            sl22 = sl2 + w * nf * nf
            accept = changed & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(accept, new_l, L[:, i])
            sumlx = np.where(accept, slx2, sumlx)
            suml2 = np.where(accept, sl22, suml2)

    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(suml2 > 0, sumlx / suml2, F32(0.0)).astype(F32)
    scale = np.where(zero, F32(0.0), scale)
    L = np.where(zero[:, None], 0, L)
    return scale, L


def q3_search(x: np.ndarray, nmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric x²-weighted fit with coordinate descent (make_q3_quants
    do_rmse=true): the Q3_K ref per-group encoder.
    → (scale (B,), L (B, n) int32 biased by +nmax; zero groups L=0 raw)."""
    x = np.ascontiguousarray(x, F32)
    B, n = x.shape
    absx = np.abs(x)
    amax = absx.max(axis=1)
    idx = absx.argmax(axis=1)
    maxv = x[np.arange(B), idx]
    zero = amax < GROUP_MAX_EPS
    safe_max = np.where(zero, F32(1.0), maxv)
    w = x * x

    iscale = -F32(nmax) / safe_max
    L = np.clip(_rint(iscale[:, None] * x), -nmax, nmax - 1)
    lf = L.astype(F32)
    sumlx = _seqsum(w * x * lf)
    suml2 = _seqsum(w * lf * lf)
    for _ in range(5):
        for i in range(n):
            wi = w[:, i]
            xi = x[:, i]
            li = L[:, i].astype(F32)
            slx = sumlx - wi * xi * li
            ok = slx > 0
            sl2 = suml2 - wi * li * li
            with np.errstate(divide="ignore", invalid="ignore"):
                cand = _rint(xi * sl2 / np.where(ok, slx, F32(1.0)))
            new_l = np.clip(cand, -nmax, nmax - 1)
            changed = ok & (new_l != L[:, i])
            nf = new_l.astype(F32)
            slx2 = slx + wi * xi * nf
            sl22 = sl2 + wi * nf * nf
            accept = changed & (sl22 > 0) & (
                slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(accept, new_l, L[:, i])
            sumlx = np.where(accept, slx2, sumlx)
            suml2 = np.where(accept, sl22, suml2)

    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(suml2 > 0, sumlx / suml2, F32(0.0)).astype(F32)
    Lout = np.where(zero[:, None], 0, L + nmax)
    scale = np.where(zero, F32(0.0), scale)
    return scale, Lout


# --------------------------------------------------------------------------
# shared bits
# --------------------------------------------------------------------------

def _group_weights(g: np.ndarray, qw: np.ndarray | None, sigma_mult: float
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Per-group error weights + per-superblock sigma² (impl-variant rules).

    g: (nb, groups, n). Plain: weights = av_x + |x| (av_x per group for the
    32-wide formats; callers override for the 16-wide ones). Imatrix:
    weights = qw·sqrt(sigma² + x²) with sigma² = sigma_mult·Σx²/256."""
    nb, ngrp, n = g.shape
    flat = g.reshape(nb, ngrp * n)
    sumx2 = _seqsum(flat * flat)
    sigma2 = (F32(sigma_mult) * sumx2 / F32(ngrp * n)).astype(F32)
    if qw is None:
        return None, sigma2
    qwg = _qw_per_block(qw, nb).reshape(nb, ngrp, n)
    w = qwg * np.sqrt(sigma2[:, None, None] + g * g)
    return w.astype(F32), sigma2


def _qw_per_block(qw: np.ndarray, nb: int) -> np.ndarray:
    """imatrix row (n_per_row floats, i.e. k·256) → per-superblock weights
    (nb, 256): block b of the flattened tensor is superblock b mod k of its
    row (quant_weights + QK_K*i indexing in the reference impls)."""
    qb = np.ascontiguousarray(qw, F32).reshape(-1, 256)
    assert nb % qb.shape[0] == 0, (nb, qb.shape)
    return np.tile(qb, (nb // qb.shape[0], 1))


def _requant_minmax(g: np.ndarray, d16: np.ndarray, m16: np.ndarray,
                    sc: np.ndarray, mn: np.ndarray, nmax: int,
                    L: np.ndarray) -> np.ndarray:
    """Final requantization against the f16-rounded, integer-coded scales:
    L = clip(rint((x + dmin·mn)/(d·sc)), 0, nmax) where d·sc ≠ 0."""
    dl = d16[:, None] * sc.astype(F32)               # (nb, groups)
    ml = m16[:, None] * mn.astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = _rint((g + ml[:, :, None]) / dl[:, :, None])
    q = np.clip(q, 0, nmax)
    return np.where((dl != 0)[:, :, None], q, L)


# --------------------------------------------------------------------------
# format encoders
# --------------------------------------------------------------------------

def quant_q4_k_search(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Q4_K weighted-search encoder (quantize_row_q4_K_ref / _impl)."""
    v = np.ascontiguousarray(x, F32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 8, 32)
    if qw is None:
        sumx2 = _seqsum(g * g)                        # (nb, 8)
        av = np.sqrt(sumx2 / F32(32.0))
        w = av[:, :, None] + np.abs(g)
        scale, mins, L = qkx_search(g.reshape(-1, 32), w.reshape(-1, 32),
                                    15, -1.0, 0.1, 20, False)
        scale = scale.reshape(nb, 8)
        mins = mins.reshape(nb, 8)
        L = L.reshape(nb, 8, 32)
        max_scale = scale.max(axis=1)
        max_min = mins.max(axis=1)
        inv_scale = np.where(max_scale > 0, F32(63.0) / max_scale, F32(0.0))
        inv_min = np.where(max_min > 0, F32(63.0) / max_min, F32(0.0))
        ls = np.minimum(_rint(inv_scale[:, None] * scale) & 0xFF, 63).astype(np.uint8)
        lm = np.minimum(_rint(inv_min[:, None] * mins) & 0xFF, 63).astype(np.uint8)
        d = (max_scale / F32(63.0)).astype(F32)
        dmin = (max_min / F32(63.0)).astype(F32)
    else:
        w, sigma2 = _group_weights(g, qw, 2.0)
        sw = _seqsum(w).reshape(nb, 8)
        scale, mins, L = qkx_search(g.reshape(-1, 32), w.reshape(-1, 32),
                                    15, -0.9, 0.05, 36, False)
        scale = scale.reshape(nb, 8)
        mins = mins.reshape(nb, 8)
        L = L.reshape(nb, 8, 32)
        d, Ls = qp_search(scale, sw, 63)
        dmin, Lm = qp_search(mins, sw, 63)
        ls = Ls.astype(np.uint8)
        lm = Lm.astype(np.uint8)
    d16 = _f16_round(d)
    m16 = _f16_round(dmin)
    q = _requant_minmax(g, d16, m16, ls, lm, 15, L).astype(np.uint8)
    qs = np.empty((nb, 128), np.uint8)
    for j in range(4):
        qs[:, j * 32:(j + 1) * 32] = q[:, 2 * j] | (q[:, 2 * j + 1] << 4)
    return np.concatenate(
        [_to_f16_bytes(d).reshape(-1, 2), _to_f16_bytes(dmin).reshape(-1, 2),
         _pack_scale_min_k4(ls, lm), qs], axis=1).reshape(-1)


def quant_q5_k_search(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Q5_K weighted-search encoder (quantize_row_q5_K_ref / _impl)."""
    v = np.ascontiguousarray(x, F32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 8, 32)
    if qw is None:
        sumx2 = _seqsum(g * g)
        av = np.sqrt(sumx2 / F32(32.0))
        w = av[:, :, None] + np.abs(g)
        scale, mins, L = qkx_search(g.reshape(-1, 32), w.reshape(-1, 32),
                                    31, -0.5, 0.1, 15, False)
        scale = scale.reshape(nb, 8)
        mins = mins.reshape(nb, 8)
        L = L.reshape(nb, 8, 32)
        max_scale = scale.max(axis=1)
        max_min = mins.max(axis=1)
        inv_scale = np.where(max_scale > 0, F32(63.0) / max_scale, F32(0.0))
        inv_min = np.where(max_min > 0, F32(63.0) / max_min, F32(0.0))
        ls = np.minimum(_rint(inv_scale[:, None] * scale) & 0xFF, 63).astype(np.uint8)
        lm = np.minimum(_rint(inv_min[:, None] * mins) & 0xFF, 63).astype(np.uint8)
        d = (max_scale / F32(63.0)).astype(F32)
        dmin = (max_min / F32(63.0)).astype(F32)
    else:
        w, _ = _group_weights(g, qw, 2.0)
        sw = _seqsum(w).reshape(nb, 8)
        scale, mins, L = qkx_search(g.reshape(-1, 32), w.reshape(-1, 32),
                                    31, -0.9, 0.05, 36, False)
        scale = scale.reshape(nb, 8)
        mins = mins.reshape(nb, 8)
        L = L.reshape(nb, 8, 32)
        d, Ls = qp_search(scale, sw, 63)
        dmin, Lm = qp_search(mins, sw, 63)
        ls = Ls.astype(np.uint8)
        lm = Lm.astype(np.uint8)
    d16 = _f16_round(d)
    m16 = _f16_round(dmin)
    q = _requant_minmax(g, d16, m16, ls, lm, 31, L).astype(np.uint8)
    ql = np.empty((nb, 128), np.uint8)
    qh = np.zeros((nb, 32), np.uint8)
    for j in range(4):
        q1, q2 = q[:, 2 * j], q[:, 2 * j + 1]
        ql[:, j * 32:(j + 1) * 32] = (q1 & 0x0F) | ((q2 & 0x0F) << 4)
        qh |= np.where(q1 & 16, 1 << (2 * j), 0).astype(np.uint8)
        qh |= np.where(q2 & 16, 2 << (2 * j), 0).astype(np.uint8)
    return np.concatenate(
        [_to_f16_bytes(d).reshape(-1, 2), _to_f16_bytes(dmin).reshape(-1, 2),
         _pack_scale_min_k4(ls, lm), qh, ql], axis=1).reshape(-1)


def quant_q2_k_search(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Q2_K weighted-search encoder (quantize_row_q2_K_ref / _impl)."""
    v = np.ascontiguousarray(x, F32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 16, 16)
    if qw is None:
        w = np.abs(g)
        scale, mins, L = qkx_search(g.reshape(-1, 16), w.reshape(-1, 16),
                                    3, -0.5, 0.1, 15, True)
        scale = scale.reshape(nb, 16)
        mins = mins.reshape(nb, 16)
        L = L.reshape(nb, 16, 16)
        max_scale = scale.max(axis=1)
        max_min = mins.max(axis=1)
        d = np.where(max_scale > 0, max_scale / F32(15.0), F32(0.0)).astype(F32)
        dmin = np.where(max_min > 0, max_min / F32(15.0), F32(0.0)).astype(F32)
        inv_scale = np.where(max_scale > 0, F32(15.0) / max_scale, F32(0.0))
        inv_min = np.where(max_min > 0, F32(15.0) / max_min, F32(0.0))
        ls = (_rint(inv_scale[:, None] * scale) & 0xFF).astype(np.uint8)
        lm = (_rint(inv_min[:, None] * mins) & 0xFF).astype(np.uint8)
        ls = np.where(max_scale[:, None] > 0, ls, 0).astype(np.uint8)
        lm = np.where(max_min[:, None] > 0, lm, 0).astype(np.uint8)
    else:
        w, _ = _group_weights(g, qw, 1.0)
        sw = _seqsum(w).reshape(nb, 16)
        scale, mins, L = qkx_search(g.reshape(-1, 16), w.reshape(-1, 16),
                                    3, -0.9, 0.05, 36, False)
        scale = scale.reshape(nb, 16)
        mins = mins.reshape(nb, 16)
        L = L.reshape(nb, 16, 16)
        d, Ls = qp_search(scale, sw, 15)
        dmin, Lm = qp_search(mins, sw, 15)
        ls = Ls.astype(np.uint8)
        lm = Lm.astype(np.uint8)
    # C stores the FULL ls byte then ORs lm<<4 on top (a negative searched
    # scale wraps and pollutes the high nibble — emulate the wrap exactly)
    scales_b = ls | (lm << 4)
    d16 = _f16_round(d)
    m16 = _f16_round(dmin)
    q = _requant_minmax(g, d16, m16, scales_b & 0x0F, scales_b >> 4, 3,
                        L).astype(np.uint8)
    qs = np.zeros((nb, 64), np.uint8)
    is_ = 0
    for n in (0, 128):
        base = n // 4
        for shift in (0, 2, 4, 6):
            for half in (0, 16):
                qs[:, base + half:base + half + 16] |= q[:, is_] << shift
                is_ += 1
    return np.concatenate(
        [scales_b, qs, _to_f16_bytes(d).reshape(-1, 2),
         _to_f16_bytes(dmin).reshape(-1, 2)], axis=1).reshape(-1)


def quant_q3_k_search(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Q3_K weighted-search encoder (quantize_row_q3_K_ref / _impl)."""
    v = np.ascontiguousarray(x, F32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 16, 16)
    if qw is None:
        scale, L = q3_search(g.reshape(-1, 16), 4)
        scale = scale.reshape(nb, 16)
        L = L.reshape(nb, 16, 16)
        absc = np.abs(scale)
        amax = absc.max(axis=1)
        idx = absc.argmax(axis=1)
        max_scale = scale[np.arange(nb), idx]
        nonzero = max_scale != 0
        safe = np.where(nonzero, max_scale, F32(1.0))
        iscale = F32(-32.0) / safe
        ls = np.clip(_rint(iscale[:, None] * scale), -32, 31) + 32
        ls = np.where(nonzero[:, None], ls, 0)
        d = np.where(nonzero, F32(1.0) / iscale, F32(0.0)).astype(F32)
    else:
        w, _ = _group_weights(g, qw, 2.0)
        if w is None:
            w = g * g
        sw = _seqsum(w).reshape(nb, 16)
        scale, L = qx_search(g.reshape(-1, 16), w.reshape(-1, 16), 4)
        scale = scale.reshape(nb, 16)
        L = L.reshape(nb, 16, 16)
        d, Ls = qx_search(scale, sw, 32)
        ls = Ls                                      # already biased 0..63
    d16 = _f16_round(d)
    sc_dec = ls.astype(np.int32) - 32
    dl = d16[:, None] * sc_dec.astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.clip(_rint(g / dl[:, :, None]), -4, 3) + 4
    q = np.where((dl != 0)[:, :, None], q, L).astype(np.uint8)
    q = q.reshape(nb, 256)
    hm = np.zeros((nb, 32), np.uint8)
    qs = np.zeros((nb, 64), np.uint8)
    is_ = 0
    m = 1
    for n in (0, 128):
        base = n // 4
        for shift in (0, 2, 4, 6):
            for half in (0, 16):
                grp = q[:, 16 * is_:16 * is_ + 16]
                qs[:, base + half:base + half + 16] |= (grp & 3) << shift
                hm[:, half:half + 16] |= np.where(grp & 4, m, 0).astype(np.uint8)
                is_ += 1
            m <<= 1
    return np.concatenate(
        [hm, qs, _q3k_pack_scales(ls.astype(np.uint8)),
         _to_f16_bytes(d).reshape(-1, 2)], axis=1).reshape(-1)


def quant_q6_k_search(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Q6_K weighted-search encoder (quantize_row_q6_K_ref / _impl)."""
    v = np.ascontiguousarray(x, F32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 16, 16)
    qwg = (None if qw is None
           else _qw_per_block(qw, nb).reshape(-1, 16))
    scale, L = qx_search(g.reshape(-1, 16), qwg, 32)
    scale = scale.reshape(nb, 16)
    L = L.reshape(nb, 16, 16)
    absc = np.abs(scale)
    amax = absc.max(axis=1)
    idx = absc.argmax(axis=1)
    max_scale = scale[np.arange(nb), idx]
    dead = amax < GROUP_MAX_EPS
    safe = np.where(dead, F32(1.0), max_scale)
    iscale = F32(-128.0) / safe
    d = np.where(dead, F32(0.0), F32(1.0) / iscale).astype(F32)
    ls = np.minimum(_rint(iscale[:, None] * scale), 127)
    ls = np.where(dead[:, None], 0, ls)
    d16 = _f16_round(d)
    dl = d16[:, None] * ls.astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.clip(_rint(g / dl[:, :, None]), -32, 31) + 32
    q = np.where((dl != 0)[:, :, None], q, L)
    q = np.where(dead[:, None, None], 0, q).astype(np.uint8).reshape(nb, 256)
    ls8 = (ls & 0xFF).astype(np.uint8)
    ls8 = np.where(dead[:, None], 0, ls8).astype(np.uint8)
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    for n in (0, 128):
        q1 = q[:, n + 0:n + 32]
        q2 = q[:, n + 32:n + 64]
        q3 = q[:, n + 64:n + 96]
        q4 = q[:, n + 96:n + 128]
        ql[:, n // 2:n // 2 + 32] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
        ql[:, n // 2 + 32:n // 2 + 64] = (q2 & 0x0F) | ((q4 & 0x0F) << 4)
        qh[:, n // 4:n // 4 + 32] = ((q1 >> 4) | ((q2 >> 4) << 2)
                                     | ((q3 >> 4) << 4) | ((q4 >> 4) << 6))
    dz = np.where(dead, F32(0.0), d)
    return np.concatenate(
        [ql, qh, ls8, _to_f16_bytes(dz).reshape(-1, 2)], axis=1).reshape(-1)


SEARCH_QUANTIZERS = {
    "Q2_K": quant_q2_k_search,
    "Q3_K": quant_q3_k_search,
    "Q4_K": quant_q4_k_search,
    "Q5_K": quant_q5_k_search,
    "Q6_K": quant_q6_k_search,
}
