"""KV cache (f32 / bf16, Q8_0 or Q4_0) with positional masking.

Counterpart of the JAX package's ``runtime/kv_cache.py``: a fixed-shape ring
of (k, v, pos) tensors; causal masking derives from the stored per-slot
positions, so mixed prefill/decode batches need no host bookkeeping.
Quantized caches hold codes in k/v and f32 scales beside them: Q8_0 int8
codes with one scale per (layer, row, head, slot); Q4_0 nibble-packed uint8
codes (byte j holds element 2j in the low nibble, 2j+1 in the high one) with
one scale per 32-group. Codes and scales are bit-equal to the JAX package's.

Unlike the JAX cache, which is a functional pytree donated to each jitted
step, this one is updated IN PLACE: ``kv_update_layer``, ``kv_advance`` and
``kv_truncate_rows`` write into the cache's tensors and return the same
object. Each tensor carries one spare slot at index ``max_seq``: writes whose
slot falls outside the cache are routed there (JAX drops out-of-bounds
scatter writes; torch indexing would fault), and readers only ever see slots
``[0, max_seq)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.ref import apply_rope, quant_scale


@dataclass
class KVCache:
    k: torch.Tensor        # (n_layer, B, H_kv, S + 1, D)
    v: torch.Tensor        # (n_layer, B, H_kv, S + 1, Dv)
    pos: torch.Tensor      # (B, S + 1) int32; -1 = empty slot
    cursor: torch.Tensor   # (B,) int32 next write slot
    # Q8_0: (n_layer, B, H_kv, S + 1); Q4_0: (n_layer, B, H_kv, S + 1, D / 32)
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def max_seq(self) -> int:
        return self.k.shape[3] - 1

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def q4(self) -> bool:
        """Q4_0 nibble-packed codes (per-32-group scales carry a trailing
        dim that Q8_0's per-row scales lack)."""
        return self.k_scale is not None and self.k_scale.ndim == self.k.ndim

    def positions(self, n: int | None = None) -> torch.Tensor:
        """(B, n) slot positions of the first n slots (all by default)."""
        return self.pos[:, : (n or self.max_seq)]

    def layer(self, il: int, n: int | None = None):
        """(k, v, k_scale, v_scale) views of layer il over the first n slots:
        k (B, H_kv, n, D) (Q4_0: D / 2 bytes); the scales are None for a
        float cache."""
        n = n or self.max_seq
        ks = vs = None
        if self.quantized:
            ks, vs = self.k_scale[il][:, :, :n], self.v_scale[il][:, :, :n]
        return self.k[il][:, :, :n], self.v[il][:, :, :n], ks, vs


def kv_cache_init(n_layer: int, batch: int, max_seq: int, n_head_kv: int,
                  head_dim: int, head_dim_v: int | None = None,
                  dtype=torch.bfloat16, device="cpu") -> KVCache:
    """dtype: a float torch dtype, or "q8_0" (int8 codes, per-row scale) /
    "q4_0" (nibble-packed codes, per-32-group scale)."""
    head_dim_v = head_dim_v if head_dim_v is not None else head_dim
    sh = (n_layer, batch, n_head_kv, max_seq + 1)
    pos = torch.full((batch, max_seq + 1), -1, dtype=torch.int32, device=device)
    cursor = torch.zeros((batch,), dtype=torch.int32, device=device)
    f32 = torch.float32
    if dtype == "q4_0":
        if head_dim % 32 or head_dim_v % 32:
            raise ValueError("q4_0 KV needs head dims divisible by 32")
        return KVCache(
            k=torch.zeros((*sh, head_dim // 2), dtype=torch.uint8, device=device),
            v=torch.zeros((*sh, head_dim_v // 2), dtype=torch.uint8, device=device),
            pos=pos, cursor=cursor,
            k_scale=torch.zeros((*sh, head_dim // 32), dtype=f32, device=device),
            v_scale=torch.zeros((*sh, head_dim_v // 32), dtype=f32, device=device))
    if dtype == "q8_0":
        return KVCache(
            k=torch.zeros((*sh, head_dim), dtype=torch.int8, device=device),
            v=torch.zeros((*sh, head_dim_v), dtype=torch.int8, device=device),
            pos=pos, cursor=cursor,
            k_scale=torch.zeros(sh, dtype=f32, device=device),
            v_scale=torch.zeros(sh, dtype=f32, device=device))
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"KV cache type {dtype!r}: a float dtype, 'q8_0' or 'q4_0'")
    return KVCache(
        k=torch.zeros((*sh, head_dim), dtype=dtype, device=device),
        v=torch.zeros((*sh, head_dim_v), dtype=dtype, device=device),
        pos=pos, cursor=cursor)


def q8_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D) float → (int8 codes, f32 per-row scale): Q8_0 semantics,
    round half to even as in the JAX package."""
    xf = x.to(torch.float32)
    scale, inv = quant_scale(torch.amax(torch.abs(xf), dim=-1), 127.0)
    return torch.round(xf * inv[..., None]).to(torch.int8), scale


def q4_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D) float → (uint8 nibble-packed codes (..., D/2), f32
    per-32-group scales (..., D/32)): Q4_0 semantics (symmetric, amax/7,
    codes clipped to ±7 then offset by 8)."""
    D = x.shape[-1]
    xf = x.to(torch.float32).reshape(*x.shape[:-1], D // 32, 32)
    scale, inv = quant_scale(torch.amax(torch.abs(xf), dim=-1), 7.0)
    q = torch.clamp(torch.round(xf * inv[..., None]), -7, 7).to(torch.int32) + 8
    q = q.reshape(*x.shape[:-1], D)
    return (q[..., 0::2] | (q[..., 1::2] << 4)).to(torch.uint8), scale


def q4_dequant(codes: torch.Tensor, scales: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of q4_quantize_rows."""
    c = codes.to(torch.int32)
    D = codes.shape[-1] * 2
    q = torch.stack([(c & 0xF) - 8, (c >> 4) - 8], dim=-1)
    g = q.reshape(*codes.shape[:-1], D // 32, 32).to(torch.float32)
    return (g * scales[..., None]).reshape(*codes.shape[:-1], D).to(dtype)


def kv_layer(cache: KVCache, il: int, dtype=torch.float32, n: int | None = None):
    """K/V of layer il over the first n slots, dequantized when the cache is
    quantized (float caches are returned as stored)."""
    ck, cv, ks, vs = cache.layer(il, n)
    if cache.q4:
        return q4_dequant(ck, ks, dtype), q4_dequant(cv, vs, dtype)
    if cache.quantized:
        return ((ck.to(torch.float32) * ks[..., None]).to(dtype),
                (cv.to(torch.float32) * vs[..., None]).to(dtype))
    return ck, cv


def kv_write_slots(cache: KVCache, n_new: int) -> torch.Tensor:
    """Slot indices (B, n_new) the next write will occupy."""
    return cache.cursor[:, None] + torch.arange(
        n_new, dtype=torch.int32, device=cache.cursor.device)[None, :]


def _in_cache(cache: KVCache, slots: torch.Tensor) -> torch.Tensor:
    """Slots as int64 indices, out-of-range ones routed to the spare slot."""
    return torch.clamp(slots, max=cache.max_seq).to(torch.int64)


def kv_update_layer(cache: KVCache, layer: int, slots: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Write (B, T, H_kv, D) new keys/values at the given (B, T) slots of one
    layer, in place; a quantized cache stores their codes and scales."""
    idx = _in_cache(cache, slots)
    b_idx = torch.arange(idx.shape[0], device=idx.device)[:, None]
    if cache.quantized:
        quantize = q4_quantize_rows if cache.q4 else q8_quantize_rows
        for codes, scales, new in ((cache.k, cache.k_scale, k_new),
                                   (cache.v, cache.v_scale, v_new)):
            c, s = quantize(new)
            codes[layer][b_idx, :, idx] = c
            scales[layer][b_idx, :, idx] = s
        return cache
    cache.k[layer][b_idx, :, idx] = k_new.to(cache.k.dtype)
    cache.v[layer][b_idx, :, idx] = v_new.to(cache.v.dtype)
    return cache


def kv_advance(cache: KVCache, slots: torch.Tensor, pos_new: torch.Tensor) -> KVCache:
    """Record positions for the written slots and advance cursors, in place.

    pos_new: (B, T) positions; entries with pos < 0 are padding: their slots
    stay empty (-1) and do not count toward the cursor advance."""
    idx = _in_cache(cache, slots)
    b_idx = torch.arange(idx.shape[0], device=idx.device)[:, None]
    valid = pos_new >= 0
    cache.pos[b_idx, idx] = torch.where(valid, pos_new, -1).to(torch.int32)
    cache.cursor += valid.sum(dim=1, dtype=torch.int32)
    return cache


def causal_mask(cache_pos: torch.Tensor, q_pos: torch.Tensor,
                swa_window: int = 0) -> torch.Tensor:
    """Additive mask (B, 1, T, S): slot visible iff occupied ∧ pos ≤ q_pos
    (∧ within the sliding window when swa_window > 0). Padded query rows
    (q_pos < 0) see slot 0 only, to keep their softmax finite."""
    cp = cache_pos[:, None, None, :]
    qp = q_pos[:, None, :, None]
    ok = (cp >= 0) & (cp <= qp)
    if swa_window > 0:
        ok &= cp > qp - swa_window
    slot0 = torch.arange(cache_pos.shape[1], device=cache_pos.device) == 0
    ok |= (qp < 0) & slot0[None, None, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=cache_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, float("-inf")))


def kv_truncate_rows(cache: KVCache, keep: torch.Tensor) -> KVCache:
    """Per-row truncation to the first ``keep[b]`` slots, in place (rollback
    of block-decode overshoot). Stale K/V beyond the cut stay in memory,
    masked by pos = -1 and overwritten by later writes."""
    keep = keep.to(device=cache.pos.device, dtype=torch.int32)
    idx = torch.arange(cache.pos.shape[1], device=cache.pos.device)[None, :]
    cache.pos.masked_fill_(idx >= keep[:, None], -1)
    cache.cursor.copy_(keep)
    return cache


def kv_insert_row(big: KVCache, small: KVCache, row: int, n_valid: int) -> KVCache:
    """Copy a one-row cache (a prefill scratch) into row ``row`` of ``big``,
    in place, with its scales; the row's cursor becomes n_valid."""
    big.k[:, row] = small.k[:, 0]
    big.v[:, row] = small.v[:, 0]
    if big.quantized:
        big.k_scale[:, row] = small.k_scale[:, 0]
        big.v_scale[:, row] = small.v_scale[:, 0]
    big.pos[row] = small.pos[0]
    big.cursor[row] = n_valid
    return big


# --- iSWA two-tier cache -------------------------------------------------------
#
# Counterpart of the JAX package's ISWACache (llama_kv_cache_iswa,
# src/llama-kv-cache-iswa.h): full-attention layers keep the append-ordered
# cache; sliding-window layers share a ring of O(window) slots indexed by
# pos % S_swa. A write overwrites the entry S_swa positions older, which the
# window mask hides anyway. Padding tokens (pos < 0) go to slot S_swa, the
# spare slot, where the JAX ring drops them. Slots and positions are computed
# on the device, so a step on the ring is captured like any other.


@dataclass
class ISWACache:
    full: KVCache   # (n_full_layer, B, H_kv, S_full + 1, D), append-ordered
    swa: KVCache    # (n_swa_layer,  B, H_kv, S_swa + 1,  D), ring by pos % S_swa

    @property
    def max_seq(self) -> int:
        return self.full.max_seq


def iswa_layer_split(hp) -> tuple[list[int], list[int]]:
    """(full layers, SWA layers): the static routing of each layer."""
    full = [il for il in range(hp.n_layer) if not hp.is_swa_layer(il)]
    swa = [il for il in range(hp.n_layer) if hp.is_swa_layer(il)]
    return full, swa


def iswa_swa_seq(window: int, n_ubatch: int, max_seq: int) -> int:
    """Ring size: the window plus one ubatch of headroom, rounded up to a
    multiple of 128, at most max_seq (the reference's size_swa = window +
    n_ubatch, src/llama-kv-cache-iswa.cpp)."""
    s = -(-(window + n_ubatch) // 128) * 128
    return min(s, max_seq)


def iswa_cache_init(hp, batch: int, max_seq: int, n_ubatch: int = 512,
                    dtype=torch.bfloat16, device="cpu") -> ISWACache:
    full, swa = iswa_layer_split(hp)
    s_swa = iswa_swa_seq(hp.swa_window, n_ubatch, max_seq)
    return ISWACache(
        full=kv_cache_init(len(full), batch, max_seq, hp.n_head_kv, hp.head_dim,
                           hp.head_dim_v, dtype, device),
        swa=kv_cache_init(len(swa), batch, s_swa, hp.n_head_kv, hp.head_dim,
                          hp.head_dim_v, dtype, device))


def kv_ring_slots(pos: torch.Tensor, max_seq: int) -> torch.Tensor:
    """Ring slot of each token: pos % S; padding (pos < 0) → S, the spare
    slot."""
    return torch.where(pos >= 0, torch.remainder(pos, max_seq), max_seq).to(torch.int32)


def kv_ring_advance(cache: KVCache, slots: torch.Tensor, pos_new: torch.Tensor) -> KVCache:
    """Record positions at ring slots, in place (padding lands in the spare
    slot); the cursor becomes max(cursor, the highest position + 1), a
    high-water mark for bookkeeping only."""
    idx = _in_cache(cache, slots)
    b_idx = torch.arange(idx.shape[0], device=idx.device)[:, None]
    cache.pos[b_idx, idx] = pos_new.to(torch.int32)
    top = (pos_new.amax(dim=1) + 1).to(torch.int32)
    torch.maximum(cache.cursor, top, out=cache.cursor)
    return cache


def iswa_truncate_pos(cache: ISWACache, keep_pos: torch.Tensor) -> ISWACache:
    """Empty every entry at a position >= keep_pos[b] in both tiers, in
    place (a rollback by position). The full tier's cursor becomes its count
    of surviving entries (it stays append-ordered), the ring's
    min(cursor, keep_pos)."""
    keep_pos = keep_pos.to(device=cache.full.pos.device, dtype=torch.int32)
    cut = keep_pos[:, None]
    for tier in (cache.full, cache.swa):
        tier.pos.masked_fill_(tier.pos >= cut, -1)
    S = cache.full.max_seq
    cache.full.cursor.copy_((cache.full.pos[:, :S] >= 0).sum(dim=1, dtype=torch.int32))
    torch.minimum(cache.swa.cursor, keep_pos, out=cache.swa.cursor)
    return cache


# --- sequence ops -------------------------------------------------------------
#
# The JAX package's seq_* ops and context shift (llama_memory_seq_* of
# include/llama.h) return new arrays; these write their results into the
# cache's own tensors (``copy_``), since captured CUDA graphs address them.
# They read and write slots [0, max_seq) only; the spare slot is left alone.


def _gather_slots(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, ...) gathered along S by a per-row (B, S) order."""
    idx = order.reshape(order.shape[0], 1, order.shape[1], *([1] * (x.ndim - 3)))
    return torch.gather(x, 2, idx.expand(x.shape))


def _rerope_k(cache: KVCache, il: int, delta: torch.Tensor, inv_freq: torch.Tensor,
              rope_type: int = 0, mscale: float = 1.0):
    """Layer il's stored K over its first S slots re-rotated by a per-(row,
    slot) position delta (B, S): the reference's shift by rope rerun. A Q8_0
    K is dequantized, rotated and requantized with ``q8_quantize_rows``, as
    the JAX package does. Returns (k, k_scale or None), new tensors.

    A Q4_0 K raises: the JAX package multiplies its packed nibbles by the
    per-32-group scales as if they were Q8_0's per-row ones, which fails."""
    if cache.q4:
        raise ValueError("a Q4_0 KV cache cannot be re-roped (context shift, seq_add_rerope, "
                         "seq_div): the JAX package's _rerope_k treats its per-32-group "
                         "scales as Q8_0's per-row ones and fails")
    S = cache.max_seq
    k = cache.k[il][:, :, :S]
    if cache.quantized:
        k = k.to(torch.float32) * cache.k_scale[il][:, :, :S, None]
    # (B, H, S, D) → (B, S, H, D): rope over S
    k = apply_rope(k.transpose(1, 2), delta.to(torch.int32), inv_freq, rope_type,
                   mscale).transpose(1, 2)
    if cache.quantized:
        return q8_quantize_rows(k)
    return k.to(cache.k.dtype), None


def kv_context_shift(cache: KVCache, keep: torch.Tensor, discard: torch.Tensor,
                     inv_freq: torch.Tensor, rope_type: int = 0,
                     mscale: float = 1.0) -> KVCache:
    """Context shift (server-context.cpp:1976-2023 semantics), in place: per
    row, drop positions [keep, keep + discard) and slide later positions
    down by ``discard``. K is re-roped by −discard and the row compacted
    (a stable sort by new position, holes last), so slot order stays
    position order. keep / discard: (B,) ints; discard 0 leaves a row's
    positions as they are (its K goes through the rotation by 0, as in
    JAX)."""
    S = cache.max_seq
    pos = cache.pos[:, :S]
    keep = torch.as_tensor(keep).to(pos.device, torch.int32)[:, None]
    discard = torch.as_tensor(discard).to(pos.device, torch.int32)[:, None]
    kd = keep + discard
    sel_discard = (pos >= keep) & (pos < kd) & (discard > 0)
    sel_shift = (pos >= kd) & (discard > 0)
    new_pos = torch.where(sel_discard, -1, torch.where(sel_shift, pos - discard, pos))
    delta = torch.where(sel_shift, -discard, 0)
    order = torch.argsort(torch.where(new_pos < 0, 2 ** 30, new_pos), dim=1, stable=True)
    for il in range(cache.k.shape[0]):
        k, ks = _rerope_k(cache, il, delta, inv_freq, rope_type, mscale)
        cache.k[il][:, :, :S].copy_(_gather_slots(k, order))
        cache.v[il][:, :, :S].copy_(_gather_slots(cache.v[il][:, :, :S], order))
        if ks is not None:
            cache.k_scale[il][:, :, :S].copy_(_gather_slots(ks, order))
            cache.v_scale[il][:, :, :S].copy_(_gather_slots(cache.v_scale[il][:, :, :S], order))
    pos_c = torch.gather(new_pos, 1, order)
    pos.copy_(pos_c)
    cache.cursor.copy_((pos_c >= 0).sum(dim=1, dtype=torch.int32))
    return cache


def kv_gather_slots(cache: KVCache, idx: torch.Tensor, n_valid: torch.Tensor) -> KVCache:
    """Reorder / compact rows by slot index, in place: new slot j takes old
    slot idx[b, j]; slots from n_valid[b] on become empty and the cursor is
    n_valid (tree-decoding accept: lookahead keeps the prefix and the
    winning branch's cells)."""
    S = cache.max_seq
    idx = torch.as_tensor(idx).to(cache.pos.device, torch.int64)
    n_valid = torch.as_tensor(n_valid).to(cache.pos.device, torch.int32)
    tensors = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale] if cache.quantized else [])
    for t in tensors:
        for il in range(t.shape[0]):
            t[il][:, :, :S].copy_(_gather_slots(t[il][:, :, :S], idx))
    pos = torch.gather(cache.pos[:, :S], 1, idx)
    valid = torch.arange(S, device=pos.device)[None, :] < n_valid[:, None]
    cache.pos[:, :S].copy_(torch.where(valid, pos, -1))
    cache.cursor.copy_(n_valid)
    return cache


def _row_sel(cache: KVCache, b: int, p0: int, p1: int) -> torch.Tensor:
    """(S,) cells of row b whose positions lie in [p0, p1)."""
    p = cache.pos[b, : cache.max_seq]
    return (p >= p0) & (p < p1)


def seq_rm(cache: KVCache, b: int, p0: int, p1: int) -> KVCache:
    """Remove positions [p0, p1) of row b (llama_memory_seq_rm), in place."""
    cache.pos[b, : cache.max_seq].masked_fill_(_row_sel(cache, b, p0, p1), -1)
    return cache


def seq_add(cache: KVCache, b: int, p0: int, p1: int, delta: int) -> KVCache:
    """Shift positions [p0, p1) of row b by delta, in place: the position
    table only (K stays as rotated; ``seq_add_rerope`` re-ropes it)."""
    p = cache.pos[b, : cache.max_seq]
    p.copy_(torch.where(_row_sel(cache, b, p0, p1), p + delta, p))
    return cache


def _rerope_rows(cache: KVCache, delta: torch.Tensor, inv_freq, rope_type, mscale) -> None:
    """Re-rope every layer's K by a (B, S) delta, in place."""
    S = cache.max_seq
    for il in range(cache.k.shape[0]):
        k, ks = _rerope_k(cache, il, delta, inv_freq, rope_type, mscale)
        cache.k[il][:, :, :S].copy_(k)
        if ks is not None:
            cache.k_scale[il][:, :, :S].copy_(ks)


def seq_add_rerope(cache: KVCache, b: int, p0: int, p1: int, delta: int,
                   inv_freq: torch.Tensor, rope_type: int = 0,
                   mscale: float = 1.0) -> KVCache:
    """seq_add with K re-roped to match (exact llama_memory_seq_add), in
    place."""
    sel = _row_sel(cache, b, p0, p1)
    d = torch.zeros_like(cache.pos[:, : cache.max_seq])
    d[b] = torch.where(sel, delta, 0)
    _rerope_rows(cache, d, inv_freq, rope_type, mscale)
    p = cache.pos[b, : cache.max_seq]
    p.copy_(torch.where(sel, p + delta, p))
    return cache


def seq_div(cache: KVCache, b: int, p0: int, p1: int, d: int,
            inv_freq: torch.Tensor, rope_type: int = 0,
            mscale: float = 1.0) -> KVCache:
    """Integer-divide positions [p0, p1) of row b by d, K re-roped by each
    cell's delta, in place: self-extend's grouped attention
    (llama_memory_seq_div; examples/passkey/passkey.cpp:138-139)."""
    sel = _row_sel(cache, b, p0, p1)
    p = cache.pos[b, : cache.max_seq]
    new_p = torch.where(sel, torch.div(p, d, rounding_mode="floor"), p)
    delta = torch.zeros_like(cache.pos[:, : cache.max_seq])
    delta[b] = torch.where(sel, new_p - p, 0)
    _rerope_rows(cache, delta, inv_freq, rope_type, mscale)
    p.copy_(new_p)
    return cache


def seq_cp(cache: KVCache, src: int, dst: int) -> KVCache:
    """Copy row src over row dst (llama_memory_seq_cp for batch-row
    sequences), in place."""
    for t in (cache.k, cache.v) + ((cache.k_scale, cache.v_scale) if cache.quantized else ()):
        t[:, dst].copy_(t[:, src])
    cache.pos[dst].copy_(cache.pos[src])
    cache.cursor[dst].copy_(cache.cursor[src])
    return cache


def seq_keep(cache: KVCache, b: int) -> KVCache:
    """Clear every row but b, in place."""
    other = torch.arange(cache.pos.shape[0], device=cache.pos.device) != b
    cache.pos.masked_fill_(other[:, None], -1)
    cache.cursor.masked_fill_(other, 0)
    return cache
