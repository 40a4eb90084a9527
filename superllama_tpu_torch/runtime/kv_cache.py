"""Float KV cache (f32 / bf16) with positional masking.

Counterpart of the JAX package's ``runtime/kv_cache.py``: a fixed-shape ring
of (k, v, pos) tensors; causal masking derives from the stored per-slot
positions, so mixed prefill/decode batches need no host bookkeeping.

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


@dataclass
class KVCache:
    k: torch.Tensor        # (n_layer, B, H_kv, S + 1, D)
    v: torch.Tensor        # (n_layer, B, H_kv, S + 1, Dv)
    pos: torch.Tensor      # (B, S + 1) int32; -1 = empty slot
    cursor: torch.Tensor   # (B,) int32 next write slot

    @property
    def max_seq(self) -> int:
        return self.k.shape[3] - 1

    def positions(self, n: int | None = None) -> torch.Tensor:
        """(B, n) slot positions of the first n slots (all by default)."""
        return self.pos[:, : (n or self.max_seq)]

    def layer(self, il: int, n: int | None = None):
        """(k, v) views of layer il over the first n slots: (B, H_kv, n, D)."""
        n = n or self.max_seq
        return self.k[il][:, :, :n], self.v[il][:, :, :n]


def kv_cache_init(n_layer: int, batch: int, max_seq: int, n_head_kv: int,
                  head_dim: int, head_dim_v: int | None = None,
                  dtype=torch.bfloat16, device="cpu") -> KVCache:
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise NotImplementedError(
            f"KV cache type {dtype!r}: the port keeps f32/bf16 caches; "
            "quantized caches come in a later slice")
    head_dim_v = head_dim_v if head_dim_v is not None else head_dim
    sh = (n_layer, batch, n_head_kv, max_seq + 1)
    return KVCache(
        k=torch.zeros((*sh, head_dim), dtype=dtype, device=device),
        v=torch.zeros((*sh, head_dim_v), dtype=dtype, device=device),
        pos=torch.full((batch, max_seq + 1), -1, dtype=torch.int32, device=device),
        cursor=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


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
    layer, in place."""
    idx = _in_cache(cache, slots)
    b_idx = torch.arange(idx.shape[0], device=idx.device)[:, None]
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
    in place; the row's cursor becomes n_valid."""
    big.k[:, row] = small.k[:, 0]
    big.v[:, row] = small.v[:, 0]
    big.pos[row] = small.pos[0]
    big.cursor[row] = n_valid
    return big
