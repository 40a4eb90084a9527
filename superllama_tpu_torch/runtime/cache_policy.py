"""Memory-type policy for the serving Engine and Context: the counterpart of
the JAX package's ``runtime/cache_policy.py``.

 - ``cache_kind``    : "dense" | "recurrent" | "hybrid", how the Engine must
                       treat a model's rows;
 - ``make_cache``    : the model's memory (create_memory's counterpart): the
                       flat KV cache, the iSWA two-tier one, the recurrent
                       store (mamba's conv + SSM state, or rwkv's) or the
                       hybrid one (a KV cache beside a recurrent store);
 - ``mask_rows``     : after a batched step, rows that were idle get their
                       old recurrent state back (a recurrent state has no
                       position to mask a junk update on read);
 - ``truncate_rows`` : per-row rollback, in place (a flat cache by slot
                       count, an iSWA cache by position; a recurrent row
                       resets where keep is 0 and stays as it is otherwise,
                       since its state cannot rewind; a hybrid cache both);
 - ``get_row`` / ``set_row`` : a slot's state as host arrays and back, in
                       place (llama_state_seq_get_data / set_data), with a
                       quantized cache's scales;
 - ``pow2_chunk``    : recurrent prompts load in fully valid power-of-two
                       chunks, never a padded bucket (a pad token would
                       advance the state).

The port's recurrent forwards keep an idle row's state themselves (rows with
pos[:, 0] < 0, inside the step: the cache is written in place), so the
Engine needs no snapshot for ``mask_rows``; the function serves callers that
hold one.
"""

from __future__ import annotations

import numpy as np
import torch

from .kv_cache import (ISWACache, KVCache, iswa_cache_init, iswa_truncate_pos,
                       kv_cache_init, kv_truncate_rows)
from .recurrent import (HybridCache, RecurrentCache, RWKVCache, recurrent_cache_init,
                        rwkv_cache_init)

_QUANT_KV = ("q8_0 KV cache is supported for standard attention caches only (not "
             "iswa/recurrent/hybrid)")


def cache_kind(hp) -> str:
    """'dense' | 'recurrent' | 'hybrid': how the Engine must treat rows."""
    if hp.is_hybrid:
        return "hybrid"
    if hp.is_recurrent:
        return "recurrent"
    return "dense"


def make_cache(hp, batch: int, n_ctx: int, kv_dtype, iswa: bool = False,
               n_ubatch: int = 512, device="cpu"):
    """The model's memory: a ``HybridCache`` for a hybrid model, an
    ``RWKVCache`` (f32) or a ``RecurrentCache`` (states in kv_dtype, as in
    JAX) for a recurrent one, an ``ISWACache`` (its ring sized for one
    ubatch of n_ubatch tokens past the window) when ``iswa``, else the flat
    KV cache. A quantized cache for any but the flat one raises
    ``ValueError``, as the JAX Context does."""
    kind = cache_kind(hp)
    if isinstance(kv_dtype, str) and (iswa or kind != "dense"):
        raise ValueError(_QUANT_KV)
    if kind == "hybrid":
        from ..models.jamba import hybrid_cache_init

        return hybrid_cache_init(hp, batch, n_ctx, dtype=kv_dtype, device=device)
    if hp.recurrent_kind == "rwkv":
        return rwkv_cache_init(hp.n_layer, batch, hp.n_embd, hp.n_embd // hp.wkv_head_size,
                               hp.wkv_head_size, dtype=torch.float32, device=device)
    if kind == "recurrent":
        return recurrent_cache_init(hp.n_layer, batch, hp.ssm_d_conv, hp.ssm_d_inner,
                                    hp.ssm_d_state, dtype=kv_dtype,
                                    conv_dim=hp.ssm_conv_dim, device=device)
    if iswa:
        return iswa_cache_init(hp, batch, n_ctx, n_ubatch=n_ubatch, dtype=kv_dtype,
                               device=device)
    return kv_cache_init(hp.n_layer, batch, n_ctx, hp.n_head_kv, hp.head_dim,
                         hp.head_dim_v, dtype=kv_dtype, device=device)


def _rec_fields(cache) -> list[torch.Tensor]:
    return [getattr(cache, f) for f in cache.FIELDS]


def _row_view(active: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A (B,) row vector shaped to select along t's batch axis (axis 1)."""
    return active.to(device=t.device).reshape(1, -1, *(1,) * (t.ndim - 2))


def mask_rows(cache, old, active: torch.Tensor):
    """After a batched step: rows with active False get the state of ``old``
    (a snapshot taken before the step) back, in place. A dense cache is left
    as it is (its junk writes are masked by position on read); a hybrid one
    masks its recurrent half."""
    if isinstance(cache, HybridCache):
        mask_rows(cache.rec, old.rec, active)
    elif isinstance(cache, (RecurrentCache, RWKVCache)):
        for new_t, old_t in zip(_rec_fields(cache), _rec_fields(old)):
            new_t.copy_(torch.where(_row_view(active, new_t), new_t, old_t))
    return cache


def _rec_reset(cache, zero: torch.Tensor) -> None:
    for t in _rec_fields(cache):
        t.masked_fill_(_row_view(zero, t), 0)


def truncate_rows(cache, keep: torch.Tensor):
    """Flat cache: each row cut to its first keep[b] slots. iSWA: every
    entry at a position >= keep[b] emptied in both tiers. Recurrent: rows
    with keep 0 reset to zero, the rest kept as they are (the state cannot
    rewind; the engines that would need it refuse such a model). Hybrid:
    both. In place."""
    if isinstance(cache, KVCache):
        return kv_truncate_rows(cache, keep)
    if isinstance(cache, ISWACache):
        return iswa_truncate_pos(cache, keep)
    if isinstance(cache, (RecurrentCache, RWKVCache)):
        _rec_reset(cache, keep == 0)
        return cache
    if isinstance(cache, HybridCache):
        kv_truncate_rows(cache.attn, keep)
        _rec_reset(cache.rec, keep == 0)
        return cache
    raise TypeError(f"truncate_rows: unsupported cache {type(cache)}")


def get_row(cache, idx: int) -> dict:
    """A slot's state as host arrays: an iSWA cache's per tier (its K / V
    and scales over [0, max_seq), positions and cursor); a recurrent one's
    per field over every layer; a hybrid one's {"attn": its KV row, "rec":
    its recurrent row}. (A flat cache's snapshot is the Engine's own
    ``slot_save``.)"""
    if isinstance(cache, ISWACache):
        return {"full": _kv_get_row(cache.full, idx), "swa": _kv_get_row(cache.swa, idx)}
    if isinstance(cache, HybridCache):
        return {"attn": _kv_get_row(cache.attn, idx), "rec": get_row(cache.rec, idx)}
    if isinstance(cache, (RecurrentCache, RWKVCache)):
        return {f: _host(getattr(cache, f)[:, idx]) for f in cache.FIELDS}
    raise TypeError(type(cache))


def set_row(cache, idx: int, blob: dict):
    """Load a ``get_row`` blob into row idx, in place; a KV tier's spare
    slot comes back empty."""
    if isinstance(cache, ISWACache):
        _kv_set_row(cache.full, idx, blob["full"])
        _kv_set_row(cache.swa, idx, blob["swa"])
        return cache
    if isinstance(cache, HybridCache):
        if "attn" not in blob or "rec" not in blob:
            raise ValueError("a hybrid cache restores only a hybrid state (attn and rec)")
        _kv_set_row(cache.attn, idx, blob["attn"])
        set_row(cache.rec, idx, blob["rec"])
        return cache
    if isinstance(cache, (RecurrentCache, RWKVCache)):
        rows = []
        for f in cache.FIELDS:
            t = getattr(cache, f)[:, idx]
            if f not in blob or tuple(np.shape(blob[f])) != tuple(t.shape):
                got = tuple(np.shape(blob[f])) if f in blob else None
                raise ValueError(f"state {f} has shape {got}, the cache row {tuple(t.shape)}")
            rows.append((t, blob[f]))
        for t, a in rows:
            t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)).to(t.dtype))
        return cache
    raise TypeError(type(cache))


def _kv_parts(kv: KVCache) -> list:
    parts = [("k", kv.k), ("v", kv.v)]
    if kv.quantized:
        parts += [("k_scale", kv.k_scale), ("v_scale", kv.v_scale)]
    return parts


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (a CPU tensor's numpy view would follow later writes);
    float tensors as f32 (numpy has no bfloat16; the values are exact)."""
    dtype = torch.float32 if t.is_floating_point() else t.dtype
    return t.to("cpu", dtype, copy=True).numpy()


def _kv_get_row(kv: KVCache, idx: int) -> dict:
    S = kv.max_seq
    out = {name: _host(t[:, idx, :, :S]) for name, t in _kv_parts(kv)}
    out["pos"] = _host(kv.pos[idx, :S])
    out["cursor"] = int(kv.cursor[idx])
    return out


def _kv_set_row(kv: KVCache, idx: int, blob: dict) -> KVCache:
    S = kv.max_seq
    parts = _kv_parts(kv)
    for name, t in parts:
        if name not in blob:
            raise ValueError(f"a quantized cache restores only a state with its scales "
                             f"(no {name})")
        want = tuple(t[:, idx, :, :S].shape)
        if tuple(np.shape(blob[name])) != want:
            raise ValueError(f"state {name} has shape {tuple(np.shape(blob[name]))}, "
                             f"the cache row {want}")
    if tuple(np.shape(blob["pos"])) != (S,):
        raise ValueError(f"state pos has shape {tuple(np.shape(blob['pos']))}, want ({S},)")
    for name, t in parts:
        t[:, idx, :, :S].copy_(torch.from_numpy(np.array(blob[name])).to(t.dtype))
        t[:, idx, :, S:].zero_()
    kv.pos[idx, :S].copy_(torch.from_numpy(np.array(blob["pos"], dtype=np.int32)))
    kv.pos[idx, S:].fill_(-1)
    kv.cursor[idx].fill_(int(blob["cursor"]))
    return kv


def pow2_chunk(remaining: int, cap: int) -> int:
    """The largest power of two ≤ min(remaining, cap): recurrent prompts load
    in fully valid chunks (no padding) from a log-bounded set of shapes."""
    n = min(remaining, cap)
    return 1 << (n.bit_length() - 1)
