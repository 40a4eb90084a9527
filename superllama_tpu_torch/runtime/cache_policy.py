"""Memory-type policy for the serving Engine and Context: the dense and iSWA
parts of the JAX package's ``runtime/cache_policy.py``.

 - ``cache_kind``    : "dense" | "recurrent" | "hybrid", how the Engine must
                       treat a model's rows;
 - ``make_cache``    : the model's memory (create_memory's counterpart): the
                       flat KV cache, or the iSWA two-tier one;
 - ``truncate_rows`` : per-row rollback, in place (a flat cache by slot
                       count, an iSWA cache by position);
 - ``get_row`` / ``set_row`` : a slot's state as host arrays and back, in
                       place (llama_state_seq_get_data / set_data), with a
                       quantized cache's scales.

The recurrent and hybrid memories (and ``mask_rows`` / ``pow2_chunk``, which
only they need) wait for ROADMAP §1 item 4.
"""

from __future__ import annotations

import numpy as np
import torch

from .kv_cache import (ISWACache, KVCache, iswa_cache_init, iswa_truncate_pos,
                       kv_cache_init, kv_truncate_rows)

_ITEM_4 = "recurrent and hybrid memories are not ported yet (ROADMAP §1 item 4)"


def cache_kind(hp) -> str:
    """'dense' | 'recurrent' | 'hybrid': how the Engine must treat rows."""
    if hp.is_hybrid:
        return "hybrid"
    if hp.is_recurrent:
        return "recurrent"
    return "dense"


def make_cache(hp, batch: int, n_ctx: int, kv_dtype, iswa: bool = False,
               n_ubatch: int = 512, device="cpu"):
    """The model's memory: an ``ISWACache`` (its ring sized for one ubatch of
    n_ubatch tokens past the window) when ``iswa``, else the flat KV cache.
    A quantized cache with iSWA raises ``ValueError``, as the JAX Context
    does."""
    if cache_kind(hp) != "dense":
        raise NotImplementedError(f"{hp.arch}: {_ITEM_4}")
    if iswa:
        if isinstance(kv_dtype, str):
            raise ValueError("q8_0 KV cache is supported for standard attention caches "
                             "only (not iswa/recurrent/hybrid)")
        return iswa_cache_init(hp, batch, n_ctx, n_ubatch=n_ubatch, dtype=kv_dtype,
                               device=device)
    return kv_cache_init(hp.n_layer, batch, n_ctx, hp.n_head_kv, hp.head_dim,
                         hp.head_dim_v, dtype=kv_dtype, device=device)


def truncate_rows(cache, keep: torch.Tensor):
    """Flat cache: each row cut to its first keep[b] slots. iSWA: every
    entry at a position >= keep[b] emptied in both tiers. In place."""
    if isinstance(cache, KVCache):
        return kv_truncate_rows(cache, keep)
    if isinstance(cache, ISWACache):
        return iswa_truncate_pos(cache, keep)
    raise TypeError(f"truncate_rows: unsupported cache {type(cache)}")


def get_row(cache, idx: int) -> dict:
    """An iSWA slot's state as host arrays: per tier, its K / V (and
    scales) over [0, max_seq), positions and cursor. (A flat cache's
    snapshot is the Engine's own ``slot_save``.)"""
    if isinstance(cache, ISWACache):
        return {"full": _kv_get_row(cache.full, idx), "swa": _kv_get_row(cache.swa, idx)}
    raise TypeError(type(cache))


def set_row(cache, idx: int, blob: dict):
    """Load a ``get_row`` blob into row idx, in place; each tier's spare
    slot comes back empty."""
    if isinstance(cache, ISWACache):
        _kv_set_row(cache.full, idx, blob["full"])
        _kv_set_row(cache.swa, idx, blob["swa"])
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
