"""Parameters and caches of the JAX package → those of the port.

``params_from_jax`` turns the JAX package's parameter tree, with its arrays
given as numpy arrays, into the port's: the same function computed by both
packages, which the parity tests rely on. ``kv_cache_from_jax``,
``paged_cache_from_jax``, ``recurrent_cache_from_jax`` and
``hybrid_cache_from_jax`` carry a cache across the same way, so both packages
can start from one mid-generation state. This module reads plain attributes
and numpy arrays only; it imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .gguf.constants import GGMLType
from .models.hparams import HParams
from .ops.qtensor import QTensor
from .runtime.kv_cache import KVCache
from .runtime.paged_kv import PagedKVCache
from .runtime.recurrent import HybridCache, RecurrentCache

_QT_META = ("group", "offset", "nibble", "K", "N", "hi_bits", "sb")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bf16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _qtensor(q, device) -> QTensor:
    planes = {n: (None if getattr(q, n) is None else _tensor(getattr(q, n), device))
              for n in QTensor.PLANES}
    meta = {k: bool(q.nibble) if k == "nibble" else int(getattr(q, k)) for k in _QT_META}
    return QTensor(**planes, **meta, ggml_type=GGMLType(int(q.ggml_type)))


def params_from_jax(params_np, hp: HParams, device=None):
    """Nested dict/list of numpy arrays, QTensor leaves as objects with
    numpy planes (``jax.tree_util.tree_map(np.asarray, params)`` gives
    that) → the port's params on ``device`` (default CUDA). A layer's
    ``xielu`` array becomes the tuple of Python floats the port's forward
    takes; every other array (``cvec``, 2-D q/k norms…) a tensor. The
    layer lists are checked against hp: ``layers`` (n_layer), T5's
    ``enc_layers`` / ``dec_layers`` (n_layer / dec_n_layer), the
    WavTokenizer decoder's ``posnet`` / ``convnext``."""
    dev = resolve_device(device)
    want = ({"enc_layers": hp.n_layer, "dec_layers": hp.dec_n_layer or hp.n_layer}
            if "enc_layers" in params_np else
            {"posnet": hp.posnet_n_layer, "convnext": hp.convnext_n_layer}
            if "posnet" in params_np else {"layers": hp.n_layer})
    for key, n in want.items():
        if len(params_np.get(key, [])) != n:
            raise ValueError(f"expected {n} {key}, got {len(params_np.get(key, []))}")

    def conv(v):
        if v is None:
            return None
        if hasattr(v, "codes") and hasattr(v, "ggml_type"):   # a QTensor
            return _qtensor(v, dev)
        if isinstance(v, dict):
            return {k: tuple(float(a) for a in np.asarray(x)) if k == "xielu" else conv(x)
                    for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return _tensor(v, dev)

    return conv(params_np)


def kv_cache_from_jax(cache_np, device=None) -> KVCache:
    """A JAX ``KVCache`` (float, Q8_0 or Q4_0; fields as numpy arrays) →
    the port's, with the spare slot added at index max_seq (empty: codes and
    scales 0, position -1)."""
    dev = resolve_device(device)

    def spare(a, fill):
        a = np.asarray(a)
        axis = 1 if a.ndim == 2 else 3        # pos (B, S); k/v/scales (L, B, H, S, ...)
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, 1)
        return _tensor(np.pad(a, pad, constant_values=fill), dev)

    quant = getattr(cache_np, "k_scale", None) is not None
    return KVCache(
        k=spare(cache_np.k, 0), v=spare(cache_np.v, 0), pos=spare(cache_np.pos, -1),
        cursor=_tensor(cache_np.cursor, dev),
        k_scale=spare(cache_np.k_scale, 0) if quant else None,
        v_scale=spare(cache_np.v_scale, 0) if quant else None)


def paged_cache_from_jax(cache_np, device=None) -> PagedKVCache:
    """A JAX ``PagedKVCache`` (fields as numpy arrays) → the port's."""
    dev = resolve_device(device)
    return PagedKVCache(**{name: _tensor(getattr(cache_np, name), dev)
                           for name in ("k_pages", "v_pages", "page_pos", "table",
                                        "cur_page", "cur_off")})


def recurrent_cache_from_jax(cache_np, device=None) -> RecurrentCache:
    """A JAX ``RecurrentCache`` (conv and ssm as numpy arrays) → the port's."""
    dev = resolve_device(device)
    return RecurrentCache(conv=_tensor(cache_np.conv, dev), ssm=_tensor(cache_np.ssm, dev))


def hybrid_cache_from_jax(cache_np, device=None) -> HybridCache:
    """A JAX ``HybridCache`` (fields as numpy arrays) → the port's: its KV
    half through ``kv_cache_from_jax``, its recurrent half as it is."""
    return HybridCache(attn=kv_cache_from_jax(cache_np.attn, device),
                       rec=recurrent_cache_from_jax(cache_np.rec, device))
