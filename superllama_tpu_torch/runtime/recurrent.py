"""Recurrent state stores (mamba- and rwkv-style), the counterpart of the JAX
package's ``runtime/recurrent.py`` (llama_memory_recurrent): instead of KV
slots, each layer carries a convolution shift-state and an SSM state.

The JAX stores are functional NamedTuples; these hold device tensors that
the forwards update in place, like the port's ``KVCache``, so a step on
them is captured in a CUDA graph like any other. ``FIELDS`` names each
store's tensors in order (the JAX tuples' ``_fields``), each with its layer
axis first and its batch axis second.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RecurrentCache:
    conv: torch.Tensor   # (L, B, d_conv - 1, conv_dim): the last d_conv - 1 conv inputs
    ssm: torch.Tensor    # (L, B, d_inner, d_state)

    FIELDS = ("conv", "ssm")

    @property
    def batch(self) -> int:
        return self.conv.shape[1]


def recurrent_cache_init(n_layer: int, batch: int, d_conv: int, d_inner: int,
                         d_state: int, dtype=torch.float32, conv_dim: int | None = None,
                         device="cpu") -> RecurrentCache:
    """conv_dim: the channels through the conv (mamba2 convolves [x, B, C], so
    it exceeds d_inner); defaults to d_inner (mamba1)."""
    return RecurrentCache(
        conv=torch.zeros((n_layer, batch, d_conv - 1, conv_dim or d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((n_layer, batch, d_inner, d_state), dtype=dtype, device=device))


def seq_keep_row(cache: RecurrentCache, b: int) -> RecurrentCache:
    """Zero every row but b, in place."""
    keep = torch.arange(cache.batch, device=cache.conv.device) == b
    for t in (cache.conv, cache.ssm):
        t.mul_(keep.reshape(1, -1, *(1,) * (t.ndim - 2)).to(t.dtype))
    return cache


@dataclass
class HybridCache:
    """The hybrid memory (llama_memory_hybrid): a flat KV cache over the
    attention layers and a recurrent store over the SSM layers, each indexed
    by its own compact layer list (``models/jamba.py::hybrid_layer_split``)."""

    attn: object               # KVCache over the attention layers only
    rec: RecurrentCache        # conv + SSM state over the recurrent layers only

    @property
    def batch(self) -> int:
        return self.rec.batch


@dataclass
class RWKVCache:
    """RWKV recurrent state (token_shift_count 2, as llama_memory_recurrent
    stores it for rwkv6 / rwkv7): per layer the last time-mix and
    channel-mix inputs and the (H, D, D) wkv state, f32."""

    shift: torch.Tensor   # (L, B, 2, E): [att_shift, ffn_shift]
    wkv: torch.Tensor     # (L, B, H, D, D) f32

    FIELDS = ("shift", "wkv")

    @property
    def batch(self) -> int:
        return self.shift.shape[1]


def rwkv_cache_init(n_layer: int, batch: int, n_embd: int, n_head: int, head_size: int,
                    dtype=torch.float32, device="cpu") -> RWKVCache:
    return RWKVCache(
        shift=torch.zeros((n_layer, batch, 2, n_embd), dtype=dtype, device=device),
        wkv=torch.zeros((n_layer, batch, n_head, head_size, head_size),
                        dtype=torch.float32, device=device))
