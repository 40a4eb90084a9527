"""Inference context: a model, its forward function and one KV cache.

Counterpart of the JAX package's ``runtime/context.py::Context``. The JAX
context jit-compiles its step and donates the functional cache; here the
forward runs eagerly and updates the cache in place. The cache comes from
``cache_policy.make_cache``: the recurrent store of a mamba or RWKV model,
the hybrid one of a model with SSM (or short-conv, or delta-net) and
attention layers, the iSWA two-tier cache by default for a model with
sliding-window layers (``iswa=None``), else the flat one. A recurrent model's positions come from a counter of the tokens
fed (its state has none); a quantized cache for any but the flat or paged
one raises ``ValueError``, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.loader import LoadedModel
from ..models.registry import get_forward
from .cache_policy import cache_kind, make_cache
from .kv_cache import ISWACache, iswa_layer_split
from .recurrent import HybridCache


def model_device(model: LoadedModel) -> torch.device:
    return model.params["token_embd"].device


def check_model_device(model: LoadedModel, device: torch.device) -> None:
    have = model_device(model)
    if have.type != device.type:
        raise ValueError(f"model weights are on {have}, but {device} was asked "
                         f"for; load the model with device={str(device)!r}")


class Context:
    def __init__(self, model: LoadedModel, n_batch: int = 1, n_ctx: int = 2048,
                 kv_dtype: torch.dtype | str | None = None, device=None,
                 iswa: bool | None = None):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        self.model = model
        hp = self.hp = model.hparams
        self.n_batch = n_batch
        self.n_ctx = n_ctx
        # the iSWA two-tier cache (llama_kv_cache_iswa): on for models with
        # sliding-window layers, whose layers then take an O(window) ring
        if iswa is None:
            iswa = (cache_kind(hp) == "dense" and hp.swa_window > 0
                    and len(iswa_layer_split(hp)[1]) > 0)
        self.iswa = bool(iswa)
        self.kv_dtype = kv_dtype or model.params["token_embd"].dtype
        self._fwd = get_forward(hp.arch)
        self.cache = self.new_cache()
        self._n_past = 0        # a recurrent model's position counter

    def new_cache(self):
        return make_cache(self.hp, self.n_batch, self.n_ctx, self.kv_dtype, iswa=self.iswa,
                          device=self.device)

    def reset(self) -> None:
        """Start over on an empty cache."""
        self.cache = self.new_cache()
        self._n_past = 0

    @torch.no_grad()
    def forward(self, tokens, pos=None) -> torch.Tensor:
        """Run one step over (B, T) tokens; returns logits (B, T, V)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                 device=self.device)
        if tokens.ndim == 1:
            tokens = tokens[None, :]
        B, T = tokens.shape
        if self.hp.is_recurrent:
            if pos is None:
                pos = self._n_past + torch.arange(T, dtype=torch.int32,
                                                  device=self.device)[None, :].expand(B, T)
            else:
                pos = torch.as_tensor(np.asarray(pos), dtype=torch.int32,
                                      device=self.device).reshape(-1, T).expand(B, T)
            self._n_past += T
            logits, self.cache = self._fwd(self.model.params, self.hp, tokens, pos,
                                           self.cache)
            return logits
        if isinstance(self.cache, ISWACache):
            s_swa = self.cache.swa.max_seq
            if s_swa < self.n_ctx and T > s_swa - self.hp.swa_window:
                raise ValueError(f"ubatch of {T} exceeds SWA ring headroom ({s_swa} slots - "
                                 f"window {self.hp.swa_window}); split it")
            cursor = torch.maximum(self.cache.full.cursor, self.cache.swa.cursor)
        elif isinstance(self.cache, HybridCache):
            cursor = self.cache.attn.cursor
        else:
            cursor = self.cache.cursor
        max_cursor = int(cursor.max())
        if max_cursor + T > self.n_ctx:
            raise ValueError(f"KV cache overflow: {max_cursor}+{T} > n_ctx={self.n_ctx}")
        if pos is None:
            pos = cursor[:B, None] + torch.arange(
                T, dtype=torch.int32, device=self.device)[None, :]
        else:
            pos = torch.as_tensor(np.asarray(pos), dtype=torch.int32,
                                  device=self.device)
            if pos.ndim == 1:
                pos = pos[None, :]
        logits, self.cache = self._fwd(self.model.params, self.hp, tokens, pos,
                                       self.cache)
        return logits

    def greedy_generate(self, prompt_ids: list[int], n_gen: int,
                        stop_eog: bool = True) -> list[int]:
        """Prefill + greedy decode loop."""
        v = self.model.tokenizer.vocab if self.model.tokenizer else None
        logits = self.forward(np.asarray(prompt_ids, np.int64))
        out = list(prompt_ids)
        last = int(torch.argmax(logits[0, -1]))
        out.append(last)
        for _ in range(n_gen - 1):
            if stop_eog and v is not None and v.is_eog(last):
                break
            logits = self.forward(np.asarray([last], np.int64))
            last = int(torch.argmax(logits[0, -1]))
            out.append(last)
        return out
