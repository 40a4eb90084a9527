"""Prefill, then a block of decode steps with on-device sampling.

Counterpart of the JAX package's ``runtime/decode_loop.py::DecodeLoop``
(prefill + a ``lax.scan`` over the decode steps with
``device_sampling.sample``: one dispatch for N tokens, no per-token Python).
Here the prefill runs eagerly and the n_gen - 1 decode steps are one
function over static buffers: on a CUDA device it is captured once per step
count in a CUDA graph and replayed, on the CPU it runs eagerly. The cache
is one row of n_ctx slots, emptied in place by each ``generate``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.loader import LoadedModel
from ..models.registry import get_forward
from ..ops import device_sampling
from .context import check_model_device
from .graphs import GraphCache
from .kv_cache import kv_cache_init


class DecodeLoop:
    """generate(): prefill + n_gen - 1 decode steps, captured on a CUDA
    device (the default), eager on the CPU."""

    def __init__(self, model: LoadedModel, n_ctx: int = 2048,
                 kv_dtype=torch.bfloat16, temp: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0, device=None):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        self.model = model
        hp = self.hp = model.hparams
        self.n_ctx = n_ctx
        self._fwd = get_forward(hp.arch)
        self.samp_cfg = dict(temp=temp, top_k=top_k, top_p=top_p, min_p=min_p)
        self.cache = kv_cache_init(hp.n_layer, 1, n_ctx, hp.n_head_kv, hp.head_dim,
                                   hp.head_dim_v, dtype=kv_dtype, device=self.device)
        self._io = self._new_io()
        self._idle_io = self._new_io()     # the warm-up's: the row stays idle
        self._graphs = GraphCache(self.device) if self.device.type == "cuda" else None

    def _new_io(self) -> dict:
        i64 = dict(dtype=torch.int64, device=self.device)
        return {"tok": torch.zeros((1, 1), **i64),
                "pos": torch.full((1, 1), -1, dtype=torch.int32, device=self.device),
                "keys": torch.zeros((self.n_ctx, 2), **i64),
                "toks": torch.zeros((1, self.n_ctx), **i64)}

    def _steps(self, io: dict, n: int) -> None:
        """n decode steps from io's token and position, each sampled with
        its own key; the tokens go to io["toks"][:, :n]. A row at pos < 0
        stays idle."""
        tok, pos = io["tok"], io["pos"]
        live = pos[:, 0] >= 0
        out = []
        for i in range(n):
            logits, _ = self._fwd(self.model.params, self.hp, tok, pos, self.cache)
            nxt = device_sampling.sample(logits[:, -1], io["keys"][i], **self.samp_cfg)
            pos = torch.where(live[:, None], pos + 1, pos)
            tok = nxt[:, None]
            out.append(nxt)
        io["toks"][:, :n].copy_(torch.stack(out, dim=1))

    @torch.no_grad()
    def generate(self, prompt_ids: list[int], n_gen: int, seed: int = 0,
                 stop_eog: bool = True) -> list[int]:
        """Single-sequence generate; returns prompt + generated ids."""
        n = len(prompt_ids)
        if n < 1 or n_gen < 1 or n + n_gen > self.n_ctx:
            raise ValueError(f"prompt ({n}) + n_gen ({n_gen}) must fit n_ctx ({self.n_ctx})")
        cache = self.cache
        cache.pos.fill_(-1)
        cache.cursor.zero_()
        tokens = torch.tensor([list(prompt_ids)], dtype=torch.int64, device=self.device)
        pos = torch.arange(n, dtype=torch.int32, device=self.device)[None]
        logits, _ = self._fwd(self.model.params, self.hp, tokens, pos, cache)
        subs = None
        if self.samp_cfg["temp"] > 0.0:
            # the JAX loop's key chain: key, sub = split(key) before each token
            key, subs = device_sampling.prng_key(seed), []
            for _ in range(n_gen):
                key, sub = device_sampling.split(key)
                subs.append(sub)
            subs = torch.stack(subs).to(self.device)
        tok0 = device_sampling.sample(logits[:, -1], None if subs is None else subs[0],
                                      **self.samp_cfg)
        out = tok0
        m = n_gen - 1
        if m > 0:
            io = self._io
            io["tok"].copy_(tok0[:, None])
            io["pos"].fill_(n)
            if subs is not None:
                io["keys"][:m].copy_(subs[1:])
            if self._graphs is None:
                self._steps(io, m)
            else:
                self._graphs.run(("decode", m), lambda: self._steps(io, m),
                                 lambda: self._steps(self._idle_io, m))
            out = torch.cat([tok0, io["toks"][0, :m]])
        toks = [int(t) for t in out.cpu()]
        if stop_eog and self.model.tokenizer is not None:
            v = self.model.tokenizer.vocab
            for i, t in enumerate(toks):
                if v.is_eog(t):
                    toks = toks[: i + 1]
                    break
        return list(prompt_ids) + toks
