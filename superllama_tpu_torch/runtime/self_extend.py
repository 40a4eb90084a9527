"""Self-extend (grouped attention): compress KV positions on the fly so a
model attends beyond its trained context without finetuning.

The JAX package's ``runtime/self_extend.py::SelfExtend`` over the port's
``Context``. Behavioral reference: examples/passkey/passkey.cpp:100-180 —
during prefill, whenever n_past crosses the group window, shift and
integer-divide the position range:

    ib = (ga_n * ga_i) / ga_w
    bd = (ga_w / ga_n) * (ga_n - 1)
    dd = (ga_w / ga_n) - ib*bd - ga_w
    seq_add(0, ga_i, n_past, ib*bd)
    seq_div(0, ga_i + ib*bd, ga_i + ib*bd + ga_w, ga_n)
    seq_add(0, ga_i + ib*bd + ga_w, n_past + ib*bd, dd)
    n_past -= bd;  ga_i += ga_w / ga_n

The position edits re-rope K (``seq_add_rerope``, ``seq_div``) in the
cache's own storage.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ref as ops
from .kv_cache import seq_add_rerope, seq_div


class SelfExtend:
    """Drives grouped-attention prefill and decode over a Context (row 0)."""

    def __init__(self, ctx, ga_n: int = 4, ga_w: int = 256):
        if ga_n < 1 or ga_w % ga_n:
            raise ValueError(f"ga_w ({ga_w}) must be a multiple of ga_n ({ga_n}) >= 1")
        self.ctx = ctx
        self.ga_n = ga_n
        self.ga_w = ga_w
        self.ga_i = 0
        self.n_past = 0
        hp = ctx.hp
        scale = 1.0 / hp.rope_scale_factor if hp.rope_scaling == "linear" else 1.0
        self._inv_freq, self._mscale = ops.rope_frequencies(
            hp.head_dim, hp.n_rot, hp.rope_freq_base, scale, device=ctx.device)

    def _herd(self):
        """Apply the pending group compressions (passkey.cpp's while loop)."""
        rope = (self._inv_freq, self.ctx.hp.rope_type, self._mscale)
        while self.n_past >= self.ga_i + self.ga_w:
            ib = (self.ga_n * self.ga_i) // self.ga_w
            bd = (self.ga_w // self.ga_n) * (self.ga_n - 1)
            dd = (self.ga_w // self.ga_n) - ib * bd - self.ga_w
            c = self.ctx.cache
            seq_add_rerope(c, 0, self.ga_i, self.n_past, ib * bd, *rope)
            seq_div(c, 0, self.ga_i + ib * bd, self.ga_i + ib * bd + self.ga_w, self.ga_n,
                    *rope)
            seq_add_rerope(c, 0, self.ga_i + ib * bd + self.ga_w, self.n_past + ib * bd, dd,
                           *rope)
            self.n_past -= bd
            self.ga_i += self.ga_w // self.ga_n

    def feed(self, tokens) -> torch.Tensor:
        """Prefill or decode a chunk at grouped positions; returns its logits."""
        self._herd()
        t = np.asarray(tokens, np.int64).reshape(1, -1)
        pos = self.n_past + np.arange(t.shape[1], dtype=np.int32)[None]
        logits = self.ctx.forward(t, pos)
        self.n_past += t.shape[1]
        return logits

    def generate(self, prompt_ids: list[int], n_gen: int, chunk: int = 64) -> list[int]:
        out = list(prompt_ids)
        logits = None
        for i in range(0, len(prompt_ids), chunk):
            logits = self.feed(prompt_ids[i:i + chunk])
        last = int(torch.argmax(logits[0, -1]))
        out.append(last)
        for _ in range(n_gen - 1):
            logits = self.feed([last])
            last = int(torch.argmax(logits[0, -1]))
            out.append(last)
        return out
