"""Lookahead decoding (examples/lookahead/lookahead.cpp counterpart).

The JAX package's ``runtime/lookahead.py::LookaheadDecoder`` over the port's
forward. Jacobi-iteration parallel decoding with an n-gram pool: each step
evaluates, in ONE batched forward pass with a tree-attention mask,
  - the current input token,
  - up to G verification n-grams drafted from the pool,
  - a W-wide, (N−1)-level lookahead window whose levels shift down each step
    (the Jacobi trajectories that mint new n-grams).
Accepted verification tokens advance several positions per pass; no draft
model is needed. The mask layout is lookahead.cpp:173-196, the pool update
:371-423 (a ring of G n-grams per head token, deduplicated), the acceptance
loop :259-329. The masked step takes the forward's plain attention path
(``attn_mask`` turns flash off); the accepted cells are kept with
``kv_gather_slots``, in the cache's own storage. Greedy only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.registry import get_forward
from .context import check_model_device
from .kv_cache import kv_cache_init, kv_gather_slots

NEG = -1e30


class LookaheadDecoder:
    """Greedy lookahead decoding of one sequence on one device (default
    CUDA); kv_dtype defaults to f32, as in JAX."""

    def __init__(self, model, W: int = 8, N: int = 4, G: int = 8,
                 n_ctx: int = 1024, kv_dtype=None, device=None):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        self.model = model
        self.hp = model.hparams
        self.W, self.N, self.G = W, N, G
        self.n_ctx = n_ctx
        self.kv_dtype = kv_dtype or torch.float32
        self.fwd = get_forward(self.hp.arch)
        # batch layout: [input] [G*(N-1) verify] [W-1 level-0] [W*(N-2) levels]
        self.T = 1 + G * (N - 1) + (W - 1) + W * (N - 2)
        self.n_accept = 0
        self.n_steps = 0

    def _dev(self, arr: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=dtype).to(self.device)

    def _prefill(self, ids, cache):
        """The prompt in 64-token chunks; returns the last position's logits
        (f32, host)."""
        P = 64
        for off in range(0, len(ids), P):
            chunk = ids[off:off + P]
            t = np.zeros((1, P), np.int64)
            p = np.full((1, P), -1, np.int32)
            t[0, :len(chunk)] = chunk
            p[0, :len(chunk)] = np.arange(off, off + len(chunk))
            logits, _ = self.fwd(self.model.params, self.hp, self._dev(t, torch.int64),
                                 self._dev(p, torch.int32), cache)
            last = len(chunk) - 1
        return logits[0, last].float().cpu().numpy()

    @torch.no_grad()
    def generate(self, prompt_ids: list[int], n_gen: int) -> list[int]:
        W, N, G, T = self.W, self.N, self.G, self.T
        hp = self.hp
        cache = kv_cache_init(hp.n_layer, 1, self.n_ctx, hp.n_head_kv, hp.head_dim,
                              hp.head_dim_v, dtype=self.kv_dtype, device=self.device)
        last_logits = self._prefill([int(t) for t in prompt_ids], cache)
        n_past = len(prompt_ids)
        out = [int(t) for t in prompt_ids]
        cur = int(last_logits.argmax())
        out.append(cur)

        # Jacobi window levels [N-1][W] and the n-gram pool
        tokens_j = [[100 + i for i in range(W)] for _ in range(N - 1)]
        pool: dict[int, list[list[int]]] = {}  # head token -> ring of ≤ G grams

        while len(out) - len(prompt_ids) < n_gen:
            if n_past + T + 1 > self.n_ctx:
                break  # the window no longer fits; the caller sizes n_ctx
            g_list = pool.get(cur, [])[:G]
            g_cur = len(g_list)
            toks = np.zeros(T, np.int64)
            pos = np.full(T, -1, np.int32)
            seqs: list[set] = [set()] * T
            toks[0], pos[0] = cur, n_past
            seqs[0] = set(range(W + G + 1))        # the input joins every branch
            vidx = np.zeros((g_cur, N), np.int32)  # batch index per gram position
            b = 1
            for g in range(g_cur):
                vidx[g, 0] = 0
                for j in range(N - 1):
                    toks[b], pos[b] = g_list[g][j], n_past + 1 + j
                    seqs[b] = {W + 1 + g}
                    vidx[g, j + 1] = b
                    b += 1
            b = 1 + G * (N - 1)                    # fixed offset of level 0
            look0 = b
            for i in range(1, W):
                toks[b], pos[b] = tokens_j[0][i], n_past + i
                seqs[b] = set(range(i + 1, W + 1))
                b += 1
            lookj = b
            for j in range(1, N - 1):
                for i in range(W):
                    toks[b], pos[b] = tokens_j[j][i], n_past + j + i
                    seqs[b] = {i + 1}
                    b += 1

            # tree-attention mask: the prefix causal, plus same-branch entries
            n_kv = n_past
            S = self.n_ctx
            mask = np.full((1, 1, T, S), NEG, np.float32)
            mask[0, 0, :, :n_kv] = 0.0             # the committed prefix
            for t in range(T):
                if pos[t] < 0:
                    mask[0, 0, t, :] = NEG
                    mask[0, 0, t, 0] = 0.0         # keeps the softmax finite
                    continue
                for s in range(T):
                    if pos[s] < 0 or pos[s] > pos[t]:
                        continue
                    if seqs[t] & seqs[s]:
                        mask[0, 0, t, n_kv + s] = 0.0
            logits, _ = self.fwd(self.model.params, hp, self._dev(toks[None], torch.int64),
                                 self._dev(pos[None], torch.int32), cache,
                                 attn_mask=self._dev(mask, torch.float32))
            lg = logits[0].float().cpu().numpy()
            self.n_steps += 1

            active = [True] * g_cur
            accepted_slots: list[int] = []
            ids_round: list[int] = []
            nid = int(lg[0].argmax())
            for v in range(N):
                if v > 0:
                    gi = next((g for g in range(g_cur) if active[g]), None)
                    if gi is None:
                        break
                    nid = int(lg[vidx[gi, v]].argmax())
                    accepted_slots.append(int(vidx[gi, v]))
                    self.n_accept += 1
                ids_round.append(nid)
                out.append(nid)
                if len(out) - len(prompt_ids) >= n_gen + 1:
                    break
                for g in range(g_cur):
                    if active[g] and (v == N - 1 or nid != g_list[g][v]):
                        active[g] = False
                # shift the Jacobi window down one level
                prev0 = list(tokens_j[0])
                for j in range(N - 2):
                    tokens_j[j] = tokens_j[j + 1]
                if v == 0:
                    tokens_j[N - 2] = [
                        int(lg[lookj + (N - 3) * W + i].argmax()) if N > 2
                        else int(lg[(look0 + i - 1) if i else 0].argmax())
                        for i in range(W)]
                else:
                    tokens_j[N - 2] = list(tokens_j[0])
                # mint n-grams from the trajectories (v == 0 only)
                if v == 0:
                    for f in range(W):
                        head = prev0[f]
                        gram = [tokens_j[j][f] for j in range(N - 1)]
                        ring = pool.setdefault(head, [])
                        if gram in ring:
                            continue
                        ring.append(gram)
                        if len(ring) > G:
                            ring.pop(0)
            # commit: the prefix, the input's cell and the accepted verify cells
            idx = np.arange(S, dtype=np.int64)
            keep = [n_kv + 0] + [n_kv + s for s in accepted_slots]
            idx[n_kv:n_kv + len(keep)] = keep
            kv_gather_slots(cache, torch.as_tensor(idx[None]),
                            torch.tensor([n_kv + len(keep)], dtype=torch.int32))
            n_past += len(keep)
            cur = out[-1] if ids_round else cur
        return out[:len(prompt_ids) + n_gen]
