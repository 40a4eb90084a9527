"""N-gram lookup cache for prompt-based speculative drafting.

The JAX package's ``runtime/ngram.py``, kept as the port's own copy.
Counterpart of common/ngram-cache.{h,cpp} + examples/lookup: drafts come from
n-gram statistics over already-seen tokens instead of a draft model — free
speculation for repetitive/structured continuations (code, quotes, JSON).
Drafts are verified by the target exactly like model-drafted tokens, so
output is provably unchanged."""

from __future__ import annotations

from collections import defaultdict


class NgramCache:
    """Maps n-gram context tuples (n in [n_min, n_max]) → {next_token: count}."""

    def __init__(self, n_min: int = 2, n_max: int = 4):
        self.n_min = n_min
        self.n_max = n_max
        self._maps: dict[int, dict[tuple, dict[int, int]]] = {
            n: defaultdict(lambda: defaultdict(int))
            for n in range(n_min, n_max + 1)
        }
        self._n_seen = 0

    def update(self, tokens: list[int]) -> None:
        """Index every n-gram in a token stream (idempotent growth)."""
        for n in range(self.n_min, self.n_max + 1):
            m = self._maps[n]
            for i in range(len(tokens) - n):
                m[tuple(tokens[i:i + n])][tokens[i + n]] += 1
        self._n_seen += len(tokens)

    def extend(self, prev_tail: list[int], new_tokens: list[int]) -> None:
        """Incremental update with only the new suffix (prev_tail supplies
        left context of length >= n_max)."""
        self.update(list(prev_tail[-self.n_max:]) + list(new_tokens))

    def _best_next(self, context: list[int]) -> int | None:
        # longest matching n-gram wins; ties by count
        for n in range(self.n_max, self.n_min - 1, -1):
            if len(context) < n:
                continue
            cand = self._maps[n].get(tuple(context[-n:]))
            if cand:
                return max(cand.items(), key=lambda kv: kv[1])[0]
        return None

    def draft(self, context: list[int], k: int) -> list[int]:
        """Propose up to k continuation tokens by chained lookup."""
        ctx = list(context)
        out: list[int] = []
        for _ in range(k):
            t = self._best_next(ctx)
            if t is None:
                break
            out.append(t)
            ctx.append(t)
        return out
