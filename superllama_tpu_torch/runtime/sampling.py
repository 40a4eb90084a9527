"""Sampler chain (counterpart of src/llama-sampling.{h,cpp}; API surface
mirrors include/llama.h:1276-1477).

Host-side numpy implementation operating on the final-token logits; the chain
composes transforms exactly like llama_sampler_chain. A copy of the JAX
package's numpy chain, the grammar sampler included; the engine's decode
blocks sample on the device (``ops/device_sampling.py``), and a request with
a grammar stays on this chain.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


class Sampler:
    """Transforms logits (float32 (V,)) and/or selects a token."""

    def apply(self, logits: np.ndarray, ctx: "SamplerContext") -> np.ndarray:
        return logits

    def accept(self, token: int) -> None:
        pass

    def reset(self) -> None:
        pass


@dataclass
class SamplerContext:
    recent_tokens: list[int] = field(default_factory=list)
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))
    orig_logits: np.ndarray | None = None  # pre-chain logits (grammar rescan)


def _softmax(logits: np.ndarray) -> np.ndarray:
    x = logits - np.max(logits)
    e = np.exp(x)
    return e / e.sum()


# ---------------------------------------------------------------- transforms


@dataclass
class TopK(Sampler):
    k: int

    def apply(self, logits, ctx):
        if self.k <= 0 or self.k >= logits.size:
            return logits
        kth = np.partition(logits, -self.k)[-self.k]
        out = logits.copy()
        out[logits < kth] = -np.inf
        return out


@dataclass
class TopP(Sampler):
    p: float
    min_keep: int = 1

    def apply(self, logits, ctx):
        if self.p >= 1.0:
            return logits
        order = np.argsort(-logits, kind="stable")
        probs = _softmax(logits[order])
        csum = np.cumsum(probs)
        # keep the smallest prefix reaching p (inclusive), at least min_keep
        n_keep = max(int(np.searchsorted(csum, self.p) + 1), self.min_keep)
        out = np.full_like(logits, -np.inf)
        keep = order[:n_keep]
        out[keep] = logits[keep]
        return out


@dataclass
class MinP(Sampler):
    p: float
    min_keep: int = 1

    def apply(self, logits, ctx):
        if self.p <= 0.0:
            return logits
        mx = logits.max()
        # p_tok / p_max >= p  ⇔  logit >= logit_max + log(p)
        thresh = mx + math.log(self.p)
        keep = logits >= thresh
        if keep.sum() < self.min_keep:
            order = np.argsort(-logits, kind="stable")[: self.min_keep]
            keep[:] = False
            keep[order] = True
        out = logits.copy()
        out[~keep] = -np.inf
        return out


@dataclass
class Typical(Sampler):
    p: float
    min_keep: int = 1

    def apply(self, logits, ctx):
        if self.p >= 1.0:
            return logits
        probs = _softmax(logits)
        with np.errstate(divide="ignore"):
            surprise = -np.log(probs)
        valid = np.isfinite(surprise)
        entropy = float(np.sum(probs[valid] * surprise[valid]))
        shifted = np.abs(surprise - entropy)
        order = np.argsort(shifted, kind="stable")
        csum = np.cumsum(probs[order])
        n_keep = max(int(np.searchsorted(csum, self.p) + 1), self.min_keep)
        out = np.full_like(logits, -np.inf)
        keep = order[:n_keep]
        out[keep] = logits[keep]
        return out


@dataclass
class Temperature(Sampler):
    t: float

    def apply(self, logits, ctx):
        if self.t <= 0.0:
            # llama.cpp: temp <= 0 → greedy spike
            out = np.full_like(logits, -np.inf)
            out[int(np.argmax(logits))] = logits.max()
            return out
        return logits / self.t


@dataclass
class TemperatureExt(Sampler):
    """Dynamic-temperature (entropy-scaled) sampler (llama.h temp_ext)."""

    t: float
    delta: float = 0.0
    exponent: float = 1.0

    def apply(self, logits, ctx):
        if self.delta <= 0.0:
            return Temperature(self.t).apply(logits, ctx)
        probs = _softmax(logits)
        nz = probs > 0
        entropy = -np.sum(probs[nz] * np.log(probs[nz]))
        max_entropy = math.log(np.count_nonzero(nz)) if np.count_nonzero(nz) > 1 else 1.0
        norm_entropy = entropy / max_entropy if max_entropy > 0 else 0.0
        dyn_t = (self.t - self.delta) + 2.0 * self.delta * (norm_entropy ** self.exponent)
        return logits / max(dyn_t, 1e-3)


@dataclass
class XTC(Sampler):
    """Exclude-top-choices (llama.h xtc): with probability p, remove every
    token whose prob exceeds the threshold except the least likely of them."""

    p: float
    threshold: float
    min_keep: int = 1
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def apply(self, logits, ctx):
        if self.p <= 0 or self.threshold > 0.5 or self._rng.random() > self.p:
            return logits
        probs = _softmax(logits)
        above = np.flatnonzero(probs >= self.threshold)
        if above.size < 2:
            return logits
        # keep the least probable of the above-threshold set
        keep_last = above[np.argmin(probs[above])]
        out = logits.copy()
        drop = above[above != keep_last]
        out[drop] = -np.inf
        return out


@dataclass
class TopNSigma(Sampler):
    n: float

    def apply(self, logits, ctx):
        if self.n <= 0:
            return logits
        finite = logits[np.isfinite(logits)]
        mx, sd = finite.max(), finite.std()
        out = logits.copy()
        out[logits < mx - self.n * sd] = -np.inf
        return out


@dataclass
class Penalties(Sampler):
    """Repeat/frequency/presence penalties over the last n tokens
    (llama_sampler_init_penalties semantics)."""

    last_n: int = 64
    repeat: float = 1.0
    freq: float = 0.0
    presence: float = 0.0

    def apply(self, logits, ctx):
        if self.last_n == 0 or (self.repeat == 1.0 and self.freq == 0.0 and self.presence == 0.0):
            return logits
        window = ctx.recent_tokens[-self.last_n:] if self.last_n > 0 else ctx.recent_tokens
        if not window:
            return logits
        out = logits.copy()
        toks, counts = np.unique(np.asarray(window, np.int64), return_counts=True)
        sel = out[toks]
        pos = sel > 0
        sel[pos] = sel[pos] / self.repeat
        sel[~pos] = sel[~pos] * self.repeat
        sel -= counts * self.freq + (counts > 0) * self.presence
        out[toks] = sel
        return out


@dataclass
class LogitBias(Sampler):
    bias: dict[int, float]

    def apply(self, logits, ctx):
        if not self.bias:
            return logits
        out = logits.copy()
        for tid, b in self.bias.items():
            if 0 <= tid < out.size:
                out[tid] += b
        return out


@dataclass
class DRY(Sampler):
    """DRY (don't-repeat-yourself) sampler. For each candidate continuation
    token, finds the longest context suffix whose extension by that token
    repeats an earlier subsequence, and penalizes multiplier·base^(len−allowed).
    Sequence-breaker tokens reset matching (llama_sampler_init_dry semantics).
    """

    multiplier: float = 0.0
    base: float = 1.75
    allowed_length: int = 2
    penalty_last_n: int = -1
    seq_breakers: frozenset[int] = frozenset()

    def apply(self, logits, ctx):
        if self.multiplier <= 0.0:
            return logits
        toks = ctx.recent_tokens
        if self.penalty_last_n > 0:
            toks = toks[-self.penalty_last_n:]
        n = len(toks)
        if n < self.allowed_length:
            return logits
        # truncate at the most recent sequence breaker
        start = 0
        for i in range(n - 1, -1, -1):
            if toks[i] in self.seq_breakers:
                start = i + 1
                break
        toks = toks[start:]
        n = len(toks)
        if n < 2:
            return logits
        # match lengths: for each position i<n-1, length of match between
        # suffix ending at n-1 and subsequence ending at i
        max_len: dict[int, int] = {}  # candidate next-token → longest repeat
        for i in range(n - 1):
            if toks[i] != toks[n - 1]:
                continue
            # walk backwards to measure the match length ending here
            L = 0
            while L <= i and toks[i - L] == toks[n - 1 - L]:
                L += 1
            cand = toks[i + 1]
            if L > max_len.get(cand, 0):
                max_len[cand] = L
        out = logits.copy()
        for cand, L in max_len.items():
            if L >= self.allowed_length:
                out[cand] -= self.multiplier * (self.base ** (L - self.allowed_length))
        return out


# ---------------------------------------------------------------- terminal


@dataclass
class Greedy(Sampler):
    def sample(self, logits, ctx) -> int:
        return int(np.argmax(logits))


@dataclass
class Dist(Sampler):
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def sample(self, logits, ctx) -> int:
        probs = _softmax(logits.astype(np.float64))
        return int(self._rng.choice(probs.size, p=probs))

    def reset(self):
        self._rng = np.random.default_rng(self.seed)


@dataclass
class MirostatV2(Sampler):
    tau: float = 5.0
    eta: float = 0.1
    seed: int = 0

    def __post_init__(self):
        self.mu = 2.0 * self.tau
        self._rng = np.random.default_rng(self.seed)

    def sample(self, logits, ctx) -> int:
        probs = _softmax(logits)
        with np.errstate(divide="ignore"):
            surprise = -np.log2(probs)
        keep = surprise <= self.mu
        if not keep.any():
            keep[int(np.argmax(probs))] = True
        p = np.where(keep, probs, 0.0)
        p = p / p.sum()
        tok = int(self._rng.choice(p.size, p=p))
        self.mu -= self.eta * (float(surprise[tok]) - self.tau)
        return tok

    def reset(self):
        self.mu = 2.0 * self.tau
        self._rng = np.random.default_rng(self.seed)


@dataclass
class Mirostat(Sampler):
    """Mirostat v1 (llama_sampler_init_mirostat, llama-sampling.cpp):
    estimates the Zipf exponent ŝ from the top-m probabilities, derives the
    top-k cut from the target surprise μ, then updates μ against the observed
    surprise of the sampled token."""

    n_vocab: int = 32000
    tau: float = 5.0
    eta: float = 0.1
    m: int = 100
    seed: int = 0

    def __post_init__(self):
        self.mu = 2.0 * self.tau
        self._rng = np.random.default_rng(self.seed)

    def sample(self, logits, ctx) -> int:
        probs = _softmax(logits)
        order = np.argsort(-probs)
        p_sorted = probs[order]
        mm = min(self.m - 1, p_sorted.size - 1)
        i = np.arange(mm, dtype=np.float64)
        t_i = np.log((i + 2.0) / (i + 1.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            b_i = np.log(p_sorted[:mm] / np.maximum(p_sorted[1:mm + 1], 1e-30))
        s_hat = float((t_i * b_i).sum() / (t_i * t_i).sum())
        eps = s_hat - 1.0
        k = ((eps * 2.0 ** self.mu)
             / (1.0 - float(self.n_vocab) ** -eps)) ** (1.0 / s_hat)
        k = max(int(k), 1)
        keep = p_sorted[:k]
        keep = keep / keep.sum()
        idx = int(self._rng.choice(keep.size, p=keep.astype(np.float64)
                                   / keep.astype(np.float64).sum()))
        tok = int(order[idx])
        observed = -np.log2(max(float(keep[idx]), 1e-30))
        self.mu -= self.eta * (observed - self.tau)
        return tok

    def reset(self):
        self.mu = 2.0 * self.tau
        self._rng = np.random.default_rng(self.seed)


@dataclass
class AdaptiveP(Sampler):
    """adaptive-p (llama_sampler_init_adaptive_p, llama-sampling.cpp:3289):
    tracks an EMA of the ORIGINAL probabilities of accepted tokens and
    re-peaks the distribution around an adapted target probability —
    quadratic near the target, linear in the tails."""

    target: float = 0.5
    decay: float = 0.9
    seed: int = 0

    _WIDTH, _PEAK, _SHARP = 0.3, 5.0, 10.0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.weighted_sum = self.target / (1.0 - self.decay)
        self.total_weight = 1.0 / (1.0 - self.decay)
        self._pending: tuple[int, float] | None = None

    def sample(self, logits, ctx) -> int:
        probs = _softmax(logits)
        if self.target < 0.0:   # disabled → plain dist
            p64 = probs.astype(np.float64)
            return int(self._rng.choice(probs.size, p=p64 / p64.sum()))
        target = float(np.clip(self.target, 0.0, 1.0))
        adapted = float(np.clip(
            target if self.total_weight == 0.0
            else 2.0 * target - self.weighted_sum / self.total_weight,
            0.0, 1.0))
        dist = np.abs((probs - adapted) / self._WIDTH)
        new_logits = np.where(
            np.isneginf(logits), -np.inf,
            self._PEAK - self._SHARP * dist * dist / (1.0 + dist))
        p2 = _softmax(new_logits.astype(np.float32))
        tok = int(self._rng.choice(p2.size, p=p2.astype(np.float64)
                                   / p2.astype(np.float64).sum()))
        self._pending = (tok, float(probs[tok]))
        return tok

    def accept(self, token: int) -> None:
        if self._pending is not None and self._pending[0] == token:
            self.weighted_sum = self._pending[1] + self.decay * self.weighted_sum
            self.total_weight = 1.0 + self.decay * self.total_weight
        self._pending = None

    def reset(self):
        self.__post_init__()


class Infill(Sampler):
    """Fill-in-middle sampler (llama_sampler_init_infill,
    llama-sampling.cpp): biases toward EOG when text probability mass is
    weak, merges candidates sharing a byte prefix, drops sub-threshold
    non-EOG candidates, and falls back to EOT when nothing textual remains.
    Operates on the top candidates (the reference runs after truncation)."""

    def __init__(self, pieces: list[bytes], eog_ids: set[int],
                 eot_id: int | None = None, seed: int = 0,
                 n_candidates: int = 64):
        self.pieces = pieces
        self.eog_ids = eog_ids
        self.eot_id = eot_id if eot_id is not None else (
            next(iter(eog_ids)) if eog_ids else 0)
        self.n_candidates = n_candidates
        self._rng = np.random.default_rng(seed)
        self._seed = seed

    def sample(self, logits, ctx) -> int:
        probs = _softmax(logits)
        finite = np.isfinite(logits)
        cand = np.argsort(-np.where(finite, probs, -1.0))[:self.n_candidates]
        cand = [int(c) for c in cand if finite[c]]
        p = {c: float(probs[c]) for c in cand}
        is_eog = {c: c in self.eog_ids for c in cand}
        p_txt = sum(v for c, v in p.items() if not is_eog[c])
        p_eog = sum(v for c, v in p.items() if is_eog[c])
        if 3.0 * p_eog * len(cand) > p_txt:
            keep = {c: v for c, v in p.items() if is_eog[c]}
        else:
            # merge tokens whose piece is a byte-prefix of another candidate
            alive = dict(p)
            for c0 in cand:
                for c1 in cand:
                    if c0 == c1 or c0 not in alive or c1 not in alive:
                        continue
                    b0, b1 = self.pieces[c0], self.pieces[c1]
                    if b0 and len(b0) <= len(b1) and b1[:len(b0)] == b0:
                        dst, src = (c0, c1) if alive[c0] >= alive[c1] else (c1, c0)
                        alive[dst] += alive[src]
                        del alive[src]
            thold = 0.2
            keep = {c: v for c, v in alive.items()
                    if v >= thold or is_eog.get(c, False)}
            if not any(not is_eog.get(c, False) for c in keep):
                return self.eot_id
        tot = sum(keep.values())
        ids = list(keep)
        pv = np.asarray([keep[c] / tot for c in ids], np.float64)
        return int(ids[self._rng.choice(len(ids), p=pv / pv.sum())])

    def reset(self):
        self._rng = np.random.default_rng(self._seed)


class GrammarSampler(Sampler):
    """Constrained decoding against a GBNF grammar (llama_sampler_init_grammar
    / _lazy_patterns counterpart, include/llama.h:1370-1392).

    Masks candidate tokens whose UTF-8 pieces the grammar rejects. For
    efficiency the transform only tests candidates still finite after earlier
    chain stages; if all of those are rejected it rescans the full vocab in
    descending-logit order. ``lazy`` grammars stay dormant until a trigger
    pattern (regex over emitted text) or trigger token appears.
    """

    def __init__(self, grammar, pieces: list[bytes], eos_ids: set[int],
                 lazy: bool = False, trigger_patterns: list[str] | None = None,
                 trigger_tokens: set[int] | None = None):
        from ..grammar.gbnf import Grammar, GrammarState, parse_gbnf
        if isinstance(grammar, str):
            grammar = parse_gbnf(grammar)
        self.grammar: "Grammar" = grammar
        self.pieces = pieces
        self.eos_ids = eos_ids
        self.lazy = lazy
        self.trigger_res = [re.compile(p) for p in (trigger_patterns or [])]
        self.trigger_tokens = trigger_tokens or set()
        self._GrammarState = GrammarState
        # first codepoint of each piece (None = empty or partial UTF-8): a
        # cheap pre-filter — a token can only be legal if some stack's top
        # char atom matches its first codepoint
        self._first_cp: list[int | None] = []
        for p in pieces:
            try:
                s = p.decode("utf-8")
                self._first_cp.append(ord(s[0]) if s else None)
            except UnicodeDecodeError:
                self._first_cp.append(None)
        self.reset()

    def reset(self):
        self.state = self._GrammarState(self.grammar)
        self.active = not self.lazy
        self._emitted = ""

    def _allowed(self, tid: int) -> bool:
        if tid in self.eos_ids:
            return self.state.can_terminate
        piece = self.pieces[tid]
        if not piece:
            return False
        cp = self._first_cp[tid]
        if cp is not None and not self.state._partial:
            from ..grammar.gbnf import _matches
            if not any(st and _matches(st[-1], cp) for st in self.state.stacks):
                return False
        return self.state.would_accept(piece)

    def apply(self, logits, ctx):
        if not self.active or not self.state.alive:
            return logits
        out = logits.copy()
        cand = np.flatnonzero(np.isfinite(logits))
        any_ok = False
        for tid in cand:
            if self._allowed(int(tid)):
                any_ok = True
            else:
                out[tid] = -np.inf
        if not any_ok:
            # earlier stages cut away every grammar-legal token: rescan the
            # full vocab against the pre-chain logits (resampling semantics
            # of common_sampler_sample grammar_first=false)
            base = logits
            if ctx is not None and ctx.orig_logits is not None:
                base = ctx.orig_logits
            order = np.argsort(base)[::-1]
            for tid in order:
                if self._allowed(int(tid)):
                    out[tid] = 0.0  # sole survivor
                    return out
            # dead grammar: allow EOS so generation stops
            for tid in self.eos_ids:
                out[tid] = 0.0
        return out

    def accept(self, token: int):
        if self.active:
            if token not in self.eos_ids:
                self.state.accept_bytes(self.pieces[token])
            return
        if not self.lazy:
            return
        if token in self.trigger_tokens:
            self.active = True
            return
        try:
            self._emitted += self.pieces[token].decode("utf-8", errors="ignore")
        except IndexError:
            return
        for cre in self.trigger_res:
            m = cre.search(self._emitted)
            if m:
                self.active = True
                # feed the grammar everything from the trigger start
                self.state.accept_text(self._emitted[m.start():])
                return


class SamplerChain:
    """llama_sampler_chain counterpart: ordered transforms + terminal picker."""

    def __init__(self, samplers: Sequence[Sampler], seed: int = 0):
        self.samplers = list(samplers)
        self.ctx = SamplerContext(rng=np.random.default_rng(seed))

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, np.float32).reshape(-1)
        self.ctx.orig_logits = logits
        tok = None
        for s in self.samplers:
            if hasattr(s, "sample"):
                tok = s.sample(logits, self.ctx)
                break
            logits = s.apply(logits, self.ctx)
        if tok is None:
            tok = int(np.argmax(logits))
        self.accept(tok)
        return tok

    def accept(self, token: int) -> None:
        self.ctx.recent_tokens.append(token)
        for s in self.samplers:
            s.accept(token)

    def reset(self) -> None:
        self.ctx.recent_tokens.clear()
        for s in self.samplers:
            s.reset()


def make_chain(
    *, seed: int = 0, temp: float = 1.0, dynatemp_range: float = 0.0,
    dynatemp_exponent: float = 1.0, top_k: int = 40, top_p: float = 0.95,
    min_p: float = 0.05, typical_p: float = 1.0, xtc_probability: float = 0.0,
    xtc_threshold: float = 0.1, top_n_sigma: float = -1.0,
    penalty_last_n: int = 64, penalty_repeat: float = 1.0,
    penalty_freq: float = 0.0, penalty_present: float = 0.0,
    dry_multiplier: float = 0.0, dry_base: float = 1.75,
    dry_allowed_length: int = 2, dry_penalty_last_n: int = -1,
    mirostat: int = 0, mirostat_tau: float = 5.0, mirostat_eta: float = 0.1,
    logit_bias: dict[int, float] | None = None, greedy: bool = False,
    n_vocab: int = 32000,
    adaptive_p_target: float = -1.0, adaptive_p_decay: float = 0.9,
) -> SamplerChain:
    """Build the default chain in the reference's standard order
    (common/sampling.cpp: penalties → dry → top-n-sigma/top-k/typ/top-p/min-p
    /xtc → temp → dist)."""
    chain: list[Sampler] = []
    if logit_bias:
        chain.append(LogitBias(logit_bias))
    chain.append(Penalties(penalty_last_n, penalty_repeat, penalty_freq, penalty_present))
    if dry_multiplier > 0:
        chain.append(DRY(dry_multiplier, dry_base, dry_allowed_length, dry_penalty_last_n))
    if greedy or temp <= 0.0:
        chain.append(Greedy())
        return SamplerChain(chain, seed)
    if mirostat == 1:
        chain.append(Temperature(temp))
        chain.append(Mirostat(n_vocab, mirostat_tau, mirostat_eta,
                              100, seed))
        return SamplerChain(chain, seed)
    if mirostat == 2:
        chain.append(Temperature(temp))
        chain.append(MirostatV2(mirostat_tau, mirostat_eta, seed))
        return SamplerChain(chain, seed)
    if adaptive_p_target >= 0.0:
        # recommended chain: mild min-p truncation then adaptive-p terminal
        chain += [MinP(min_p), Temperature(temp),
                  AdaptiveP(adaptive_p_target, adaptive_p_decay, seed)]
        return SamplerChain(chain, seed)
    if top_n_sigma > 0:
        chain += [TopK(top_k), Temperature(temp), TopNSigma(top_n_sigma)]
    else:
        chain.append(TopK(top_k))
        if typical_p < 1.0:
            chain.append(Typical(typical_p))
        chain.append(TopP(top_p))
        chain.append(MinP(min_p))
        if xtc_probability > 0:
            chain.append(XTC(xtc_probability, xtc_threshold, seed=seed))
        if dynatemp_range > 0:
            chain.append(TemperatureExt(temp, dynatemp_range, dynatemp_exponent))
        else:
            chain.append(Temperature(temp))
    chain.append(Dist(seed))
    return SamplerChain(chain, seed)
