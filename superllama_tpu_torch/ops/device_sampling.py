"""On-device sampling: the whole-batch sampler of ``DecodeLoop`` and the
per-row sampler chain of the engine's decode block (the reference's
"backend sampling", llama.h:1021/1270: sampling inside the device's step so
the per-token loop never leaves the device).

Counterpart of the JAX package's ``ops/device_sampling.py``. Every function
is a plain tensor function on its inputs' device with no host sync: no
``.item()``, no ``nonzero``, no boolean indexing, no data-dependent shape,
so a CUDA graph can capture a block of steps and replay it.

Random bits are threefry2x32 as ``jax.random`` draws them (raw ``uint32[2]``
keys, ``jax_threefry_partitionable`` bits), written as int64 tensor ops
masked to 32 bits: the same seed gives the JAX package's tokens. Keys are
(..., 2) int64 tensors holding the two 32-bit words.

Ties: ``lax.top_k`` and ``jnp.argmax`` put the lower index first. The port
keeps that rule everywhere: the chain's candidates come from a stable
descending sort (equal logits keep index order, on the CPU and on CUDA),
``torch.argmax`` returns the first maximum, the typical stage sorts stably.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


# ------------------------------------------------------------ random bits


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of counter words (x1, x2) under key
    words (k1, k2); int64 tensors holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = (((b << r) | (b >> (32 - r))) & _M32) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """The raw key of an integer seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of (..., 2) keys with integer data (a tensor
    broadcast against keys[..., 0], or an int): threefry of the counter
    (0, data)."""
    k1, k2 = keys[..., 0], keys[..., 1]
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = torch.full_like(k1, int(data) & _M32)
    a, b = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([a, b], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one (2,) key into (num, 2) keys."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """32-bit random bits of (..., 2) keys: one word per key (``n`` None,
    jax's shape ()) or n words per key (shape (n,)), as ``bits1 ^ bits2``
    of threefry over the (hi, lo) words of each element's flat index."""
    k1, k2 = keys[..., 0], keys[..., 1]
    if n is None:
        zero = torch.zeros_like(k1)
        a, b = threefry2x32(k1, k2, zero, zero)
    else:
        lo = torch.arange(n, dtype=torch.int64, device=keys.device)
        a, b = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(lo), lo)
    return a ^ b


def uniform(keys: torch.Tensor, n: int | None = None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) of each key at shape () or (n,): the
    random bits' top 23 as the mantissa of a float in [1, 2), less 1, scaled
    to [minval, maxval) and clamped below at minval."""
    bits = random_bits(keys, n)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - torch.ones((), dtype=torch.float32, device=bits.device))
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses f·(hi - lo) + lo into one fused multiply-add: the product is
    # exact in float64, so the sum there rounds (almost always) as the FMA
    scaled = (f.to(torch.float64) * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp(scaled, min=float(lo))


# ------------------------------------------------------------ plain sampling


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) → (B,) int64: the first maximum of each row."""
    return torch.argmax(logits, dim=-1)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis (exp(x - max) / sum)."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return _f32(float("-inf"), like)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` of (B, V) float32 logits under one (2,)
    key: the argmax of logits plus Gumbel noise (mode "low")."""
    B, V = logits.shape
    u = uniform(key, B * V, _F32_TINY, 1.0).reshape(B, V)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample(logits: torch.Tensor, key: torch.Tensor | None, *, temp: float = 1.0,
           top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0) -> torch.Tensor:
    """One token per row of (B, V) logits (int64 (B,)); temp <= 0 is greedy
    and needs no key."""
    lf = logits.to(torch.float32)
    if temp <= 0.0:
        return greedy(lf)
    ninf = _neg_inf(lf)
    if top_k > 0:
        thresh = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < thresh, ninf, lf)
    if min_p > 0.0:
        mx = torch.amax(lf, dim=-1, keepdim=True)
        lf = torch.where(lf < mx + torch.log(_f32(min_p, lf)), ninf, lf)
    if top_p < 1.0:
        sorted_l = torch.sort(lf, dim=-1, descending=True, stable=True).values
        probs = _softmax(sorted_l)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        thresh = torch.amin(torch.where(keep, sorted_l, _f32(float("inf"), lf)),
                            dim=-1, keepdim=True)
        lf = torch.where(lf < thresh, ninf, lf)
    return categorical(key, lf / _f32(temp, lf))


# --------------------------------------------------------------------------
# Per-row parameterized sampler chain of the engine's decode block: every
# parameter is a (B,) tensor, so slots with different settings share one
# captured block. Chain order as in runtime/sampling.py make_chain: logit
# bias → penalties → top-k → typical → top-p → min-p → XTC → temperature
# (static or dynamic) → top-n-σ → dist.
#
# The cutting stages work on the top N_CAND candidates: exact whenever the
# row's top_k ≤ N_CAND (llama.cpp's default top_k is 40). Rows with
# top_k == 0 are treated as top_k = N_CAND; the host chain remains the
# full-distribution reference.

N_CAND = 128   # candidates surviving to the cutting stages
RING = 64      # recent-token window for penalties (llama.cpp's default)
N_BIAS = 16    # most logit-bias entries of a row on the device chain

_UNSUPPORTED = ("dry_multiplier", "mirostat")


def chain_supported(cfg: dict) -> bool:
    """True when the sampling config is expressible by the device chain
    (everything except the stateful DRY / mirostat / adaptive-p samplers and
    more than N_BIAS bias entries)."""
    for k in _UNSUPPORTED:
        if cfg.get(k):
            return False
    if cfg.get("adaptive_p_target", -1.0) >= 0.0:
        return False
    if len(cfg.get("logit_bias") or {}) > N_BIAS:
        return False
    return True


def chain_params(rows: list[dict | None], n_vocab: int) -> dict:
    """The per-row parameter arrays (numpy) of request sampling configs.

    ``rows[i] is None`` is an inert row (greedy, no penalties): the engine
    fills idle slots so. Raises ValueError for a config the chain cannot
    express (gate with :func:`chain_supported`)."""
    B = len(rows)
    p = {
        "temp": np.zeros(B, np.float32),
        "top_k": np.full(B, N_CAND, np.int32),
        "top_p": np.ones(B, np.float32),
        "min_p": np.zeros(B, np.float32),
        "pen_repeat": np.ones(B, np.float32),
        "pen_freq": np.zeros(B, np.float32),
        "pen_present": np.zeros(B, np.float32),
        "pen_last_n": np.zeros(B, np.int32),
        "bias_ids": np.full((B, N_BIAS), -1, np.int32),
        "bias_vals": np.zeros((B, N_BIAS), np.float32),
        "typ_p": np.ones(B, np.float32),
        "xtc_p": np.zeros(B, np.float32),
        "xtc_thr": np.full(B, 0.1, np.float32),
        "dynatemp_range": np.zeros(B, np.float32),
        "dynatemp_exp": np.ones(B, np.float32),
        "n_sigma": np.full(B, -1.0, np.float32),
    }
    for i, cfg in enumerate(rows):
        if cfg is None:
            continue
        if not chain_supported(cfg):
            raise ValueError(f"row {i}: config not expressible by the device chain")
        if cfg.get("greedy") or cfg.get("temp", 1.0) <= 0.0:
            p["temp"][i] = 0.0
        else:
            p["temp"][i] = cfg.get("temp", 1.0)
        tk = int(cfg.get("top_k", 40))
        p["top_k"][i] = tk if 0 < tk <= N_CAND else N_CAND
        p["top_p"][i] = cfg.get("top_p", 0.95)
        p["min_p"][i] = cfg.get("min_p", 0.05)
        p["pen_repeat"][i] = cfg.get("penalty_repeat", 1.0)
        p["pen_freq"][i] = cfg.get("penalty_freq", 0.0)
        p["pen_present"][i] = cfg.get("penalty_present", 0.0)
        n = int(cfg.get("penalty_last_n", 64))
        p["pen_last_n"][i] = min(n, RING) if n >= 0 else RING
        p["typ_p"][i] = cfg.get("typical_p", 1.0)
        p["xtc_p"][i] = cfg.get("xtc_probability", 0.0)
        p["xtc_thr"][i] = cfg.get("xtc_threshold", 0.1)
        p["dynatemp_range"][i] = cfg.get("dynatemp_range", 0.0)
        p["dynatemp_exp"][i] = cfg.get("dynatemp_exponent", 1.0)
        ns = cfg.get("top_n_sigma", -1.0)
        p["n_sigma"][i] = ns if ns and ns > 0 else -1.0
        if ns and ns > 0:
            # the host chain's top-n-sigma branch is top-k → temp → nσ and
            # skips typical/top-p/min-p/xtc (make_chain): mirror that
            p["typ_p"][i] = 1.0
            p["top_p"][i] = 1.0
            p["min_p"][i] = 0.0
            p["xtc_p"][i] = 0.0
        for j, (tid, b) in enumerate((cfg.get("logit_bias") or {}).items()):
            if 0 <= int(tid) < n_vocab:
                p["bias_ids"][i, j] = int(tid)
                p["bias_vals"][i, j] = float(b)
    return p


def chain_tensors(params: dict, device) -> dict:
    """chain_params' arrays as tensors on ``device`` (integer ones int64)."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64
                                      if v.dtype.kind == "i" else torch.float32)
            for k, v in params.items()}


def chain_noise(keys: torch.Tensor, counts: torch.Tensor, n_steps: int):
    """The uniforms of n_steps chain steps: step i of row b draws from the
    key fold_in(keys[b], counts[b] + i), as the JAX package's decode block.
    Returns (u_xtc (B, n_steps), u_gumbel (B, n_steps, N_CAND))."""
    steps = counts.to(torch.int64)[:, None] + torch.arange(
        n_steps, dtype=torch.int64, device=counts.device)[None, :]
    k = fold_in(keys[:, None, :], steps)
    u_xtc = uniform(fold_in(k, 7))
    u_gumbel = uniform(k, N_CAND, 1e-7, 1.0 - 1e-7)
    return u_xtc, u_gumbel


def chain_step_core(logits: torch.Tensor, ring: torch.Tensor, p: dict,
                    u_xtc: torch.Tensor, u_gumbel: torch.Tensor):
    """One chain application with its uniforms given: (B, V) float32 logits
    → (B,) int64 tokens and the updated ring.

    ``ring`` (B, RING) int64: recent tokens, the most recent in the last
    column, -1 empty. ``u_xtc`` (B,) decides whether XTC fires, ``u_gumbel``
    (B, N_CAND) is the noise of the Gumbel-max draw."""
    B, V = logits.shape
    dev = logits.device
    ninf = _neg_inf(logits)
    zero = _f32(0.0, logits)
    lf = logits.to(torch.float32)

    # logit bias (sparse per-row adds; absent entries add 0 at index 0)
    bid = torch.clamp(p["bias_ids"], min=0)
    bval = torch.where(p["bias_ids"] >= 0, p["bias_vals"], zero)
    lf = lf.scatter_add(1, bid, bval)

    # penalties over the ring window (llama_sampler_init_penalties semantics)
    age = (RING - 1 - torch.arange(RING, device=dev))[None, :]
    valid = (ring >= 0) & (age < p["pen_last_n"][:, None])
    counts = torch.zeros((B, V), dtype=torch.float32, device=dev).scatter_add(
        1, torch.clamp(ring, min=0), valid.to(torch.float32))
    hit = counts > 0
    rep = p["pen_repeat"][:, None]
    lf = torch.where(hit, torch.where(lf > 0, lf / rep, lf * rep), lf)
    lf = lf - (counts * p["pen_freq"][:, None]
               + hit.to(torch.float32) * p["pen_present"][:, None])

    # cutting stages over the top-N_CAND candidates (lower index first on ties)
    vals, idx = torch.sort(lf, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :N_CAND], idx[:, :N_CAND]
    rank = torch.arange(N_CAND, device=dev)[None, :]
    vals = torch.where(rank < p["top_k"][:, None], vals, ninf)

    # locally typical: keep the smallest-|surprise - entropy| set with
    # cumulative probability >= typ_p; inert when typ_p >= 1
    probs = _softmax(vals)
    finite = torch.isfinite(vals)
    surprise = torch.where(finite, -torch.log(torch.clamp(probs, min=1e-30)),
                           _f32(float("inf"), logits))
    entropy = torch.sum(torch.where(finite, probs * surprise, zero), dim=-1, keepdim=True)
    sh_idx = torch.argsort(torch.abs(surprise - entropy), dim=-1, stable=True)
    p_ord = torch.gather(probs, 1, sh_idx)
    keep_ord = (torch.cumsum(p_ord, dim=-1) - p_ord) < p["typ_p"][:, None]
    keep_typ = torch.zeros((B, N_CAND), dtype=torch.bool, device=dev).scatter(
        1, sh_idx, keep_ord)
    vals = torch.where(keep_typ, vals, ninf)

    # top-p, then min-p against the rank-0 value
    probs = _softmax(vals)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    vals = torch.where(cum_before < p["top_p"][:, None], vals, ninf)
    min_p = p["min_p"][:, None]
    minp = torch.where(min_p > 0,
                       vals[:, :1] + torch.log(torch.clamp(min_p, min=1e-30)), ninf)
    vals = torch.where(vals >= minp, vals, ninf)

    # XTC: with probability xtc_p drop every token whose probability is at
    # least the threshold, except the least likely of them
    probs = _softmax(vals)
    above = probs >= p["xtc_thr"][:, None]
    n_above = torch.sum(above, dim=-1, keepdim=True)
    last_above = torch.amax(torch.where(above, rank, torch.full_like(rank, -1)),
                            dim=-1, keepdim=True)
    xtc_p = p["xtc_p"][:, None]
    fire = ((xtc_p > 0.0) & (u_xtc[:, None] < xtc_p)
            & (p["xtc_thr"][:, None] <= 0.5) & (n_above >= 2))
    vals = torch.where(fire & above & (rank < last_above), ninf, vals)

    # temperature: static, or scaled by the candidates' normalized entropy
    temp = p["temp"][:, None]
    probs = _softmax(vals)
    finite = torch.isfinite(vals)
    ent = -torch.sum(torch.where(finite, probs * torch.log(torch.clamp(probs, min=1e-30)),
                                 zero), dim=-1, keepdim=True)
    n_fin = torch.sum(finite, dim=-1, keepdim=True).to(torch.float32)
    max_ent = torch.where(n_fin > 1, torch.log(torch.clamp(n_fin, min=2.0)),
                          _f32(1.0, logits))
    norm_ent = torch.where(max_ent > 0, ent / max_ent, zero)
    delta = p["dynatemp_range"][:, None]
    dyn_t = (temp - delta) + 2.0 * delta * norm_ent ** p["dynatemp_exp"][:, None]
    eff_t = torch.where(delta > 0.0, torch.clamp(dyn_t, min=1e-3), temp)
    scaled = vals / torch.clamp(eff_t, min=1e-6)

    # top-n-sigma after the temperature (the host chain's nσ branch order)
    ns = p["n_sigma"][:, None]
    n_div = torch.clamp(n_fin, min=1.0)
    mean_s = torch.sum(torch.where(finite, scaled, zero), -1, keepdim=True) / n_div
    var_s = torch.sum(torch.where(finite, (scaled - mean_s) ** 2, zero), -1,
                      keepdim=True) / n_div
    max_s = torch.amax(torch.where(finite, scaled, ninf), -1, keepdim=True)
    sig_cut = max_s - ns * torch.sqrt(var_s)
    scaled = torch.where((ns > 0.0) & (scaled < sig_cut), ninf, scaled)

    # dist: Gumbel-max over the survivors; temp <= 0 takes rank 0 (greedy)
    j_samp = torch.argmax(scaled - torch.log(-torch.log(u_gumbel)), dim=-1)
    j = torch.where(p["temp"] > 0, j_samp, torch.zeros_like(j_samp))
    tok = torch.gather(idx, 1, j[:, None])[:, 0]
    return tok, torch.cat([ring[:, 1:], tok[:, None]], dim=1)


def chain_step(logits: torch.Tensor, ring: torch.Tensor, keys: torch.Tensor,
               p: dict):
    """One chain application with the uniforms drawn from (B, 2) row keys
    (the JAX package's ``chain_step``): (tokens (B,), ring)."""
    u_xtc = uniform(fold_in(keys, 7))
    u_gumbel = uniform(keys, N_CAND, 1e-7, 1.0 - 1e-7)
    return chain_step_core(logits, ring, p, u_xtc, u_gumbel)
