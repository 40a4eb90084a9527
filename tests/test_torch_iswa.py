"""The iSWA two-tier cache of the port against the JAX package, on the CPU
(the map: tests/test_iswa.py):

 - ``iswa_layer_split``, ``iswa_swa_seq``, ``kv_ring_slots``,
   ``kv_ring_advance`` and ``iswa_truncate_pos`` against the JAX functions;
 - ``llama_forward`` on an ``ISWACache`` (a 16-token window, a 128-slot
   ring) in several chunks past the window and around the ring, on the plain
   path and with ``flash=True`` (``fa``'s plain version over each tier),
   against the JAX forward on its ``ISWACache``, for gemma2 (window on
   layers 0 and 2) and cohere2 (layers 0-2, rope only there); a wave of two
   rows with padding; a rollback by position against a fresh replay;
 - ``Context`` turning iSWA on by itself, its ubatch-headroom and quantized
   refusals; ``cache_policy``'s dispatch;
 - the Engine: the ring it builds, greedy tokens against the JAX iSWA
   Engine past the window and around the ring (a wave of two, then a slot
   reused), the prefix-reuse guard of the ring's wrap, slot save / restore /
   erase (its own snapshots through ``np.savez``, and the JAX engine's),
   each incompatible mode's ``ValueError`` and its default off, the
   warm-up's in-place chunk keys replayed.

Tolerances: logits to rtol = atol = 1e-4 (f32 weights and caches, the
architecture parity tests' ARCH_TOL); tokens, positions, slots and cursors
equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.models import load_model as jax_load
from superllama_tpu.models.llama import llama_forward as jax_forward
from superllama_tpu.models.synthetic import tiny_test_hparams as jax_tiny_hparams
from superllama_tpu.runtime import kv_cache as JK
from superllama_tpu.runtime.context import Context as JaxContext
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models.llama import llama_forward
from superllama_tpu_torch.models.synthetic import tiny_test_hparams
from superllama_tpu_torch.runtime import cache_policy
from superllama_tpu_torch.runtime import kv_cache as TK
from superllama_tpu_torch.runtime.context import Context
from superllama_tpu_torch.runtime.engine import Engine
from test_torch_fixtures import (ARCH_TOL, N_VOCAB, arch_spec, byte_vocab_fields,  # noqa: F401
                                 dense_spec, prompt, torch_one_thread, write_arch_gguf)
from test_torch_prefix_reuse import _Rerun, fake_graphs  # noqa: F401 (a fixture)

WINDOW = 16
N_CTX = 256
UBATCH = 32              # the forward tests' ring: iswa_swa_seq(16, 32, 256) = 128
BUCKETS = (16, 64)       # the engines' ring: iswa_swa_seq(16, 64, 256) = 128
ARCHS = ("gemma2", "cohere2")


def _spec(arch: str):
    """A tiny SWA model of ``arch`` over the byte vocab: gemma2 at 4 layers
    (window on 0 and 2, softcaps), cohere2's reference spec (window on 0-2,
    rope there only); a 16-token window."""
    if arch == "gemma2":
        return dense_spec("gemma2", tied=True, D=32, post_norms=True, L=4, V=N_VOCAB,
                          md={"attention.sliding_window": WINDOW,
                              "attn_logit_softcapping": 5.0,
                              "final_logit_softcapping": 3.0, "attention.scale": 0.2})
    name, md, tensors = arch_spec(arch)
    tensors = {**tensors, "token_embd.weight": tensors["token_embd.weight"][:N_VOCAB]}
    return name, {**md, "vocab_size": N_VOCAB, "attention.sliding_window": WINDOW}, tensors


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("iswa")
    out = {}
    for arch in ARCHS:
        name, md, tensors = _spec(arch)
        path = write_arch_gguf(d / f"{arch}.gguf", name, md, tensors,
                               vocab_fields=byte_vocab_fields())
        out[arch] = (jax_load(path), load_model(path, device="cpu"))
    return out


# ------------------------------------------------------------ the tier's functions


@pytest.mark.parametrize("kw", [dict(n_layer=4, swa_window=16, swa_pattern=2),
                                dict(n_layer=8, swa_window=16, swa_pattern=6),
                                dict(n_layer=4, swa_window=16, swa_pattern=4),
                                dict(n_layer=4, swa_window=0, swa_pattern=2)],
                         ids=["pattern2", "pattern6", "pattern4", "no-window"])
def test_layer_split_matches_jax(kw):
    assert TK.iswa_layer_split(tiny_test_hparams(**kw)) == JK.iswa_layer_split(
        jax_tiny_hparams(**kw))


def test_layer_split_of_an_explicit_pattern():
    hp, jhp = tiny_test_hparams(n_layer=4, swa_window=8), jax_tiny_hparams(n_layer=4, swa_window=8)
    hp.extra["swa_layers"] = jhp.extra["swa_layers"] = [True, False, False, True]
    assert TK.iswa_layer_split(hp) == JK.iswa_layer_split(jhp) == ([1, 2], [0, 3])


@pytest.mark.parametrize("args", [(16, 32, 256), (16, 64, 256), (4096, 512, 8192),
                                  (4096, 2048, 131072), (5, 512, 32), (100, 28, 100)])
def test_swa_seq_matches_jax(args):
    assert TK.iswa_swa_seq(*args) == JK.iswa_swa_seq(*args)


@pytest.mark.parametrize("S", [128, 4352])
def test_ring_slots_match_jax(S):
    pos = np.random.default_rng(S).integers(-1, 3 * S, (3, 40)).astype(np.int32)
    got = TK.kv_ring_slots(torch.from_numpy(pos), S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JK.kv_ring_slots(jnp.asarray(pos), S)))


def _rand_tier(rng, B: int, S: int, L: int = 2, H: int = 2, D: int = 8):
    """A JAX KVCache and the port's with the same random K / V, positions
    (-1 holes) and cursors."""
    k = rng.standard_normal((L, B, H, S, D)).astype(np.float32)
    v = rng.standard_normal((L, B, H, S, D)).astype(np.float32)
    pos = np.where(rng.random((B, S)) < 0.3, -1, rng.integers(0, 4 * S, (B, S))).astype(np.int32)
    cursor = rng.integers(0, 4 * S, B).astype(np.int32)
    j = JK.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), pos=jnp.asarray(pos),
                   cursor=jnp.asarray(cursor))
    t = TK.kv_cache_init(L, B, S, H, D, dtype=torch.float32)
    t.k[:, :, :, :S] = torch.from_numpy(k)
    t.v[:, :, :, :S] = torch.from_numpy(v)
    t.pos[:, :S] = torch.from_numpy(pos)
    t.cursor[:] = torch.from_numpy(cursor)
    return j, t


@pytest.mark.parametrize("padded", [False, True], ids=["full-rows", "padding"])
def test_ring_advance_matches_jax(padded):
    rng = np.random.default_rng(int(padded))
    S = 64
    jc, tc = _rand_tier(rng, 3, S)
    pos = (100 + np.arange(20, dtype=np.int32))[None].repeat(3, 0)
    if padded:
        pos[1, 12:] = -1
        pos[2, :] = -1
    jslots = JK.kv_ring_slots(jnp.asarray(pos), S)
    j = JK.kv_ring_advance(jc, jslots, jnp.asarray(pos))
    tslots = TK.kv_ring_slots(torch.from_numpy(pos), S)
    t = TK.kv_ring_advance(tc, tslots, torch.from_numpy(pos))
    assert t is tc                              # in place
    np.testing.assert_array_equal(t.pos[:, :S].numpy(), np.asarray(j.pos))
    np.testing.assert_array_equal(t.cursor.numpy(), np.asarray(j.cursor))


@pytest.mark.parametrize("keep", [[0, 50, 300], [7, 7, 7]])
def test_truncate_pos_matches_jax(keep):
    rng = np.random.default_rng(sum(keep))
    (jf, tf), (js, ts) = _rand_tier(rng, 3, 96), _rand_tier(rng, 3, 32)
    j = JK.iswa_truncate_pos(JK.ISWACache(full=jf, swa=js), jnp.asarray(keep, jnp.int32))
    tc = TK.ISWACache(full=tf, swa=ts)
    t = cache_policy.truncate_rows(tc, torch.tensor(keep, dtype=torch.int32))
    assert t is tc
    for tier, jt in (("full", j.full), ("swa", j.swa)):
        got = getattr(t, tier)
        np.testing.assert_array_equal(got.pos[:, :got.max_seq].numpy(), np.asarray(jt.pos))
        np.testing.assert_array_equal(got.cursor.numpy(), np.asarray(jt.cursor))


# --------------------------------------------------------------- the forward


def _caches(jm, tm, B: int = 1):
    jc = JK.iswa_cache_init(jm.hparams, B, N_CTX, n_ubatch=UBATCH, dtype=jnp.float32)
    tc = TK.iswa_cache_init(tm.hparams, B, N_CTX, n_ubatch=UBATCH, dtype=torch.float32)
    assert tc.swa.max_seq == jc.swa.max_seq == 128 and tc.full.max_seq == N_CTX
    return jc, tc


def _run(jm, tm, jc, tc, steps, flash: bool):
    """Each (tokens (B, T), positions (B, T)) step through both forwards;
    returns the two lists of logits."""
    jstep = jax.jit(lambda p, t, s, c: jax_forward(p, jm.hparams, t, s, c, flash=False))
    got, ref = [], []
    for tok, pos in steps:
        r, jc = jstep(jm.params, jnp.asarray(tok, jnp.int32), jnp.asarray(pos), jc)
        ref.append(np.asarray(r))
        with torch.no_grad():
            g, _ = llama_forward(tm.params, tm.hparams, torch.from_numpy(tok),
                                 torch.from_numpy(pos), tc, flash=flash)
        got.append(g.numpy())
    return got, ref


CHUNKS = [24] + [1] * 20 + [8] + [1] * 10 + [40] + [1] * 60     # 162 positions


def _chunk_steps(chunks, seed: int):
    ids = np.random.default_rng(seed).integers(0, 256, sum(chunks))
    out, p0 = [], 0
    for t in chunks:
        out.append((ids[None, p0:p0 + t].astype(np.int64),
                    np.arange(p0, p0 + t, dtype=np.int32)[None]))
        p0 += t
    return out


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_around_the_ring_matches_jax(models, arch, flash, torch_one_thread):
    """162 positions in chunks of 24, 1, 8 and 40: the ring of 128 wraps,
    and every step's logits equal the JAX forward's on its ISWACache."""
    jm, tm = models[arch]
    jc, tc = _caches(jm, tm)
    got, ref = _run(jm, tm, jc, tc, _chunk_steps(CHUNKS, 7), flash)
    assert int(tc.swa.cursor.max()) > tc.swa.max_seq      # wrapped
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **ARCH_TOL)


def test_iswa_forward_equals_the_flat_cache(models, torch_one_thread):
    """The port's two tiers against its own flat cache: every in-window
    entry is resident, so the logits agree."""
    _, tm = models["gemma2"]
    hp = tm.hparams
    _, tc = _caches(*models["gemma2"])
    flat = TK.kv_cache_init(hp.n_layer, 1, N_CTX, hp.n_head_kv, hp.head_dim, hp.head_dim_v,
                            dtype=torch.float32)
    with torch.no_grad():
        for tok, pos in _chunk_steps(CHUNKS, 8):
            a, _ = llama_forward(tm.params, hp, torch.from_numpy(tok), torch.from_numpy(pos), tc)
            b, _ = llama_forward(tm.params, hp, torch.from_numpy(tok), torch.from_numpy(pos),
                                 flat)
            np.testing.assert_allclose(a.numpy(), b.numpy(), **ARCH_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_wave_matches_jax(models, arch, torch_one_thread):
    """Two rows in one cache: a 30-token and a 12-token prompt in one
    padded chunk (padding to the spare slot), then decode steps with the
    second row idle half the time, past the ring."""
    jm, tm = models[arch]
    jc, tc = _caches(jm, tm, B=2)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, 256, (2, 32)).astype(np.int64)
    pos = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    pos[0, 30:] = -1
    pos[1, 12:] = -1
    steps = [(tok, pos)]
    n = [30, 12]
    for i in range(110):
        p = np.asarray([[n[0]], [n[1] if i % 2 else -1]], np.int32)
        steps.append((rng.integers(0, 256, (2, 1)).astype(np.int64), p))
        n = [n[0] + 1, n[1] + (i % 2)]
    got, ref = _run(jm, tm, jc, tc, steps, flash=False)
    assert int(tc.swa.cursor[0]) > tc.swa.max_seq
    for (_, p), g, r in zip(steps, got, ref):
        live = p >= 0
        np.testing.assert_allclose(g[live], r[live], **ARCH_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_truncate_pos_equals_a_fresh_replay(models, arch, torch_one_thread):
    """A rollback by position (40 tokens cut back to 30) gives the next
    token the logits of a fresh cache that saw the first 30, and the JAX
    package's."""
    jm, tm = models[arch]
    hp = tm.hparams
    toks = np.random.default_rng(11).integers(0, 256, (1, 40)).astype(np.int64)
    pos = np.arange(40, dtype=np.int32)[None]
    jc, tc = _caches(jm, tm)
    _, fresh = _caches(jm, tm)
    nxt, npos = torch.tensor([[5]]), torch.tensor([[30]], dtype=torch.int32)
    with torch.no_grad():
        llama_forward(tm.params, hp, torch.from_numpy(toks), torch.from_numpy(pos), tc)
        TK.iswa_truncate_pos(tc, torch.tensor([30], dtype=torch.int32))
        llama_forward(tm.params, hp, torch.from_numpy(toks[:, :30]),
                      torch.from_numpy(pos[:, :30]), fresh)
        a, _ = llama_forward(tm.params, hp, nxt, npos, tc)
        b, _ = llama_forward(tm.params, hp, nxt, npos, fresh)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **ARCH_TOL)
    _, jc = jax_forward(jm.params, jm.hparams, jnp.asarray(toks, jnp.int32), jnp.asarray(pos),
                        jc, flash=False)
    jc = JK.iswa_truncate_pos(jc, jnp.asarray([30], jnp.int32))
    r, _ = jax_forward(jm.params, jm.hparams, jnp.asarray([[5]], jnp.int32),
                       jnp.asarray([[30]], jnp.int32), jc, flash=False)
    np.testing.assert_allclose(a.numpy(), np.asarray(r), **ARCH_TOL)


def test_attn_mask_and_alibi_refuse_the_iswa_cache(models):
    _, tm = models["gemma2"]
    tc = TK.iswa_cache_init(tm.hparams, 1, 32, dtype=torch.float32)
    with pytest.raises(ValueError, match="flat dense"):
        llama_forward(tm.params, tm.hparams, torch.zeros((1, 1), dtype=torch.int64),
                      torch.zeros((1, 1), dtype=torch.int32), tc,
                      attn_mask=torch.zeros((1, 1, 1, 32)))


# ----------------------------------------------------------------- Context


@pytest.mark.parametrize("arch", ARCHS)
def test_context_turns_iswa_on_and_matches_jax(models, arch, torch_one_thread):
    jm, tm = models[arch]
    tc = Context(tm, n_ctx=N_CTX, kv_dtype=torch.float32, device="cpu")
    assert tc.iswa and isinstance(tc.cache, TK.ISWACache)
    jc = JaxContext(jm, n_ctx=N_CTX, kv_dtype=jnp.float32)
    assert jc.iswa
    flat = Context(tm, n_ctx=N_CTX, kv_dtype=torch.float32, device="cpu", iswa=False)
    assert isinstance(flat.cache, TK.KVCache)
    p = prompt(10, 4)
    got = tc.greedy_generate(p, 24, stop_eog=False)
    assert got == jc.greedy_generate(p, 24, stop_eog=False)
    assert got == flat.greedy_generate(p, 24, stop_eog=False)


def test_context_refuses_an_ubatch_past_the_ring_headroom(models):
    _, tm = models["gemma2"]
    tc = Context(tm, n_ctx=1024, kv_dtype=torch.float32, device="cpu")
    assert tc.cache.swa.max_seq == 640            # 16 + 512, rounded up to 128s
    with pytest.raises(ValueError, match="headroom"):
        tc.forward(np.zeros(640 - WINDOW + 1, np.int64))


def test_context_refuses_a_quantized_iswa_cache(models):
    _, tm = models["gemma2"]
    with pytest.raises(ValueError, match="not iswa"):
        Context(tm, n_ctx=64, kv_dtype="q8_0", device="cpu")
    c = Context(tm, n_ctx=64, kv_dtype="q8_0", device="cpu", iswa=False)
    assert isinstance(c.cache, TK.KVCache) and c.cache.quantized


def test_cache_policy_dispatch(models):
    _, tm = models["cohere2"]
    hp = tm.hparams
    assert cache_policy.cache_kind(hp) == "dense"
    c = cache_policy.make_cache(hp, 2, N_CTX, torch.float32, iswa=True, n_ubatch=64)
    assert isinstance(c, TK.ISWACache)
    assert (c.full.k.shape[0], c.swa.k.shape[0], c.swa.max_seq) == (1, 3, 128)
    flat = cache_policy.make_cache(hp, 2, N_CTX, "q8_0")
    assert isinstance(flat, TK.KVCache) and flat.quantized and not flat.q4
    with pytest.raises(TypeError):
        cache_policy.truncate_rows(object(), torch.zeros(2, dtype=torch.int32))


# ------------------------------------------------------------------ Engine


def _engines(model_pair, n_slots: int = 2, **kw):
    jm, tm = model_pair
    je = JaxEngine(jm, n_slots=n_slots, n_ctx=N_CTX, kv_dtype=jnp.float32,
                   prefill_buckets=BUCKETS, **kw)
    te = Engine(tm, n_slots=n_slots, n_ctx=N_CTX, kv_dtype=torch.float32,
                prefill_buckets=BUCKETS, device="cpu", **kw)
    return je, te


def _wave(eng, prompts, max_tokens: int) -> list:
    mod = Engine if isinstance(eng, Engine) else JaxEngine
    from superllama_tpu.runtime.engine import GenRequest as JReq
    from superllama_tpu_torch.runtime.engine import GenRequest as TReq

    req = TReq if mod is Engine else JReq
    reqs = [eng.submit(req(prompt_ids=p, max_tokens=max_tokens, stop_eog=False))
            for p in prompts]
    eng.run_until_drained()
    return [r.result()["tokens"] for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_builds_the_ring(models, arch):
    _, te = _engines(models[arch])
    assert te.iswa and isinstance(te.cache, TK.ISWACache) and te._scratch is None
    assert te.cache.swa.max_seq == 128 >= WINDOW + BUCKETS[-1]
    assert te.cache.full.max_seq == N_CTX
    full, swa = TK.iswa_layer_split(te.hp)
    assert te.cache.full.k.shape[0] == len(full) and te.cache.swa.k.shape[0] == len(swa)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax_past_the_window(models, arch, torch_one_thread):
    """A wave of a 100- and a 20-token prompt, 40 tokens each (the first
    row's positions pass the ring of 128), then the second prompt again on
    a reused slot: the JAX iSWA Engine's tokens."""
    je, te = _engines(models[arch])
    assert je.iswa and te.iswa
    p1, p2 = prompt(100, 5), prompt(20, 6)
    assert _wave(te, [p1, p2], 40) == _wave(je, [p1, p2], 40)
    assert int(te.cache.swa.cursor.max()) > te.cache.swa.max_seq
    assert _wave(te, [p2], 12) == _wave(je, [p2], 12)


@pytest.mark.parametrize("case", ["kept", "wrapped"])
def test_prefix_reuse_guard(models, case, torch_one_thread):
    """A 40-token base, then the base with another tail: the prefix is
    reused while the ring still holds its window (4 tokens generated), not
    after the first request wrote 130 positions past it; tokens equal a
    fresh engine's and the JAX engine's either way."""
    je, te = _engines(models["gemma2"], n_slots=1)
    base = prompt(40, 9)
    first = 4 if case == "kept" else 130
    _wave(te, [base + [1, 2]], first)
    _wave(je, [base + [1, 2]], first)
    cached = te.metrics["n_prompt_cached"]
    got = _wave(te, [base + [3, 4]], 6)
    reused = te.metrics["n_prompt_cached"] - cached
    assert reused == (40 if case == "kept" else 0)
    _, fresh = _engines(models["gemma2"], n_slots=1)
    assert got == _wave(fresh, [base + [3, 4]], 6) == _wave(je, [base + [3, 4]], 6)


def test_slot_save_restore_erase(models, tmp_path, torch_one_thread):
    """A slot saved (through an .npz file), erased, used by another request,
    restored: a continuation of its tokens equals a fresh engine's and the
    JAX engine's."""
    je, te = _engines(models["gemma2"], n_slots=1)
    p = prompt(30, 10)
    _wave(te, [p], 4)
    snap = te.slot_save(0)
    assert {"full_k", "swa_k", "swa_pos", "full_cursor", "n_past"} <= set(snap)
    np.savez(tmp_path / "slot.npz", **snap)
    te.slot_erase(0)
    assert int((te.cache.swa.pos[0] >= 0).sum()) == int((te.cache.full.pos[0] >= 0).sum()) == 0
    _wave(te, [prompt(9, 11)], 3)
    te.slot_erase(0)
    with np.load(tmp_path / "slot.npz") as z:
        assert te.slot_restore(0, dict(z)) == len(snap["cache_tokens"])
    p2 = [int(t) for t in snap["cache_tokens"]] + [5, 6]
    got = _wave(te, [p2], 4)
    assert te.metrics["n_prompt_cached"] > 0
    _, fresh = _engines(models["gemma2"], n_slots=1)
    assert got == _wave(fresh, [p2], 4) == _wave(je, [p2], 4)


def test_slot_restore_takes_the_jax_snapshot(models, torch_one_thread):
    je, te = _engines(models["cohere2"], n_slots=1)
    p = prompt(30, 12)
    _wave(je, [p], 4)
    snap = je.slot_save(0)
    te.slot_restore(0, snap)
    for tier in ("full", "swa"):
        got = getattr(te.cache, tier)
        np.testing.assert_array_equal(got.pos[0, :got.max_seq].numpy(),
                                      snap["state"][tier]["pos"])
    p2 = [int(t) for t in snap["cache_tokens"]] + [7]
    assert _wave(te, [p2], 4) == _wave(je, [p2], 4)


def test_slot_restore_refuses_the_other_kind_of_snapshot(models):
    _, tm = models["gemma2"]
    flat = Engine(tm, n_slots=1, n_ctx=64, kv_dtype=torch.float32, device="cpu", iswa=False)
    ring = Engine(tm, n_slots=1, n_ctx=64, kv_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="iSWA"):
        flat.slot_restore(0, ring.slot_save(0))
    with pytest.raises(ValueError, match="iSWA"):
        ring.slot_restore(0, flat.slot_save(0))


INCOMPATIBLE = {"paged": dict(paged=True, page_size=16), "q8_0": dict(kv_dtype="q8_0"),
                "q4_0": dict(kv_dtype="q4_0"), "lookup": dict(lookup_ngrams=3),
                "ctx_shift": dict(ctx_shift=True), "speculative": dict(draft=True)}


def _incompatible(tm, mode: str, iswa):
    kw = dict(INCOMPATIBLE[mode])
    if kw.pop("draft", False):
        kw["draft_model"] = tm
    kw.setdefault("kv_dtype", torch.float32)
    return Engine(tm, n_slots=1, n_ctx=64, device="cpu", iswa=iswa, **kw)


@pytest.mark.parametrize("mode", list(INCOMPATIBLE))
def test_incompatible_mode_refuses_iswa(models, mode):
    _, tm = models["gemma2"]
    with pytest.raises(ValueError, match="iswa cache: incompatible"):
        _incompatible(tm, mode, True)


@pytest.mark.parametrize("mode", list(INCOMPATIBLE))
def test_incompatible_mode_turns_iswa_off(models, mode):
    _, tm = models["gemma2"]
    eng = _incompatible(tm, mode, None)
    assert not eng.iswa and not isinstance(eng.cache, TK.ISWACache)


def test_warmup_keys_are_in_place_chunks(models, fake_graphs, torch_one_thread):
    """Warm-up captures the (n_slots, P) in-place chunks on the big cache
    (keyed apart from a flat cache's) and full-cache blocks only; serving
    then captures nothing, every chunk a replay, and the tokens equal an
    engine's without graphs."""
    _, te = _engines(models["gemma2"], n_slots=2)
    te._graphs = _Rerun("cuda")
    te.warmup()
    keys = set(te._graphs.keys())
    assert {k for k in keys if k[0] == "chunk"} == {
        ("chunk", "iswa torch.float32", 2, P) for P in BUCKETS}
    assert {k[2] for k in keys if k[0] != "chunk"} == {None}
    captures = dict(te._graphs.stats["chunk"])
    prompts = [prompt(70, 13), prompt(20, 14)]
    got = _wave(te, prompts, 10)
    assert set(te._graphs.keys()) == keys
    assert te._graphs.stats["chunk"]["captures"] == captures["captures"]
    assert te._graphs.stats["chunk"]["replays"] > captures["replays"]
    _, eager = _engines(models["gemma2"], n_slots=2)
    assert got == _wave(eager, prompts, 10)
