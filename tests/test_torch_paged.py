"""Port parity: paged KV (superllama_tpu_torch.runtime.paged_kv and
ops.paged_attention) against the JAX package.

 - paged attention over a shuffled page pool equals the JAX kernel in
   interpret mode (the tests/test_paged_kv.py cases, bf16 and softcap too);
 - the page manager, op by op, leaves the state of the JAX manager: tables,
   cursors, free list, page metadata, stats, page positions and contents,
   and the host store, through alloc, spill, pin, coalesced restore,
   rollback, trim, export/import and free;
 - the paged Engine's greedy tokens equal the JAX paged Engine's, with a
   forced spill and a block-decode rollback (tests/test_engine_paged.py).

Tolerances: attention NMSE < 1e-9 in f32 (the same logits; the page
chunks sum in another order) and < 1e-5 in bf16 (p rounded to bf16
relative to another running max). The JAX side runs with XLA's excess
precision off (``xla_exact``) so its bf16 roundings happen as written.
Manager state and tokens are compared for equality.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.ops.paged_attention import paged_flash_attention as jax_paged
from superllama_tpu.runtime import paged_kv as JP
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch.convert import paged_cache_from_jax
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.ops.flash_attention import flash_attention_plain
from superllama_tpu_torch.ops.paged_attention import paged_flash_attention
from superllama_tpu_torch.runtime import paged_kv as TP
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from test_torch_fixtures import (cuda_typed, failing_build, prompt, write_tiny_llama,
                                 xla_exact)

GREEDY = {"greedy": True}


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


# ------------------------------------------------------------ attention


def _pool(B, T, H, Hkv, D, P, MAXP, n_valid, seed, absent=()):
    """Each row's first n_valid positions scattered over a shuffled pool
    (page 0 = NULL); ``absent`` (row, logical page) entries stay -1."""
    rng = np.random.default_rng(seed)
    S = P * MAXP
    q = rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    n_pool = B * MAXP + 1
    k_pages = np.zeros((n_pool, Hkv, P, D), np.float32)
    v_pages = np.zeros((n_pool, Hkv, P, D), np.float32)
    page_pos = np.full((n_pool, P), -1, np.int32)
    table = np.full((B, MAXP), -1, np.int32)
    order = iter(rng.permutation(np.arange(1, n_pool)))
    for b in range(B):
        for lg in range(-(-n_valid[b] // P)):
            if (b, lg) in absent:
                continue
            slot = int(next(order))
            table[b, lg] = slot
            k_pages[slot] = k[b, :, lg * P:(lg + 1) * P]
            v_pages[slot] = v[b, :, lg * P:(lg + 1) * P]
            page_pos[slot] = np.where(np.arange(lg * P, (lg + 1) * P) < n_valid[b],
                                      np.arange(lg * P, (lg + 1) * P), -1)
    q_pos = np.stack([np.arange(n - T, n, dtype=np.int32) for n in n_valid])
    return {"q": q, "k_pages": k_pages, "v_pages": v_pages, "q_pos": q_pos,
            "page_pos": page_pos, "page_table": table}


CASES = {
    # tests/test_paged_kv.py: partial last pages, shuffled pool
    "dense": (dict(B=2, T=8, H=8, Hkv=4, D=32, P=16, MAXP=4, n_valid=[37, 52], seed=0), {}),
    # tests/test_paged_kv.py: sliding window and sinks
    "swa_sinks": (dict(B=1, T=4, H=4, Hkv=2, D=16, P=8, MAXP=3, n_valid=[20], seed=1),
                  dict(swa_window=6, sinks=True)),
    "softcap_absent": (dict(B=3, T=1, H=8, Hkv=2, D=64, P=16, MAXP=5, n_valid=[70, 33, 50],
                            seed=2, absent={(0, 1), (2, 0)}), dict(logit_softcap=20.0)),
    "bf16": (dict(B=2, T=8, H=8, Hkv=2, D=64, P=16, MAXP=4, n_valid=[60, 41], seed=3),
             dict(bf16=True)),
    # head sizes the CUDA kernels pad (80) or copy by words (100 in bf16)
    "d80_prefill": (dict(B=2, T=12, H=8, Hkv=2, D=80, P=16, MAXP=4, n_valid=[60, 41],
                         seed=6), {}),
    "d100_decode_bf16": (dict(B=2, T=1, H=8, Hkv=2, D=100, P=16, MAXP=4, n_valid=[60, 33],
                              seed=7), dict(bf16=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_paged_attention_matches_jax(case):
    shape, opts = CASES[case]
    inp = _pool(**shape)
    bf16 = opts.get("bf16", False)
    sinks = (np.random.default_rng(9).normal(0, 1, (shape["H"],)).astype(np.float32)
             if opts.get("sinks") else None)
    kw = dict(swa_window=opts.get("swa_window", 0),
              logit_softcap=opts.get("logit_softcap", 0.0))
    names = ("q", "k_pages", "v_pages", "q_pos", "page_pos", "page_table")
    jargs = [jnp.asarray(inp[n]) for n in names]
    targs = [torch.from_numpy(inp[n]) for n in names]
    if bf16:
        for i in (0, 1, 2):
            jargs[i] = jargs[i].astype(jnp.bfloat16)
            targs[i] = targs[i].to(torch.bfloat16)
    jsinks = None if sinks is None else jnp.asarray(sinks)
    ref = xla_exact(lambda *a: jax_paged(*a[:6], sinks=a[6], interpret=True, **kw),
                    *jargs, jsinks)
    got = paged_flash_attention(*targs, sinks=None if sinks is None
                                else torch.from_numpy(sinks), **kw)
    assert got.dtype == targs[0].dtype
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) < (1e-5 if bf16 else 1e-9)


def test_paged_equals_dense_attention():
    """The pool read through the table is the row's dense cache: absent
    pages read the NULL page and are masked like empty slots."""
    inp = _pool(B=2, T=4, H=8, Hkv=2, D=32, P=8, MAXP=4, n_valid=[30, 25], seed=4,
                absent={(1, 1)})
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = paged_flash_attention(t["q"], t["k_pages"], t["v_pages"], t["q_pos"],
                                t["page_pos"], t["page_table"])
    tbl = torch.clamp(t["page_table"].long(), min=0)
    k = t["k_pages"][tbl].permute(0, 2, 1, 3, 4).reshape(2, 2, 32, 32)
    v = t["v_pages"][tbl].permute(0, 2, 1, 3, 4).reshape(2, 2, 32, 32)
    ref = flash_attention_plain(t["q"], k, v, t["q_pos"], t["page_pos"][tbl].reshape(2, 32))
    assert torch.equal(got, ref)


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    build_failed = failing_build(monkeypatch)
    inp = _pool(B=1, T=1, H=4, Hkv=2, D=32, P=8, MAXP=2, n_valid=[10], seed=5)
    args = [cuda_typed(torch.from_numpy(inp[n])) for n in
            ("q", "k_pages", "v_pages", "q_pos", "page_pos", "page_table")]
    before = paged_flash_attention.launches
    with pytest.raises(build_failed):
        paged_flash_attention(*args)
    assert paged_flash_attention.launches == before


# ------------------------------------------------------------ manager


class _Both:
    """The JAX and the port's page manager driven by the same operations,
    with the same K/V written through paged_advance / paged_update_layer."""

    L, HKV, D = 2, 2, 4

    def __init__(self, n_pages=5, P=8, n_seqs=2, maxp=6):
        kw = dict(n_layer=self.L, n_pages=n_pages, page_size=P, n_seqs=n_seqs,
                  max_pages_per_seq=maxp, n_head_kv=self.HKV, head_dim=self.D)
        self.j = JP.PagedKVManager(JP.paged_cache_init(**kw, dtype=jnp.float32))
        self.t = TP.PagedKVManager(TP.paged_cache_init(**kw, dtype=torch.float32))
        self.rng = np.random.default_rng(n_pages * 100 + P)
        self.n_seqs = n_seqs
        self.next_pos = [0] * n_seqs

    def both(self, name, *args):
        out = [getattr(m, name)(*args) for m in (self.j, self.t)]
        self.check()
        return out

    def write(self, seq, n):
        """One step appending n tokens to seq (the other rows ride along)."""
        self.both("plan_step", {seq: n})
        pos = np.full((self.n_seqs, n), -1, np.int32)
        pos[seq] = np.arange(self.next_pos[seq], self.next_pos[seq] + n)
        self.next_pos[seq] += n
        jc, js, jo = JP.paged_advance(self.j.cache, jnp.asarray(pos))
        ts, to = TP.paged_advance(self.t.cache, torch.from_numpy(pos))
        for il in range(self.L):
            k = self.rng.normal(0, 1, (self.n_seqs, n, self.HKV, self.D)).astype(np.float32)
            v = self.rng.normal(0, 1, (self.n_seqs, n, self.HKV, self.D)).astype(np.float32)
            jc = JP.paged_update_layer(jc, il, js, jo, jnp.asarray(k), jnp.asarray(v))
            TP.paged_update_layer(self.t.cache, il, ts, to, torch.from_numpy(k),
                                  torch.from_numpy(v))
        self.j.finish_step(jc)
        self.t.finish_step()
        self.check()

    def check(self):
        j, t = self.j, self.t
        np.testing.assert_array_equal(t._table_np, j._table_np)
        np.testing.assert_array_equal(t._cur_page, j._cur_page)
        np.testing.assert_array_equal(t._cur_off, j._cur_off)
        assert t.free == j.free and t.stats == j.stats
        assert ([(m.seq, m.logical, m.pinned) for m in t.meta]
                == [(m.seq, m.logical, m.pinned) for m in j.meta])
        for name in ("page_pos", "table", "cur_page", "cur_off"):
            np.testing.assert_array_equal(getattr(t.cache, name).numpy(),
                                          np.asarray(getattr(j.cache, name)))
        # page 0 (NULL) holds the riding rows' junk K/V: JAX drops the cells
        # past a page's end, the port sends them to the NULL page
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(getattr(t.cache, name)[:, 1:].numpy(),
                                          np.asarray(getattr(j.cache, name))[:, 1:])
        assert sorted(t.host) == sorted(j.host)
        for key, (k, v, p) in j.host.items():
            tk, tv, tp = t.host[key]
            for a, b in ((tk, k), (tv, v), (tp, p)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _alloc_and_spill(m):
    for _ in range(3):
        m.write(0, 8)
    assert not m.t.free
    m.write(1, 4)                       # the LRU page of seq 0 spills
    assert (0, 0) in m.t.host and m.t.stats["evictions"] == 1
    m.both("ensure_resident", 0)        # it comes back, something else spills
    assert m.t.stats["restores"] == 1


def _pinning(m):
    m.write(0, 8)
    m.write(0, 8)
    m.both("pin", 0)
    for mgr in (m.j, m.t):
        with pytest.raises(RuntimeError):
            mgr.plan_step({1: 8})
    m.check()
    m.both("pin", 0, False)
    m.write(1, 8)
    assert m.t.stats["evictions"] >= 1


def _coalesced_restore(m):
    for _ in range(5):
        m.write(0, 8)
    m.both("_evict_lru", 5)
    m.both("ensure_resident", 0)
    assert m.t.stats["coalesced_restores"] >= 1 and m.t.stats["restores"] == 5


def _free_seq(m):
    m.write(0, 8)
    m.write(0, 8)
    m.write(1, 3)
    m.both("free_seq", 0)
    assert int(m.t._cur_off[0]) == 0


def _rollback(m):
    m.write(0, 5)
    for planned, accepted in ((2, 1), (4, 2)):     # in the open page, then a fresh one
        cur = m.t.save_cursor(0)
        assert m.j.save_cursor(0) == cur
        m.write(0, planned)
        m.both("rollback", 0, cur, accepted, planned)
        m.next_pos[0] -= planned - accepted


def _trim(m):
    m.write(0, 8)
    m.write(0, 8)
    m.write(0, 3)
    m.both("_evict_lru", 1)             # a spilled page past the cut goes too
    assert m.both("trim_to_position", 0, 10) == [True, True]


def _export_import(m):
    m.write(0, 8)
    m.write(0, 5)
    (jk, jv, jp), (tk, tv, tp) = m.both("export_row", 0)
    for a, b in ((tk, jk), (tv, jv), (tp, jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    m.j.import_row(1, jk, jv, jp)
    m.t.import_row(1, tk, tv, tp)
    m.check()


SCENARIOS = {
    "alloc_and_spill": (_alloc_and_spill, dict(n_pages=4)),
    "pinning": (_pinning, dict(n_pages=3)),
    "coalesced_restore": (_coalesced_restore, dict(n_pages=11, maxp=10)),
    "free_seq": (_free_seq, {}),
    "rollback": (_rollback, dict(n_pages=6)),
    "trim": (_trim, dict(n_pages=5)),
    "export_import": (_export_import, dict(n_pages=7)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_manager_matches_jax(name):
    fn, kw = SCENARIOS[name]
    fn(_Both(**kw))


def test_paged_cache_from_jax():
    m = _Both()
    m.write(0, 8)
    m.write(1, 3)
    got = paged_cache_from_jax(jax.tree_util.tree_map(np.asarray, m.j.cache), device="cpu")
    for name in ("k_pages", "v_pages", "page_pos", "table", "cur_page", "cur_off"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(m.j.cache, name)))


@pytest.mark.parametrize("kvt", ["q8_0", "q4_0"])
def test_paged_quantized_cache_raises(kvt):
    with pytest.raises(ValueError):
        TP.paged_cache_init(1, 3, 8, 1, 2, 1, 64, dtype=kvt)


# ------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(tmp_path_factory.mktemp("paged"), (GGMLType.F32,))[GGMLType.F32]


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jmodel(path):
    return jax_load(path)


def _gen(eng, prompts, max_tokens, request=GenRequest):
    reqs = [eng.submit(request(prompt_ids=p, max_tokens=max_tokens, sampling=GREEDY,
                               stop_eog=False)) for p in prompts]
    eng.run_until_drained()
    return [r.result()["tokens"] for r in reqs]


ENGINE_CASES = {
    # tests/test_engine_paged.py
    "three_prompts": (dict(n_slots=3, n_ctx=128, page_size=16),
                      [prompt(18, 1), prompt(11, 2), prompt(25, 3)], 12),
    "forced_spill": (dict(n_slots=4, n_ctx=64, page_size=8, n_pages=15),
                     [prompt(24, 10 + i) for i in range(4)], 16),
    "long_prompt_chunked": (dict(n_slots=2, n_ctx=128, page_size=16), [prompt(58, 4)], 8),
    "block_decode_rollback": (dict(n_slots=2, n_ctx=128, page_size=32, block_size=8,
                                   prefill_buckets=(16,)), [prompt(7, 11), prompt(9, 12)], 5),
    # host-sampled step decode (no blocks), with a spill
    "step_decode_spill": (dict(n_slots=3, n_ctx=64, page_size=8, n_pages=8, block_size=1),
                          [prompt(13, 20 + i) for i in range(3)], 10),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_paged_engine_matches_jax(jmodel, model, case):
    kw, prompts, max_tokens = ENGINE_CASES[case]
    je = JaxEngine(jmodel, kv_dtype=jnp.float32, paged=True, **kw)
    te = Engine(model, kv_dtype=torch.float32, device="cpu", paged=True, **kw)
    assert te.block_size == je.block_size
    ref = _gen(je, prompts, max_tokens, JaxRequest)
    assert _gen(te, prompts, max_tokens) == ref
    assert te.pkv.stats == je.pkv.stats
    if case == "forced_spill":
        assert te.pkv.stats["evictions"] > 0 and te.pkv.stats["restores"] > 0


def test_paged_block_decode_rollback_then_fresh_request(model):
    """A stop mid-block rolls the page state back; the slot then serves a
    fresh request exactly (against the port's own Context)."""
    from superllama_tpu_torch.runtime.context import Context

    eng = Engine(model, n_slots=2, n_ctx=128, kv_dtype=torch.float32, device="cpu",
                 prefill_buckets=(16,), paged=True, page_size=32, block_size=8)
    ctx = Context(model, n_batch=1, n_ctx=128, kv_dtype=torch.float32, device="cpu")
    for i, (n, max_tokens) in enumerate(((7, 5), (9, 7))):
        p = prompt(n, 20 + i)
        r = eng.generate(p, max_tokens=max_tokens, sampling=GREEDY, stop_eog=False)
        ctx.cache = ctx.new_cache()
        assert r["tokens"] == ctx.greedy_generate(p, max_tokens, stop_eog=False)[len(p):]


def test_paged_equals_dense_engine_and_slot_reuse(model):
    prompts = [prompt(12, 30 + i) for i in range(3)]
    dense = Engine(model, n_slots=1, n_ctx=64, kv_dtype=torch.float32, device="cpu")
    paged = Engine(model, n_slots=1, n_ctx=64, kv_dtype=torch.float32, device="cpu",
                   paged=True, page_size=8, n_pages=9)
    for p in prompts:        # one slot: each request reclaims the last one's pages
        assert _gen(paged, [p], 6) == _gen(dense, [p], 6)
    assert paged.pkv.stats["allocs"] >= 3


def test_paged_prompt_larger_than_the_pool_fails_alone(model):
    """A prompt whose pages cannot all be pinned in the pool fails its own
    request (as in the JAX engine) and the engine serves the next one."""
    eng = Engine(model, n_slots=1, n_ctx=64, kv_dtype=torch.float32, device="cpu",
                 paged=True, page_size=8, n_pages=3, prefill_buckets=(8,))
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        eng.generate(prompt(20, 1), max_tokens=2, sampling=GREEDY, stop_eog=False)
    assert eng.pkv.seq_pages(0) == 0
    assert len(eng.generate(prompt(5, 2), max_tokens=2, sampling=GREEDY,
                            stop_eog=False)["tokens"]) == 2


def test_paged_engine_rejects_quantized_kv(model):
    with pytest.raises(ValueError):
        Engine(model, n_slots=1, n_ctx=64, kv_dtype="q8_0", device="cpu", paged=True)


def test_serve_paged_flags(model, monkeypatch):
    """``serve --paged-kv --kv-page-size --kv-pages`` reach the engine."""
    from superllama_tpu_torch import cli
    from superllama_tpu_torch.server import http

    seen, real_app = {}, http.ServerApp

    class App:
        def __init__(self, model, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(cli, "_load", lambda args: (model, torch.float32))
    monkeypatch.setattr(http, "ServerApp", App)
    with pytest.raises(SystemExit):
        cli.main(["serve", "-m", "unused.gguf", "--device", "cpu", "--paged-kv",
                  "--kv-page-size", "64", "--kv-pages", "13"])
    assert seen["paged"] is True and seen["page_size"] == 64 and seen["n_pages"] == 13
    app = real_app(model, n_slots=2, n_ctx=64, kv_dtype=torch.float32,
                         device="cpu", paged=True, page_size=16, n_pages=9)
    assert app.engine.paged and app.engine.pkv.n_pool_pages == 8
