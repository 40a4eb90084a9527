"""Prompt-prefix reuse, slot choice and request priority in the port's
Engine, on the CPU (tiny F32 llama), against the JAX Engine on the same
GGUF and requests:

 - a request that shares a prefix of 16 tokens or more with a slot's cache
   row prefills only the rest, in place, after a longer earlier request
   (the row is truncated to the prefix first: a fresh engine's tokens show
   the older request's cells are gone), on f32, bf16 and Q8_0 dense caches
   and a paged cache of 16-token pages (a 24-token prefix, then a tail that
   starts mid-page): tokens, ``n_prompt_cached`` and the page tables equal
   the JAX engine's;
 - on an engine of one slot the rest loads on the big cache at one row (its
   own graph key), Q4_0 included (the JAX engine cannot serve a lone Q4_0
   prompt, so Q4_0 is held to a fresh port engine);
 - the reused prefix is capped at the prompt less one token and dropped
   below 16 tokens, as in JAX;
 - a request takes the free slot with the longest cached prefix, and
   waiting requests are admitted by priority, as in JAX;
 - after ``warmup`` the reused chunks hit captured keys only (stand-ins for
   torch's graph API).
"""

import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.runtime import graphs as graphs_mod
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from test_torch_decode_block import _FakeGraph, _FakeStream
from test_torch_fixtures import prompt, torch_one_thread, write_tiny_llama_np  # noqa: F401

# torch on one thread: engine runs of several test workers oversubscribe the
# cores
pytestmark = pytest.mark.usefixtures("torch_one_thread")

GREEDY = {"greedy": True}
SIZE = dict(n_ctx=128, prefill_buckets=(32,))   # one bucket: few JAX compiles
CACHES = {"f32": dict(kv_dtype=(torch.float32, jnp.float32)),
          "bf16": dict(kv_dtype=(torch.bfloat16, jnp.bfloat16)),
          "q8_0": dict(kv_dtype=("q8_0", "q8_0")),
          "q4_0": dict(kv_dtype=("q4_0", "q4_0")),
          "paged": dict(kv_dtype=(torch.float32, jnp.float32), paged=True, page_size=16)}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama_np(tmp_path_factory.mktemp("reuse"))


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_model(path):
    return jax_load(path)


@pytest.fixture(scope="module")
def jax_engines(jax_model):
    """The JAX engines by (cache, n_slots), shared by the tests of this
    file (each compiles its steps once), every slot erased between uses."""
    made = {}

    def get(cache: str, n_slots: int):
        je = made.get((cache, n_slots))
        if je is None:
            kw = dict(CACHES[cache])
            je = made[(cache, n_slots)] = JaxEngine(jax_model, kv_dtype=kw.pop("kv_dtype")[1],
                                                    n_slots=n_slots, **SIZE, **kw)
        for i in range(n_slots):
            je.slot_erase(i)
        return je

    return get


def engines(model, jax_engines, cache: str, n_slots: int = 2, jax: bool = True):
    """(a new port engine, the shared JAX engine or None) of one cache kind."""
    kw = dict(CACHES[cache])
    te = Engine(model, kv_dtype=kw.pop("kv_dtype")[0], n_slots=n_slots, device="cpu",
                **SIZE, **kw)
    return te, jax_engines(cache, n_slots) if jax else None


def holder(eng, p: list[int]) -> int:
    """The slot whose cache row holds prompt p."""
    return next(s.idx for s in eng.slots if s.cache_tokens[:len(p)] == p)


def serve(eng, request, specs) -> list:
    """Each (prompt, max_tokens) served alone, in turn: [(tokens, slot, cached)]."""
    out = []
    for p, n in specs:
        cached = eng.metrics["n_prompt_cached"]
        r = eng.submit(request(prompt_ids=p, max_tokens=n, sampling=GREEDY, stop_eog=False))
        eng.run_until_drained()
        out.append((r.result()["tokens"], holder(eng, p), eng.metrics["n_prompt_cached"] - cached))
    return out


def turns(first: int = 40, shared: int = 24) -> tuple[list, callable]:
    """A's prompt, and B's and C's built from what came before: B shares
    ``shared`` tokens with the longer A, C is B's prompt, B's tokens and 5
    more (so C reuses all B left in the cache)."""
    pA = prompt(first, 1)
    pB = pA[:shared] + prompt(12, 2)[1:]
    return pA, pB, lambda outB: pB + outB + prompt(6, 3)[1:]


def three_turns(eng, request) -> list:
    pA, pB, pC = turns()
    a, b = serve(eng, request, [(pA, 8), (pB, 8)])
    return [a, b] + serve(eng, request, [(pC(b[0]), 6)])


@pytest.mark.parametrize("cache", ["f32", "bf16", "q8_0", "paged"])
def test_reuse_after_a_longer_request_matches_jax(model, jax_engines, cache):
    te, je = engines(model, jax_engines, cache)
    got, ref = three_turns(te, GenRequest), three_turns(je, JaxRequest)
    assert got == ref
    assert [c for *_, c in got] == [0, 24, 42]            # B: 24 of A's 47; C: all of B's 42
    assert te.metrics["n_prompt_cached"] == 66
    if cache == "paged":   # B opened a fresh page after its prefix; C's tail starts mid-page
        assert np.array_equal(te.pkv._table_np, je.pkv._table_np)
        assert np.array_equal(te.pkv.cache.page_pos.numpy(), np.asarray(je.pkv.cache.page_pos))
    fresh, _ = engines(model, jax_engines, cache, jax=False)
    pB = turns()[1]
    assert serve(fresh, GenRequest, [(pB, 8)])[0][0] == got[1][0]


@pytest.mark.parametrize("cache", ["f32", "bf16", "q8_0", "q4_0"])
def test_reuse_on_one_slot_matches_a_fresh_engine(model, jax_engines, cache):
    """One slot: B's rest loads on the big cache at one row, the key
    ("chunk", cache, 1, P, "main"), beside the scratch's."""
    te, _ = engines(model, jax_engines, cache, n_slots=1, jax=False)
    got = three_turns(te, GenRequest)
    assert [c for *_, c in got] == [0, 24, 42]
    pA, pB, pC = turns()
    for i, p in ((1, pB), (2, pC(got[1][0]))):
        fresh, _ = engines(model, jax_engines, cache, n_slots=1, jax=False)
        assert serve(fresh, GenRequest, [(p, 8 if i == 1 else 6)])[0][0] == got[i][0]
    keys = {key for key, *_ in te._graph_targets()}
    assert ("chunk", str(te.kv_dtype), 1, 32, "main") in keys
    assert ("chunk", str(te.kv_dtype), 1, 32) in keys


@pytest.mark.parametrize("cache", ["f32", "paged"])
def test_reused_prefix_is_capped_and_dropped_below_16(model, jax_engines, cache):
    """The whole cached history again (the prefix capped at the prompt less
    one), then a 15-token prefix (no reuse: a fresh prefill)."""
    def run(eng, request):
        p = prompt(30, 4)
        (out, _, _), = serve(eng, request, [(p, 5)])
        again = p + out[:-1]
        return serve(eng, request, [(again, 5), (again[:15] + prompt(9, 5)[1:], 5)])

    te, je = engines(model, jax_engines, cache)
    got, ref = run(te, GenRequest), run(je, JaxRequest)
    assert got == ref
    assert [c for *_, c in got] == [33, 0]


@pytest.mark.parametrize("cache", ["f32", "paged"])
def test_slot_choice_by_longest_prefix(model, jax_engines, cache):
    """X and Y load in one wave (slots 0 and 1); Z shares 20 tokens with Y
    and goes to slot 1, then W shares 18 with X and goes to slot 0."""
    def run(eng, request):
        X, Y = prompt(30, 6), prompt(30, 7)
        reqs = [eng.submit(request(prompt_ids=p, max_tokens=5, sampling=GREEDY,
                                   stop_eog=False)) for p in (X, Y)]
        eng.run_until_drained()
        first = [r.result()["tokens"] for r in reqs]
        return first, serve(eng, request, [(Y[:20] + prompt(7, 8)[1:], 5),
                                           (X[:18] + prompt(5, 9)[1:], 5)])

    te, je = engines(model, jax_engines, cache)
    got, ref = run(te, GenRequest), run(je, JaxRequest)
    assert got == ref
    assert [(slot, c) for _, slot, c in got[1]] == [(1, 20), (0, 18)]


@pytest.mark.parametrize("cache", ["f32", "paged"])
def test_priority_orders_admission(model, jax_engines, cache):
    """Both slots busy; requests of priority 1, 5 and 3 arrive and are
    admitted as 5, 3, 1 (their first tokens stream in that order)."""
    def run(eng, request):
        order = []
        busy = [eng.submit(request(prompt_ids=prompt(9, s), max_tokens=6, sampling=GREEDY,
                                   stop_eog=False)) for s in (10, 11)]
        eng.step()
        reqs = [eng.submit(request(prompt_ids=prompt(7 + pr, pr), max_tokens=3,
                                   sampling=GREEDY, stop_eog=False, priority=pr,
                                   stream=lambda t, s, pr=pr: order.append(pr)))
                for pr in (1, 5, 3)]
        eng.run_until_drained()
        return (list(dict.fromkeys(order)), [r.result()["tokens"] for r in busy + reqs])

    te, je = engines(model, jax_engines, cache)
    got, ref = run(te, GenRequest), run(je, JaxRequest)
    assert got == ref
    assert got[0] == [5, 3, 1]


@pytest.mark.parametrize("cache", ["f32", "paged"])
def test_reuse_while_another_slot_decodes(model, jax_engines, cache):
    """A wave leaves slot 1 holding ``base``; slot 0 then decodes 40 tokens
    of a prompt without BOS (dense: blocks in flight, landed before the
    admission reads host counts) while a request reusing slot 1's prefix
    arrives. Tokens of both equal the JAX engine's."""
    def run(eng, request):
        base = prompt(26, 11)
        reqs = [eng.submit(request(prompt_ids=p, max_tokens=4, sampling=GREEDY,
                                   stop_eog=False)) for p in (prompt(12, 14), base)]
        eng.run_until_drained()
        b_out = reqs[1].result()["tokens"]
        long = eng.submit(request(prompt_ids=prompt(10, 12)[1:], max_tokens=40,
                                  sampling=GREEDY, stop_eog=False))
        for _ in range(3):
            eng.step()
        reuse = eng.submit(request(prompt_ids=base + b_out + prompt(4, 13)[1:], max_tokens=9,
                                   sampling=GREEDY, stop_eog=False))
        eng.run_until_drained()
        slots = [holder(eng, r.prompt_ids) for r in (long, reuse)]
        return slots, long.result()["tokens"], reuse.result()["tokens"]

    te, je = engines(model, jax_engines, cache)
    cached = je.metrics["n_prompt_cached"]
    got = run(te, GenRequest)
    assert got == run(je, JaxRequest)
    assert got[0] == [0, 1]
    assert te.metrics["n_prompt_cached"] == je.metrics["n_prompt_cached"] - cached == 29


@pytest.fixture
def fake_graphs(monkeypatch):
    """torch's graph API replaced by stand-ins (a capture runs its function
    once, a replay runs nothing): GraphCache's keys and counts on the CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [])


class _Rerun(graphs_mod.GraphCache):
    """GraphCache over the stand-ins, whose replay runs the captured
    function again, eagerly: the keys and counts of the graphs, the
    arithmetic of the eager engine."""

    def capture(self, key, fn, warm, kind="block"):
        super().capture(key, fn, warm, kind)
        self._fns = {**getattr(self, "_fns", {}), key: fn}

    def replay(self, key):
        super().replay(key)
        self._fns[key]()


@pytest.mark.parametrize("cache,n_slots", [("f32", 3), ("f32", 1), ("paged", 3)],
                         ids=["dense", "dense-one-slot", "paged"])
def test_reused_chunks_hit_warm_keys(model, jax_engines, fake_graphs, cache, n_slots):
    """After ``warmup``, the three turns capture nothing, and their tokens
    equal an engine's without graphs."""
    te, _ = engines(model, jax_engines, cache, n_slots=n_slots, jax=False)
    te._graphs = _Rerun("cuda")
    te.warmup()
    keys = set(te._graphs.keys())
    captures = te._graphs.stats["chunk"]["captures"]
    replays = te._graphs.stats["chunk"]["replays"]
    chunks = te.stats["chunks"]
    got = three_turns(te, GenRequest)
    assert [c for *_, c in got] == [0, 24, 42]
    assert te._graphs.stats["chunk"]["captures"] == captures
    assert te._graphs.stats["chunk"]["replays"] - replays == te.stats["chunks"] - chunks > 0
    assert set(te._graphs.keys()) == keys
    eager, _ = engines(model, jax_engines, cache, n_slots=n_slots, jax=False)
    assert three_turns(eager, GenRequest) == got
