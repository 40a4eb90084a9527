"""The port's prompt chunks as functions over static buffers, and the
engine's warm-up, on the CPU (tiny F32 llama, so both packages compute the
same logits to float rounding):

 - a paged chunk of one row (the pool's row view) gives the JAX engine's
   padded (n_slots, P) chunk's logits for that slot, and a paged engine the
   JAX paged engine's tokens, greedy and seeded sampled;
 - a second lone prompt waits while the first holds the scratch (or joins a
   wave that forms meanwhile), with the JAX engine's tokens;
 - ``_chunk`` reaches no host sync (dense lone, wave, paged row view), so a
   CUDA graph can capture it;
 - ``warmup()`` captures the expected keys (stand-ins for torch's graph
   API), serving every bucket afterwards captures nothing, and no slot's
   state changes;
 - ``serve --no-warmup`` reaches ``ServerApp(warmup=False)``.
"""

import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.runtime import graphs as graphs_mod
from superllama_tpu_torch.runtime.engine import Engine, GenRequest, SlotState
from test_torch_decode_block import _FakeGraph, _FakeStream, _HostSyncs
from test_torch_fixtures import prompt, write_tiny_llama

SAMPLED = {"temp": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05, "seed": 17}
TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_model.py's, F32 weights


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(tmp_path_factory.mktemp("chunk"), (GGMLType.F32,))[GGMLType.F32]


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_model(path):
    return jax_load(path)


PAGED = dict(n_slots=3, n_ctx=128, paged=True, page_size=16)


def test_paged_row_chunk_matches_the_jax_padded_chunk(model, jax_model):
    """Slot 1's 24-token prompt in two chunks (16 tokens, then 8 in a fresh
    page): every position's logits of the one-row forward on the row view,
    and the first token's row that ``_chunk`` gathers, against the JAX
    engine's (3, 16) chunk with rows 0 and 2 padding."""
    je = JaxEngine(jax_model, kv_dtype=jnp.float32, **PAGED)
    te = Engine(model, kv_dtype=torch.float32, device="cpu", **PAGED)
    p, seq, P = prompt(24, 5), 1, 16
    for off in (0, 16):
        chunk = p[off:off + P]
        n = len(chunk)
        tok = np.zeros((3, P), np.int32)
        pos = np.full((3, P), -1, np.int32)
        tok[seq, :n], pos[seq, :n] = chunk, np.arange(off, off + n)
        je.pkv.plan_step({seq: n})
        ref, cache = je._decode(jax_model.params, jnp.asarray(tok), jnp.asarray(pos),
                                je.pkv.cache)
        je.pkv.finish_step(cache)
        ref = np.asarray(ref, np.float32)[seq, :n]

        te.pkv.plan_step({seq: n})
        te.pkv.load_row(te._pview, seq)
        with torch.no_grad():
            got, _ = te._fwd(model.params, model.hparams, torch.from_numpy(tok[seq:seq + 1]),
                             torch.from_numpy(pos[seq:seq + 1]), te._pview)
            te.pkv.load_row(te._pview, seq)          # the same cells, written again
            io = te._run_chunk(1, P, {0: (chunk, off)})
        te.pkv.finish_step()
        np.testing.assert_allclose(got[0, :n].numpy(), ref, **TOL)
        np.testing.assert_allclose(io["logits"][0].numpy(), ref[n - 1], **TOL)
    assert np.array_equal(te.pkv._table_np, je.pkv._table_np)
    assert np.array_equal(te.pkv.cache.page_pos.numpy(), np.asarray(je.pkv.cache.page_pos))


@pytest.mark.parametrize("sampling", [{"greedy": True}, SAMPLED], ids=["greedy", "sampled"])
def test_paged_engine_with_row_chunks_matches_jax(model, jax_model, sampling):
    """Two prompts of several one-row chunks each, served together."""
    prompts = [prompt(37, 8), prompt(21, 9)]
    samplings = [sampling, {**sampling, "seed": 3}] if "seed" in sampling else [sampling] * 2

    def serve(eng, request):
        reqs = [eng.submit(request(prompt_ids=p, max_tokens=14, sampling=sm, stop_eog=False))
                for p, sm in zip(prompts, samplings)]
        eng.run_until_drained()
        return [r.result()["tokens"] for r in reqs]

    ref = serve(JaxEngine(jax_model, kv_dtype=jnp.float32, **PAGED), JaxRequest)
    eng = Engine(model, kv_dtype=torch.float32, device="cpu", **PAGED)
    assert serve(eng, GenRequest) == ref
    assert eng.stats["chunks"] == 3 + 2


DENSE = dict(n_slots=3, n_ctx=128, prefill_buckets=(8,))


@pytest.mark.parametrize("third", [False, True], ids=["waits", "joins-a-wave"])
def test_second_lone_prompt_waits_for_the_scratch(model, jax_model, third):
    """A's 20-token prompt takes the scratch (chunks of 8); B arrives after
    A's first chunk and waits with prefill_off 0 while A holds it; with a
    third prompt C arriving too, B and C load in one wave instead. Tokens
    equal the JAX engine's under the same arrivals."""
    specs = [prompt(20, 1), prompt(6, 2)] + ([prompt(11, 3)] if third else [])

    def serve(eng, request):
        reqs = [eng.submit(request(prompt_ids=specs[0], max_tokens=9,
                                   sampling={"greedy": True}, stop_eog=False))]
        eng.step()
        reqs += [eng.submit(request(prompt_ids=p, max_tokens=9, sampling={"greedy": True},
                                    stop_eog=False)) for p in specs[1:]]
        eng.step()
        seen = [(s.prefill_off, s.in_place) for s in eng.slots]
        eng.run_until_drained()
        return [r.result()["tokens"] for r in reqs], seen

    ref, _ = serve(JaxEngine(jax_model, kv_dtype=jnp.float32, **DENSE), JaxRequest)
    eng = Engine(model, kv_dtype=torch.float32, device="cpu", **DENSE)
    got, seen = serve(eng, GenRequest)
    assert got == ref
    assert seen[0] == (16, False)                    # A: two chunks on the scratch
    assert seen[1] == ((6, True) if third else (0, False))
    assert eng._scratch_owner is None and bool((eng._scratch.pos == -1).all())


def _loading_engine(model, kind):
    """An engine with a prompt loading, its next chunk's inputs staged."""
    kw = {"dense": DENSE, "wave": DENSE, "paged": PAGED}[kind]
    eng = Engine(model, kv_dtype=torch.float32, device="cpu", **kw)
    n = 2 if kind == "wave" else 1
    for i in range(n):
        eng.submit(GenRequest(prompt_ids=prompt(20, i), max_tokens=4))
    eng.step()          # admitted, first chunk run
    rows = eng.n_slots if kind == "wave" else 1
    P = 16 if kind == "paged" else 8
    if kind == "paged":
        eng.pkv.plan_step({0: P})
        eng.pkv.load_row(eng._pview, 0)
        cache = eng._pview
    else:
        cache = eng.cache if kind == "wave" else eng._scratch
    io = eng._chunk_io(rows, P)[0]
    io["tok"].copy_(torch.arange(rows * P).reshape(rows, P) % 200)
    io["pos"][0].copy_(torch.arange(P, 2 * P))
    return eng, cache, io


@pytest.mark.parametrize("kind", ["dense", "wave", "paged"])
def test_chunk_has_no_host_sync(model, kind):
    eng, cache, io = _loading_engine(model, kind)
    with torch.no_grad(), _HostSyncs() as mode:
        eng._chunk(cache, io)
    assert mode.seen == []
    assert bool(torch.isfinite(io["logits"][0]).all())


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


def _state(eng):
    slots = [(s.state, s.req, s.n_past, s.n_prompt, s.prefill_off, s.in_place,
              list(s.generated), list(s.pending)) for s in eng.slots]
    if eng.paged:
        c = eng.pkv.cache
        dev = (c.table, c.cur_page, c.cur_off, c.page_pos)
        host = (eng.pkv._table_np.copy(), eng.pkv._cur_page.copy(), eng.pkv._cur_off.copy())
    else:
        dev, host = (eng.cache.pos, eng.cache.cursor, eng._scratch.pos), ()
    return slots, [t.clone() for t in dev], host


def _same_state(a, b) -> bool:
    return (a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
            and all(np.array_equal(x, y) for x, y in zip(a[2], b[2])))


WARM_CASES = {
    # n_ctx 512: slot windows 256 and the full cache; buckets 8/16/32
    "dense": (dict(n_slots=3, n_ctx=512, prefill_buckets=(8, 16, 32)),
              {(str(torch.float32), 8, w, g) for w in (256, None) for g in (True, False)}
              | {("chunk", str(torch.float32), r, P) for r in (1, 3) for P in (8, 16, 32)}),
    "paged": (dict(n_slots=3, n_ctx=512, prefill_buckets=(8, 16, 32), paged=True,
                   page_size=16),
              {("paged", 8, None, g) for g in (True, False)}
              | {("chunk", "paged", 1, P) for P in (8, 16)}),
}


@pytest.mark.parametrize("case", list(WARM_CASES))
def test_warmup_captures_every_key(model, fake_graphs, case):
    kw, want = WARM_CASES[case]
    eng = Engine(model, kv_dtype=torch.float32, device="cpu", **kw)
    eng._graphs = graphs_mod.GraphCache("cuda")
    before = _state(eng)
    info = eng.warmup()
    assert set(info["keys"]) == want and len(info["keys"]) == len(want)
    assert set(eng._graphs.keys()) == want and len(info["capture_s"]) == len(want)
    assert _same_state(before, _state(eng))
    stats = {k: dict(v) for k, v in eng._graphs.stats.items()}
    chunks0 = eng.stats["chunks"]
    # every bucket, lone and in a wave, greedy and sampled, past the 256 window
    lone = [(prompt(n, n), {"greedy": True}) for n in (5, 13, 30)]
    wave = [(prompt(n, n + 1), {**SAMPLED, "seed": n}) for n in (7, 15, 29)]
    for batch in [[r] for r in lone] + [wave, [(prompt(31, 4), {"greedy": True})] * 2]:
        reqs = [eng.submit(GenRequest(prompt_ids=p, max_tokens=260 if len(batch) == 2 else 6,
                                      sampling=sm, stop_eog=False)) for p, sm in batch]
        eng.run_until_drained()
        assert all(len(r.result()["tokens"]) == r.max_tokens for r in reqs)
    for kind in ("block", "chunk"):
        assert eng._graphs.stats[kind]["captures"] == stats[kind]["captures"]
    assert (eng._graphs.stats["chunk"]["replays"] - stats["chunk"]["replays"]
            == eng.stats["chunks"] - chunks0 > 0)
    assert set(eng._graphs.keys()) == want


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_warmup_without_graphs_leaves_the_slots_as_they_were(model, kind):
    """The CPU has no graphs: warm-up serves the micro-wave (two 2-token
    prompts, 2 tokens each) for real, and erases it from its slots."""
    kw = PAGED if kind == "paged" else DENSE
    eng = Engine(model, kv_dtype=torch.float32, device="cpu", **kw)
    before = _state(eng)
    info = eng.warmup()
    assert info["keys"] == [] and info["pool_bytes"] == 0
    assert eng.stats["chunks"] >= 1 and eng.stats["blocks"] >= 1
    assert _same_state(before, _state(eng))
    assert all(s.state == SlotState.IDLE for s in eng.slots)
    r = eng.generate(prompt(9, 7), max_tokens=5, sampling={"greedy": True}, stop_eog=False)
    fresh = Engine(model, kv_dtype=torch.float32, device="cpu", **kw)
    assert r["tokens"] == fresh.generate(prompt(9, 7), max_tokens=5,
                                         sampling={"greedy": True}, stop_eog=False)["tokens"]
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            eng.warmup()
    finally:
        eng.stop()


@pytest.mark.parametrize("flags,want", [([], True), (["--warmup"], True),
                                        (["--no-warmup"], False)],
                         ids=["default", "warmup", "no-warmup"])
def test_serve_warmup_flags(model, monkeypatch, flags, want):
    from superllama_tpu_torch import cli
    from superllama_tpu_torch.server import http

    seen = {}

    class App:
        def __init__(self, model, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(cli, "_load", lambda args: (model, torch.float32))
    monkeypatch.setattr(http, "ServerApp", App)
    with pytest.raises(SystemExit):
        cli.main(["serve", "-m", "unused.gguf", "--device", "cpu", *flags])
    assert seen["warmup"] is want


@pytest.mark.parametrize("warmup", [True, False])
def test_server_warms_the_engine_before_serving(model, warmup):
    from superllama_tpu_torch.server.http import Server, ServerApp

    app = ServerApp(model, n_slots=2, n_ctx=64, kv_dtype=torch.float32, device="cpu",
                    warmup=warmup)
    assert app.engine.stats["chunks"] == 0          # the engine never warms itself
    srv = Server(app, port=0)
    srv.start()
    try:
        assert (app.warmup_info is not None) == warmup
        assert (app.engine.stats["chunks"] > 0) == warmup
    finally:
        srv.stop()
