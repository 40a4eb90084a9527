"""The port's decode variants in its Engine against the JAX Engine, on the
CPU (tiny F32 llama GGUFs written here), on the same GGUF and requests:

 - ``are_compatible`` / ``VocabTranslator`` and ``NgramCache`` against the
   JAX package's;
 - speculative decoding with the target as its own draft (f32) and with a
   one-layer draft (the target's first layer, embeddings and head; Q8_0
   and paged): two concurrent slots, one greedy and one seeded sampled;
   tokens and the ``n_spec_*`` counters equal, and again on the same
   engines;
 - the translated path: a draft whose vocab merges byte pairs, so that
   ``are_compatible`` is false;
 - lookup decoding, dense and paged;
 - context shift on f32, Q8_0 and paged caches: tokens, ``n_ctx_shifts``,
   ``cache_tokens``; a shifted engine whose blocks replay from (stand-in)
   graphs gives the eager engine's tokens, and the cache keeps its storage;
 - ``ServerApp(draft_model=)`` over HTTP, and ``serve -md / --draft-n``;
 - the new entry points default to CUDA and raise without a GPU.
The JAX engines are shared per module (each compiles its steps once).
"""

import json
import urllib.request

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
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_fixtures import byte_vocab_fields, prompt, write_tiny_llama
from test_torch_prefix_reuse import _Rerun, fake_graphs  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SIZE = dict(n_ctx=96, prefill_buckets=(32,), n_slots=2)
REQS = [({"greedy": True}, 20, 16), ({"temp": 0.8, "seed": 5}, 26, 12)]
KV = {"f32": (torch.float32, jnp.float32), "q8_0": ("q8_0", "q8_0")}


def merged_vocab_fields() -> dict:
    """The byte vocab with its two spare ids as merged pieces (the UTF-8
    replacement character's bytes EF BF, then EF BF BD), which random byte
    text decodes to: a vocab of the same size that is not compatible."""
    f = byte_vocab_fields()
    f["tokenizer.ggml.tokens"] = f["tokenizer.ggml.tokens"][:258] + ["ï¿", "ï¿½"]
    f["tokenizer.ggml.token_type"] = [1] * 256 + [3, 3, 1, 1]
    f["tokenizer.ggml.merges"] = ["ï ¿", "ï¿ ½"]
    return f


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    return {"target": write_tiny_llama(d)[GGMLType.F32],
            "layer0": write_tiny_llama(d, keep_layers=1, name="layer0")[GGMLType.F32],
            "merged": write_tiny_llama(d, keep_layers=1, vocab_fields=merged_vocab_fields(),
                                       name="merged")[GGMLType.F32]}


@pytest.fixture(scope="module")
def models(paths):
    return {k: load_model(p, device="cpu") for k, p in paths.items()}


@pytest.fixture(scope="module")
def jax_models(paths):
    return {k: jax_load(p) for k, p in paths.items()}


@pytest.fixture(scope="module")
def jax_engines(jax_models):
    """The JAX engines by configuration, made once, every slot erased
    before each use."""
    made = {}

    def get(name: str, kv: str, **kw):
        key = (name, kv)
        if key not in made:
            for k in ("draft_model",):
                if k in kw:
                    kw[k] = jax_models[kw[k]]
            made[key] = JaxEngine(jax_models["target"], kv_dtype=KV[kv][1], **SIZE, **kw)
        je = made[key]
        for i in range(je.n_slots):
            je.slot_erase(i)
        return je

    return get


def pair(models, jax_engines, name: str, kv: str = "f32", **kw):
    """(a new port engine, the shared JAX engine) of one configuration;
    ``draft_model`` names a model of the fixture."""
    tkw = dict(kw)
    if "draft_model" in tkw:
        tkw["draft_model"] = models[tkw["draft_model"]]
    te = Engine(models["target"], kv_dtype=KV[kv][0], device="cpu", **SIZE, **tkw)
    return te, jax_engines(name, kv, **kw)


def serve(eng, request, reqs=REQS, seed: int = 0) -> tuple:
    """The requests submitted together: (tokens, the variant counters)."""
    subs = [eng.submit(request(prompt_ids=prompt(n, seed + i), max_tokens=m, sampling=sm,
                               stop_eog=False))
            for i, (sm, n, m) in enumerate(reqs)]
    eng.run_until_drained()
    counters = {k: eng.metrics[k] for k in ("n_spec_drafted", "n_spec_accepted",
                                            "n_ctx_shifts")}
    return [r.result()["tokens"] for r in subs], counters


# ------------------------------------------------------------ host helpers


def test_are_compatible_and_translator_match_jax(models, jax_models):
    from superllama_tpu.runtime import speculative as jspec
    from superllama_tpu_torch.runtime import speculative as tspec

    tt, tm = models["target"].tokenizer, models["merged"].tokenizer
    jt, jm = jax_models["target"].tokenizer, jax_models["merged"].tokenizer
    assert tspec.are_compatible(tt, tt) and jspec.are_compatible(jt, jt)
    assert not tspec.are_compatible(tt, tm) and not jspec.are_compatible(jt, jm)
    assert not tspec.are_compatible(None, tt)
    ttr, jtr = tspec.VocabTranslator(tt, tm), jspec.VocabTranslator(jt, jm)
    for tr in (ttr, jtr):
        tr.add_replacement("é", "e")
    rng = np.random.default_rng(3)
    for _ in range(20):
        ids = rng.integers(0, 258, int(rng.integers(0, 12))).tolist()
        assert ttr.tgt_to_dft(ids) == jtr.tgt_to_dft(ids)
        assert ttr.dft_to_tgt(ids + [258, 259]) == jtr.dft_to_tgt(ids + [258, 259])
    assert 259 in ttr.tgt_to_dft([0xEF, 0xBF, 0xBD])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_cache_matches_jax(seed):
    from superllama_tpu.runtime.ngram import NgramCache as JaxNgram
    from superllama_tpu_torch.runtime.ngram import NgramCache

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 9, 12).tolist()
    seq = (base * 4 + rng.integers(0, 9, 6).tolist()) * 2
    t, j = NgramCache(), JaxNgram()
    hwm = 0
    for cut in (10, 25, 40, len(seq)):
        for ng in (t, j):
            ng.extend(seq[max(hwm - ng.n_max, 0):hwm], seq[hwm:cut])
        hwm = cut
        for k in (1, 4, 8):
            assert t.draft(seq[:cut], k) == j.draft(seq[:cut], k)
    assert t.draft(seq, 8)


# ------------------------------------------------------------ speculative


@pytest.mark.parametrize("draft,kv,paged", [("target", "f32", False), ("layer0", "q8_0", False),
                                            ("layer0", "f32", True)],
                         ids=["self-dense", "layer0-q8_0", "layer0-paged"])
def test_speculative_matches_jax(models, jax_engines, draft, kv, paged):
    kw = dict(draft_model=draft, n_draft=3)
    if paged:
        kw.update(paged=True, page_size=16)
    te, je = pair(models, jax_engines, f"spec-{draft}-{paged}", kv, **kw)
    got = serve(te, GenRequest)
    assert got == serve(je, JaxRequest)
    assert got[1]["n_spec_drafted"] > 0
    if draft == "target":
        assert got[1]["n_spec_accepted"] > 0
    # again on the same engines: the draft rows and slots are reused
    assert serve(te, GenRequest, seed=7) == serve(je, JaxRequest, seed=7)


def test_translated_matches_jax(models, jax_engines):
    te, je = pair(models, jax_engines, "translated", draft_model="merged", n_draft=3)
    assert te.spec_translator is not None and je.spec_translator is not None
    got = serve(te, GenRequest)
    assert got == serve(je, JaxRequest)
    assert got[1]["n_spec_drafted"] > 0


def test_variant_refusals(models):
    with pytest.raises(ValueError, match="must fit one page"):
        Engine(models["target"], paged=True, page_size=8, draft_model=models["target"],
               n_draft=8, device="cpu")
    with pytest.raises(ValueError, match="must fit one page"):
        Engine(models["target"], paged=True, page_size=8, lookup_ngrams=8, device="cpu")
    with pytest.raises(ValueError, match="dense target"):
        Engine(models["target"], paged=True, page_size=16, draft_model=models["merged"],
               n_draft=4, device="cpu")


# ------------------------------------------------------------ lookup


REPEAT = [({"greedy": True}, 0, 24), ({"temp": 0.8, "seed": 9}, 0, 12)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_lookup_matches_jax(models, jax_engines, paged):
    kw = dict(lookup_ngrams=4)
    if paged:
        kw.update(paged=True, page_size=16)
    te, je = pair(models, jax_engines, f"lookup-{paged}", **kw)
    assert serve(te, GenRequest) == serve(je, JaxRequest)
    # prompts of a repeated span: drafts from the prompt itself
    span = prompt(9, 11)[1:]
    reqs = [(sm, 0, m) for sm, _, m in REPEAT]

    def spans(eng, request):
        subs = [eng.submit(request(prompt_ids=[256] + span * 3, max_tokens=m, sampling=sm,
                                   stop_eog=False)) for sm, _, m in reqs]
        eng.run_until_drained()
        return [r.result()["tokens"] for r in subs], eng.metrics["n_spec_accepted"]

    assert spans(te, GenRequest) == spans(je, JaxRequest)
    assert te.metrics["n_spec_drafted"] > 0


# ------------------------------------------------------------ context shift


SHIFT = dict(n_ctx=48, prefill_buckets=(16,))
SHIFT_REQS = [({"greedy": True}, 20, 56), ({"temp": 0.8, "seed": 5}, 26, 60)]
# the paged engines decode a token a step: the JAX engine's paged shift
# pads a chain into n_ctx cells, which the closed-page gaps of blocks outgrow
SHIFT_CACHES = {"f32": ("f32", {}), "q8_0": ("q8_0", {}),
                "paged": ("f32", dict(paged=True, page_size=16, block_size=1))}


@pytest.mark.parametrize("cache", list(SHIFT_CACHES))
def test_context_shift_matches_jax(models, jax_models, cache):
    kv, kw = SHIFT_CACHES[cache]
    te = Engine(models["target"], kv_dtype=KV[kv][0], device="cpu", n_slots=2, ctx_shift=True,
                **SHIFT, **kw)
    je = JaxEngine(jax_models["target"], kv_dtype=KV[kv][1], n_slots=2, ctx_shift=True,
                   **SHIFT, **kw)
    got = serve(te, GenRequest, SHIFT_REQS)
    assert got == serve(je, JaxRequest, SHIFT_REQS)
    assert [len(t) for t in got[0]] == [56, 60]
    assert got[1]["n_ctx_shifts"] >= 4
    assert [s.cache_tokens for s in te.slots] == [s.cache_tokens for s in je.slots]
    assert [s.n_past for s in te.slots] == [s.n_past for s in je.slots]


def test_shifted_blocks_replay(models, fake_graphs):  # noqa: F811
    """A ctx-shift engine whose decode blocks replay from (stand-in) graphs
    that rerun the captured functions: its tokens equal an eager engine's
    across the shifts, so the replayed blocks read the shifted rows; the
    cache's tensors keep their storage."""
    kw = dict(kv_dtype=torch.float32, device="cpu", n_slots=2, ctx_shift=True, **SHIFT)
    te = Engine(models["target"], **kw)
    te._graphs = _Rerun("cuda")
    te.warmup()
    c = te.cache
    ptrs = [t.data_ptr() for t in (c.k, c.v, c.pos, c.cursor)]
    got = serve(te, GenRequest, SHIFT_REQS)
    assert got[1]["n_ctx_shifts"] >= 4
    assert te._graphs.stats["block"]["replays"] > 0
    assert te.cache is c and [t.data_ptr() for t in (c.k, c.v, c.pos, c.cursor)] == ptrs
    assert serve(Engine(models["target"], **kw), GenRequest, SHIFT_REQS) == got


def test_engine_limits_with_shift(models):
    """With ctx_shift a request may ask for more than n_ctx tokens; its
    prompt must still fit. Without it, the JAX engine's limit holds."""
    te = Engine(models["target"], kv_dtype=torch.float32, device="cpu", n_slots=1,
                ctx_shift=True, **SHIFT)
    with pytest.raises(RuntimeError, match="exceeds n_ctx"):
        te.generate(prompt(64), max_tokens=4)
    plain = Engine(models["target"], kv_dtype=torch.float32, device="cpu", n_slots=1, **SHIFT)
    with pytest.raises(RuntimeError, match="exceeds n_ctx"):
        plain.generate(prompt(20), max_tokens=60)


# ------------------------------------------------------------ server and CLI


def test_server_with_draft(models):
    from superllama_tpu_torch.server.http import Server, ServerApp

    app = ServerApp(models["target"], n_slots=2, n_ctx=96, kv_dtype=torch.float32,
                    device="cpu", draft_model=models["layer0"], n_draft=3)
    assert app.engine.draft_model is models["layer0"] and app.engine.n_draft == 3
    srv = Server(app, port=0)
    srv.start()
    try:
        p = prompt(14, 4)
        r = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps({"prompt": p, "max_tokens": 12, "temperature": 0,
                             "return_tokens": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=120) as resp:
            out = json.loads(resp.read())
        assert app.engine.metrics["n_spec_drafted"] > 0
    finally:
        srv.stop()
    ref = Engine(models["target"], kv_dtype=torch.float32, device="cpu", n_slots=2, n_ctx=96)
    want = ref.generate(p, max_tokens=12, sampling={"greedy": True})["tokens"]
    assert out["choices"][0]["tokens"] == want


def test_serve_draft_flags(paths, monkeypatch):
    """``serve -md PATH --draft-n N`` loads the draft on the serve device and
    hands both to ServerApp."""
    import time
    from types import SimpleNamespace

    from superllama_tpu_torch import cli
    from superllama_tpu_torch.server import http

    seen = {}

    class StubServer:
        def __init__(self, app, host, port):
            seen["app"], self.port = app, 0

        def start(self):
            pass

        def stop(self):
            seen["stopped"] = True

    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(http, "Server", StubServer)
    # serve waits in time.sleep until interrupted: cli's own clock ends it at once
    monkeypatch.setattr(cli, "time", SimpleNamespace(sleep=interrupt,
                                                     perf_counter=time.perf_counter))
    rc = cli.main(["serve", "-m", paths["target"], "-md", paths["layer0"], "--draft-n", "5",
                   "--device", "cpu", "--kv-dtype", "float32", "-c", "128", "--no-warmup"])
    eng = seen["app"].engine
    assert rc == 0 and seen["stopped"]
    assert eng.n_draft == 5 and eng.draft_model.hparams.n_layer == 1
    assert eng.draft_model.params["token_embd"].device.type == "cpu"
    rc = cli.main(["serve", "-m", paths["target"], "--draft", "3", "--device", "cpu",
                   "--kv-dtype", "float32", "-c", "128", "--no-warmup"])
    assert seen["app"].engine.draft_model is None and seen["app"].engine.n_draft == 3


@pytest.mark.parametrize("entry", ["Engine", "ServerApp", "LookaheadDecoder"])
def test_entry_points_default_to_cuda(models, entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from superllama_tpu_torch.runtime.lookahead import LookaheadDecoder
    from superllama_tpu_torch.server.http import ServerApp

    m = models["target"]
    calls = {"Engine": lambda: Engine(m, draft_model=models["layer0"]),
             "ServerApp": lambda: ServerApp(m, draft_model=models["layer0"]),
             "LookaheadDecoder": lambda: LookaheadDecoder(m)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
