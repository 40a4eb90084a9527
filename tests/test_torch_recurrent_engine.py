"""The port's Engine on the recurrent and hybrid memories, on the CPU, with
a recurrent model (the tiny mamba spec) and a hybrid one (jamba's):

 - n_slots 2 generations of three prompts (one waits for a slot) equal to
   solo Context generations, and to the JAX Engine's greedy tokens;
 - a slot reused by another request starts from a reset state;
 - slot save / erase / restore round trip: the restored row continues as an
   uninterrupted run, and the JAX engine's snapshot restores into the port;
 - the refusals (paged, Q8_0 / Q4_0, speculative, lookup, context shift,
   iSWA), as in JAX;
 - the warm-up's keys (a greedy one-step block, the power-of-two chunks in
   place) and the micro-wave leaving no state behind;
 - ``/v1/completions`` through ``ServerApp``;
 - ``run`` on a recurrent model takes the Engine, not ``DecodeLoop``: the
   JAX ``DecodeLoop`` builds a flat KV cache whatever the model and fails on
   a recurrent one (ROADMAP §3).

Torch runs on one thread (``torch_one_thread``). Tokens are compared exactly.
"""

import json
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch import cli
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.runtime import decode_loop
from superllama_tpu_torch.runtime.cache_policy import get_row
from superllama_tpu_torch.runtime.context import Context
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from superllama_tpu_torch.server.http import Server, ServerApp
from test_torch_fixtures import (N_VOCAB, arch_models, byte_vocab_fields, ssm_spec,
                                 torch_one_thread, write_arch_gguf)  # noqa: F401

KINDS = ("mamba", "jamba")
BUCKETS = (4, 8, 16)
PROMPTS = [np.random.default_rng(i).integers(0, 500, n).tolist()
           for i, n in ((1, 7), (2, 12), (3, 3))]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec_engine")
    return {arch: arch_models(d, arch) for arch in KINDS}


@pytest.fixture(scope="module")
def jax_engines(models):
    """One JAX engine a model, shared (each compiles its steps once)."""
    return {arch: JaxEngine(models[arch][0], n_slots=2, n_ctx=64, kv_dtype=jnp.float32,
                            prefill_buckets=BUCKETS) for arch in KINDS}


def _engine(tm, **kw) -> Engine:
    return Engine(tm, **{"n_slots": 2, "n_ctx": 64, "kv_dtype": torch.float32,
                         "device": "cpu", "prefill_buckets": BUCKETS, **kw})


def _gen(eng, prompts, n, request=GenRequest):
    reqs = [eng.submit(request(prompt_ids=p, max_tokens=n, stop_eog=False)) for p in prompts]
    eng.run_until_drained()
    return [r.result()["tokens"] for r in reqs]


def _solo(tm, p, n):
    ctx = Context(tm, n_batch=1, n_ctx=64, kv_dtype=torch.float32, device="cpu")
    return ctx.greedy_generate(p, n, stop_eog=False)[len(p):]


@pytest.mark.parametrize("arch", KINDS)
def test_engine_kind_and_policy(models, arch):
    eng = _engine(models[arch][1], block_size=8, pipeline_depth=2)
    assert eng.kind == ("recurrent" if arch == "mamba" else "hybrid")
    assert (eng.block_size, eng.pipeline_depth) == (1, 1)
    assert eng._scratch is None and not eng.iswa


@pytest.mark.parametrize("arch", KINDS)
def test_concurrent_slots_match_solo_and_jax(models, jax_engines, arch, torch_one_thread):
    tm = models[arch][1]
    eng = _engine(tm)
    got = _gen(eng, PROMPTS, 6)
    assert got == [_solo(tm, p, 6) for p in PROMPTS]
    assert eng.stats["blocks"] > 0 and eng.stats["chunks"] > 0
    assert _gen(jax_engines[arch], PROMPTS, 6, JaxRequest) == got


@pytest.mark.parametrize("arch", KINDS)
def test_slot_reuse_resets_state(models, arch, torch_one_thread):
    tm = models[arch][1]
    eng = _engine(tm, n_slots=1)
    _gen(eng, [PROMPTS[1]], 4)
    assert _gen(eng, [PROMPTS[0]], 5) == [_solo(tm, PROMPTS[0], 5)]


@pytest.mark.parametrize("arch", KINDS)
def test_sampled_request_takes_the_host_step(models, jax_engines, arch, torch_one_thread):
    """A seeded sampled request's tokens are its host chain's, as in JAX:
    no block runs."""
    tm = models[arch][1]
    cfg = {"temp": 0.8, "top_k": 20, "seed": 5}
    eng = _engine(tm)
    reqs = [eng.submit(GenRequest(prompt_ids=PROMPTS[0], max_tokens=5, stop_eog=False,
                                  sampling=cfg))]
    eng.run_until_drained()
    je = jax_engines[arch]
    jr = je.submit(JaxRequest(prompt_ids=PROMPTS[0], max_tokens=5, stop_eog=False,
                              sampling=cfg))
    je.run_until_drained()
    assert reqs[0].result()["tokens"] == jr.result()["tokens"]
    assert eng.stats["blocks"] == 0


@pytest.mark.parametrize("arch", KINDS)
def test_slot_save_restore_round_trip(models, jax_engines, arch, torch_one_thread):
    """save → another request → erase → restore: the row's state and
    history come back, and the next tokens are an uninterrupted run's."""
    tm = models[arch][1]
    p = PROMPTS[1]
    eng = _engine(tm, n_slots=1)
    first = _gen(eng, [p], 4)[0]
    snap = eng.slot_save(0)
    assert snap["n_past"] == len(p) + 3
    assert ("conv" in snap) if arch == "mamba" else ("rec_ssm" in snap and "attn_k" in snap)
    state = get_row(eng.cache, 0)
    _gen(eng, [PROMPTS[2]], 3)
    eng.slot_erase(0)
    assert eng.slot_restore(0, snap) == len(p) + 3
    again = get_row(eng.cache, 0)
    rec = (state, again) if arch == "mamba" else (state["rec"], again["rec"])
    for k in ("conv", "ssm"):
        np.testing.assert_array_equal(rec[1][k], rec[0][k])
    full = _solo(tm, p, 10)
    assert first == full[:4]
    cont, tok, n_past = [], first[-1], snap["n_past"]
    for _ in range(4):
        lg = eng._forward(np.full((1, 1), tok, np.int64), np.full((1, 1), n_past, np.int32),
                          eng.cache)
        tok = int(torch.argmax(lg[0, -1]))
        cont.append(tok)
        n_past += 1
    assert cont == full[4:8]
    # the JAX engine's snapshot of the same run restores into the port
    je = jax_engines[arch]
    _gen(je, [p], 4, JaxRequest)
    (idx,) = [s.idx for s in je.slots if list(s.cache_tokens[:len(p)]) == p]
    eng.slot_erase(0)
    eng.slot_restore(0, je.slot_save(idx))
    for k in ("conv", "ssm"):
        got = get_row(eng.cache, 0)
        got = got if arch == "mamba" else got["rec"]
        np.testing.assert_allclose(got[k], rec[0][k], rtol=1e-5, atol=1e-5)


REFUSED = {"paged": dict(paged=True), "q8_0": dict(kv_dtype="q8_0"),
           "q4_0": dict(kv_dtype="q4_0"), "lookup": dict(lookup_ngrams=3),
           "ctx_shift": dict(ctx_shift=True), "iswa": dict(iswa=True)}


@pytest.mark.parametrize("mode", sorted(REFUSED) + ["speculative"])
@pytest.mark.parametrize("arch", KINDS)
def test_engine_refuses_modes(models, arch, mode):
    tm = models[arch][1]
    kw = dict(draft_model=tm) if mode == "speculative" else REFUSED[mode]
    with pytest.raises(ValueError, match="not supported|dense cache|incompatible"):
        _engine(tm, **kw)


@pytest.mark.parametrize("kv", ["q8_0", "q4_0"])
@pytest.mark.parametrize("arch", KINDS)
def test_context_refuses_quantized_cache(models, arch, kv):
    with pytest.raises(ValueError, match="standard attention caches only"):
        Context(models[arch][1], n_batch=1, n_ctx=32, kv_dtype=kv, device="cpu")


@pytest.mark.parametrize("arch", KINDS)
def test_warmup_keys_and_no_state_left(models, arch, torch_one_thread):
    eng = _engine(models[arch][1])
    label = f"{eng.kind} {torch.float32}"
    keys = [t[0] for t in eng._graph_targets()]
    assert keys == [(label, 1, None, True)] + [("chunk", label, 2, P)
                                               for P in (1, 2, 4, 8, 16)]
    before = [get_row(eng.cache, i) for i in range(2)]
    eng.warmup()
    assert all(s.n_past == 0 and not s.cache_tokens for s in eng.slots)
    after = [get_row(eng.cache, i) for i in range(2)]
    for b, a in zip(before, after):
        rb, ra = (b, a) if arch == "mamba" else (b["rec"], a["rec"])
        for k in ("conv", "ssm"):
            np.testing.assert_array_equal(ra[k], rb[k])


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    """The mamba2 spec with the byte-level vocab (for the CLI and server)."""
    name, md, tensors = ssm_spec("mamba2", V=N_VOCAB)
    return write_arch_gguf(tmp_path_factory.mktemp("rec_vocab") / "mamba2.gguf", name, md,
                           tensors, vocab_fields=byte_vocab_fields())


def test_server_completions_on_a_recurrent_model(vocab_path, torch_one_thread):
    model = load_model(vocab_path, device="cpu")
    prompts = [[t % N_VOCAB for t in p] for p in PROMPTS[:2]]
    want = _gen(_engine(model), prompts, 5)
    app = ServerApp(model, n_slots=2, n_ctx=64, kv_dtype=torch.float32, device="cpu",
                    warmup=False)
    srv = Server(app, port=0)
    srv.start()
    try:
        for p, w in zip(prompts, want):
            body = {"prompt": p, "max_tokens": 5, "temperature": 0, "return_tokens": True}
            r = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/completions",
                                       data=json.dumps(body).encode(), method="POST",
                                       headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=120) as resp:
                assert json.loads(resp.read())["choices"][0]["tokens"] == w
    finally:
        srv.stop()


def test_run_takes_the_engine_not_decode_loop(vocab_path, monkeypatch, capsys):
    """``run`` greedy on a recurrent model: the Engine's tokens, never
    DecodeLoop (the JAX DecodeLoop fails on a recurrent model: below)."""
    def refuse(*a, **k):
        raise AssertionError("DecodeLoop on a recurrent model")
    monkeypatch.setattr(decode_loop, "DecodeLoop", refuse)
    assert cli.main(["run", "-m", vocab_path, "-p", "hi", "-n", "4", "--temp", "0",
                     "--device", "cpu", "--ignore-eos"]) == 0
    text = capsys.readouterr().out.strip()
    model = load_model(vocab_path, device="cpu")
    ids = model.tokenizer.encode("hi", add_special=True, parse_special=True)
    eng = Engine(model, n_slots=1, n_ctx=4096, kv_dtype=torch.bfloat16, device="cpu")
    toks = _gen(eng, [ids], 4)[0]
    assert text == model.tokenizer.decode(toks)


def test_jax_decode_loop_fails_on_a_recurrent_model(vocab_path):
    """The reference's fault the port's ``run`` routes around: its DecodeLoop
    builds a flat KV cache for any model (ROADMAP §3)."""
    from superllama_tpu.models import load_model as jax_load
    from superllama_tpu.runtime.decode_loop import DecodeLoop as JaxDecodeLoop

    loop = JaxDecodeLoop(jax_load(vocab_path), n_ctx=64, kv_dtype=jnp.float32, temp=0.0)
    with pytest.raises(AttributeError, match="conv"):
        loop.generate([1, 2, 3], 2)
