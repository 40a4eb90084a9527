"""The port's Engine on the linear-attention and short-conv models, on the
CPU, with a recurrent model (the tiny rwkv6 spec, an ``RWKVCache``) and two
hybrid ones (lfm2's short conv and qwen3next's gated delta net beside
attention):

 - n_slots 2 generations of three prompts (one waits for a slot) equal to
   solo Context generations, and to the JAX Engine's greedy tokens (one
   JAX engine a model, shared: each compiles its steps once);
 - the memory kind and the one-token-a-step policy; a sampled request's
   host-step tokens equal to the JAX Engine's;
 - slot save / erase / restore round trip: every state row comes back and
   the restored row continues as an uninterrupted run;
 - the refusals (paged, Q8_0 / Q4_0, speculative, lookup, context shift,
   iSWA), as in JAX, and the quantized Context's;
 - the warm-up's keys (a greedy one-step block, the power-of-two chunks in
   place) with ``wkv`` among the sources it builds, and no state left;
 - gemma3n on the Engine's iSWA cache equal to solo Context generations.

Torch runs on one thread (``torch_one_thread``). Tokens are compared
exactly; no JAX paged route runs (these memories refuse paging).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch.runtime import engine as tengine
from superllama_tpu_torch.runtime.cache_policy import get_row
from superllama_tpu_torch.runtime.context import Context
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from test_torch_fixtures import arch_models, torch_one_thread  # noqa: F401

KINDS = ("rwkv6", "lfm2", "qwen3next")
BUCKETS = (4, 8, 16)
PROMPTS = [np.random.default_rng(i).integers(0, 500, n).tolist()
           for i, n in ((1, 7), (2, 12), (3, 3))]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("linear_engine")
    return {arch: arch_models(d, arch) for arch in KINDS + ("gemma3n",)}


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


def _rec(blob: dict, arch: str) -> dict:
    """The recurrent part of a ``get_row`` blob."""
    return blob if arch == "rwkv6" else blob["rec"]


@pytest.mark.parametrize("arch", KINDS)
def test_engine_kind_and_policy(models, arch):
    eng = _engine(models[arch][1], block_size=8, pipeline_depth=2)
    assert eng.kind == ("recurrent" if arch == "rwkv6" else "hybrid")
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
def test_sampled_request_takes_the_host_step(models, jax_engines, arch, torch_one_thread):
    """A seeded sampled request's tokens are its host chain's, as in JAX:
    no block runs."""
    cfg = {"temp": 0.8, "top_k": 20, "seed": 5}
    eng = _engine(models[arch][1])
    req = eng.submit(GenRequest(prompt_ids=PROMPTS[0], max_tokens=5, stop_eog=False,
                                sampling=cfg))
    eng.run_until_drained()
    je = jax_engines[arch]
    jr = je.submit(JaxRequest(prompt_ids=PROMPTS[0], max_tokens=5, stop_eog=False,
                              sampling=cfg))
    je.run_until_drained()
    assert req.result()["tokens"] == jr.result()["tokens"]
    assert eng.stats["blocks"] == 0


@pytest.mark.parametrize("arch", KINDS)
def test_slot_save_restore_round_trip(models, arch, torch_one_thread):
    """save → another request → erase → restore: the row's state and
    history come back, and the next tokens are an uninterrupted run's."""
    tm = models[arch][1]
    p = PROMPTS[1]
    eng = _engine(tm, n_slots=1)
    first = _gen(eng, [p], 4)[0]
    snap = eng.slot_save(0)
    assert snap["n_past"] == len(p) + 3
    assert ("wkv" in snap) if arch == "rwkv6" else ("rec_conv" in snap and "attn_k" in snap)
    state = get_row(eng.cache, 0)
    _gen(eng, [PROMPTS[2]], 3)
    eng.slot_erase(0)
    assert eng.slot_restore(0, snap) == len(p) + 3
    again = _rec(get_row(eng.cache, 0), arch)
    for k, v in _rec(state, arch).items():
        np.testing.assert_array_equal(again[k], v)
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
    assert "wkv" in tengine.SSM_SOURCES
    eng = _engine(models[arch][1])
    label = f"{eng.kind} {torch.float32}"
    keys = [t[0] for t in eng._graph_targets()]
    assert keys == [(label, 1, None, True)] + [("chunk", label, 2, P)
                                               for P in (1, 2, 4, 8, 16)]
    before = [_rec(get_row(eng.cache, i), arch) for i in range(2)]
    eng.warmup()
    assert all(s.n_past == 0 and not s.cache_tokens for s in eng.slots)
    for i, b in enumerate(before):
        a = _rec(get_row(eng.cache, i), arch)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_gemma3n_engine_matches_solo(models, torch_one_thread):
    """gemma3n serves as a dense model on the iSWA cache (its default), two
    slots and three prompts equal to solo Context generations."""
    tm = models["gemma3n"][1]
    eng = Engine(tm, n_slots=2, n_ctx=64, kv_dtype=torch.float32, device="cpu",
                 prefill_buckets=BUCKETS)
    assert eng.kind == "dense" and eng.iswa
    assert _gen(eng, PROMPTS, 5) == [_solo(tm, p, 5) for p in PROMPTS]
