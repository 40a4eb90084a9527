"""llama4 through the port's ``llama_forward`` against the JAX package, on
the CPU: a tiny llama4 GGUF (4 layers, layer 3 NoPE; 4 experts, top 1 on
raw logits with the sigmoid after, a shared expert, weights before the
experts; chunked attention of 8; temperature tuning with floor 8):

 - hparams; logits of a 20-token prefill and two decode steps (past two
   chunk bounds) through both Contexts, f32 and Q8_0 weights;
 - ``flash=True`` on the port (the NoPE layer through ``fa``'s plain
   version, the rope layers on the plain path with the chunk mask): still
   the JAX CPU result; the chunk mask dropped (as the JAX TPU path drops
   it) is not, and only the NoPE layer reaches ``flash_attention``;
 - greedy Engine tokens against the JAX Engine (alone, a wave);
 - the paged cache refused (its kernel has no chunk bound).

Tolerances: f32 logits to rtol = atol = 1e-4 (tests/test_torch_model.py's);
Q8_0 weights: NMSE < 5e-4 (≤ 16-row steps quantize the activations);
tokens equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.models.llama import llama_forward as jax_forward
from superllama_tpu.runtime import Context as JaxContext
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu.runtime.kv_cache import kv_cache_init as jax_cache
from superllama_tpu_torch.models import llama as llama_mod
from superllama_tpu_torch.models import load_model, registry
from superllama_tpu_torch.models.llama import llama_forward
from superllama_tpu_torch.runtime.context import Context
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from superllama_tpu_torch.runtime.kv_cache import kv_cache_init
from superllama_tpu_torch.runtime.paged_kv import paged_cache_init
from test_torch_fixtures import (ARCH_TOL, N_VOCAB, byte_vocab_fields, dense_spec,  # noqa: F401
                                 prompt, torch_one_thread, write_arch_gguf)

NMSE_ACT_QUANT = 5e-4
CHUNK = 8


def llama4_spec():
    return dense_spec("llama4", L=4, V=N_VOCAB,
                      experts=dict(n=4, k=1, f=48, shared=48),
                      md={"attention.chunk_size": CHUNK, "attention.temperature_tuning": True,
                          "attention.floor_scale": 8.0, "rope.freq_base": 500000.0})


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("llama4")
    name, md, tensors = llama4_spec()
    out = {}
    for t in (GGMLType.F32, GGMLType.Q8_0):
        path = write_arch_gguf(d / f"llama4_{t.name}.gguf", name, md, tensors, t,
                               vocab_fields=byte_vocab_fields())
        out[t] = (jax_load(path, keep_quantized=True),
                  load_model(path, keep_quantized=True, device="cpu"))
    return out


def test_hparams_match_jax(models):
    jm, tm = models[GGMLType.F32]
    hp = tm.hparams
    assert registry.get_forward("llama4") is llama_forward
    assert hp.extra["llama4"] == jm.hparams.extra["llama4"]
    assert hp.extra["llama4"]["chunk"] == CHUNK and hp.n_no_rope_layer_step == 4
    assert hp.swa_window == 0 and not Context(tm, n_ctx=32, device="cpu").iswa
    assert [llama_mod._nope_layer(hp, il) for il in range(4)] == [False, False, False, True]
    for f in ("moe_topk_raw", "expert_weights_before_ffn"):
        assert hp.extra[f] and jm.hparams.extra[f]


STEPS = [np.asarray([prompt(20, 1)]), np.asarray([[7]]), np.asarray([[9]])]


@pytest.mark.parametrize("wtype", [GGMLType.F32, GGMLType.Q8_0], ids=["f32", "q8_0"])
def test_logits_past_the_chunk_match_jax(models, wtype, torch_one_thread):
    jm, tm = models[wtype]
    jc = JaxContext(jm, n_ctx=32, kv_dtype=jnp.float32)
    tc = Context(tm, n_ctx=32, kv_dtype=torch.float32, device="cpu")
    for s in STEPS:
        r = np.asarray(jc.forward(s.astype(np.int32)))
        g = tc.forward(s).numpy()
        if wtype == GGMLType.F32:
            np.testing.assert_allclose(g, r, **ARCH_TOL)
        else:
            assert float(np.mean((g - r) ** 2) / np.mean(r ** 2)) < NMSE_ACT_QUANT


def _flash_run(tm, chunk=None, spy=None):
    """A 40-token prefill and two decode steps through the port with
    flash=True on a flat cache (the chunk size replaced by ``chunk``)."""
    hp = tm.hparams
    if chunk is not None:
        hp = type(hp)(**{**hp.__dict__, "extra": {**hp.extra,
                                                  "llama4": {**hp.extra["llama4"],
                                                             "chunk": chunk}}})
    cache = kv_cache_init(hp.n_layer, 1, 64, hp.n_head_kv, hp.head_dim, dtype=torch.float32)
    out, p0 = [], 0
    for s in [np.asarray([prompt(40, 2)]), np.asarray([[3]]), np.asarray([[4]])]:
        pos = torch.arange(p0, p0 + s.shape[1], dtype=torch.int32)[None]
        with torch.no_grad():
            g, _ = llama_forward(tm.params, hp, torch.from_numpy(s), pos, cache, flash=True)
        out.append(g.numpy())
        p0 += s.shape[1]
    return out


def _jax_run(jm):
    cache = jax_cache(jm.hparams.n_layer, 1, 64, jm.hparams.n_head_kv, jm.hparams.head_dim,
                      dtype=jnp.float32)
    out, p0 = [], 0
    for s in [np.asarray([prompt(40, 2)]), np.asarray([[3]]), np.asarray([[4]])]:
        pos = jnp.arange(p0, p0 + s.shape[1], dtype=jnp.int32)[None]
        r, cache = jax_forward(jm.params, jm.hparams, jnp.asarray(s, jnp.int32), pos, cache)
        out.append(np.asarray(r))
        p0 += s.shape[1]
    return out


def test_flash_keeps_the_chunk_mask(models, torch_one_thread):
    jm, tm = models[GGMLType.F32]
    ref = _jax_run(jm)
    for g, r in zip(_flash_run(tm), ref):
        np.testing.assert_allclose(g, r, **ARCH_TOL)
    # the mask matters on this input: without it (the JAX TPU path's flash)
    # the prefill's logits are far from the reference's
    dropped = _flash_run(tm, chunk=0)[0]
    assert float(np.abs(dropped - ref[0]).max()) > 1e-2


def test_only_the_nope_layer_reaches_flash(models, monkeypatch):
    _, tm = models[GGMLType.F32]
    calls = []
    real = llama_mod.flash_attention
    monkeypatch.setattr(llama_mod, "flash_attention",
                        lambda *a, **k: (calls.append(a[0].shape), real(*a, **k))[1])
    _flash_run(tm)
    assert len(calls) == 3          # layer 3 of the prefill and of each decode step


@pytest.mark.parametrize("case", ["alone", "wave"])
def test_engine_tokens_match_jax(models, case, torch_one_thread):
    jm, tm = models[GGMLType.F32]
    prompts = ([prompt(18, 3)] if case == "alone"
               else [prompt(18, 4), prompt(9, 5), prompt(13, 6)])
    kw = dict(n_slots=3, n_ctx=64)
    je = JaxEngine(jm, kv_dtype=jnp.float32, **kw)
    te = Engine(tm, kv_dtype=torch.float32, device="cpu", **kw)

    def gen(eng, request):
        reqs = [eng.submit(request(prompt_ids=p, max_tokens=12, sampling={"greedy": True},
                                   stop_eog=False)) for p in prompts]
        eng.run_until_drained()
        return [r.result()["tokens"] for r in reqs]

    assert gen(te, GenRequest) == gen(je, JaxRequest)


def test_paged_cache_is_refused(models):
    _, tm = models[GGMLType.F32]
    hp = tm.hparams
    cache = paged_cache_init(hp.n_layer, 4, 16, 1, 2, hp.n_head_kv, hp.head_dim,
                             dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="chunk"):
        llama_forward(tm.params, hp, torch.zeros((1, 1), dtype=torch.int64),
                      torch.zeros((1, 1), dtype=torch.int32), cache)
