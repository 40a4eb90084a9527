"""Multi-head latent attention (``models/deepseek2.py``) of the port against
the JAX package, on the CPU:

 - tiny GGUFs of deepseek2 with the q LoRA (a dense lead layer, then
   routed and shared experts, a routed scale), deepseek2 without it (the
   V2-Lite form), minicpm3 (q LoRA, NEOX rope, the muP scalings) and plm
   (direct q, relu² FFN, tied embeddings): hparams, the MLA tensors the
   loader reads, a 12-token prefill and two decode steps through both
   Contexts, in f32 and with Q8_0 weights packed (qmv / qmm's plain
   versions at MLA's widths);
 - greedy Engine tokens against the JAX Engine (a request alone, a wave);
 - the refusals: Q8_0, Q4_0, paged and iSWA caches raise ``ValueError``
   rather than serve; and the JAX fault they answer, its Q8_0 logits far
   from its float ones;
 - qmv's and qmm's plans at DeepSeek-V2-Lite's MLA widths (wkv_a N = 576,
   wkv_b K = 512).

Tolerances: f32 logits to rtol = atol = 1e-4 (tests/test_torch_model.py's);
Q8_0 weights to rtol = atol = 1e-4 on the prefill (> 32 rows: dequantized
matmuls) and NMSE < 5e-4 on the decode steps (≤ 16 rows: qmv quantizes the
activations to int8); tokens equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

import ref_arch_specs
from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime import Context as JaxContext
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models import registry
from superllama_tpu_torch.models.deepseek2 import deepseek2_forward
from superllama_tpu_torch.ops import qmatmul as qm
from superllama_tpu_torch.ops.qtensor import QTensor
from superllama_tpu_torch.runtime import kv_cache as TK
from superllama_tpu_torch.runtime.context import Context
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from superllama_tpu_torch.runtime.paged_kv import paged_cache_init
from test_torch_fixtures import (ARCH_TOL, N_VOCAB, _experts, _W, arch_steps,  # noqa: F401
                                 byte_vocab_fields, prompt, torch_one_thread, write_arch_gguf)

NMSE_ACT_QUANT = 5e-4
ARCHS = ("deepseek2", "deepseek2-lite", "minicpm3", "plm")


def deepseek2_spec(q_lora: bool):
    """A 3-layer deepseek2: 4 heads of d_nope 16 + d_rope 8, d_v 16, a KV
    latent of 32 (a q LoRA of 24 with ``q_lora``), layer 0 dense (96), then
    4 routed experts of 48 (top 2, scale 1.5) and a shared one."""
    E, H, L, F, dn, dr, dv, rkv, rq = 64, 4, 3, 96, 16, 8, 16, 32, 24
    p = _W("deepseek2" + ("" if q_lora else "-lite"))
    p.w("token_embd.weight", N_VOCAB, E, scale=0.5)
    p.norm("output_norm.weight", E)
    p.w("output.weight", N_VOCAB, E)
    for i in range(L):
        b = f"blk.{i}."
        p.norm(b + "attn_norm.weight", E)
        if q_lora:
            p.w(b + "attn_q_a.weight", rq, E)
            p.norm(b + "attn_q_a_norm.weight", rq)
            p.w(b + "attn_q_b.weight", H * (dn + dr), rq)
        else:
            p.w(b + "attn_q.weight", H * (dn + dr), E)
        p.w(b + "attn_kv_a_mqa.weight", rkv + dr, E)
        p.norm(b + "attn_kv_a_norm.weight", rkv)
        p.w(b + "attn_kv_b.weight", H * (dn + dv), rkv)
        p.w(b + "attn_output.weight", E, H * dv)
        p.norm(b + "ffn_norm.weight", E)
        if i == 0:
            p.w(b + "ffn_gate.weight", F, E)
            p.w(b + "ffn_up.weight", F, E)
            p.w(b + "ffn_down.weight", E, F)
        else:
            _experts(p, b, E, n=4, k=2, f=48, shared=48)
    md = {"context_length": 64, "embedding_length": E, "block_count": L,
          "feed_forward_length": F, "attention.head_count": H, "attention.head_count_kv": H,
          "attention.key_length": dn + dr, "attention.value_length": dv,
          "rope.dimension_count": dr, "rope.freq_base": 10000.0, "vocab_size": N_VOCAB,
          "attention.layer_norm_rms_epsilon": 1e-6, "attention.kv_lora_rank": rkv,
          "expert_count": 4, "expert_used_count": 2, "expert_feed_forward_length": 48,
          "expert_shared_count": 1, "leading_dense_block_count": 1,
          "expert_weights_scale": 1.5}
    if q_lora:
        md["attention.q_lora_rank"] = rq
    return "deepseek2", md, p.t


def mla_spec(name: str):
    if name.startswith("deepseek2"):
        return deepseek2_spec(q_lora=name == "deepseek2")
    arch, md, tensors = ref_arch_specs.SPECS[name]()
    tensors = {k: (v[:N_VOCAB] if k in ("token_embd.weight", "output.weight") else v)
               for k, v in tensors.items()}
    return arch, {**md, "vocab_size": N_VOCAB}, tensors


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mla")
    out = {}
    for name in ARCHS:
        arch, md, tensors = mla_spec(name)
        for t in (GGMLType.F32, GGMLType.Q8_0):
            out[name, t] = write_arch_gguf(d / f"{name}_{t.name}.gguf", arch, md, tensors, t,
                                           vocab_fields=byte_vocab_fields())
    return out


@pytest.fixture(scope="module")
def models(paths):
    return {key: (jax_load(p, keep_quantized=True), load_model(p, keep_quantized=True,
                                                               device="cpu"))
            for key, p in paths.items()}


def test_mla_archs_are_served():
    for arch in ("deepseek2", "minicpm3", "plm"):
        assert registry.get_forward(arch) is deepseek2_forward
        assert arch in registry.MLA_ARCHS


@pytest.mark.parametrize("name", ARCHS)
def test_hparams_and_tensors_match_jax(models, name):
    jm, tm = models[name, GGMLType.F32]
    for f in ("arch", "n_head", "n_head_kv", "head_dim", "head_dim_v", "n_rot", "q_lora_rank",
              "kv_lora_rank", "n_layer_dense_lead", "n_expert", "n_expert_used",
              "expert_weights_scale", "expert_weights_norm", "f_residual_scale",
              "f_embedding_scale", "logit_scale", "rope_type", "rms_eps"):
        assert getattr(tm.hparams, f) == getattr(jm.hparams, f), f
    for jl, tl in zip(jm.params["layers"], tm.params["layers"]):
        mla = {"wq", "wq_a", "wq_b", "attn_q_a_norm", "wkv_a", "wkv_b", "attn_kv_a_norm"}
        assert {k for k in tl if k in mla} == {k for k, v in jl.items()
                                                if k in mla and v is not None}
        for k in mla & set(tl):
            np.testing.assert_array_equal(np.asarray(tl[k]), np.asarray(jl[k]))


def _logits(jm, tm, n_ctx: int = 32):
    jc = JaxContext(jm, n_batch=1, n_ctx=n_ctx, kv_dtype=jnp.float32)
    tc = Context(tm, n_batch=1, n_ctx=n_ctx, kv_dtype=torch.float32, device="cpu")
    steps = arch_steps(N_VOCAB)
    ref = [np.asarray(jc.forward(s.astype(np.int32))) for s in steps]
    got = [tc.forward(s).numpy() for s in steps]
    return got, ref


@pytest.mark.parametrize("name", ARCHS)
def test_logits_match_jax(models, name, torch_one_thread):
    got, ref = _logits(*models[name, GGMLType.F32])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **ARCH_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_q8_0_weights_match_jax(models, name, torch_one_thread):
    jm, tm = models[name, GGMLType.Q8_0]
    assert isinstance(tm.params["layers"][0]["wkv_a"], QTensor)
    # the prefill's 12 rows and the decode steps' 1 row take qmv (≤ 16 rows)
    for g, r in zip(*_logits(jm, tm)):
        nmse = float(np.mean((g - r) ** 2) / np.mean(r ** 2))
        assert nmse < NMSE_ACT_QUANT, nmse


def test_prefill_past_32_rows_matches_jax(models, torch_one_thread):
    """A 40-token prefill with Q8_0 weights: the > 32-row regime
    (dequantized matmuls, continuous in their input)."""
    jm, tm = models["deepseek2", GGMLType.Q8_0]
    ids = np.asarray([prompt(40, 3)])
    r = np.asarray(JaxContext(jm, n_ctx=64, kv_dtype=jnp.float32).forward(ids.astype(np.int32)))
    g = Context(tm, n_ctx=64, kv_dtype=torch.float32, device="cpu").forward(ids).numpy()
    np.testing.assert_allclose(g, r, **ARCH_TOL)


def _gen(eng, prompts, max_tokens, request):
    reqs = [eng.submit(request(prompt_ids=p, max_tokens=max_tokens, sampling={"greedy": True},
                               stop_eog=False)) for p in prompts]
    eng.run_until_drained()
    return [r.result()["tokens"] for r in reqs]


@pytest.mark.parametrize("name", ["deepseek2", "minicpm3", "plm"])
def test_engine_tokens_match_jax(models, name, torch_one_thread):
    jm, tm = models[name, GGMLType.F32]
    kw = dict(n_slots=3, n_ctx=64)
    je = JaxEngine(jm, kv_dtype=jnp.float32, **kw)
    te = Engine(tm, kv_dtype=torch.float32, device="cpu", **kw)
    for prompts in ([prompt(18, 1)], [prompt(18, 2), prompt(9, 3), prompt(13, 4)]):
        assert _gen(te, prompts, 10, GenRequest) == _gen(je, prompts, 10, JaxRequest)


def _refused_cache(kind: str, hp):
    if kind in ("q8_0", "q4_0"):
        return TK.kv_cache_init(hp.n_layer, 1, 32, hp.n_head_kv, hp.head_dim, hp.head_dim_v,
                                dtype=kind)
    if kind == "paged":
        return paged_cache_init(hp.n_layer, 4, 16, 1, 2, hp.n_head_kv, hp.head_dim,
                                hp.head_dim_v, dtype=torch.float32)
    hp.swa_window = 8     # an iSWA cache, all its layers in the full tier
    try:
        return TK.iswa_cache_init(hp, 1, 32, dtype=torch.float32)
    finally:
        hp.swa_window = 0


@pytest.mark.parametrize("kind", ["q8_0", "q4_0", "paged", "iswa"])
def test_refused_caches_raise(models, kind):
    _, tm = models["deepseek2", GGMLType.F32]
    hp = tm.hparams
    hp_q4 = type(hp)(**{**hp.__dict__, "head_dim": 32, "head_dim_v": 32})
    cache = _refused_cache(kind, hp_q4 if kind == "q4_0" else hp)
    with pytest.raises(ValueError, match="float KV cache|flat dense"):
        deepseek2_forward(tm.params, hp, torch.zeros((1, 1), dtype=torch.int64),
                          torch.zeros((1, 1), dtype=torch.int32), cache)


def test_engine_with_a_q8_0_cache_fails_the_request(models, torch_one_thread):
    _, tm = models["plm", GGMLType.F32]
    eng = Engine(tm, n_slots=1, n_ctx=32, kv_dtype="q8_0", device="cpu")
    with pytest.raises(ValueError, match="float KV cache"):
        eng.generate(prompt(8, 5), max_tokens=2, stop_eog=False)


def test_the_jax_q8_0_cache_fault(models):
    """The fault the refusal answers: the JAX forward attends over a Q8_0
    cache's int8 codes without their scales, so its logits are far from its
    own float cache's (relative error above 0.1)."""
    jm, _ = models["deepseek2", GGMLType.F32]
    ids = np.asarray([prompt(12, 6)], np.int32)
    f = np.asarray(JaxContext(jm, n_ctx=32, kv_dtype=jnp.float32).forward(ids))
    q = np.asarray(JaxContext(jm, n_ctx=32, kv_dtype="q8_0").forward(ids))
    assert float(np.linalg.norm(q - f) / np.linalg.norm(f)) > 0.1


@pytest.mark.parametrize("K,N", [(2048, 576), (512, 4096), (2048, 3072), (2048, 2048)],
                         ids=["wkv_a", "wkv_b", "wq", "wo"])
def test_plans_take_the_mla_widths(K, N):
    """DeepSeek-V2-Lite's MLA matmuls (K, N): qmv's plan covers every
    column and K unit with its blocks; qmm's split covers K's 128-wide
    tiles."""
    for fmt in range(len(qm._QMV_UNIT)):
        unit = qm._QMV_UNIT[fmt]
        if K % unit:
            continue
        plan = qm.qmv_plan(fmt, K, N)
        assert plan.cl * plan.per >= K // unit and -(-N // plan.bn) * plan.cl == plan.blocks
    n_split, per = qm.qmm_plan(K, N)
    assert n_split * per >= -(-K // 128) > (n_split - 1) * per
