"""Port parity: GGUF load + llama forward + greedy generation against the JAX
package, on a tiny llama written offline in F32, Q8_0 and Q4_K.

Both sides load the same file; the port runs on the CPU with the kernels'
plain versions, the JAX package as its own tests run it. Logits agree to
atol = rtol = 1e-4 in f32, and for the quantized models wherever the matmuls
are continuous in their input (the fused 17-32-row and the dequantized >32-row
regimes). Steps of at most 16 rows quantize the activations to int8: there a
last-bit difference upstream (rsqrt, exp and pow differ by an ulp between
XLA and torch) can move one activation code by one step, the same size of
error as the activation quantization itself, so those logits are held to
that budget, NMSE < 5e-4. Greedy tokens agree exactly.
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
from superllama_tpu.runtime.kv_cache import kv_cache_init as jax_cache
from superllama_tpu_torch.convert import params_from_jax
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models.llama import llama_forward
from superllama_tpu_torch.ops.qtensor import QTensor
from superllama_tpu_torch.runtime.context import Context
from superllama_tpu_torch.runtime.kv_cache import kv_cache_init
from test_torch_fixtures import prompt, write_tiny_llama

TYPES = [GGMLType.F32, GGMLType.Q8_0, GGMLType.Q4_K]
IDS = [t.name for t in TYPES]
TOL = dict(rtol=1e-4, atol=1e-4)
NMSE_ACT_QUANT = 5e-4


def _assert_close(got, ref, ttype, act_quant):
    if ttype == GGMLType.F32 or not act_quant:
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        nmse = float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))
        assert nmse < NMSE_ACT_QUANT, nmse


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_tiny_llama(tmp_path_factory.mktemp("tiny"), TYPES)


@pytest.fixture(scope="module")
def models(paths):
    return {t: (jax_load(p, keep_quantized=True),
                load_model(p, keep_quantized=True, device="cpu"))
            for t, p in paths.items()}


@pytest.mark.parametrize("T", [8, 12, 20], ids=["gemv", "fused", "dequant"])
@pytest.mark.parametrize("ttype", TYPES, ids=IDS)
def test_prefill_logits_match_jax(models, ttype, T):
    """B = 2: 16 rows take the int8-activation GEMV, 24 the fused kernel,
    40 the dequantized matmul."""
    jm, tm = models[ttype]
    ids = np.array([prompt(T, 1), prompt(T, 2)], np.int64)
    ref = np.asarray(JaxContext(jm, n_batch=2, n_ctx=64).forward(ids.astype(np.int32)))
    got = Context(tm, n_batch=2, n_ctx=64, device="cpu").forward(ids)
    _assert_close(got.numpy(), ref, ttype, act_quant=2 * T <= 16)


@pytest.mark.parametrize("ttype", TYPES, ids=IDS)
def test_decode_steps_match_jax(models, ttype):
    jm, tm = models[ttype]
    jc, tc = JaxContext(jm, n_batch=1, n_ctx=32), Context(tm, n_batch=1, n_ctx=32, device="cpu")
    for t in prompt(6, 3):
        ref = np.asarray(jc.forward(np.array([t], np.int32)))
        got = tc.forward(np.array([t]))
        _assert_close(got.numpy(), ref, ttype, act_quant=True)


@pytest.mark.parametrize("ttype", TYPES, ids=IDS)
def test_greedy_16_tokens_identical(models, ttype):
    """The prompt is one whose 16 greedy steps keep a top-2 logit margin of
    at least 8e-3 on every type, several times the activation-quantization
    noise between the packages (about 1e-3)."""
    jm, tm = models[ttype]
    p = prompt(5, 6)
    ref = JaxContext(jm, n_batch=1, n_ctx=64).greedy_generate(p, 16, stop_eog=False)
    got = Context(tm, n_batch=1, n_ctx=64, device="cpu").greedy_generate(p, 16, stop_eog=False)
    assert got == ref


@pytest.mark.parametrize("ttype", TYPES, ids=IDS)
def test_flash_prefill_matches_jax(models, ttype):
    """T = 40 ≥ 32: both sides on their flash-attention path."""
    jm, tm = models[ttype]
    hp = tm.hparams
    T = 40
    tok = np.array([prompt(T, 5)], np.int64)
    pos = np.arange(T, dtype=np.int32)[None]
    jc = jax_cache(hp.n_layer, 1, 64, hp.n_head_kv, hp.head_dim, dtype=jnp.float32)
    ref, _ = jax_forward(jm.params, jm.hparams, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(pos), jc, flash=True)
    tcache = kv_cache_init(hp.n_layer, 1, 64, hp.n_head_kv, hp.head_dim,
                           dtype=torch.float32)
    with torch.no_grad():
        got, _ = llama_forward(tm.params, hp, torch.from_numpy(tok),
                               torch.from_numpy(pos), tcache, flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _leaves(params, prefix=""):
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(params, list):
        for i, v in enumerate(params):
            yield from _leaves(v, f"{prefix}/{i}")
    elif isinstance(params, QTensor):
        for n, plane in params.planes().items():
            yield f"{prefix}.{n}", plane
    elif params is not None:
        yield prefix, params


@pytest.mark.parametrize("ttype", TYPES, ids=IDS)
def test_params_from_jax_roundtrip(models, ttype):
    """JAX params → numpy → params_from_jax equals the port's own load, and
    computes the same logits."""
    jm, tm = models[ttype]
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                           tm.hparams, device="cpu")
    want = dict(_leaves(tm.params))
    have = dict(_leaves(conv))
    assert set(have) == set(want)
    for name, t in want.items():
        torch.testing.assert_close(have[name], t, rtol=0, atol=0, msg=name)
    ids = np.array([prompt(7, 6)])
    a = Context(tm, n_ctx=16, device="cpu").forward(ids)
    tm2 = type(tm)(tm.hparams, conv, tm.tokenizer, tm.metadata)
    b = Context(tm2, n_ctx=16, device="cpu").forward(ids)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_hparams_and_tokenizer_match_jax(models):
    jm, tm = models[GGMLType.F32]
    for f in ("arch", "n_vocab", "n_embd", "n_layer", "n_head", "n_head_kv",
              "n_ff", "n_rot", "head_dim", "rms_eps", "rope_freq_base", "rope_type"):
        assert getattr(tm.hparams, f) == getattr(jm.hparams, f), f
    text = "hello wörld, tokens!"
    assert (tm.tokenizer.encode(text, add_special=True, parse_special=True)
            == jm.tokenizer.encode(text, add_special=True, parse_special=True))


def test_unported_features_raise(models):
    _, tm = models[GGMLType.F32]
    hp = type(tm.hparams)(**{**tm.hparams.__dict__, "extra": {"moe_mesh": {}}})
    cache = kv_cache_init(hp.n_layer, 1, 8, hp.n_head_kv, hp.head_dim,
                          dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="item 9"):
        llama_forward(tm.params, hp, torch.zeros((1, 1), dtype=torch.int64),
                      torch.zeros((1, 1), dtype=torch.int32), cache)
