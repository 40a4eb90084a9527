"""The dense architecture registry of the port against the JAX package, on
the CPU (its routes, fused tensors and forward extras:
tests/test_torch_archs_routes.py):

 - the ``ops/ref.py`` functions the new architectures call (LayerNorm,
   xIELU, quick GELU, gpt-oss's clamped swiglu, every gate-less activation,
   ``top_k_mask``), M-RoPE / IMROPE, ALiBi's slopes and the per-head mask
   of the grouped-query path, each against the JAX function;
 - the registry: every name the JAX package sends to ``llama_forward`` or
   ``deepseek2_forward`` is served, each with a parity case of its own (the
   dense ones in tests/test_torch_archs_1..11.py, the MoE ones in
   tests/test_torch_archs_moe_1..3.py, llama4 in tests/test_torch_llama4.py,
   the MLA ones in tests/test_torch_mla.py); all 106 names of the JAX
   registry resolve to the counterpart of their JAX forward (the diffusion
   names' parity cases in tests/test_torch_diffusion.py), the encoders,
   T5 and the WavTokenizer decoder name the entry point that runs them,
   and ``_check_supported`` refuses only the expert-parallel MoE of
   ``moe_mesh`` (item 9).

Tolerances: ops to rtol = atol = 1e-6 (f32, the same formulas; M-RoPE and
attention 1e-5), ALiBi's slopes and ``top_k_mask`` bit-equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.models import llama as jllama
from superllama_tpu.models import qwen2vl as jqwen2vl
from superllama_tpu.models import registry as jregistry
from superllama_tpu.ops import jnp_ref as jops
from superllama_tpu_torch.models import llama as tllama
from superllama_tpu_torch.models import qwen2vl as tqwen2vl
from superllama_tpu_torch.models import registry as tregistry
from superllama_tpu_torch.ops import ref as tops
from superllama_tpu_torch.runtime.kv_cache import kv_cache_init
from test_torch_fixtures import (LINEAR_REGISTERED, MOE_REGISTERED, REGISTERED, SSM_REGISTERED,
                                 arch_models)

OPS_TOL = dict(rtol=1e-6, atol=1e-6)


def _x(*shape, seed=0, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("weight,bias", [(True, True), (True, False), (False, False)],
                         ids=["affine", "no_bias", "non_parametric"])
def test_layer_norm_matches_jax(weight, bias):
    x, w, b = _x(3, 5, 64), _x(64, seed=1), _x(64, seed=2)
    ref = jops.layer_norm(jnp.asarray(x), jnp.asarray(w) if weight else None,
                          jnp.asarray(b) if bias else None, 1e-5)
    got = tops.layer_norm(torch.from_numpy(x), torch.from_numpy(w) if weight else None,
                          torch.from_numpy(b) if bias else None, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPS_TOL)


@pytest.mark.parametrize("name", sorted(tops.ACT_FNS))
def test_gateless_activation_matches_jax(name):
    assert set(tops.ACT_FNS) == set(jops.ACT_FNS)
    x = _x(4, 96)
    np.testing.assert_allclose(tops.ACT_FNS[name](torch.from_numpy(x)).numpy(),
                               np.asarray(jops.ACT_FNS[name](jnp.asarray(x))), **OPS_TOL)


def test_xielu_quick_gelu_and_swiglu_oai_match_jax():
    x, g, u = _x(4, 96), _x(4, 96, seed=1, scale=6.0), _x(4, 96, seed=2, scale=6.0)
    for raw in ((0.8, 0.5, 0.5, -1e-6), (-0.4, 1.2, 0.25, -1e-6)):
        ref = jops.xielu(jnp.asarray(x), *(np.float32(v) for v in raw))
        np.testing.assert_allclose(tops.xielu(torch.from_numpy(x), *raw).numpy(),
                                   np.asarray(ref), **OPS_TOL)
    np.testing.assert_allclose(tops.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jops.quick_gelu(jnp.asarray(x))), **OPS_TOL)
    np.testing.assert_allclose(
        tops.swiglu_oai(torch.from_numpy(g), torch.from_numpy(u), 1.702, 7.0).numpy(),
        np.asarray(jops.swiglu_oai(jnp.asarray(g), jnp.asarray(u), 1.702, 7.0)), **OPS_TOL)


@pytest.mark.parametrize("k", [1, 5, 40])
def test_top_k_mask_matches_jax(k):
    x = _x(3, 64)
    x[0, :8] = x[0, 0]                       # a tie at the threshold
    np.testing.assert_array_equal(tops.top_k_mask(torch.from_numpy(x), k).numpy(),
                                  np.asarray(jops.top_k_mask(jnp.asarray(x), k)))


@pytest.mark.parametrize("sections,interleaved", [((2, 3, 3), False), ((16, 24, 24), False),
                                                  ((4, 2, 2), True), ((24, 20, 20), True)],
                         ids=["mrope_small", "mrope_qwen2vl", "imrope_small", "imrope_qwen3vl"])
def test_mrope_apply_matches_jax(sections, interleaved):
    D = 2 * sum(sections) if not interleaved else (16 if sections[0] == 4 else 128)
    half = D // 2
    np.testing.assert_array_equal(tqwen2vl._imrope_owner(sections, half).numpy(),
                                  jqwen2vl._imrope_owner(sections, half))
    x = _x(2, 5, 3, D)
    pos3 = np.random.default_rng(1).integers(0, 50, (3, 2, 5)).astype(np.int32)
    inv = (10000.0 ** (-np.arange(0, D, 2, dtype=np.float32) / D)).astype(np.float32)
    ref = jqwen2vl.mrope_apply(jnp.asarray(x), jnp.asarray(pos3), jnp.asarray(inv), sections,
                               interleaved=interleaved)
    got = tqwen2vl.mrope_apply(torch.from_numpy(x), torch.from_numpy(pos3),
                               torch.from_numpy(inv), sections, interleaved=interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,max_bias", [(4, 8.0), (12, 8.0), (6, 4.0)])
def test_alibi_slopes_equal_jax_schedule(H, max_bias):
    """The JAX forward's slope list (llama.py:471-476), bit for bit."""
    n2 = 1 << (H.bit_length() - 1)
    m0, m1 = 2.0 ** (-max_bias / n2), 2.0 ** (-max_bias / (2 * n2))
    want = np.asarray([m0 ** (i + 1) if i < n2 else m1 ** (2 * (i - n2) + 1)
                       for i in range(H)], np.float32)
    np.testing.assert_array_equal(tllama.alibi_slopes(H, max_bias, "cpu").numpy(), want)


@pytest.mark.parametrize("fn", ["attention_gqa", "attention_ref"])
def test_per_head_mask_attention_matches_jax(fn):
    B, T, H, Hkv, S, D = 2, 3, 6, 2, 10, 16
    q, k, v = _x(B, T, H, D), _x(B, Hkv, S, D, seed=1), _x(B, Hkv, S, D, seed=2)
    mask = _x(B, H, T, S, seed=3)
    ref = getattr(jops, fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    got = getattr(tops, fn)(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ registry


def _jax_llama_names() -> set:
    return {a for a in jregistry.supported_archs()
            if jregistry.get_forward(a) is jllama.llama_forward}


def test_every_registered_arch_has_a_parity_case():
    assert set(tregistry.LLAMA_ARCHS) == set(REGISTERED)
    assert set(tregistry.MOE_ARCHS) == set(MOE_REGISTERED)
    for arch in REGISTERED + MOE_REGISTERED:
        assert tregistry.get_forward(arch) is tllama.llama_forward
    assert set(REGISTERED) | set(MOE_REGISTERED) <= _jax_llama_names()
    assert set(tregistry.SSM_ARCHS) == set(SSM_REGISTERED)
    assert set(tregistry.LINEAR_ARCHS) == set(LINEAR_REGISTERED)
    for arch in SSM_REGISTERED + LINEAR_REGISTERED:   # the JAX module's forward, by name
        jfn, tfn = jregistry.get_forward(arch), tregistry.get_forward(arch)
        assert (tfn.__name__, tfn.__module__.split(".")[-1]) == (
            jfn.__name__, jfn.__module__.split(".")[-1])


# llama4 and the MLA names: tests/test_torch_llama4.py, tests/test_torch_mla.py;
# the SSM names: tests/test_torch_archs_ssm.py; the linear-attention and
# short-conv names: tests/test_torch_archs_linear.py; the diffusion names:
# tests/test_torch_diffusion.py
SERVED = (set(REGISTERED) | set(MOE_REGISTERED) | {"llama4", "deepseek2", "minicpm3", "plm"}
          | set(SSM_REGISTERED) | set(LINEAR_REGISTERED))


def test_every_jax_registry_name_resolves_to_its_counterpart():
    """All 106 names of the JAX registry resolve in the port's to the
    forward of the same name in the module of the same name; the names no
    registry holds (the encoders, T5, the WavTokenizer decoder) name the
    entry point that runs them."""
    names = set(jregistry.supported_archs())
    assert len(names) == 106 and set(tregistry._REGISTRY) == names
    assert SERVED | set(tregistry.TEXT_PATH_ARCHS) | set(tregistry.DIFFUSION_ARCHS) == names
    assert not hasattr(tregistry, "WAITING")
    for arch in sorted(names):
        jfn, tfn = jregistry.get_forward(arch), tregistry.get_forward(arch)
        assert (tfn.__name__, tfn.__module__.split(".")[-1]) == (
            jfn.__name__, jfn.__module__.split(".")[-1]), arch
    for arch, where in tregistry.OWN_PATHS.items():
        with pytest.raises(NotImplementedError, match=f"runs through {where}"):
            tregistry.get_forward(arch)
        tregistry.check_loadable(arch)
    with pytest.raises(NotImplementedError, match="registry has no such name"):
        tregistry.get_forward("no-such-arch")


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    return tmp_path_factory.mktemp("archs")


@pytest.fixture(scope="module")
def llama(d):
    return arch_models(d, "llama")


@pytest.mark.parametrize("what", ["moe_mesh"])
def test_check_supported_refuses_only_item_3(llama, what):
    _, tm = llama
    hp = type(tm.hparams)(**{**tm.hparams.__dict__, "extra": {what: {}}})
    cache = kv_cache_init(hp.n_layer, 1, 8, hp.n_head_kv, hp.head_dim, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="item 9"):
        tllama.llama_forward(tm.params, hp, torch.zeros((1, 1), dtype=torch.int64),
                             torch.zeros((1, 1), dtype=torch.int32), cache)
