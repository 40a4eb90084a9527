"""Port parity of the linear-attention and short-conv names (rwkv6, rwkv7,
arwkv7, rwkv6qwen2, lfm2, lfm2moe, qwen3next, gemma3n) against the JAX
package, on the CPU:

 - each mixer against the JAX one, on the tiny specs' layers: RWKV-6's time
   mix and qrwkv's (rwkv6qwen2), RWKV-7's on its first layer (v_first taken)
   and a later one (v_first mixed in), both channel mixes, lfm2's
   ``shortconv_mixer`` and qwen3next's ``_linear_layer`` in both layouts
   (the ecosystem's ``attn_qkv`` + ``attn_gate``, the fused ``ssm_in``):
   outputs and every state;
 - each mixer's prefill of 5 tokens equal to a prefill of 3 then two steps
   (the token shift, the conv and the recurrent state carry);
 - each name's tiny GGUF (tests/test_torch_fixtures.py::arch_spec:
   ref_arch_specs' tensor sets, their vocabulary cut to 512, gemma3n grown
   to 7 layers with a shared-KV tail; ``qwen3next_spec``) through both
   packages' Context, a 12-token prefill and two decode steps, f32 weights,
   logits to ARCH_TOL;
 - each file's hparams equal to the JAX ``read_hparams``'s, field by field;
 - the loader's new tensors: the port's load of each file equal to the JAX
   loader's tree carried across by ``params_from_jax``, tensor by tensor.

Tolerances: the mixers 1e-5 (rtol and atol, f32), the forwards ARCH_TOL;
prefill against steps 1e-5; the loads exact.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from superllama_tpu.models import lfm2 as jlfm2
from superllama_tpu.models import qwen3next as jq3n
from superllama_tpu.models import rwkv as jrwkv
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime import Context as JaxContext
from superllama_tpu_torch.convert import params_from_jax
from superllama_tpu_torch.models import lfm2 as tlfm2
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models import qwen3next as tq3n
from superllama_tpu_torch.models import rwkv as trwkv
from superllama_tpu_torch.runtime.context import Context
from test_torch_fixtures import (ARCH_N_CTX, ARCH_TOL, LINEAR_REGISTERED, arch_models,
                                 arch_steps, qwen3next_spec, torch_one_thread,  # noqa: F401
                                 write_arch_gguf)

TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 5


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    return tmp_path_factory.mktemp("linear_archs")


@pytest.fixture(scope="module")
def models(d):
    """(JAX model, port model) of each name's f32 file (and of qwen3next's
    fused layout, "qwen3next-fused"), loaded once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            if arch == "qwen3next-fused":
                name, md, tensors = qwen3next_spec(fused=True)
                path = write_arch_gguf(d / "qwen3next_fused.gguf", name, md, tensors)
                cache[arch] = (jax_load(path), load_model(path, device="cpu"))
            else:
                cache[arch] = arch_models(d, arch)
        return cache[arch]
    return get


# ------------------------------------------------------------------ the mixers

# mixer -> (model, layer)
MIXERS = {"rwkv6": ("rwkv6", 0), "qrwkv": ("rwkv6qwen2", 0), "rwkv7_first": ("rwkv7", 0),
          "rwkv7_later": ("rwkv7", 1), "channel_v6": ("rwkv6", 0), "channel_v7": ("rwkv7", 0),
          "shortconv": ("lfm2", 0), "delta_ecosystem": ("qwen3next", 0),
          "delta_fused": ("qwen3next-fused", 0)}


def _states(kind: str, hp, rng) -> dict:
    """Random starting states of the mixer (numpy f32)."""
    E = hp.n_embd
    f = lambda *s, scale=0.3: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    if kind in ("shortconv",):
        return {"conv": f(B, hp.shortconv_l_cache - 1, E)}
    if kind.startswith("delta"):
        return {"conv": f(B, hp.ssm_d_conv - 1, hp.ssm_conv_dim),
                "ssm": f(B, hp.ssm_d_inner, hp.ssm_d_state)}
    out = {"shift": f(B, E)}
    if not kind.startswith("channel"):
        D = hp.wkv_head_size
        out["wkv"] = f(B, E // D, D, D)
    if kind == "rwkv7_later":
        out["v_first"] = f(B, T, E, scale=1.0)
    return out


def _shifted(x, shift, cat):
    return cat([shift[:, None, :], x[:, :-1, :]], 1)


def _jax_mixer(kind, layer, hp, h, st):
    """(outputs, new states) of the JAX mixer, numpy."""
    h = jnp.asarray(h)
    st = {k: jnp.asarray(v) for k, v in st.items()}
    if kind.startswith("delta"):
        y, conv, ssm = jq3n._linear_layer(layer, hp, h, st["conv"], st["ssm"])
        return [y], {"conv": conv, "ssm": ssm}
    if kind == "shortconv":
        y, conv = jlfm2.shortconv_mixer(layer, h, st["conv"])
        return [y], {"conv": conv}
    x_prev = _shifted(h, st["shift"], jnp.concatenate)
    new = {"shift": h[:, -1]}
    if kind.startswith("channel"):
        return [jrwkv._channel_mix(layer, h, x_prev, kind == "channel_v7")], new
    if kind.startswith("rwkv7"):
        y, new["wkv"], vf = jrwkv._rwkv7_time_mix(layer, hp, h, x_prev, st["wkv"],
                                                  st.get("v_first"))
        return [y, vf], new
    y, new["wkv"] = jrwkv._rwkv6_time_mix(layer, hp, h, x_prev, st["wkv"])
    return [y], new


def _port_mixer(kind, layer, hp, h, st):
    """The port's mixer over h with the states (torch, updated in place;
    the token shift carried here, as the forward carries it)."""
    if kind.startswith("delta"):
        return [tq3n._linear_layer(layer, hp, h, st["conv"], st["ssm"])]
    if kind == "shortconv":
        return [tlfm2.shortconv_mixer(layer, h, st["conv"])]
    x_prev = _shifted(h, st["shift"], torch.cat)
    st["shift"].copy_(h[:, -1])
    if kind.startswith("channel"):
        return [trwkv._channel_mix(layer, h, x_prev, kind == "channel_v7")]
    if kind.startswith("rwkv7"):
        vf = st.get("v_first")
        return list(trwkv._rwkv7_time_mix(layer, hp, h, x_prev, st["wkv"],
                                          None if vf is None else vf[:, :h.shape[1]]))
    return [trwkv._rwkv6_time_mix(layer, hp, h, x_prev, st["wkv"])]


def _case(models, kind, seed=0):
    arch, il = MIXERS[kind]
    jm, tm = models(arch)
    rng = np.random.default_rng([seed, len(kind)])
    h = rng.standard_normal((B, T, tm.hparams.n_embd)).astype(np.float32)
    return jm, tm, il, h, _states(kind, tm.hparams, rng)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_matches_jax(models, kind, torch_one_thread):
    jm, tm, il, h, st = _case(models, kind)
    ref, ref_st = _jax_mixer(kind, jm.params["layers"][il], jm.hparams, h, st)
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    with torch.no_grad():
        got = _port_mixer(kind, tm.params["layers"][il], tm.hparams, torch.from_numpy(h), tst)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    for k, r in ref_st.items():
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_prefill_then_steps_equals_one_prefill(models, kind, torch_one_thread):
    _, tm, il, h, st = _case(models, kind, seed=1)
    layer, hp = tm.params["layers"][il], tm.hparams
    one = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    parts = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ht = torch.from_numpy(h)
    with torch.no_grad():
        whole = _port_mixer(kind, layer, hp, ht, one)[0]
        pieces = []
        for a, b in ((0, 3), (3, 4), (4, 5)):
            if "v_first" in st:
                parts["v_first"] = one["v_first"][:, a:]
            pieces.append(_port_mixer(kind, layer, hp, ht[:, a:b], parts)[0])
    np.testing.assert_allclose(torch.cat(pieces, 1).numpy(), whole.numpy(), **TOL)
    for k in one:
        if k != "v_first":
            np.testing.assert_allclose(parts[k].numpy(), one[k].numpy(), **TOL)


# ------------------------------------------------------------------ the names


def _logits(jm, tm) -> tuple[list, list]:
    """Each step's logits through both packages' Context on the model's own
    memory (recurrent, hybrid, or gemma3n's iSWA cache)."""
    jc = JaxContext(jm, n_batch=1, n_ctx=ARCH_N_CTX)
    tc = Context(tm, n_batch=1, n_ctx=ARCH_N_CTX, device="cpu")
    steps = arch_steps(tm.hparams.n_vocab)
    ref = [np.asarray(jc.forward(s.astype(np.int32))) for s in steps]
    got = [tc.forward(s).numpy() for s in steps]
    return got, ref


@pytest.mark.parametrize("arch", LINEAR_REGISTERED)
def test_linear_arch_matches_jax(models, arch, torch_one_thread):
    jm, tm = models(arch)
    got, ref = _logits(jm, tm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **ARCH_TOL)


@pytest.mark.parametrize("arch", LINEAR_REGISTERED)
def test_hparams_match_jax(models, arch):
    """The port's hparams of each file equal the JAX ``read_hparams``'s,
    field by field: ``wkv.head_size``, ``rescale_every_n_layers``,
    ``shortconv.l_cache``, qwen3next's recurrent layers, ``extra["gemma3n"]``."""
    jm, tm = models(arch)
    assert vars(tm.hparams) == vars(jm.hparams)
    hp = tm.hparams
    assert ([hp.is_recurrent_layer(il) for il in range(hp.n_layer)]
            == [jm.hparams.is_recurrent_layer(il) for il in range(hp.n_layer)])
    assert (hp.is_hybrid, hp.is_recurrent, hp.recurrent_kind) == (
        jm.hparams.is_hybrid, jm.hparams.is_recurrent, jm.hparams.recurrent_kind)


@pytest.mark.parametrize("arch", LINEAR_REGISTERED + ("qwen3next-fused",))
def test_loader_matches_the_jax_loader(models, arch):
    """The port's load equals the JAX loader's tree carried across, tensor
    by tensor: the RWKV block, ``ssm_ba`` and qwen3next's unsplit
    ``ssm_qkv``, the short conv and lfm2's moved final norm, gemma3n's
    AltUp / LAUREL / per-layer tensors and its 3-D projections."""
    jm, tm = models(arch)
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), tm.hparams,
                          device="cpu")
    for k, v in tm.params.items():
        if k != "layers":
            assert (got.get(k) is None) == (v is None), k
            if v is not None:
                torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    for jl, tl in zip(got["layers"], tm.params["layers"]):
        assert set(jl) == set(tl)
        for k in tl:
            torch.testing.assert_close(jl[k], tl[k], rtol=0, atol=0)
    hp = tm.hparams
    layer = tm.params["layers"][0]
    if arch.startswith(("rwkv", "arwkv")):
        assert layer["time_mix_receptance"].shape == (hp.n_embd, hp.n_embd)
    if arch == "qwen3next":
        assert "ssm_qkv" in layer and "wq" not in layer and "ssm_beta_alpha" in layer
    if arch.startswith("lfm2"):
        assert tm.params["token_embd_norm"] is None and tm.params["output_norm"] is not None
