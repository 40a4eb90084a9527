"""The dense architecture registry's routes, fused tensors and forward
extras against the JAX package, on the CPU (its ops and names:
tests/test_torch_archs.py):

 - the routes: ALiBi and ``attn_mask`` steps keep off the flash and decode
   kernels, a layer with fewer kv heads than the cache keeps off the decode
   kernel, each with the JAX logits (its kernels in interpret mode); ALiBi
   refuses the paged cache;
 - the fused tensors: a fused qkv and gate ∥ up split dense, and a packed
   fused gate ∥ up split into two QTensors before the repack, where the
   JAX loader leaves it fused and its forward fails; bitnet's weight scales
   folded into dense weights, refused on packed ones;
 - the forward's extras: ``embeds``, ``hidden_sink``, ``params["cvec"]``
   (and ``params_from_jax`` carrying it, xIELU and 2-D q/k norms),
   ``mrope_pos3``, ``deepstack_add`` and chameleon's logit suppression.

Tolerances: f32 logits to rtol = atol = 1e-4 (test_torch_model.py's); a
packed model's steps of at most 16 rows quantize activations to int8, so
those logits are held to NMSE < 5e-4 against the JAX dense model.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.models import llama as jllama
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime.kv_cache import kv_cache_init as jax_cache
from superllama_tpu_torch.convert import params_from_jax
from superllama_tpu_torch.gguf import GGMLType
from superllama_tpu_torch.models import llama as tllama
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.ops.qtensor import QTensor, dequant_qtensor
from superllama_tpu_torch.runtime.kv_cache import kv_cache_init
from superllama_tpu_torch.runtime.paged_kv import paged_cache_init
from test_torch_fixtures import (ARCH_TOL, arch_models, arch_spec, arch_steps,  # noqa: F401
                                 torch_one_thread, write_arch_gguf)

NMSE_ACT_QUANT = 5e-4


def _x(*shape, seed=0, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    return tmp_path_factory.mktemp("archs")


@pytest.fixture(scope="module")
def llama(d):
    return arch_models(d, "llama")


# ------------------------------------------------------------------ routes


class _Spy:
    """Counts the calls of a function of the port's llama module, calling
    through to it."""

    def __init__(self, monkeypatch, name):
        self.fn, self.n = getattr(tllama, name), 0
        monkeypatch.setattr(tllama, name, self)

    def __call__(self, *a, **k):
        self.n += 1
        return self.fn(*a, **k)


def _routes(monkeypatch):
    return {n: _Spy(monkeypatch, n) for n in ("flash_attention", "flash_decode_attention")}


def _both(jm, tm, steps, extra, flash, mask=None, kv_dtype=(jnp.float32, torch.float32)):
    """Each step through both forwards on one dense cache each, the JAX
    kernels in interpret mode where its route reaches them."""
    hp_j = type(jm.hparams)(**{**jm.hparams.__dict__, "extra": {**jm.hparams.extra, **extra}})
    hp_t = type(tm.hparams)(**{**tm.hparams.__dict__, "extra": {**tm.hparams.extra, **extra}})
    shape = (hp_t.n_layer, 1, 32, hp_t.n_head_kv, hp_t.head_dim)
    jc, tc = jax_cache(*shape, dtype=kv_dtype[0]), kv_cache_init(*shape, dtype=kv_dtype[1])
    step = jax.jit(lambda p, t, ps, c, m: jllama.llama_forward(p, hp_j, t, ps, c, flash=flash,
                                                               attn_mask=m))
    got, ref, n = [], [], 0
    for s in steps:
        T = s.shape[1]
        pos = np.arange(n, n + T, dtype=np.int32)[None]
        m = None if mask is None else mask[:, :, n:n + T]
        n += T
        r, jc = step(jm.params, jnp.asarray(s, jnp.int32), jnp.asarray(pos), jc,
                     None if m is None else jnp.asarray(m))
        with torch.no_grad():
            g, _ = tllama.llama_forward(tm.params, hp_t, torch.from_numpy(s),
                                        torch.from_numpy(pos), tc, flash=flash,
                                        attn_mask=None if m is None else torch.from_numpy(m))
        got.append(g.numpy())
        ref.append(np.asarray(r))
    return got, ref


FLASH_EVERYWHERE = {"flash_decode": True, "flash_decode_float": True}


@pytest.mark.parametrize("arch", ["bloom", "mpt"])
def test_alibi_keeps_off_the_flash_and_decode_kernels(d, arch, monkeypatch):
    jm, tm = arch_models(d, arch)
    spies = _routes(monkeypatch)
    got, ref = _both(jm, tm, arch_steps(tm.hparams.n_vocab), FLASH_EVERYWHERE, flash=True)
    assert [s.n for s in spies.values()] == [0, 0]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **ARCH_TOL)
    hp = tm.hparams
    pcache = paged_cache_init(hp.n_layer, 4, 16, 1, 2, hp.n_head_kv, hp.head_dim,
                              dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="alibi"):
        tllama.llama_forward(tm.params, hp, torch.zeros((1, 1), dtype=torch.int64),
                             torch.zeros((1, 1), dtype=torch.int32), pcache)


@pytest.mark.parametrize("arch,fa,fd", [("deci", 1, 1), ("openelm", 2, 1)])
def test_per_layer_heads_route(d, arch, fa, fd, monkeypatch):
    """deci: one attention layer of four (the others attention-free, linear
    or FFN-free); openelm: layer 0 has one kv head of the cache's two, so its
    decode-sized steps take the plain path. A prefill with flash runs ``fa``
    flash calls; without flash each of the three decode-sized steps (T·G ≤
    32: the 12-token prefill too) makes ``fd`` calls of the decode kernel."""
    jm, tm = arch_models(d, arch)
    spies = _routes(monkeypatch)
    steps = arch_steps(tm.hparams.n_vocab)
    got, ref = _both(jm, tm, steps[:1], FLASH_EVERYWHERE, flash=True)
    assert [s.n for s in spies.values()] == [fa, 0]
    got2, ref2 = _both(jm, tm, steps, FLASH_EVERYWHERE, flash=False)
    assert spies["flash_decode_attention"].n == 3 * fd
    for g, r in zip(got + got2, ref + ref2):
        np.testing.assert_allclose(g, r, **ARCH_TOL)


def test_attn_mask_keeps_off_the_flash_and_decode_kernels(llama, monkeypatch):
    """A tree mask (lookahead's): prefill and decode steps with a custom
    additive mask, flash asked for, take the plain path."""
    jm, tm = llama
    spies = _routes(monkeypatch)
    steps = arch_steps(tm.hparams.n_vocab)
    mask = np.where(np.tril(np.ones((14, 32), bool)) & (np.arange(32) % 3 != 1), 0.0,
                    -np.inf).astype(np.float32)[None, None]
    mask[..., 0] = 0.0
    got, ref = _both(jm, tm, steps, FLASH_EVERYWHERE, flash=True, mask=mask)
    assert [s.n for s in spies.values()] == [0, 0]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **ARCH_TOL)


# ------------------------------------------------------------------ fused tensors


def test_fused_qkv_and_gate_up_split_dense(d):
    """phi3's fused attn_qkv and gate ∥ up, f32: the port's split tensors
    equal the JAX loader's."""
    jm, tm = arch_models(d, "phi3")
    for jl, tl in zip(jm.params["layers"], tm.params["layers"]):
        assert "qkv" not in tl and "attn_qkv" not in tl
        for key in ("wq", "wk", "wv", "ffn_gate", "ffn_up"):
            np.testing.assert_array_equal(tl[key].numpy(), np.asarray(jl[key]), err_msg=key)


@pytest.fixture(scope="module")
def phi3_q8(d):
    """phi3 in Q8_0: the JAX model dense, the port's packed."""
    jm_dense, _ = arch_models(d, "phi3", GGMLType.Q8_0)
    jm_packed, tm = arch_models(d, "phi3", GGMLType.Q8_0, keep_quantized=True)
    return jm_dense, jm_packed, tm


def test_packed_gate_up_splits_into_two_qtensors(phi3_q8):
    jm_dense, _, tm = phi3_q8
    F = tm.hparams.n_ff
    for jl, tl in zip(jm_dense.params["layers"], tm.params["layers"]):
        for key in ("ffn_gate", "ffn_up"):
            assert isinstance(tl[key], QTensor) and tl[key].N == F
            np.testing.assert_array_equal(dequant_qtensor(tl[key]).numpy(), np.asarray(jl[key]),
                                          err_msg=key)
        assert not isinstance(tl["wq"], QTensor)     # a fused qkv is read dense


def test_jax_loader_leaves_a_packed_gate_up_fused(phi3_q8):
    """The fault of the reference the port repairs: keep_quantized leaves
    the fused ffn_up a (E, 2F) QTensor without ffn_gate; the JAX forward's
    quantized kernels then read past ffn_down's rows (NaN logits at ≤ 32
    rows), and its > 32-row matmul raises on the widths."""
    _, jm_packed, tm = phi3_q8
    layer = jm_packed.params["layers"][0]
    assert "ffn_gate" not in layer and layer["ffn_up"].N == 2 * tm.hparams.n_ff
    hp = jm_packed.hparams

    def step(T):
        cache = jax_cache(hp.n_layer, 1, 64, hp.n_head_kv, hp.head_dim, dtype=jnp.float32)
        fwd = jax.jit(lambda p, t, ps, c: jllama.llama_forward(p, hp, t, ps, c)[0])
        return fwd(jm_packed.params, jnp.zeros((1, T), jnp.int32),
                   jnp.arange(T, dtype=jnp.int32)[None], cache)

    assert not np.isfinite(np.asarray(step(4))).all()
    with pytest.raises(TypeError):
        step(40)


def test_packed_phi3_matches_jax_dense(phi3_q8, torch_one_thread):
    """The packed port on qmv (≤ 16 rows) against the JAX package's
    dequantized model: the activation-quantization budget."""
    jm_dense, _, tm = phi3_q8
    got, ref = _both(jm_dense, tm, arch_steps(tm.hparams.n_vocab), {}, flash=False)
    for g, r in zip(got, ref):
        assert _nmse(g, r) < NMSE_ACT_QUANT


def test_bitnet_scales_fold_into_dense_weights_only(d):
    """bitnet's per-tensor scales fold into the f32 weights as the JAX
    loader folds them; a packed weight with a scale raises in both."""
    jm, tm = arch_models(d, "bitnet")
    for jl, tl in zip(jm.params["layers"], tm.params["layers"]):
        np.testing.assert_array_equal(tl["wq"].numpy(), np.asarray(jl["wq"]))
    path = write_arch_gguf(d / "bitnet_q8.gguf", *arch_spec("bitnet"), GGMLType.Q8_0)
    with pytest.raises(NotImplementedError, match="dense weights"):
        jax_load(path, keep_quantized=True)
    with pytest.raises(NotImplementedError, match="dense weights"):
        load_model(path, keep_quantized=True, device="cpu")


# ------------------------------------------------------------------ forward extras


def _fwd_pair(jm, tm, T=6, sinks=(None, None), **kw):
    """One T-token prefill through both forwards with the same keyword
    arguments (numpy arrays, converted per side) and ``sinks`` (the JAX
    forward's hidden_sink, the port's); returns (got, ref)."""
    hp = tm.hparams
    tok = np.asarray(arch_steps(hp.n_vocab)[0][:, :T])
    pos = np.arange(T, dtype=np.int32)[None]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jc = jax_cache(hp.n_layer, 1, 16, hp.n_head_kv, hp.head_dim, dtype=jnp.float32)
    tc = kv_cache_init(hp.n_layer, 1, 16, hp.n_head_kv, hp.head_dim, dtype=torch.float32)

    def run(p, t, ps, c, kw):       # the JAX taps come out of the jitted step
        sink = [] if sinks[0] is not None else None
        lg, _ = jllama.llama_forward(p, jm.hparams, t, ps, c, hidden_sink=sink, **kw)
        return lg, sink

    ref, jsink = jax.jit(run)(jm.params, jnp.asarray(tok, jnp.int32), jnp.asarray(pos), jc, jkw)
    if sinks[0] is not None:
        sinks[0].extend(jsink)
    with torch.no_grad():
        got, _ = tllama.llama_forward(tm.params, hp, torch.from_numpy(tok),
                                      torch.from_numpy(pos), tc, hidden_sink=sinks[1], **tkw)
    return got.numpy(), np.asarray(ref)


def test_hidden_sink_and_embeds_match_jax(llama):
    jm, tm = llama
    E = tm.hparams.n_embd
    emb = _x(1, 6, E, scale=0.5)
    got, ref = _fwd_pair(jm, tm, embeds=emb)
    np.testing.assert_allclose(got, ref, **ARCH_TOL)
    js, ts = [], []
    got, ref = _fwd_pair(jm, tm, sinks=(js, ts))
    np.testing.assert_allclose(got, ref, **ARCH_TOL)
    assert len(ts) == len(js) == tm.hparams.n_layer
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ARCH_TOL)


def test_cvec_param_matches_jax(llama):
    jm, tm = llama
    cv = _x(tm.hparams.n_layer, tm.hparams.n_embd, scale=0.3)
    jparams = {**jm.params, "cvec": jnp.asarray(cv)}
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tm.hparams,
                              device="cpu")
    jm2, tm2 = type(jm)(jm.hparams, jparams, None, {}), type(tm)(tm.hparams, tparams, None, {})
    got, ref = _fwd_pair(jm2, tm2)
    base, _ = _fwd_pair(jm, tm)
    np.testing.assert_allclose(got, ref, **ARCH_TOL)
    assert not np.allclose(got, base, rtol=1e-3, atol=1e-3)


def test_params_from_jax_carries_xielu_and_2d_qk_norms(d):
    for arch in ("apertus", "chameleon"):
        jm, tm = arch_models(d, arch)
        conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), tm.hparams,
                               device="cpu")
        for cl, tl in zip(conv["layers"], tm.params["layers"]):
            assert set(cl) == set(tl)
            for k, v in tl.items():
                if k == "xielu":
                    assert cl[k] == v and all(type(f) is float for f in v)
                else:
                    torch.testing.assert_close(cl[k], v, rtol=0, atol=0, msg=k)


def test_mrope_pos3_and_deepstack_match_jax(d):
    """qwen2vl with distinct t / h / w streams, qwen3vl (IMROPE) with
    DeepStack taps on its first layer."""
    jm, tm = arch_models(d, "qwen2vl")
    pos3 = np.stack([np.arange(6), np.arange(6) // 2, np.arange(6) % 3]).astype(np.int32)
    got, ref = _fwd_pair(jm, tm, mrope_pos3=pos3[:, None])
    np.testing.assert_allclose(got, ref, **ARCH_TOL)
    jm, tm = arch_models(d, "qwen3vl")
    ds = _x(1, 1, 6, tm.hparams.n_embd, scale=0.2)
    got, ref = _fwd_pair(jm, tm, mrope_pos3=pos3[:, None], deepstack_add=ds)
    np.testing.assert_allclose(got, ref, **ARCH_TOL)


def test_chameleon_suppresses_image_logits_on_decode_steps(d):
    jm, tm = arch_models(d, "chameleon")
    lo, hi = tm.hparams.extra["logit_suppress"]
    got, ref = _both(jm, tm, arch_steps(tm.hparams.n_vocab), {}, flash=False)
    assert (got[0][..., lo:hi] > -1e30).all()                 # a 12-row step: not touched
    for g in got[1:]:
        assert (g[..., lo:hi] == np.finfo(np.float32).min).all()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **ARCH_TOL)
