"""Port parity of whole models in the new weight formats: tiny llama GGUFs
(``write_tiny_llama_np``'s shapes) quantized by the JAX package to Q4_0, a
Q5_K_M mix (Q5_K, with attn_v, ffn_down and the output in Q6_K), IQ4_XS,
Q2_K and TQ2_0, loaded by both packages with ``keep_quantized``; and split
GGUFs.

Logits agree to atol = rtol = 1e-4 in the continuous regimes (the fused
17-32-row and the dequantized > 32-row matmuls); steps of at most 16 rows
quantize the activations to int8, where a last-bit difference upstream can
move one activation code by a step, so those logits are held to NMSE
5e-4 (``tests/test_torch_model.py`` states why). Greedy Engine tokens agree
exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.gguf import GGMLType, GGUFReader, GGUFWriter
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime import Context as JaxContext
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.tools.gguf_split import split_gguf
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.ops.qtensor import QTensor
from superllama_tpu_torch.runtime.context import Context
from superllama_tpu_torch.runtime.engine import Engine
from test_torch_fixtures import prompt, torch_one_thread, write_tiny_llama_np  # noqa: F401

T = GGMLType
# the type of each 2-D tensor by name, per file (llama.cpp's file types)
MIXES = {
    "Q4_0": lambda name: T.Q4_0,
    "Q5_K_M": lambda name: (T.Q6_K if name == "output.weight" or ".attn_v." in name
                            or ".ffn_down." in name else T.Q5_K),
    "IQ4_XS": lambda name: T.IQ4_XS,
    "Q2_K": lambda name: T.Q2_K,
    "TQ2_0": lambda name: T.TQ2_0,
}
TOL = dict(rtol=1e-4, atol=1e-4)
NMSE_ACT_QUANT = 5e-4
GREEDY = {"greedy": True}


def requantize(src: str, dst: str, pick) -> None:
    """The F32 GGUF src with each 2-D tensor quantized to pick(name) by the
    JAX package's encoders."""
    r = GGUFReader(src)
    w = GGUFWriter(dst, arch=r.metadata["general.architecture"])
    for k, v in r.metadata.items():
        if k != "general.architecture":
            w.add(k, v)
    for name, ti in r.tensors.items():
        if len(ti.ne) == 2:
            w.add_tensor(name, ti.astype_f32(), pick(name))
        else:
            w.add_tensor(name, ti.raw().copy(), ti.ggml_type, raw_ne=ti.ne)
    w.write()
    r.close()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("formats")
    src = write_tiny_llama_np(d)
    out = {}
    for mix, pick in MIXES.items():
        out[mix] = str(d / f"tiny_{mix}.gguf")
        requantize(src, out[mix], pick)
    return out


@pytest.fixture(scope="module")
def models(paths, torch_one_thread):  # noqa: F811
    return {mix: (jax_load(p, keep_quantized=True),
                  load_model(p, keep_quantized=True, device="cpu"))
            for mix, p in paths.items()}


def _assert_close(got, ref, act_quant):
    if act_quant:
        nmse = float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))
        assert nmse < NMSE_ACT_QUANT, nmse
    else:
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("mix", list(MIXES))
def test_loaded_types(models, mix):
    """Every matmul weight loads as a QTensor of its file type in both
    packages, with the same planes."""
    jm, tm = models[mix]
    roles = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
             "ffn_gate": "ffn_gate", "ffn_up": "ffn_up", "ffn_down": "ffn_down"}
    assert tm.params["output"].ggml_type == MIXES[mix]("output.weight")
    for il, (jl, tl) in enumerate(zip(jm.params["layers"], tm.params["layers"])):
        for k, role in roles.items():
            assert isinstance(tl[k], QTensor)
            assert tl[k].ggml_type == jl[k].ggml_type == MIXES[mix](f"blk.{il}.{role}.weight")
            for n in QTensor.PLANES:
                a = getattr(jl[k], n)
                if a is not None:
                    np.testing.assert_array_equal(getattr(tl[k], n).numpy(), np.asarray(a))
    np.testing.assert_array_equal(tm.params["token_embd"].numpy(),
                                  np.asarray(jm.params["token_embd"]))


@pytest.mark.parametrize("T_", [8, 12, 20], ids=["gemv", "fused", "dequant"])
@pytest.mark.parametrize("mix", list(MIXES))
def test_prefill_logits_match_jax(models, mix, T_):
    """B = 2: 16 rows take the int8-activation GEMV, 24 the fused kernel,
    40 the dequantized matmul."""
    jm, tm = models[mix]
    ids = np.array([prompt(T_, 1), prompt(T_, 2)], np.int64)
    ref = np.asarray(JaxContext(jm, n_batch=2, n_ctx=64).forward(ids.astype(np.int32)))
    got = Context(tm, n_batch=2, n_ctx=64, device="cpu").forward(ids)
    _assert_close(got.numpy(), ref, act_quant=2 * T_ <= 16)


@pytest.mark.parametrize("mix", list(MIXES))
def test_decode_steps_match_jax(models, mix):
    jm, tm = models[mix]
    jc, tc = JaxContext(jm, n_batch=1, n_ctx=32), Context(tm, n_batch=1, n_ctx=32, device="cpu")
    for t in prompt(5, 3):
        ref = np.asarray(jc.forward(np.array([t], np.int32)))
        got = tc.forward(np.array([t]))
        _assert_close(got.numpy(), ref, act_quant=True)


@pytest.mark.parametrize("mix", list(MIXES))
def test_engine_greedy_matches_jax(models, mix):
    """A 12-token prompt (one fused chunk) and 12 greedy tokens through each
    package's Engine."""
    jm, tm = models[mix]
    p = prompt(12, 6)
    ref = JaxEngine(jm, n_slots=2, n_ctx=128, kv_dtype=jnp.float32).generate(
        p, max_tokens=12, sampling=GREEDY, stop_eog=False)
    got = Engine(tm, n_slots=2, n_ctx=128, kv_dtype=torch.float32, device="cpu").generate(
        p, max_tokens=12, sampling=GREEDY, stop_eog=False)
    assert got["tokens"] == ref["tokens"]


def _flat(params):
    out = [(k, v) for k, v in params.items() if k != "layers"]
    for i, layer in enumerate(params["layers"]):
        out += [(f"{i}.{k}", v) for k, v in layer.items()]
    return out


def _same(a, b) -> bool:
    if isinstance(a, QTensor):
        return a.ggml_type == b.ggml_type and all(
            (getattr(a, n) is None and getattr(b, n) is None)
            or torch.equal(getattr(a, n), getattr(b, n)) for n in QTensor.PLANES)
    return a is None and b is None or torch.equal(a, b)


@pytest.mark.parametrize("mix,n_split", [("Q4_0", 2), ("Q5_K_M", 3)])
def test_split_gguf_loads_like_the_whole_file(paths, tmp_path, mix, n_split):
    """Shards written by the JAX split tool load, from the first shard's
    path as in the JAX loader (the others carry only split.* metadata), to
    the parameters of the unsplit file, every tensor found."""
    shards = split_gguf(paths[mix], str(tmp_path / "tiny"), n_split=n_split)
    assert len(shards) == n_split
    whole = load_model(paths[mix], keep_quantized=True, device="cpu")
    got = load_model(shards[0], keep_quantized=True, device="cpu")
    a, b = _flat(got.params), _flat(whole.params)
    assert [k for k, _ in a] == [k for k, _ in b]
    assert all(_same(x, y) for (_, x), (_, y) in zip(a, b))
    assert got.hparams == whole.hparams
    assert got.tokenizer.vocab.tokens == whole.tokenizer.vocab.tokens
