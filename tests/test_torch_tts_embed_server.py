"""The port's TTS pipeline, Embedder and embedding routes against the JAX
package's:

 - ``wavtokenizer_decode`` of a tiny WavTokenizer GGUF (two ResNet blocks,
   the attention block, two more, the group norm; two ConvNeXt blocks)
   loaded by both loaders (every tensor equal), frames within 1e-5; and of
   the JAX tree through ``params_from_jax``; a Q8_0 file loaded dense under
   ``keep_quantized`` (the JAX loader's packed decoder cannot run);
 - ``embd_to_audio``, ``hann_window``, ``save_wav``'s bytes,
   ``process_text`` and ``extract_codes`` equal to the JAX package's;
 - the ``tts`` CLI on a tiny voice LM (the byte vocab, OuteTTS's control
   pieces, the audio codes from id 151,672; its head biased toward the
   codes) and the WavTokenizer file: the WAV's samples within 2 LSB of the
   JAX CLI's;
 - ``Embedder.embed`` (mean, cls, last; texts of other lengths) and
   ``rerank`` with a classification head and by cosine, within 1e-5; the
   head's input "query document" joined by a space in both (a fault of
   the reference, kept);
 - ``ServerApp(embed_model=)``'s ``/v1/embeddings`` and ``/rerank`` bodies
   against the JAX ServerApp's (floats within 1e-5, order and the rest
   equal), the port's over HTTP equal to its handlers';
 - ``serve --embed-model`` accepted: the encoder loaded dense on
   ``--device`` and handed to the app.
Torch runs on one thread (``torch_one_thread``)."""

import json
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superllama_tpu import cli as jcli
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.models.wavtokenizer import wavtokenizer_decode as jax_decode
from superllama_tpu.runtime.embedder import Embedder as JaxEmbedder
from superllama_tpu.server.http import ServerApp as JaxServerApp
from superllama_tpu.tools import tts as jtts
from superllama_tpu_torch import cli
from superllama_tpu_torch.convert import params_from_jax
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models.wavtokenizer import wavtokenizer_decode
from superllama_tpu_torch.runtime.embedder import Embedder
from superllama_tpu_torch.server.http import Server, ServerApp
from superllama_tpu_torch.tools import tts
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from superllama_tpu.gguf import GGMLType
from test_torch_fixtures import (_W, byte_vocab_fields, dense_spec, write_arch_gguf,
                                 write_encoder, write_tiny_llama_np)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

FEAT, PE, CE, NFF, NCODE, NFFT = 12, 16, 16, 32, 64, 16


def wav_spec(PE: int = PE, CE: int = CE, NFF: int = NFF) -> tuple[str, dict, dict]:
    """A tiny WavTokenizer decoder (n_fft 16), numpy order as the loader
    reads it: conv weights (C_out, C_in / groups, K), norms (C, 1) in the
    posnet, ``output`` / ``pw1`` / ``pw2`` as (out, in)."""
    p = _W("wavtokenizer")
    t = p.t
    p.w("token_embd.weight", NCODE, FEAT, scale=0.5)
    p.w("conv1d.weight", PE, FEAT, 7, scale=0.2)
    p.bias("conv1d.bias", PE, 1)
    for il, kind in enumerate(("res", "res", "attn", "res", "res", "norm")):
        b = f"posnet.{il}."
        if kind == "res":
            for n in ("norm1", "norm2"):
                p.norm(b + n + ".weight", PE, 1)
                p.bias(b + n + ".bias", PE, 1)
            for n in ("conv1", "conv2"):
                p.w(b + n + ".weight", PE, PE, 3, scale=0.2)
                p.bias(b + n + ".bias", PE, 1)
        elif kind == "attn":
            p.norm(b + "attn_norm.weight", PE, 1)
            p.bias(b + "attn_norm.bias", PE, 1)
            for n in ("attn_q", "attn_k", "attn_v", "attn_output"):
                p.w(b + n + ".weight", PE, PE, 1, scale=0.3)
                p.bias(b + n + ".bias", PE, 1)
        else:
            p.norm(b + "norm.weight", PE, 1)
            p.bias(b + "norm.bias", PE, 1)
    p.norm("token_embd_norm.weight", PE)
    p.bias("token_embd_norm.bias", PE)
    for il in range(2):
        b = f"convnext.{il}."
        p.w(b + "dw.weight", CE, 1, 7, scale=0.3)
        p.bias(b + "dw.bias", CE, 1)
        p.norm(b + "norm.weight", CE)
        p.bias(b + "norm.bias", CE)
        p.w(b + "pw1.weight", NFF, CE)
        p.bias(b + "pw1.bias", NFF)
        p.w(b + "pw2.weight", CE, NFF)
        p.bias(b + "pw2.bias", CE)
        t[b + "gamma.weight"] = np.full(CE, 0.9, np.float32)
    p.norm("output_norm.weight", CE)
    p.bias("output_norm.bias", CE)
    n_out = 2 * (NFFT // 2 + 1)
    p.w("output.weight", n_out, CE)
    p.bias("output.bias", n_out)
    md = {"embedding_length": CE, "features_length": FEAT, "posnet.embedding_length": PE,
          "posnet.block_count": 6, "convnext.embedding_length": CE,
          "convnext.block_count": 2, "attention.group_norm_groups": 4,
          "attention.group_norm_epsilon": 1e-6, "feed_forward_length": NFF,
          "vocab_size": NCODE, "attention.layer_norm_epsilon": 1e-5}
    return "wavtokenizer-dec", md, t


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    name, md, t = wav_spec()
    return write_arch_gguf(tmp_path_factory.mktemp("wav") / "wt.gguf", name, md, t)


@pytest.fixture(scope="module")
def wav_models(wav_path):
    return jax_load(wav_path), load_model(wav_path, device="cpu")


def test_wavtokenizer_loader_loads_what_jax_loads(wav_models):
    jm, tm = wav_models
    assert tm.tokenizer is None and tm.hparams.posnet_n_layer == 6
    for key, v in jm.params.items():
        if key in ("posnet", "convnext"):
            assert [set(a) for a in v] == [set(b) for b in tm.params[key]]
            for a, b in zip(v, tm.params[key]):
                for k in a:
                    np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)
        else:
            np.testing.assert_array_equal(tm.params[key].numpy(), np.asarray(v), err_msg=key)


@pytest.mark.parametrize("codes", [[1, 5, 9, 20, 33, 2, 7, 40], [63, 0, 17]], ids=["8", "3"])
def test_wavtokenizer_decode_matches_jax(wav_models, codes):
    jm, tm = wav_models
    ref = np.asarray(jax_decode(jm.params, jm.hparams, jnp.asarray([codes, codes[::-1]],
                                                                   jnp.int32)))
    with torch.no_grad():
        got = wavtokenizer_decode(tm.params, tm.hparams,
                                  torch.tensor([codes, codes[::-1]])).numpy()
    assert got.shape == (2, len(codes), 2 * (NFFT // 2 + 1))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_packed_wavtokenizer_loads_dense(tmp_path):
    """A fault of the JAX package that no JAX path meets (ROADMAP §3): its
    loader keeps ``output`` / ``pw1`` / ``pw2`` packed under
    ``keep_quantized`` and its decoder multiplies them with ``@``, which a
    QTensor cannot take (its ``tts`` loads the decoder dense). The port's
    loader loads the decoder dense always: the same frames as the JAX
    package's dense load."""
    name, md, t = wav_spec(PE=32, CE=32, NFF=64)
    path = write_arch_gguf(tmp_path / "wt_q8.gguf", name, md, t, GGMLType.Q8_0)
    packed = jax_load(path, keep_quantized=True)
    codes = [[1, 5, 9, 20]]
    assert type(packed.params["convnext"][0]["pw1"]).__name__ == "QTensor"
    with pytest.raises(TypeError):
        jax_decode(packed.params, packed.hparams, jnp.asarray(codes, jnp.int32))
    tm, jm = load_model(path, keep_quantized=True, device="cpu"), jax_load(path)
    assert isinstance(tm.params["convnext"][0]["pw1"], torch.Tensor)
    with torch.no_grad():
        got = wavtokenizer_decode(tm.params, tm.hparams, torch.tensor(codes)).numpy()
    ref = np.asarray(jax_decode(jm.params, jm.hparams, jnp.asarray(codes, jnp.int32)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_params_from_jax_carries_the_wavtokenizer(wav_models):
    jm, _ = wav_models
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), jm.hparams,
                             device="cpu")
    codes = [3, 8, 1, 60]
    ref = np.asarray(jax_decode(jm.params, jm.hparams, jnp.asarray([codes], jnp.int32)))
    with torch.no_grad():
        got = wavtokenizer_decode(params, jm.hparams, torch.tensor([codes])).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_codes", [1, 5, 12])
def test_embd_to_audio_equals_jax(n_codes):
    embd = np.random.default_rng(n_codes).normal(0, 0.5, (n_codes, 2 * (NFFT // 2 + 1)))
    got = tts.embd_to_audio(embd.astype(np.float32), n_fft=NFFT, n_hop=4)
    np.testing.assert_array_equal(got, jtts.embd_to_audio(embd.astype(np.float32),
                                                          n_fft=NFFT, n_hop=4))
    full = np.random.default_rng(0).normal(0, 0.5, (3, 2 * (tts.N_FFT // 2 + 1)))
    np.testing.assert_array_equal(tts.embd_to_audio(full), jtts.embd_to_audio(full))


def test_text_codes_window_and_wav_equal_jax(tmp_path):
    for text in ("Hello, World! 123", "a-b_c/d.e\\f  G", ""):
        assert tts.process_text(text) == jtts.process_text(text)
    toks = [5, 151671, 151672, 151675, 155767, 155768, 9]
    assert tts.extract_codes(toks) == jtts.extract_codes(toks) == [0, 3, 4095]
    for n, periodic in ((8, True), (9, False), (tts.N_FFT, True)):
        np.testing.assert_array_equal(tts.hann_window(n, periodic),
                                      jtts.hann_window(n, periodic))
    audio = np.sin(np.linspace(0, 40 * np.pi, 2400)).astype(np.float32) * 1.3
    tts.save_wav(str(tmp_path / "a.wav"), audio)
    jtts.save_wav(str(tmp_path / "b.wav"), audio)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


TTS_CONTROL = ("<|im_start|>", "<|text_start|>", "<|text_sep|>", "<|text_end|>",
               "<|audio_start|>")


@pytest.fixture(scope="module")
def voice_path(tmp_path_factory):
    """A one-layer llama over the byte vocab, OuteTTS's control pieces,
    filler pieces up to the code offset and NCODE code pieces; its head's
    bias lifts the code rows, so greedy decoding emits codes."""
    f = byte_vocab_fields()
    n_fill = tts.CODE_OFFSET - len(f["tokenizer.ggml.tokens"]) - len(TTS_CONTROL)
    pieces = (list(f["tokenizer.ggml.tokens"]) + list(TTS_CONTROL)
              + [f"<|fill{i}|>" for i in range(n_fill)]
              + [f"<|c{i}|>" for i in range(NCODE)])
    f["tokenizer.ggml.tokens"] = pieces
    f["tokenizer.ggml.token_type"] = (list(f["tokenizer.ggml.token_type"])
                                      + [3] * len(TTS_CONTROL) + [1] * (n_fill + NCODE))
    name, md, tensors = dense_spec("qwen2", E=16, H=2, HKV=1, D=8, F=32, L=1, V=len(pieces))
    bias = np.zeros(len(pieces), np.float32)
    bias[tts.CODE_OFFSET:] = 8.0
    tensors["output.bias"] = bias
    return write_arch_gguf(tmp_path_factory.mktemp("voice") / "voice.gguf", name, md, tensors,
                           vocab_fields=f)


def _samples(path) -> np.ndarray:
    with wave.open(str(path)) as w:
        assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (24000, 1, 2)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def test_tts_cli_writes_the_jax_wav(voice_path, wav_path, tmp_path, capsys, monkeypatch):
    # the tiny decoder's frames are n_fft 16 wide: both pipelines' embd_to_audio at that size
    for mod in (tts, jtts):
        real = mod.embd_to_audio
        monkeypatch.setattr(mod, "embd_to_audio",
                            lambda e, real=real: real(e, n_fft=NFFT, n_hop=4))
    argv = ["tts", "-m", voice_path, "-mv", wav_path, "-p", "Hello world", "-n", "6"]
    assert cli.main(argv + ["-o", str(tmp_path / "port.wav"), "--device", "cpu"]) == 0
    assert "wrote" in capsys.readouterr().err
    assert jcli.main(argv + ["-o", str(tmp_path / "jax.wav")]) == 0
    got, ref = _samples(tmp_path / "port.wav"), _samples(tmp_path / "jax.wav")
    assert got.shape == ref.shape == (6 * 4 + NFFT - 2 * 6 - 4,) and np.abs(got).max() > 0
    assert np.abs(got - ref).max() <= 2


def test_tts_without_codes_returns_no_audio(voice_path, wav_path):
    voice = load_model(voice_path, device="cpu")
    voice.params["output_b"] = torch.zeros_like(voice.params["output_b"])
    voice.params["output_b"][:260] = 8.0           # bytes only: no code
    audio = tts.tts_generate(voice, load_model(wav_path, device="cpu"), "hi", n_predict=3)
    assert audio.size == 0


# ------------------------------------------------------------ embeddings


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """(JAX, port) models of a bert reranker (with a classification head)
    and of nomic-bert (none), over the byte vocab."""
    d = tmp_path_factory.mktemp("embed")
    out = {}
    for arch, cls in (("bert", True), ("nomic-bert", False)):
        path = write_encoder(d, arch, vocab_fields=byte_vocab_fields(), cls=cls)
        out[arch] = (jax_load(path), load_model(path, device="cpu"), path)
    return out


TEXTS = ["hello world", "a", "the quick brown fox jumps over the lazy dog", "x" * 20]


@pytest.mark.parametrize("pooling", ["mean", "cls", "last"])
@pytest.mark.parametrize("arch", ["bert", "nomic-bert"])
def test_embedder_embed_matches_jax(encoders, arch, pooling):
    jm, tm, _ = encoders[arch]
    ref, n_ref = JaxEmbedder(jm, pooling).embed(TEXTS)
    got, n_got = Embedder(tm, pooling).embed(TEXTS)
    assert n_got == n_ref and got.shape == ref.shape == (4, jm.hparams.n_embd)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["bert", "nomic-bert"], ids=["head", "cosine"])
def test_embedder_rerank_matches_jax(encoders, arch):
    jm, tm, _ = encoders[arch]
    docs = ["paris is in france", "bananas are yellow", "the eiffel tower"]
    ref, n_ref = JaxEmbedder(jm).rerank("where is paris", docs)
    got, n_got = Embedder(tm).rerank("where is paris", docs)
    assert n_got == n_ref and len(got) == 3
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_head_rerank_joins_query_and_document_with_a_space(encoders, monkeypatch):
    """A fault of the reference kept by both packages (ROADMAP §3): the
    classification head scores "query document", one string joined by a
    space, not the pair with a separator token between them."""
    jm, tm, _ = encoders["bert"]
    seen = {}
    for name, cls, attr in (("port", Embedder, "batch"), ("jax", JaxEmbedder, "_batch")):
        real = getattr(cls, attr)
        monkeypatch.setattr(cls, attr, lambda self, texts, real=real, name=name: (
            seen.setdefault(name, list(texts)), real(self, texts))[1])
    Embedder(tm).rerank("q x", ["d1", "d 2"])
    JaxEmbedder(jm).rerank("q x", ["d1", "d 2"])
    assert seen["port"] == seen["jax"] == ["q x d1", "q x d 2"]


def test_embedder_refuses_a_decoder(tmp_path):
    with pytest.raises(ValueError, match="not an encoder"):
        Embedder(load_model(write_tiny_llama_np(tmp_path), device="cpu"))


@pytest.fixture(scope="module")
def apps(encoders, tmp_path_factory):
    chat = write_tiny_llama_np(tmp_path_factory.mktemp("chat"))
    jm, tm, _ = encoders["bert"]
    port = ServerApp(load_model(chat, device="cpu"), n_slots=1, n_ctx=64,
                     kv_dtype=torch.float32, device="cpu", warmup=False, embed_model=tm)
    ref = JaxServerApp(jax_load(chat), n_slots=1, n_ctx=64, kv_dtype=jnp.float32,
                       embed_model=jm)
    return port, ref


def _close(got, ref) -> None:
    """Equal JSON bodies but for floats, which agree within 1e-5."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _close(got[k], ref[k])
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _close(a, b)
    elif isinstance(ref, float):
        assert abs(got - ref) <= 1e-5 + 1e-5 * abs(ref)
    else:
        assert got == ref


EMBED_BODIES = [{"input": "hello"}, {"input": ["a b", "c"], "model": "enc"},
                {"content": "native route"}]
RERANK_BODIES = [{"query": "q", "documents": ["a", "b b", "c c c"]},
                 {"query": "q", "documents": [{"text": "a"}, {"text": "b"}], "top_n": 1,
                  "return_documents": True}]


@pytest.mark.parametrize("i", range(len(EMBED_BODIES)))
def test_embeddings_body_matches_jax(apps, i):
    port, ref = apps
    got = port.handle_embeddings(EMBED_BODIES[i], "alice")
    _close(json.loads(json.dumps(got)), json.loads(json.dumps(ref.handle_embeddings(
        EMBED_BODIES[i], "alice"))))


@pytest.mark.parametrize("i", range(len(RERANK_BODIES)))
def test_rerank_body_matches_jax(apps, i):
    port, ref = apps
    got = port.handle_rerank(RERANK_BODIES[i], "alice")
    want = ref.handle_rerank(RERANK_BODIES[i], "alice")
    assert [r["index"] for r in got["results"]] == [r["index"] for r in want["results"]]
    _close(json.loads(json.dumps(got)), json.loads(json.dumps(want)))


def test_embedding_routes_over_http(apps):
    port, _ = apps
    srv = Server(port, port=0)
    srv.start()
    try:
        for path, body, fn in (("/v1/embeddings", EMBED_BODIES[1], port.handle_embeddings),
                               ("/rerank", RERANK_BODIES[0], port.handle_rerank)):
            r = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                       data=json.dumps(body).encode(), method="POST",
                                       headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=60) as resp:
                assert resp.status == 200
                assert json.loads(resp.read()) == json.loads(json.dumps(fn(body)))
    finally:
        srv.stop()


def test_serve_embed_model_is_accepted(monkeypatch, encoders):
    from superllama_tpu_torch.server import http

    _, _, path = encoders["bert"]
    seen = {}

    class App:
        def __init__(self, model, **kw):
            seen["app"] = kw
            self.warmup_info = None

    class Srv:
        def __init__(self, app, **kw):
            raise SystemExit(0)

    monkeypatch.setattr(cli, "_load", lambda args: (None, torch.float32))
    monkeypatch.setattr(http, "ServerApp", App)
    monkeypatch.setattr(http, "Server", Srv)
    with pytest.raises(SystemExit):
        cli.main(["serve", "-m", "m.gguf", "--device", "cpu", "--embed-model", path])
    emb = seen["app"]["embed_model"]
    assert emb.hparams.arch == "bert" and emb.params["token_embd"].dtype == torch.float32
    assert emb.params["cls_out"] is not None and "embed_model" not in cli.UNPORTED
