"""Shared fixtures of the port's parity tests (no tests of its own): a tiny
llama GGUF written offline from a seeded HF model, with a hand-built
byte-level BPE vocab (256 byte tokens + BOS/EOS + 2 spares)."""

import numpy as np
import pytest
import torch

from superllama_tpu.gguf import GGMLType
from superllama_tpu.tools.convert_hf import convert_state_dict

N_VOCAB = 260
BOS, EOS = 256, 257


def _bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def byte_vocab_fields() -> dict:
    b2u = _bytes_to_unicode()
    return {
        "tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "default",
        "tokenizer.ggml.tokens": [b2u[b] for b in range(256)]
        + ["<|bos|>", "<|eos|>", "<|spare0|>", "<|spare1|>"],
        "tokenizer.ggml.token_type": [1] * 256 + [3] * 4,
        "tokenizer.ggml.merges": [],
        "tokenizer.ggml.bos_token_id": BOS, "tokenizer.ggml.eos_token_id": EOS,
        "tokenizer.ggml.add_bos_token": True,
    }


FIM_PIECES = ("<|fim_prefix|>", "<|fim_suffix|>", "<|fim_middle|>")


def fim_vocab_fields() -> dict:
    """The byte vocab plus the three FIM pieces of Qwen2.5-Coder-style
    vocabs (control tokens, ids 260-262), for ``/infill``."""
    fields = byte_vocab_fields()
    fields["tokenizer.ggml.tokens"] = fields["tokenizer.ggml.tokens"] + list(FIM_PIECES)
    fields["tokenizer.ggml.token_type"] = fields["tokenizer.ggml.token_type"] + [3] * 3
    return fields


def write_tiny_llama(directory, types=(GGMLType.F32,), seed=0, vocab_fields=None,
                     name="tiny", keep_layers=None) -> dict:
    """Write the tiny llama (hidden 256, so Q4_K blocks fit, 2 layers) in
    each GGML type; with ``keep_layers`` only its first layers (a shallower
    model with the same embeddings and head), over ``vocab_fields``
    (default the byte vocab); returns {type: path}."""
    from transformers import LlamaConfig, LlamaForCausalLM

    fields = vocab_fields or byte_vocab_fields()
    torch.manual_seed(seed)
    cfg = LlamaConfig(
        vocab_size=len(fields["tokenizer.ggml.tokens"]), hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256, rms_norm_eps=1e-6,
        rope_theta=10000.0, tie_word_embeddings=False, architectures=["LlamaForCausalLM"])
    hf = LlamaForCausalLM(cfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    if keep_layers is not None:
        cfg.num_hidden_layers = keep_layers
        sd = {k: v for k, v in sd.items()
              if not k.startswith("model.layers.") or int(k.split(".")[2]) < keep_layers}
    paths = {}
    for t in types:
        path = str(directory / f"{name}_{t.name}.gguf")
        convert_state_dict(path, cfg, sd, t, tokenizer_fields=fields)
        paths[t] = path
    return paths


def write_tiny_llama_np(directory, vocab_fields=None, seed=0, name="tiny") -> str:
    """The tiny llama's shapes (hidden 256, 2 layers, 4 heads over 2 KV
    heads, FFN 512) as one F32 GGUF of seeded numpy weights (normal, std
    0.02; norms 1), without importing transformers (whose import takes
    about 15 s); returns its path."""
    from types import SimpleNamespace

    fields = vocab_fields or byte_vocab_fields()
    V, E, F, H, KV = len(fields["tokenizer.ggml.tokens"]), 256, 512, 4, 2
    cfg = SimpleNamespace(vocab_size=V, hidden_size=E, intermediate_size=F,
                          num_hidden_layers=2, num_attention_heads=H, num_key_value_heads=KV,
                          max_position_embeddings=256, rms_norm_eps=1e-6, rope_theta=10000.0,
                          tie_word_embeddings=False, architectures=["LlamaForCausalLM"])
    rng = np.random.default_rng(seed)
    w = lambda *shape: rng.normal(0.0, 0.02, shape).astype(np.float32)
    kv = KV * E // H
    sd = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": np.ones(E, np.float32),
          "lm_head.weight": w(V, E)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = np.ones(E, np.float32)
        sd[p + "post_attention_layernorm.weight"] = np.ones(E, np.float32)
        for key, shape in (("self_attn.q_proj", (E, E)), ("self_attn.k_proj", (kv, E)),
                           ("self_attn.v_proj", (kv, E)), ("self_attn.o_proj", (E, E)),
                           ("mlp.gate_proj", (F, E)), ("mlp.up_proj", (F, E)),
                           ("mlp.down_proj", (E, F))):
            sd[p + key + ".weight"] = w(*shape)
    path = str(directory / f"{name}_F32.gguf")
    convert_state_dict(path, cfg, sd, GGMLType.F32, tokenizer_fields=fields)
    return path


def prompt(n: int, seed: int = 0) -> list[int]:
    return [BOS] + np.random.default_rng(seed).integers(0, 256, n - 1).tolist()


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its CUDA
    branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def cuda_typed(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_CudaTyped, t)


def xla_exact(fn, *args):
    """fn(*args) jitted with XLA's excess precision off: on the CPU, XLA
    otherwise drops f32→bf16→f32 round trips, so the JAX package's bf16
    roundings (Q4_0 dequant, bf16 probabilities) would not happen as
    written."""
    import jax

    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def failing_build(monkeypatch) -> type:
    """Make every kernel build fail and every plain version unreachable;
    returns the exception type a wrapper must then raise."""
    from superllama_tpu_torch.ops import _build
    from superllama_tpu_torch.ops import flash_attention as fa_mod
    from superllama_tpu_torch.ops import paged_attention as pa_mod
    from superllama_tpu_torch.ops import qmatmul as qm_mod
    from superllama_tpu_torch.tools import qmv_probe as probe_mod

    class BuildFailed(RuntimeError):
        pass

    def fail(*a, **k):
        raise BuildFailed("no nvcc")

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(_build, "load", fail)
    for mod, name in ((qm_mod, "qmv_plain"), (qm_mod, "qmm_plain"),
                      (fa_mod, "flash_attention_plain"), (fa_mod, "flash_decode_plain"),
                      (pa_mod, "paged_flash_attention_plain"),
                      (pa_mod, "flash_attention_plain"),
                      (probe_mod, "qmv_variant_plain")):
        monkeypatch.setattr(mod, name, plain)
    return BuildFailed


@pytest.fixture(scope="module")
def torch_one_thread():
    """torch on one intra-op thread for a module: tiny eager steps gain
    nothing from more, and several test workers' threads oversubscribe the
    cores (a module of engine runs took 8× its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
