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
    from superllama_tpu_torch.ops import grouped_matmul as gm_mod
    from superllama_tpu_torch.ops import paged_attention as pa_mod
    from superllama_tpu_torch.ops import qmatmul as qm_mod
    from superllama_tpu_torch.ops import ssm_scan as ss_mod
    from superllama_tpu_torch.ops import wkv as wkv_mod
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
                      (probe_mod, "qmv_variant_plain"), (gm_mod, "grouped_matmul_plain"),
                      (ss_mod, "ssm_scan_plain"), (wkv_mod, "wkv6_plain"),
                      (wkv_mod, "gla_plain"), (wkv_mod, "wkv7_plain"),
                      (wkv_mod, "delta_net_plain")):
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


# ------------------------------------------------------------ architectures
# Tiny GGUFs of every dense architecture the port registers, for the
# parity tests of tests/test_torch_archs*.py. Where tests/ref_arch_specs.py
# has a spec, its tensor set is reused (without its build_gguf, which reads
# a vocab file this repo does not ship); the others are written here from
# the JAX loader's tensor names. Seeded numpy weights, no tokenizer.

ARCH_V = 512            # the vocabulary of the specs written here
ARCH_WINDOW = 5         # the sliding window of the SWA specs (12-token prompts)


class _W:
    """Seeded random tensors by GGUF name (numpy order (out, in))."""

    def __init__(self, name: str):
        self.rng = np.random.default_rng(int.from_bytes(name.encode()[:8].ljust(8, b"\0"),
                                                        "little"))
        self.t: dict[str, np.ndarray] = {}

    def w(self, name, *shape, scale=None):
        scale = 0.7 * shape[-1] ** -0.5 if scale is None else scale
        self.t[name] = (self.rng.standard_normal(shape) * scale).astype(np.float32)

    def norm(self, name, *shape):
        self.t[name] = (1.0 + 0.1 * self.rng.standard_normal(shape)).astype(np.float32)

    def bias(self, name, *shape, scale=0.05):
        self.t[name] = (self.rng.standard_normal(shape) * scale).astype(np.float32)


def _experts(p: "_W", b: str, E: int, n=4, k=2, f=48, shared=0, shexp_gate=None,
             bias=False, router_bias=False, probs_b=False, groups=None, md=None) -> None:
    """A MoE layer's tensors: the router (``router_bias``: its bias), n
    experts of width f (``bias``: their biases), DeepSeek-V3's selection
    bias (``probs_b``) and a shared expert of width ``shared`` with a
    "1d" or "2d" sigmoid gate."""
    p.w(b + "ffn_gate_inp.weight", n, E, scale=1.0)
    if router_bias:
        p.bias(b + "ffn_gate_inp.bias", n, scale=0.5)
    if probs_b:
        p.bias(b + "exp_probs_b.bias", n, scale=0.2)
    for part, shape in (("gate", (n, f, E)), ("up", (n, f, E)), ("down", (n, E, f))):
        p.w(b + f"ffn_{part}_exps.weight", *shape)
        if bias:
            p.bias(b + f"ffn_{part}_exps.bias", n, shape[1])
    if shared:
        p.w(b + "ffn_gate_shexp.weight", shared, E)
        p.w(b + "ffn_up_shexp.weight", shared, E)
        p.w(b + "ffn_down_shexp.weight", E, shared)
        if shexp_gate == "1d":
            p.w(b + "ffn_gate_inp_shexp.weight", E)
        elif shexp_gate == "2d":
            p.w(b + "ffn_gate_inp_shexp.weight", 1, E)


def _experts_md(n=4, k=2, f=48, shared=0, groups=None, md=None, **_) -> dict:
    out = {"expert_count": n, "expert_used_count": k, "expert_feed_forward_length": f}
    if shared:
        out["expert_shared_feed_forward_length"] = shared
    if groups:
        out["expert_group_count"], out["expert_group_used_count"] = groups
    return {**out, **(md or {})}


def dense_spec(arch: str, *, E=64, H=4, HKV=2, F=128, L=2, D=16, V=ARCH_V, ln=False,
               norm_bias=False, qkv="split", qkv_bias=False, o_bias=False, gate=True,
               fused_up=False, ffn_bias=False, pre_norm=True, ffn_norm=True,
               post_norms=False, qk_norm=None, tied=False, pos_embd=0, embd_norm=False,
               out_bias=False, sub_norms=False, scales=False, attn_gate=False, n_rot=None,
               sinks=False, experts=None, dense_lead=0, md=None) -> tuple[str, dict, dict]:
    """(arch, metadata without the arch prefix, tensors) of a tiny model of
    the llama family: LayerNorm or RMS (with biases), split or fused qkv,
    gated, gate-less or fused gate ∥ up FFN, pre- or post-norms, q/k norms
    ("head", "full", "head_ln": chameleon-style (H, D) LayerNorm weights),
    learned positions (``pos_embd`` rows), bloom's embedding norm, bitnet's
    sub-norms and per-tensor weight scales, an attention gate, attention
    sinks; ``experts`` (``_experts``' options) makes every layer from
    ``dense_lead`` on a MoE layer; ``md`` adds metadata."""
    p = _W(arch)
    nq, nk = H * D, HKV * D

    def norm(name, dim):
        p.norm(name + ".weight", dim)
        if norm_bias:
            p.bias(name + ".bias", dim)

    p.w("token_embd.weight", V, E, scale=0.5)
    if pos_embd:
        p.w("position_embd.weight", pos_embd, E, scale=0.5)
    if embd_norm:
        norm("token_embd_norm", E)
    norm("output_norm", E)
    if not tied:
        p.w("output.weight", V, E)
    if out_bias:
        p.bias("output.bias", V)
    for i in range(L):
        b = f"blk.{i}."
        if pre_norm:
            norm(b + "attn_norm", E)
        if qkv == "fused":
            p.w(b + "attn_qkv.weight", nq + 2 * nk, E)
            if qkv_bias:
                p.bias(b + "attn_qkv.bias", nq + 2 * nk)
        else:
            for n, w in (("q", nq), ("k", nk), ("v", nk)):
                p.w(b + f"attn_{n}.weight", w, E)
                if qkv_bias:
                    p.bias(b + f"attn_{n}.bias", w)
        if qk_norm == "head":
            p.norm(b + "attn_q_norm.weight", D)
            p.norm(b + "attn_k_norm.weight", D)
        elif qk_norm == "full":
            p.norm(b + "attn_q_norm.weight", nq)
            p.norm(b + "attn_k_norm.weight", nk)
        elif qk_norm == "head_ln":
            p.norm(b + "attn_q_norm.weight", H, D)
            p.norm(b + "attn_k_norm.weight", HKV, D)
        if attn_gate:
            p.w(b + "attn_gate.weight", nq, E)
        if sub_norms:
            p.norm(b + "attn_sub_norm.weight", nq)
            p.norm(b + "ffn_sub_norm.weight", F)
        p.w(b + "attn_output.weight", E, nq)
        if o_bias:
            p.bias(b + "attn_output.bias", E)
        if pre_norm and ffn_norm:
            norm(b + "ffn_norm", E)
        if post_norms:
            p.norm(b + "post_attention_norm.weight", E)
            p.norm(b + "post_ffw_norm.weight", E)
        if sinks:
            p.bias(b + "attn_sinks.weight", H, scale=1.0)
        if experts is not None and i >= dense_lead:
            _experts(p, b, E, **experts)
        elif fused_up:
            p.w(b + "ffn_up.weight", 2 * F, E)
        else:
            if gate:
                p.w(b + "ffn_gate.weight", F, E)
                if ffn_bias:
                    p.bias(b + "ffn_gate.bias", F)
            p.w(b + "ffn_up.weight", F, E)
            if ffn_bias:
                p.bias(b + "ffn_up.bias", F)
        if experts is None or i < dense_lead:
            p.w(b + "ffn_down.weight", E, F)
            if ffn_bias:
                p.bias(b + "ffn_down.bias", E)
        if scales:
            for n in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                      "ffn_down"):
                p.t[b + n + ".scale"] = np.asarray([0.75 + 0.5 * p.rng.random()], np.float32)
    meta = {"context_length": 64, "embedding_length": E, "block_count": L,
            "feed_forward_length": F, "attention.head_count": H,
            "attention.head_count_kv": HKV, "attention.key_length": D,
            "attention.value_length": D, "rope.dimension_count": n_rot or D,
            "rope.freq_base": 10000.0, "vocab_size": V,
            ("attention.layer_norm_epsilon" if ln else
             "attention.layer_norm_rms_epsilon"): 1e-5}
    if experts is not None:
        meta.update(_experts_md(**experts))
    meta.update(md or {})
    return arch, meta, p.t


_LN = dict(ln=True, norm_bias=True)
_SWA = {"attention.sliding_window": ARCH_WINDOW}

# the specs written here, by architecture
DENSE_SPECS = {
    "llama": dict(),
    "llama2": dict(HKV=4),
    "tinyllama": dict(),
    "mistral": dict(md=_SWA),
    "stablelm": dict(**_LN, qkv_bias=True, n_rot=4),
    "olmo2": dict(pre_norm=False, post_norms=True, qk_norm="full"),
    "granite": dict(md={"residual_scale": 0.5, "embedding_scale": 2.0, "logit_scale": 4.0,
                        "attention.scale": 0.1}),
    "smollm3": dict(L=4),
    "gemma": dict(tied=True, D=32),
    "gemma2": dict(tied=True, D=32, post_norms=True,
                   md={**_SWA, "attn_logit_softcapping": 5.0,
                       "final_logit_softcapping": 3.0, "attention.scale": 0.2}),
    "gemma3": dict(tied=True, D=32, post_norms=True, qk_norm="head",
                   md={**_SWA, "rope.freq_base": 1e6, "rope.freq_base_swa": 1e4}),
    "phi3": dict(qkv="fused", fused_up=True, md=_SWA),
    "gpt2": dict(**_LN, qkv="fused", qkv_bias=True, o_bias=True, gate=False,
                 ffn_bias=True, pos_embd=64),
    "gptneox": dict(**_LN, qkv="fused", qkv_bias=True, o_bias=True, gate=False,
                    ffn_bias=True, n_rot=4, md={"use_parallel_residual": True}),
    "falcon": dict(**_LN, qkv="fused", HKV=1, gate=False, ffn_norm=False),
    "starcoder": dict(**_LN, qkv="fused", qkv_bias=True, HKV=1, o_bias=True, gate=False,
                      ffn_bias=True, pos_embd=64),
    "starcoder2": dict(**_LN, qkv_bias=True, o_bias=True, gate=False, ffn_bias=True),
    "phi2": dict(**_LN, qkv_bias=True, o_bias=True, gate=False, ffn_bias=True,
                 ffn_norm=False, n_rot=8, out_bias=True, HKV=4),
    "command-r": dict(ln=True, ffn_norm=False, tied=True, qk_norm="head_ln",
                      md={"logit_scale": 0.0625}),
    "nemotron": dict(**_LN, gate=False, n_rot=8),
    "refact": dict(ln=True),
    "bloom": dict(**_LN, embd_norm=True, qkv="fused", qkv_bias=True, o_bias=True,
                  gate=False, ffn_bias=True, tied=True, HKV=4),
    "mpt": dict(ln=True, qkv="fused", gate=False, tied=True, HKV=4,
                md={"attention.clamp_kqv": 0.5, "attention.max_alibi_bias": 4.0}),
    "glm4": dict(qkv="fused", qkv_bias=True, fused_up=True, post_norms=True, n_rot=8),
    "seed_oss": dict(qkv_bias=True),
    "hunyuan-dense": dict(qk_norm="head"),
    "ernie4_5": dict(),
    "exaone4": dict(L=4, pre_norm=False, post_norms=True, qk_norm="head",
                    md={**_SWA, "attention.sliding_window_pattern": [True, True, True, False]}),
    "qwen2vl": dict(qkv_bias=True, md={"rope.dimension_sections": [2, 3, 3, 0]}),
    "arcee": dict(gate=False),
    "apertus": dict(gate=False, qk_norm="head",
                    md={f"xielu.{k}": v for k, v in (
                        ("alpha_n", [0.8, -0.4]), ("alpha_p", [0.5, 1.2]),
                        ("beta", [0.5, 0.5]), ("eps", [-1e-6, -1e-6]))}),
    "bitnet": dict(sub_norms=True, scales=True),
}
# the MoE specs written here: every expert form the 25 MoE names of the
# JAX registry reach that ref_arch_specs has no spec of
_SHARED = dict(shared=48)
MOE_SPECS = {
    "mixtral": dict(experts=dict()),
    "qwen2moe": dict(qkv_bias=True, experts=dict(**_SHARED, shexp_gate="1d")),
    "qwen3moe": dict(qk_norm="head", experts=dict(n=8, k=3)),
    "olmoe": dict(qk_norm="full", experts=dict(n=8, md={"expert_weights_norm": False})),
    "dbrx": dict(ln=True, qkv="fused", experts=dict(), md={"attention.clamp_kqv": 0.5}),
    # MXFP4 banks (their inner width a multiple of 32), sinks, biases, SWA
    "gpt-oss": dict(qkv_bias=True, o_bias=True, sinks=True,
                    experts=dict(f=64, bias=True, router_bias=True), md=_SWA),
    "gptoss": dict(qkv_bias=True, o_bias=True, sinks=True,
                   experts=dict(bias=True, router_bias=True), md=_SWA),
    "granitemoe": dict(experts=dict(**_SHARED),
                       md={"residual_scale": 0.5, "embedding_scale": 2.0, "logit_scale": 4.0,
                           "attention.scale": 0.1}),
    # sigmoid gating, groups, the selection bias, a routed scale
    "glm4moe": dict(qkv_bias=True, n_rot=8, dense_lead=1,
                    experts=dict(n=8, **_SHARED, probs_b=True, groups=(2, 1),
                                 md={"expert_gating_func": 2, "expert_weights_scale": 2.5,
                                     "expert_weights_norm": True})),
    "dots1": dict(qk_norm="head",
                  experts=dict(n=8, **_SHARED, probs_b=True, groups=(4, 2),
                               md={"expert_gating_func": 2, "expert_weights_norm": True})),
    "ernie4_5-moe": dict(dense_lead=1, experts=dict(n=8, **_SHARED, probs_b=True)),
    "hunyuan-moe": dict(qk_norm="head", experts=dict(n=8, **_SHARED, shexp_gate="2d")),
}
MOE_BANK_TYPE = {"gpt-oss": GGMLType.MXFP4}
# the reused ref_arch_specs MoE specs (a dense FFN beside grok's MoE, so its
# dense-plus-MoE path runs)
REF_MOE_SPECS = {"deepseek": {}, "arctic": {}, "grok": {}, "bailingmoe": {},
                 "smallthinker": {}, "minimax-m2": {}, "bailingmoe2": {}, "exaone-moe": {},
                 "grovemoe": {}, "afmoe": {}, "mimo2": {}, "phimoe": {}, "qwen3vlmoe": {}}
# the three that run the paged cache first, so each slice of three holds one
MOE_REGISTERED = ("mixtral", "gpt-oss", "qwen3moe") + tuple(sorted(
    set(MOE_SPECS) - {"mixtral", "gpt-oss", "qwen3moe"}) + sorted(REF_MOE_SPECS))

# the reused ref_arch_specs specs, their metadata overrides (a window the
# 12-token prompts pass) and the depth they are cut to
REF_SPECS = {"qwen2": {}, "qwen3": {}, "olmo": {}, "exaone": {}, "internlm2": {},
             "cohere2": _SWA, "minicpm": {}, "jais": {}, "chatglm": {}, "baichuan": {},
             "xverse": {}, "orion": {}, "qwen": {}, "codeshell": {}, "chameleon": {},
             "mistral3": {}, "maincoder": {}, "pangu-embedded": {}, "deci": {},
             "openelm": {}, "plamo": {}, "plamo3": {}, "qwen3vl": {}}
REF_DEPTH = 2


def arch_spec(arch: str) -> tuple[str, dict, dict]:
    """The tiny spec of a registered architecture: (arch, metadata, tensors)."""
    if arch in DENSE_SPECS or arch in MOE_SPECS:
        return dense_spec(arch, **{**DENSE_SPECS, **MOE_SPECS}[arch])
    if arch in SSM_SPECS:
        return ssm_spec(arch, **SSM_SPECS[arch])
    if arch in LINEAR_REGISTERED:
        return _linear_spec(arch)
    import ref_arch_specs

    fn = ref_arch_specs.SPECS[arch]
    name, md, tensors = fn()
    md = {**md, **{**REF_SPECS, **REF_MOE_SPECS, **REF_SSM_SPECS}[arch]}
    if arch == "grok":              # a dense FFN beside the MoE
        p = _W("grok-dense")
        E, F = md["embedding_length"], md["feed_forward_length"]
        for i in range(int(md["block_count"])):
            p.w(f"blk.{i}.ffn_gate.weight", F, E)
            p.w(f"blk.{i}.ffn_up.weight", F, E)
            p.w(f"blk.{i}.ffn_down.weight", E, F)
        tensors = {**tensors, **p.t}
    L = int(md["block_count"])
    if arch == "baichuan" and L > REF_DEPTH:    # 7B-shaped: cut its depth
        md["block_count"] = REF_DEPTH
        tensors = {k: v for k, v in tensors.items()
                   if not k.startswith("blk.") or int(k.split(".")[1]) < REF_DEPTH}
    return name, md, tensors


def write_arch_gguf(path, arch: str, md: dict, tensors: dict, ggml_type=GGMLType.F32,
                    vocab_fields=None, bank_type=GGMLType.F32) -> str:
    """A GGUF of (arch, md, tensors) through the JAX package's writer: 2-D
    weights in ``ggml_type`` where their rows fit its blocks (else F32),
    expert banks (3-D) in ``bank_type`` where theirs do, the embeddings,
    norms and biases in F32; no tokenizer unless given."""
    from superllama_tpu.gguf import GGUFWriter
    from superllama_tpu.gguf.constants import GGML_TYPE_TRAITS

    w = GGUFWriter(str(path), arch=arch)
    w.add("general.name", f"tiny-{arch}")
    for k, v in md.items():
        w.add(k if k.startswith(("general.", "tokenizer.")) else f"{arch}.{k}", v)
    for k, v in (vocab_fields or {}).items():
        w.add(k, v)
    block = GGML_TYPE_TRAITS[ggml_type].block_size
    bank_block = GGML_TYPE_TRAITS[bank_type].block_size
    for name, arr in tensors.items():
        quant = (arr.ndim == 2 and arr.shape[-1] % block == 0
                 and not name.startswith(("token_embd", "position_embd")))
        if arr.ndim == 3 and arr.shape[-1] % bank_block == 0:
            w.add_tensor(name, arr, bank_type)
        else:
            w.add_tensor(name, arr, ggml_type if quant else GGMLType.F32)
    w.write()
    return str(path)


def _ssm(p: "_W", b: str, E: int, di: int, ds: int, dc: int = 4, rank: int = 0, nh: int = 0,
         G: int = 0, norms: bool = False, ssm_norm: bool = False, suffix: bool = False) -> None:
    """A mamba layer's tensors: Mamba-1 (``rank``: the dt rank; ``norms``:
    jamba's dt / B / C norms) or Mamba-2 (``nh`` heads, ``G`` B / C groups,
    ``ssm_norm``: the grouped output norm); A as -exp(.), as the ecosystem
    stores it; ``suffix``: A, D and the norm under ".weight" names, 1-D."""
    if nh == 0:
        p.w(b + "ssm_in.weight", 2 * di, E)
        p.w(b + "ssm_conv1d.weight", di, dc, scale=0.3)
        p.bias(b + "ssm_conv1d.bias", di)
        p.w(b + "ssm_x.weight", rank + 2 * ds, di)
        p.w(b + "ssm_dt.weight", di, rank, scale=0.3)
        p.bias(b + "ssm_dt.bias", di, scale=0.3)
        p.t[b + "ssm_a"] = -np.exp(0.5 * p.rng.standard_normal((di, ds))).astype(np.float32)
        p.bias(b + "ssm_d", di, scale=0.5)
        if norms:
            p.norm(b + "ssm_dt_norm.weight", rank)
            p.norm(b + "ssm_b_norm.weight", ds)
            p.norm(b + "ssm_c_norm.weight", ds)
    else:
        conv_dim = di + 2 * G * ds
        p.w(b + "ssm_in.weight", 2 * di + 2 * G * ds + nh, E)
        p.w(b + "ssm_conv1d.weight", conv_dim, dc, scale=0.3)
        p.bias(b + "ssm_conv1d.bias", conv_dim)
        p.bias(b + "ssm_dt.bias", nh, scale=0.3)
        sfx = ".weight" if suffix else ""
        p.t[b + "ssm_a" + sfx] = -np.exp(0.5 * p.rng.standard_normal(
            nh if suffix else (nh, 1))).astype(np.float32)
        p.bias(b + "ssm_d" + sfx, *((nh,) if suffix else (nh, 1)), scale=0.5)
        if ssm_norm:
            p.norm(b + "ssm_norm.weight", *((di,) if suffix else (G, di // G)))
    p.w(b + "ssm_out.weight", E, di)


def _attn(p: "_W", b: str, E: int, H: int, HKV: int, D: int) -> None:
    p.w(b + "attn_q.weight", H * D, E)
    p.w(b + "attn_k.weight", HKV * D, E)
    p.w(b + "attn_v.weight", HKV * D, E)
    p.w(b + "attn_output.weight", E, H * D)


def _ffn(p: "_W", b: str, E: int, F: int, gate: bool = True) -> None:
    if gate:
        p.w(b + "ffn_gate.weight", F, E)
    p.w(b + "ffn_up.weight", F, E)
    p.w(b + "ffn_down.weight", E, F)


def ssm_spec(arch: str, E: int = 64, V: int = ARCH_V) -> tuple[str, dict, dict]:
    """(arch, metadata, tensors) of a tiny state-space model, one of the six
    SSM names ref_arch_specs has no spec of: mamba (falcon-mamba's
    non-parametric dt / B / C norms; E 256 and d_inner 512 so Q4_K packs its
    projections), mamba2 (G 2, the grouped norm), jamba (Mamba-1 with its
    norms beside rope-less attention, MoE FFNs on the attention layers),
    granitehybrid (Mamba-2 G 2 and roped attention, Granite's multipliers, a
    MoE FFN with a shared expert on the last layer), nemotron_h (one of
    Mamba-2 / attention / relu² FFN a layer, ".weight" names) and falcon-h1
    (attention and Mamba-2 in every layer)."""
    p = _W(arch)
    H, HKV, D, F = 4, 2, 16, 128
    p.w("token_embd.weight", V, E, scale=0.5)
    p.norm("output_norm.weight", E)
    p.w("output.weight", V, E)
    md = {"context_length": 64, "embedding_length": E, "vocab_size": V,
          "attention.layer_norm_rms_epsilon": 1e-5, "ssm.conv_kernel": 4}
    attn_md = {"attention.head_count": H, "attention.key_length": D,
               "attention.value_length": D, "rope.dimension_count": D,
               "rope.freq_base": 10000.0}
    if arch in ("mamba", "mamba2"):
        L = 2
        di, ds, rank, nh, G = (512, 16, 16, 0, 0) if arch == "mamba" else (128, 16, 0, 8, 2)
        for i in range(L):
            p.norm(f"blk.{i}.attn_norm.weight", E)
            _ssm(p, f"blk.{i}.", E, di, ds, rank=rank, nh=nh, G=G, ssm_norm=True)
        md.update({"block_count": L, "ssm.inner_size": di, "ssm.state_size": ds,
                   "ssm.time_step_rank": rank or nh, "ssm.group_count": G,
                   "attention.head_count": 0, "attention.head_count_kv": 0,
                   "feed_forward_length": 0})
        if arch == "mamba":
            md["ssm.dt_b_c_rms"] = True
        return arch, md, p.t
    md.update(attn_md)
    if arch == "jamba":
        pattern, di, ds, rank = "MAMA", 128, 8, 8
        for i, k in enumerate(pattern):
            b = f"blk.{i}."
            p.norm(b + "attn_norm.weight", E)
            p.norm(b + "ffn_norm.weight", E)
            if k == "M":
                _ssm(p, b, E, di, ds, rank=rank, norms=True)
                _ffn(p, b, E, F)
            else:
                _attn(p, b, E, H, HKV, D)
                _experts(p, b, E)
        md.update({"block_count": 4, "feed_forward_length": F,
                   "attention.head_count_kv": [0, HKV, 0, HKV],
                   "ssm.inner_size": di, "ssm.state_size": ds, "ssm.time_step_rank": rank,
                   **_experts_md()})
    elif arch == "granitehybrid":
        pattern, di, ds, nh, G = "MAM", 128, 16, 8, 2
        for i, k in enumerate(pattern):
            b = f"blk.{i}."
            p.norm(b + "attn_norm.weight", E)
            p.norm(b + "ffn_norm.weight", E)
            if k == "M":
                _ssm(p, b, E, di, ds, nh=nh, G=G, ssm_norm=True)
            else:
                _attn(p, b, E, H, HKV, D)
            if i == len(pattern) - 1:
                _experts(p, b, E, shared=48)
            else:
                _ffn(p, b, E, F)
        md.update({"block_count": 3, "feed_forward_length": F,
                   "attention.head_count_kv": [0, HKV, 0],
                   "ssm.inner_size": di, "ssm.state_size": ds, "ssm.time_step_rank": nh,
                   "ssm.group_count": G, "rope.scaling.finetuned": True,
                   "residual_scale": 0.5, "embedding_scale": 2.0, "logit_scale": 4.0,
                   "attention.scale": 0.1, **_experts_md(shared=48)})
    elif arch == "nemotron_h":
        pattern, di, ds, nh, ff = "M*-M", 128, 16, 8, 96
        for i, k in enumerate(pattern):
            b = f"blk.{i}."
            p.norm(b + "attn_norm.weight", E)
            if k == "M":
                _ssm(p, b, E, di, ds, nh=nh, G=1, ssm_norm=True, suffix=True)
            elif k == "*":
                _attn(p, b, E, H, HKV, D)
            else:
                _ffn(p, b, E, ff, gate=False)
        md.update({"block_count": 4, "feed_forward_length": [ff if k == "-" else 0
                                                             for k in pattern],
                   "attention.head_count_kv": [HKV if k == "*" else 0 for k in pattern],
                   "ssm.inner_size": di, "ssm.state_size": ds, "ssm.time_step_rank": nh,
                   "ssm.group_count": 1})
    elif arch == "falcon-h1":
        di, ds, nh = 128, 16, 8
        for i in range(2):
            b = f"blk.{i}."
            p.norm(b + "attn_norm.weight", E)
            p.norm(b + "ffn_norm.weight", E)
            _attn(p, b, E, H, HKV, D)
            _ssm(p, b, E, di, ds, nh=nh, G=1, ssm_norm=True)
            _ffn(p, b, E, F)
        md.update({"block_count": 2, "feed_forward_length": F,
                   "attention.head_count_kv": HKV, "ssm.inner_size": di,
                   "ssm.state_size": ds, "ssm.time_step_rank": nh, "ssm.group_count": 1})
    else:
        raise KeyError(arch)
    return arch, md, p.t


# the SSM specs written here (E 256 for mamba: its Q4_K case packs the
# projections) and the two reused from ref_arch_specs
SSM_SPECS = {"mamba": dict(E=256), "mamba2": {}, "jamba": {}, "granitehybrid": {},
             "nemotron_h": {}, "falcon-h1": {}}
REF_SSM_SPECS = {"nemotron_h_moe": {}, "plamo2": {}}
SSM_REGISTERED = tuple(sorted(SSM_SPECS) + sorted(REF_SSM_SPECS))


def qwen3next_spec(E: int = 64, V: int = ARCH_V, fused: bool = False) -> tuple[str, dict, dict]:
    """(arch, metadata, tensors) of a tiny Qwen3-Next, which ref_arch_specs
    has no spec of, under the names the JAX converter writes
    (``superllama_tpu/tools/convert_hf.py::_convert_qwen3next``): three
    gated-delta-net layers (2 k-heads and 4 v-heads of 16, conv 4; the
    ecosystem's head-contiguous ``attn_qkv`` with ``attn_gate``, or with
    ``fused`` one ``ssm_in`` of a k-head's interleaved [q | k | v | z]),
    then a gated attention layer (4 heads over 2 of 16, a partial rope of
    4 dims), a MoE of 4 experts (top 2) with a sigmoid-gated shared expert
    after every layer."""
    p = _W("qwen3next" + ("-fused" if fused else ""))
    H, HKV, D, Dk, Hk, Hv, dc = 4, 2, 16, 16, 2, 4, 4
    R = Hv // Hk
    p.w("token_embd.weight", V, E, scale=0.5)
    p.norm("output_norm.weight", E)
    p.w("output.weight", V, E)
    for il in range(4):
        b = f"blk.{il}."
        p.norm(b + "attn_norm.weight", E)
        p.norm(b + "post_attention_norm.weight", E)
        if (il + 1) % 4 == 0:
            p.w(b + "attn_q.weight", 2 * H * D, E)
            p.w(b + "attn_k.weight", HKV * D, E)
            p.w(b + "attn_v.weight", HKV * D, E)
            p.w(b + "attn_output.weight", E, H * D)
            p.norm(b + "attn_q_norm.weight", D)
            p.norm(b + "attn_k_norm.weight", D)
        else:
            if fused:
                p.w(b + "ssm_in.weight", Hk * (2 * Dk + 2 * R * Dk), E)
            else:
                p.w(b + "attn_qkv.weight", 2 * Hk * Dk + Hv * Dk, E)
                p.w(b + "attn_gate.weight", Hv * Dk, E)
            p.w(b + "ssm_ba.weight", 2 * Hv, E)
            p.w(b + "ssm_conv1d.weight", 2 * Hk * Dk + Hv * Dk, dc, scale=0.3)
            p.t[b + "ssm_a"] = -np.exp(0.5 * p.rng.standard_normal(Hv)).astype(np.float32)
            p.bias(b + "ssm_dt.bias", Hv, scale=0.3)
            p.norm(b + "ssm_norm.weight", Dk)
            p.w(b + "ssm_out.weight", E, Hv * Dk)
        _experts(p, b, E, shared=48, shexp_gate="1d")
    md = {"context_length": 64, "embedding_length": E, "block_count": 4, "vocab_size": V,
          "feed_forward_length": 128, "attention.head_count": H,
          "attention.head_count_kv": HKV, "attention.key_length": D,
          "attention.value_length": D, "rope.dimension_count": D // 4,
          "rope.freq_base": 10000.0, "attention.layer_norm_rms_epsilon": 1e-6,
          "ssm.conv_kernel": dc, "ssm.state_size": Dk, "ssm.group_count": Hk,
          "ssm.time_step_rank": Hv, "ssm.inner_size": Hv * Dk, **_experts_md(shared=48)}
    return "qwen3next", md, p.t


# the linear-attention and short-conv names: ref_arch_specs' tensor sets,
# their vocabulary cut to ARCH_V (the rows of the embeddings and the head);
# gemma3n grown to 7 layers with a shared-KV tail of 2 (layers 5-6, SWA, read
# layer 3's cache; layer 4 is its full layer); qwen3next from qwen3next_spec
REF_LINEAR_SPECS = ("arwkv7", "gemma3n", "lfm2", "lfm2moe", "rwkv6", "rwkv6qwen2", "rwkv7")
LINEAR_REGISTERED = tuple(sorted(REF_LINEAR_SPECS + ("qwen3next",)))
_VOCAB_ROWS = ("token_embd.weight", "output.weight", "per_layer_token_embd.weight")


def _linear_spec(arch: str) -> tuple[str, dict, dict]:
    if arch == "qwen3next":
        return qwen3next_spec()
    import ref_arch_specs

    name, md, tensors = ref_arch_specs.SPECS[arch]()
    tensors = {k: v[:ARCH_V] if k in _VOCAB_ROWS else v for k, v in tensors.items()}
    md = {**md, "vocab_size": ARCH_V}
    if arch == "gemma3n":
        L, E, EA = 7, md["embedding_length"], 256
        p = _W("gemma3n-tail")
        for k, v in list(tensors.items()):
            if k.startswith("blk.4."):
                for il in (5, 6):
                    tensors[k.replace("blk.4.", f"blk.{il}.")] = (
                        v + 0.1 * p.rng.standard_normal(v.shape).astype(np.float32))
        p.w("per_layer_token_embd.weight", ARCH_V, EA * L, scale=0.05)
        p.w("per_layer_model_proj.weight", EA * L, E)
        tensors.update(p.t)
        md.update({"block_count": L, "attention.shared_kv_layers": 2})
    return name, md, tensors


REGISTERED = tuple(sorted(DENSE_SPECS) + sorted(REF_SPECS))
# JAX refuses the paged cache for ALiBi, and its paged path fails on a layer
# with fewer kv heads than the cache (openelm): no paged case for those. Of
# the MoE names only mixtral, gpt-oss and qwen3moe run the paged cache (the
# JAX paged kernel in interpret mode is most of a parity file's time).
ALIBI_ARCHS = ("bloom", "jais", "mpt")
NO_PAGED = ALIBI_ARCHS + ("openelm",) + tuple(
    a for a in MOE_REGISTERED if a not in ("mixtral", "gpt-oss", "qwen3moe"))
ARCH_TOL = dict(rtol=1e-4, atol=1e-4)   # f32 weights: test_torch_model.py's TOL
ARCH_N_CTX = 32
ARCH_PAGE = 16


def arch_models(directory, arch: str, ggml_type=GGMLType.F32, keep_quantized=False):
    """(JAX model, port model on the CPU) of ``arch``'s tiny spec, both
    loaded from one GGUF written in ``ggml_type``."""
    from superllama_tpu.models import load_model as jax_load
    from superllama_tpu_torch.models import load_model

    name, md, tensors = arch_spec(arch)
    path = write_arch_gguf(directory / f"{arch}_{ggml_type.name}.gguf", name, md, tensors,
                           ggml_type, bank_type=MOE_BANK_TYPE.get(arch, GGMLType.F32))
    return (jax_load(path, keep_quantized=keep_quantized),
            load_model(path, keep_quantized=keep_quantized, device="cpu"))


def arch_steps(n_vocab: int, seed: int = 0) -> list[np.ndarray]:
    """A 12-token prefill and two decode steps, (1, T) token ids each."""
    ids = np.random.default_rng(seed).integers(0, min(n_vocab, 500), 14)
    return [ids[None, :12], ids[None, 12:13], ids[None, 13:14]]


def dense_logits(jm, tm) -> tuple[list, list]:
    """Each step's logits through the JAX Context (iswa off: the flat dense
    cache) and the port's, on one dense cache each."""
    from superllama_tpu.runtime import Context as JaxContext
    from superllama_tpu_torch.runtime.context import Context

    jc = JaxContext(jm, n_batch=1, n_ctx=ARCH_N_CTX, iswa=False)
    tc = Context(tm, n_batch=1, n_ctx=ARCH_N_CTX, device="cpu", iswa=False)
    steps = arch_steps(tm.hparams.n_vocab)
    ref = [np.asarray(jc.forward(s.astype(np.int32))) for s in steps]
    got = [tc.forward(s).numpy() for s in steps]
    return got, ref


def paged_logits(jm, tm) -> tuple[list, list]:
    """Each step's logits through both packages' llama_forward on a paged
    cache of one sequence (its pages out of order in the pool), the JAX
    paged-attention kernel in interpret mode."""
    import jax
    import jax.numpy as jnp

    from superllama_tpu.models.llama import llama_forward as jax_forward
    from superllama_tpu.runtime import paged_kv as JP
    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.runtime import paged_kv as TP

    hp = tm.hparams
    shape = (hp.n_layer, 4, ARCH_PAGE, 1, 2, hp.n_head_kv, hp.head_dim, hp.head_dim_v)
    jc = JP.paged_cache_init(*shape, dtype=jnp.float32)
    jc = jc._replace(table=jnp.asarray([[2, 1]], jnp.int32))
    tc = TP.paged_cache_init(*shape, dtype=torch.float32)
    tc.table[:] = torch.tensor([[2, 1]], dtype=torch.int32)
    step = jax.jit(lambda p, t, s, c: jax_forward(p, jm.hparams, t, s, c))
    got, ref, n = [], [], 0
    for s in arch_steps(hp.n_vocab):
        pos = np.arange(n, n + s.shape[1], dtype=np.int32)[None]
        n += s.shape[1]
        r, jc = step(jm.params, jnp.asarray(s, jnp.int32), jnp.asarray(pos), jc)
        ref.append(np.asarray(r))
        with torch.no_grad():
            g, _ = llama_forward(tm.params, hp, torch.from_numpy(s), torch.from_numpy(pos), tc)
        got.append(g.numpy())
    return got, ref


def arch_parity_tests(archs):
    """The two parity tests of a slice of the registered architectures (one
    module each, so no module runs long): the dense cache's and the paged
    cache's 12-token prefill and two decode steps against the JAX package,
    f32 weights, to ARCH_TOL."""
    @pytest.fixture(scope="module")
    def models(tmp_path_factory):
        d = tmp_path_factory.mktemp("archs")
        return {arch: arch_models(d, arch) for arch in archs}

    @pytest.mark.parametrize("arch", archs)
    def test_dense_cache_matches_jax(models, arch, torch_one_thread):
        got, ref = dense_logits(*models[arch])
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, **ARCH_TOL)

    paged = [a for a in archs if a not in NO_PAGED]

    @pytest.mark.parametrize("arch", paged)
    def test_paged_cache_matches_jax(models, arch, torch_one_thread):
        got, ref = paged_logits(*models[arch])
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, **ARCH_TOL)

    return models, test_dense_cache_matches_jax, test_paged_cache_matches_jax


# ------------------------------------------------------------ encoders
# ref_arch_specs' encoder specs (its ENC_SPECS, never their build_gguf),
# the vocabulary cut to V rows; with ``cls`` a classification head (cls with
# its bias, a one-score cls.output with its bias), as a reranker ships.

ENCODERS = ("bert", "gemma-embedding", "jina-bert-v2", "jina-bert-v3", "modern-bert",
            "neo-bert", "nomic-bert", "nomic-bert-moe")


def enc_spec(arch: str, V: int = ARCH_V, cls: bool = False) -> tuple[str, dict, dict]:
    import ref_arch_specs

    name, md, tensors = ref_arch_specs.ENC_SPECS[arch]()
    tensors = {k: v[:V] if k == "token_embd.weight" else v for k, v in tensors.items()}
    md = {**md, "vocab_size": V}
    if cls:
        p = _W(f"{arch}-cls")
        E = md["embedding_length"]
        p.w("cls.weight", E, E)
        p.bias("cls.bias", E)
        p.w("cls.output.weight", 1, E)
        p.bias("cls.output.bias", 1)
        tensors = {**tensors, **p.t}
    return name, md, tensors


def write_encoder(directory, arch: str, ggml_type=GGMLType.F32, vocab_fields=None,
                  cls: bool = False) -> str:
    """An encoder spec's GGUF (over ``vocab_fields``' pieces when given)."""
    V = len(vocab_fields["tokenizer.ggml.tokens"]) if vocab_fields else ARCH_V
    name, md, tensors = enc_spec(arch, V, cls)
    tag = f"{arch}_{ggml_type.name}{'_cls' if cls else ''}{'_vocab' if vocab_fields else ''}"
    return write_arch_gguf(directory / f"{tag}.gguf", name, md, tensors, ggml_type,
                           vocab_fields=vocab_fields)
