"""Model hyperparameters loaded from GGUF metadata.

Counterpart of src/llama-hparams.{h,cpp} + the per-arch KV reads in
llama_model::load_hparams (src/llama-model.cpp:490). Keys are the GGUF
ecosystem's standard "{arch}.*" metadata keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from ..gguf import GGUFReader

ROPE_SCALING_NONE = "none"
ROPE_SCALING_LINEAR = "linear"
ROPE_SCALING_YARN = "yarn"


@dataclass
class HParams:
    arch: str
    n_vocab: int
    n_ctx_train: int
    n_embd: int
    n_layer: int
    n_head: int
    n_head_kv: int
    n_ff: int
    n_rot: int
    head_dim: int
    head_dim_v: int
    rms_eps: float = 1e-5
    norm_eps: float = 1e-5
    rope_freq_base: float = 10000.0
    rope_scaling: str = ROPE_SCALING_NONE
    rope_scale_factor: float = 1.0
    rope_orig_ctx: int = 0
    rope_attn_factor: float = 1.0
    rope_type: int = 0  # ROPE_TYPE_NORM; per-arch override
    # MoE
    n_expert: int = 0
    n_expert_used: int = 0
    n_ff_exp: int = 0
    expert_weights_norm: bool = False
    expert_weights_scale: float = 1.0   # deepseek2 routed_scaling_factor
    expert_gating_softmax: bool = True  # softmax vs sigmoid gating
    n_expert_groups: int = 1            # deepseek-v3 grouped selection
    n_group_used: int = 1
    n_expert_shared: int = 0
    n_layer_dense_lead: int = 0         # deepseek2 first_k_dense_replace
    # MLA (deepseek2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    # SSM (mamba-family)
    ssm_d_conv: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0   # mamba2: n_head (ssm.time_step_rank holds n_head)
    ssm_n_group: int = 0   # mamba2 B/C group count (0 = mamba1 layout)
    # attention extras
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    swa_window: int = 0           # sliding window size (0 = full attention)
    swa_pattern: int = 1          # every Nth layer is full-attention (iSWA)
    f_attn_scale: float = 0.0     # 0 → 1/sqrt(head_dim) (gemma2 query scalar)
    rope_freq_base_swa: float = 0.0  # 0 → same base for SWA layers (gemma3)
    # FFN activation: silu | gelu_tanh | gelu | relu | swiglu_oai (gpt-oss)
    act: str = "silu"
    swiglu_limit: float = 7.0     # swiglu_oai clamp
    swiglu_alpha: float = 1.702   # swiglu_oai sigmoid sharpening
    # T5 (encoder-decoder)
    n_rel_attn_bkts: int = 0
    dec_n_layer: int = 0
    dec_start_token_id: int = 0
    # LFM2 shortconv mixer (kernel length; conv state = L_cache - 1 columns)
    shortconv_l_cache: int = 0
    # RWKV (wkv linear attention)
    wkv_head_size: int = 0
    rescale_every_n_layers: int = 0
    token_shift_count: int = 2
    # wavtokenizer (audio codec decoder)
    n_embd_features: int = 0
    posnet_n_embd: int = 0
    posnet_n_layer: int = 0
    convnext_n_embd: int = 0
    convnext_n_layer: int = 0
    n_norm_groups: int = 32
    f_norm_group_eps: float = 1e-6
    # hybrid (jamba-family): per-layer attention head counts; 0 = SSM layer
    n_head_arr: list[int] | None = None  # per-layer query heads (deci/openelm)
    n_head_kv_arr: list[int] | None = None
    n_ff_arr: list[int] | None = None  # per-layer FFN width (nemotron-h: 0 on
                                       # ssm/attention layers)
    n_ff_shexp: int = 0                # granitemoe-shared expert width
    rope_finetuned: bool = False       # granite-hybrid: rope on (bamba)
    # classic GPT family (gpt2/gptneox/falcon/phi2/starcoder/bloom/mpt)
    norm_type: str = "rms"            # "rms" | "ln" (LayerNorm, opt. biases)
    parallel_residual: bool = False   # x + attn(h) + ffn(h2) in one add
    alibi: bool = False               # ALiBi position bias (bloom/mpt)
    max_alibi_bias: float = 8.0       # ggml soft_max_ext max_bias
    logit_scale: float = 1.0          # multiplier on final logits (command-r;
                                      # granite stores the divisor — inverted
                                      # at load)
    f_residual_scale: float = 1.0     # granite residual_multiplier
    f_clamp_kqv: float = 0.0          # clamp |q|,|k|,|v| (dbrx/mpt clip_qkv)
    n_no_rope_layer_step: int = 0     # every Nth layer skips rope (smollm3)
    # misc
    f_embedding_scale: float = 1.0
    extra: dict[str, Any] = field(default_factory=dict)

    def n_head_il(self, il: int) -> int:
        if self.n_head_arr is not None:
            return self.n_head_arr[il]
        return self.n_head

    def n_head_kv_il(self, il: int) -> int:
        if self.n_head_kv_arr is not None:
            return self.n_head_kv_arr[il]
        return self.n_head_kv

    def n_ff_il(self, il: int) -> int:
        if self.n_ff_arr is not None:
            return self.n_ff_arr[il]
        return self.n_ff

    def is_recurrent_layer(self, il: int) -> bool:
        """Layer uses SSM state (llama_hparams::is_recurrent counterpart).
        falcon-h1 runs attention AND mamba2 in every layer; nemotron-h has
        pure-FFN layers (n_head_kv==0, n_ff>0) that are neither
        (llama-model.cpp:1899,2204)."""
        if self.arch == "falcon-h1":
            return True
        if self.arch in ("nemotron_h", "nemotron-h", "nemotron_h_moe"):
            return self.n_head_kv_il(il) == 0 and self.n_ff_il(il) == 0
        if self.arch == "qwen3next":
            # gated delta net on 3 of every 4 layers (llama-model.cpp:2389
            # full_attention_interval = 4)
            return (il + 1) % 4 != 0
        return self.n_head_kv_il(il) == 0

    @property
    def ssm_conv_dim(self) -> int:
        """Channels through the depthwise conv: mamba2 convolves [x,B,C]
        together (d_inner + 2·G·d_state); mamba1 convolves x only."""
        if self.ssm_n_group > 0:
            return self.ssm_d_inner + 2 * self.ssm_n_group * self.ssm_d_state
        return self.ssm_d_inner

    @property
    def is_hybrid(self) -> bool:
        """Mixed attention + recurrent layers (jamba/falcon-h1/lfm2-style)."""
        if self.arch == "falcon-h1":  # parallel attn+ssm in every layer
            return self.ssm_d_inner > 0
        if self.arch == "qwen3next":    # delta-net + attention hybrid
            return self.ssm_d_inner > 0
        if self.shortconv_l_cache > 0:  # lfm2: shortconv + attention layers
            return (self.n_head_kv_arr is not None
                    and any(h > 0 for h in self.n_head_kv_arr))
        return (self.ssm_d_inner > 0 and self.n_head_kv_arr is not None
                and any(h > 0 for h in self.n_head_kv_arr))

    @property
    def is_recurrent(self) -> bool:
        """State-space/recurrent memory instead of a KV cache."""
        if self.is_hybrid:
            return False
        return self.ssm_d_inner > 0 or self.wkv_head_size > 0

    @property
    def recurrent_kind(self) -> str | None:
        """'ssm' (mamba conv+state), 'rwkv' (token-shift + wkv matrix), or
        None — selects the recurrent store layout (create_memory counterpart)."""
        if self.wkv_head_size > 0:
            return "rwkv"
        if self.ssm_d_inner > 0:
            return "ssm"
        return None

    def is_swa_layer(self, il: int) -> bool:
        """True if layer uses sliding-window attention (iSWA pattern)."""
        if self.swa_window <= 0:
            return False
        arr = self.extra.get("swa_layers")  # explicit per-layer bool array
        if arr is not None:                 # (olmo3 sliding_window_pattern)
            return bool(arr[il])
        return (il + 1) % self.swa_pattern != 0


# per-arch rope convention (table mirrors llama_model_rope_type,
# src/llama-model.cpp; NORM = adjacent pairs, NEOX = split halves)
ROPE_TYPE_BY_ARCH = {
    "llama": 0, "llama4": 0, "deci": 0, "baichuan": 0, "starcoder2": 2,
    "qwen2": 2, "qwen2moe": 2, "qwen3": 2, "qwen3moe": 2,
    "mistral": 0, "mixtral": 0, "phi2": 2, "phi3": 2, "gemma": 2,
    "gemma2": 2, "gemma3": 2, "stablelm": 2, "gptneox": 2, "olmo": 0,
    "olmo2": 2, "minicpm": 0, "smollm3": 0, "granite": 0, "internlm2": 0,
    "exaone": 2, "nemotron": 2, "cohere2": 0, "glm4": 0, "deepseek2": 0,
    "gpt-oss": 2, "gptoss": 2, "falcon": 2, "command-r": 0, "dbrx": 2,
    "olmoe": 2, "seed_oss": 2, "hunyuan-dense": 2, "ernie4_5": 0,
    "exaone4": 2, "qwen2vl": 2,
    "granitemoe": 0, "granitehybrid": 0, "falcon-h1": 2,
    "mamba2": -1, "nemotron_h": -1, "nemotron_h_moe": -1,
    "arcee": 0, "ernie4_5-moe": 0, "dots1": 2, "hunyuan-moe": 2,
    "glm4moe": 2, "apertus": 2, "xverse": 0, "orion": 2,
    "qwen": 2, "codeshell": 2, "deepseek": 0, "minicpm3": 2,
    "arctic": 0, "chameleon": 0, "grok": 2,
    "bailingmoe": 0, "mistral3": 0, "plm": 0,
    "smallthinker": 2, "maincoder": 0, "pangu-embedded": 2, "bitnet": 2,
    "openelm": 2, "plamo": 2, "minimax-m2": 2, "bailingmoe2": 2,
    "exaone-moe": 2, "grovemoe": 2, "afmoe": 2, "mimo2": 2,
    "lfm2": 2, "lfm2moe": 2, "plamo3": 2, "rnd1": 2, "cogvlm": 2,
    # diffusion LMs: dream/llada-moe are qwen-based (NEOX); llada is NORM
    "dream": 2, "llada-moe": 2, "llada": 0,
    "gemma-embedding": 2, "rwkv6qwen2": -1,
    # encoders: nomic/jina-v3/modern-bert rope NEOX; neo-bert NORM;
    # bert/jina-v2 have no rope (learned positions / ALiBi)
    "nomic-bert": 2, "nomic-bert-moe": 2, "jina-bert-v3": 2,
    "modern-bert": 2, "neo-bert": 0, "bert": -1, "jina-bert-v2": -1,
    "llama-embed": 0, "phimoe": 2, "qwen3vl": 2, "qwen3vlmoe": 2,
    "plamo2": 2, "gemma3n": 2, "qwen3next": 2,
    "gpt2": -1, "starcoder": -1, "bloom": -1, "mpt": -1, "jais": -1,
    "refact": -1,
}

# iSWA layer pattern per arch: every Nth layer is full attention
# (the reference hardcodes these per arch in llama_model::load_hparams)
SWA_PATTERN_BY_ARCH = {"gemma2": 2, "gemma3": 6, "gpt-oss": 2, "gptoss": 2,
                       "cohere2": 4,
                       # symmetric (bidirectional) windows on encoders
                       "modern-bert": 3, "gemma-embedding": 6,
                       "gemma3n": 5}

# FFN activation per arch (llm_build_* act choices in src/models/).
# HF "gelu" is erf-based for neox/falcon/mpt; gpt2/phi2/starcoder use the
# tanh approximation ("gelu_new"/"gelu_pytorch_tanh").
ACT_BY_ARCH = {"gemma": "gelu_tanh", "gemma2": "gelu_tanh", "gemma3": "gelu_tanh",
               "gpt-oss": "swiglu_oai", "gptoss": "swiglu_oai",
               "gpt2": "gelu_tanh", "starcoder": "gelu_tanh",
               "starcoder2": "gelu_tanh", "phi2": "gelu_tanh",
               "bloom": "gelu_tanh", "gptneox": "gelu_erf",
               "falcon": "gelu_erf", "mpt": "gelu_erf",
               "refact": "gelu_tanh", "codeshell": "gelu_tanh",
               "grok": "gelu_tanh", "nemotron": "relu2", "plm": "relu2",
               "smallthinker": "relu",
               # microsoft bitnet-2B-4T is relu²-gated (HF BitNetMLP); the
               # reference's SILU builder targets the legacy 1bitLLM ckpts
               "bitnet": "relu2",
               "nemotron_h": "relu2", "nemotron_h_moe": "relu2",
               "arcee": "relu2"}

# archs built on LayerNorm (weight + optional bias) rather than RMSNorm
LN_ARCHS = {"gpt2", "gptneox", "falcon", "starcoder", "starcoder2", "phi2",
            "stablelm", "bloom", "mpt", "command-r", "cohere2", "dbrx",
            "olmo", "refact", "jais", "nemotron", "orion", "codeshell",
            # encoder family (neo-bert and gemma-embedding are RMS)
            "bert", "nomic-bert", "nomic-bert-moe", "jina-bert-v2",
            "jina-bert-v3", "modern-bert"}

# parallel-residual archs (default; gptneox models can override via the
# use_parallel_residual KV). Whether the FFN shares the attn norm output is
# tensor-driven (ffn_norm present or not).
PARALLEL_RES_BY_ARCH = {"gptneox": True, "falcon": True, "phi2": True,
                        "command-r": True, "cohere2": True,
                        # plamo: ffn reads the attn-norm output, one residual
                        # add of attn+ffn (plamo.cpp:78-92)
                        "plamo": True}

# archs with no rotary embedding (learned/alibi positions instead)
NO_ROPE_ARCHS = {"gpt2", "starcoder", "bloom", "mpt", "jais", "refact"}


def _k(md: dict, arch: str, suffix: str, default=None):
    return md.get(f"{arch}.{suffix}", default)


def hparams_from_gguf(reader: "GGUFReader") -> HParams:
    md = reader.metadata
    arch = md["general.architecture"]
    n_embd = int(_k(md, arch, "embedding_length"))
    h_raw = _k(md, arch, "attention.head_count", 0)
    n_head_arr = None
    if isinstance(h_raw, (list, tuple)) or getattr(h_raw, "ndim", 0) == 1:
        n_head_arr = [int(x) for x in h_raw]     # per-layer (deci/openelm)
        n_head = max(n_head_arr)
    else:
        n_head = int(h_raw)
    hkv_raw = _k(md, arch, "attention.head_count_kv", n_head)
    n_head_kv_arr = None
    if isinstance(hkv_raw, (list, tuple)) or getattr(hkv_raw, 'ndim', 0) == 1:  # per-layer array
        n_head_kv_arr = [int(x) for x in hkv_raw]
        n_head_kv = max(n_head_kv_arr)
    else:
        n_head_kv = int(hkv_raw)
    _ff_raw = _k(md, arch, "feed_forward_length", 0)  # per-layer (nemotron-h)
    _ff_is_arr = (isinstance(_ff_raw, (list, tuple))
                  or getattr(_ff_raw, "ndim", 0) == 1)
    head_dim = int(_k(md, arch, "attention.key_length",
                      n_embd // n_head if n_head else 0))
    head_dim_v = int(_k(md, arch, "attention.value_length", head_dim))
    n_rot = int(_k(md, arch, "rope.dimension_count", head_dim))
    n_vocab = int(_k(md, arch, "vocab_size", 0)) or len(md.get("tokenizer.ggml.tokens", []))

    scaling = str(_k(md, arch, "rope.scaling.type", ROPE_SCALING_NONE) or ROPE_SCALING_NONE)
    hp = HParams(
        arch=arch,
        n_vocab=n_vocab,
        n_ctx_train=int(_k(md, arch, "context_length", 2048)),
        n_embd=n_embd,
        n_layer=int(_k(md, arch, "block_count", 0) or 0),
        n_head=n_head,
        n_head_kv=n_head_kv,
        n_ff=(max(int(x) for x in _ff_raw)
              if _ff_is_arr else int(_ff_raw)),
        n_ff_arr=([int(x) for x in _ff_raw] if _ff_is_arr else None),
        n_rot=n_rot,
        head_dim=head_dim,
        head_dim_v=head_dim_v,
        rms_eps=float(_k(md, arch, "attention.layer_norm_rms_epsilon", 1e-5)),
        norm_eps=float(_k(md, arch, "attention.layer_norm_epsilon", 1e-5)),
        rope_freq_base=float(_k(md, arch, "rope.freq_base", 10000.0)),
        rope_scaling=scaling,
        rope_scale_factor=float(_k(md, arch, "rope.scaling.factor", 1.0)),
        rope_orig_ctx=int(_k(md, arch, "rope.scaling.original_context_length", 0)),
        rope_attn_factor=float(_k(md, arch, "rope.scaling.attn_factor", 1.0)),
        rope_type=ROPE_TYPE_BY_ARCH.get(arch, 0),
        n_expert=int(_k(md, arch, "expert_count", 0)),
        n_expert_used=int(_k(md, arch, "expert_used_count", 0)),
        n_ff_exp=int(_k(md, arch, "expert_feed_forward_length", 0)),
        n_ff_shexp=int(_k(md, arch, "expert_shared_feed_forward_length", 0)),
        rope_finetuned=bool(_k(md, arch, "rope.scaling.finetuned", False)),
        attn_logit_softcap=float(_k(md, arch, "attn_logit_softcapping", 0.0)),
        final_logit_softcap=float(_k(md, arch, "final_logit_softcapping", 0.0)),
        swa_window=int(_k(md, arch, "attention.sliding_window", 0)),
        swa_pattern=SWA_PATTERN_BY_ARCH.get(arch, 1),
        f_attn_scale=float(_k(md, arch, "attention.scale", 0.0)),
        rope_freq_base_swa=float(_k(md, arch, "rope.freq_base_swa", 0.0)),
        act=ACT_BY_ARCH.get(arch, "silu"),
        expert_weights_norm=bool(_k(md, arch, "expert_weights_norm",
                                    # jamba: build_moe_ffn norm_w=false
                                    # (models/jamba.cpp:78)
                                    # norm_w=false builders: jamba.cpp:78,
                                    # llada-moe.cpp:92
                                    arch not in ("qwen2moe", "deepseek2",
                                                 "deepseek", "jamba",
                                                 "llada-moe"))),
        expert_weights_scale=float(_k(md, arch, "expert_weights_scale", 1.0)),
        n_expert_shared=int(_k(md, arch, "expert_shared_count", 0)),
        n_layer_dense_lead=int(_k(md, arch, "leading_dense_block_count", 0)),
        q_lora_rank=int(_k(md, arch, "attention.q_lora_rank", 0) or 0),
        kv_lora_rank=int(_k(md, arch, "attention.kv_lora_rank", 0) or 0),
        ssm_d_conv=int(_k(md, arch, "ssm.conv_kernel", 0)),
        ssm_d_inner=int(_k(md, arch, "ssm.inner_size", 0)),
        ssm_d_state=int(_k(md, arch, "ssm.state_size", 0)),
        ssm_dt_rank=int(_k(md, arch, "ssm.time_step_rank", 0)),
        ssm_n_group=int(_k(md, arch, "ssm.group_count", 0)),
        n_rel_attn_bkts=int(_k(md, arch, "attention.relative_buckets_count", 0)),
        dec_start_token_id=int(_k(md, arch, "decoder_start_token_id", 0)),
        shortconv_l_cache=int(_k(md, arch, "shortconv.l_cache", 0)),
        wkv_head_size=int(_k(md, arch, "wkv.head_size", 0)),
        rescale_every_n_layers=int(_k(md, arch, "rescale_every_n_layers", 0)),
        token_shift_count=int(_k(md, arch, "token_shift_count", 2)),
        n_head_arr=n_head_arr,
        n_head_kv_arr=n_head_kv_arr,
    )
    hp.norm_type = "ln" if arch in LN_ARCHS else "rms"
    ms = _k(md, arch, "rope.dimension_sections")
    if ms is not None and len(ms):
        hp.extra["mrope_sections"] = tuple(int(v) for v in ms)
    if arch in ("qwen3vl", "qwen3vlmoe"):
        hp.extra["imrope"] = True   # interleaved M-RoPE (IMROPE)
    if _k(md, arch, "ssm.dt_b_c_rms", False):
        # falcon-mamba: non-parametric RMS on dt/B/C selection streams
        hp.extra["ssm_dt_b_c_rms"] = True
    if arch == "smollm3":
        hp.n_no_rope_layer_step = 4   # hardcoded per arch (llama-model.cpp:2249)
    # LLAMA_EXPERT_GATING_FUNC (1 = softmax, 2 = sigmoid); per-KV override
    egf = _k(md, arch, "expert_gating_func")
    if egf is not None:
        hp.expert_gating_softmax = int(egf) != 2
    elif arch in ("smallthinker", "lfm2moe"):
        hp.expert_gating_softmax = False  # sigmoid default (llama-model.cpp)
    if arch in ("mimo2", "nemotron_h_moe"):
        # these builders hardcode sigmoid gating regardless of the KV
        # (mimo2-iswa.cpp, nemotron-h.cpp build_moe_ffn calls)
        hp.expert_gating_softmax = False
    if arch == "smallthinker":
        hp.extra["moe_router_prenorm"] = True  # routes from the layer input
        hp.extra["no_rope_mod_zero"] = True    # no-rope at il % step == 0
        if hp.swa_window > 0:
            hp.swa_window = 4096               # forced (llama-model.cpp:2309)
            # set_swa_pattern(4, dense_first): full attn at il % 4 == 0
            hp.extra["swa_layers"] = [il % 4 != 0 for il in range(hp.n_layer)]
            hp.n_no_rope_layer_step = 0
        else:
            hp.n_no_rope_layer_step = 0           # rope everywhere
    if arch == "maincoder":
        hp.extra["qk_norm_post_rope"] = True
    hp.n_expert_groups = int(_k(md, arch, "expert_group_count", 1) or 1)
    hp.n_group_used = int(_k(md, arch, "expert_group_used_count", 1) or 1)
    if arch == "apertus":
        xn = _k(md, arch, "xielu.alpha_n")
        if xn is not None:
            hp.extra["xielu"] = [
                [float(a) for a in _k(md, arch, f"xielu.{f}")]
                for f in ("alpha_n", "alpha_p", "beta", "eps")]
    swp = _k(md, arch, "attention.sliding_window_pattern")
    if swp is not None and not isinstance(swp, (int, float)):
        hp.extra["swa_layers"] = [bool(x) for x in swp]  # olmo3-style array
    if arch in ("glm4moe", "bailingmoe2", "exaone-moe"):
        # NextN/MTP prediction layers ride at the end of the stack but are
        # not run by the forward pass (glm4-moe.cpp:31 n_transformer_layers)
        hp.n_layer -= int(_k(md, arch, "nextn_predict_layers", 0) or 0)
    if arch == "cohere2":
        # rope applies ONLY on sliding-window layers (cohere2-iswa.cpp:64)
        hp.extra["rope_swa_only"] = True
    if arch in ("exaone4", "exaone-moe"):
        # rope applies ONLY on sliding-window layers; full-attention layers
        # are NoPE (exaone4.cpp:34, exaone-moe.cpp:19 is_local_layer)
        hp.extra["rope_swa_only"] = True
        if arch == "exaone-moe":
            # SWA always on: window 128 default, 3-sliding/1-full pattern
            # (llama-model.cpp LLM_ARCH_EXAONE_MOE case)
            hp.swa_window = int(
                _k(md, arch, "attention.sliding_window", 128) or 128)
            hp.swa_pattern = 4
    if arch == "afmoe":
        # MuP embedding scale baked in the builder (afmoe.cpp:14); ISWA
        # 3-sliding/1-full when a window ships; sigmoid gating default;
        # every-4th-layer NoPE via no_rope_layer_step-style gating
        hp.f_embedding_scale = float(n_embd) ** 0.5
        if hp.swa_window > 0:
            hp.swa_pattern = 4
        if egf is None:
            hp.expert_gating_softmax = False
        # every 4th layer is NoPE: the builder reads the hparams default
        # (llama-hparams.h:171 n_no_rope_layer_step = 4, smollm3 semantics)
        hp.n_no_rope_layer_step = 4
    if arch == "grovemoe":
        # adjugate ("chunk") experts: big-expert id // n_group_experts selects
        # the chunk expert; output added with expert_group_scale
        # (grovemoe.cpp:104-117, build_moe_ffn GROVEMOE branches)
        hp.extra["grove"] = {
            "n_group_experts": int(_k(md, arch, "experts_per_group", 1) or 1),
            "scale": float(_k(md, arch, "expert_group_scale", 0.05) or 0.05),
        }
        hp.extra["moe_select_sigmoid"] = True  # selection on sigmoid(logits),
        hp.expert_gating_softmax = True        # weights from softmax(logits)
    if arch == "llama4":
        hp.n_no_rope_layer_step = int(_k(md, arch, "no_rope_layer_step", 4))
        hp.expert_gating_softmax = False
        hp.expert_weights_norm = False   # sigmoid weights used as-is
        hp.extra["moe_topk_raw"] = True  # top-k on raw logits, sigmoid after
        hp.extra["expert_weights_before_ffn"] = True
        hp.extra["llama4"] = {
            "temp_tuning": bool(_k(md, arch, "attention.temperature_tuning", True)),
            "floor_scale": float(_k(md, arch, "attention.floor_scale", 8192.0)),
            "attn_scale": float(_k(md, arch, "attention.scale_smooth", 0.1)),
            "chunk": int(_k(md, arch, "attention.chunk_size", 0)),
        }
    if arch in ("bloom", "mpt", "jais"):
        hp.alibi = True
        hp.max_alibi_bias = float(_k(md, arch, "attention.max_alibi_bias", 8.0))
    if arch == "jais":
        # kq scale is 1/n_embd_head, NOT 1/sqrt (models/jais.cpp:44)
        hp.f_attn_scale = 1.0 / hp.head_dim
    if arch == "baichuan" and hp.n_layer == 40:
        # Baichuan-13B: no rope, ALiBi (llama-model.cpp:846 sets
        # f_max_alibi_bias=8 for LLM_TYPE_13B; the builder skips rope)
        hp.rope_type = -1
        hp.alibi = True
    par_def = PARALLEL_RES_BY_ARCH.get(arch, False)
    hp.parallel_residual = bool(_k(md, arch, "use_parallel_residual", par_def))
    ls = _k(md, arch, "logit_scale")
    if ls:
        hp.logit_scale = 1.0 / float(ls) if arch.startswith("granite") else float(ls)
    hp.f_residual_scale = float(_k(md, arch, "residual_scale", 1.0))
    hp.f_clamp_kqv = float(_k(md, arch, "attention.clamp_kqv", 0.0))
    if _k(md, arch, "embedding_scale") is not None:
        hp.f_embedding_scale = float(_k(md, arch, "embedding_scale"))
    if arch.startswith("gemma"):
        hp.f_embedding_scale = float(n_embd) ** 0.5
    if arch == "minicpm3":
        # builder-hardcoded muP scalings (src/models/minicpm3.cpp:5-8,139)
        hp.f_embedding_scale = 12.0
        hp.f_residual_scale = 1.4 / hp.n_layer ** 0.5
        hp.logit_scale = 256.0 / hp.n_embd
    if arch == "minicpm":
        # muP DEFAULTS for older GGUFs; KVs override when present
        # (llama-model.cpp:761-775)
        hp.f_embedding_scale = float(_k(md, arch, "embedding_scale", 12.0))
        hp.f_residual_scale = float(
            _k(md, arch, "residual_scale", 1.4 / hp.n_layer ** 0.5))
        # rides llm_build_granite, which DIVIDES logits by f_logit_scale
        # (granite.cpp:65) — store the inverted multiplier
        hp.logit_scale = 1.0 / float(
            _k(md, arch, "logit_scale", 256.0 / hp.n_embd))
    if arch == "chameleon":
        hp.extra["swin_norm"] = bool(_k(md, arch, "swin_norm", False))
        # image-token logits suppressed for text-only output
        # (chameleon.cpp:141-156 img_token range [4, 8196))
        hp.extra["logit_suppress"] = (4, 8196)
    moe_n = _k(md, arch, "moe_every_n_layers")
    if moe_n:
        hp.extra["moe_every_n_layers"] = int(moe_n)   # nomic-bert-moe
    if arch == "grok":
        # grok-1 defaults baked in the loader (llama-model.cpp:795-813)
        hp.f_embedding_scale = float(
            _k(md, arch, "embedding_scale", 78.38367176906169))
        hp.f_attn_scale = float(
            _k(md, arch, "attention.output_scale", 0.08838834764831845))
        hp.attn_logit_softcap = float(
            _k(md, arch, "attn_logit_softcapping", 30.0))
        hp.logit_scale = float(_k(md, arch, "logit_scale", 0.5773502691896257))
        hp.extra["moe_dense_parallel_scale"] = 2.0 ** 0.5 / 2.0
    if arch == "gemma3n":
        # AltUp/LAUREL/per-layer-input params (defaults llama-hparams.h:177;
        # the reference hardcodes kv_from_start=20 — E2B 30−10, E4B 35−15 —
        # honoring the converter's shared_kv_layers KV when present)
        shared = _k(md, arch, "attention.shared_kv_layers")
        sp = _k(md, arch, "activation_sparsity_scale")
        hp.extra["gemma3n"] = {
            "n_altup": int(_k(md, arch, "altup.num_inputs", 4) or 4),
            "i_altup_act": int(_k(md, arch, "altup.active_idx", 0) or 0),
            "n_embd_altup": int(
                _k(md, arch, "embedding_length_per_layer_input", 256) or 256),
            "n_layer_kv_from_start": (hp.n_layer - int(shared)
                                      if shared is not None else 20),
            # per-layer activation-sparsity std multipliers (0 = off);
            # default: first 10 layers at icdf(0.95) (models.h:198)
            "sparsity": ([float(x) for x in sp] if sp is not None else
                         [1.6448533535003662] * min(10, hp.n_layer)
                         + [0.0] * max(hp.n_layer - 10, 0)),
        }
        if hp.final_logit_softcap == 0.0:
            hp.final_logit_softcap = 30.0
    if arch in ("t5", "t5encoder"):
        hp.dec_n_layer = int(_k(md, arch, "decoder_block_count", hp.n_layer))
    if arch == "wavtokenizer-dec":
        hp.n_embd_features = int(_k(md, arch, "features_length", 0))
        hp.posnet_n_embd = int(_k(md, arch, "posnet.embedding_length", 0))
        hp.posnet_n_layer = int(_k(md, arch, "posnet.block_count", 0))
        hp.convnext_n_embd = int(_k(md, arch, "convnext.embedding_length", 0))
        hp.convnext_n_layer = int(_k(md, arch, "convnext.block_count", 0))
        hp.n_norm_groups = int(_k(md, arch, "attention.group_norm_groups", 32))
        hp.f_norm_group_eps = float(
            _k(md, arch, "attention.group_norm_epsilon", 1e-6))
    return hp
