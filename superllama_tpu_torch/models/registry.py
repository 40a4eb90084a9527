"""Architecture registry: GGUF ``general.architecture`` → forward function.

Counterpart of the JAX package's ``models/registry.py``, holding every
architecture the JAX package sends to ``llama_forward`` (the dense ones,
those with sparse mixtures of experts and llama4) or to
``deepseek2_forward`` (multi-head latent attention), the state-space
models to ``mamba_forward``, ``jamba_forward``, ``hybrid_forward`` and
``plamo2_forward``, and the linear-attention and short-conv models to the
RWKV forwards, ``lfm2_forward``, ``qwen3next_forward`` and
``gemma3n_forward``, and the diffusion LMs to ``llada_forward``: all 106
names of the JAX registry. The encoders, T5 and the WavTokenizer decoder
have no forward of the registry, as in JAX: they run through entry points
of their own (``runtime/embedder.py``, ``models/t5.py``,
``models/wavtokenizer.py``), and ``check_loadable`` lets the loader take
them."""

from __future__ import annotations

from typing import Callable

from .bert import ENCODER_ARCHS
from .deepseek2 import deepseek2_forward
from .gemma3n import gemma3n_forward
from .hybrid import hybrid_forward
from .jamba import jamba_forward
from .lfm2 import lfm2_forward
from .llada import llada_forward
from .llama import llama_forward
from .mamba import mamba_forward
from .plamo2 import plamo2_forward
from .qwen3next import qwen3next_forward
from .rwkv import arwkv7_forward, rwkv6_forward, rwkv6qwen2_forward, rwkv7_forward

ForwardFn = Callable  # (params, hp, tokens, pos, cache, **kw) -> (logits, cache)

# dense llama-family architectures: the shared forward, told apart by hparams
# and optional tensors (LayerNorm, ALiBi, parallel residual, learned
# positions, fused qkv / gate-up, per-layer heads, NoPE and M-RoPE variants)
LLAMA_ARCHS = (
    "llama", "llama2", "mistral", "tinyllama", "qwen2", "qwen3",
    "stablelm", "olmo", "olmo2", "exaone", "granite", "internlm2", "smollm3",
    "gemma", "gemma2", "gemma3", "phi3",
    "gpt2", "gptneox", "falcon", "starcoder", "starcoder2", "phi2",
    "command-r", "cohere2", "nemotron", "minicpm", "refact", "jais",
    "bloom", "mpt", "glm4", "chatglm",
    "seed_oss", "hunyuan-dense", "ernie4_5", "exaone4", "qwen2vl",
    "arcee", "apertus", "baichuan", "xverse", "orion", "qwen", "codeshell",
    "chameleon", "mistral3", "maincoder", "pangu-embedded", "bitnet",
    "deci", "openelm", "plamo", "plamo3", "qwen3vl",
)

# sparse mixture-of-experts architectures on the same forward: the router,
# shared and chunk experts, arctic's parallel branch and grok's dense plus
# MoE FFN, told apart by hparams and optional tensors
MOE_ARCHS = (
    "mixtral", "qwen2moe", "qwen3moe", "olmoe", "dbrx", "gpt-oss", "gptoss",
    "granitemoe", "glm4moe", "dots1", "ernie4_5-moe", "hunyuan-moe", "deepseek",
    "arctic", "grok", "bailingmoe", "bailingmoe2", "smallthinker", "minimax-m2",
    "exaone-moe", "grovemoe", "afmoe", "mimo2", "phimoe", "qwen3vlmoe",
)

# llama4 on the same forward: top-1 sigmoid routing with a shared expert, the
# L2 q/k norm, NoPE layers with temperature tuning, chunked attention
LLAMA4_ARCHS = ("llama4",)

# multi-head latent attention: the q LoRA (or a direct q), the compressed KV
# latent up-projected into the flat cache, leading dense layers, then MoE
MLA_ARCHS = ("deepseek2", "minicpm3", "plm")

# state-space models on the selective scan: pure mamba / mamba2 on a
# recurrent store, the hybrids on a KV cache beside it
SSM_ARCHS = {
    "mamba": mamba_forward, "mamba2": mamba_forward, "jamba": jamba_forward,
    "granitehybrid": hybrid_forward, "nemotron_h": hybrid_forward,
    "nemotron_h_moe": hybrid_forward, "falcon-h1": hybrid_forward,
    "plamo2": plamo2_forward,
}

# linear attention and short convs: the RWKV recurrences on an RWKVCache,
# lfm2's short conv and qwen3next's gated delta net beside attention on a
# hybrid memory, gemma3n's AltUp stack on the iSWA cache
LINEAR_ARCHS = {
    "rwkv6": rwkv6_forward, "rwkv7": rwkv7_forward, "arwkv7": arwkv7_forward,
    "rwkv6qwen2": rwkv6qwen2_forward, "lfm2": lfm2_forward, "lfm2moe": lfm2_forward,
    "qwen3next": qwen3next_forward, "gemma3n": gemma3n_forward,
}

# the llama graph's text path, as the JAX registry sends them: llama-embed
# (pooling is the host's), cogvlm (its fused qkv split at load; no path of
# either package reads its vis_* bank)
TEXT_PATH_ARCHS = ("llama-embed", "cogvlm")

# the diffusion LMs: the llama / qwen2 / qwen3-moe blocks bidirectional and
# without a cache (llada-moe and rnd1 on moe_ffn)
DIFFUSION_ARCHS = ("llada", "llada-moe", "dream", "rnd1")

# served through entry points of their own, not a registry forward
OWN_PATHS = {**dict.fromkeys(sorted(ENCODER_ARCHS), "runtime/embedder.py"),
             "t5": "models/t5.py", "t5encoder": "models/t5.py",
             "wavtokenizer-dec": "models/wavtokenizer.py"}

_REGISTRY: dict[str, ForwardFn] = {
    **{arch: llama_forward
       for arch in LLAMA_ARCHS + MOE_ARCHS + LLAMA4_ARCHS + TEXT_PATH_ARCHS},
    **{arch: deepseek2_forward for arch in MLA_ARCHS},
    **SSM_ARCHS,
    **LINEAR_ARCHS,
    **{arch: llada_forward for arch in DIFFUSION_ARCHS},
}


def get_forward(arch: str) -> ForwardFn:
    fn = _REGISTRY.get(arch)
    if fn is None:
        where = OWN_PATHS.get(arch)
        why = (f"it runs through {where}, not a forward of the registry" if where
               else "the JAX package's registry has no such name either")
        raise NotImplementedError(f"architecture {arch!r} has no registry forward: {why}")
    return fn


def check_loadable(arch: str) -> None:
    """Raise for a name that no path runs, in the port or in the JAX
    package: neither a forward of the registry nor an entry point of
    ``OWN_PATHS``."""
    if arch not in _REGISTRY and arch not in OWN_PATHS:
        raise NotImplementedError(
            f"architecture {arch!r} is not supported: no forward of the registry and no "
            f"encoder, T5 or WavTokenizer path runs it, here or in the JAX package")
