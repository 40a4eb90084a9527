"""Declarative CLI option table with environment-variable mirrors: the
port's copy of the JAX package's ``args.py``.

Counterpart of common/arg.cpp (the ~300-flag `common_arg` table): every
option declares its flags, an env-var alias (LLAMA_ARG_*), help text, and
the set of tools it applies to. `add_options(parser, tool)` attaches the
relevant subset to an argparse parser; env values become defaults
(flag > env > default precedence, common_params_parse semantics), which is
how a container passes its settings.

The table is the JAX package's, option for option, with one change:
``--device`` is the torch device the port runs on (default ``cuda``, or
``cpu``). Flags whose semantics belong to a host CPU, another vendor's
GPU stack or the TPU build are accepted and have no effect, as in the JAX
CLI; ``cli.UNPORTED`` lists the flags of features the port lacks, which
``run`` and ``serve`` refuse.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Any, Callable

ALL = frozenset({"run", "serve", "perplexity", "bench", "imatrix",
                 "diffusion"})
GEN = frozenset({"run", "serve", "diffusion"})          # generation tools
SRV = frozenset({"serve"})
RUN = frozenset({"run", "diffusion"})


@dataclass
class Opt:
    flags: tuple[str, ...]
    help: str
    tools: frozenset = ALL
    env: str | None = None          # explicit env name; auto when None
    type: Callable | None = None
    default: Any = None
    action: str | None = None
    choices: tuple | None = None
    dest: str | None = None
    metavar: str | None = None
    nargs: str | None = None
    repeatable: bool = False

    @property
    def env_name(self) -> str:
        if self.env:
            return self.env
        base = max(self.flags, key=len).lstrip("-").replace("-", "_").upper()
        return f"LLAMA_ARG_{base}"

    @property
    def dest_name(self) -> str:
        return self.dest or max(self.flags, key=len).lstrip("-").replace(
            "-", "_")


def _o(*flags, **kw) -> Opt:
    return Opt(tuple(flags), **kw)


# ----------------------------------------------------------------- the table
# Mirrors the reference option groups (common/arg.cpp): model/load, context,
# rope/yarn, sampling, grammar, speculative, server, enterprise/fork,
# logging. Flag names and env aliases match the reference where a direct
# counterpart exists.

OPTIONS: list[Opt] = [
    # ---- model / load
    _o("-m", "--model", help="GGUF model path", env="LLAMA_ARG_MODEL"),
    _o("--keep-quantized", help="keep repackable weights packed for the "
       "fused dequant-matmul path", action="store_true"),
    _o("--lora", help="LoRA adapter FILE[:SCALE] (repeatable)",
       repeatable=True, metavar="FILE[:SCALE]"),
    _o("--control-vector", help="control vector FILE[:SCALE] (repeatable)",
       repeatable=True, metavar="FILE[:SCALE]"),
    _o("--override-kv", help="override a GGUF metadata key: KEY=TYPE:VALUE "
       "(repeatable)", repeatable=True, metavar="KEY=TYPE:VALUE"),
    _o("--decrypt-key", help="AES-256-GCM key file for encrypted models"),
    # ---- context
    _o("-c", "--ctx-size", help="context window size", type=int,
       default=2048, env="LLAMA_ARG_CTX_SIZE"),
    _o("-b", "--batch-size", help="logical batch size (prompt chunking)",
       type=int, default=512, env="LLAMA_ARG_BATCH"),
    _o("-ub", "--ubatch-size", help="physical batch size per device step",
       type=int, default=512, env="LLAMA_ARG_UBATCH"),
    _o("-n", "--n-predict", help="tokens to generate", type=int,
       default=128, tools=GEN),
    _o("--keep", help="tokens kept from the initial prompt on context "
       "shift", type=int, default=0, tools=GEN),
    _o("--kv-dtype", help="KV cache dtype", default="bfloat16",
       choices=("bfloat16", "float32", "q8_0", "q4_0"),
       env="LLAMA_ARG_CACHE_TYPE_K"),
    _o("--flash-attn", help="flash attention: on/off/auto (accepted; "
       "the port always runs its attention kernels)", default="auto", choices=("on", "off", "auto"),
       env="LLAMA_ARG_FLASH_ATTN"),
    # ---- rope / long context
    _o("--rope-scaling", help="rope scaling type",
       choices=("none", "linear", "yarn"), env="LLAMA_ARG_ROPE_SCALING_TYPE"),
    _o("--rope-freq-base", help="rope base frequency override", type=float,
       env="LLAMA_ARG_ROPE_FREQ_BASE"),
    _o("--rope-freq-scale", help="rope frequency scale override",
       type=float, env="LLAMA_ARG_ROPE_FREQ_SCALE"),
    _o("--yarn-orig-ctx", help="YaRN original context size", type=int,
       env="LLAMA_ARG_YARN_ORIG_CTX"),
    _o("--yarn-attn-factor", help="YaRN attention magnitude factor",
       type=float, env="LLAMA_ARG_YARN_ATTN_FACTOR"),
    _o("--grp-attn-n", help="self-extend group size (seq_div factor)",
       type=int, default=1, tools=RUN),
    _o("--grp-attn-w", help="self-extend window width", type=int,
       default=512, tools=RUN),
    # ---- sampling (common_params_sampling)
    _o("-s", "--seed", help="RNG seed", type=int, default=0, tools=GEN),
    _o("--temp", help="temperature (<=0 → greedy)", type=float,
       default=0.8, tools=GEN),
    _o("--top-k", help="top-k", type=int, default=40, tools=GEN),
    _o("--top-p", help="top-p (nucleus)", type=float, default=0.95,
       tools=GEN),
    _o("--min-p", help="min-p", type=float, default=0.05, tools=GEN),
    _o("--typical", help="locally-typical sampling p", type=float,
       default=1.0, dest="typical_p", tools=GEN),
    _o("--xtc-probability", help="XTC removal probability", type=float,
       default=0.0, tools=GEN),
    _o("--xtc-threshold", help="XTC threshold", type=float, default=0.1,
       tools=GEN),
    _o("--top-n-sigma", "--top-nsigma", help="top-n-sigma cutoff (-1 = off)", type=float,
       default=-1.0, tools=GEN),
    _o("--dynatemp-range", help="dynamic temperature range", type=float,
       default=0.0, tools=GEN),
    _o("--dynatemp-exp", help="dynamic temperature exponent", type=float,
       default=1.0, dest="dynatemp_exponent", tools=GEN),
    _o("--repeat-last-n", help="penalty window (tokens)", type=int,
       default=64, dest="penalty_last_n", tools=GEN),
    _o("--repeat-penalty", help="repetition penalty", type=float,
       default=1.0, dest="penalty_repeat", tools=GEN),
    _o("--presence-penalty", help="presence penalty", type=float,
       default=0.0, dest="penalty_present", tools=GEN),
    _o("--frequency-penalty", help="frequency penalty", type=float,
       default=0.0, dest="penalty_freq", tools=GEN),
    _o("--dry-multiplier", help="DRY repetition penalty multiplier",
       type=float, default=0.0, tools=GEN),
    _o("--dry-base", help="DRY base", type=float, default=1.75, tools=GEN),
    _o("--dry-allowed-length", help="DRY allowed repeat length", type=int,
       default=2, tools=GEN),
    _o("--dry-penalty-last-n", help="DRY window (-1 = ctx)", type=int,
       default=-1, tools=GEN),
    _o("--mirostat", help="mirostat version (0/1/2)", type=int, default=0,
       tools=GEN),
    _o("--mirostat-ent", help="mirostat target entropy τ", type=float,
       default=5.0, dest="mirostat_tau", tools=GEN),
    _o("--mirostat-lr", help="mirostat learning rate η", type=float,
       default=0.1, dest="mirostat_eta", tools=GEN),
    _o("--adaptive-p-target", help="adaptive-p target probability "
       "(-1 = off)", type=float, default=-1.0, tools=GEN),
    _o("--adaptive-p-decay", help="adaptive-p EMA decay", type=float,
       default=0.9, tools=GEN),
    _o("-l", "--logit-bias", help="TOKEN_ID(+/-)BIAS (repeatable)",
       repeatable=True, metavar="TOKEN_ID(+/-)BIAS", tools=GEN),
    _o("--ignore-eos", help="never stop at end-of-generation tokens",
       action="store_true", tools=GEN),
    # ---- grammar / structured output
    _o("--grammar", help="GBNF grammar for constrained decoding",
       tools=GEN),
    _o("--grammar-file", help="file with a GBNF grammar", tools=GEN),
    _o("-j", "--json-schema", help="JSON schema to constrain output to",
       tools=GEN),
    # ---- speculative / lookup decoding
    _o("-md", "--draft-model", help="draft model for speculative decoding",
       env="LLAMA_ARG_MODEL_DRAFT", tools=GEN),
    _o("--draft-n", "--draft", help="draft tokens per round", type=int, default=8,
       env="LLAMA_ARG_DRAFT_MAX", dest="draft_n", tools=GEN),
    _o("--draft-p-min", help="min draft acceptance probability",
       type=float, default=0.0, tools=GEN),
    _o("--lookup-ngram-min", help="enable n-gram lookup decoding with this "
       "min ngram size (0 = off)", type=int, default=0, tools=GEN),
    # ---- server
    _o("--host", help="bind address", default="127.0.0.1",
       env="LLAMA_ARG_HOST", tools=SRV),
    _o("--port", help="bind port", type=int, default=8080,
       env="LLAMA_ARG_PORT", tools=SRV),
    _o("--api-key", help="NAME=KEY api key (repeatable)", repeatable=True,
       env="LLAMA_API_KEY", tools=SRV),
    _o("-np", "--slots", "--parallel", help="concurrent generation slots", type=int, default=4,
       env="LLAMA_ARG_N_PARALLEL", tools=SRV),
    _o("--timeout", help="per-request timeout seconds", type=int,
       default=600, tools=SRV),
    _o("--rate-limit", help="requests/min per client (0 = off)", type=int,
       default=0, tools=SRV),
    _o("--ssl-cert-file", help="TLS certificate (PEM)",
       env="LLAMA_ARG_SSL_CERT_FILE", tools=SRV),
    _o("--ssl-key-file", help="TLS private key (PEM)",
       env="LLAMA_ARG_SSL_KEY_FILE", tools=SRV),
    _o("--embed-model", help="encoder GGUF for /embeddings + /rerank",
       tools=SRV),
    _o("--chat-template", help="builtin chat template name override",
       env="LLAMA_ARG_CHAT_TEMPLATE", tools=SRV),
    _o("--router", help="router mode: proxy + dynamic model loading",
       action="store_true", tools=SRV),
    # ---- fork enterprise flags (common/arg.cpp:1301-1401)
    _o("--no-dynamic-layers", help="disable the device⇄host layer scheduler (accepted, no effect)",
       action="store_true", tools=SRV | RUN),
    _o("--no-paged-kv", help="disable the paged KV cache",
       action="store_true", dest="no_paged_kv", tools=SRV),
    _o("--paged-kv", help="serve with the paged KV cache (device⇄host spill)",
       action="store_true", tools=SRV),
    _o("--kv-page-size", help="tokens per KV page", type=int, default=256,
       tools=SRV),
    _o("--kv-pages", help="device-resident page pool size "
       "(default: slots*ctx/page + 1)", type=int, default=None, tools=SRV),
    _o("--mem-pressure", help="device memory pressure threshold (accepted, no effect)",
       type=float, default=0.85, tools=SRV | RUN),
    _o("--mem-pressure-low", help="device memory low-water mark (accepted, no effect)",
       type=float, default=0.75, tools=SRV | RUN),
    _o("--pin-layers", help="comma list of layer indices pinned on the device (accepted, no effect)",
       tools=SRV | RUN),
    _o("--metrics-file", help="JSONL metrics sink path",
       env="LLAMA_METRICS_FILE", tools=SRV),
    _o("--verbose-migration", help="log layer migrations",
       action="store_true", tools=SRV | RUN),
    # ---- misc
    _o("--preset", help="named parameter preset (presets.py)", tools=GEN),
    _o("-v", "--verbose", help="verbose logging", action="store_true"),
    _o("--log-file", help="mirror logs to a file", env="LLAMA_LOG_FILE"),
    # =================================================================
    # wave 3: the rest of the common/arg.cpp table. Flags whose semantics
    # are host-CPU or GPU-vendor specific are ACCEPTED (scripts written for
    # the reference keep working) and have no effect.
    # ---- sampling (rest)
    _o("--samplers", help="semicolon list ordering the sampler chain",
       env="LLAMA_ARG_SAMPLERS", tools=GEN),
    _o("--sampler-seq", help="single-char shorthand for --samplers",
       tools=GEN),
    _o("--dry-sequence-breaker", help="DRY sequence breaker (repeatable; "
       "'none' clears)", repeatable=True, tools=GEN),
    _o("--seed-draft", help="draft model RNG seed", type=int, tools=GEN),
    # ---- prompt / io
    # (-p/--prompt and -f/--file are declared by the run/diffusion
    # subcommands directly — they are positional-required there)
    _o("--in-file", help="input file (repeatable)", repeatable=True),
    _o("-e", "--escape", help="process prompt escape sequences "
       "(\\n, \\t, …)", action="store_true", tools=RUN),
    _o("--no-escape", help="do not process escape sequences",
       action="store_true", tools=RUN),
    _o("--in-prefix", help="prefix prepended to user inputs", tools=RUN),
    _o("--in-suffix", help="suffix appended to user inputs", tools=RUN),
    _o("--in-prefix-bos", help="prepend BOS to user inputs",
       action="store_true", tools=RUN),
    _o("--system-prompt", help="system message", dest="system_prompt",
       tools=RUN),
    _o("--verbose-prompt", help="print the tokenized prompt",
       action="store_true", tools=RUN),
    _o("--display-prompt", help="echo the prompt before generation "
       "(default)", action="store_true", tools=RUN),
    _o("--no-display-prompt", help="do not echo the prompt",
       action="store_true", tools=RUN),
    _o("--simple-io", help="plain stdin/stdout (no console codes)",
       action="store_true", tools=RUN),
    _o("--interactive", help="interactive chat mode", action="store_true",
       tools=RUN),
    _o("--interactive-first", help="wait for input before generating",
       action="store_true", tools=RUN),
    _o("--multiline-input", help="allow multi-line input terminated by \\",
       action="store_true", tools=RUN),
    _o("--color", help="colorized output", action="store_true", tools=RUN),
    _o("--reverse-prompt", help="stop generation at this string "
       "(repeatable)", repeatable=True, tools=RUN),
    _o("--special", help="render special/control tokens in output",
       action="store_true", tools=RUN),
    _o("--spm-infill", help="suffix/prefix/middle FIM token order",
       action="store_true", tools=RUN),
    # ---- context / memory (rest)
    _o("--context-shift", help="enable context shift on a full window",
       action="store_true", env="LLAMA_ARG_CONTEXT_SHIFT", tools=GEN),
    _o("--no-context-shift", help="fail instead of shifting on a full "
       "context", action="store_true", tools=GEN),
    _o("--cache-reuse", help="min prompt-cache chunk length to reuse via "
       "KV shift", type=int, default=0, env="LLAMA_ARG_CACHE_REUSE",
       tools=SRV),
    _o("--cache-prompt", help="reuse cached prompt KV across requests "
       "(default)", action="store_true", tools=SRV),
    _o("--no-cache-prompt", help="disable prompt KV reuse",
       action="store_true", tools=SRV),
    _o("--swa-full", help="keep full-size KV for SWA layers (disable the "
       "two-tier iSWA cache)", action="store_true",
       env="LLAMA_ARG_SWA_FULL", tools=GEN),
    _o("--swa-checkpoints", help="max SWA rollback checkpoints per slot",
       type=int, default=3, env="LLAMA_ARG_SWA_CHECKPOINTS", tools=SRV),
    _o("--ctx-checkpoints", help="max context checkpoints per slot",
       type=int, default=8, tools=SRV),
    _o("--kv-unified", help="single shared KV buffer across slots",
       action="store_true", env="LLAMA_ARG_KV_SPLIT", tools=SRV),
    _o("--cache-type-v", help="V cache dtype (K and V are quantized "
       "together; accepted for compatibility)", default="bfloat16",
       env="LLAMA_ARG_CACHE_TYPE_V", tools=GEN),
    _o("--defrag-thold", help="KV defrag threshold (no-op: the ring cache "
       "never fragments)", type=float, default=0.1, tools=GEN),
    _o("--prompt-cache", help="save/load prompt KV state to this file",
       tools=RUN),
    _o("--prompt-cache-all", help="also cache generated tokens",
       action="store_true", tools=RUN),
    _o("--prompt-cache-ro", help="use the prompt cache read-only",
       action="store_true", tools=RUN),
    # ---- rope / yarn (rest)
    _o("--rope-scale", help="rope context scaling factor (reciprocal of "
       "--rope-freq-scale)", type=float, tools=GEN),
    _o("--yarn-ext-factor", help="YaRN extrapolation mix factor",
       type=float, default=-1.0, env="LLAMA_ARG_YARN_EXT_FACTOR",
       tools=GEN),
    _o("--yarn-beta-fast", help="YaRN low-correction dim", type=float,
       default=32.0, env="LLAMA_ARG_YARN_BETA_FAST", tools=GEN),
    _o("--yarn-beta-slow", help="YaRN high-correction dim", type=float,
       default=1.0, env="LLAMA_ARG_YARN_BETA_SLOW", tools=GEN),
    # ---- model load (rest)
    _o("-mu", "--model-url", help="model download URL (cached, resumable)",
       env="LLAMA_ARG_MODEL_URL"),
    _o("-hf", "--hf-repo", help="HuggingFace repo user/model[:QUANT]",
       env="LLAMA_ARG_HF_REPO"),
    _o("-hff", "--hf-file", help="HF file name", env="LLAMA_ARG_HF_FILE"),
    _o("-hfd", "--hf-repo-draft", help="HF repo for the draft model",
       env="LLAMA_ARG_HF_REPO_DRAFT"),
    _o("-hft", "--hf-token", help="HF auth token", env="HF_TOKEN"),
    _o("--mmap", help="mmap model weights (default)", action="store_true"),
    _o("--no-mmap", help="read weights instead of mmap",
       action="store_true", env="LLAMA_ARG_NO_MMAP"),
    _o("--mlock", help="lock weights in RAM (no-op: weights live on the device)",
       action="store_true", env="LLAMA_ARG_MLOCK"),
    _o("--check-tensors", help="validate tensor data while loading",
       action="store_true"),
    _o("--override-tensor", help="per-tensor buffer override (no-op: every "
       "tensor lives on the device)", repeatable=True, metavar="PATTERN"),
    _o("--tensor-filter", help="regex filter of tensors to load",
       repeatable=True),
    _o("--repack", help="repack weights for the fused kernels "
       "(--keep-quantized)", action="store_true"),
    _o("--lora-scaled", help="LoRA adapter with scale: FILE SCALE "
       "(repeatable)", repeatable=True, nargs="+", metavar="FILE SCALE",
       tools=GEN),
    _o("--lora-init-without-apply", help="load adapters without applying "
       "(apply later via /lora-adapters)", action="store_true", tools=SRV),
    _o("--control-vector-scaled", help="control vector with scale: FILE "
       "SCALE (repeatable)", repeatable=True, nargs="+", tools=GEN),
    _o("--control-vector-layer-range", help="layer range START END for "
       "control vectors", nargs="+", metavar="START END", tools=GEN),
    # ---- threads / scheduling (host-CPU semantics; accepted, no effect)
    _o("-t", "--threads", help="host threads (no-op: torch owns "
       "threading)", type=int, default=-1, env="LLAMA_ARG_THREADS"),
    _o("-tb", "--threads-batch", help="host threads for batch processing "
       "(accepted, no effect)", type=int, default=-1),
    _o("--threads-draft", help="draft-model threads (accepted, no effect)",
       type=int, default=-1, tools=GEN),
    _o("--threads-batch-draft", help="draft batch threads (accepted, no effect)",
       type=int, default=-1, tools=GEN),
    _o("--cpu-mask", help="CPU affinity mask (accepted, no effect)"),
    _o("--cpu-range", help="CPU affinity range (accepted, no effect)"),
    _o("--cpu-strict", help="strict CPU placement (accepted, no effect)",
       type=int, default=0),
    _o("--cpu-mask-batch", help="batch CPU mask (accepted, no effect)"),
    _o("--cpu-range-batch", help="batch CPU range (accepted, no effect)"),
    _o("--cpu-strict-batch", help="strict batch placement (accepted, no effect)",
       type=int, default=0),
    _o("--cpu-mask-draft", help="draft CPU mask (accepted, no effect)",
       tools=GEN),
    _o("--cpu-range-draft", help="draft CPU range (accepted, no effect)",
       tools=GEN),
    _o("--cpu-strict-draft", help="strict draft placement (accepted, no effect)",
       type=int, default=0, tools=GEN),
    _o("--cpu-mask-batch-draft", help="draft batch CPU mask (no-op)",
       tools=GEN),
    _o("--cpu-strict-batch-draft", help="strict draft batch placement "
       "(accepted, no effect)", type=int, default=0, tools=GEN),
    _o("--poll", help="polling level for work waits (accepted, no effect)",
       type=int, default=50),
    _o("--poll-batch", help="batch polling level (accepted, no effect)",
       type=int),
    _o("--poll-draft", help="draft polling level (accepted, no effect)", type=int,
       tools=GEN),
    _o("--poll-batch-draft", help="draft batch polling (accepted, no effect)",
       type=int, tools=GEN),
    _o("--prio", help="process priority (accepted, no effect)", type=int,
       default=0),
    _o("--prio-batch", help="batch priority (accepted, no effect)", type=int),
    _o("--prio-draft", help="draft priority (accepted, no effect)", type=int,
       tools=GEN),
    _o("--prio-batch-draft", help="draft batch priority (accepted, no effect)",
       type=int, tools=GEN),
    _o("--numa", help="NUMA strategy (accepted, no effect)",
       choices=("distribute", "isolate", "numactl")),
    # ---- device / split (one device in the port)
    _o("-ngl", "--gpu-layers", help="layers offloaded to device (no-op: "
       "all layers live on the device)",
       type=int, default=-1, env="LLAMA_ARG_N_GPU_LAYERS"),
    _o("--gpu-layers-draft", help="draft model device layers (no-op)",
       type=int, default=-1, tools=GEN),
    _o("--split-mode", help="multi-device split mode (accepted, no "
       "effect: one device)", choices=("none", "layer", "row")),
    _o("--tensor-split", help="per-device split fractions (accepted, no "
       "effect)", env="LLAMA_ARG_TENSOR_SPLIT"),
    _o("--main-gpu", help="main device ordinal (no-op: --device names it)",
       type=int, default=0),
    _o("--device", help="torch device: cuda (default) or cpu",
       default="cuda", env="LLAMA_ARG_DEVICE"),
    _o("--device-draft", help="draft model device list (no-op)",
       tools=GEN),
    _o("--list-devices", help="print available devices and exit",
       action="store_true"),
    _o("--rpc", help="RPC server list (accepted, no effect)", env="LLAMA_ARG_RPC"),
    _o("--no-op-offload", help="disable host op offload (accepted, no effect)",
       action="store_true"),
    _o("--no-kv-offload", help="keep KV on host (no-op: KV lives on the device)",
       action="store_true", env="LLAMA_ARG_NO_KV_OFFLOAD"),
    _o("--no-repack", help="disable weight repacking", action="store_true"),
    _o("--no-host", help="bypass host buffers (accepted, no effect)",
       action="store_true"),
    # ---- speculative (rest)
    _o("--draft-min", help="min draft tokens per round", type=int,
       default=1, env="LLAMA_ARG_DRAFT_MIN", tools=GEN),
    _o("--draft-p-split", help="draft split probability", type=float,
       default=0.1, tools=GEN),
    _o("--spec-replace", help="TARGET DRAFT template replacement for "
       "vocab-translated speculation", nargs="+", repeatable=True,
       tools=GEN),
    _o("--ctx-size-draft", help="draft model context size", type=int,
       default=0, env="LLAMA_ARG_CTX_SIZE_DRAFT", tools=GEN),
    _o("--cache-type-k-draft", help="draft K cache dtype", tools=GEN),
    _o("--cache-type-v-draft", help="draft V cache dtype", tools=GEN),
    # ---- embeddings / rerank
    _o("--embedding", help="embedding mode (llama-embedding)",
       action="store_true", env="LLAMA_ARG_EMBEDDINGS",
       tools=SRV | frozenset({"embedding"})),
    _o("--pooling", help="pooling type",
       choices=("none", "mean", "cls", "last", "rank"),
       env="LLAMA_ARG_POOLING", tools=SRV | frozenset({"embedding"})),
    _o("--attention", help="attention type for embeddings",
       choices=("causal", "non-causal"),
       tools=frozenset({"embedding"})),
    _o("--embd-normalize", help="embedding normalization: -1=none, 0=max "
       "abs, 2=L2, >2=p-norm", type=int, default=2,
       tools=frozenset({"embedding"})),
    _o("--embd-output-format", help="output format: '', 'array', 'json', "
       "'json+'", tools=frozenset({"embedding"})),
    _o("--embd-separator", help="separator between input prompts",
       tools=frozenset({"embedding"})),
    _o("--cls-separator", help="separator for classification pairs",
       tools=frozenset({"embedding"})),
    _o("--rerank", help="reranking mode (/rerank endpoint)",
       action="store_true", env="LLAMA_ARG_RERANKING", tools=SRV),
    _o("--embd-gemma-default", help="load EmbeddingGemma defaults",
       action="store_true", tools=frozenset({"embedding"})),
    # ---- perplexity / eval tool
    _o("--ppl", help="perplexity over the input text (default mode)",
       action="store_true", tools=frozenset({"perplexity"})),
    _o("--ppl-stride", help="stride for sliding-window ppl", type=int,
       default=0, tools=frozenset({"perplexity"})),
    _o("--ppl-output-type", help="0 = final ppl, 1 = per-chunk table",
       type=int, default=0, tools=frozenset({"perplexity"})),
    _o("--hellaswag", help="HellaSwag scoring mode", action="store_true",
       tools=frozenset({"perplexity"})),
    _o("--hellaswag-tasks", help="number of HellaSwag tasks", type=int,
       default=400, tools=frozenset({"perplexity"})),
    _o("--winogrande", help="Winogrande scoring mode", action="store_true",
       tools=frozenset({"perplexity"})),
    _o("--winogrande-tasks", help="number of Winogrande tasks", type=int,
       default=0, tools=frozenset({"perplexity"})),
    _o("--multiple-choice", help="multiple-choice scoring mode",
       action="store_true", tools=frozenset({"perplexity"})),
    _o("--multiple-choice-tasks", help="number of MC tasks", type=int,
       default=0, tools=frozenset({"perplexity"})),
    _o("--kl-divergence", help="KL divergence vs a saved logits file",
       action="store_true", tools=frozenset({"perplexity"})),
    _o("--save-all-logits", "--kl-divergence-base",
       help="save logits to this file for later KL comparison",
       dest="save_logits_file", tools=frozenset({"perplexity"})),
    _o("--chunks", help="max chunks to process (-1 = all)", type=int,
       default=-1, tools=frozenset({"perplexity", "imatrix"})),
    # ---- imatrix tool
    _o("--save-frequency", help="save every N chunks (0 = only at end)",
       type=int, default=0, tools=frozenset({"imatrix"})),
    _o("--output-frequency", help="status print frequency", type=int,
       default=10, tools=frozenset({"imatrix"})),
    _o("--process-output", help="collect stats for the output tensor",
       action="store_true", tools=frozenset({"imatrix"})),
    _o("--in-file-imatrix", help="previous imatrix to continue from",
       repeatable=True, tools=frozenset({"imatrix"})),
    _o("--show-statistics", help="print imatrix tensor statistics",
       action="store_true", tools=frozenset({"imatrix"})),
    # ---- cvector generator
    _o("--positive-file", help="positive prompts file",
       tools=frozenset({"cvector"})),
    _o("--negative-file", help="negative prompts file",
       tools=frozenset({"cvector"})),
    _o("--pca-batch", help="PCA batch size", type=int, default=100,
       tools=frozenset({"cvector"})),
    _o("--pca-iter", help="PCA iterations", type=int, default=1000,
       tools=frozenset({"cvector"})),
    _o("--method", help="dimensionality reduction method",
       choices=("pca", "mean"), tools=frozenset({"cvector"})),
    # ---- server (rest)
    _o("--threads-http", help="HTTP worker threads", type=int, default=-1,
       env="LLAMA_ARG_THREADS_HTTP", tools=SRV),
    _o("--api-prefix", help="prefix prepended to all routes",
       env="LLAMA_ARG_API_PREFIX", tools=SRV),
    _o("--api-key-file", help="file with one api key per line", tools=SRV),
    _o("--metrics", help="enable /metrics (prometheus)",
       action="store_true", env="LLAMA_ARG_ENDPOINT_METRICS", tools=SRV),
    _o("--props", help="enable POST /props updates", action="store_true",
       env="LLAMA_ARG_ENDPOINT_PROPS", tools=SRV),
    _o("--slots-endpoint", help="enable /slots (default)",
       action="store_true", tools=SRV),
    _o("--no-slots", help="disable /slots", action="store_true",
       env="LLAMA_ARG_NO_ENDPOINT_SLOTS", tools=SRV),
    _o("--slot-save-path", help="directory for slot KV state files",
       tools=SRV),
    _o("--slot-prompt-similarity", help="min prompt similarity to reuse a "
       "slot", type=float, default=0.5, tools=SRV),
    _o("--webui", help="serve the bundled web UI (default)",
       action="store_true", tools=SRV),
    _o("--no-webui", help="disable the web UI", action="store_true",
       env="LLAMA_ARG_NO_WEBUI", tools=SRV),
    _o("--webui-config", help="inline JSON web UI config", tools=SRV),
    _o("--webui-config-file", help="web UI config file", tools=SRV),
    _o("--jinja", help="render chat templates with the jinja engine "
       "(default; builtin fallback otherwise)", action="store_true",
       env="LLAMA_ARG_JINJA", tools=SRV),
    _o("--no-jinja", help="builtin chat templates only",
       action="store_true", tools=SRV),
    _o("--chat-template-file", help="file with a jinja chat template",
       env="LLAMA_ARG_CHAT_TEMPLATE_FILE", tools=SRV),
    _o("--chat-template-kwargs", help="JSON of extra template variables",
       env="LLAMA_CHAT_TEMPLATE_KWARGS", tools=SRV),
    _o("--reasoning-format", help="how reasoning is returned",
       choices=("auto", "none", "deepseek", "deepseek-legacy"),
       env="LLAMA_ARG_THINK", tools=SRV),
    _o("--reasoning-budget", help="max thinking tokens (-1 = unlimited, "
       "0 = disable thinking)", type=int, default=-1,
       env="LLAMA_ARG_THINK_BUDGET", tools=SRV),
    _o("--prefill-assistant", help="prefill an open assistant message "
       "(default on)", action="store_true",
       env="LLAMA_ARG_PREFILL_ASSISTANT", tools=SRV),
    _o("--no-prefill-assistant", help="never prefill assistant messages",
       action="store_true", tools=SRV),
    _o("--models-dir", help="router: directory of loadable GGUFs",
       env="LLAMA_ARG_MODELS_DIR", tools=SRV),
    _o("--models-max", help="router: max resident models", type=int,
       default=4, env="LLAMA_ARG_MODELS_MAX", tools=SRV),
    _o("--models-autoload", help="router: load models on first use "
       "(default)", action="store_true", tools=SRV),
    _o("--no-models-autoload", help="router: explicit /models/load only",
       action="store_true", tools=SRV),
    _o("--models-preset", help="router: preset config file", tools=SRV),
    # ---- multimodal
    _o("--mmproj", help="multimodal projector GGUF",
       env="LLAMA_ARG_MMPROJ", tools=GEN),
    _o("--mmproj-url", help="mmproj download URL (unavailable: "
       "zero-egress)", env="LLAMA_ARG_MMPROJ_URL", tools=GEN),
    _o("--no-mmproj", help="ignore any bundled mmproj", action="store_true",
       tools=GEN),
    _o("--no-mmproj-offload", help="keep the vision tower on host (accepted, "
       "no effect)", action="store_true", tools=GEN),
    _o("--mmproj-auto", help="auto-locate the mmproj next to the model "
       "(default)", action="store_true", tools=GEN),
    _o("--image", help="image file for multimodal prompts (repeatable)",
       repeatable=True, tools=GEN),
    _o("--image-min-tokens", help="min image patch tokens", type=int,
       tools=GEN),
    _o("--image-max-tokens", help="max image patch tokens", type=int,
       tools=GEN),
    _o("--media-path", help="base directory for media references",
       tools=GEN),
    # ---- TTS
    _o("--tts-oute-default", help="load OuteTTS default model pair",
       action="store_true", tools=frozenset({"tts"})),
    _o("--tts-speaker-file", help="speaker embedding JSON",
       tools=frozenset({"tts"})),
    _o("--tts-use-guide-tokens", help="use guide tokens for word recall",
       action="store_true", tools=frozenset({"tts"})),
    _o("--vocoder-model", help="WavTokenizer decoder GGUF",
       tools=frozenset({"tts"})),
    # ---- diffusion LMs
    _o("--diffusion-steps", help="denoising steps", type=int, default=128,
       tools=frozenset({"diffusion"})),
    _o("--diffusion-algorithm", help="unmasking algorithm id", type=int,
       default=4, tools=frozenset({"diffusion"})),
    _o("--diffusion-visual", help="live denoising display",
       action="store_true", tools=frozenset({"diffusion"})),
    _o("--diffusion-eps", help="timestep epsilon", type=float,
       tools=frozenset({"diffusion"})),
    _o("--diffusion-block-length", help="block length for semi-ar "
       "generation", type=int, tools=frozenset({"diffusion"})),
    _o("--diffusion-alg-temp", help="algorithm temperature", type=float,
       tools=frozenset({"diffusion"})),
    _o("--diffusion-cfg-scale", help="classifier-free guidance scale",
       type=float, tools=frozenset({"diffusion"})),
    _o("--diffusion-add-gumbel-noise", help="add gumbel noise",
       action="store_true", tools=frozenset({"diffusion"})),
    # ---- logging (rest)
    _o("--log-disable", help="disable all logging", action="store_true"),
    _o("--log-colors", help="colorized log output",
       choices=("on", "off", "auto"), env="LLAMA_LOG_COLORS"),
    _o("--log-timestamps", help="prefix log lines with timestamps",
       action="store_true", env="LLAMA_LOG_TIMESTAMPS"),
    _o("--log-prefix", help="prefix log lines with the level",
       action="store_true", env="LLAMA_LOG_PREFIX"),
    _o("--log-verbosity", help="verbosity threshold", type=int, default=0,
       env="LLAMA_LOG_VERBOSITY"),
    _o("--perf", help="print performance counters at exit",
       action="store_true", dest="perf"),
    _o("--no-perf", help="disable performance counters",
       action="store_true"),
    _o("--show-timings", help="per-request timing breakdown (server "
       "default)", action="store_true", tools=SRV),
    # ---- bench / parallel drivers
    _o("--pps", help="batched-bench: prompt is shared across sequences",
       action="store_true", tools=frozenset({"bench"})),
    _o("-npp", help="batched-bench prompt lengths (comma list)",
       dest="n_pp", tools=frozenset({"bench"})),
    _o("-ntg", help="batched-bench generation lengths", dest="n_tg",
       tools=frozenset({"bench"})),
    _o("-npl", help="batched-bench batch sizes", dest="n_pl",
       tools=frozenset({"bench"})),
    _o("--junk", help="passkey: junk paragraph repeats", type=int,
       default=250, tools=frozenset({"bench"})),
    _o("--pos", help="passkey: needle position", type=int, default=-1,
       tools=frozenset({"bench"})),
    # ---- misc (rest)
    _o("--version", help="print version and exit", action="store_true"),
    _o("--license", help="print license and exit", action="store_true"),
    _o("--completion-bash", help="print a bash completion script",
       action="store_true"),
    _o("--warmup", help="run a warmup pass (default)", action="store_true"),
    _o("--no-warmup", help="skip model warmup", action="store_true"),
    _o("--check-tensors-draft", help="validate draft tensors",
       action="store_true", tools=GEN),
    _o("--offline", help="offline mode: never touch the network "
       "(always true in this build)", action="store_true",
       env="LLAMA_OFFLINE"),
]

_BY_DEST = {o.dest_name: o for o in OPTIONS}


def add_options(parser: argparse.ArgumentParser, tool: str,
                exclude: set[str] = frozenset()) -> None:
    """Attach every option whose tool mask includes `tool`. Environment
    mirrors become defaults (flag > env > declared default)."""
    for o in OPTIONS:
        if tool not in o.tools or o.dest_name in exclude:
            continue
        kw: dict[str, Any] = {"help": f"{o.help} (env {o.env_name})",
                              "dest": o.dest_name}
        env_val = os.environ.get(o.env_name)
        if o.action:
            kw["action"] = o.action
            kw["default"] = (env_val not in (None, "", "0", "false", "off")
                             if env_val is not None else False)
        else:
            if o.type:
                kw["type"] = o.type
            if o.choices:
                kw["choices"] = o.choices
            if o.metavar:
                kw["metavar"] = o.metavar
            if o.repeatable:
                kw["action"] = "append"
            default = o.default
            if env_val is not None:
                default = ([env_val] if o.repeatable
                           else (o.type(env_val) if o.type else env_val))
            kw["default"] = default
        parser.add_argument(*o.flags, **kw)


def sampling_from_args(args: argparse.Namespace) -> dict:
    """Collect the sampler-chain kwargs (make_chain signature) present on a
    parsed namespace."""
    keys = ("seed", "temp", "top_k", "top_p", "min_p", "typical_p",
            "xtc_probability", "xtc_threshold", "top_n_sigma",
            "dynatemp_range", "dynatemp_exponent", "penalty_last_n",
            "penalty_repeat", "penalty_freq", "penalty_present",
            "dry_multiplier", "dry_base", "dry_allowed_length",
            "dry_penalty_last_n", "mirostat", "mirostat_tau", "mirostat_eta",
            "adaptive_p_target", "adaptive_p_decay")
    out = {k: getattr(args, k) for k in keys if hasattr(args, k)}
    biases = {}
    for spec in getattr(args, "logit_bias", None) or []:
        tok, _, val = spec.replace("+", ":").replace("-", ":-").partition(":")
        try:
            biases[int(tok)] = float(val)
        except ValueError:
            continue
    if biases:
        out["logit_bias"] = biases
    return out
