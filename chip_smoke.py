#!/usr/bin/env python3
"""Chip smoke of superllama_tpu_torch, the PyTorch / CUDA port: drives the
port's serving path on one NVIDIA GPU and holds every kernel to its plain
PyTorch version.

    python3 chip_smoke.py                 # every phase (the chip check)
    python3 chip_smoke.py --kernel-times  # device, build, the kernel rows of phase 6,
                                          # the lone prompt chunks' profiles of phase 7
    python3 chip_smoke.py --checks        # device, build, the kernel checks of phase 3
    python3 chip_smoke.py --fa-times      # device, build, fa's rows of phase 6
    python3 chip_smoke.py --paged-times   # device, build, paged's rows of phase 6
    python3 chip_smoke.py --qmv-times     # device, build, qmv's rows of phase 6 and
                                          # a bf16 decode block's profile
    python3 chip_smoke.py --graphs        # device, build, phase 4b, phase 4c and the
                                          # bf16 serving waves of phase 4
    python3 chip_smoke.py --prefill       # device, build, phases 4b and 4d, the
                                          # one-row paged chunk of phase 5, the TTFTs
                                          # of phase 6, the lone prompts of phase 7
    python3 chip_smoke.py --state         # device, build, phase 4e
    python3 chip_smoke.py --grammar       # device, build, phase 4f
    python3 chip_smoke.py --spec          # device, build, phase 4g
    python3 chip_smoke.py --server        # device, build, phase 4h
    python3 chip_smoke.py --formats       # device, build, phase 4i
    python3 chip_smoke.py --toolchain     # device, build, phase 4j
    python3 chip_smoke.py --archs         # device, build, phase 4k
    python3 chip_smoke.py --moe           # device, build, phase 4l
    python3 chip_smoke.py --mla           # device, build, phase 4m
    python3 chip_smoke.py --ssm           # device, build, phase 4n
    python3 chip_smoke.py --linear        # device, build, phase 4o
    python3 chip_smoke.py --encoders      # device, build, phase 4p
    python3 chip_smoke.py --format-times  # device, build, every format's qmv and
                                          # qmm readings (phase 6's format rows), and
                                          # qmm of a format of each layout at every
                                          # served shape, M 17 and 32 (with a list
                                          # F1,F2 after the flag: those formats'
                                          # gate/up rows alone)
    python3 chip_smoke.py --qmm-plans     # device, build, qmm of a format of each
                                          # layout at every served (K, N): the
                                          # plan's K split against the others
    python3 chip_smoke.py --base-times    # device, build, the Q8_0 / Q4_K / Q6_K
                                          # rows of --format-times
    python3 chip_smoke.py --qmv-clusters  # device, build, qmv of a format of each
                                          # kernel format at every served (K, N):
                                          # the plan's cluster against none
                                          # (--sweep: against every grid)

Phases, each printing one JSON line:
 1. device: torch's name and capability, nvidia-smi's name and power limit;
 2. build: nvcc of every kernel source in superllama_tpu_torch/csrc;
 3. kernels against their plain versions at Llama-3-8B shapes (qmv, qmm,
    fa's two kernels, fd in its f/q8/q4 modes, paged's decode kernel and
    its two prefill kernels, the four qmv-probe variants, which are also
    held against qmv), at head sizes 80, 96, 100 and 256, fd with chunks of
    two passes, fa at a 1024-token chunk, fa and paged over positions in no
    order with holes, paged over pages smaller than a tile; qmv, qmm, the
    tensor-core attention kernels and the decode kernels called twice and
    held bit-equal; qmv's row 0 of an M 8 and an M 16 call held bit-equal
    to the row alone, and the residency qmv's grids assume checked on the
    card; each
    fa and paged call checked to take the kernel its types and shape ask
    for; then (3b) each of the twenty other weight formats (seeded random
    GGUF bytes through the port's repack) through qmv at M 1, 8, 16 and
    qmm at M 17, 32, bf16 and f32 x, at the 8B's gate/up and down shapes,
    and a format of each family, group size and adds at every other shape
    the serving mixes and the 1B-width file drive (qmv at M 1, 5, 8, 16,
    qmm at M 17, 32), each call counted in its family (int8 codes,
    nibbles, Q5_K), and the M 33 dequantize + matmul path against the CPU
    for a format of each family; qmv's row 0 of an M 8 and an M 16 call
    held bit-equal to the row alone, and qmm's row 0 of an M 32 call to
    an M 17 call's, for a format of each layout at every such shape; one
    qmv call of Q4_K and of each of those formats profiled to one device
    kernel each (no reduce, no quantizer), and one bf16 qmm call of each
    of the 23 types to its layout's qmm_tc_kernel instantiation (then
    qmm_reduce where the plan splits K); each of qmm's eleven
    instantiations at two blocks an SM on the card;
 4. serving: a synthetic Llama-3-8B-width Q4_K model behind the port's HTTP
    server (warmed up first, as ``serve`` does: no graph may be captured
    while it serves) answers 8 concurrent completions and one streamed
    one, greedy, then 8 sampled ones (temperature 0.8, top-k 40, top-p
    0.95, min-p 0.05, a seed each, two with repeat penalty 1.1) twice; the
    served tokens equal the engine's own, every decode block and every
    prompt chunk is a CUDA-graph replay (the device sampler chain inside
    the sampled blocks), and the launch counters, which count a replay's
    launches, show the path went through every kernel (fa only through its
    tensor-core kernel). Then the same with a Q8_0 KV cache (fd decode),
    with the paged KV cache (prefill through paged's tensor-core kernel; an
    ample pool, then a pool of about half the wave's pages that must spill
    to host), and a short wave on an f32 cache (fa's CUDA-core kernel);
 4b. graph against eager decode blocks and prompt chunks (the 8B widths
    at GRAPH_LAYERS = 4; phases 4c-4i and 4g's draft at 8) on the bf16, Q8_0
    and paged caches, greedy and sampled waves, and lone 100- and
    1000-token prompts: equal tokens, bit-equal written cache rows, equal
    launch counts, every block and chunk of the graph engine a replay;
 4c. DecodeLoop (prefill + one captured graph of the decode steps) against
    engine.generate, and a seeded sampled loop repeated;
 4d. Engine.warmup on a bf16 and a paged engine: the keys, their capture
    seconds, the graph pool's bytes, then a 32- and a 1000-token request
    with no capture after the warm-up, and their TTFT;
 4e. the engine's state between requests on warmed-up bf16, Q8_0 and paged
    servers: a second turn that reuses a 1000-token prompt's cache (its
    tail through fa's or paged's tensor-core kernel; on the paged cache a
    16-token tail through qmm) against the same prompt on an erased slot,
    slot save / erase / restore bit-equal (dense), no capture after the
    warm-up, TTFT with and without reuse, and /metrics, /slots,
    /tokenize, /detokenize and /slots/:id over HTTP;
 4f. structured output on warmed-up bf16, Q8_0 and paged servers of the
    model with a 128,256-piece tokenizer: a bounded JSON schema greedy
    (bf16) and seeded sampled (Q8_0, paged; Q8_0's repeated on an erased
    slot)
    ends by EOS with schema-valid text through the host-sampled step (qmv;
    fd on Q8_0, paged on paged; no decode block while it generates); a
    wave of 7 plain requests beside one grammar request; over HTTP
    response_format, a GBNF grammar, tool calls plain and streamed and a
    bad grammar's 400; no capture after the warm-up; the host step's
    forward ms, the mask's ms a token and the grammar request's tok/s;
 4g. the decode variants at full width, eager (no graph for their rounds):
    speculative engines of 4 slots (bf16 with a synthetic Llama-3.2-1B-width
    draft at n_draft 8, served over HTTP and warmed up; Q8_0 and paged with
    that draft at n_draft 7; bf16 with the 8B as its own draft at 7; bf16
    with a draft of another vocab through the translator), lookup engines
    (bf16, paged; prompts of repeated spans): 4 greedy requests of 32 tokens
    (16 on the engines with the 1B draft) must give the plain engine's
    tokens on the same cache, or part at one position where the two
    candidates' logits lie within the two paths' difference there, each
    later token ranked first or near it by the plain prefill of the
    variant's own tokens; a seeded sampled request repeats on an erased slot;
    the draft rollout launches qmv (and fd on Q8_0), the verify qmm, fd or
    paged where its shape asks; context shift on bf16, Q8_0 and paged
    engines (n_ctx 512, 600 tokens, the first shift held against the plain
    op on a CPU copy); lookahead against Context greedy; self-extend's
    positions and re-roped K; tok/s of each beside the plain engines';
 4h. the server's front door on warmed-up servers of the 8B widths (8
    layers deep) with a 128,256-piece tokenizer carrying FIM pieces: API
    keys (401 without a key and with a bad one; Bearer and x-api-key), a
    client past its rate (429), the audit log, /health "healthy", one
    JSONL metrics line per request; /v1/messages greedy (64 tokens)
    equal to /v1/completions of the rendered prompt on bf16, Q8_0 and
    paged caches, streamed (the
    Messages API's events in order), with tools (tool_choice any: a
    tool_use block within the schema), count_tokens; /v1/responses and
    /api/chat equal to the chat route, /api/tags, /api/show, /infill equal
    to the FIM ids' completion, /embeddings 501; /profile around 4
    requests (the trace names engine.prefill, engine.decode, qmv and fa's
    tensor-core kernel; decode tok/s inside and outside the window); a
    ModelRouter serving the 8B and the 1B-width model, whose unload returns
    its device memory to within 64 MB; no capture after any warm-up; the
    launches of qmv, qmm, fa, fd and paged; each front-door step's host
    cost over 1,000 calls and each part's seconds;
 4i. the weight formats on the serving path: the 8B-width model (8
    layers) in the
    Q4_0, Q5_K_M and IQ4_XS mixes (weights made on the card in repack's
    layout) over HTTP on a bf16 cache, greedy and sampled
    waves equal to the engine's, a full-width forward against the plain
    versions, decode tok/s and TTFT; then a Llama-3.2-1B-width GGUF of
    mixed formats written by the port's writer, split in two shards,
    loaded onto the card from the first shard (planes equal to repack's,
    the unsplit file equal) and served;
 4j. the model-file toolchain: a Llama-3-8B-width, 32-layer Q4_K_M GGUF
    (Q4_K blocks and token_embd, Q6_K attn_v, ffn_down and output, the
    128,256-piece tokenizer; every layer the bytes of layer 0) written by
    the port's GGUFWriter, loaded through the native repack (its seconds
    and thread counts; layer 0's planes bit-equal to the numpy route's,
    both routes timed on the same bytes) and served greedy on a bf16 cache
    (a lone prompt through qmm and fa, a wave through qmv); at
    Llama-3.2-1B's widths, 16 layers and its tied head, an F16 GGUF of
    seeded weights through the CLI's quantize to Q4_K_M (a few rows of
    three tensors equal to the numpy encoders' bytes; the files
    WORKFLOW_LAYERS deep), imatrix on the card over the repo's own text,
    quantize --imatrix at a cut depth (IMATRIX_LAYERS, IMATRIX_ROLES; its
    weighted tensors differ from the plain file's, the others equal),
    perplexity of the F16 and the Q4_K_M file on the same text, the KL divergence of Q4_K_M
    against F16, and the packed load's perplexity against the dequantized
    one (PPL_TOL); about 200 KB of the repo's text through the native and
    the Python tokenizer, equal ids, both timed;
 4k. the dense architecture registry: a Command-R7B-width GGUF (cohere2:
    4096 wide, ARCH_LAYERS = 4 of 32 layers, 32/8 heads of 128, FFN
    14,336, a 256,000-piece vocab, a 4,096 window on three layers of four
    and NoPE on the fourth, LayerNorm, a parallel residual, tied
    embeddings; a Q4_K_M-style mix of
    rand_raw bytes, every layer layer 0's) written, loaded packed and its
    hparams checked; a 4,600-token prompt (the M > 32 path, fa_tc) whose
    last 32-token chunk through the kernels (qmm, fa_tc) and through the
    plain versions over the same cache agree within ARCH_NMSE; 16 greedy
    tokens on a bf16, a Q8_0 (fd) and a paged (paged) cache through the
    Engine held to the eager plain route by greedy_rule; the 4,600-token
    prompt again on one-slot iSWA Engines (ISWA_BUCKETS, a 4,352-slot
    ring that the prompt wraps) with graphs and without (tokens, both
    tiers' rows and launches equal, every chunk and block a replay), held
    to a flat-cache Engine by greedy_rule, with both caches' KV bytes and
    TTFTs; an 8-slot wave on the iSWA cache against an eager engine; a
    wave of 8 over HTTP after the warm-up (the iSWA cache; every block and
    chunk a replay), B 1 / B 8 decode tok/s and the warm TTFT of 32
    tokens. Then eight feature
    families (bloom: ALiBi; phi3: fused qkv and a packed fused gate-up;
    gpt2: learned positions; falcon: parallel residual; deci: per-layer
    heads; chameleon; gemma2: D 256 with softcaps; qwen3vl: IMROPE) at 2
    layers (deci 4), 1,024 wide: first-token logits on the card against
    the port's CPU plain forward of the same file, and 4 greedy requests
    on a warmed Q8_0 Engine (ALiBi: no fa, no fd launch);
 4l. sparse mixtures of experts: gmm (the grouped GEMM in place of
    ragged_dot) against its plain version at Qwen3-30B-A3B's decode (64
    rows) and 256-token chunk (2,048 rows) shapes and Mixtral-8x7B's, bf16
    and f32, an empty group, one group of many tiles and an unaligned
    shape (the plain-load path), two calls bit-equal, and its times beside
    torch._grouped_mm; a Qwen3-30B-A3B-width Q4_K_M-style file (128
    experts of 768, top 8, at MOE_LAYERS of 48 layers; F32 routers) written,
    loaded (banks as bf16) and served: 16 greedy tokens on bf16, Q8_0 and
    paged caches held to the eager plain route by greedy_rule, a wave whose
    graph-replayed blocks and chunks equal an eager engine's bit for bit,
    a served wave of 8 after the warm-up (every block and chunk a replay),
    B 1 / B 8 decode and the warm TTFT; then seven MoE families (mixtral,
    gpt-oss with MXFP4 banks, grovemoe, arctic, grok, qwen2moe, glm4moe) at
    2 layers, 1,024 wide: first-token logits on the card against the
    port's CPU plain forward;
 4m. the remaining attention forms: a DeepSeek-V2-Lite-width (MLA: 16
    heads of 128 + 64 over a 512-wide latent, 64 experts of 1,408, top 6,
    2 shared, layer 0 dense) and a Llama-4-Scout-width (5,120 wide, 40/8
    heads, 16 experts of 8,192, top 1, a shared expert, chunked attention
    of 8,192, layer 3 NoPE) Q4_K_M-style file at MLA_LAYERS layers,
    written, loaded and checked against the published configs; DeepSeek2's
    16 greedy tokens on a bf16 cache held to the plain route by
    greedy_rule and its Q8_0 refusal; Scout's 8,400-token prompt (past
    its chunk) and 16 greedy tokens held to the plain route by greedy_rule
    (a parting beyond the paths' limit explained by a router near tie,
    router_tie); for each a wave whose replayed blocks and chunks equal an
    eager engine's, a served wave of 8, B 1 / B 8 and the warm TTFT; then
    the held attention routes' times (held_route_times);
 4n. state-space models: ssm_scan (the selective scan in place of the
    mixers' lax.scan) against its plain loop at falcon-mamba-7B's Mamba-1
    and Bamba-9B's Mamba-2 widths (B 8 T 1, B 1 T 256; G 1 and 8), f32 and
    bf16 state, with idle rows, two calls bit-equal, and its times; a
    Bamba-9B-width granitehybrid (SSM_LAYERS of 32 layers, attention at
    layer 9) and a falcon-mamba-7B-width mamba (MAMBA_LAYERS of 64) as
    Q4_K_M-style rand_raw files, written, loaded and checked; greedy tokens
    held to the plain route (the scan's plain loop) by greedy_rule; Bamba:
    a wave replayed against eager (tokens and every state row bit-equal),
    the warm-up's keys, the TTFT of a 32- and a 1,000-token prompt (pow2
    chunks), a slot save / restore round trip, the refusals of paged, Q8_0,
    speculative, lookup and context shift; both served over HTTP (B 1 / B 8,
    every block and chunk a replay, fa and fd never launched); the held
    routes' times (the hybrid attention's plain path against fa_tc / fd,
    the plain conv); six more SSM names at the tests' widths against the
    port's CPU forward;
 4o. linear attention and short convs: wkv (the wkv6, gla, wkv7 and delta
    net recurrences in place of the models' lax.scan) against its plain
    loops at RWKV-6-7B's, rwkv6qwen2's (head sizes 64 and 128), RWKV-7-2.9B's
    and Qwen3-Next's widths (B 8 T 1 with an idle row, B 1 T 256; the delta
    net with an f32 and a bf16 state), two calls bit-equal, and their times;
    an RWKV-6-7B and an RWKV-7-2.9B (LINEAR_LAYERS of 32) and a
    Qwen3-Next-80B-A3B (QWEN3NEXT_LAYERS: three delta-net layers and the
    gated attention layer, 512 experts) as Q4_K_M-style rand_raw files,
    written, loaded packed and checked; greedy tokens held to the plain
    route by greedy_rule; a wave replayed against eager (tokens, every state
    and KV row, launches); the TTFT of a 32- and a 1,000-token prompt and
    B 1 / B 8 on a warmed engine (RWKV-6: a slot save / restore round trip;
    Qwen3-Next: gmm); arwkv7, rwkv6qwen2, lfm2, lfm2moe and gemma3n at 1,024
    wide against the port's CPU forward, and 4 greedy requests each on a
    warmed engine;
 4p. encoders, T5, diffusion LMs and TTS, each at published widths from a
    file of seeded bytes, each part's launches counted in its own run:
    nomic-embed-text-v1.5 (nomic-bert, 12 layers) packed through the
    Embedder at 16 rows (qmv) and 32 rows (qmm) against the plain route
    (cosine ≥ EMBED_COS); EmbeddingGemma-300M (24 layers, a symmetric
    window of 512) dense at B 8 × T 512 and its texts a second;
    nomic-embed-text-v2-moe (8 experts, top 2, every second layer) at
    B 8 × T 512 through gmm (the JAX gather form would hold about 150 GB)
    against the plain route; a bge-reranker-v2-m3-width bert reranker (24
    layers, a classification head) behind a ``serve --embed-model`` process
    of the CLI: /v1/embeddings and /rerank over HTTP, the scores equal to
    the in-process Embedder's; the ``diffusion`` CLI (--keep-quantized, the
    vocab's mask token) on LLaDA-8B, Dream-v0-7B and RND1 (Qwen3-30B-A3B
    widths, gmm) at DIFFUSION_LAYERS, each generation recorded and run
    again through the plain route on the same params (tokens equal or
    parted at a near tie, diffusion_rule), a step's ms split into the
    forward and the host; flan-t5-large at full depth packed: the bucket
    table on the card equal to the CPU's, ``T5Model.generate`` against the
    plain route, the encoder's ms (qmm) and ms a token (qmv); the ``tts``
    CLI with an OuteTTS-0.2-500M-width voice LM (its head biased toward the
    audio codes; a prompt of ≥ 32 tokens on an f32 cache: fa's CUDA-core
    kernel) and a WavTokenizer-large-width decoder, a WAV of non-zero
    samples, the pipeline's seconds a second of audio, the decoder's frames
    against its CPU run; the plain attention of EmbeddingGemma and
    LLaDA-8B beside fa_tc's causal time at the same shapes;
 5. full-width parity: one 8B forward with the kernels and again with the
    plain versions; decode through fd against the materialized path on Q8_0
    and Q4_0 caches; the paged cache against the dense one; a one-row paged
    prompt chunk against the same chunk padded to 8 rows;
 6. times: decode tok/s (greedy and sampled, blocks replayed from CUDA
    graphs, with the captures' time and the graph pool's bytes), time to
    first token of a 32-, 100- and 1000-token prompt (bf16, Q8_0, paged),
    cold (the first request to reach its chunk's graph key) and warm, and
    each kernel's time beside its plain version, a library call and its
    bound (qmv at every (K, N) of a decode step and their sum over a step;
    qmm at every (K, N) of a lone prompt chunk; fa at the serving wave, a
    lone 32-token chunk and a 1024-token chunk; paged's prefill path at the
    engine's one-row chunk of a 100-token prompt, at that chunk padded to 8
    rows and at a long prompt's 256-token chunk),
    kernel and library both read from a CUDA graph over inputs rotated past
    the L2 (the eager reading beside it);
 7. profile (the 8B widths at a depth of 8 layers): where a lone 32-token
    and a lone 1000-token prompt's time goes (bf16 cache; the 1000-token one also on the paged cache), its
    chunks eager and replayed from CUDA graphs, and where one engine
    decode step's time goes on each cache, its block eager and replayed
    from a CUDA graph (torch.profiler), qmv, the decode-attention kernels
    and cache writes apart;
 8. tools: the measurement tools' path (the qmv probe at two 8B shapes,
    ops_bench at its default shapes, flash_decode_probe, a short llama-bench
    and batched-bench on the 8B model) with its own launch counts, then each probe variant's
    time (from a CUDA graph, weights past the L2) beside its plain version,
    a library call, qmv and its bound.
The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
SEED = 0
T_START = time.perf_counter()
CUT_LAYERS = 8   # the depth of phases 4c-4i and 7's 8B-width model
# the depth of phase 4b's graph-against-eager engines: their eager runs,
# host-bound, take most of its time
GRAPH_LAYERS = 4


def emit(obj) -> None:
    if "phase" in obj:   # a phase's line carries the script's seconds so far
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def nmse(got, ref) -> float:
    g, r = got.double(), ref.double()
    return float(((g - r) ** 2).mean() / (r ** 2).mean().clamp_min(1e-300))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------ 1. device


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unavailable"
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "capability": list(torch.cuda.get_device_capability(0)),
            "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


# ------------------------------------------------------------ 2. build


def phase_build() -> None:
    """nvcc of every source, all started together (build_all), each one's
    seconds from the start to its library."""
    from superllama_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    regs = {}
    for name, log in logs.items():
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.txt"), "w") as f:
            f.write(log)
        used = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln]
        regs[name] = used
    emit({"phase": "build", "seconds": dt, "sources": list(_build.SOURCES),
          "source_seconds": dict(_build.SECONDS), "ptxas_used": regs})


# ------------------------------------------------------------ 3. kernels


def rand_weight(torch, kind: str, N: int, K: int, seed: int):
    """A random weight of the given format, generated on the card."""
    from superllama_tpu_torch.gguf.constants import GGMLType
    from superllama_tpu_torch.models.synthetic import rand_q4k
    from superllama_tpu_torch.ops.qtensor import QTensor

    dev = torch.device("cuda")
    if kind == "Q4_K":
        return rand_q4k(f"w{seed}", N, K, seed, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1000 + seed)
    ri = lambda lo, hi, shape, dt: torch.randint(lo, hi, shape, generator=g,
                                                 device=dev, dtype=dt)
    if kind == "Q6_K":
        d = torch.rand((K // 256, N), generator=g, device=dev) / (16.0 * 32 * math.sqrt(K))
        return QTensor(ri(0, 256, (K // 2, N), torch.uint8), None, None, 16, 32,
                       True, K, N, GGMLType.Q6_K, sc=ri(-32, 33, (K // 16, N), torch.int8),
                       d=d, hi=ri(0, 256, (K // 4, N), torch.uint8), hi_bits=2, sb=16)
    scales = torch.rand((K // 32, N), generator=g, device=dev) / (64.0 * math.sqrt(K))
    return QTensor(ri(-127, 128, (K, N), torch.int8), scales, None, 32, 0, False,
                   K, N, GGMLType.Q8_0)


KN_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
# the same of the Llama-3.2-1B-width draft (phase 4g): its rollout sends
# them through qmv at 4 and 8 rows, the translated draft's catch-up through
# qmm at up to 32
KN_1B = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (2048, 128256)]
# launches of each (K, N) in a lone prompt chunk of the 8B model: wq+wo, wk+wv,
# gate+up, down per layer (32 layers), the output head once
CHUNK_LAUNCHES = {(4096, 4096): 64, (4096, 1024): 64, (4096, 14336): 64,
                  (14336, 4096): 32, (4096, 128256): 1}
# head sizes the JAX kernels take and the first port refused (Llama-style
# 80, 96, 256; OpenLLaMA-3B's 100: 3200 over 32 heads)
HEAD_SIZES = (80, 96, 100, 256)
# (M, K, N) grid of tests/test_backend_ops.py plus the 3- and 13-row qmv
# instantiations
EDGE_SHAPES = [(1, 512, 64), (5, 512, 128), (128, 512, 64), (16, 1024, 96),
               (1, 768, 64), (8, 768, 128), (2, 544, 128), (33, 544, 64),
               (47, 1024, 96), (8, 512, 640), (3, 512, 64), (13, 768, 96)]
# (T, S, G, swa, softcap, sinks, q8): the FA_CELLS of tests/test_backend_ops.py
FA_EDGE_CELLS = ([(T, S, G, 0, 0.0, False, False)
                  for T, S in ((1, 256), (8, 256), (64, 64), (100, 131)) for G in (1, 4)]
                 + [(T, S, 4, swa, cap, sk, q8) for T, S in ((1, 256), (64, 128))
                    for swa, cap, sk, q8 in ((32, 0.0, False, False), (0, 30.0, False, False),
                                             (0, 0.0, True, False), (0, 0.0, False, True),
                                             (32, 0.0, True, True))])


def fa_inputs(torch, B=1, T=32, S=2048, n_past=500, H=32, Hkv=8, D=128,
              dtype="bf16", q8=False, sinks=False, lens=None, scramble=False, seed=0,
              ring_end=None):
    """Cache layout inputs: slots [0, n_past + len) occupied in order, the
    rest empty (-1); query rows at positions n_past..n_past+len-1, padding
    rows (beyond each row's len) at -1. ``scramble``: each row's positions
    are scattered over all S slots in no order and one in eight of them is
    dropped (-1), as after seq_rm or a slot copy. ``ring_end`` (one a row):
    an iSWA ring after a wrap, slot p % S holding position p for every p in
    [ring_end - S, ring_end), the query rows its last len positions."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn((B, T, H, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, Hkv, S, D), generator=g, device=dev)
    v = torch.randn((B, Hkv, S, D), generator=g, device=dev)
    lens = lens or [T] * B
    q_pos = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    kv_pos = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        if ring_end is not None:
            end = ring_end[b]
            q_pos[b, :n] = torch.arange(end - n, end, device=dev)
            p = torch.arange(max(end - S, 0), end, device=dev)
            kv_pos[b, p % S] = p.to(torch.int32)
            continue
        q_pos[b, :n] = torch.arange(n_past, n_past + n, device=dev)
        kv_pos[b, :n_past + n] = torch.arange(n_past + n, device=dev)
    if scramble:
        cpu = torch.Generator().manual_seed(seed)
        for b in range(B):
            row = kv_pos[b, torch.randperm(S, generator=cpu).to(dev)]
            row[torch.randperm(S, generator=cpu)[:S // 8].to(dev)] = -1
            kv_pos[b] = row
    kw = {}
    if q8:
        ks = k.abs().amax(-1) / 127.0
        vs = v.abs().amax(-1) / 127.0
        k = torch.round(k / ks[..., None]).to(torch.int8)
        v = torch.round(v / vs[..., None]).to(torch.int8)
        kw = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = k.to(dt), v.to(dt)
    if sinks:
        kw["sinks"] = torch.randn((H,), generator=g, device=dev)
    return (q, k, v, q_pos, kv_pos), kw


# (T, S, G, kv, swa, softcap, sinks): the FD_CELLS of tests/test_backend_ops.py
FD_EDGE_CELLS = ([(1, S, G, kv, 0, 0.0, False) for S in (256, 1000, 2048) for G in (1, 4)
                  for kv in ("f", "q8", "q4")]
                 + [(1, 512, 4, "f", 64, 0.0, False), (1, 512, 4, "q8", 0, 30.0, False),
                    (1, 512, 4, "f", 0, 0.0, True), (8, 512, 4, "q8", 0, 0.0, False),
                    (2, 512, 2, "q4", 64, 0.0, True)])


def fd_inputs(torch, B=8, T=1, S=2048, H=32, Hkv=8, D=128, kv="f", dtype="bf16",
              sinks=False, n_past=None, seed=0):
    """Decode inputs: a cache of S slots with the last few empty, query rows
    at the newest positions; K/V float in q's type, or Q8_0 / Q4_0 codes
    and scales from the port's quantizers."""
    from superllama_tpu_torch.runtime.kv_cache import q4_quantize_rows, q8_quantize_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn((B, T, H, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, Hkv, S, D), generator=g, device=dev)
    v = torch.randn((B, Hkv, S, D), generator=g, device=dev)
    n_past = S - T - 3 if n_past is None else n_past
    q_pos = (torch.arange(T, dtype=torch.int32, device=dev)[None] + n_past).expand(B, T)
    slot = torch.arange(S, dtype=torch.int32, device=dev)[None]
    kv_pos = torch.where(slot < n_past + T, slot, -1).expand(B, S)
    kw = {}
    if kv == "f":
        k, v = k.to(dt), v.to(dt)
    else:
        quantize = q8_quantize_rows if kv == "q8" else q4_quantize_rows
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize(k), quantize(v)
    if sinks:
        kw["sinks"] = torch.randn((H,), generator=g, device=dev)
    return (q, k, v, q_pos.contiguous(), kv_pos.contiguous()), kw


def paged_inputs(torch, B=8, T=1, H=32, Hkv=8, D=128, P=256, MAXP=8, dtype="bf16",
                 lens=None, absent=(), gap=0, scramble=False, seed=0):
    """A shuffled pool of B*MAXP+1 pages (page 0 = NULL) holding each row's
    first lens[b] positions; ``absent`` (row, logical page) entries are -1;
    ``gap`` > 0 leaves the last gap slots of every page empty (the gaps of
    closed pages), positions going on in the next page. Query rows at each
    row's newest min(T, n) positions, then padding (-1): a row shorter than
    T is a prompt chunk shorter than its bucket, a row of length 0 padding
    only over an empty table (the rows riding along in a page-chunked
    prefill). ``scramble``: each row's positions scattered over its pages'
    slots in no order, one in eight dropped (-1)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    N = B * MAXP + 1
    lens = lens or [P * MAXP] * B
    kp = torch.randn((N, Hkv, P, D), generator=g, device=dev).to(dt)
    vp = torch.randn((N, Hkv, P, D), generator=g, device=dev).to(dt)
    order = iter((torch.randperm(N - 1, generator=torch.Generator().manual_seed(seed)) + 1)
                 .tolist())
    table = torch.full((B, MAXP), -1, dtype=torch.int32)
    page_pos = torch.full((N, P), -1, dtype=torch.int32)
    per = P - gap
    for b, n in enumerate(lens):
        for lg in range(-(-n // per)):
            if (b, lg) in absent:
                continue
            pg = next(order)
            table[b, lg] = pg
            cnt = min(per, n - lg * per)
            page_pos[pg, :cnt] = torch.arange(lg * per, lg * per + cnt)
    if scramble:
        cpu = torch.Generator().manual_seed(seed)
        for b in range(B):
            pgs = table[b][table[b] > 0].long()
            vals = page_pos[pgs].reshape(-1)
            vals = vals[torch.randperm(vals.numel(), generator=cpu)]
            vals[torch.randperm(vals.numel(), generator=cpu)[:vals.numel() // 8]] = -1
            page_pos[pgs] = vals.reshape(len(pgs), P)
    q = torch.randn((B, T, H, D), generator=g, device=dev).to(dt)
    q_pos = torch.full((B, T), -1, dtype=torch.int32)
    for b, n in enumerate(lens):
        m = min(T, n)
        q_pos[b, :m] = torch.arange(n - m, n, dtype=torch.int32)
    return (q, kp, vp, q_pos.to(dev), page_pos.to(dev), table.to(dev))


def check_decode_kernels(torch, record) -> None:
    """fd (f/q8/q4 at the 8B decode shapes, the FD_CELLS grid in f32, a
    split-chunk combine) and paged (8 rows, 256-token pages, absent pages,
    SWA, sinks, softcap) against their plain versions, each result passed
    to record(kernel, case, got, ref, dtype, mask=None, p_bf16=False)."""
    from superllama_tpu_torch.ops.flash_attention import (flash_decode_attention,
                                                          flash_decode_plain)
    from superllama_tpu_torch.ops.paged_attention import (paged_flash_attention,
                                                          paged_flash_attention_plain)

    f32 = torch.float32
    fd_cases = [(f"{kv} T={T} S={S} bf16", dict(T=T, S=S, kv=kv), {})
                for kv in ("f", "q8", "q4") for T in (1, 8) for S in (2048, 1000)]
    fd_cases += [("q8 T=8 S=2048 sinks bf16", dict(T=8, kv="q8", sinks=True), {}),
                 ("f T=1 S=2048 swa=512 bf16", dict(kv="f"), {"swa_window": 512}),
                 ("f T=1 S=2048 block_s=256 f32", dict(kv="f", dtype="f32"), {"block_s": 256}),
                 ("q8 T=1 S=2048 block_s=256 bf16", dict(kv="q8"), {"block_s": 256})]
    for T, S, G, kv, swa, cap, sk in FD_EDGE_CELLS:
        fd_cases.append((f"f32 T={T} S={S} G={G} {kv} swa={swa} softcap={cap} sinks={sk}",
                         dict(B=2, T=T, S=S, H=2 * G, Hkv=2, D=64, kv=kv, dtype="f32",
                              sinks=sk), {"swa_window": swa, "logit_softcap": cap}))
    # the cluster geometry's edges: one batch row, two chunks (the combine
    # kernel runs), a partial cluster, G 8 (64/8 heads)
    fd_cases += [(f"{kv} B=1 S={S} bf16", dict(B=1, S=S, kv=kv), {})
                 for kv in ("f", "q8", "q4") for S in (2048, 4096)]
    fd_cases += [(f"{kv} T=1 S={S} bf16", dict(S=S, kv=kv), {})
                 for kv in ("f", "q8", "q4") for S in (4096, 1000)]
    fd_cases += [(f"{kv} G=8 T={T} bf16", dict(T=T, H=64, kv=kv), {})
                 for kv in ("f", "q8", "q4") for T in (1, 4)]
    fd_cases += [("q8 T=1 S=4096 block_s=256 sinks bf16", dict(S=4096, kv="q8", sinks=True),
                  {"block_s": 256}),
                 ("f T=1 S=2048 swa=100 f32", dict(kv="f", dtype="f32"), {"swa_window": 100})]
    # head sizes outside 16/32/64/128 (D 100: 100-byte Q8_0 and 200-byte bf16
    # rows, the word-copy path), and T*G 32 with block_s 4096 (two passes
    # through the logits workspace)
    fd_cases += [(f"{kv} D={D} T=2 S=1000 {dt}", dict(B=2, T=2, S=1000, D=D, kv=kv, dtype=dt,
                                                       sinks=True), {})
                 for D in HEAD_SIZES for kv in ("f", "q8") for dt in ("bf16", "f32")]
    fd_cases += [(f"q4 D={D} T=2 S=1000 bf16", dict(B=2, T=2, S=1000, D=D, kv="q4"), {})
                 for D in (96, 256)]
    # rows that are not 4-byte multiples take the byte copies: Q8_0 at D 50,
    # bf16 at D 51 (102-byte rows, 13 output groups of 4 columns, the last part)
    fd_cases += [("q8 D=50 T=2 S=1000 bf16", dict(B=2, T=2, S=1000, D=50, kv="q8"), {}),
                 ("f D=51 T=2 S=1000 bf16", dict(B=2, T=2, S=1000, D=51, kv="f"), {})]
    fd_cases += [(f"{kv} T=8 (T*G 32) S=4096 block_s=4096 bf16", dict(B=2, T=8, S=4096, kv=kv),
                  {"block_s": 4096}) for kv in ("f", "q8", "q4")]
    fd_cases += [("q8 T=8 S=6000 block_s=4096 sinks swa=3000 bf16",
                  dict(B=2, T=8, S=6000, kv="q8", sinks=True),
                  {"block_s": 4096, "swa_window": 3000})]
    # the 1B draft's rollout on its Q8_0 cache: 4 rows of head size 64, G 4,
    # the catch-up over a 2-token tail and the single-token steps
    fd_cases += [(f"q8 D=64 B=4 T={T} n_past 150 bf16 (the 1B draft's rollout)",
                  dict(B=4, T=T, D=64, kv="q8", n_past=150), {}) for T in (1, 2)]
    for i, (case, kw, opts) in enumerate(fd_cases):
        args, extra = fd_inputs(torch, seed=300 + i, **kw)
        got = flash_decode_attention(*args, **extra, **opts)
        again = flash_decode_attention(*args, **extra, **opts)
        ref = flash_decode_plain(*args, **extra, **opts)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"fd {case}: two calls differ")
        record("fd", case, got, ref, args[0].dtype, p_bf16=kw["kv"] != "f")
    # block_s 2048 against 256: one chunk against eight, combined
    args, _ = fd_inputs(torch, kv="f", dtype="f32", seed=399)
    one = flash_decode_attention(*args, block_s=2048)
    eight = flash_decode_attention(*args, block_s=256)
    torch.cuda.synchronize()
    record("fd", "f32 combine: block_s 256 vs 2048", eight, one, f32)

    lens = [2048, 1900, 1500, 1025, 700, 300, 2000, 1]
    absent = {(1, 2), (3, 0), (6, 7)}
    paged_cases = [("bf16 T=1", dict(), {}), ("f32 T=1", dict(dtype="f32"), {}),
                   ("bf16 T=1 lens+absent", dict(lens=lens, absent=absent), {}),
                   ("f32 T=8 lens+absent swa=300 sinks", dict(T=8, dtype="f32", lens=lens,
                                                             absent=absent), {"swa_window": 300,
                                                                              "sinks": True}),
                   ("bf16 T=8 sinks", dict(T=8), {"sinks": True}),
                   ("f32 T=64 softcap=30", dict(T=64, dtype="f32", lens=[1024] * 8),
                    {"logit_softcap": 30.0})]
    # the decode kernel's geometry: B 1, small pages, G 8, either side of
    # the prefill path (T*G 32 and 36), gaps left by closed pages, a row
    # longer than one pass
    paged_cases += [("bf16 B=1 T=1", dict(B=1), {}),
                    ("bf16 T=1 P=16 MAXP=128", dict(P=16, MAXP=128), {}),
                    ("bf16 T=1 P=64 MAXP=32 lens+absent", dict(P=64, MAXP=32, lens=lens,
                                                                absent=absent), {}),
                    ("f32 T=1 P=16 MAXP=64 swa=200 sinks", dict(P=16, MAXP=64, dtype="f32"),
                     {"swa_window": 200, "sinks": True}),
                    ("bf16 G=8 T=1", dict(H=64), {}),
                    ("bf16 G=8 T=4", dict(H=64, T=4), {}),
                    ("bf16 T=8 (T*G 32, decode path)", dict(T=8), {}),
                    ("bf16 T=9 (T*G 36, prefill path)", dict(T=9), {}),
                    ("f32 T=8 (T*G 32) softcap=30", dict(T=8, dtype="f32"),
                     {"logit_softcap": 30.0}),
                    ("bf16 T=1 P=64 gaps", dict(P=64, MAXP=40, gap=12, lens=[2000] * 8), {}),
                    ("bf16 T=4 P=16 gaps lens", dict(P=16, MAXP=190, gap=5, lens=lens), {}),
                    ("bf16 B=2 T=1 MAXP=128 (two passes)", dict(B=2, MAXP=128), {})]
    # head sizes outside 16/32/64/128, on both paths, 64- and 256-token pages
    paged_cases += [(f"{dt} D={D} T={T} P={P}", dict(B=2, T=T, D=D, P=P, MAXP=2048 // P // 4,
                                                      dtype=dt, lens=[500, 371]), {})
                    for D in HEAD_SIZES for T in (1, 9) for P in (64, 256)
                    for dt in ("bf16", "f32")]
    paged_cases += [(f"bf16 D=51 T={T} P=64 (byte copies)",
                     dict(B=2, T=T, D=51, P=64, MAXP=8, lens=[500, 371]), {}) for T in (1, 9)]
    # the tensor-core prefill kernel's own cases: 16-token pages with gaps
    # (tiles across pages), pages that are no whole number of tiles,
    # positions in no order with holes (with a window and sinks), the
    # serving chunk of a 100-token prompt (seven rows of padding only over
    # empty tables), a long prompt's fourth chunk, a chunk too long for the
    # cluster split, D 256, G 8; the cluster split (one row a call, as the
    # engine sends) at a 100-token prompt's chunk and over scrambled
    # positions with a window and sinks
    paged_cases += [("bf16 T=16 P=16 gaps lens (tiles across pages)",
                     dict(T=16, P=16, MAXP=190, gap=5, lens=lens), {}),
                    ("bf16 T=64 P=100 (pages no whole number of tiles)",
                     dict(B=2, T=64, P=100, MAXP=12, lens=[1100, 640]), {}),
                    ("bf16 T=64 P=64 scrambled positions",
                     dict(B=2, T=64, P=64, MAXP=16, lens=[1000, 700], scramble=True), {}),
                    ("bf16 T=64 P=64 scrambled positions swa=300 sinks",
                     dict(B=2, T=64, P=64, MAXP=16, lens=[1000, 700], scramble=True),
                     {"swa_window": 300, "sinks": True}),
                    ("bf16 B=8 T=128 prompt 100, 7 padding rows (serving chunk)",
                     dict(T=128, lens=[100] + [0] * 7), {}),
                    ("bf16 B=1 T=256 positions 768-1023", dict(B=1, T=256, MAXP=4, lens=[1024]),
                     {}),
                    ("bf16 B=1 T=1024 positions 1024-2047 (no cluster split)",
                     dict(B=1, T=1024, lens=[2048]), {}),
                    ("bf16 D=256 T=64 P=64 softcap=30",
                     dict(B=2, T=64, D=256, P=64, MAXP=16, lens=[900, 371]),
                     {"logit_softcap": 30.0}),
                    ("bf16 G=8 T=16", dict(H=64, T=16, lens=lens), {}),
                    ("bf16 B=1 T=128 prompt 100 (the engine's chunk, cluster split)",
                     dict(B=1, T=128, lens=[100]), {}),
                    ("bf16 B=1 T=64 P=64 scrambled positions swa=300 sinks (cluster split)",
                     dict(B=1, T=64, P=64, MAXP=16, lens=[1000], scramble=True),
                     {"swa_window": 300, "sinks": True})]
    bf16 = torch.bfloat16
    for i, (case, kw, opts) in enumerate(paged_cases):
        args = paged_inputs(torch, seed=500 + i, **kw)
        if opts.pop("sinks", False):
            opts["sinks"] = torch.randn((args[0].shape[2],), device="cuda")
        q, kp = args[0], args[1]
        before = (paged_flash_attention.launches, paged_flash_attention.launches_tc)
        got = paged_flash_attention(*args, **opts)
        tc = paged_flash_attention.launches_tc - before[1]
        # bf16 q over bf16 pages at T*G > 32 takes the tensor-core kernel,
        # every other call the decode or the CUDA-core prefill kernel
        want_tc = (q.shape[1] * (q.shape[2] // kp.shape[1]) > 32 and q.dtype == bf16
                   and kp.dtype == bf16)
        check((tc, paged_flash_attention.launches - before[0]) == ((1, 0) if want_tc else (0, 1)),
              f"paged {case}: the call took the wrong kernel")
        again = paged_flash_attention(*args, **opts)
        ref = paged_flash_attention_plain(*args, **opts)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"paged {case}: two calls differ")
        record("paged_tc" if tc else "paged", case, got, ref, q.dtype, mask=args[3] >= 0)


# (M, K, N) of the probe checks: ffn_gate/up, ffn_down, wq/wo at one row,
# wk/wv, and an N that is not a multiple of the TPU's 512-column tile
PROBE_SHAPES = [(8, 4096, 14336), (8, 14336, 4096), (1, 4096, 4096), (8, 4096, 1024),
                (3, 4096, 1000)]


def check_probe_kernels(torch, record) -> None:
    """The four qmv-probe variants against their plain versions and against
    qmv on the same x (f32 and bf16 activations), in f32: the integer group
    dots are exact and both sides quantize x alike, so only the f32 sums'
    order (and qmv's association ig·(sx·s) against (ig·s)·sx) differs:
    NMSE < 1e-10."""
    from superllama_tpu_torch.ops.qmatmul import qmv
    from superllama_tpu_torch.tools.qmv_probe import VARIANTS, qmv_variant, qmv_variant_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    for i, (M, K, N) in enumerate(PROBE_SHAPES):
        qt = rand_weight(torch, "Q4_K", N, K, 600 + i)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            mv = qmv(x, qt, torch.float32)
            for v in VARIANTS:
                got = qmv_variant(x, qt, v)
                ref = qmv_variant_plain(x, qt, v)
                torch.cuda.synchronize()
                case = f"M={M} K={K} N={N} x {str(dt)[6:]}"
                record(f"qmv_probe_{v}", f"{case} vs plain", got, ref, torch.float32, tol=1e-10)
                record(f"qmv_probe_{v}", f"{case} vs qmv", got, mv, torch.float32, tol=1e-10)


def check_qmv_plans(torch) -> None:
    """qmv_plan counts rounds of resident blocks with a table of the H100's
    cluster residency: at every (K, N) of a decode step and each format,
    the card holds at least the blocks the plan assumes for its cluster
    size (cudaOccupancyMaxActiveClusters), at 8 and at 16 rows, so no grid
    takes more rounds than planned (a grid of at most that many blocks, one
    round). Prints the card's count for each cluster size beside the
    table."""
    import ctypes

    from superllama_tpu_torch.ops import _build
    from superllama_tpu_torch.ops import qmatmul as qm

    fn = _build.load("qmv").slt_qmv_resident
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    emit({"phase": "qmv_resident", "card": {cl: fn(1, 128, 8, cl) for cl in range(1, 9)},
          "plan_assumes": qm._QMV_CLUSTER_RESIDENT})
    for fmt in range(len(qm._QMV_UNIT)):
        for K, N in KN_8B + KN_1B:
            p = qm.qmv_plan(fmt, K, N)
            per_sm = min(qm._QMV_BLOCKS_SM, qm._QMV_SM_SMEM // (p.smem + 1024))
            assumed = qm._QMV_CLUSTER_RESIDENT[p.cl] * per_sm // qm._QMV_BLOCKS_SM
            for rows in (8, 16):
                r = fn(fmt, p.bn, rows, p.cl)
                check(r >= assumed, f"qmv fmt {fmt} K={K} N={N} rows {rows}: {p} assumes "
                      f"{assumed} blocks resident, the card holds {r}")


def check_qmv_rows(torch) -> None:
    """qmv's sums run in an order fixed by (fmt, K, N): at every (K, N) of
    a decode step of the 8B and of the 1B draft (Q4_K, bf16 x), row 0 of an
    M 8 and an M 16 call equals the same row alone at M 1, bit for bit."""
    from superllama_tpu_torch.ops.qmatmul import qmv

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 20)
    bf16 = torch.bfloat16
    for i, (K, N) in enumerate(KN_8B + KN_1B):
        qt = rand_weight(torch, "Q4_K", N, K, 300 + i)
        x = torch.randn((16, K), generator=gen, device="cuda").to(bf16)
        alone = qmv(x[:1], qt, bf16)
        for M in (8, 16):
            got = qmv(x[:M], qt, bf16)
            torch.cuda.synchronize()
            check(torch.equal(got[0], alone[0]),
                  f"qmv K={K} N={N}: row 0 of an M {M} call differs from the row alone")
        del qt


def phase_kernels(torch) -> list:
    from superllama_tpu_torch.ops.flash_attention import (flash_attention,
                                                          flash_attention_plain)
    from superllama_tpu_torch.ops.qmatmul import qmm, qmm_plain, qmv, qmv_plain

    # parity phases compare full-precision f32 products: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    # bf16 outputs: kernel and plain version sum the same exact terms in
    # another order, so the f32 sums differ in the last bits and a few
    # outputs round to the neighbouring bf16 value (relative step 2^-8).
    # fa in bf16, and with Q8_0 K/V in any type, also rounds p to bf16
    # before P.V: the kernel rounds p relative to each tile's running max,
    # the plain version relative to the row's final max, a relative 2^-9
    # difference on every probability. Those cases sit closest to the bf16
    # limit (NMSE up to 4.8e-6 on an H100) and are held to it all the same
    # fd in q8 and q4 modes: exp differs by an ulp between the kernel and
    # torch, which can move one int8 p code (q8) or one bf16 rounding of p
    # (q4) by a step, about 1/127 resp. 2^-8 of one term; those modes are
    # held to the bf16 limit in any query type
    TOL = {bf16: 1e-5, f32: 1e-9}
    rows = []

    def record(kernel, case, got, ref, dtype, mask=None, p_bf16=False, tol=None):
        g, r = got.float(), ref.float()
        if mask is not None:
            g, r = g[mask], r[mask]
        err = float((g - r).abs().max())
        e = nmse(g, r)
        if tol is None:
            tol = TOL[bf16] if p_bf16 else TOL[dtype]
        ok = bool(torch.isfinite(got.float()).all()) and e < tol
        rows.append({"kernel": kernel, "case": case, "max_abs_err": err,
                     "nmse": e, "tol": tol, "ok": ok})
        if not ok:
            dump()
        check(ok, f"{kernel} {case}: nmse {e:g} (tol {tol:g}), max err {err:g}")

    def dump():
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "kernel_checks.json"), "w") as f:
            json.dump(rows, f, indent=1)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    seed = 0
    mv_cases = [("Q4_K", M, K, N, bf16) for M in (1, 8, 16) for K, N in KN_8B]
    mv_cases += [("Q4_K", M, K, N, bf16) for M in (1, 4, 8) for K, N in KN_1B]
    mv_cases += [("Q6_K", 8, 4096, 14336, bf16), ("Q8_0", 8, 4096, 14336, bf16),
                 ("Q4_K", 8, 4096, 14336, f32)]
    mm_cases = [("Q4_K", M, K, N, bf16) for M in (1, 8, 17, 24, 32) for K, N in KN_8B]
    mm_cases += [("Q4_K", M, K, N, bf16) for M in (24, 32) for K, N in KN_1B]
    mm_cases += [("Q6_K", 32, 4096, 14336, bf16), ("Q8_0", 32, 4096, 14336, bf16),
                 ("Q4_K", 32, 4096, 4096, f32)]
    # the edges at small shapes, in f32: every row-count instantiation of
    # qmv, partial column tiles, K of 17 groups, qmm row tiles past 32
    for kind in ("Q4_K", "Q6_K", "Q8_0"):
        for M, K, N in EDGE_SHAPES:
            if K % (32 if kind == "Q8_0" else 256):
                continue
            if M <= 16:
                mv_cases.append((kind, M, K, N, f32))
            # qmm: the CUDA-core kernel (f32 x) and the tensor-core one (bf16)
            mm_cases += [(kind, M, K, N, f32), (kind, M, K, N, bf16)]
    weights = {}
    for kernel, cases, fn, plain in (("qmv", mv_cases, qmv, qmv_plain),
                                     ("qmm", mm_cases, qmm, qmm_plain)):
        for kind, M, K, N, dt in cases:
            key = (kind, K, N)
            if key not in weights:
                seed += 1
                weights[key] = rand_weight(torch, kind, N, K, seed)
            qt = weights[key]
            x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            got = fn(x, qt, dt)
            ref = plain(x, qt, dt)
            case = f"{kind} M={M} K={K} N={N} {str(dt)[6:]}"
            # a fixed summation order: two calls, the same bits
            again = fn(x, qt, dt)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{kernel} {case}: two calls differ")
            torch.cuda.synchronize()
            record(kernel, case, got, ref, dt)
    weights.clear()
    check_qmv_rows(torch)
    check_qmv_plans(torch)
    check_format_kernels(torch, record)
    check_one_kernel_a_call(torch)
    check_qmm_resident(torch)

    fa_cases = [("T=32 bf16", dict(T=32)), ("T=128 bf16", dict(T=128)),
                ("T=32 f32", dict(T=32, dtype="f32")),
                ("T=128 q8_0 kv", dict(T=128, q8=True)),
                ("T=128 swa=256", dict(T=128, swa=256)),
                ("T=32 softcap=50", dict(T=32, softcap=50.0)),
                ("T=128 sinks", dict(T=128, sinks=True)),
                ("B=8 T=128 mixed lens", dict(B=8, T=128, n_past=0,
                                              lens=[100, 32] * 4))]
    for T, S, G, swa, cap, sinks, q8 in FA_EDGE_CELLS:
        fa_cases.append((f"f32 T={T} S={S} G={G} swa={swa} softcap={cap} sinks={sinks} q8={q8}",
                         dict(B=2, T=T, S=S, n_past=max(S - T - 3, 0), H=2 * G, Hkv=2,
                              D=64, dtype="f32", q8=q8, sinks=sinks, swa=swa, softcap=cap)))
    fa_cases.append(("f32 T=40 S=64 G=2 D=16", dict(T=40, S=64, n_past=0, H=4, Hkv=2, D=16,
                                                     dtype="f32")))
    # head sizes outside 16/32/64/128: Dv padded to the next instantiation
    fa_cases += [(f"D={D} T=48 S=512 {name}", dict(B=2, T=48, S=512, n_past=300, D=D, **kw))
                 for D in HEAD_SIZES
                 for name, kw in (("bf16", {}), ("f32", {"dtype": "f32"}),
                                  ("q8_0 kv", {"q8": True}))]
    # the tensor-core kernel's own cases: a long prompt chunk, positions in
    # no order with holes (with and without a window), row tiles of padding
    # only, G 1 / 4 / 8, D 256
    fa_cases += [("T=1024 S=2048 bf16", dict(T=1024, n_past=0)),
                 ("T=1024 S=2048 q8_0 kv", dict(T=1024, n_past=0, q8=True)),
                 ("T=128 scrambled kv_pos", dict(B=2, T=128, n_past=900, scramble=True)),
                 ("T=128 scrambled kv_pos swa=300", dict(B=2, T=128, n_past=900,
                                                         scramble=True, swa=300)),
                 ("T=128 q8_0 scrambled swa=300 sinks", dict(B=2, T=128, n_past=900, q8=True,
                                                             scramble=True, swa=300,
                                                             sinks=True)),
                 ("B=3 T=128 padding-only row tiles", dict(B=3, T=128, n_past=40,
                                                           lens=[8, 128, 50])),
                 ("G=1 T=64 bf16", dict(T=64, H=8)), ("G=4 T=64 bf16", dict(T=64)),
                 ("G=8 T=64 bf16", dict(T=64, H=64)),
                 ("G=8 T=64 q8_0 kv softcap=30", dict(T=64, H=64, q8=True, softcap=30.0)),
                 ("D=256 T=256 S=1024 bf16", dict(T=256, S=1024, n_past=300, D=256)),
                 ("D=256 T=256 S=1024 q8_0 kv", dict(T=256, S=1024, n_past=300, D=256,
                                                      q8=True))]
    # the iSWA ring of Command-R7B's SWA tier (4,352 slots: its 4,096-token
    # window and a 256-token ubatch; its heads, D 128) after a wrap, slot p %
    # S holding position p: the prompt's last chunks past 4,352 and a second
    # row wrapped twice. bf16 only: the iSWA cache refuses a quantized one
    # (make_cache), so no Q8_0 K/V reaches fa over a ring
    fa_cases += [(f"iSWA ring S=4352 T={T} swa=4096 wrapped at {ends}",
                  dict(B=len(ends), T=T, S=4352, ring_end=ends, swa=4096))
                 for T, ends in ((32, [4600]), (256, [4600]), (256, [4568, 9000]))]
    # the 1B draft's prompt start (head size 64, G 4): a 100-token prompt's
    # one-row chunk on a bf16 and on a Q8_0 draft cache
    fa_cases += [(f"D=64 T=128 prompt 100 {name} (the 1B draft's prompt chunk)",
                  dict(T=128, D=64, n_past=0, lens=[100], **kw))
                 for name, kw in (("bf16", {}), ("q8_0 kv", {"q8": True}))]
    for i, (case, kw) in enumerate(fa_cases):
        kw = dict(kw)
        swa, cap = kw.pop("swa", 0), kw.pop("softcap", 0.0)
        args, extra = fa_inputs(torch, seed=100 + i, **kw)
        before = (flash_attention.launches, flash_attention.launches_tc)
        got = flash_attention(*args, swa_window=swa, logit_softcap=cap, **extra)
        tc = flash_attention.launches_tc - before[1]
        # bf16 q takes the tensor-core kernel, f32 q the CUDA-core one
        check((tc, flash_attention.launches - before[0]) == ((1, 0) if args[0].dtype == bf16
                                                             else (0, 1)),
              f"fa {case}: {args[0].dtype} q took the wrong kernel")
        if tc:   # a fixed summation order: two calls, the same bits
            again = flash_attention(*args, swa_window=swa, logit_softcap=cap, **extra)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"fa {case}: two calls differ")
        ref = flash_attention_plain(*args, swa_window=swa, logit_softcap=cap, **extra)
        torch.cuda.synchronize()
        record("fa_tc" if tc else "fa", case, got, ref, args[0].dtype, mask=args[3] >= 0,
               p_bf16=kw.get("q8", False))
    # bf16 q over an f32 cache (the JAX package's P.V in f32): the CUDA-core
    # kernel
    args, _ = fa_inputs(torch, T=128, dtype="f32", seed=199)
    args = (args[0].to(bf16),) + args[1:]
    before = (flash_attention.launches, flash_attention.launches_tc)
    got = flash_attention(*args)
    check((flash_attention.launches - before[0], flash_attention.launches_tc - before[1])
          == (1, 0), "fa: bf16 q over f32 K/V did not take the CUDA-core kernel")
    ref = flash_attention_plain(*args)
    torch.cuda.synchronize()
    record("fa", "T=128 bf16 q, f32 kv", got, ref, bf16, mask=args[3] >= 0)

    try:
        check_decode_kernels(torch, record)
        check_probe_kernels(torch, record)
    finally:
        dump()
    worst = {}
    for r in rows:
        w = worst.get(r["kernel"])
        if w is None or r["nmse"] / r["tol"] > w["nmse"] / w["tol"]:
            worst[r["kernel"]] = r
    emit({"phase": "kernels", "n_checks": len(rows), "all_ok": all(r["ok"] for r in rows),
          "closest_to_tolerance": worst})
    return rows


# ------------------------------------------------------------ 4. serving


def counters() -> dict:
    """kernel -> (wrapper, its count attribute): fa's and paged's wrappers
    count their tensor-core kernels in ``launches_tc``, the others in
    ``launches``."""
    from superllama_tpu_torch.ops import flash_attention as fa_mod
    from superllama_tpu_torch.ops import grouped_matmul as gm_mod
    from superllama_tpu_torch.ops import paged_attention as pa_mod
    from superllama_tpu_torch.ops import qmatmul as qm_mod

    try:                    # (an unpacked parent tree may predate the scan)
        from superllama_tpu_torch.ops.ssm_scan import ssm_scan
        scan = {"ssm_scan": (ssm_scan, "launches")}
    except ImportError:
        scan = {}
    try:                    # (or the wkv recurrences)
        from superllama_tpu_torch.ops import wkv
        scan.update({rule: (getattr(wkv, rule), "launches")
                     for rule in ("wkv6", "gla", "wkv7", "delta_net")})
    except ImportError:
        pass
    fa = fa_mod.flash_attention
    fams = {f"{k}_{f}": (getattr(qm_mod, k), f"launches_{f}") for k in ("qmv", "qmm")
            for f in qm_mod._FAMILY.values()}
    return {"qmv": (qm_mod.qmv, "launches"), "qmm": (qm_mod.qmm, "launches"), **fams,
            "fa": (fa, "launches"), "fa_tc": (fa, "launches_tc"),
            "fd": (fa_mod.flash_decode_attention, "launches"),
            "paged": (pa_mod.paged_flash_attention, "launches"),
            "paged_tc": (pa_mod.paged_flash_attention, "launches_tc"),
            "gmm": (gm_mod.grouped_matmul, "launches"), **scan}


def reset_counts() -> None:
    from superllama_tpu_torch.tools.qmv_probe import qmv_variant

    for fn, attr in counters().values():
        if hasattr(fn, attr):
            setattr(fn, attr, 0)
    for v in qmv_variant.launches:
        qmv_variant.launches[v] = 0


def read_counts() -> dict:
    from superllama_tpu_torch.tools.qmv_probe import qmv_variant

    # (an unpacked parent tree, read with --kernel-times, may predate a count)
    counts = {name: getattr(fn, attr, 0) for name, (fn, attr) in counters().items()}
    counts.update({f"qmv_probe_{v}": n for v, n in qmv_variant.launches.items()})
    return counts


def build_model(torch, mix: str = "Q4_K", n_layer: int = 32):
    """The synthetic Llama-3-8B-width model (n_layer deep), its weights of a
    ``MIXES`` entry in repack's layout (default every matmul weight Q4_K)
    generated on the card."""
    from superllama_tpu_torch.models.loader import LoadedModel
    from superllama_tpu_torch.models.synthetic import (llama3_8b_hparams,
                                                       synthetic_qparams_device,
                                                       synthetic_qparams_mix)

    hp = llama3_8b_hparams(n_layer=n_layer)
    t0 = time.perf_counter()
    params = (synthetic_qparams_device(hp, seed=SEED, device="cuda") if mix == "Q4_K" else
              synthetic_qparams_mix(hp, mix, seed=SEED, device="cuda"))
    torch.cuda.synchronize()
    qbytes = sum(w.nbytes for layer in params["layers"] for w in layer.values()
                 if hasattr(w, "planes")) + params["output"].nbytes
    key = "q4k_weight_bytes" if mix == "Q4_K" else "weight_bytes"
    emit({"phase": "model", "arch": hp.arch, "mix": mix, "n_layer": hp.n_layer,
          "n_embd": hp.n_embd, "n_vocab": hp.n_vocab, key: qbytes,
          "seconds": time.perf_counter() - t0})
    return LoadedModel(hp, params, tokenizer=None, metadata={},
                       name=f"synthetic-llama3-8b-{mix.lower()}")


def token_prompts(n_vocab: int, lens, seed: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_vocab, n).tolist() for n in lens]


def http(port: int, path: str, body: dict, timeout: float = 600.0):
    import urllib.request

    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                               data=json.dumps(body).encode(), method="POST",
                               headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return resp.status, resp.read()


def fresh(eng) -> None:
    """Empty every slot's cache row, so that the next requests prefill their
    whole prompts: the engine serves a prompt that repeats what a slot holds
    from that slot's cache (prefix reuse), and a phase that repeats prompts
    to compare or time their prefill means a prefill from scratch. (An
    unpacked parent tree's engine keeps nothing between requests.) Waits
    for the step in progress; every slot must be idle."""
    if hasattr(eng, "slot_erase"):
        with eng._step_lock:
            for s in eng.slots:
                eng.slot_erase(s.idx)


def in_one_wave(engine, submit_all, n: int) -> None:
    """Hold the engine between steps while n requests arrive, so they are
    admitted together and prefill in one wave: the same batch every time,
    hence the same arithmetic for the same prompts."""
    with engine._step_lock:
        submit_all()
        deadline = time.time() + 120
        while engine._queue.qsize() < n:
            check(time.time() < deadline, "requests did not reach the engine")
            time.sleep(0.01)


def engine_wave(engine, prompts, max_tokens: int, samplings=None) -> list[dict]:
    """The prompts submitted together, greedy unless ``samplings`` gives each
    request's sampling config."""
    from superllama_tpu_torch.runtime.engine import GenRequest

    samplings = samplings or [{"greedy": True}] * len(prompts)
    reqs = []
    in_one_wave(engine, lambda: reqs.extend(
        engine.submit(GenRequest(prompt_ids=p, max_tokens=max_tokens, sampling=sm,
                                 stop_eog=False))
        for p, sm in zip(prompts, samplings)), len(prompts))
    return [r.result(timeout=600) for r in reqs]


# the sampled waves' request settings (OpenAI completion fields): one seed a
# request, the last two with repeat penalty 1.1
SAMPLED_BODY = {"temperature": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05}


def sampled_bodies(n: int) -> list[dict]:
    return [{**SAMPLED_BODY, "seed": 1000 + i,
             **({"repeat_penalty": 1.1} if i >= n - 2 else {})} for i in range(n)]


def sampled_configs(n: int) -> list[dict]:
    """The engine's sampling configs of sampled_bodies, as the server builds them."""
    from superllama_tpu_torch.server.http import ServerApp

    return [ServerApp._sampling_from(b) for b in sampled_bodies(n)]


def graph_stats(eng, kind: str) -> dict:
    """GraphCache's counts of one kind of key ("block" or "chunk"); an
    unpacked parent tree's cache counted blocks alone, in one dict."""
    g = eng._graphs.stats if eng._graphs is not None else {}
    if "block" not in g:
        g = {"block": g, "chunk": {}}
    return g[kind]


def block_stats(eng) -> dict:
    """The engine's decode blocks and prompt chunks so far, and how many of
    each were graph replays (blocks' keys "replays", "captures",
    "capture_s"; chunks' the same keys prefixed "chunk_")."""
    b, c = graph_stats(eng, "block"), graph_stats(eng, "chunk")
    return {"blocks": eng.stats["blocks"], "chained": eng.stats["chained"],
            "replays": b.get("replays", 0), "captures": b.get("captures", 0),
            "capture_s": b.get("capture_s", 0.0), "chunks": eng.stats.get("chunks", 0),
            "chunk_replays": c.get("replays", 0), "chunk_captures": c.get("captures", 0),
            "chunk_capture_s": c.get("capture_s", 0.0)}


def check_replayed(label: str, before: dict, after: dict) -> dict:
    """Every decode block and every prompt chunk between two block_stats
    readings was a replay."""
    d = {k: after[k] - before[k] for k in after}
    check(d["blocks"] > 0 and d["replays"] == d["blocks"],
          f"{label}: {d['blocks']} decode blocks, {d['replays']} of them graph replays")
    check(d["chunks"] > 0 and d["chunk_replays"] == d["chunks"],
          f"{label}: {d['chunks']} prompt chunks, {d['chunk_replays']} of them graph replays")
    return d


def serve_wave(torch, model, label: str, lens, expect, **app_kw) -> tuple[dict, list]:
    """8 concurrent completions and one streamed one over HTTP; the served
    tokens must equal the engine's own wave of the same prompts, and every
    kernel in ``expect`` must have launched. The server warms its engine up
    first (``serve``'s default; ``warmup=False`` skips it), and after a
    warm-up no capture may happen while it serves. Returns (launch counts,
    served tokens)."""
    import gc

    from superllama_tpu_torch.server.http import Server, ServerApp

    app = ServerApp(model, n_slots=8, n_ctx=2048, model_name=model.name, device="cuda",
                    **app_kw)
    srv = Server(app, host="127.0.0.1", port=0)
    srv.start()
    eng = app.engine
    warm = app.warmup_info
    if warm is not None:
        emit({"phase": "warmup", "kv": label, "keys": len(warm["keys"]),
              "seconds": warm["seconds"], "capture_s": sum(warm["capture_s"]),
              "pool_bytes": warm["pool_bytes"]})
    try:
        prompts = token_prompts(model.hparams.n_vocab, lens, SEED + 1)
        body = lambda p, **kw: {"prompt": p, "max_tokens": 64, "temperature": 0,
                                "return_tokens": True, **kw}
        results: list = [None] * len(prompts)

        def send(i):
            results[i] = http(srv.port, "/v1/completions", body(prompts[i]))

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(prompts))]
        stats0 = block_stats(eng)
        reset_counts()
        t0 = time.perf_counter()
        in_one_wave(eng, lambda: [t.start() for t in threads], len(prompts))
        for t in threads:
            t.join(timeout=900)
        t_batch = time.perf_counter() - t0
        stream_prompt = token_prompts(model.hparams.n_vocab, [32], SEED + 2)[0]
        status, raw = http(srv.port, "/v1/completions", body(stream_prompt, stream=True))
        counts = read_counts()

        served = []
        for i, (st, data) in enumerate(results):
            out = json.loads(data)
            ch = out["choices"][0]
            check(st == 200, f"{label} request {i}: HTTP {st}")
            check(ch["finish_reason"] == "length", f"{label} request {i}: {ch['finish_reason']}")
            check(out["usage"]["completion_tokens"] == 64,
                  f"{label} request {i}: usage {out['usage']}")
            served.append(ch["tokens"])
        events = [ln[6:] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
        check(status == 200 and events[-1] == "[DONE]", f"{label}: stream did not end with [DONE]")
        chunks = [json.loads(e) for e in events[:-1]]
        final = chunks[-1]
        streamed = [c["choices"][0]["token"] for c in chunks[:-1]]
        check(final["choices"][0]["finish_reason"] == "length", f"{label} stream: {final}")
        check(final["usage"]["completion_tokens"] == 64 and len(streamed) == 64,
              f"{label} stream: {len(streamed)} tokens, usage {final['usage']}")
        for name in expect:
            check(counts[name] > 0, f"the {label} serving path never launched the {name} kernel")
        if "fa_tc" in expect:
            check(counts["fa"] == 0, f"the {label} serving path launched the CUDA-core fa "
                  f"kernel {counts['fa']} times")

        # the same prompts straight through the engine, batched the same way
        fresh(eng)
        direct = [r["tokens"] for r in engine_wave(eng, prompts, 64)]
        check(direct == served, f"{label}: served tokens differ from the engine's for the same wave")
        fresh(eng)
        alone = eng.generate(stream_prompt, max_tokens=64, sampling={"greedy": True},
                             stop_eog=False)["tokens"]
        check(alone == streamed, f"{label}: streamed tokens differ from engine.generate")
        greedy_blocks = check_replayed(f"{label} greedy waves", stats0, block_stats(eng))
        sampled = sampled_wave(eng, srv.port, label, prompts, expect)
        info = {"phase": "serving", "kv": label, "requests": len(prompts) + 1,
                "batch_wall_s": t_batch, "launches": counts,
                "served_equal_engine": True, "stream_equal_generate": True,
                "greedy_blocks": greedy_blocks, "sampled": sampled,
                "graph_pool_bytes": eng._graphs.pool_bytes(),
                "ttft_s": [json.loads(d)["timings"]["ttft_s"] for _, d in results]}
        if eng.paged:
            info["paged_stats"] = dict(eng.pkv.stats)
        if warm is not None:
            after = block_stats(eng)
            check(after["captures"] == stats0["captures"]
                  and after["chunk_captures"] == stats0["chunk_captures"],
                  f"{label}: a graph was captured while serving after the warm-up: {after}")
    finally:
        srv.stop()
        del app, srv, eng     # the graphs' pool goes back to the card
        gc.collect()
        torch.cuda.empty_cache()
    emit(info)
    return counts, served


def sampled_wave(eng, port: int, label: str, prompts, expect) -> dict:
    """The prompts again over HTTP, sampled (sampled_bodies), in one wave:
    every decode block a graph replay through the device sampler chain; the
    served tokens must equal the engine's own wave of the same requests,
    and a second HTTP wave must repeat them."""
    bodies = sampled_bodies(len(prompts))

    def wave() -> list:
        fresh(eng)
        results: list = [None] * len(prompts)

        def send(i):
            results[i] = http(port, "/v1/completions",
                              {"prompt": prompts[i], "max_tokens": 64, "return_tokens": True,
                               **bodies[i]})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(prompts))]
        in_one_wave(eng, lambda: [t.start() for t in threads], len(prompts))
        for t in threads:
            t.join(timeout=900)
        out = []
        for i, (st, data) in enumerate(results):
            ch = json.loads(data)["choices"][0]
            check(st == 200 and ch["finish_reason"] == "length" and len(ch["tokens"]) == 64,
                  f"{label} sampled request {i}: HTTP {st}, {ch['finish_reason']}")
            out.append(ch["tokens"])
        return out

    stats0 = block_stats(eng)
    reset_counts()
    t0 = time.perf_counter()
    served = wave()
    t_wave = time.perf_counter() - t0
    counts = read_counts()
    blocks = check_replayed(f"{label} sampled wave", stats0, block_stats(eng))
    for name in expect:
        if name.startswith("qmm"):   # a wave's prompt chunks take the M > 32 path
            continue
        check(counts[name] > 0, f"the {label} sampled wave never launched the {name} kernel")
    fresh(eng)
    direct = [r["tokens"] for r in engine_wave(eng, prompts, 64, sampled_configs(len(prompts)))]
    check(direct == served, f"{label}: sampled served tokens differ from the engine's")
    again = wave()
    check(again == served, f"{label}: a repeat of the sampled wave gave other tokens")
    check(len({tuple(t) for t in served}) == len(served), f"{label}: sampled rows coincide")
    return {"wall_s": t_wave, "launches": counts, "blocks": blocks,
            "served_equal_engine": True, "repeat_equal": True}


def phase_serving(torch, model) -> dict:
    counts, _ = serve_wave(torch, model, "bf16", [32, 100] * 4, ("qmv", "qmm", "fa_tc"),
                           kv_dtype=torch.bfloat16)
    return counts


def phase_serving_q8(torch, model) -> dict:
    """The bf16 phase's wave on a Q8_0 cache: prefill feeds codes to fa's
    tensor-core kernel, every decode step runs fd."""
    counts, _ = serve_wave(torch, model, "q8_0", [32, 100] * 4,
                           ("qmv", "qmm", "fa_tc", "fd"), kv_dtype="q8_0")
    return counts


def phase_serving_f32(torch, model) -> dict:
    """The same prompts on an f32 cache (``--kv-dtype float32``), straight
    through the engine, 4 tokens each: bf16 q over f32 K/V is the JAX
    package's P.V in f32, so prefill takes fa's CUDA-core kernel."""
    from superllama_tpu_torch.runtime.engine import Engine

    eng = Engine(model, n_slots=8, n_ctx=2048, kv_dtype=torch.float32, device="cuda")
    eng.start()
    try:
        prompts = token_prompts(model.hparams.n_vocab, [32, 100] * 4, SEED + 1)
        reset_counts()
        rs = engine_wave(eng, prompts, 4)
        counts = read_counts()
    finally:
        eng.stop()
    emit({"phase": "serving", "kv": "float32 (engine)", "launches": counts,
          "tokens": [len(r["tokens"]) for r in rs]})
    check(all(len(r["tokens"]) == 4 for r in rs), "the f32-cache wave did not finish")
    check(counts["fa"] > 0 and counts["fa_tc"] == 0,
          f"the f32-cache prefill did not take fa's CUDA-core kernel: {counts}")
    return counts


# Prompts of one 32-token prefill bucket under either page size, with
# lengths that are multiples of the 8-token decode block: a block that does
# not fit its page's tail opens a new page and leaves a gap, which regroups
# positions into the paged kernel's 64-slot tiles (as the TPU kernel's
# 4-page chunks), changing sums and bf16 roundings. With these lengths the
# 64- and 256-token pages lay every position out in the same tile.
PAGED_LENS = [32, 24] * 4


def phase_serving_paged(torch, model) -> dict:
    """The paged cache: a wave with 256-token pages and an ample pool (each
    prompt chunk through paged's tensor-core prefill kernel, each decode
    step through its decode kernel), then the same prompts with 64-token
    pages and a pool of 8 pages (+ NULL) against the 16 the wave needs, so
    pages spill to host and come back; its tokens must equal the ample
    pool's."""
    from superllama_tpu_torch.runtime.engine import Engine

    counts, served = serve_wave(torch, model, "paged", PAGED_LENS, ("qmv", "paged", "paged_tc"),
                                kv_dtype=torch.bfloat16, paged=True, page_size=256)
    eng = Engine(model, n_slots=8, n_ctx=2048, kv_dtype=torch.bfloat16, device="cuda",
                 paged=True, page_size=64, n_pages=9)
    eng.start()
    try:
        prompts = token_prompts(model.hparams.n_vocab, PAGED_LENS, SEED + 1)
        spilled = [r["tokens"] for r in engine_wave(eng, prompts, 64)]
    finally:
        eng.stop()
    stats = dict(eng.pkv.stats)
    emit({"phase": "serving", "kv": "paged, 64-token pages, 8-page pool",
          "paged_stats": stats, "equal_ample_pool": spilled == served})
    check(spilled == served, "the spilling paged run's tokens differ from the ample pool's")
    check(stats["evictions"] > 0 and stats["restores"] > 0, f"no spill: {stats}")
    return counts


def cache_rows(eng) -> dict:
    """A copy of the engine's cache: its positions and the written rows
    (slots that hold a position) of every tensor. Taken under the engine's
    step lock: a request's result is set inside the step that emits its
    last token, and that step goes on to land the block in flight and roll
    the cache back, so the cache is only settled once the step ends."""
    import torch

    with eng._step_lock:
        torch.cuda.synchronize()
        return _cache_rows(eng)


def _cache_rows(eng) -> dict:
    if eng.paged:
        c = eng.pkv.cache
        m = c.page_pos >= 0
        return {"page_pos": c.page_pos.clone(), "table": c.table.clone(),
                "k": c.k_pages.permute(1, 3, 0, 2, 4)[m], "v": c.v_pages.permute(1, 3, 0, 2, 4)[m]}
    if getattr(eng, "iswa", False):    # each tier's rows, keyed by tier
        return {f"{tier}_{k}": v for tier in ("full", "swa")
                for k, v in _kv_rows(getattr(eng.cache, tier)).items()}
    kind = getattr(eng, "kind", "dense")
    if kind != "dense":                 # every row's whole state (and KV rows)
        rec = eng.cache.rec if kind == "hybrid" else eng.cache
        rows = {f: getattr(rec, f).clone() for f in rec.FIELDS}
        if kind == "hybrid":
            rows.update({f"attn_{k}": v for k, v in _kv_rows(eng.cache.attn).items()})
        return rows
    return _kv_rows(eng.cache)


def _kv_rows(c) -> dict:
    m = c.pos >= 0
    rows = {"pos": c.pos.clone(), "cursor": c.cursor.clone(),
            "k": c.k.permute(1, 3, 0, 2, 4)[m], "v": c.v.permute(1, 3, 0, 2, 4)[m]}
    if c.quantized:
        rows["k_scale"] = c.k_scale.permute(1, 3, 0, 2)[m]
        rows["v_scale"] = c.v_scale.permute(1, 3, 0, 2)[m]
    return rows


GRAPH_CASES = (("bf16", {}, [32, 100] * 4), ("q8_0", {"kv_dtype": "q8_0"}, [32, 100] * 4),
               ("paged", {"paged": True, "page_size": 256}, PAGED_LENS))


def phase_graph_vs_eager(torch, model, cases=GRAPH_CASES,
                         modes=("greedy", "sampled", "lone"), n_ctx: int = 2048,
                         max_tokens: int = 40) -> list:
    """Decode blocks and prompt chunks replayed from CUDA graphs against the
    same blocks and chunks run eagerly, on each cache, greedy and sampled:
    two engines (graphs on and off) serve the same two waves of 8 requests
    x 40 tokens (a warm one, then the measured one, whose last block stops
    mid-way and rolls back), then ("lone") a 100-token and a 1000-token
    prompt alone, 8 tokens each, twice (the 1000-token one: a 1024-token
    chunk on a dense cache, four one-row 256-token chunks on the paged one;
    both through the M > 32 path's cuBLAS product). Tokens, the written
    cache rows and the measured run's launch counts must be equal; every
    block and every prompt chunk of the graph engine's measured run a
    replay, none captured. ``cases``, ``modes`` and ``max_tokens`` (the
    waves' tokens a request) narrow it (phases 4l-4o)."""
    import gc

    from superllama_tpu_torch.runtime.engine import Engine

    recs = []
    lone = token_prompts(model.hparams.n_vocab, [100, 1000], SEED + 10)
    for label, kw, lens in cases:
        prompts = token_prompts(model.hparams.n_vocab, lens, SEED + 9)
        engines = {g: Engine(model, n_slots=8, n_ctx=n_ctx, device="cuda", graphs=g,
                             **{"kv_dtype": torch.bfloat16, **kw}) for g in (True, False)}
        for eng in engines.values():
            eng.start()
        try:
            for mode in modes:
                samplings = (sampled_configs(len(prompts)) if mode == "sampled" else None)

                def serve(eng):
                    fresh(eng)
                    if mode == "lone":
                        return [eng.generate(p, max_tokens=8, sampling={"greedy": True},
                                             stop_eog=False)["tokens"] for p in lone]
                    return [r["tokens"] for r in engine_wave(eng, prompts, max_tokens,
                                                             samplings)]

                runs = {}
                for g, eng in engines.items():
                    serve(eng)
                    with eng._step_lock:     # the last step of the warm run has ended
                        stats0 = block_stats(eng)
                        reset_counts()
                    t0 = time.perf_counter()
                    toks = serve(eng)
                    wall = time.perf_counter() - t0
                    with eng._step_lock:     # and the measured run's
                        torch.cuda.synchronize()
                        runs[g] = {"tokens": toks, "wall_s": wall, "launches": read_counts(),
                                   "blocks": {k: v - stats0[k]
                                              for k, v in block_stats(eng).items()}}
                g_run, e_run = runs[True], runs[False]
                rows_g, rows_e = cache_rows(engines[True]), cache_rows(engines[False])
                rows_equal = {k: bool(torch.equal(rows_g[k], rows_e[k])) for k in rows_g}
                rec = {"phase": "graph_vs_eager", "kv": label, "mode": mode,
                       "iswa": engines[True].iswa,
                       "graph_wall_s": g_run["wall_s"], "eager_wall_s": e_run["wall_s"],
                       "graph_blocks": g_run["blocks"], "eager_blocks": e_run["blocks"],
                       "tokens_equal": g_run["tokens"] == e_run["tokens"],
                       "launches_equal": g_run["launches"] == e_run["launches"],
                       "launches": g_run["launches"], "rows_equal": rows_equal}
                emit(rec)
                recs.append(rec)
                check(rec["tokens_equal"],
                      f"{label} {mode}: the graph engine's tokens differ from eager")
                check(all(rows_equal.values()),
                      f"{label} {mode}: the graph engine's cache rows differ from eager: "
                      f"{rows_equal}")
                check(rec["launches_equal"], f"{label} {mode}: launch counts differ: graph "
                      f"{g_run['launches']}, eager {e_run['launches']}")
                gb = g_run["blocks"]
                check(gb["blocks"] > 0 and gb["replays"] == gb["blocks"] and gb["captures"] == 0,
                      f"{label} {mode}: graph engine blocks {gb}")
                check(gb["chunks"] > 0 and gb["chunk_replays"] == gb["chunks"]
                      and gb["chunk_captures"] == 0, f"{label} {mode}: graph engine chunks {gb}")
                check(e_run["blocks"]["replays"] == 0 and e_run["blocks"]["chunk_replays"] == 0,
                      f"{label} {mode}: eager engine replayed")
                if (not engines[True].paged and mode != "lone"
                        and getattr(engines[True], "kind", "dense") == "dense"):
                    check(gb["chained"] > 0, f"{label} {mode}: no block was chained")
        finally:
            for eng in engines.values():
                eng.stop()
        del engines
        gc.collect()
        torch.cuda.empty_cache()
    return recs


def phase_decode_loop(torch, model) -> dict:
    """DecodeLoop (prefill + one captured graph of n_gen - 1 decode steps)
    against engine.generate on the 8B widths: a 32-token prompt, 48 greedy
    tokens, one slot of 256 positions on both sides (the same shapes, so
    the same kernels and sums). Then a sampled loop twice with one seed."""
    from superllama_tpu_torch.runtime.decode_loop import DecodeLoop
    from superllama_tpu_torch.runtime.engine import Engine

    p = token_prompts(model.hparams.n_vocab, [32], SEED + 8)[0]
    eng = Engine(model, n_slots=1, n_ctx=256, kv_dtype=torch.bfloat16, device="cuda")
    want = eng.generate(p, max_tokens=48, sampling={"greedy": True}, stop_eog=False)["tokens"]
    loop = DecodeLoop(model, n_ctx=256, kv_dtype=torch.bfloat16)
    first = loop.generate(p, 48, stop_eog=False)[32:]
    reset_counts()
    t0 = time.perf_counter()
    got = loop.generate(p, 48, stop_eog=False)[32:]
    wall = time.perf_counter() - t0
    counts = read_counts()
    sampler = DecodeLoop(model, n_ctx=256, kv_dtype=torch.bfloat16, temp=0.8, top_k=40,
                         top_p=0.95, min_p=0.05)
    s1, s2 = (sampler.generate(p, 48, seed=5, stop_eog=False)[32:] for _ in range(2))
    rec = {"phase": "decode_loop", "tokens_equal_engine": got == want == first,
           "wall_s_48_tokens": wall, "tok_s": 48 / wall, "launches": counts,
           "graphs": dict(loop._graphs.stats), "sampled_repeat_equal": s1 == s2}
    emit(rec)
    check(rec["tokens_equal_engine"], "DecodeLoop's tokens differ from engine.generate's")
    steps = graph_stats(loop, "block")
    check(steps["captures"] == 1 and steps["replays"] == 2,
          f"DecodeLoop's decode steps were not one replayed graph: {loop._graphs.stats}")
    per_step = 7 * model.hparams.n_layer + 1          # each layer's matmuls and the head
    check(counts["qmv"] == 47 * per_step and counts["qmm"] == per_step,
          f"DecodeLoop's launches: {counts}")
    check(s1 == s2 and len(set(s1)) > 1, "the sampled DecodeLoop did not repeat itself")
    return rec


# the warm-up phase's prefill buckets: the full set's 2048-token wave and
# lone chunk are left out to bound the phase's time (serving's engines warm
# up on the full set)
WARM_BUCKETS = (32, 128, 1024)


def phase_warmup(torch, model) -> list:
    """Engine.warmup on a bf16 engine and a paged one (256-token pages), 8
    slots, n_ctx 2048, prefill buckets WARM_BUCKETS: the keys it captures,
    each capture's seconds, the graph pool's bytes and the device memory
    reserved before and after; then one request of 32 and one of 1000
    tokens (8 tokens each), whose TTFT it prints: no capture may happen
    after the warm-up, and every key the engine can reach must have been
    captured by it."""
    import gc

    from superllama_tpu_torch.runtime.engine import Engine

    recs = []
    p32, p1000 = token_prompts(model.hparams.n_vocab, [32, 1000], SEED + 11)
    for label, kw in (("bf16", {}), ("paged", {"paged": True, "page_size": 256})):
        eng = Engine(model, n_slots=8, n_ctx=2048, kv_dtype=torch.bfloat16, device="cuda",
                     prefill_buckets=WARM_BUCKETS, **kw)
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved()
        info = eng.warmup()
        torch.cuda.synchronize()
        stats0 = block_stats(eng)
        ttft = {n: eng.generate(p, max_tokens=8, sampling={"greedy": True},
                                stop_eog=False)["ttft_s"] * 1e3
                for n, p in ((32, p32), (1000, p1000))}
        after = block_stats(eng)
        want = {key for key, *_ in eng._graph_targets()}
        rec = {"phase": "warmup", "kv": label, "prefill_buckets": list(WARM_BUCKETS),
               "note": "prefill buckets cut to (32, 128, 1024) to bound this phase's time",
               "keys": [[list(k), sec] for k, sec in zip(info["keys"], info["capture_s"])],
               "n_keys": len(info["keys"]), "seconds": info["seconds"],
               "capture_s": sum(info["capture_s"]), "pool_bytes": info["pool_bytes"],
               "reserved_bytes_before": reserved0,
               "reserved_bytes_after": torch.cuda.memory_reserved(),
               "ttft_ms_after_warmup": ttft,
               "captures_after_warmup": (after["captures"] - stats0["captures"]
                                         + after["chunk_captures"] - stats0["chunk_captures"]),
               "chunk_replays_after_warmup": after["chunk_replays"] - stats0["chunk_replays"]}
        emit(rec)
        recs.append(rec)
        check(set(info["keys"]) == want, f"{label} warm-up: keys {info['keys']}, want {want}")
        check(rec["captures_after_warmup"] == 0,
              f"{label}: {rec['captures_after_warmup']} captures after the warm-up")
        check(rec["chunk_replays_after_warmup"] == after["chunks"] - stats0["chunks"] > 0,
              f"{label}: prompt chunks after the warm-up were not all replays: {after}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return recs


def phase_chunk_parity(torch, model) -> list:
    """A paged prompt chunk of one row (the engine's: the pool's row view,
    ``paged_row_view``) against the same chunk padded to the 8 slots' rows
    (the JAX engine's shape) at full width: row 3's chunks of 256 and 32
    tokens (positions 0-255, then 256-287 in a fresh page) through two
    pools of 256-token pages that allocate alike. Logits of every valid
    position: NMSE < 1e-3 (phase 5's gate), max abs printed. The 32-token
    chunk of one row runs its matmuls through qmm (M 32), the padded one
    through the M > 32 path."""
    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.runtime.paged_kv import (PagedKVManager, paged_cache_init,
                                                       paged_row_view)

    hp = model.hparams

    def manager():
        return PagedKVManager(paged_cache_init(hp.n_layer, 9, 256, 8, 8, hp.n_head_kv,
                                               hp.head_dim, dtype=torch.bfloat16,
                                               device="cuda"))

    pad, one = manager(), manager()
    view = paged_row_view(one.cache)
    seq, off, recs = 3, 0, []
    toks = token_prompts(hp.n_vocab, [288], SEED + 12)[0]
    with torch.no_grad():
        for n in (256, 32):
            t8 = torch.zeros((8, n), dtype=torch.int64, device="cuda")
            p8 = torch.full((8, n), -1, dtype=torch.int32, device="cuda")
            t8[seq] = torch.tensor(toks[off:off + n], device="cuda")
            p8[seq] = torch.arange(off, off + n, dtype=torch.int32, device="cuda")
            pad.plan_step({seq: n})
            ref, _ = llama_forward(model.params, hp, t8, p8, pad.cache)
            pad.finish_step()
            one.plan_step({seq: n})
            one.load_row(view, seq)
            got, _ = llama_forward(model.params, hp, t8[seq:seq + 1], p8[seq:seq + 1], view)
            one.finish_step()
            step = compare_steps([got[0].float()], [ref[seq].float()])[0]
            rec = {"phase": "chunk_parity",
                   "what": f"paged chunk of {n} tokens at positions {off}-{off + n - 1}: "
                           "one row against 8 rows", **step}
            emit(rec)
            recs.append(rec)
            check(step["nmse"] < 1e-3, f"paged one-row chunk of {n}: nmse {step['nmse']:g}")
            off += n
    check(torch.equal(one.cache.page_pos, pad.cache.page_pos),
          "the one-row and padded chunks wrote different positions")
    return recs


# ------------------------------------------------------------ 5. parity


# ------------------------------------------------------------ 4e. engine state


def byte_tokenizer():
    """A byte-level BPE tokenizer over ids 0-257 (256 byte tokens, BOS 256,
    EOS 257), for the text routes of the synthetic model, which has none."""
    from superllama_tpu_torch.tokenizer import Tokenizer
    from superllama_tpu_torch.tokenizer.vocab import TokenAttr, Vocab

    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    b2u = dict(zip(bs, map(chr, cs)))
    tokens = [b2u[b] for b in range(256)] + ["<|bos|>", "<|eos|>"]
    attrs = [TokenAttr.NORMAL] * 256 + [TokenAttr.CONTROL] * 2
    return Tokenizer(Vocab(model="gpt2", pre="default", tokens=tokens, scores=[0.0] * 258,
                           attrs=attrs, bos_id=256, eos_id=257, add_bos=True))


STATE_CACHES = (("bf16", {}), ("q8_0", {"kv_dtype": "q8_0"}),
                ("paged", {"paged": True, "page_size": 256}))
# greedy tokens of a reused and a fresh prefill may part where the fresh
# run's two best logits are nearer than this (other chunkings, other sums)
NEAR_TIE = 0.05


def phase_state(torch, model, smi_line: str) -> list:
    """The engine's state between requests, on each cache of STATE_CACHES,
    through a server warmed up as ``serve`` does (8 slots, n_ctx 2048):

     - turn 1: a 1000-token prompt, 32 greedy tokens; turn 2: turn 1's
       prompt, its tokens and 100 new ones. Turn 2 must reuse at least
       1000 cached tokens and load the rest in one chunk through fa's
       tensor-core kernel (dense) or paged's (paged), the counts set to 0
       just before it and read just after; then the same prompt on the
       erased slot (a fresh prefill): first-token logits within NMSE 1e-3,
       and tokens equal up to any step where the fresh tokens' two best
       logits (a teacher-forced forward of them) lie within NEAR_TIE;
     - dense: save after turn 1, erase, a 200-token request on the slot,
       restore: turn 2 again gives turn 2's tokens bit for bit; paged: save
       and restore refuse, erase frees the pages, and a 16-token reused
       tail (one row of M 32) goes through qmm;
     - no graph is captured after the warm-up;
     - bf16 only, over HTTP: /metrics (device memory in use, the requests
       sent), /slots, /tokenize and /detokenize round trip (a byte-level
       tokenizer on the server's model), /slots/:id save, erase, restore.
    TTFT with and without reuse is printed beside the card's name and power
    limit."""
    import gc

    from superllama_tpu_torch.server.http import Server, ServerApp

    n_vocab = model.hparams.n_vocab
    turn1, new2, other, new3 = token_prompts(n_vocab, [1000, 100, 200, 15], SEED + 20)
    recs = []
    for label, kw in STATE_CACHES:
        app = ServerApp(model, n_slots=8, n_ctx=2048, model_name=model.name, device="cuda",
                        **{"kv_dtype": torch.bfloat16, **kw})
        srv = Server(app, host="127.0.0.1", port=0)
        srv.start()
        eng = app.engine
        try:
            rec = state_turns(torch, model, eng, label, turn1, new2, other, new3)
            if label == "bf16":
                rec["http"] = state_http(app, srv.port, turn1, rec.pop("requests"))
            rec.pop("requests", None)
        finally:
            srv.stop()
            del app, srv, eng
            gc.collect()
            torch.cuda.empty_cache()
        rec["card"] = smi_line
        emit(rec)
        recs.append(rec)
    return recs


def state_turns(torch, model, eng, label, turn1, new2, other, new3) -> dict:
    from superllama_tpu_torch.runtime.engine import SlotState

    paged = eng.paged
    last = {}
    run_chunk = eng._run_chunk

    def spy(rows, P, parts, main=None):
        io = run_chunk(rows, P, parts, main)
        last["logits"] = io["logits"][next(iter(parts))].float().clone()
        return io

    eng._run_chunk = spy
    sent = [0]

    def gen(p, n=32):
        sent[0] += 1
        return eng.generate(p, max_tokens=n, sampling={"greedy": True}, stop_eog=False)

    def holder(p) -> int:
        with eng._step_lock:
            return next(s.idx for s in eng.slots
                        if s.state == SlotState.IDLE and s.cache_tokens[:len(p)] == p)

    caps0 = tuple(graph_stats(eng, k).get("captures", 0) for k in ("chunk", "block"))
    r1 = gen(turn1)
    slot = holder(turn1)
    if paged:
        for act in (lambda: eng.slot_save(slot), lambda: eng.slot_restore(slot, {})):
            try:
                act()
                check(False, "a paged slot saved or restored")
            except NotImplementedError:
                pass
        snap = None
    else:
        snap = eng.slot_save(slot)
    p2 = turn1 + r1["tokens"] + new2
    cached0 = eng.metrics["n_prompt_cached"]
    reset_counts()
    r2 = gen(p2)
    counts2 = read_counts()
    reused = eng.metrics["n_prompt_cached"] - cached0
    logits_reuse = last["logits"]
    attn = "paged_tc" if paged else "fa_tc"
    check(reused >= 1000, f"{label} turn 2 reused {reused} tokens")
    check(holder(p2) == slot, f"{label} turn 2 left its slot")
    check(counts2[attn] > 0, f"{label} turn 2's tail never launched {attn}: {counts2}")

    eng.slot_erase(slot)
    if paged:
        check(eng.pkv.seq_pages(slot) == 0, "the paged erase kept pages")
    cached0 = eng.metrics["n_prompt_cached"]
    r2f = gen(p2)
    logits_fresh = last["logits"]
    check(eng.metrics["n_prompt_cached"] == cached0, f"{label}: the erased slot reused a prefix")
    first_nmse = nmse(logits_reuse, logits_fresh)
    check(first_nmse <= 1e-3, f"{label} turn 2 first-token logits: nmse {first_nmse:g}")
    chunks = [p2[i:i + 256] for i in range(0, len(p2), 256)]   # a paged step fits a page
    fresh_logits = forward_run(torch, model, chunks + [[t] for t in r2f["tokens"][:-1]],
                               kv_dtype=None if paged else eng.kv_dtype, paged=paged)
    top2 = [lg[0, -1].topk(2).values for lg in fresh_logits[len(chunks) - 1:]]
    gaps = [float(v[0] - v[1]) for v in top2]
    split = next((i for i, (a, b) in enumerate(zip(r2["tokens"], r2f["tokens"])) if a != b),
                 None)
    if split is not None:
        check(gaps[split] < NEAR_TIE, f"{label} turn 2: reused and fresh tokens part at step "
              f"{split}, where the fresh run's top-2 gap is {gaps[split]:g}")
    rec = {"phase": "state", "kv": label, "turn1_tokens": len(turn1), "turn2_tokens": len(p2),
           "reused_tokens": reused, "ttft_ms_turn2_reuse": r2["ttft_s"] * 1e3,
           "ttft_ms_turn2_fresh": r2f["ttft_s"] * 1e3, "ttft_ms_turn1": r1["ttft_s"] * 1e3,
           "launches_turn2": counts2, "first_token_nmse": first_nmse,
           "tokens_equal_fresh": split is None, "split_step": split,
           "split_gap": None if split is None else gaps[split],
           "min_top2_gap_fresh": min(gaps), "min_gap_step": gaps.index(min(gaps))}

    if paged:
        p3 = p2 + r2f["tokens"] + new3       # a 16-token tail after 1163 cached tokens
        cached0 = eng.metrics["n_prompt_cached"]
        reset_counts()
        r3 = gen(p3, 8)
        counts3 = read_counts()
        rec.update({"tail16_reused": eng.metrics["n_prompt_cached"] - cached0,
                    "launches_tail16": counts3, "ttft_ms_tail16": r3["ttft_s"] * 1e3})
        check(rec["tail16_reused"] == len(p3) - 16, f"paged 16-token tail: {rec}")
        check(counts3["qmm"] > 0 and counts3["paged_tc"] > 0,
              f"the paged 16-token tail did not take qmm and paged_tc: {counts3}")
    else:
        eng.slot_erase(slot)
        gen(other, 8)
        check(holder(other) == slot, f"{label}: the 200-token request took another slot")
        check(eng.slot_restore(slot, snap) == len(snap["cache_tokens"]), "restore count")
        cached0 = eng.metrics["n_prompt_cached"]
        r2r = gen(p2)
        rec["restored_reused"] = eng.metrics["n_prompt_cached"] - cached0
        rec["restore_tokens_equal"] = r2r["tokens"] == r2["tokens"]
        check(rec["restored_reused"] == reused, f"{label} restore: {rec}")
        check(rec["restore_tokens_equal"], f"{label}: turn 2 after the restore gave other tokens")
    caps = tuple(graph_stats(eng, k).get("captures", 0) for k in ("chunk", "block"))
    rec["captures_after_warmup"] = [b - a for a, b in zip(caps0, caps)]
    check(caps == caps0, f"{label}: graphs captured after the warm-up {rec}")
    rec["requests"] = sent[0]
    eng._run_chunk = run_chunk
    return rec


def state_http(app, port: int, turn1, sent: int) -> dict:
    """The state routes over HTTP on the bf16 server, after its turns."""
    import urllib.request

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read().decode()

    def post(path, body):
        st, raw = http(port, path, body, timeout=300)
        check(st == 200, f"POST {path}: HTTP {st}")
        return json.loads(raw)

    eng = app.engine
    out = post("/v1/completions", {"prompt": turn1[:64], "max_tokens": 4, "temperature": 0,
                                   "return_tokens": True})
    sent += 1
    check(out["usage"]["completion_tokens"] == 4, f"HTTP completion: {out}")
    st, text = get("/metrics")
    g = {}
    for line in text.splitlines():
        if line.startswith("sllm_") and "{" not in line:
            name, val = line.split()
            g[name[5:]] = float(val)
    check(st == 200 and g.get("device_memory_used_bytes", 0) > 0, f"/metrics: {g}")
    check(g.get("requests_total") == sent, f"/metrics requests_total {g.get('requests_total')}, "
          f"{sent} sent")
    st, raw = get("/slots")
    slots = json.loads(raw)
    held = [s for s in slots if s["n_past"] > 0]
    check(st == 200 and held and all(s["n_past"] == len(eng.slots[s["id"]].cache_tokens)
                                     for s in slots), f"/slots: {slots}")
    app.model = type(app.model)(**{**vars(app.model), "tokenizer": byte_tokenizer()})
    text_in = "The state of the engine, 2048 slots of it."
    ids = post("/tokenize", {"content": text_in})["tokens"]
    back = post("/detokenize", {"tokens": ids})["content"]
    check(back == text_in, f"/tokenize then /detokenize: {back!r}")
    idx = held[0]["id"]
    saved = post(f"/slots/{idx}?action=save", {"filename": "state.npz"})
    erased = post(f"/slots/{idx}?action=erase", {})
    restored = post(f"/slots/{idx}?action=restore", {"filename": "state.npz"})
    check(saved["n_saved"] == restored["n_restored"] == held[0]["n_past"] and erased["success"],
          f"/slots/{idx} actions: {saved} {erased} {restored}")
    return {"requests_total": g["requests_total"], "device_memory_used_bytes":
            g["device_memory_used_bytes"], "slots_n_past": [s["n_past"] for s in slots],
            "tokenize_roundtrip": True, "n_saved": saved["n_saved"],
            "save_ms": saved["timings"]["save_ms"], "restore_ms": restored["timings"]["restore_ms"]}


# ----------------------------------------------------- 4f. structured output

GRAMMAR_SCHEMA = {"type": "object",
                  "properties": {"ok": {"type": "boolean"},
                                 "n": {"type": "integer", "minimum": 0, "maximum": 99},
                                 "c": {"enum": ["red", "green", "blue"]}},
                  "required": ["ok", "n", "c"], "additionalProperties": False}
GRAMMAR_TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather", "description": "the weather in a city",
        "parameters": {"type": "object",
                       "properties": {"city": {"enum": ["Oslo", "Lima", "Pune"]},
                                      "days": {"type": "integer", "minimum": 1, "maximum": 7}},
                       "required": ["city", "days"], "additionalProperties": False}}},
    {"type": "function", "function": {
        "name": "set_alarm", "description": "an alarm at an hour",
        "parameters": {"type": "object",
                       "properties": {"hour": {"type": "integer", "minimum": 0, "maximum": 23},
                                      "loud": {"type": "boolean"}},
                       "required": ["hour", "loud"], "additionalProperties": False}}}]
GRAMMAR_SAMPLED = {"temp": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05}
# JSON pieces the vocab carries beside its random ones, so the mask meets
# multi-character tokens ("Ġ" is a space in the byte-level alphabet)
JSON_PIECES = (['{"', '":', '",', '"}', '":Ġ', ',Ġ"', 'Ġ"', '{Ġ"', '}', '{', ':', ',', '"',
                'true', 'false', 'null', 'ok', 'red', 'green', 'blue', 'name', 'arguments',
                'Oslo', 'Lima', 'Pune', 'city', 'days', 'hour', 'loud', 'get_weather',
                'set_alarm', '"}}', '}}', '":{"', 'ĠĠ', 'Ċ']
               + [str(i) for i in range(10, 100)])


def grammar_tokenizer(n_vocab: int, control=()):
    """A byte-level BPE tokenizer with one piece per id below n_vocab: the
    256 byte tokens, BOS 256 and EOS 257 (as ``byte_tokenizer``), the
    ``control`` pieces (control tokens, from id 258), the JSON pieces, then
    seeded unique printable pieces of 2-8 characters. Prompts encode to
    byte tokens (no merges); the grammar sampler sees every piece."""
    import numpy as np

    from superllama_tpu_torch.tokenizer import Tokenizer
    from superllama_tpu_torch.tokenizer.vocab import TokenAttr, Vocab

    base = byte_tokenizer().vocab
    tokens = list(base.tokens) + list(control)
    seen = set(tokens)
    alphabet = [chr(c) for c in range(ord("!"), ord("~") + 1)] + ["Ġ"]
    for p in JSON_PIECES:
        if p not in seen:
            tokens.append(p)
            seen.add(p)
    rng = np.random.default_rng(SEED + 30)
    while len(tokens) < n_vocab:
        for n, idx in zip(rng.integers(2, 9, 4096), rng.integers(0, len(alphabet), (4096, 8))):
            p = "".join(alphabet[i] for i in idx[:n])
            if p not in seen and len(tokens) < n_vocab:
                tokens.append(p)
                seen.add(p)
    attrs = (list(base.attrs) + [TokenAttr.CONTROL] * len(control)
             + [TokenAttr.NORMAL] * (n_vocab - len(base.tokens) - len(control)))
    return Tokenizer(Vocab(model="gpt2", pre="default", tokens=tokens,
                           scores=[0.0] * n_vocab, attrs=attrs, bos_id=256, eos_id=257,
                           add_bos=True))


def schema_ok(obj) -> bool:
    return (isinstance(obj, dict) and set(obj) == {"ok", "n", "c"}
            and isinstance(obj["ok"], bool) and isinstance(obj["n"], int)
            and not isinstance(obj["n"], bool) and 0 <= obj["n"] <= 99
            and obj["c"] in ("red", "green", "blue"))


def args_ok(name: str, args) -> bool:
    """A tool call's arguments satisfy its tool's parameters."""
    if name == "get_weather":
        return (set(args) == {"city", "days"} and args["city"] in ("Oslo", "Lima", "Pune")
                and type(args["days"]) is int and 1 <= args["days"] <= 7)
    return (set(args) == {"hour", "loud"} and type(args["hour"]) is int
            and 0 <= args["hour"] <= 23 and isinstance(args["loud"], bool))


class MaskClock:
    """Times every GrammarSampler.apply (the mask) and every host-step
    forward (``Engine._forward``, synchronized) while installed."""

    def __init__(self, torch, eng):
        from superllama_tpu_torch.runtime import sampling

        self.torch, self.eng, self.cls = torch, eng, sampling.GrammarSampler
        self.apply, self.forward = self.cls.apply, eng._forward
        self.mask_s: list[float] = []
        self.fwd_s: list[float] = []
        clock = self

        def apply(gs, logits, ctx):
            t0 = time.perf_counter()
            out = clock.apply(gs, logits, ctx)
            clock.mask_s.append(time.perf_counter() - t0)
            return out

        def forward(*a, **k):
            t0 = time.perf_counter()
            out = clock.forward(*a, **k)
            torch.cuda.synchronize()
            clock.fwd_s.append(time.perf_counter() - t0)
            return out

        self.cls.apply = apply
        eng._forward = forward

    def reset(self) -> None:
        self.mask_s.clear()
        self.fwd_s.clear()

    def close(self) -> None:
        self.cls.apply = self.apply
        self.eng._forward = self.forward


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def grammar_request(torch, eng, clock, label: str, prompt, sampling: dict, expect) -> dict:
    """One JSON-schema request alone on a warmed-up engine: it must end by
    EOS with schema-valid text a fresh GrammarState accepts, run no decode
    block and launch every kernel of ``expect``."""
    from superllama_tpu_torch.grammar import json_schema_to_gbnf
    from superllama_tpu_torch.grammar.gbnf import GrammarState, parse_gbnf

    gbnf = json_schema_to_gbnf(GRAMMAR_SCHEMA)
    fresh(eng)
    stats0 = block_stats(eng)
    clock.reset()
    reset_counts()
    t0 = time.perf_counter()
    r = eng.generate(prompt, max_tokens=64, sampling=sampling, grammar=gbnf)
    wall = time.perf_counter() - t0
    counts = read_counts()
    d = {k: v - stats0[k] for k, v in block_stats(eng).items()}
    check(r["finish_reason"] == "stop", f"{label} grammar request: {r['finish_reason']}, "
          f"{r['n_generated']} tokens, {r['text']!r}")
    obj = json.loads(r["text"])
    check(schema_ok(obj), f"{label} grammar request: {obj} breaks the schema")
    st = GrammarState(parse_gbnf(gbnf))
    check(st.accept_text(r["text"]) and st.can_terminate,
          f"{label}: a fresh GrammarState refuses {r['text']!r}")
    check(d["blocks"] == 0 and d["replays"] == 0,
          f"{label}: decode blocks ran while the grammar request generated: {d}")
    for name in expect:
        check(counts[name] > 0, f"the {label} grammar request never launched {name}: {counts}")
    decode_s = r["total_s"] - r["ttft_s"]
    return {"tokens": r["tokens"], "text": r["text"], "n_generated": r["n_generated"],
            "wall_s": wall, "ttft_s": r["ttft_s"],
            "tok_s": (r["n_generated"] - 1) / decode_s if r["n_generated"] > 1 else None,
            "mask_ms_median": median(clock.mask_s) * 1e3,
            "mask_ms_max": max(clock.mask_s) * 1e3, "mask_steps": len(clock.mask_s),
            "mask_share_of_decode": sum(clock.mask_s) / decode_s,
            "host_step_forward_ms_median": median(clock.fwd_s) * 1e3, "launches": counts}


def mixed_wave(torch, model, eng, clock) -> dict:
    """8 greedy requests of 64 tokens, then 7 of them beside one greedy
    grammar request: every request finishes, no block runs while the grammar
    slot generates, and each kind's tok/s is read."""
    from superllama_tpu_torch.grammar import json_schema_to_gbnf
    from superllama_tpu_torch.runtime.engine import GenRequest

    gbnf = json_schema_to_gbnf(GRAMMAR_SCHEMA)
    prompts = token_prompts(model.hparams.n_vocab, [32] * 8, SEED + 31)
    rate = lambda r: (r["n_generated"] - 1) / (r["total_s"] - r["ttft_s"])   # noqa: E731
    fresh(eng)
    plain = [rate(r) for r in engine_wave(eng, prompts, 64)]
    run_block = eng._run_block
    during: list[bool] = []

    def spy(*a, **k):
        during.append(any(s.req is not None and s.req.grammar for s in eng.slots))
        return run_block(*a, **k)

    eng._run_block = spy
    fresh(eng)
    clock.reset()
    reqs = []
    try:
        in_one_wave(eng, lambda: reqs.extend(
            [eng.submit(GenRequest(prompt_ids=p, max_tokens=64, stop_eog=False,
                                   sampling={"greedy": True})) for p in prompts[:7]]
            + [eng.submit(GenRequest(prompt_ids=prompts[7], max_tokens=64, grammar=gbnf,
                                     sampling={"greedy": True}))]), 8)
        out = [r.result(timeout=900) for r in reqs]
    finally:
        eng._run_block = run_block
    check(all(o["finish_reason"] == "length" for o in out[:7]), "mixed wave: a plain request "
          "stopped early")
    check(out[7]["finish_reason"] == "stop" and schema_ok(json.loads(out[7]["text"])),
          f"mixed wave: the grammar request gave {out[7]['text']!r}")
    check(not any(during), "mixed wave: a decode block ran while the grammar slot generated")
    return {"plain_tok_s_per_row_alone": median(plain),
            "plain_tok_s_per_row_mixed": median([rate(o) for o in out[:7]]),
            "grammar_tok_s_mixed": rate(out[7]), "grammar_tokens": out[7]["n_generated"],
            "blocks_after_grammar_slot": len(during),
            "mask_ms_median": median(clock.mask_s) * 1e3,
            "host_step_forward_ms_median": median(clock.fwd_s) * 1e3}


def grammar_http(port: int, eng) -> dict:
    """The structured-output routes over HTTP: response_format, a GBNF
    grammar, tools with tool_choice "required" plain and streamed (each on
    erased slots), a bad grammar refused with 400 and the next request
    served."""
    import urllib.error

    def post(path, body):
        st, raw = http(port, path, body, timeout=900)
        check(st == 200, f"POST {path}: HTTP {st}")
        return raw

    seeded = {"temperature": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05, "seed": 11}
    out = json.loads(post("/v1/completions", {
        "prompt": "A JSON answer:", "max_tokens": 96, **seeded,
        "response_format": {"type": "json_schema",
                            "json_schema": {"name": "answer", "schema": GRAMMAR_SCHEMA}}}))
    obj = json.loads(out["choices"][0]["text"])
    check(schema_ok(obj), f"response_format json_schema gave {obj}")
    alt = json.loads(post("/v1/completions", {"prompt": "Pick:", "max_tokens": 8, **seeded,
                                              "grammar": 'root ::= "alpha" | "beta"'}))
    check(alt["choices"][0]["text"] in ("alpha", "beta"), f"GBNF alpha|beta gave {alt}")
    chat = {"messages": [{"role": "user", "content": "What is the weather in Oslo?"}],
            "tools": GRAMMAR_TOOLS, "tool_choice": "required", "max_tokens": 160, **seeded}
    fresh(eng)
    plain = json.loads(post("/v1/chat/completions", chat))["choices"][0]
    check(plain["finish_reason"] == "tool_calls", f"tools: finish {plain['finish_reason']}")
    call = plain["message"]["tool_calls"][0]["function"]
    check(call["name"] in ("get_weather", "set_alarm")
          and args_ok(call["name"], json.loads(call["arguments"])), f"tool call {call}")
    fresh(eng)
    raw = post("/v1/chat/completions", {**chat, "stream": True}).decode()
    chunks = [json.loads(ln[6:]) for ln in raw.split("\n")
              if ln.startswith("data: ") and ln != "data: [DONE]"]
    names, args = [], ""
    for c in chunks[:-1]:
        for tc in c["choices"][0]["delta"].get("tool_calls", []):
            if "name" in tc["function"]:
                names.append(tc["function"]["name"])
            args += tc["function"]["arguments"]
    check(chunks[-1]["choices"][0]["finish_reason"] == "tool_calls",
          f"streamed tools: final chunk {chunks[-1]}")
    check(names == [call["name"]] and json.loads(args) == json.loads(call["arguments"]),
          f"streamed tool call {names} {args!r} against {call}")
    try:
        http(port, "/v1/completions", {"prompt": "x", "max_tokens": 4, "grammar": "root ::= (("})
        check(False, "a bad grammar was served")
    except urllib.error.HTTPError as e:
        check(e.code == 400, f"a bad grammar gave HTTP {e.code}")
    after = json.loads(post("/v1/completions", {"prompt": "x", "max_tokens": 4,
                                                "temperature": 0}))
    check(after["usage"]["completion_tokens"] >= 1, f"after the bad grammar: {after}")
    return {"response_format": obj, "grammar": alt["choices"][0]["text"],
            "tool_call": call, "streamed_equal_plain": True, "bad_grammar_status": 400}


GRAMMAR_CACHES = (("bf16", {}, "greedy", ("qmv",)),
                  ("q8_0", {"kv_dtype": "q8_0"}, "sampled", ("qmv", "fd")),
                  ("paged", {"paged": True, "page_size": 256}, "sampled", ("qmv", "paged")))
# the grammar servers' context: every request of the phase fits 256 positions,
# and the warm-up captures a key for each window bucket up to it (18 keys at
# 2,048 on a dense cache)
GRAMMAR_N_CTX = 512
# the cache whose sampled grammar request is repeated on an erased slot (each
# such request holds the Python mask about 0.3 s a token)
GRAMMAR_REPEAT = "q8_0"


def phase_grammar(torch, model, smi_line: str) -> list:
    """Structured output on warmed-up bf16, Q8_0 and paged servers (8 slots,
    GRAMMAR_N_CTX positions) of the synthetic model with a 128,256-piece
    tokenizer (``grammar_tokenizer``):

     - a bounded JSON schema (a boolean, an integer in 0-99, an enum of three
       strings), greedy on bf16 and seeded temperature 0.8 on Q8_0 and
       paged: the request ends by EOS with schema-valid text that a fresh
       GrammarState accepts; no decode block runs while it generates; qmv
       launches (fd on Q8_0, paged on the paged cache); the sampled request
       repeated on an erased slot of GRAMMAR_REPEAT's server gives the same
       tokens;
     - bf16: a wave of 7 plain greedy requests and one grammar request
       against a wave of 8 plain ones (tok/s of each kind), and the HTTP
       routes (``grammar_http``);
     - no graph is captured after the warm-up.
    Prints the host step's forward ms, the mask's ms a token and its share
    of the decode, and the grammar request's tok/s, beside the card's name
    and power limit."""
    import gc

    from superllama_tpu_torch.server.http import Server, ServerApp

    tok = grammar_tokenizer(model.hparams.n_vocab)
    gmodel = type(model)(**{**vars(model), "tokenizer": tok})
    prompt = tok.encode("Reply with a JSON object: is it ok, a number and a colour.",
                        add_special=True, parse_special=True)
    recs = []
    for label, kw, mode, expect in GRAMMAR_CACHES:
        app = ServerApp(gmodel, n_slots=8, n_ctx=GRAMMAR_N_CTX, model_name=model.name,
                        device="cuda",
                        **{"kv_dtype": torch.bfloat16, **kw})
        srv = Server(app, host="127.0.0.1", port=0)
        srv.start()
        eng = app.engine
        caps0 = tuple(graph_stats(eng, k).get("captures", 0) for k in ("chunk", "block"))
        clock = MaskClock(torch, eng)
        try:
            sm = ({"greedy": True} if mode == "greedy"
                  else {**GRAMMAR_SAMPLED, "seed": 21})
            rec = {"phase": "grammar", "kv": label, "mode": mode,
                   **grammar_request(torch, eng, clock, label, prompt, sm, expect)}
            if label == GRAMMAR_REPEAT:
                again = grammar_request(torch, eng, clock, label, prompt, sm, expect)
                check(again["tokens"] == rec["tokens"],
                      f"{label}: the sampled grammar request on an erased slot gave other tokens")
                rec["repeat_equal"] = True
            if label == "bf16":
                rec["mixed_wave"] = mixed_wave(torch, model, eng, clock)
                rec["http"] = grammar_http(srv.port, eng)
            caps = tuple(graph_stats(eng, k).get("captures", 0) for k in ("chunk", "block"))
            check(caps == caps0, f"{label}: graphs captured after the warm-up ({caps0} -> {caps})")
            rec["captures_after_warmup"] = 0
        finally:
            clock.close()
            srv.stop()
            del app, srv, eng
            gc.collect()
            torch.cuda.empty_cache()
        rec["card"] = smi_line
        rec.pop("tokens")
        emit(rec)
        recs.append(rec)
    return recs


class PlainKernels:
    """Within the block, every kernel the forward calls is its plain PyTorch
    version (the eager plain route)."""

    def __enter__(self):
        from superllama_tpu_torch.models import llama as llama_mod
        from superllama_tpu_torch.models import mamba as mamba_mod
        from superllama_tpu_torch.models import qwen3next as q3n_mod
        from superllama_tpu_torch.models import rwkv as rwkv_mod
        from superllama_tpu_torch.ops import flash_attention as fa_mod
        from superllama_tpu_torch.ops import paged_attention as pa_mod
        from superllama_tpu_torch.ops import qmatmul as qm_mod
        from superllama_tpu_torch.ops import ref as ref_mod

        self.saved = [(qm_mod, "qmv", qm_mod.qmv_plain), (qm_mod, "qmm", qm_mod.qmm_plain),
                      (llama_mod, "grouped_matmul", ref_mod.grouped_matmul_plain),
                      (mamba_mod, "ssm_scan", ref_mod.ssm_scan_plain),
                      (rwkv_mod, "wkv6", ref_mod.wkv6_plain), (rwkv_mod, "gla", ref_mod.gla_plain),
                      (rwkv_mod, "wkv7", ref_mod.wkv7_plain),
                      (q3n_mod, "delta_net", ref_mod.delta_net_plain),
                      (llama_mod, "flash_attention", fa_mod.flash_attention_plain),
                      (llama_mod, "flash_decode_attention", fa_mod.flash_decode_plain),
                      (llama_mod, "paged_flash_attention", pa_mod.paged_flash_attention_plain)]
        self.saved = [(mod, name, getattr(mod, name), plain) for mod, name, plain in self.saved]
        for mod, name, _, plain in self.saved:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn, _ in self.saved:
            setattr(mod, name, fn)


class RouterTap:
    """Within the block, records each MoE router call of the forward (layer
    order): for the last position of row 0, the router's input, its
    selection scores (the raw logits where ``moe_topk_raw`` picks on them,
    else the gate's probabilities plus any selection bias) and the experts
    it picked."""

    def __enter__(self):
        from superllama_tpu_torch.models import llama as llama_mod

        self.mod, self.real, self.calls = llama_mod, llama_mod._moe_route, []

        def tap(x, layer, hp, router_x=None):
            probs, top_w, top_i = self.real(x, layer, hp, router_x)
            xr = (x if router_x is None else router_x)[0, -1]
            sel = llama_mod.mm(xr[None], layer["ffn_gate_inp"])[0].float()
            if "ffn_gate_inp_b" in layer:
                sel = sel + layer["ffn_gate_inp_b"].float()
            if not hp.extra.get("moe_topk_raw"):
                sel = probs[0, -1].float()
                if "exp_probs_b" in layer:
                    sel = sel + layer["exp_probs_b"].float()
            self.calls.append({"x": xr.float().cpu(), "sel": sel.cpu(),
                               "top": sorted(top_i[0, -1].tolist())})
            return probs, top_w, top_i

        llama_mod._moe_route = tap
        return self

    def __exit__(self, *exc):
        self.mod._moe_route = self.real


def router_tie(taps: dict) -> dict:
    """Where two paths' logits part by more than PATH_NMSE on a model with
    top-k routing: the first layer whose router picked other experts on the
    two paths, its inputs within PATH_NMSE of each other there and at every
    layer before, and the gap between the plain path's (a) scores of the
    experts only it picked and of those only the kernel path (b) picked no
    larger than the two paths' largest score difference: a near tie of the
    router, which the rest of the forward then amplifies (top-1 routing is
    discontinuous, like an int8 activation code)."""
    ra, rb = taps["a"], taps["b"]
    check(len(ra) == len(rb) > 0, f"router taps: {len(ra)} and {len(rb)} calls")
    layer = next((i for i, (a, b) in enumerate(zip(ra, rb)) if a["top"] != b["top"]), None)
    check(layer is not None, "the paths part beyond their limit, but every router picked "
                             "the same experts on both")
    ins = [nmse(rb[i]["x"], ra[i]["x"]) for i in range(layer + 1)]
    check(max(ins) <= PATH_NMSE, f"router inputs part before layer {layer}: NMSE {ins}")
    a, b = ra[layer], rb[layer]
    only_a = [e for e in a["top"] if e not in b["top"]]
    only_b = [e for e in b["top"] if e not in a["top"]]
    gap = float(min(a["sel"][e] for e in only_a) - max(a["sel"][e] for e in only_b))
    diff = float((a["sel"] - b["sel"]).abs().max())
    check(0 <= gap <= diff, f"router of MoE layer {layer}: experts {only_a} against {only_b}, "
                            f"scores {gap} apart, the paths' scores only {diff} apart")
    return {"moe_layer": layer, "experts_plain": only_a, "experts_kernels": only_b,
            "score_gap": gap, "score_path_diff": diff, "input_nmse": ins}


def forward_run(torch, model, tokens_seq, kv_dtype=None, paged=False, extra=None,
                greedy: int = 0, n_ctx: int = 2048):
    """Prefill tokens_seq[0] then decode the rest one by one on a fresh
    cache (dense of kv_dtype, default bf16, n_ctx slots, or paged bf16 with
    256-token pages), then ``greedy`` more decode steps, each of the last
    step's argmax, with ``extra`` set in hparams.extra meanwhile, through
    the registry's forward of the model's architecture; returns the logits
    of every step (f32; of a prompt longer than PROMPT_CHUNK, which goes in
    chunks of that many, its last chunk's)."""
    from superllama_tpu_torch.models.registry import get_forward
    from superllama_tpu_torch.runtime.paged_kv import PagedKVManager, paged_cache_init

    hp = model.hparams
    fwd = get_forward(hp.arch)
    mgr = None
    if paged:
        mgr = PagedKVManager(paged_cache_init(hp.n_layer, 9, 256, 1, 8, hp.n_head_kv,
                                              hp.head_dim, dtype=torch.bfloat16,
                                              device="cuda"))
        cache = mgr.cache
    else:
        cache = plain_cache(torch, hp, n_ctx, kv_dtype or torch.bfloat16)
    hp.extra.update(extra or {})
    out, p0 = [], 0
    try:
        with torch.no_grad():
            for i in range(len(tokens_seq) + greedy):
                toks = (tokens_seq[i] if i < len(tokens_seq)
                        else [int(out[-1][0, -1].argmax())])
                for c in range(0, len(toks), PROMPT_CHUNK):
                    part = toks[c:c + PROMPT_CHUNK]
                    t = torch.tensor([part], device="cuda")
                    pos = torch.arange(p0, p0 + len(part), device="cuda",
                                       dtype=torch.int32)[None]
                    if mgr is not None:
                        mgr.plan_step({0: len(part)})
                    logits, _ = fwd(model.params, hp, t, pos, cache)
                    if mgr is not None:
                        mgr.finish_step()
                    p0 += len(part)
                out.append(logits.float())
    finally:
        for key in extra or {}:
            hp.extra.pop(key, None)
    torch.cuda.synchronize()
    return out


# the longest prompt chunk the plain-route helpers feed at once: a prompt of
# 8,400 tokens in one step would hold 40 x 8,400^2 f32 logits a layer
PROMPT_CHUNK = 2048


def plain_cache(torch, hp, n_ctx: int, kv_dtype):
    """One row of the model's memory for the plain-route helpers: the flat
    KV cache of a dense model, the recurrent or hybrid store of an SSM one."""
    from superllama_tpu_torch.runtime.cache_policy import cache_kind, make_cache
    from superllama_tpu_torch.runtime.kv_cache import kv_cache_init

    if cache_kind(hp) != "dense":
        return make_cache(hp, 1, n_ctx, kv_dtype, device="cuda")
    return kv_cache_init(hp.n_layer, 1, n_ctx, hp.n_head_kv, hp.head_dim, hp.head_dim_v,
                         dtype=kv_dtype, device="cuda")


def phase_parity(torch, model, label: str = "Q4_K") -> None:
    """One full-width forward (32-token prefill + 4 decode steps) with the
    kernels and again with their plain versions on the same inputs."""
    seq = token_prompts(model.hparams.n_vocab, [32, 1, 1, 1, 1], SEED + 3)
    got = forward_run(torch, model, seq)
    with PlainKernels():
        ref = forward_run(torch, model, seq)
    steps = compare_steps(got, ref)
    emit({"phase": "parity", "model": label, "steps": steps})
    # bf16 activations between layers: the kernels and the plain versions
    # sum in other orders, a last-bit difference can round a bf16 activation
    # or move an int8 activation code by one step, and that compounds over
    # 32 layers; logits stay within NMSE 1e-3 of each other
    for s in steps:
        check(s["nmse"] < 1e-3, f"full-width parity step {s['step']}: nmse {s['nmse']:g}")


def compare_steps(got, ref) -> list:
    return [{"step": i, "nmse": nmse(g, r), "max_abs_err": float((g - r).abs().max()),
             "argmax_agree": float((g.argmax(-1) == r.argmax(-1)).float().mean())}
            for i, (g, r) in enumerate(zip(got, ref))]


def phase_cache_parity(torch, model) -> None:
    """The tests/test_kv_quant.py decode check at 8B width: 1 prefill + 5
    decode steps through fd against the materialized path, on a Q8_0 cache
    and on a Q4_0 cache with flash_decode_float (the path of fd's q4 mode);
    then the paged cache against the dense one. Limit: logits NMSE 1e-3,
    as in phase 5 (bf16 activations compound last-bit differences over 32
    layers)."""
    seq = token_prompts(model.hparams.n_vocab, [32, 1, 1, 1, 1, 1], SEED + 7)
    runs = {
        "q8_0 fd vs materialized": (
            forward_run(torch, model, seq, "q8_0"),
            forward_run(torch, model, seq, "q8_0", extra={"flash_decode_off": True})),
        "q4_0 fd (flash_decode_float) vs materialized": (
            forward_run(torch, model, seq, "q4_0", extra={"flash_decode_float": True}),
            forward_run(torch, model, seq, "q4_0")),
        "paged bf16 vs dense bf16": (
            forward_run(torch, model, seq, paged=True), forward_run(torch, model, seq)),
    }
    for what, (got, ref) in runs.items():
        steps = compare_steps(got, ref)
        emit({"phase": "cache_parity", "what": what, "steps": steps})
        for st in steps:
            check(st["nmse"] < 1e-3, f"{what} step {st['step']}: nmse {st['nmse']:g}")


# ------------------------------------------------------------ 6. times


def cuda_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


ROTATE_BYTES = 120e6   # inputs rotated per reading: well past the 50 MB L2


def n_copies(nbytes: float, least: int = 2) -> int:
    """Copies of an input set of nbytes that together exceed ROTATE_BYTES."""
    return max(least, math.ceil(ROTATE_BYTES / nbytes))


def kernel_reading(torch, shape: str, call, plain, lib, n: int, nbytes: float, ops: float,
                   kind: str) -> dict:
    """One kernel's times at one shape. call(i), lib(i) rotate over copies of
    their inputs (n calls a reading, the copies together past the L2), so
    each call reads from device memory as a decode step does. ``ms`` and
    ``library_ms`` are device time per call from a CUDA graph of n calls
    (no host launch cost), ``ms_eager`` / ``library_ms_eager`` the same
    calls launched one by one (CUDA events around 2n calls), ``plain_ms``
    the plain version, eager. A reading above the bound (share > 1) is a
    mis-measurement and fails the run."""
    ms = graph_ms(torch, call, n)
    lib_ms = graph_ms(torch, lib, n)
    b, by = bound(nbytes, ops, kind)
    row = {"shape": shape, "ms": ms, "ms_eager": cuda_ms(torch, call, 2 * n),
           "plain_ms": cuda_ms(torch, plain, 3, 1), "library_ms": lib_ms,
           "library_ms_eager": cuda_ms(torch, lib, 2 * n), "bound_ms": b, "bound_by": by,
           "bytes": nbytes, "ops": ops, "gbps": nbytes / ms / 1e6,
           "share_of_bound": b / ms, "library_factor": ms / lib_ms, "rotated_copies": n}
    check(row["share_of_bound"] <= 1.0,
          f"{shape}: {ms:g} ms is below the {b:g} ms bound: a mis-measurement")
    return row


def matmul_reading(torch, fn, plain, kind: str, M: int, K: int, N: int, ops_kind: str,
                   seed: int = 50) -> dict:
    """fn (qmv or qmm) at (M, K, N) with bf16 x and output, beside
    torch.matmul on the dequantized bf16 weight; both sides rotate over
    weight copies past the L2. The bound counts the weight planes, x and
    the output once."""
    from superllama_tpu_torch.ops.qtensor import dequant_qtensor

    first = rand_weight(torch, kind, N, K, seed)
    copies = [first] + [rand_weight(torch, kind, N, K, seed + i)
                        for i in range(1, n_copies(first.nbytes, 6 if N < 10**5 else 2))]
    dense = [dequant_qtensor(copies[i % len(copies)], torch.bfloat16)
             for i in range(n_copies(K * N * 2))]
    x = torch.randn((M, K), device="cuda").to(torch.bfloat16)
    nbytes = first.nbytes + x.numel() * 2 + M * N * 2
    row = kernel_reading(
        torch, f"{kind} M={M} K={K} N={N} bf16",
        lambda i: fn(x, copies[i % len(copies)], torch.bfloat16),
        lambda i: plain(x, copies[i % len(copies)], torch.bfloat16),
        lambda i: torch.matmul(x, dense[i % len(dense)]),
        max(12, len(copies), len(dense)), nbytes, 2.0 * M * K * N, ops_kind)
    del copies, dense
    return row


def time_qmv(torch) -> dict:
    """qmv at every (K, N) of a decode step at M 8 (the serving wave's 8
    rows; ``qmv`` is gate/up's row), at gate/up and wk/wv at M 1, and a
    Q6_K gate/up at M 8; each row carries its launches in a decode step.
    ``qmv_step`` sums launches x ms over the step's five shapes at M 8
    beside the same sum of bounds and of torch.matmul's times."""
    from superllama_tpu_torch.ops.qmatmul import qmv, qmv_plain

    out = {}
    for K, N in KN_8B:
        row = matmul_reading(torch, qmv, qmv_plain, "Q4_K", 8, K, N, "int8")
        row["launches_per_step"] = CHUNK_LAUNCHES[(K, N)]
        out[f"qmv K={K} N={N}"] = row
    for name, kind, M, K, N in (("qmv M=1 K=4096 N=14336", "Q4_K", 1, 4096, 14336),
                                ("qmv M=1 K=4096 N=1024", "Q4_K", 1, 4096, 1024),
                                ("qmv Q6_K K=4096 N=14336", "Q6_K", 8, 4096, 14336)):
        out[name] = matmul_reading(torch, qmv, qmv_plain, kind, M, K, N, "int8")
        out[name]["launches_per_step"] = CHUNK_LAUNCHES[(K, N)] if kind == "Q4_K" else 0
    rows = [out[f"qmv K={K} N={N}"] for K, N in KN_8B]
    out["qmv_step"] = {key: sum(r[key] * r["launches_per_step"] for r in rows)
                       for key in ("ms", "bound_ms", "library_ms")}
    out["qmv"] = out["qmv K=4096 N=14336"]
    return out


def time_matmul_kernels(torch) -> dict:
    """qmm at every (K, N) of a lone 32-token prompt chunk (M 32, Q4_K);
    ``qmm`` is the gate/up row; each row carries its launches in a lone
    chunk."""
    from superllama_tpu_torch.ops.qmatmul import qmm, qmm_plain

    out = {}
    for K, N in KN_8B:
        row = matmul_reading(torch, qmm, qmm_plain, "Q4_K", 32, K, N, "bf16")
        row["launches_per_chunk"] = CHUNK_LAUNCHES[(K, N)]
        out[f"qmm K={K} N={N}"] = row
    out["qmm"] = out["qmm K=4096 N=14336"]
    return out


def qmm_chunk(kernels: dict) -> dict:
    """qmm's device time in a lone 32-token chunk of the 8B model, from the
    graph readings at each (K, N) times its launches, beside the bound's."""
    rows = [kernels[f"qmm K={K} N={N}"] for K, N in KN_8B]
    return {"ms": sum(r["ms"] * r["launches_per_chunk"] for r in rows),
            "library_ms": sum(r["library_ms"] * r["launches_per_chunk"] for r in rows),
            "bound_ms": sum(r["bound_ms"] * r["launches_per_chunk"] for r in rows)}


def after_weight_stream_ms(torch, call, n: int) -> float:
    """Device ms of call(i) when each call follows a qmm call that streams
    a 33 MB Q4_K weight (gate/up, M 32; four copies, past the L2), as
    attention does in a prompt chunk: a graph of n (qmm, call) pairs less
    a graph of the n qmm calls alone."""
    from superllama_tpu_torch.ops.qmatmul import qmm

    ws = [rand_weight(torch, "Q4_K", 14336, 4096, 60 + i) for i in range(4)]
    x = torch.randn((32, 4096), device="cuda").to(torch.bfloat16)
    mm = lambda i: qmm(x, ws[i % 4], torch.bfloat16)
    both = graph_ms(torch, lambda i: (mm(i), call(i)), n)
    return both - graph_ms(torch, mm, n)


def fa_reading(torch, name: str, B: int, T: int, n_past: int, lens=None, kv="bf16",
               after_stream=False) -> dict:
    """fa at one prefill shape (S 2048, 32/8 heads, D 128, bf16 q) over a
    bf16 or f32 cache, beside SDPA (bool mask, GQA) on the same K/V. Work
    and bytes count only the visible (causal, occupied) part, as the kernel
    skips the rest: each visible K/V row read once per kv head, q read and
    the output written once, the positions. The copies rotated over hold
    ROTATE_BYTES of those bytes together, so each call reads from device
    memory."""
    import torch.nn.functional as F

    from superllama_tpu_torch.ops.flash_attention import (flash_attention,
                                                          flash_attention_plain)

    lens = lens or [T] * B
    S, H, Hkv, D = 2048, 32, 8, 128
    dtype = "f32" if kv == "f32" else "bf16"
    pairs = sum(n_past * n + n * (n + 1) // 2 for n in lens) * H   # visible (row, slot)
    ops = 2.0 * (D + D) * pairs
    kv_bytes = 4 if kv == "f32" else 2
    nbytes = (2 * sum(n_past + n for n in lens) * Hkv * D * kv_bytes
              + sum(lens) * H * D * 2 * 2 + (B * T + B * S) * 4)
    n = n_copies(nbytes)
    sets = []
    for i in range(n):
        args = fa_inputs(torch, B=B, T=T, S=S, n_past=n_past, lens=lens, dtype=dtype,
                         seed=7 + i)[0]
        sets.append((args[0].to(torch.bfloat16),) + args[1:])
    q_pos, kv_pos = sets[0][3], sets[0][4]
    mask = ((kv_pos[:, None, None, :] >= 0) & (kv_pos[:, None, None, :] <= q_pos[:, None, :, None]))
    lib_q = [s[0].transpose(1, 2).to(s[1].dtype) for s in sets]
    row = kernel_reading(
        torch, f"B={B} T={T} S={S} H={H} Hkv={Hkv} D={D} n_past={n_past} lens={lens} "
               f"bf16 q, {kv} kv",
        lambda i: flash_attention(*sets[i % n]),
        lambda i: flash_attention_plain(*sets[i % n]),
        lambda i: F.scaled_dot_product_attention(lib_q[i % n], sets[i % n][1], sets[i % n][2],
                                                 attn_mask=mask, enable_gqa=True),
        max(8, n), nbytes, ops, "bf16")
    if after_stream:
        row["ms_after_weight_stream"] = after_weight_stream_ms(
            torch, lambda i: flash_attention(*sets[i % n]), 32)
    del sets, lib_q
    return {name: row}


def time_fa(torch) -> dict:
    """fa's tensor-core kernel at the three prefill shapes of the main path:
    (a) the serving wave, 8 rows of 100 or 32 prompt tokens in a 128-token
    bucket; (b) a lone 32-token chunk, also right after a weight-streaming
    qmm call as in the chunk; (c) a long prompt's 1024-token chunk, where
    operations bound it; and the CUDA-core kernel at (a) over an f32 cache
    (bf16 q). Each row carries its launches in its path."""
    rows = {**fa_reading(torch, "fa_tc", 8, 128, 0, lens=[100, 32] * 4),
            **fa_reading(torch, "fa_tc T=32", 1, 32, 0, after_stream=True),
            **fa_reading(torch, "fa_tc T=1024", 1, 1024, 0),
            **fa_reading(torch, "fa", 8, 128, 0, lens=[100, 32] * 4, kv="f32")}
    for key, per in (("fa_tc", "wave"), ("fa_tc T=32", "chunk"), ("fa_tc T=1024", "chunk"),
                     ("fa", "wave")):
        rows[key][f"launches_per_{per}"] = 64 if per == "wave" else 32
    return rows


def time_fd(torch) -> dict:
    """fd in each mode at the 8B decode shape (B 8, T 1, S 2048, 32/8 heads,
    D 128, bf16 q), beside its plain version and SDPA over the same float or
    already dequantized cache (the yardstick leaves the dequant out)."""
    import torch.nn.functional as F

    from superllama_tpu_torch.ops.flash_attention import (flash_decode_attention,
                                                          flash_decode_plain)
    from superllama_tpu_torch.runtime.kv_cache import q4_dequant

    out = {}
    for kv in ("f", "q8", "q4"):
        args, extra = fd_inputs(torch, kv=kv, seed=700)
        q, k, v, q_pos, kv_pos = args
        B, T, H, D = q.shape
        Hkv, S = k.shape[1], k.shape[2]
        # each input read once (q, K/V codes and scales, positions), the
        # output written once
        nbytes = sum(t.numel() * t.element_size() for t in (*args, *extra.values()))
        nbytes += q.numel() * q.element_size()
        n = n_copies(nbytes)
        sets = [(args, extra)] + [fd_inputs(torch, kv=kv, seed=700 + i) for i in range(1, n)]
        dense = []
        for a, e in sets[:2]:
            if kv == "q8":
                dense.append(((a[1].float() * e["k_scale"][..., None]).to(torch.bfloat16),
                              (a[2].float() * e["v_scale"][..., None]).to(torch.bfloat16)))
            elif kv == "q4":
                dense.append((q4_dequant(a[1], e["k_scale"], torch.bfloat16),
                              q4_dequant(a[2], e["v_scale"], torch.bfloat16)))
            else:
                dense.append((a[1], a[2]))
        mask = ((kv_pos[:, None, None, :] >= 0)
                & (kv_pos[:, None, None, :] <= q_pos[:, None, :, None]))
        qt = q.transpose(1, 2)
        visible = int((kv_pos[0] >= 0).sum())
        ops = 2.0 * 2 * D * B * H * T * visible
        out[f"fd_{kv}"] = kernel_reading(
            torch, f"{kv} B={B} T={T} S={S} H={H} Hkv={Hkv} D={D} bf16 q",
            lambda i: flash_decode_attention(*sets[i % n][0], **sets[i % n][1]),
            lambda i: flash_decode_plain(*sets[i % n][0], **sets[i % n][1]),
            lambda i: F.scaled_dot_product_attention(
                qt, dense[i % 2][0], dense[i % 2][1], attn_mask=mask, enable_gqa=True),
            max(n, 8), nbytes, ops, "int8" if kv == "q8" else "bf16")
        del sets, dense
    return out


def paged_reading(torch, what: str, seed: int, **shape) -> dict:
    """paged at one shape of paged_inputs (a shuffled bf16 pool, 32/8 heads,
    D 128), beside SDPA over the gathered dense K/V (the gather left out);
    copies rotated as in fa_reading. Work counts the visible (row, slot)
    pairs. Bytes count what the function needs: the K/V of the slots some
    valid query of their row sees, the positions of the row's pages, the
    table and q_pos, and q and the output of the valid rows only (a padding
    row's q is never read and its output is undefined, though the kernel
    writes zeros there)."""
    import torch.nn.functional as F

    from superllama_tpu_torch.ops.paged_attention import (paged_flash_attention,
                                                          paged_flash_attention_plain)

    first = paged_inputs(torch, seed=seed, **shape)
    q, kp, vp, q_pos, page_pos, table = first
    B, T, H, D = q.shape
    Hkv, P = kp.shape[1], kp.shape[2]
    kv_pos = page_pos[table.long().clamp(min=0)].reshape(B, -1)
    mask = ((kv_pos[:, None, None, :] >= 0)
            & (kv_pos[:, None, None, :] <= q_pos[:, None, :, None]))
    ops = 2.0 * 2 * D * H * int(mask.sum())
    seen = int(mask.any(dim=2).sum())   # (row, slot) pairs some valid query sees
    nbytes = (seen * 2 * Hkv * D * 2 + int((table >= 0).sum()) * P * 4 + table.numel() * 4
              + q_pos.numel() * 4 + 2 * int((q_pos >= 0).sum()) * H * D * 2)
    n = n_copies(nbytes)
    sets = [first] + [paged_inputs(torch, seed=seed + i, **shape) for i in range(1, n)]
    dense = []
    for s in sets:
        tbl = s[5].long().clamp(min=0)
        dense.append((s[1][tbl].permute(0, 2, 1, 3, 4).reshape(B, Hkv, -1, D),
                      s[2][tbl].permute(0, 2, 1, 3, 4).reshape(B, Hkv, -1, D)))
    row = kernel_reading(
        torch, f"B={B} T={T} {what} P={P} MAXP={table.shape[1]} H={H} Hkv={Hkv} D={D} bf16",
        lambda i: paged_flash_attention(*sets[i % n]),
        lambda i: paged_flash_attention_plain(*sets[i % n]),
        lambda i: F.scaled_dot_product_attention(
            sets[i % n][0].transpose(1, 2), dense[i % n][0], dense[i % n][1], attn_mask=mask,
            enable_gqa=True), max(8, n), nbytes, ops, "bf16")
    del sets, dense
    return row


def time_paged(torch) -> dict:
    """paged at the decode shape: 8 rows of 2048 positions in 256-token
    pages (MAXP 8); and its prefill path (T*G > 32, bf16: the tensor-core
    kernel) at (b) a 100-token prompt's chunk padded to the 8 slots' rows
    (B 8, T 128, row 0 at positions 0-99 in one page, rows 1-7 padding only
    over empty tables, MAXP 8 = n_ctx 2048: the JAX engine's chunk), where
    bytes bound it; (c) a prompt's fourth 256-token chunk (B 1, T 256 at
    positions 768-1023, four pages: the engine's chunk), where operations
    bound it (3.76 GFLOP); (d) that chunk beside seven rows of padding (B
    8, MAXP 8); (e) a call whose eight rows are all 100-token prompts (T
    128), which the engine never sends (a call of several rows is not
    split); (f) the chunk of a 100-token prompt as the engine sends it, one
    row (B 1, T 128), cluster split."""
    rows = {"paged": paged_reading(torch, "2048 positions", 800),
            "paged prefill B=8": paged_reading(
                torch, "prompt 100 in a 128-token bucket, 7 padding rows", 900, T=128,
                lens=[100] + [0] * 7),
            "paged prefill": paged_reading(torch, "positions 768-1023", 850, B=1, T=256,
                                           MAXP=4, lens=[1024]),
            "paged prefill B=8 T=256": paged_reading(
                torch, "positions 768-1023, 7 padding rows", 870, T=256, lens=[1024] + [0] * 7),
            "paged prefill B=8 all rows": paged_reading(
                torch, "8 prompts of 100 in a 128-token bucket", 880, T=128, lens=[100] * 8),
            "paged prefill B=1 T=128": paged_reading(
                torch, "prompt 100 in a 128-token bucket, one row", 905, B=1, T=128,
                lens=[100])}
    for key in ("paged prefill B=1 T=128", "paged prefill"):
        rows[key]["launches_per_chunk"] = 32
    return rows


def time_decode_attention(torch) -> dict:
    """The plain decode attention of a bf16 cache (attention_gqa and
    attention_ref, which llama_forward picks between by the JAX package's
    TPU-tuned test) against fd in f mode, at B 1 and B 8, T 1, S 2048."""
    from superllama_tpu_torch.ops import ref as ops
    from superllama_tpu_torch.ops.flash_attention import flash_decode_attention
    from superllama_tpu_torch.runtime.kv_cache import causal_mask

    out = {}
    for B in (1, 8):
        args, _ = fd_inputs(torch, B=B, kv="f", seed=900 + B)
        q, k, v, q_pos, kv_pos = args
        mask = causal_mask(kv_pos, q_pos)
        out[f"B={B}"] = {
            "attention_gqa_ms": cuda_ms(torch, lambda i: ops.attention_gqa(q, k, v, mask), 50),
            "attention_ref_ms": cuda_ms(torch, lambda i: ops.attention_ref(q, k, v, mask), 50),
            "fd_f_ms": cuda_ms(torch, lambda i: flash_decode_attention(*args), 50)}
    return out


TTFT_LENS = (32, 100, 1000)


def time_ttft(eng) -> dict:
    """Time to first token of a lone 32-, 100- and 1000-token prompt on a
    fresh engine: cold (each the first request to reach its prompt chunk's
    graph key, whose capture it pays; on a dense cache one chunk each, on
    a paged one the 1000-token prompt's four 256-token chunks), then warm
    (the same prompts again, three times: the keys captured)."""
    prompts = token_prompts(eng.model.hparams.n_vocab, TTFT_LENS, SEED + 4)
    def run(p) -> float:
        fresh(eng)
        return eng.generate(p, max_tokens=1, sampling={"greedy": True},
                            stop_eog=False)["ttft_s"] * 1e3

    out = {f"ttft_ms_prompt{n}_cold": run(p) for n, p in zip(TTFT_LENS, prompts)}
    warm = {n: [run(p) for _ in range(3)] for n, p in zip(TTFT_LENS, prompts)}
    for n in TTFT_LENS:
        out[f"ttft_ms_prompt{n}"] = sorted(warm[n])[1]
        out[f"ttft_ms_prompt{n}_runs"] = warm[n]
    return out


def time_serving(torch, model, sampled: bool = True, **engine_kw) -> dict:
    """TTFT of lone 32-, 100- and 1000-token prompts, cold and warm
    (time_ttft), then decode tok/s at B 1 and B 8, greedy and (with
    sampled) sampled (sampled_configs). Each decode block and prompt chunk
    is a graph replay, the blocks captured in a warm run first; the
    captures' time and the graph pool's bytes are reported."""
    from superllama_tpu_torch.runtime.engine import Engine

    engine_kw.setdefault("kv_dtype", torch.bfloat16)
    eng = Engine(model, n_slots=8, n_ctx=2048, device="cuda", **engine_kw)
    ttft = time_ttft(eng)
    p32 = token_prompts(model.hparams.n_vocab, [32], SEED + 4)[0]
    # (each request prefills its prompt from scratch: fresh)
    gen = lambda p, n, sm: (fresh(eng), eng.generate(  # noqa: E731
        p, max_tokens=n, sampling=sm, stop_eog=False))[1]
    gen(p32, 16, {"greedy": True})  # warm
    r1 = gen(p32, 128, {"greedy": True})
    sm = sampled_configs(8)
    if sampled:
        gen(p32, 16, sm[0])  # warm
        r1s = gen(p32, 128, sm[0])
    eng.start()
    try:
        p8 = token_prompts(model.hparams.n_vocab, [32] * 8, SEED + 5)
        fresh(eng)
        t0 = time.perf_counter()
        rs = engine_wave(eng, p8, 128)
        wall = time.perf_counter() - t0
        if sampled:
            fresh(eng)
            rss = engine_wave(eng, p8, 128, sm)
    finally:
        eng.stop()
    graphs = {**block_stats(eng), "pool_bytes": eng._graphs.pool_bytes()}
    check(graphs["replays"] == graphs["blocks"] and graphs["chunk_replays"] == graphs["chunks"],
          f"time_serving: blocks and chunks {graphs}")
    # launches of one lone 32-token prefill chunk, then of one decode step
    fresh(eng)
    reset_counts()
    eng.generate(p32, max_tokens=1, sampling={"greedy": True}, stop_eog=False)
    per_chunk = read_counts()
    eng.block_size = 1
    fresh(eng)
    reset_counts()
    eng.generate(p32, max_tokens=2, sampling={"greedy": True}, stop_eog=False)
    per_step = {k: n - per_chunk[k] for k, n in read_counts().items()}
    b1 = lambda r: (r["n_generated"] - 1) / (r["total_s"] - r["ttft_s"])   # noqa: E731
    b8 = lambda rs: (sum(r["n_generated"] - 1 for r in rs)                 # noqa: E731
                     / (max(r["total_s"] for r in rs) - max(r["ttft_s"] for r in rs)))
    return {
        "decode_tok_s_b1": b1(r1), "decode_tok_s_b8": b8(rs),
        **({"decode_tok_s_b1_sampled": b1(r1s), "decode_tok_s_b8_sampled": b8(rss)}
           if sampled else {}),
        "graphs": graphs, **ttft, "batch8_wall_s": wall,
        "launches_per_prefill_chunk_32": per_chunk, "launches_per_decode_step": per_step,
    }


def kernel_times(torch) -> dict:
    return {**time_qmv(torch), **time_matmul_kernels(torch), **time_fa(torch),
            **time_fd(torch), **time_paged(torch)}


def phase_times(torch, model, smi_line: str) -> dict:
    serving = {"bf16": time_serving(torch, model),
               "q8_0": time_serving(torch, model, kv_dtype="q8_0"),
               "paged": time_serving(torch, model, paged=True, page_size=256)}
    kernels = kernel_times(torch)
    emit({"phase": "times", "card": smi_line, "serving": serving, "kernels": kernels,
          "qmm_per_chunk": qmm_chunk(kernels), "qmv_per_step": kernels["qmv_step"],
          "decode_attention": time_decode_attention(torch)})
    return kernels


def profile_block(torch, model, label: str, graphs: bool = True, **engine_kw) -> dict:
    """torch.profiler over one engine step in steady state (one block of 8
    greedy decode steps launched, the one before it landed; 8 active rows at
    a depth of about 40-100 positions) on one cache, the block a graph
    replay or (``graphs=False``) eager. In an eager block the cache writes
    run under a "kv_write" range, so their device time (the quantize-on-write
    ops on a Q8_0 cache) reads apart from the rest; a replay runs no Python,
    so it has no such range and its kernels are read by name. The step
    before the profiled one is timed unprofiled (``wall_ms_unprofiled``):
    the profiler's tracing adds its own cost to every kernel."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from superllama_tpu_torch.models import llama as llama_mod
    from superllama_tpu_torch.runtime.engine import Engine, GenRequest

    engine_kw.setdefault("kv_dtype", torch.bfloat16)
    eng = Engine(model, n_slots=8, n_ctx=2048, device="cuda", graphs=graphs, **engine_kw)
    for p in token_prompts(model.hparams.n_vocab, [32] * 8, SEED + 6):
        eng.submit(GenRequest(prompt_ids=p, max_tokens=64, sampling={"greedy": True},
                              stop_eog=False))
    eng.step()                      # admit, prefill wave, first decode block
    eng.step()                      # warm decode block
    torch.cuda.synchronize()
    t0 = time.perf_counter()        # the same kind of step, unprofiled
    eng.step()
    torch.cuda.synchronize()
    wall_unprofiled_ms = (time.perf_counter() - t0) * 1e3
    writers = {name: getattr(llama_mod, name) for name in ("kv_update_layer",
                                                           "paged_update_layer")}

    def ranged(fn):
        def run(*a, **k):
            with record_function("kv_write"):
                return fn(*a, **k)
        return run

    for name, fn in writers.items():
        setattr(llama_mod, name, ranged(fn))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in writers.items():
            setattr(llama_mod, name, fn)
    events = prof.key_averages()
    dev = device_rows(events)
    device_ms = sum(t for _, t, _ in dev)
    attn = [(k, t, n) for k, t, n in dev
            if any(s in k for s in ("decode_kernel", "fd_combine", "paged_kernel"))]
    # qmv's kernels (a parent tree's quantizer and reduce kernels too)
    qmv_rows = [(k, t, n) for k, t, n in dev if any(
        s in k for s in ("qmv_kernel", "quantize_acts_kernel", "reduce_splits_kernel"))]
    kv_write = [e for e in events if e.key == "kv_write" and e.self_cpu_time_total > 0]
    name = f"profile_decode_{label}{'_graph' if graphs else ''}.txt"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    top = sorted(dev, key=lambda r: -r[1])[:12]
    return {"cache": label, "block": "graph replay" if graphs else "eager",
            "wall_ms": wall_ms, "wall_ms_unprofiled": wall_unprofiled_ms,
            "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "device_ops": sum(c for _, _, c in dev),
            "cuda_launch_calls": sum(e.count for e in events if e.key == "cudaLaunchKernel"),
            "cuda_graph_launches": sum(e.count for e in events if e.key == "cudaGraphLaunch"),
            "decode_attention_kernels": [{"name": k[:80], "ms": t, "count": n}
                                         for k, t, n in attn],
            "decode_attention_ms": sum(t for _, t, _ in attn),
            "qmv_ms": sum(t for _, t, _ in qmv_rows), "qmv_ops": sum(n for _, _, n in qmv_rows),
            "kv_write_device_ms": sum(e.device_time_total for e in kv_write) / 1e3,
            "kv_write_calls": sum(e.count for e in kv_write),
            "top": [{"name": k[:80], "ms": t, "count": c} for k, t, c in top]}


def device_rows(events) -> list:
    """(name, device ms, count) of the device-side rows of a profile:
    kernels and copies carry no CPU time; operator rows repeat their
    kernels' device time, so they are left out of the sums (the kv_write
    range's own device row spans its kernels and the gaps between them, so
    it is left out too; its CPU row sums its kernels)."""
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0
            and e.key != "kv_write"]


def profile_chunk(torch, model, n: int = 32, paged: bool = False,
                  graphs: bool = False) -> dict:
    """torch.profiler over one lone n-token prompt on the bf16 cache, dense
    or (``paged``) in 256-token pages (engine.generate of one token, warmed
    once), its chunks eager or (``graphs``) replayed from CUDA graphs: the
    prompt's wall ms, device ms, idle share, device ms by kernel, the
    attention kernels' (fa's or paged's, every launch) and, for an eager
    chunk above 32 tokens, the M > 32 matmul path's (the llama forward's
    ``mm`` under a range: dequantize, then torch.matmul; a replay runs no
    Python, so no range); before it the TTFT of one more unprofiled run. A
    paged engine takes the prompt in one-row 256-token chunks. The table
    goes to chiprun_out/profile_chunk_bf16[_paged][_<n>][_graph].txt."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from superllama_tpu_torch.models import llama as llama_mod
    from superllama_tpu_torch.ops import paged_attention as pa_mod
    from superllama_tpu_torch.runtime.engine import Engine

    kw = {"paged": True, "page_size": 256} if paged else {}
    eng = Engine(model, n_slots=8, n_ctx=2048, kv_dtype=torch.bfloat16, device="cuda",
                 graphs=graphs, **kw)
    prompt = token_prompts(model.hparams.n_vocab, [n], SEED + 4)[-1]
    run = lambda: eng.generate(prompt, max_tokens=1, sampling={"greedy": True}, stop_eog=False)
    run()
    fresh(eng)          # each run prefills the whole prompt
    ttft_ms = run()["ttft_s"] * 1e3
    fresh(eng)
    torch.cuda.synchronize()
    mm = llama_mod.mm

    def ranged(*a, **k):
        with record_function("mm"):
            return mm(*a, **k)

    if n > 32:   # every matmul of the chunk takes the M > 32 path
        llama_mod.mm = ranged
    try:
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
    finally:
        llama_mod.mm = mm
    events = prof.key_averages()
    dev = [r for r in device_rows(events) if r[0] != "mm"]
    device_ms = sum(t for _, t, _ in dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    label = f"{'_paged' if paged else ''}{'' if n == 32 else f'_{n}'}{'_graph' if graphs else ''}"
    with open(os.path.join(OUT_DIR, f"profile_chunk_bf16{label}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    qmm_rows = [(k, t, c) for k, t, c in dev if "qmm" in k]
    # attention: fa's two kernels, paged's tensor-core kernel (an
    # instantiation of fa_tc_kernel) and its CUDA-core one
    fa_rows = [(k, t, c) for k, t, c in dev
               if any(name in k for name in ("fa_tc_kernel", "fa_kernel", "paged_kernel"))]
    mm_cpu = [e for e in events if e.key == "mm" and e.self_cpu_time_total > 0]
    rec = {"phase": "profile",
           "what": f"one lone {n}-token prompt, bf16 {'paged ' if paged else ''}cache",
           "chunks": "graph replay" if graphs else "eager",
           "ttft_ms": ttft_ms, "wall_ms": wall_ms, "device_ms": device_ms,
           "device_idle_share": 1.0 - device_ms / wall_ms,
           "device_ops": sum(c for _, _, c in dev),
           "qmm_ms": sum(t for _, t, _ in qmm_rows),
           "qmm_kernels": [{"name": k[:80], "ms": t, "count": c} for k, t, c in qmm_rows],
           "fa_ms": sum(t for _, t, _ in fa_rows),
           "fa_kernels": [{"name": k[:80], "ms": t, "count": c} for k, t, c in fa_rows],
           "mm_ms": sum(e.device_time_total for e in mm_cpu) / 1e3,
           "launches": {k: counts[k] for k in ("qmm", "fa", "fa_tc", "paged", "paged_tc")},
           "by_kernel": [{"name": k[:80], "ms": t, "count": c}
                         for k, t, c in sorted(dev, key=lambda r: -r[1])[:15]]}
    emit(rec)
    check(rec["fa_ms"] > 0, f"the lone {n}-token chunk ran no attention kernel")
    # (an unpacked parent tree, read with --kernel-times, may predate a count)
    if paged and hasattr(pa_mod.paged_flash_attention, "launches_tc"):
        check(counts["paged_tc"] > 0 and counts["paged"] == 0 and counts["fa_tc"] == 0,
              f"the lone paged {n}-token prompt's attention launches did not all take paged's "
              f"tensor-core kernel: {counts}")
    elif not paged and hasattr(llama_mod.flash_attention, "launches_tc"):
        check(counts["fa_tc"] > 0 and counts["fa"] == 0,
              f"the lone {n}-token chunk's fa launches did not all take the tensor-core "
              f"kernel: {counts}")
    if n <= 32:
        check(rec["qmm_ms"] > 0, "the lone prompt chunk ran no qmm kernel")
    return rec


def profile_chunks(torch, model) -> None:
    """Where a lone 32-token and 1000-token prompt's time goes on the bf16
    cache, and a 1000-token one on the paged cache, its chunks eager and
    replayed from CUDA graphs."""
    for n, paged in ((32, False), (1000, False), (1000, True)):
        for graphs in (False, True):
            profile_chunk(torch, model, n, paged=paged, graphs=graphs)


def phase_profile(torch, model) -> None:
    """Where a decode step's time goes, on the bf16, Q8_0 and paged caches:
    one block of 8 greedy decode steps with 8 active rows each, eager and
    replayed from a CUDA graph, tables in
    chiprun_out/profile_decode_<cache>[_graph].txt; before them the lone
    prompts' (profile_chunks)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    profile_chunks(torch, model)
    for label, kw in (("bf16", {}), ("q8_0", {"kv_dtype": "q8_0"}),
                      ("paged", {"paged": True, "page_size": 256})):
        for graphs in (False, True):
            rec = profile_block(torch, model, label, graphs, **kw)
            emit({"phase": "profile", "what": "one engine step = 8 greedy decode steps, 8 rows",
                  **rec})
            if label != "bf16" and not graphs:
                check(rec["decode_attention_ms"] > 0,
                      f"the {label} decode step ran no decode-attention kernel")


# ------------------------------------------------------------ 8. tools


def phase_tools(torch, model) -> dict:
    """The measurement tools' path, as a user runs them: qmv_probe at
    ffn_gate/up's (N 14336, K 4096) and at (4096, 4096), ops_bench at its
    default shapes (written to chiprun_out/ops_perf.json),
    flash_decode_probe, llama-bench (pp 32, tg 16) and batched-bench (pp
    128, tg 32, B 1/4/8; its decode chains replayed from CUDA graphs) on the
    8B model. The launch counts are set to 0 just before and read just
    after."""
    from dataclasses import asdict

    from superllama_tpu_torch.tools import (batched_bench, flash_decode_probe, llama_bench,
                                            ops_bench, qmv_probe)

    reset_counts()
    t0 = time.perf_counter()
    probe = [qmv_probe.run(N, K, device="cuda")["qmv_probe"] for N, K in ((14336, 4096),
                                                                           (4096, 4096))]
    ops_bench.run(device="cuda", out=os.path.join(OUT_DIR, "ops_perf.json"))
    cells = flash_decode_probe.probe(device="cuda")
    bench = llama_bench.run_bench(model, pp=(32,), tg=(16,), reps=2, n_ctx=2048)
    print(llama_bench.format_markdown(bench), flush=True)
    batched = batched_bench.run_batched_bench(model, [(128, 32, b) for b in (1, 4, 8)])
    print(batched_bench.format_table(batched), flush=True)
    counts = read_counts()
    emit({"phase": "tools", "seconds": time.perf_counter() - t0, "launches": counts,
          "qmv_probe": probe, "decode_cells": len(cells),
          "llama_bench": [asdict(r) for r in bench],
          "batched_bench": [r.as_dict() | {"t_pp_s": r.t_pp_s, "t_tg_s": r.t_tg_s}
                            for r in batched]})
    families = {f"{k}_{f}" for k in ("qmv", "qmm") for f in FAMILY_FORMAT}
    for name, n in counts.items():
        # fa's CUDA-core kernel serves f32 q or K/V, and paged's tensor-core
        # kernel a paged prefill chunk, neither of which a tool sends; the
        # tools run the Q4_K model, so no format family's kernel either,
        # and the model has no experts, so no gmm, and no SSM or linear-
        # attention layer, so no ssm_scan or wkv rule
        idle = ("fa", "paged_tc", "gmm", "ssm_scan", "wkv6", "gla", "wkv7", "delta_net")
        check(n > 0 or name in idle or name in families,
              f"the tools' path never launched the {name} kernel")
    return counts


def graph_ms(torch, fn, n: int, replays: int = 3) -> float:
    """Device ms per call of fn(i), i < n, captured once in a CUDA graph and
    replayed: the reading holds no host launch cost."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * n)


def time_probe(torch, smi_line: str) -> dict:
    """Each probe variant at M 8 on (K 4096, N 14336) and (4096, 4096), bf16
    x, weights rotating over copies that exceed the 50 MB L2: ``ms`` the
    whole call with its torch prep replayed from a CUDA graph (as every
    kernel's ms here; ``ms_eager`` launched one by one), ``kernel_ms`` the
    kernel alone on prepared activations from a CUDA graph; beside them the
    plain version, ``torch.matmul`` of bf16 x with the dequantized bf16
    weight (``library_ms`` from a graph over copies past the L2, eager
    beside it), and qmv (eager and from a graph). The bound counts the
    weight planes, int8 x, f32 sx/xs and the f32 output once."""
    from superllama_tpu_torch.ops.qmatmul import qmv
    from superllama_tpu_torch.ops.qtensor import dequant_qtensor
    from superllama_tpu_torch.tools.qmv_probe import (VARIANTS, launch_variant, prep_acts,
                                                      qmv_variant, qmv_variant_plain)

    out = {}
    M = 8
    t0 = time.perf_counter()
    for K, N in ((4096, 14336), (4096, 4096)):
        n_copies = max(6, -(-120_000_000 // (K * N * 9 // 16)))
        copies = [rand_weight(torch, "Q4_K", N, K, 700 + i) for i in range(n_copies)]
        dense = [dequant_qtensor(copies[i], torch.bfloat16) for i in range(4)]
        x = torch.randn((M, K), device="cuda").to(torch.bfloat16)
        w = lambda i: copies[i % n_copies]
        lib = lambda i: torch.matmul(x, dense[i % 4])
        lib_ms, lib_eager = graph_ms(torch, lib, 48), cuda_ms(torch, lib, 60)
        shape = {"qmv_ms": cuda_ms(torch, lambda i: qmv(x, w(i), torch.float32), 60),
                 "qmv_graph_ms": graph_ms(torch, lambda i: qmv(x, w(i), torch.float32), 48)}
        G = K // 32
        nbytes = copies[0].nbytes + M * K + 2 * M * G * 4 + M * N * 4
        b, by = bound(nbytes, 2.0 * M * K * N, "int8")
        for v in VARIANTS:
            acts = prep_acts(x, v)
            out[f"qmv_probe_{v} N={N}"] = {
                "shape": f"Q4_K M={M} K={K} N={N} bf16 x, f32 out",
                "ms": graph_ms(torch, lambda i: qmv_variant(x, w(i), v), 48),
                "ms_eager": cuda_ms(torch, lambda i: qmv_variant(x, w(i), v), 60),
                "kernel_ms": graph_ms(torch, lambda i: launch_variant(acts, w(i), v), 48),
                "plain_ms": cuda_ms(torch, lambda i: qmv_variant_plain(x, w(i), v), 3, 1),
                "library_ms": lib_ms, "library_ms_eager": lib_eager, "bound_ms": b,
                "bound_by": by, "bytes": nbytes,
                **shape}
        del copies, dense
    emit({"phase": "probe_times", "card": smi_line, "seconds": time.perf_counter() - t0,
          "kernels": out})
    return out


def phase_prefill(torch, model, smi_line: str) -> None:
    """The prompt path's phases (``--prefill``): graph against eager blocks
    and chunks, the warm-up, the one-row paged chunk against the padded
    one, TTFT cold and warm on the bf16, Q8_0 and paged caches, and the
    lone prompts' profiles. In a tree whose engine has no ``warmup`` (an
    unpacked parent) only the TTFTs and the profiles run."""
    import gc

    from superllama_tpu_torch.runtime.engine import Engine

    ours = hasattr(Engine, "warmup")
    if ours:
        phase_graph_vs_eager(torch, model)
        phase_warmup(torch, model)
        phase_chunk_parity(torch, model)
    ttft = {}
    for label, kw in (("bf16", {}), ("q8_0", {"kv_dtype": "q8_0"}),
                      ("paged", {"paged": True, "page_size": 256})):
        eng = Engine(model, n_slots=8, n_ctx=2048, device="cuda",
                     **{"kv_dtype": torch.bfloat16, **kw})
        ttft[label] = time_ttft(eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "ttft", "card": smi_line, "tree": "this" if ours else "parent",
          "ttft": ttft})
    os.makedirs(OUT_DIR, exist_ok=True)
    profile_chunks(torch, model)


# ------------------------------------------------------------ 4g. decode variants

# Llama-3.2-1B's published widths (meta-llama/Llama-3.2-1B config.json),
# the speculative draft of the synthetic 8B
DRAFT_1B = dict(n_embd=2048, n_layer=16, n_head=32, n_head_kv=8, head_dim=64, head_dim_v=64,
                n_rot=64, n_ff=8192, n_vocab=128256, rope_freq_base=500000.0)
# (label, engine kwargs, draft, n_draft, the kernels its rollout and its
# verify must launch, the prompt start's kernel)
SPEC_ENGINES = (
    ("bf16-1b-k8", {}, "1b", 8, ("qmv",), (), "fa_tc"),
    ("q8_0-1b-k7", {"kv_dtype": "q8_0"}, "1b", 7, ("qmv", "fd"), ("qmm", "fd"), "fa_tc"),
    ("paged-1b-k7", {"paged": True, "page_size": 256}, "1b", 7, ("qmv",), ("qmm", "paged"),
     "paged_tc"),
    ("bf16-self-k7", {}, "self", 7, ("qmv",), ("qmm",), "fa_tc"),
)
SPEC_CACHES = {"bf16": {}, "q8_0": {"kv_dtype": "q8_0"}, "paged": {"paged": True, "page_size": 256}}
SPEC_SAMPLED = {"temp": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05, "seed": 21}
# greedy tokens a request: the engines with the 1B draft accept nothing
# (random weights), one token a round, and read their round's cost within
# a few rounds
SPEC_TOKENS, DRAFT_TOKENS, SAMPLED_TOKENS = 32, 16, 8


def build_draft(torch, n_layer: int = DRAFT_1B["n_layer"]):
    """The synthetic 1B draft (seed 1, about 1.2 GB of Q4_K and bf16 at its
    16 layers), ``n_layer`` deep."""
    from superllama_tpu_torch.models.loader import LoadedModel
    from superllama_tpu_torch.models.synthetic import (llama3_8b_hparams,
                                                       synthetic_qparams_device)

    hp = llama3_8b_hparams(**{**DRAFT_1B, "n_layer": n_layer})
    t0 = time.perf_counter()
    params = synthetic_qparams_device(hp, seed=SEED + 1, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "draft_model", "n_layer": hp.n_layer, "n_embd": hp.n_embd,
          "head_dim": hp.head_dim, "n_vocab": hp.n_vocab, "seconds": time.perf_counter() - t0})
    return LoadedModel(hp, params, tokenizer=None, metadata={}, name="synthetic-llama3.2-1b-q4_k")


def byte_draft(torch, draft):
    """The 1B draft over byte_tokenizer's 258 ids: its layers, a 258-row
    embedding and a dense head of its own (seeded, of the embedding's
    type)."""
    import dataclasses

    tok = byte_tokenizer()
    n = tok.vocab.n_tokens
    dev, dt = draft.params["token_embd"].device, draft.params["token_embd"].dtype
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 50)
    E = draft.hparams.n_embd
    params = {**draft.params,
              "token_embd": (torch.randn((n, E), generator=g, device=dev) * 0.02).to(dt),
              "output": (torch.randn((E, n), generator=g, device=dev) / E ** 0.5).to(dt)}
    return type(draft)(dataclasses.replace(draft.hparams, n_vocab=n), params, tokenizer=tok,
                       metadata={}, name="synthetic-llama3.2-1b-bytes")


class PathTimer:
    """Wraps an engine's ``_d_rollout`` and ``_verify``: each call bracketed
    by torch.cuda.synchronize, its seconds and the kernel launches it made
    summed by path (a comparison's launches are never among them)."""

    def __init__(self, torch, eng):
        self.torch, self.eng = torch, eng
        self.s = {"rollout": 0.0, "verify": 0.0}
        self.n = {"rollout": 0, "verify": 0}
        self.launches = {"rollout": {}, "verify": {}}
        for name, attr in (("rollout", "_d_rollout"), ("verify", "_verify")):
            if hasattr(eng, attr):
                setattr(eng, attr, self._wrap(name, getattr(eng, attr)))

    def _wrap(self, name, fn):
        def run(*a, **k):
            self.torch.cuda.synchronize()
            c0, t0 = read_counts(), time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.s[name] += time.perf_counter() - t0
            self.n[name] += 1
            c1 = read_counts()
            for kname in c1:
                d = c1[kname] - c0.get(kname, 0)
                if d:
                    self.launches[name][kname] = self.launches[name].get(kname, 0) + d
            return out
        return run

    def reset(self) -> None:
        for d in (self.s, self.n):
            for k in d:
                d[k] = 0
        self.launches = {"rollout": {}, "verify": {}}

    def ms(self) -> dict:
        return {f"{k}_ms": (1e3 * self.s[k] / self.n[k] if self.n[k] else None) for k in self.s}


def decode_rate(eng, run) -> tuple:
    """(results, decode tok/s): the engine's decode seconds and tokens over
    ``run()``, bracketed by torch.cuda.synchronize (the first token of each
    request comes from its prefill and is not counted)."""
    import torch

    m0 = dict(eng.metrics)
    torch.cuda.synchronize()
    out = run()
    with eng._step_lock:     # a request ends inside a step: let the step count its time
        torch.cuda.synchronize()
    d_s = eng.metrics["decode_s"] - m0["decode_s"]
    d_tok = eng.metrics["n_tokens_generated"] - m0["n_tokens_generated"] - len(out)
    return out, (d_tok / d_s if d_s > 0 else None)


def first_divergence(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def path_logits(torch, model, ids, rows: int, width: int, kv_dtype=None, paged=False,
                masked=False):
    """The logits of ids[-1] at its position through two paths over one
    cache (``rows`` rows, row 0 real) that holds ids[:-1], prefilled in one
    chunk: (a) a decode step of one token a row, the plain engine's; (b) a
    step of ``width`` tokens a row, ids[-1] first (the verify's or, with
    ``masked``, lookahead's tree step with a causal mask over its cells).
    With ids of one token the prefix is empty and (a)/(b) are the prompt's
    chunks at ``rows`` rows and at one row. Returns (a, b), f32 on the host."""
    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.runtime.kv_cache import kv_cache_init, kv_truncate_rows
    from superllama_tpu_torch.runtime.paged_kv import PagedKVManager, paged_cache_init

    hp = model.hparams
    kv_dtype = kv_dtype or torch.bfloat16
    S = 2048
    n = len(ids) - 1

    def new_cache(nrows):
        if not paged:
            return None, kv_cache_init(hp.n_layer, nrows, S, hp.n_head_kv, hp.head_dim,
                                       hp.head_dim_v, dtype=kv_dtype, device="cuda")
        mpps = S // 256
        mgr = PagedKVManager(paged_cache_init(hp.n_layer, nrows * mpps + 1, 256, nrows, mpps,
                                              hp.n_head_kv, hp.head_dim, hp.head_dim_v,
                                              dtype=kv_dtype, device="cuda"))
        return mgr, mgr.cache

    def step(mgr, cache, toks, start, mask=None):
        nrows, T = (cache.table if mgr is not None else cache.cursor).shape[0], len(toks)
        tok = torch.zeros((nrows, T), dtype=torch.int64, device="cuda")
        pos = torch.full((nrows, T), -1, dtype=torch.int32, device="cuda")
        tok[0] = torch.tensor(toks, device="cuda")
        pos[0] = torch.arange(start, start + T, device="cuda")
        if mgr is not None:
            mgr.plan_step({0: T})
        lg, _ = llama_forward(model.params, hp, tok, pos, cache, attn_mask=mask)
        if mgr is not None:
            mgr.finish_step()
        return lg[0].float().cpu()

    mgr, cache = new_cache(rows)
    if n == 0:
        # the first token: the plain engine's prompt wave against a lone chunk
        a = step(mgr, cache, ids, 0)[-1]
        b = step(*new_cache(1), ids, 0)[-1]
        return a, b
    step(mgr, cache, ids[:-1], 0)
    saved = mgr.save_cursor(0) if paged else None
    a = step(mgr, cache, ids[-1:], n)[0]
    if paged:
        mgr.rollback(0, saved, 0, 1)
    else:
        keep = torch.zeros(rows, dtype=torch.int32, device="cuda")
        keep[0] = n
        kv_truncate_rows(cache, keep)
    mask = None
    if masked:
        mask = torch.full((1, 1, width, S), -1e30, device="cuda")
        mask[0, 0, :, :n] = 0.0
        for t in range(width):
            mask[0, 0, t, n:n + t + 1] = 0.0
    b = step(mgr, cache, [ids[-1]] * width, n, mask=mask)[0]
    return a, b


def forced_gaps(torch, model, prompt, got, kv_dtype=None, paged=False, n_ctx: int = 2048):
    """The plain prefill teacher-forced over the variant's own tokens:
    prompt + got[:-1] at one row of a fresh cache of n_ctx slots, in one
    chunk (chunks of PROMPT_CHUNK past that). Returns (gaps, logits):
    gaps[j] = the largest logit at got[j]'s position less got[j]'s own, and
    the (len(got), V) logits there, f32 on the host."""
    from superllama_tpu_torch.models.registry import get_forward
    from superllama_tpu_torch.runtime.paged_kv import PagedKVManager, paged_cache_init

    hp = model.hparams
    fwd = get_forward(hp.arch)
    kv_dtype = kv_dtype or torch.bfloat16
    ids = list(prompt) + list(got[:-1])
    T = len(ids)
    mgr = None
    if paged:
        mgr = PagedKVManager(paged_cache_init(hp.n_layer, 9, 256, 1, 8, hp.n_head_kv,
                                              hp.head_dim, hp.head_dim_v, dtype=kv_dtype,
                                              device="cuda"))
        cache = mgr.cache
        mgr.plan_step({0: T})
    else:
        cache = plain_cache(torch, hp, n_ctx, kv_dtype)
    first = len(prompt) - 1
    parts = []
    for c in range(0, T, PROMPT_CHUNK if not paged else T):
        tok = torch.tensor([ids[c:c + PROMPT_CHUNK]], dtype=torch.int64, device="cuda")
        pos = torch.arange(c, c + tok.shape[1], dtype=torch.int32, device="cuda")[None]
        lg, _ = fwd(model.params, hp, tok, pos, cache)
        if c + tok.shape[1] > first:
            parts.append(lg[0, max(first - c, 0):].float())
    if mgr is not None:
        mgr.finish_step()
    lg = torch.cat(parts)
    want = torch.tensor(got, dtype=torch.int64, device="cuda")
    gaps = lg.max(-1).values - lg.gather(1, want[:, None])[:, 0]
    return gaps.cpu(), lg.cpu()


PATH_NMSE = 1e-3     # logits of two paths of one position: phase 5's limit


def greedy_rule(torch, model, label: str, prompt, ref, got, rows: int, width: int,
                paths=None, n_ctx: int = 2048, taps: dict | None = None,
                path_nmse: float = PATH_NMSE, **path_kw) -> dict:
    """``got`` (a variant's greedy tokens) against ``ref`` (the plain path's,
    as many): equal, or parted at a first position i where the two
    candidates' logits (the plain decode path's) differ by no more than the
    largest difference between the plain path's and the variant's path's
    logits there; those two paths and the plain prefill there agree within
    logits NMSE 1e-3. From i on, the plain prefill teacher-forced over
    prompt + got must rank each got[j] first or within 2 D of the first, D
    the largest difference among the three paths at i: a token the
    variant's path ranks first lies at most 2 D below the first wherever
    the two paths differ by at most D. ``paths(ids)`` gives the two paths'
    logits (default: path_logits' plain decode step and variant step).
    With ``taps`` (route_paths' router records of the paths), two paths
    that part beyond PATH_NMSE pass where router_tie finds a router near
    tie that explains it. ``path_nmse`` replaces PATH_NMSE for a model
    family whose paths part further by construction (SSM_PATH_NMSE)."""
    ref = ref[:len(got)]
    i = first_divergence(ref, got)
    if i is None and len(ref) == len(got):
        return {"equal": True}
    check(i is not None, f"{label}: {len(got)} tokens against the plain path's {len(ref)}")
    ids = list(prompt) + list(ref[:i])
    a, b = (paths(ids) if paths is not None
            else path_logits(torch, model, ids, rows, width, **path_kw))
    x, y = ref[i], got[i]
    gap = abs(float(a[x] - a[y]))
    path_diff = float((a - b).abs().max())
    check(gap <= path_diff,
          f"{label}: tokens part at {i} ({x} against {y}), their logits {gap} apart, but the "
          f"two paths' logits only {path_diff} apart there")
    gaps, forced = forced_gaps(torch, model, prompt, got, path_kw.get("kv_dtype"),
                               path_kw.get("paged", False), n_ctx)
    p = forced[i]
    errs = {"decode_vs_variant": nmse(b, a), "decode_vs_prefill": nmse(p, a)}
    if taps is not None and max(errs.values()) > path_nmse:
        return {"equal": False, "parted_at": i, "logit_gap": gap, "path_diff": path_diff,
                "path_nmse": errs, "router_tie": router_tie(taps)}
    check(max(errs.values()) <= path_nmse,
          f"{label}: at {i} the paths' logits differ by NMSE {errs} (limit {path_nmse})")
    D = max(path_diff, float((a - p).abs().max()), float((b - p).abs().max()))
    worst = int(gaps[i:].argmax()) + i
    check(float(gaps[worst]) <= 2 * D,
          f"{label}: at {worst} (after the parting at {i}) token {got[worst]} lies "
          f"{float(gaps[worst])} below the plain prefill's first, more than 2 x {D}")
    return {"equal": False, "parted_at": i, "logit_gap": gap, "path_diff": path_diff,
            "path_nmse": errs, "spread": D, "forced_max_gap": float(gaps[worst]),
            "forced_max_gap_at": worst, "forced_n_not_first": int((gaps[i:] > 0).sum())}


def spec_prompts(n_vocab: int) -> list:
    return token_prompts(n_vocab, [100] * 4, SEED + 40)


def repeated_prompts(n_vocab: int) -> list:
    """Prompts of a 16-token span repeated (lookup's drafts come from them)."""
    spans = token_prompts(n_vocab, [16] * 4, SEED + 41)
    return [(s * 7)[:100] for s in spans]


def plain_baselines(torch, model, prompts, lookup_prompts) -> dict:
    """The plain engines' greedy tokens (a warm second wave of the same
    prompts) and their block-decode tok/s at B 4 and B 1 (the seeded
    sampled request, its second run), on each cache of SPEC_CACHES."""
    import gc

    from superllama_tpu_torch.runtime.engine import Engine

    out = {}
    for label, kw in SPEC_CACHES.items():
        eng = Engine(model, n_slots=4, n_ctx=2048, device="cuda", **kw)
        eng.start()
        engine_wave(eng, prompts, SPEC_TOKENS)            # captures its graphs
        fresh(eng)
        res, b4 = decode_rate(eng, lambda: engine_wave(eng, prompts, SPEC_TOKENS))
        sampled = lambda: [eng.generate(prompts[0], max_tokens=SAMPLED_TOKENS,
                                        sampling=SPEC_SAMPLED, stop_eog=False)]
        for _ in range(2):           # the first run captures the sampled block's graphs
            fresh(eng)
            _, b1 = decode_rate(eng, sampled)
        rec = {"tokens": [r["tokens"] for r in res], "tok_s_b4": b4, "tok_s_b1": b1}
        if label in ("bf16", "paged"):
            fresh(eng)
            rec["lookup_tokens"] = [r["tokens"] for r in engine_wave(eng, lookup_prompts,
                                                                      SPEC_TOKENS)]
        out[label] = rec
        eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "variants_plain", **{k: {"tok_s_b4": v["tok_s_b4"], "tok_s_b1": v["tok_s_b1"]}
                                        for k, v in out.items()}})
    return out


def spec_engine_run(torch, model, eng, label, prompts, base, expect_roll, expect_ver,
                    expect_start, n_tokens=SPEC_TOKENS, waves=None) -> dict:
    """A speculative (or lookup) engine's greedy wave of n_tokens a request
    (or the results of ``waves``, already served) against the plain
    engine's, its launches, rates and the seeded sampled request repeated
    on an erased slot."""
    t0 = time.perf_counter()
    timer = PathTimer(torch, eng)
    fresh(eng)
    reset_counts()
    res, b4 = decode_rate(eng, lambda: engine_wave(eng, prompts, n_tokens))
    counts = read_counts()
    got = [r["tokens"] for r in res]
    if waves is not None:
        check(waves == got, f"{label}: served tokens differ from the engine's own wave")
    for name in expect_start:
        check(counts[name] > 0, f"{label}: the prompt start never launched {name}")
    for name in expect_roll:
        check(timer.launches["rollout"].get(name, 0) > 0,
              f"{label}: the draft rollout never launched {name}: {timer.launches}")
    for name in expect_ver:
        check(timer.launches["verify"].get(name, 0) > 0,
              f"{label}: the verify never launched {name}: {timer.launches}")
    rows, width = eng.n_slots, (eng.n_draft if eng.draft_model is not None else eng.lookup_k) + 1
    kw = {"paged": eng.paged, "kv_dtype": eng.kv_dtype}
    rules = [greedy_rule(torch, model, f"{label} request {i}", p, r, g, rows, width, **kw)
             for i, (p, r, g) in enumerate(zip(prompts, base, got))]
    m = eng.metrics
    rate = m["n_spec_accepted"] / max(m["n_spec_drafted"], 1)
    paths = {**timer.ms(), "rounds": timer.n["verify"], "launches": timer.launches}
    timer.reset()
    fresh(eng)
    s1, b1 = decode_rate(eng, lambda: [eng.generate(
        prompts[0], max_tokens=SAMPLED_TOKENS, sampling=SPEC_SAMPLED, stop_eog=False)])
    b1_paths = timer.ms()
    fresh(eng)
    s2 = eng.generate(prompts[0], max_tokens=SAMPLED_TOKENS, sampling=SPEC_SAMPLED,
                      stop_eog=False)
    check(s1[0]["tokens"] == s2["tokens"],
          f"{label}: the seeded sampled request on an erased slot gave other tokens")
    return {"launches": counts, "greedy": rules, "accept_rate": rate,
            "n_spec_drafted": m["n_spec_drafted"], "n_spec_accepted": m["n_spec_accepted"],
            "tok_s_b4": b4, "tok_s_b1": b1, "b4": paths, "b1": b1_paths,
            "sampled_repeat_equal": True, "tokens": n_tokens,
            "seconds": time.perf_counter() - t0}


def spec_http(torch, model, draft, prompts, base) -> dict:
    """The bf16 engine with the 1B draft at n_draft 8 behind the port's
    server (warmed up as ``serve`` does): 4 concurrent greedy completions,
    whose tokens must equal the engine's own wave; then the engine's run
    of SPEC_ENGINES' first row; no capture after the warm-up."""
    from superllama_tpu_torch.server.http import Server, ServerApp

    label, kw, _, k, roll, ver, start = SPEC_ENGINES[0]
    app = ServerApp(model, n_slots=4, n_ctx=2048, model_name=model.name, device="cuda",
                    draft_model=draft, n_draft=k, **kw)
    srv = Server(app, host="127.0.0.1", port=0)
    srv.start()
    eng = app.engine
    caps0 = tuple(graph_stats(eng, x).get("captures", 0) for x in ("chunk", "block"))
    try:
        results: list = [None] * len(prompts)

        def send(i):
            results[i] = http(srv.port, "/v1/completions",
                              {"prompt": prompts[i], "max_tokens": DRAFT_TOKENS,
                               "temperature": 0, "return_tokens": True})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(prompts))]
        reset_counts()
        in_one_wave(eng, lambda: [t.start() for t in threads], len(prompts))
        for t in threads:
            t.join(timeout=900)
        http_counts = read_counts()
        served = []
        for i, (st, data) in enumerate(results):
            ch = json.loads(data)["choices"][0]
            check(st == 200 and ch["finish_reason"] == "length", f"{label} HTTP request {i}: {st}")
            served.append(ch["tokens"])
        rec = spec_engine_run(torch, model, eng, label, prompts, base, roll, ver, (start,),
                              DRAFT_TOKENS, waves=served)
        rec["http_launches"] = http_counts
        caps = tuple(graph_stats(eng, x).get("captures", 0) for x in ("chunk", "block"))
        check(caps == caps0, f"{label}: graphs captured after the warm-up ({caps0} -> {caps})")
        rec["warmup_keys"] = len(app.warmup_info["keys"])
        rec["captures_after_warmup"] = 0
    finally:
        srv.stop()
    return rec


class ShiftProbe:
    """Stands in for the engine module's ``kv_context_shift``: times each
    shift (torch.cuda.synchronize around it) and holds the first one against
    the plain torch op on a CPU copy of the cache taken just before it, in
    f32 (a Q8_0 copy keeps its codes): positions and cursors equal, V
    bit-equal, K within NMSE 1e-5 (Q8_0: codes within one step)."""

    def __init__(self, torch, engine_mod):
        self.torch, self.mod = torch, engine_mod
        self.orig = engine_mod.kv_context_shift
        engine_mod.kv_context_shift = self
        self.ms: list = []
        self.ref = None
        self.checked: dict = {}

    def close(self) -> None:
        self.mod.kv_context_shift = self.orig

    def __call__(self, cache, keep, discard, inv_freq, rope_type, mscale):
        torch = self.torch
        from superllama_tpu_torch.runtime.kv_cache import KVCache

        first = self.ref is None
        if first:
            f = lambda t: None if t is None else t.to(
                "cpu", torch.float32 if t.is_floating_point() else t.dtype, copy=True)
            snap = KVCache(k=f(cache.k), v=f(cache.v), pos=f(cache.pos), cursor=f(cache.cursor),
                           k_scale=f(cache.k_scale), v_scale=f(cache.v_scale))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.orig(cache, keep, discard, inv_freq, rope_type, mscale)
        torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        if first:
            ref = self.orig(snap, torch.as_tensor(keep).cpu(), torch.as_tensor(discard).cpu(),
                            inv_freq.cpu(), rope_type, mscale)
            self.ref = ref
            S = cache.max_seq
            check(torch.equal(cache.pos.cpu()[:, :S], ref.pos[:, :S])
                  and torch.equal(cache.cursor.cpu(), ref.cursor),
                  "shift: positions or cursors differ from the plain op's")
            check(torch.equal(cache.v.cpu()[..., :S, :].to(ref.v.dtype), ref.v[..., :S, :]),
                  "shift: V differs from the plain op's")
            k = cache.k.cpu()[..., :S, :]
            if cache.quantized:
                dk = (k.int() - ref.k[..., :S, :].int()).abs().max().item()
                check(dk <= 1, f"shift: Q8_0 K codes {dk} steps from the plain op's")
                check(torch.equal(cache.v_scale.cpu()[..., :S], ref.v_scale[..., :S]),
                      "shift: V scales differ from the plain op's")
                self.checked = {"k_code_steps": dk, "k_scale_nmse": nmse(
                    cache.k_scale.cpu()[..., :S], ref.k_scale[..., :S])}
            else:
                e = nmse(k.float(), ref.k[..., :S, :])
                check(e <= 1e-5, f"shift: K NMSE {e} against the plain op's")
                self.checked = {"k_nmse": e}
        return out


def shift_runs(torch, model) -> list:
    """bf16, Q8_0 and paged engines with ctx_shift, n_ctx 512, 2 slots, each
    slot a 100-token prompt and 600 greedy tokens (each shifts once on the
    way: at n_past 511, 205 cells go); the first shift against the plain op
    (the paged one on its dense row, and the chain after import through
    export_row)."""
    import gc

    from superllama_tpu_torch.runtime import engine as engine_mod
    from superllama_tpu_torch.runtime.engine import Engine

    from superllama_tpu_torch.runtime.engine import GenRequest

    prompts = token_prompts(model.hparams.n_vocab, [100, 100], SEED + 42)
    recs = []
    for label, kw in (("bf16", {}), ("q8_0", {"kv_dtype": "q8_0"}),
                      ("paged", {"paged": True, "page_size": 256, "max_pages_per_seq": 3})):
        eng = Engine(model, n_slots=2, n_ctx=512, device="cuda", ctx_shift=True, **kw)
        probe = ShiftProbe(torch, engine_mod)
        rec = {"phase": "ctx_shift", "kv": label}
        try:
            if eng.paged:
                orig = eng._paged_shift

                def paged_shift(s, n_keep, n_discard, orig=orig, rec=rec):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    orig(s, n_keep, n_discard)
                    torch.cuda.synchronize()
                    rec.setdefault("paged_shift_ms", []).append(1e3 * (time.perf_counter() - t0))
                    if "chain_checked" not in rec:
                        k, v, pos = eng.pkv.export_row(s.idx)
                        cells = pos >= 0
                        n = int(cells.sum())
                        ref = probe.ref
                        check(torch.equal(pos[cells], ref.pos[0, :n]),
                              "paged shift: the chain's positions differ from the plain op's")
                        check(torch.equal(v[:, :, cells].float(), ref.v[:, 0, :, :n]),
                              "paged shift: the chain's V differs from the plain op's")
                        e = nmse(k[:, :, cells].float(), ref.k[:, 0, :, :n])
                        check(e <= 1e-5, f"paged shift: the chain's K NMSE {e}")
                        rec["chain_checked"] = {"cells": n, "k_nmse": e}

                eng._paged_shift = paged_shift
            reqs = [eng.submit(GenRequest(prompt_ids=p, max_tokens=600,
                                          sampling={"greedy": True}, stop_eog=False))
                    for p in prompts]
            eng.run_until_drained()
            for r in reqs:
                res = r.result()
                check(res["finish_reason"] == "length" and res["n_generated"] == 600,
                      f"ctx shift {label}: {res['finish_reason']} after {res['n_generated']}")
            check(eng.metrics["n_ctx_shifts"] >= 2,
                  f"ctx shift {label}: {eng.metrics['n_ctx_shifts']} shifts")
            rec.update({"n_ctx_shifts": eng.metrics["n_ctx_shifts"], "shift_ms": probe.ms,
                        "first_shift": probe.checked})
        finally:
            probe.close()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        emit(rec)
        recs.append(rec)
    return recs


def lookahead_run(torch, model) -> dict:
    """LookaheadDecoder (W 8, N 4, G 8, n_ctx 1024, bf16) for 32 tokens
    against Context greedy, the greedy rule at the tree step's width."""
    from superllama_tpu_torch.runtime.context import Context
    from superllama_tpu_torch.runtime.lookahead import LookaheadDecoder

    prompt = token_prompts(model.hparams.n_vocab, [100], SEED + 43)[0]
    la = LookaheadDecoder(model, W=8, N=4, G=8, n_ctx=1024, kv_dtype=torch.bfloat16,
                          device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = la.generate(prompt, SPEC_TOKENS)[len(prompt):]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ctx = Context(model, n_ctx=1024, kv_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref = ctx.greedy_generate(prompt, SPEC_TOKENS, stop_eog=False)[len(prompt):]
    torch.cuda.synchronize()
    dt_ref = time.perf_counter() - t1
    rule = greedy_rule(torch, model, "lookahead", prompt, ref, got, 1, la.T, masked=True)
    return {"phase": "lookahead", "W": 8, "N": 4, "G": 8, "tokens": len(got),
            "n_accept": la.n_accept, "n_steps": la.n_steps, "greedy": rule,
            "tok_s": len(got) / dt, "context_tok_s": len(ref) / dt_ref}


def herded_positions(n_prompt: int, n_dec: int, ga_n: int, ga_w: int, chunk: int = 64):
    """passkey.cpp's positions of a prompt fed in chunks, then n_dec tokens
    one by one: each compression moves the cells' positions as its
    seq_add / seq_div / seq_add do."""
    pos: list = []
    state = {"n_past": 0, "ga_i": 0}

    def herd():
        n_past, ga_i = state["n_past"], state["ga_i"]
        ib = (ga_n * ga_i) // ga_w
        bd = (ga_w // ga_n) * (ga_n - 1)
        dd = (ga_w // ga_n) - ib * bd - ga_w
        for i, p in enumerate(pos):
            if ga_i <= p < n_past:
                p += ib * bd
            if ga_i + ib * bd <= p < ga_i + ib * bd + ga_w:
                p //= ga_n
            elif ga_i + ib * bd + ga_w <= p < n_past + ib * bd:
                p += dd
            pos[i] = p
        state["n_past"] -= bd
        state["ga_i"] += ga_w // ga_n

    def feed(k):
        while state["n_past"] >= state["ga_i"] + ga_w:
            herd()
        pos.extend(range(state["n_past"], state["n_past"] + k))
        state["n_past"] += k

    for i in range(0, n_prompt, chunk):
        feed(min(chunk, n_prompt - i))
    for _ in range(n_dec):
        feed(1)
    return pos


def self_extend_run(torch, model) -> dict:
    """SelfExtend (ga_n 4, ga_w 512) over a bf16 Context: a 1,024-token
    prompt, 16 greedy tokens; the cache positions equal the passkey
    formula's, and the first herd's re-roped K equals the plain ops' on a
    CPU f32 copy (NMSE 1e-5)."""
    from types import SimpleNamespace

    from superllama_tpu_torch.runtime.context import Context
    from superllama_tpu_torch.runtime.kv_cache import KVCache
    from superllama_tpu_torch.runtime.self_extend import SelfExtend

    prompt = token_prompts(model.hparams.n_vocab, [1024], SEED + 44)[0]
    ctx = Context(model, n_ctx=2048, kv_dtype=torch.bfloat16, device="cuda")
    se = SelfExtend(ctx, ga_n=4, ga_w=512)
    herd = se._herd
    rec = {"phase": "self_extend", "ga_n": 4, "ga_w": 512, "herds": 0}

    def checked_herd():
        if se.n_past < se.ga_i + se.ga_w:
            return herd()
        first = rec["herds"] == 0
        c = ctx.cache
        if first:
            snap = KVCache(k=c.k.to("cpu", torch.float32, copy=True),
                           v=c.v.to("cpu", copy=True), pos=c.pos.to("cpu", copy=True),
                           cursor=c.cursor.to("cpu", copy=True))
            state = (se.n_past, se.ga_i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        herd()
        torch.cuda.synchronize()
        rec.setdefault("herd_ms", []).append(1e3 * (time.perf_counter() - t0))
        rec["herds"] += 1
        if first:
            cpu = SelfExtend.__new__(SelfExtend)
            cpu.ctx = SimpleNamespace(cache=snap, hp=ctx.hp)
            cpu.ga_n, cpu.ga_w = se.ga_n, se.ga_w
            cpu.n_past, cpu.ga_i = state
            cpu._inv_freq, cpu._mscale = se._inv_freq.cpu(), se._mscale
            cpu._herd()
            S = c.max_seq
            check(torch.equal(c.pos.cpu(), snap.pos), "self-extend: positions differ after a herd")
            e = nmse(c.k.cpu().float()[..., :S, :], snap.k[..., :S, :])
            check(e <= 1e-5, f"self-extend: re-roped K NMSE {e} against the plain ops")
            rec["first_herd_k_nmse"] = e

    se._herd = checked_herd
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = se.generate(prompt, 16)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    n = int(ctx.cache.cursor[0])
    pos = ctx.cache.pos[0, :n].cpu().tolist()
    want = herded_positions(len(prompt), 15, 4, 512)
    check(pos == want, "self-extend: the cache positions differ from the passkey formula's")
    check(len(out) == len(prompt) + 16, "self-extend: wrong token count")
    rec.update({"cells": n, "max_position": max(pos), "positions_equal_formula": True})
    return rec


def phase_spec(torch, model, smi_line: str) -> None:
    """Phase 4g, the decode variants on the card (see the module
    docstring); each engine's record carries its launch counts."""
    import gc

    from superllama_tpu_torch.runtime.engine import Engine

    t_phase = time.perf_counter()
    parts, last = {}, [t_phase]

    def lap(name: str) -> None:      # seconds of each part of the phase
        now = time.perf_counter()
        parts[name], last[0] = now - last[0], now

    n_vocab = model.hparams.n_vocab
    prompts, lk_prompts = spec_prompts(n_vocab), repeated_prompts(n_vocab)
    # the draft no deeper than the target (the whole run's target is cut)
    draft = build_draft(torch, min(DRAFT_1B["n_layer"], model.hparams.n_layer))
    base = plain_baselines(torch, model, prompts, lk_prompts)
    lap("draft and plain baselines")
    recs = []
    # the bf16 engine with the 1B draft behind the HTTP server
    rec = spec_http(torch, model, draft, prompts, base["bf16"]["tokens"])
    recs.append({"phase": "spec", "engine": SPEC_ENGINES[0][0], **rec})
    lap(SPEC_ENGINES[0][0] + " (server, warm-up, HTTP and engine waves)")
    gc.collect()
    torch.cuda.empty_cache()
    for label, kw, which, k, roll, ver, start in SPEC_ENGINES[1:]:
        dm = draft if which == "1b" else model
        eng = Engine(model, n_slots=4, n_ctx=2048, device="cuda", draft_model=dm, n_draft=k,
                     **kw)
        cache = "paged" if eng.paged else ("q8_0" if kw.get("kv_dtype") == "q8_0" else "bf16")
        eng.start()
        rec = spec_engine_run(torch, model, eng, label, prompts, base[cache]["tokens"], roll,
                              ver, (start,), DRAFT_TOKENS if which == "1b" else SPEC_TOKENS)
        eng.stop()
        recs.append({"phase": "spec", "engine": label, **rec})
        lap(label)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # a draft of another vocab: the target with a 128,256-piece tokenizer
    tok = grammar_tokenizer(n_vocab)
    tmodel = type(model)(**{**vars(model), "tokenizer": tok})
    eng = Engine(tmodel, n_slots=4, n_ctx=2048, device="cuda",
                 draft_model=byte_draft(torch, draft), n_draft=7)
    check(eng.spec_translator is not None, "a draft of another vocab got no translator")
    eng.start()
    rec = spec_engine_run(torch, model, eng, "bf16-bytes-k7", prompts, base["bf16"]["tokens"],
                          (), ("qmm",), ("fa_tc",), DRAFT_TOKENS)
    eng.stop()
    recs.append({"phase": "spec", "engine": "bf16-bytes-k7", **rec})
    lap("bf16-bytes-k7")
    del eng, tmodel
    for label, kw, ver in (("bf16", {}, ()), ("paged", SPEC_CACHES["paged"], ("paged_tc",))):
        eng = Engine(model, n_slots=4, n_ctx=2048, device="cuda", lookup_ngrams=8, **kw)
        eng.start()
        rec = spec_engine_run(torch, model, eng, f"lookup-{label}", lk_prompts,
                              base[label]["lookup_tokens"], (), ver, ())
        eng.stop()
        check(rec["n_spec_drafted"] > 0, f"lookup {label}: nothing drafted")
        recs.append({"phase": "lookup", "engine": label, **rec})
        lap(f"lookup-{label}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for r in recs:
        r["card"] = smi_line
        emit(r)
    shifts = shift_runs(torch, model)
    lap("context shift")
    la = lookahead_run(torch, model)
    lap("lookahead")
    emit({**la, "card": smi_line})
    se = self_extend_run(torch, model)
    lap("self-extend")
    emit({**se, "card": smi_line})
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    summary = {"phase": "variants", "card": smi_line, "seconds": time.perf_counter() - t_phase,
               "plain": {k: {"tok_s_b4": v["tok_s_b4"], "tok_s_b1": v["tok_s_b1"]}
                         for k, v in base.items()},
               "spec": {r["engine"]: {"tok_s_b4": r["tok_s_b4"], "tok_s_b1": r["tok_s_b1"],
                                      "accept_rate": r["accept_rate"], **r["b4"]}
                        for r in recs},
               "shift_ms": {r["kv"]: r["shift_ms"][0] for r in shifts},
               "paged_shift_ms": shifts[-1].get("paged_shift_ms", [None])[0],
               "lookahead_tok_s": la["tok_s"], "seconds_by_part": parts}
    summary["spec"] = {k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                       for k, v in summary["spec"].items()}
    emit(summary)


# ------------------------------------------------------------ 3b / 4i. weight formats

# the twenty formats the kernels read beyond Q8_0, Q4_K and Q6_K
NEW_FORMATS = ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "MXFP4", "IQ4_NL", "IQ4_XS", "IQ2_XXS",
               "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S", "IQ1_M", "Q2_K", "Q3_K",
               "Q5_K", "Q8_K", "TQ1_0", "TQ2_0")
FORMAT_KN = [(4096, 14336), (14336, 4096)]   # the 8B's gate/up and down
# each family's format on the main path (the serving mixes) and in the
# kernels' record
FAMILY_FORMAT = {"i8": "IQ4_XS", "nib": "Q4_0", "q5k": "Q5_K"}
MIX_FAMILY = {"Q4_0": "nib", "Q5_K_M": "q5k", "IQ4_XS": "i8"}
_FORMAT_CPU: dict = {}   # (format, K, N) -> the port's repack of rand_raw bytes, on the CPU
# a format of each family, group size and adds (the three the mixes and the
# 1B-width file serve among them), also at every other (K, N) of those
# paths: the 8B's q/o and k/v, the 1B's four (its head is Q6_K), at the
# rows phase 4i gives them (decode 1-8, qmv's 16-row tile, chunks to 32)
SHAPE_FORMATS = ("Q4_0", "Q5_K", "IQ4_XS", "Q4_1", "Q5_1", "Q2_K", "IQ1_M", "Q8_K")
SHAPE_KN = [(4096, 4096), (4096, 1024)] + KN_1B[:4]
SHAPE_ROWS = ((1, 5, 8, 16), (17, 32))   # qmv's, qmm's
# a format of each family and group size (with and without adds), for the edge shapes
EDGE_FORMATS = ("Q5_0", "Q5_1", "Q3_K", "Q2_K", "IQ1_M", "Q8_K", "Q4_0", "Q4_1", "Q5_K")


def format_family(name: str) -> str:
    from superllama_tpu_torch.gguf.constants import GGMLType
    from superllama_tpu_torch.ops import qmatmul as qm

    t = GGMLType[name]
    return qm._FAMILY[qm.family(t, qm._FMT[t])]


def qmv_format(name: str) -> int:
    """The qmv kernel's format (csrc/qmv.cu FMT) of a type."""
    from superllama_tpu_torch.gguf.constants import GGMLType
    from superllama_tpu_torch.ops import qmatmul as qm

    return qm.qmv_fmt(qm._FMT[GGMLType[name]])


def wire_bpw(name: str) -> float:
    from superllama_tpu_torch.gguf.constants import GGML_TYPE_TRAITS, GGMLType

    tr = GGML_TYPE_TRAITS[GGMLType[name]]
    return tr.type_size * 8 / tr.block_size


def format_weights(kn, names=NEW_FORMATS) -> float:
    """Seeded random GGUF bytes (``rand_raw``) of each named format at each
    (K, N), through the port's ``repack`` on a pool of threads (numpy's
    array work releases the GIL); kept on the CPU for the later phases.
    Returns the seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from superllama_tpu_torch.gguf.constants import GGMLType
    from superllama_tpu_torch.models.synthetic import rand_raw
    from superllama_tpu_torch.ops.qtensor import repack

    def make(key):
        name, K, N = key
        t = GGMLType[name]
        return key, repack(rand_raw(t, N, K, SEED + 40), t, (N, K))

    todo = [(n, K, N) for n in names for K, N in kn if (n, K, N) not in _FORMAT_CPU]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        _FORMAT_CPU.update(ex.map(make, todo))
    return time.perf_counter() - t0


def on_card(qt, clone: bool = False):
    """A QTensor's planes on the card (copies of card planes with clone)."""
    import dataclasses

    return dataclasses.replace(qt, **{n: (p.clone() if clone else p.to("cuda"))
                                      for n, p in qt.planes().items()})


def check_format_kernels(torch, record) -> None:
    """Every new format through qmv (M 1, 8, 16) and qmm (M 17, 32), bf16 and
    f32 x, at the 8B's gate/up and down shapes, and SHAPE_FORMATS at SHAPE_KN
    and SHAPE_ROWS, against their plain versions: the weights are the port's
    repack of rand_raw bytes; each call must launch its family's kernel,
    and two calls give the same bits. At M 33 (the plain dequantize +
    torch.matmul) one format of each family, its dequantized weight
    bit-equal to the CPU's and the product within NMSE 1e-9 of the CPU's
    f32 product."""
    from superllama_tpu_torch.ops import qmatmul as qm
    from superllama_tpu_torch.ops.qtensor import dequant_qtensor

    repack_s = format_weights(FORMAT_KN) + format_weights(SHAPE_KN, SHAPE_FORMATS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 30)
    bf16, f32 = torch.bfloat16, torch.float32

    def cell(name, qt, K, N, qmv_rows, qmm_rows) -> None:
        fam = format_family(name)
        for kernel, fn, plain, rows in (("qmv", qm.qmv, qm.qmv_plain, qmv_rows),
                                        ("qmm", qm.qmm, qm.qmm_plain, qmm_rows)):
            for M in rows:
                for dt in (bf16, f32):
                    x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                    case = f"{name} M={M} K={K} N={N} {str(dt)[6:]}"
                    before = getattr(fn, f"launches_{fam}")
                    got = fn(x, qt, dt)
                    again = fn(x, qt, dt)
                    torch.cuda.synchronize()
                    check(getattr(fn, f"launches_{fam}") - before == 2,
                          f"{kernel} {case}: the {fam} kernel did not launch")
                    check(torch.equal(got, again), f"{kernel}_{fam} {case}: two calls differ")
                    record(f"{kernel}_{fam}", case, got, plain(x, qt, dt), dt)

    dispatch = {}
    for name in NEW_FORMATS:
        fam = format_family(name)
        for K, N in FORMAT_KN:
            cpu = _FORMAT_CPU[(name, K, N)]
            qt = on_card(cpu)
            cell(name, qt, K, N, (1, 8, 16), SHAPE_ROWS[1])
            if fam not in dispatch and K == 4096:
                x = torch.randn((33, K), generator=gen, device="cuda")
                w_cpu = dequant_qtensor(cpu)
                check(torch.equal(dequant_qtensor(qt).cpu(), w_cpu),
                      f"{name}: the card's dequantized weight differs from the CPU's")
                before = (qm.qmv.launches, qm.qmm.launches)
                got = qm.qmatmul(x, qt)
                check((qm.qmv.launches, qm.qmm.launches) == before,
                      f"{name} M 33: a kernel launched on the dequantize + matmul path")
                dispatch[fam] = {"format": name,
                                 "nmse_vs_cpu": nmse(got.cpu(), x.cpu() @ w_cpu)}
                check(dispatch[fam]["nmse_vs_cpu"] < 1e-9, f"{name} M 33: {dispatch[fam]}")
            del qt
    n_shape = 0
    for name in SHAPE_FORMATS:
        for K, N in SHAPE_KN:
            cell(name, on_card(_FORMAT_CPU[(name, K, N)]), K, N, *SHAPE_ROWS)
            n_shape += 2 * sum(map(len, SHAPE_ROWS))
    # the edges at small shapes, in f32 (qmm in bf16 too): partial column
    # tiles, K of 17 groups (the 32-element formats), qmm row tiles past 32,
    # for a format of each family and group size
    from superllama_tpu_torch.gguf.constants import GGML_TYPE_TRAITS, GGMLType
    from superllama_tpu_torch.models.synthetic import rand_raw
    from superllama_tpu_torch.ops.qtensor import repack

    n_edge = 0
    for name in EDGE_FORMATS:
        t = GGMLType[name]
        fam = format_family(name)
        for M, K, N in EDGE_SHAPES:
            if K % GGML_TYPE_TRAITS[t].block_size:
                continue
            qt = on_card(repack(rand_raw(t, N, K, SEED + 41), t, (N, K)))
            for kernel, fn, plain, dts in (("qmv", qm.qmv, qm.qmv_plain, (f32,) if M <= 16 else ()),
                                           ("qmm", qm.qmm, qm.qmm_plain, (f32, bf16))):
                for dt in dts:
                    x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                    got = fn(x, qt, dt)
                    torch.cuda.synchronize()
                    record(f"{kernel}_{fam}", f"{name} M={M} K={K} N={N} {str(dt)[6:]}", got,
                           plain(x, qt, dt), dt)
                    n_edge += 1
    emit({"phase": "format_kernels", "formats": len(NEW_FORMATS), "repack_s": repack_s,
          "dispatch_m33": dispatch, "shape_checks": n_shape, "edge_checks": n_edge,
          "row_checks": check_format_rows(torch), "qmm_row_checks": check_qmm_rows(torch)})


# a format of each of qmm's planar layouts and of layout 0's other formats
# (IQ4_XS 0, Q5_1 3, Q2_K 4 with adds, Q3_K 4, IQ1_M 5, Q8_K 6, Q4_0 and Q4_1
# 7, Q5_K 8): their row checks at every served shape (Q3_K at the 8B's
# gate/up and down, the others at SHAPE_KN too)
QMM_ROW_FORMATS = SHAPE_FORMATS + ("Q3_K",)


def check_qmm_rows(torch) -> int:
    """qmm's sums run in an order fixed by (layout, K, N): for
    QMM_ROW_FORMATS at the 8B's gate/up and down and every SHAPE_KN (Q3_K
    at the first two), row 0 of an M 32 call equals row 0 of an M 17 call,
    bit for bit (bf16 x and output). Returns the checks made."""
    from superllama_tpu_torch.ops.qmatmul import qmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 22)
    bf16 = torch.bfloat16
    n = 0
    for name in QMM_ROW_FORMATS:
        for K, N in FORMAT_KN + (SHAPE_KN if name in SHAPE_FORMATS else []):
            qt = on_card(_FORMAT_CPU[(name, K, N)])
            x = torch.randn((32, K), generator=gen, device="cuda").to(bf16)
            got17, got32 = qmm(x[:17], qt, bf16), qmm(x, qt, bf16)
            torch.cuda.synchronize()
            check(torch.equal(got17[0], got32[0]), f"qmm {name} K={K} N={N}: row 0 of an M 32 "
                  f"call differs from row 0 of an M 17 call")
            n += 1
            del qt
    return n


def check_qmm_resident(torch) -> None:
    """Each instantiation of qmm_tc_kernel (``_QMM_INSTANCES``) at two
    blocks an SM on the card (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    at the shared bytes ``_qmm_smem`` mirrors."""
    import ctypes

    from superllama_tpu_torch.ops import _build
    from superllama_tpu_torch.ops import qmatmul as qm

    fn = _build.load("qmm").slt_qmm_resident
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    card = {}
    for fmt, adds in qm._QMM_INSTANCES:
        smem = ctypes.c_int(0)
        blocks = fn(fmt, int(adds), ctypes.addressof(smem))
        stages, mirror = qm._qmm_smem(fmt, adds)
        card[f"{fmt}{'+adds' if adds else ''}"] = {"blocks_per_sm": blocks, "smem": smem.value,
                                                  "stages": stages}
        check(blocks >= 2 and smem.value == mirror,
              f"qmm layout {fmt} adds {adds}: {blocks} blocks an SM at {smem.value} shared "
              f"bytes (the plan assumes 2; _qmm_smem mirrors {mirror})")
    emit({"phase": "qmm_resident", "card": card})


def check_format_rows(torch) -> int:
    """check_qmv_rows for SHAPE_FORMATS, a format of each of qmv's kernel
    formats beyond Q4_K and Q6_K (IQ4_XS Q8_0's, Q5_1 adds, Q2_K gs 16,
    IQ1_M gs 8, Q8_K gs 256, Q4_0 and Q4_1 nibbles, Q5_K): at the 8B's
    gate/up and down and every SHAPE_KN, row 0 of an M 8 and an M 16 call
    equals the row alone, bit for bit. Returns the checks made."""
    from superllama_tpu_torch.ops.qmatmul import qmv

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    bf16 = torch.bfloat16
    n = 0
    for name in SHAPE_FORMATS:
        for K, N in FORMAT_KN + SHAPE_KN:
            qt = on_card(_FORMAT_CPU[(name, K, N)])
            x = torch.randn((16, K), generator=gen, device="cuda").to(bf16)
            alone = qmv(x[:1], qt, bf16)
            for M in (8, 16):
                got = qmv(x[:M], qt, bf16)
                torch.cuda.synchronize()
                check(torch.equal(got[0], alone[0]), f"qmv {name} K={K} N={N}: row 0 of an "
                      f"M {M} call differs from the row alone")
                n += 1
            del qt
    return n


def check_one_kernel_a_call(torch) -> None:
    """One qmv call is one device kernel, ``qmv_kernel`` (no quantizer, no
    reduce kernel), and each type's bf16 qmm call runs its layout's
    qmm_tc_kernel instantiation (``qmv_fmt``, with an adds plane or
    without), then qmm_reduce where qmm_plan splits K. Under one
    torch.profiler window (a second one has shown no device ops), each call
    synchronised: an M 8 qmv call at the 8B's gate/up for Q4_K and for each
    of SHAPE_FORMATS (a format of each kernel format and family) shows
    exactly that many device ops, all of them qmv's kernel; then an M 32
    qmm call of each of the 23 types there shows exactly the sequence of
    its instantiations (and reduces)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from superllama_tpu_torch.gguf.constants import GGMLType
    from superllama_tpu_torch.ops import qmatmul as qm

    K, N = FORMAT_KN[0]
    weights = [rand_weight(torch, "Q4_K", N, K, 320)]
    weights += [on_card(_FORMAT_CPU[(name, K, N)]) for name in SHAPE_FORMATS]
    names = ("Q8_0", "Q4_K", "Q6_K") + NEW_FORMATS
    mm_weights = [on_card(_FORMAT_CPU[(name, K, N)]) if name in NEW_FORMATS
                  else rand_weight(torch, name, N, K, 340) for name in names]
    split = qm.qmm_plan(K, N)[0] > 1
    expect = []
    for name, qt in zip(names, mm_weights):
        expect += [(qm.qmv_fmt(qm._FMT[GGMLType[name]]), qt.adds is not None)]
        expect += [None] if split else []
    x = torch.randn((32, K), device="cuda").to(torch.bfloat16)
    for qt in weights:
        qm.qmv(x[:8], qt, torch.bfloat16)
    for qt in mm_weights:
        qm.qmm(x, qt, torch.bfloat16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for qt in weights:
            qm.qmv(x[:8], qt, torch.bfloat16)
            torch.cuda.synchronize()
        for qt in mm_weights:
            qm.qmm(x, qt, torch.bfloat16)
            torch.cuda.synchronize()
    seq = [e.name for e in sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                                  key=lambda e: e.time_range.start)]
    mv, mm = seq[:len(weights)], seq[len(weights):]
    check(len(mv) == len(weights) and all("qmv_kernel" in k for k in mv),
          f"{len(weights)} qmv calls (Q4_K, {', '.join(SHAPE_FORMATS)}) ran these device "
          f"ops: {mv}")

    def instance(key: str):
        m = (re.search(r"qmm_tc_kernel<(\d+), ?(true|false)>", key)
             or re.search(r"qmm_tc_kernelILi(\d+)ELb([01])E", key))
        if m:
            return int(m.group(1)), m.group(2) in ("true", "1")
        return None if "qmm_reduce" in key else key

    got = [instance(k) for k in mm]
    check(got == expect, f"{len(names)} qmm calls ({', '.join(names)}) ran these device ops "
          f"{got}, not their layouts' instantiations {expect}")
    emit({"phase": "one_kernel_a_call", "qmv_calls": len(weights), "qmm_calls": len(names),
          "qmv_kernels": sorted(set(k[:60] for k in mv)),
          "qmm_kernels": sorted(set(k[:60] for k in mm))})


def format_reading(torch, fn, plain, qt, label: str, M: int, ops_kind: str) -> dict:
    """fn (qmv or qmm) at M rows, bf16 x and output, over card copies of qt
    past the L2, beside torch.matmul on its dequantized bf16 weight (as
    matmul_reading). The bound counts the bytes the kernel reads: the
    repacked planes (``QTensor.nbytes``), x and the output."""
    from superllama_tpu_torch.ops.qtensor import dequant_qtensor

    K, N = qt.K, qt.N
    copies = [qt] + [on_card(qt, clone=True) for _ in range(1, n_copies(qt.nbytes, 6))]
    dense = [dequant_qtensor(qt, torch.bfloat16)]
    dense += [dense[0].clone() for _ in range(1, n_copies(K * N * 2))]
    x = torch.randn((M, K), device="cuda").to(torch.bfloat16)
    row = kernel_reading(
        torch, f"{label} M={M} K={K} N={N} bf16",
        lambda i: fn(x, copies[i % len(copies)], torch.bfloat16),
        lambda i: plain(x, copies[i % len(copies)], torch.bfloat16),
        lambda i: torch.matmul(x, dense[i % len(dense)]),
        max(12, len(copies), len(dense)), qt.nbytes + x.numel() * 2 + M * N * 2,
        2.0 * M * K * N, ops_kind)
    row.update(bytes_per_weight=qt.nbytes / (K * N), group=qt.group)
    del copies, dense
    return row


def time_formats(torch, names=NEW_FORMATS, m1: bool = True) -> dict:
    """qmv at M 8 (and M 1 with m1) and qmm at M 32 on the 8B's gate/up (K
    4096, N 14336) for each format, each row with its wire bits a weight
    beside the bytes the kernel reads."""
    from superllama_tpu_torch.ops.qmatmul import qmm, qmm_plain, qmv, qmv_plain

    format_weights(FORMAT_KN[:1], names)
    out = {}
    for name in names:
        qt = on_card(_FORMAT_CPU[(name, 4096, 14336)])
        for key, fn, plain, M, kind in (("qmv", qmv, qmv_plain, 8, "int8"),
                                        ("qmv M=1", qmv, qmv_plain, 1, "int8"),
                                        ("qmm", qmm, qmm_plain, 32, "bf16")):
            if M == 1 and not m1:
                continue
            row = format_reading(torch, fn, plain, qt, name, M, kind)
            row.update(family=format_family(name), wire_bpw=wire_bpw(name))
            out[f"{key} {name}"] = row
        del qt
    for fam, name in FAMILY_FORMAT.items():
        if name in names:
            out[f"qmv_{fam}"], out[f"qmm_{fam}"] = out[f"qmv {name}"], out[f"qmm {name}"]
    return out


# a format of each of qmm's nine layouts (ops/qmatmul.py::qmv_fmt; Q4_1 is
# layout 7 with adds): qmm's shape rows
QMM_SHAPE_FORMATS = ("IQ4_XS", "Q4_K", "Q6_K", "Q5_1", "Q2_K", "IQ1_M", "Q8_K", "Q4_0", "Q4_1",
                     "Q5_K")


def time_qmm_shapes(torch) -> dict:
    """qmm at M 17 and M 32 (bf16 x and output) for QMM_SHAPE_FORMATS at
    every served (K, N): the 8B's gate/up, down, q/o, k/v and the 1B's
    four, each row with its layout, its plan and its launches in a lone
    32-token chunk of a model of that format (the 8B's shapes)."""
    from superllama_tpu_torch.gguf.constants import GGMLType
    from superllama_tpu_torch.ops import qmatmul as qm

    format_weights(FORMAT_KN + SHAPE_KN, [n for n in QMM_SHAPE_FORMATS if n in NEW_FORMATS])
    out = {}
    for name in QMM_SHAPE_FORMATS:
        for K, N in FORMAT_KN + SHAPE_KN:
            qt = (on_card(_FORMAT_CPU[(name, K, N)]) if name in NEW_FORMATS
                  else rand_weight(torch, name, N, K, 350))
            for M in SHAPE_ROWS[1]:
                row = format_reading(torch, qm.qmm, qm.qmm_plain, qt, name, M, "bf16")
                row.update(layout=qm.qmv_fmt(qm._FMT[GGMLType[name]]), plan=qm.qmm_plan(K, N),
                           launches_per_chunk=CHUNK_LAUNCHES.get((K, N), 0))
                out[f"qmm {name} M={M} K={K} N={N}"] = row
            del qt
    return out


def time_qmm_plans(torch, names=QMM_SHAPE_FORMATS) -> dict:
    """qmm at M 32 (bf16 x and output) for each named format at every served
    (K, N) under qmm_plan's split and under each split of a power-of-two
    count of k-tiles a split: device ms a call from a CUDA graph over
    copies past the L2. Each row: the plan, its time, the fastest split and
    its time, and their ratio."""
    from superllama_tpu_torch.ops import qmatmul as qm

    format_weights(FORMAT_KN + SHAPE_KN, [n for n in names if n in NEW_FORMATS])
    x = torch.randn((32, 14336), device="cuda").to(torch.bfloat16)
    plan = qm.qmm_plan
    out = {}
    for name in names:
        for K, N in FORMAT_KN + SHAPE_KN:
            qt = (on_card(_FORMAT_CPU[(name, K, N)]) if name in NEW_FORMATS
                  else rand_weight(torch, name, N, K, 360))
            copies = [qt] + [on_card(qt, clone=True) for _ in range(1, n_copies(qt.nbytes, 6))]
            xs = x[:, :K].contiguous()
            call = lambda i: qm.qmm(xs, copies[i % len(copies)], torch.bfloat16)
            reps = max(12, len(copies))
            n_tiles = -(-K // qm._QMM_BK)
            splits = {plan(K, N)} | {(-(-n_tiles // per), per) for per in
                                     (1 << i for i in range(n_tiles.bit_length()))}
            times = []
            for sp in sorted(splits):
                qm.qmm_plan = lambda k, n, sp=sp: sp
                try:
                    times.append((graph_ms(torch, call, reps), list(sp)))
                finally:
                    qm.qmm_plan = plan
            p0 = list(plan(K, N))
            ms = next(t for t, sp in times if sp == p0)
            best = min(times)
            out[f"{name} K={K} N={N}"] = {"plan": p0, "ms": ms, "best": best[1],
                                          "ms_best": best[0], "plan_over_best": ms / best[0],
                                          "all": times}
            del copies, qt
    return out


def time_qmv_clusters(torch, names=SHAPE_FORMATS, sweep: bool = False) -> dict:
    """qmv at M 8 (bf16 x and output) for each named format at the 8B's
    gate/up, down, q/o, k/v and the 1B's four shapes, under its plan and
    under the best plan without a cluster (qmv_plan with clusters of at
    most 1): device ms a call from a CUDA graph over copies past the L2.
    Each row: both plans, both times, and their ratio. With ``sweep``,
    every other grid too (each column tile and cluster size with no empty
    rank and at least 96 blocks, or the most there are), each row then
    naming the fastest; the full sweep goes to chiprun_out/qmv_plans.json."""
    from superllama_tpu_torch.ops import qmatmul as qm

    format_weights(FORMAT_KN + SHAPE_KN, [n for n in names if n in NEW_FORMATS])
    x = torch.randn((8, 14336), device="cuda").to(torch.bfloat16)
    out, full = {}, {}
    plan = qm.qmv_plan
    for name in names:
        fmt = qmv_format(name)
        for K, N in FORMAT_KN + SHAPE_KN:
            key = (name, K, N)
            qt = (on_card(_FORMAT_CPU[key]) if name in NEW_FORMATS
                  else rand_weight(torch, name, N, K, 330))
            copies = [qt] + [on_card(qt, clone=True) for _ in range(1, n_copies(qt.nbytes, 6))]
            xs = x[:, :K].contiguous()
            call = lambda i: qm.qmv(xs, copies[i % len(copies)], torch.bfloat16)
            reps = max(12, len(copies))
            p0 = plan(fmt, K, N)
            row = {"fmt": fmt, "plan": list(p0[:4]), "ms": graph_ms(torch, call, reps)}
            most = qm._QMV_MAX_CLUSTER
            qm._QMV_MAX_CLUSTER = 1
            try:
                row["plan_cl1"] = list(qm.qmv_plan(fmt, K, N)[:4])
                row["ms_cl1"] = graph_ms(torch, call, reps)
            finally:
                qm._QMV_MAX_CLUSTER = most
            row["cl1_over_plan"] = row["ms_cl1"] / row["ms"]
            if sweep:
                n_units = K // qm._QMV_UNIT[fmt]
                grids = []
                for bn in qm._QMV_TILES:
                    for cl in range(1, min(8, n_units) + 1):
                        per = -(-n_units // cl)
                        if -(-n_units // per) == cl:
                            grids.append(qm.QmvPlan(bn, cl, per, -(-N // bn) * cl, p0.smem))
                least = min(96, max(g.blocks for g in grids))
                times = []
                for g in grids:
                    if g.blocks < least:
                        continue
                    qm.qmv_plan = lambda f, k, n, g=g: g
                    try:
                        times.append((graph_ms(torch, call, reps), list(g[:4])))
                    finally:
                        qm.qmv_plan = plan
                times.sort()
                row["best"], row["ms_best"] = times[0][1], times[0][0]
                row["plan_over_best"] = row["ms"] / row["ms_best"]
                full[f"{name} K={K} N={N}"] = times
            out[f"{name} K={K} N={N}"] = row
            del copies, qt
    if sweep:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "qmv_plans.json"), "w") as f:
            json.dump(full, f)
    return out


def time_base_formats(torch) -> dict:
    """The three redesigned formats' rows at the same shapes (qmv M 8, qmm
    M 32, gate/up), for comparing a tree with its parent in one call."""
    from superllama_tpu_torch.ops.qmatmul import qmm, qmm_plain, qmv, qmv_plain

    out = {}
    for kind in ("Q8_0", "Q4_K", "Q6_K"):
        out[f"qmv {kind}"] = matmul_reading(torch, qmv, qmv_plain, kind, 8, 4096, 14336, "int8")
        out[f"qmm {kind}"] = matmul_reading(torch, qmm, qmm_plain, kind, 32, 4096, 14336, "bf16")
    return out


def phase_mixes(torch, smi_line: str) -> dict:
    """The 8B-width model in the Q4_0, Q5_K_M and IQ4_XS mixes (weights made
    on the card in repack's layout, ``MIXES``) at CUT_LAYERS, each on a
    bf16 dense cache of 8 slots: greedy and sampled waves over HTTP equal to the engine's
    (serve_wave, no warm-up: the graphs are captured as the waves reach
    their keys), its family's qmv and qmm launched, a full-width forward
    within NMSE 1e-3 of the plain versions, then decode tok/s at B 1 and
    B 8 and the TTFTs (time_serving). Returns the families' launches."""
    import gc

    launches = {}
    for mix, fam in MIX_FAMILY.items():
        t0 = time.perf_counter()
        model = build_model(torch, mix, n_layer=CUT_LAYERS)
        build_s = time.perf_counter() - t0
        params = model.params
        weight_bytes = (sum(w.nbytes for layer in params["layers"] for w in layer.values()
                            if hasattr(w, "planes")) + params["output"].nbytes)
        counts, _ = serve_wave(torch, model, mix, [32, 100] * 4,
                               ("qmv", "qmm", "fa_tc", f"qmv_{fam}", f"qmm_{fam}"),
                               kv_dtype=torch.bfloat16, warmup=False)
        launches.update({k: counts[k] for k in (f"qmv_{fam}", f"qmm_{fam}")})
        phase_parity(torch, model, mix)
        t = time_serving(torch, model, sampled=False)   # the sampled wave is served above
        emit({"phase": "mix", "mix": mix, "card": smi_line, "build_s": build_s,
              "weight_bytes": weight_bytes,
              "embd_bytes": params["token_embd"].numel() * params["token_embd"].element_size(),
              **{k: t[k] for k in ("decode_tok_s_b1", "decode_tok_s_b8", "ttft_ms_prompt32",
                                   "ttft_ms_prompt1000", "launches_per_decode_step",
                                   "launches_per_prefill_chunk_32")},
              "seconds": time.perf_counter() - t0})
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# the Llama-3.2-1B-width GGUF file's types by tensor role
FILE_TYPES = {"attn_q": "Q4_0", "attn_k": "Q4_0", "attn_v": "Q5_K", "attn_output": "Q4_0",
              "ffn_gate": "Q4_0", "ffn_up": "IQ4_XS", "ffn_down": "Q5_K",
              "output": "Q6_K", "token_embd": "Q4_0"}


def weight_shapes(hp, tied: bool = False, experts: tuple[int, int] | None = None) -> dict:
    """{GGUF tensor name: (role, N, K)} of a llama of hp's widths (without
    output.weight when ``tied``); with ``experts`` (n, width) the FFN is
    the three expert banks, (role, n·out, in, n) each: n experts' rows in
    one block of bytes."""
    E, F, V = hp.n_embd, hp.n_ff, hp.n_vocab
    qd, kvd = hp.n_head * hp.head_dim, hp.n_head_kv * hp.head_dim
    shapes = {"token_embd.weight": ("token_embd", V, E)}
    if not tied:
        shapes["output.weight"] = ("output", V, E)
    if experts is None:
        ffn = (("ffn_gate", F, E), ("ffn_up", F, E), ("ffn_down", E, F))
    else:
        n, f = experts
        ffn = (("ffn_gate_exps", n * f, E, n), ("ffn_up_exps", n * f, E, n),
               ("ffn_down_exps", n * E, f, n))
    for il in range(hp.n_layer):
        for role, *dims in (("attn_q", qd, E), ("attn_k", kvd, E), ("attn_v", kvd, E),
                            ("attn_output", E, qd), *ffn):
            shapes[f"blk.{il}.{role}.weight"] = (role, *dims)
    return shapes


def model_writer(path: str, hp, tok, name: str, arch: str = "llama", keys=None,
                 ffn_norm: bool = True):
    """A GGUFWriter holding a model's metadata (hp's widths under ``arch``,
    ``keys`` added or overriding (a "tokenizer." key as it is), tok's
    vocab) and its F32 norms (ones;
    without ffn_norm when ``ffn_norm`` is False); the caller adds the matmul
    weights and writes."""
    import numpy as np

    from superllama_tpu_torch.gguf import GGUFWriter

    E = hp.n_embd
    w = GGUFWriter(path, arch=arch)
    meta = {"context_length": 8192, "embedding_length": E, "block_count": hp.n_layer,
            "feed_forward_length": hp.n_ff, "attention.head_count": hp.n_head,
            "attention.head_count_kv": hp.n_head_kv,
            "attention.layer_norm_rms_epsilon": hp.rms_eps,
            "rope.freq_base": hp.rope_freq_base, "rope.dimension_count": hp.n_rot,
            "vocab_size": hp.n_vocab, **(keys or {})}
    for key, v in meta.items():
        w.add(key if key.startswith("tokenizer.") else f"{arch}.{key}", v)
    w.add("general.name", name)
    add_vocab(w, tok)
    ones = np.ones(E, np.float32)
    w.add_tensor("output_norm.weight", ones)
    for il in range(hp.n_layer):
        w.add_tensor(f"blk.{il}.attn_norm.weight", ones)
        if ffn_norm:
            w.add_tensor(f"blk.{il}.ffn_norm.weight", ones)
    return w


def add_vocab(w, tok) -> None:
    """tok's byte-level vocab (no merges) into the GGUFWriter w."""
    v = tok.vocab
    w.add("tokenizer.ggml.model", v.model)
    w.add("tokenizer.ggml.pre", v.pre)
    w.add("tokenizer.ggml.tokens", list(v.tokens))
    w.add("tokenizer.ggml.token_type", [int(a) for a in v.attrs])
    w.add("tokenizer.ggml.merges", [])
    w.add("tokenizer.ggml.bos_token_id", v.bos_id)
    w.add("tokenizer.ggml.eos_token_id", v.eos_id)
    w.add("tokenizer.ggml.add_bos_token", True)


def rand_raws(shapes: dict, types: dict, shared_layers: bool) -> dict:
    """{tensor name: (type, rand_raw bytes, (N, K))} of ``shapes`` ({name:
    (role, N, K[, n])}) in ``types``' formats by role, made on a pool of
    threads; with ``shared_layers`` every layer's tensor of a name holds the
    bytes of layer 0's (rand_raw makes about 0.2 GB/s on one core): the
    names that differ only in a "blk.<n>." part (T5's "enc.blk.<n>." too);
    every other tensor has bytes of its own."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    from superllama_tpu_torch.gguf import GGMLType
    from superllama_tpu_torch.models.synthetic import rand_raw

    key = ((lambda n: re.sub(r"(^|\.)blk\.\d+\.", r"\1blk.", n)) if shared_layers
           else (lambda n: n))
    first = {}                      # each set of bytes -> the first tensor holding it
    for n in shapes:
        first.setdefault(key(n), n)

    def make(item):
        i, (k, n) = item
        role, N, K = shapes[n][:3]
        t = GGMLType[types[role]]
        return k, (t, rand_raw(t, N, K, SEED + 50 + i), (N, K))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        made = dict(ex.map(make, enumerate(first.items())))
    return {n: made[key(n)] for n in shapes}


def add_raws(w, shapes: dict, raws: dict) -> None:
    """``rand_raws``' tensors into the GGUFWriter w (an expert bank's n
    experts as one (K, N / n, n) tensor)."""
    for n, (t, raw, (N, K)) in raws.items():
        n_exp = shapes[n][3] if len(shapes[n]) > 3 else 0
        w.add_tensor(n, raw, t, raw_ne=(K, N // n_exp, n_exp) if n_exp else (K, N))


def write_file_model(path: str, hp, tok, types=None, name="synthetic-llama3.2-1b-mixed",
                     shared_layers: bool = False, arch: str = "llama", keys=None,
                     ffn_norm: bool = True, tied: bool = False, experts=None,
                     f32_tensors=None, shapes=None) -> dict:
    """A GGUF of hp's widths under ``arch`` (``model_writer``'s ``keys`` and
    ``ffn_norm``; no output.weight when ``tied``), ``types``' formats by
    role (default FILE_TYPES) of rand_raw bytes (norms F32 ones), and tok's
    vocab, written by the port's GGUFWriter; with ``shared_layers`` every
    layer holds the bytes of layer 0 (rand_raw makes about 0.2 GB/s on one
    core). ``experts`` (n, width): the FFN is three (n, out, in) expert
    banks (``weight_shapes``), each of rand_raw bytes of its n·out rows in
    the ``*_exps`` roles' types (MXFP4 included); ``f32_tensors`` {name:
    array} are added as they are (routers, q/k norms, biases). ``shapes``
    ({name: (role, N, K[, n])}, as ``weight_shapes`` gives them) replaces
    the llama's tensor set (MLA, shared experts). Returns {tensor name:
    (type, raw bytes, (N, K))} of the quantized ones."""
    shapes = shapes or weight_shapes(hp, tied, experts)
    raws = rand_raws(shapes, types or FILE_TYPES, shared_layers)
    w = model_writer(path, hp, tok, name, arch, keys, ffn_norm)
    add_raws(w, shapes, raws)
    for n, a in (f32_tensors or {}).items():
        w.add_tensor(n, a)
    w.write()
    return raws


def phase_gguf_file(torch, smi_line: str) -> dict:
    """A real file on the card: a Llama-3.2-1B-width GGUF (16 layers, 2048
    wide, 32/8 heads of 64, FFN 8192, vocab 128,256) of Q4_0 and Q5_K
    blocks, an IQ4_XS ffn_up, a Q6_K output and a Q4_0 token_embd, written
    by the port's GGUFWriter and split in two shards by its split_gguf,
    loads through load_model(first shard, keep_quantized=True) onto the
    card: every QTensor's planes equal repack's of the written bytes, the
    Q4_0 token_embd equals dequantize's, the unsplit file loads to the
    same parameters, and a wave of greedy requests served over HTTP equals
    the engine's."""
    import gc
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from superllama_tpu_torch.gguf import dequantize
    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams
    from superllama_tpu_torch.ops.qtensor import QTensor, repack
    from superllama_tpu_torch.server.http import Server, ServerApp
    from superllama_tpu_torch.tools.gguf_split import shard_paths, split_gguf

    t_all = time.perf_counter()
    hp = llama3_8b_hparams(**DRAFT_1B)
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "gguf_1b")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        whole = os.path.join(d, "synthetic-1b.gguf")
        t0 = time.perf_counter()
        raws = write_file_model(whole, hp, grammar_tokenizer(hp.n_vocab))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        shards = split_gguf(whole, os.path.join(d, "synthetic-1b"), n_split=2)
        split_s = time.perf_counter() - t0
        check(shard_paths(shards[1]) == shards, f"shard paths {shards}")
        t0 = time.perf_counter()
        model = load_model(shards[0], dtype=torch.bfloat16, keep_quantized=True, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        by_name = {"output.weight": model.params["output"]}
        roles = {"attn_q": "wq", "attn_k": "wk", "attn_v": "wv", "attn_output": "wo",
                 "ffn_gate": "ffn_gate", "ffn_up": "ffn_up", "ffn_down": "ffn_down"}
        for il, layer in enumerate(model.params["layers"]):
            by_name.update({f"blk.{il}.{r}.weight": layer[k] for r, k in roles.items()})

        def planes_equal(name) -> bool:
            t, raw, shape = raws[name]
            ref, got = repack(raw, t, shape), by_name[name]
            return (got.ggml_type == t and all(
                torch.equal(getattr(got, p).cpu(), getattr(ref, p))
                if getattr(ref, p) is not None else getattr(got, p) is None
                for p in QTensor.PLANES))

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            bad = [n for n, ok in zip(by_name, ex.map(planes_equal, by_name)) if not ok]
        check(not bad, f"loaded QTensors differ from repack of their bytes: {bad[:4]}")
        t, raw, (V, E) = raws["token_embd.weight"]
        emb = torch.from_numpy(dequantize(raw, t, (V, E))).to(torch.bfloat16)
        check(torch.equal(model.params["token_embd"].cpu(), emb),
              "the Q4_0 token_embd differs from dequantize's")
        verify_s = time.perf_counter() - t0
        whole_model = load_model(whole, dtype=torch.bfloat16, keep_quantized=True,
                                 device="cuda")
        flat = lambda m: [(k, v) for k, v in m.params.items() if k != "layers"] + [
            (f"{i}.{k}", v) for i, layer in enumerate(m.params["layers"])
            for k, v in layer.items()]
        same = lambda a, b: (all(torch.equal(getattr(a, p), getattr(b, p)) if getattr(a, p)
                                 is not None else getattr(b, p) is None for p in QTensor.PLANES)
                             if isinstance(a, QTensor) else
                             b is None if a is None else torch.equal(a, b))
        got, ref = flat(model), flat(whole_model)
        check([k for k, _ in got] == [k for k, _ in ref]
              and all(same(a, b) for (_, a), (_, b) in zip(got, ref)),
              "the split and the unsplit file loaded to different parameters")
        del whole_model
        gc.collect()
        torch.cuda.empty_cache()
        types = sorted({v.ggml_type.name for _, v in got if isinstance(v, QTensor)})
        # a wave of greedy requests over HTTP against the engine's own wave
        app = ServerApp(model, n_slots=4, n_ctx=1024, model_name=model.name, device="cuda",
                        kv_dtype=torch.bfloat16, warmup=False)
        srv = Server(app, host="127.0.0.1", port=0)
        srv.start()
        try:
            prompts = token_prompts(hp.n_vocab, [24, 40, 16, 64], SEED + 6)
            results: list = [None] * len(prompts)

            def send(i):
                results[i] = http(srv.port, "/v1/completions",
                                  {"prompt": prompts[i], "max_tokens": 32, "temperature": 0,
                                   "return_tokens": True})

            threads = [threading.Thread(target=send, args=(i,)) for i in range(len(prompts))]
            reset_counts()
            in_one_wave(app.engine, lambda: [t.start() for t in threads], len(prompts))
            for th in threads:
                th.join(timeout=600)
            counts = read_counts()
            served = []
            for i, (st, data) in enumerate(results):
                check(st == 200, f"1B file request {i}: HTTP {st}")
                served.append(json.loads(data)["choices"][0]["tokens"])
            fresh(app.engine)
            direct = [r["tokens"] for r in engine_wave(app.engine, prompts, 32)]
            check(direct == served, "1B file: served tokens differ from the engine's")
            text = http(srv.port, "/v1/completions", {"prompt": "Hello", "max_tokens": 4,
                                                      "temperature": 0})
            check(text[0] == 200, f"1B file: a text prompt's HTTP {text[0]}")
        finally:
            srv.stop()
            del app, srv
        for name in ("qmv_nib", "qmv_q5k", "qmv_i8", "qmv"):
            check(counts[name] > 0, f"the 1B file's wave never launched {name}")
        info = {"phase": "gguf_file", "card": smi_line, "layers": hp.n_layer,
                "file_bytes": os.path.getsize(whole),
                "shard_bytes": [os.path.getsize(p) for p in shards], "types": types,
                "write_s": write_s, "split_s": split_s, "load_s": load_s,
                "verify_s": verify_s, "launches": counts, "served_equal_engine": True,
                "seconds": time.perf_counter() - t_all}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit(info)
    return info


# ------------------------------------------------------------ 4j. the model-file toolchain

# llama.cpp's Q4_K_M rules (the port's tools/quantize.py) by tensor role
Q4_K_M_TYPES = {"attn_q": "Q4_K", "attn_k": "Q4_K", "attn_v": "Q6_K", "attn_output": "Q4_K",
                "ffn_gate": "Q4_K", "ffn_up": "Q4_K", "ffn_down": "Q6_K",
                "output": "Q6_K", "token_embd": "Q4_K"}
# the depth of the imatrix-weighted quantize: its K-quant searches run in
# numpy, as in the JAX package, and one 1B-width layer (61M weights) takes
# most of a minute; of that layer the imatrix given to quantize holds only
# IMATRIX_ROLES' tensors (10.5M weights; its FFN's 50M took about 30 s)
IMATRIX_LAYERS = 1
IMATRIX_ROLES = ("attn_q", "attn_k", "attn_v", "attn_output")
PPL_CTX, PPL_CHUNKS, IMATRIX_CHUNKS = 512, 2, 4
PPL_TOL = 1e-3       # relative: the packed load against the same file dequantized
# the depth of the 1B-width workflow's files (Llama-3.2-1B has 16 layers):
# every step of it is per layer
WORKFLOW_LAYERS = 8


def repo_text(limit: int = 200_000) -> str:
    """The repo's own text: its Markdown files at the root, then the port's
    Python sources, in name order, up to ``limit`` bytes."""
    import glob

    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(root, "*.md"))) + sorted(
        glob.glob(os.path.join(root, "superllama_tpu_torch", "**", "*.py"), recursive=True))
    out, n = [], 0
    for f in files:
        with open(f, encoding="utf-8") as fh:
            out.append(fh.read())
        n += len(out[-1].encode())
        if n >= limit:
            break
    text = "".join(out).encode()[:limit].decode("utf-8", "ignore")
    check(len(text) > limit // 2, f"the repo's text holds {len(text)} bytes")
    return text


class NoNative:
    """SLT_NO_NATIVE=1 inside the block: the numpy route."""

    def __enter__(self):
        os.environ["SLT_NO_NATIVE"] = "1"

    def __exit__(self, *exc):
        del os.environ["SLT_NO_NATIVE"]


def toolchain_8b(torch, d: str, tok) -> dict:
    """The 8B Q4_K_M file: written, loaded through the native repack
    (planes of layer 0 held to the numpy route's, both routes timed on the
    same bytes), served greedy on a bf16 cache."""
    import gc

    from superllama_tpu_torch.models.loader import load_model, load_threads
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams
    from superllama_tpu_torch.ops.qtensor import QTensor, repack
    from superllama_tpu_torch.runtime.engine import Engine

    hp = llama3_8b_hparams()
    path = os.path.join(d, "synthetic-8b-q4_k_m.gguf")
    t0 = time.perf_counter()
    raws = write_file_model(path, hp, tok, Q4_K_M_TYPES, "synthetic-llama3-8b-q4_k_m",
                            shared_layers=True)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = load_model(path, dtype=torch.bfloat16, keep_quantized=True, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    workers, threads = load_threads()
    # both routes on layer 0's bytes, on this host
    roles = {"attn_q": "wq", "attn_k": "wk", "attn_v": "wv", "attn_output": "wo",
             "ffn_gate": "ffn_gate", "ffn_up": "ffn_up", "ffn_down": "ffn_down"}
    layer0 = {f"blk.0.{r}.weight": k for r, k in roles.items()}
    t0 = time.perf_counter()
    native_qt = {n: repack(raws[n][1], raws[n][0], raws[n][2]) for n in layer0}
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for n in layer0:
        repack(raws[n][1], raws[n][0], raws[n][2], threads=1)
    native_1_s = time.perf_counter() - t0
    with NoNative():
        t0 = time.perf_counter()
        numpy_qt = {n: repack(raws[n][1], raws[n][0], raws[n][2]) for n in layer0}
        numpy_s = time.perf_counter() - t0
    for n, key in layer0.items():
        got = model.params["layers"][0][key]
        for qt in (native_qt[n], got):
            check(all(torch.equal(getattr(qt, p).cpu(), getattr(numpy_qt[n], p))
                      if getattr(numpy_qt[n], p) is not None else getattr(qt, p) is None
                      for p in QTensor.PLANES), f"{n}: native planes differ from numpy's")
    types = sorted({v.ggml_type.name for layer in model.params["layers"] for v in layer.values()
                    if isinstance(v, QTensor)} | {model.params["output"].ggml_type.name})
    del native_qt, numpy_qt
    # a lone prompt (a 32-row chunk: qmm, fa), then a wave (decode: qmv)
    eng = Engine(model, n_slots=4, n_ctx=512, kv_dtype=torch.bfloat16, device="cuda")
    eng.start()
    try:
        prompts = token_prompts(hp.n_vocab, [30, 24, 17, 28], SEED + 71)
        reset_counts()
        t0 = time.perf_counter()
        lone = eng.generate(prompts[0], max_tokens=16, sampling={"greedy": True},
                            stop_eog=False)["tokens"]
        wave = [r["tokens"] for r in engine_wave(eng, prompts, 16)]
        serve_s = time.perf_counter() - t0
        counts = read_counts()
    finally:
        eng.stop()
    for name in ("qmv", "qmm", "fa_tc"):
        check(counts[name] > 0, f"the 8B Q4_K_M file's requests never launched {name}")
    check(len(lone) == 16 and all(len(t) == 16 and max(t) < hp.n_vocab for t in wave),
          "the 8B Q4_K_M file's requests gave the wrong tokens")
    info = {"file_bytes": os.path.getsize(path), "types": types, "layers": hp.n_layer,
            "write_s": write_s, "load_s": load_s, "load_workers": workers,
            "repack_threads": threads, "layer0_native_s": native_s,
            "layer0_native_1thread_s": native_1_s,
            "layer0_numpy_s": numpy_s, "layer0_planes_equal": True, "serve_s": serve_s,
            "lone_tokens": lone, "wave_tokens": wave,
            "launches": {k: counts[k] for k in ("qmv", "qmm", "fa_tc")}}
    os.remove(path)
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return info


def write_f16_model(path: str, hp, tok, weights: dict) -> None:
    from superllama_tpu_torch.gguf import GGMLType

    w = model_writer(path, hp, tok, "synthetic-llama3.2-1b-f16")
    for n in weight_shapes(hp, tied=True):
        w.add_tensor(n, weights[n], GGMLType.F16)
    w.write()


def f16_weights(torch, hp) -> dict:
    """Seeded normal weights of hp's widths (std 1/sqrt(K)), made on the
    card, as F16 host arrays; the head tied to the embedding, as
    Llama-3.2-1B's is (tie_word_embeddings)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 72)
    out = {}
    for n, (_, N, K) in weight_shapes(hp, tied=True).items():
        x = torch.randn((N, K), generator=g, device="cuda", dtype=torch.float32)
        out[n] = (x * (1.0 / math.sqrt(K))).to(torch.float16).cpu().numpy()
    return out


def cli_run(argv) -> str:
    """Run the port's CLI (exit 0 or fail); its last stdout line."""
    import contextlib
    import io

    from superllama_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(argv) == 0, f"{argv[0]} exited non-zero")
    return buf.getvalue().strip().splitlines()[-1]


def toolchain_1b(torch, d: str, tok, text: str) -> dict:
    """llama.cpp's quantization workflow at Llama-3.2-1B's widths (at
    WORKFLOW_LAYERS deep, its head tied to the embedding as Llama-3.2-1B's
    is): an F16 file, quantize to Q4_K_M, imatrix on the
    card, quantize --imatrix (at IMATRIX_LAYERS), perplexity of both files
    and their KL divergence, the packed load against the dequantized
    one."""
    import gc

    import numpy as np

    from superllama_tpu_torch.gguf import GGMLType, GGUFReader
    from superllama_tpu_torch.gguf.quants import QUANTIZERS
    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams
    from superllama_tpu_torch.tools.imatrix import load_imatrix, save_imatrix
    from superllama_tpu_torch.tools.perplexity import compute_kl_divergence, compute_perplexity

    out = {}
    lap = time.perf_counter()

    def took(key):
        nonlocal lap
        now = time.perf_counter()
        out[key] = now - lap
        lap = now

    hp = llama3_8b_hparams(**{**DRAFT_1B, "n_layer": WORKFLOW_LAYERS})
    f16, q = os.path.join(d, "f16.gguf"), os.path.join(d, "q4_k_m.gguf")
    weights = f16_weights(torch, hp)
    write_f16_model(f16, hp, tok, weights)
    took("write_f16_s")
    out["f16_bytes"] = os.path.getsize(f16)
    out["quantize_stats"] = json.loads(cli_run(["quantize", f16, q, "Q4_K_M"]))
    took("quantize_s")
    out["q4_k_m_bytes"] = os.path.getsize(q)
    # a few rows of three tensors: the file's bytes are the numpy encoders'
    r = GGUFReader(q)
    try:
        for n in ("blk.0.attn_q.weight", "blk.1.ffn_down.weight", "token_embd.weight"):
            ti = r.tensors[n]
            rows = weights[n][:8].astype(np.float32)
            per_row = ti.raw().size // ti.shape[0]
            check(np.array_equal(ti.raw().reshape(-1)[:8 * per_row], QUANTIZERS[ti.ggml_type](rows)),
                  f"{n}: quantize's bytes differ from the numpy encoder's")
    finally:
        r.close()
    took("verify_s")
    corpus = os.path.join(d, "corpus.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write(text)
    imx_path = os.path.join(d, "imatrix.gguf")
    cli_run(["imatrix", "-m", f16, "-f", corpus, "-o", imx_path, "-c", str(PPL_CTX),
              "--chunks", str(IMATRIX_CHUNKS)])
    imx = load_imatrix(imx_path)
    check(len(imx) == 7 * hp.n_layer and all(np.isfinite(v).all() and (v > 0).all()
                                             for v in imx.values()),
          f"imatrix: {len(imx)} tensors, or not finite and positive")
    took("imatrix_s")
    # quantize --imatrix on the first IMATRIX_LAYERS layers of the same
    # weights, the imatrix cut to IMATRIX_ROLES' tensors
    cut = llama3_8b_hparams(**{**DRAFT_1B, "n_layer": IMATRIX_LAYERS})
    f16_cut, q_cut = os.path.join(d, "f16_cut.gguf"), os.path.join(d, "q_cut_imatrix.gguf")
    write_f16_model(f16_cut, cut, tok, weights)
    imx_cut = os.path.join(d, "imatrix_cut.gguf")
    weighted_names = {f"blk.{il}.{role}.weight" for il in range(IMATRIX_LAYERS)
                      for role in IMATRIX_ROLES}
    save_imatrix(imx_cut, {n: v for n, v in imx.items() if n in weighted_names})
    t0 = time.perf_counter()
    out["imatrix_quantize_stats"] = json.loads(cli_run(
        ["quantize", f16_cut, q_cut, "Q4_K_M", "--imatrix", imx_cut]))
    out["imatrix_quantize_s"] = time.perf_counter() - t0
    r, rq = GGUFReader(q_cut), GGUFReader(q)
    try:
        for n, ti in r.tensors.items():
            same = bytes(ti.raw()) == bytes(rq.tensors[n].raw())
            weighted = n in weighted_names
            check(same != weighted, f"{n}: imatrix-weighted bytes {'equal' if same else 'differ'}")
    finally:
        r.close()
        rq.close()
    took("imatrix_quantize_total_s")
    # perplexity of both files on the same text, KL of Q4_K_M against F16
    ids = tok.encode(text, add_special=False)[: PPL_CTX * PPL_CHUNKS]
    base = []
    m = load_model(f16, device="cuda")
    res = compute_perplexity(m, ids, n_ctx=PPL_CTX, logits_sink=base, device="cuda")
    out["ppl_f16"] = res.ppl
    del m
    gc.collect()
    torch.cuda.empty_cache()
    took("ppl_f16_s")
    m = load_model(q, device="cuda")
    kl = compute_kl_divergence(m, ids, base, n_ctx=PPL_CTX, device="cuda")
    out.update({"ppl_q4_k_m": kl["ppl"], **{k: kl[k] for k in kl if k != "ppl"}})
    del m, base
    gc.collect()
    torch.cuda.empty_cache()
    took("ppl_kl_q4_k_m_s")
    m = load_model(q, keep_quantized=True, device="cuda")
    reset_counts()
    packed = compute_perplexity(m, ids, n_ctx=PPL_CTX, device="cuda").ppl
    counts = read_counts()
    del m
    gc.collect()
    torch.cuda.empty_cache()
    took("ppl_packed_s")
    out["ppl_q4_k_m_packed"] = packed
    out["packed_rel_diff"] = abs(packed - out["ppl_q4_k_m"]) / out["ppl_q4_k_m"]
    out["tokens_scored"] = res.n_tokens
    check(all(math.isfinite(out[k]) and out[k] > 1 for k in ("ppl_f16", "ppl_q4_k_m")),
          f"perplexities {out['ppl_f16']}, {out['ppl_q4_k_m']}")
    check(out["kl_mean"] > 0 and math.isfinite(out["kl_max"]), f"KL {out['kl_mean']}")
    check(out["packed_rel_diff"] < PPL_TOL,
          f"packed perplexity {packed} against dequantized {out['ppl_q4_k_m']}")
    check(counts["fa"] > 0, "the f32 perplexity run never launched fa")
    out.update({"layers": hp.n_layer, "imatrix_layers": IMATRIX_LAYERS,
                "imatrix_roles": list(IMATRIX_ROLES), "imatrix_chunks": IMATRIX_CHUNKS,
                "ppl_ctx": PPL_CTX, "ppl_chunks": PPL_CHUNKS,
                "packed_launches": {k: counts[k] for k in ("fa", "qmm", "qmv")}})
    return out


def toolchain_tokenizer(tok, text: str) -> dict:
    """The repo's text through the 128,256-piece tokenizer, natively and in
    Python (the plain version): equal ids."""
    from superllama_tpu_torch.tokenizer import Tokenizer

    plain = Tokenizer(tok.vocab)
    plain._nat, plain._nat_tried = None, True
    t0 = time.perf_counter()
    tok.encode("warm", add_special=False)       # g++ (once a tree) and the vocab's core
    core_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = tok.encode(text, add_special=False)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = plain.encode(text, add_special=False)
    python_s = time.perf_counter() - t0
    check(tok._nat is not None and got == ref, "native tokenizer ids differ from Python's")
    return {"bytes": len(text.encode()), "ids": len(got), "native_core_s": core_s,
            "native_s": native_s, "python_s": python_s}


def phase_toolchain(torch, smi_line: str) -> dict:
    """4j. The model-file toolchain on the card's host: an 8B-width Q4_K_M
    GGUF written, loaded through the native repack and served; the 1B-width
    quantization workflow (quantize, imatrix, quantize --imatrix,
    perplexity, KL divergence); the native tokenizer against Python's."""
    import shutil
    import tempfile

    from superllama_tpu_torch.models.loader import load_threads

    t_all = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    d = tempfile.mkdtemp(prefix="toolchain_", dir=build)
    try:
        tok = grammar_tokenizer(128256)
        text = repo_text()
        info = {"phase": "toolchain", "card": smi_line, "host_cores": len(os.sched_getaffinity(0)),
                "load_threads": load_threads()}
        info["tokenizer"] = toolchain_tokenizer(tok, text)
        t0 = time.perf_counter()
        info["file_8b"] = toolchain_8b(torch, d, tok)
        info["file_8b"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["workflow_1b"] = toolchain_1b(torch, d, tok, text)
        info["workflow_1b"]["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    info["seconds"] = time.perf_counter() - t_all
    emit(info)
    return info


# ------------------------------------------------------------ 4k. the dense architecture registry

# the depth of Command-R7B's file (of its 32 layers): writing, loading, the iSWA
# engines' eager runs and the eager plain routes of greedy_rule are per layer;
# 4 is one interval of its pattern (three window layers, then a NoPE one)
ARCH_LAYERS = 4
# Command-R7B (CohereForAI/c4ai-command-r7b-12-2024 config.json): cohere2 at
# its published widths, ARCH_LAYERS deep; a 4,096-token window on three
# layers of four, NoPE on the fourth, LayerNorm without bias, a parallel
# residual off one shared norm, logit scale 0.25, tied embeddings
CMDR7B = dict(arch="cohere2", n_embd=4096, n_layer=ARCH_LAYERS, n_head=32, n_head_kv=8,
              head_dim=128, head_dim_v=128, n_rot=128, n_ff=14336, n_vocab=256000,
              rope_freq_base=50000.0)
CMDR7B_KEYS = {"attention.layer_norm_epsilon": 1e-5, "attention.sliding_window": 4096,
               "logit_scale": 0.25, "attention.key_length": 128, "attention.value_length": 128}
# llama.cpp's Q4_K_M rules; a tied embedding is the head, so it takes the
# head's Q6_K
CMDR7B_TYPES = {**Q4_K_M_TYPES, "token_embd": "Q6_K"}
# a 4,600-token prompt, past the window; its last chunk of 32 rows takes
# qmm and fa_tc (T ≥ 32)
LONG_CHUNKS = (2048, 2048, 472, 32)
ARCH_NMSE = 1e-3     # phase 5's limit: bf16 activations, kernels against plain versions
ARCH_DECODE = 16     # greedy tokens a cache
# the sweep: 2 layers (deci 4), 1,024 wide, 8 heads of 128 (gemma2 256), FFN
# 2,816, Q4_K weights of rand_raw bytes, a 32,000-piece vocab
SWEEP = dict(E=1024, H=8, D=128, F=2816, L=2, V=32000)
SWEEP_FAMILIES = ("bloom", "phi3", "gpt2", "falcon", "deci", "chameleon", "gemma2", "qwen3vl")


def cmdr7b_long_prompt(torch, model) -> dict:
    """The 4,600-token prompt in LONG_CHUNKS on a bf16 cache through the
    kernels (the M > 32 path, fa_tc); then its last 32-token chunk twice
    over the same cache: through the kernels (qmm, fa_tc) and through the
    plain versions. The last position's logits of the two agree within
    ARCH_NMSE."""
    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.runtime.kv_cache import kv_cache_init, kv_truncate_rows

    hp = model.hparams
    n = sum(LONG_CHUNKS)
    ids = token_prompts(hp.n_vocab, [n], SEED + 80)[0]
    cache = kv_cache_init(hp.n_layer, 1, n + 8, hp.n_head_kv, hp.head_dim, hp.head_dim_v,
                          dtype=torch.bfloat16, device="cuda")

    def chunk(p0, p1):
        tok = torch.tensor([ids[p0:p1]], device="cuda")
        pos = torch.arange(p0, p1, dtype=torch.int32, device="cuda")[None]
        with torch.no_grad():
            lg, _ = llama_forward(model.params, hp, tok, pos, cache)
        return lg[0, -1].float()

    t0 = time.perf_counter()
    reset_counts()
    p0 = 0
    for c in LONG_CHUNKS[:-1]:
        chunk(p0, p0 + c)
        p0 += c
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    got = chunk(p0, n)
    counts = read_counts()
    kv_truncate_rows(cache, torch.tensor([p0], dtype=torch.int32, device="cuda"))
    with PlainKernels():
        ref = chunk(p0, n)
    err = nmse(got, ref)
    check(err < ARCH_NMSE, f"Command-R7B long prompt: kernel against plain route nmse {err:g}")
    for name in ("qmm", "fa_tc"):
        check(counts[name] > 0, f"Command-R7B long prompt never launched {name}")
    return {"tokens": n, "chunks": list(LONG_CHUNKS), "prefill_s": prefill_s, "nmse": err,
            "nmse_bound": ARCH_NMSE, "argmax_agree": bool(got.argmax() == ref.argmax()),
            "launches": {k: counts[k] for k in ("qmm", "fa_tc", "fa", "qmv")}}


# the iSWA engine's prefill buckets: a largest ubatch of 256 makes
# Command-R7B's ring iswa_swa_seq(4096, 256, n_ctx) = 4,352 slots, which the
# 4,600-token prompt wraps
ISWA_BUCKETS = (32, 128, 256)
ISWA_RING = 4352
ISWA_N_CTX = 4864     # the long prompt, ARCH_DECODE tokens and headroom


def kv_bytes(cache) -> int:
    """Device bytes of a KVCache's tensors (an iSWA cache: of one tier's)."""
    ts = [cache.k, cache.v, cache.pos, cache.cursor, cache.k_scale, cache.v_scale]
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def ring_paths(torch, model, prompt):
    """greedy_rule's paths for the iSWA engine against the flat one: the
    logits of ids[-1] through the kernels over a flat cache (a) and over an
    iSWA cache of the engine's ring (b), the prompt prefilled in chunks of
    the largest bucket, then one decode step a token."""
    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.runtime.kv_cache import iswa_cache_init, kv_cache_init

    hp = model.hparams
    P = ISWA_BUCKETS[-1]

    def run(cache, ids):
        seq = [prompt[c:c + P] for c in range(0, len(prompt), P)]
        seq += [[t] for t in ids[len(prompt):]]
        p0 = 0
        with torch.no_grad():
            for toks in seq:
                pos = torch.arange(p0, p0 + len(toks), dtype=torch.int32, device="cuda")[None]
                lg, _ = llama_forward(model.params, hp, torch.tensor([toks], device="cuda"),
                                      pos, cache)
                p0 += len(toks)
        return lg[0, -1].float().cpu()

    def paths(ids):
        flat = kv_cache_init(hp.n_layer, 1, ISWA_N_CTX, hp.n_head_kv, hp.head_dim,
                             hp.head_dim_v, dtype=torch.bfloat16, device="cuda")
        ring = iswa_cache_init(hp, 1, ISWA_N_CTX, n_ubatch=P, dtype=torch.bfloat16,
                               device="cuda")
        return run(flat, ids), run(ring, ids)
    return paths


def cmdr7b_iswa(torch, model) -> dict:
    """The 4,600-token prompt and ARCH_DECODE greedy tokens on one-slot
    Engines: a flat-cache one (``iswa=False``, the default buckets), then
    two iSWA ones (ISWA_BUCKETS: a 4,352-slot ring the prompt wraps) with
    graphs and without. The graph engine's measured run (after a warm one)
    equals the eager engine's bit for bit: tokens, cache rows of both
    tiers, launches, every chunk and block a replay. Its tokens are held to
    the flat engine's by greedy_rule (ring_paths); fa_tc launched over the
    tiers; each cache's KV bytes and each engine's TTFT."""
    import gc

    from superllama_tpu_torch.runtime.engine import Engine

    hp = model.hparams
    prompt = token_prompts(hp.n_vocab, [sum(LONG_CHUNKS)], SEED + 83)[0]
    label = "Command-R7B iSWA"

    def gen(eng):
        fresh(eng)
        return eng.generate(prompt, max_tokens=ARCH_DECODE, sampling={"greedy": True},
                            stop_eog=False)

    flat = Engine(model, n_slots=1, n_ctx=ISWA_N_CTX, device="cuda",
                  kv_dtype=torch.bfloat16, iswa=False)
    check(not flat.iswa, f"{label}: iswa=False built {type(flat.cache).__name__}")
    gen(flat)                       # captures its chunks and blocks
    r = gen(flat)
    ref, out = r["tokens"], {"flat_ttft_ms": r["ttft_s"] * 1e3,
                             "flat_kv_bytes": kv_bytes(flat.cache)}
    del flat
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    engines = {g: Engine(model, n_slots=1, n_ctx=ISWA_N_CTX, device="cuda",
                         kv_dtype=torch.bfloat16, prefill_buckets=ISWA_BUCKETS, graphs=g)
               for g in (True, False)}
    try:
        for g, eng in engines.items():
            check(eng.iswa and eng.cache.swa.max_seq == ISWA_RING
                  and eng.cache.full.max_seq == ISWA_N_CTX,
                  f"{label}: the engine's cache is {type(eng.cache).__name__}")
            if g:
                gen(eng)            # the warm run: captures
            with eng._step_lock:
                stats0 = block_stats(eng)
                reset_counts()
            r = gen(eng)
            with eng._step_lock:
                torch.cuda.synchronize()
                runs[g] = {"tokens": r["tokens"], "ttft_ms": r["ttft_s"] * 1e3,
                           "launches": read_counts(), "rows": cache_rows(eng),
                           "blocks": {k: v - stats0[k] for k, v in block_stats(eng).items()},
                           "ring_top": int(eng.cache.swa.cursor[0])}
        ring = engines[True].cache
        out["kv_bytes"] = {"full": kv_bytes(ring.full), "swa": kv_bytes(ring.swa)}
    finally:
        del engines
        gc.collect()
        torch.cuda.empty_cache()
    g_run, e_run = runs[True], runs[False]
    rows_equal = {k: bool(torch.equal(g_run["rows"][k], e_run["rows"][k]))
                  for k in g_run["rows"]}
    check(g_run["tokens"] == e_run["tokens"], f"{label}: the graph engine's tokens differ")
    check(all(rows_equal.values()), f"{label}: cache rows differ: {rows_equal}")
    check(g_run["launches"] == e_run["launches"], f"{label}: launch counts differ")
    gb = g_run["blocks"]
    check(gb["replays"] == gb["blocks"] > 0 and gb["chunk_replays"] == gb["chunks"] > 0
          and gb["captures"] == gb["chunk_captures"] == 0, f"{label}: graph engine {gb}")
    check(g_run["ring_top"] > ISWA_RING, f"{label}: the prompt did not wrap the ring")
    check(g_run["launches"]["fa_tc"] > 0, f"{label}: the prompt never launched fa_tc")
    rule = greedy_rule(torch, model, label, prompt, ref, g_run["tokens"], 1, 1,
                       paths=ring_paths(torch, model, prompt), n_ctx=ISWA_N_CTX)
    full, swa = out["kv_bytes"]["full"], out["kv_bytes"]["swa"]
    out.update({"tokens": len(prompt), "ring_slots": ISWA_RING, "n_ctx": ISWA_N_CTX,
                "buckets": list(ISWA_BUCKETS), "greedy_rule_vs_flat": rule,
                "replayed_equals_eager": True, "rows_equal": rows_equal,
                "graph_blocks": gb, "iswa_ttft_ms": g_run["ttft_ms"],
                "iswa_ttft_ms_eager": e_run["ttft_ms"], "ring_high_water": g_run["ring_top"],
                "kv_bytes_iswa_over_flat": (full + swa) / out["flat_kv_bytes"],
                "launches": {k: g_run["launches"][k] for k in ("qmv", "qmm", "fa_tc", "fa",
                                                              "fd")}})
    return out


def plain_greedy(torch, model, prompt, n: int, kv_dtype=None, paged=False,
                 n_ctx: int = 2048) -> list:
    """n greedy tokens through the eager plain route: the prompt's prefill,
    then one decode step a token, every kernel replaced by its plain
    version."""
    with PlainKernels():
        steps = forward_run(torch, model, [list(prompt)], kv_dtype, paged, greedy=n - 1,
                            n_ctx=n_ctx)
    return [int(lg[0, -1].argmax()) for lg in steps]


def route_paths(torch, model, prompt, kv_dtype=None, paged=False, n_ctx: int = 2048,
                taps: dict | None = None):
    """greedy_rule's paths for a served decode against the eager plain
    route: the logits of ids[-1] at its position through the plain route
    (a) and through the kernels (b), the prompt prefilled, then one decode
    step a token, on a fresh cache of the kind each time. With ``taps``, a
    dict, each path's last step's router calls (RouterTap) go into
    taps["a"] and taps["b"]."""
    def run(ids):
        seq = [list(prompt)] + [[t] for t in ids[len(prompt):]]
        if taps is None:
            return forward_run(torch, model, seq, kv_dtype, paged, n_ctx=n_ctx)[-1][0, -1].cpu()
        n_moe = sum("ffn_gate_inp" in layer for layer in model.params["layers"])
        with RouterTap() as tap:
            out = forward_run(torch, model, seq, kv_dtype, paged, n_ctx=n_ctx)[-1][0, -1].cpu()
        return out, tap.calls[-n_moe:]

    def paths(ids):
        with PlainKernels():
            a = run(ids)
        b = run(ids)
        if taps is None:
            return a, b
        (a, taps["a"]), (b, taps["b"]) = a, b
        return a, b
    return paths


DECODE_CACHES = (("bf16", {}, "qmv"), ("q8_0", {"kv_dtype": "q8_0"}, "fd"),
                 ("paged", {"paged": True, "page_size": 256}, "paged"))


def arch_decode(torch, model, label: str = "Command-R7B", need=(),
                caches=DECODE_CACHES) -> dict:
    """ARCH_DECODE greedy tokens of a 32-token prompt on a bf16, a Q8_0
    (fd) and a paged (paged) cache (``caches`` narrows them) through the
    Engine (its decode blocks replayed from CUDA graphs), each held to the
    eager plain route by greedy_rule; the kernels in ``need`` launched on
    every cache too."""
    from superllama_tpu_torch.runtime.engine import Engine

    hp = model.hparams
    prompt = token_prompts(hp.n_vocab, [32], SEED + 81)[0]
    out = {}
    keys = ("qmv", "qmm", "fa_tc", "fd", "paged", *need)
    for cache, kw, kernel in caches:
        eng = Engine(model, n_slots=1, n_ctx=512, device="cuda",
                     **{"kv_dtype": torch.bfloat16, **kw})
        reset_counts()
        got = eng.generate(prompt, max_tokens=ARCH_DECODE, sampling={"greedy": True},
                           stop_eog=False)["tokens"]
        counts = read_counts()
        stats = block_stats(eng)
        check(stats["blocks"] > 0 and stats["replays"] == stats["blocks"],
              f"{label} {cache}: decode blocks {stats}")
        for name in (kernel, *need):
            check(counts[name] > 0, f"{label} {cache} decode never launched {name}")
        iswa = eng.iswa
        del eng
        cache_kw = {"kv_dtype": kw.get("kv_dtype"), "paged": bool(kw.get("paged"))}
        ref = plain_greedy(torch, model, prompt, ARCH_DECODE, **cache_kw)
        rule = greedy_rule(torch, model, f"{label} {cache}", prompt, ref, got, 1, 1,
                           paths=route_paths(torch, model, prompt, **cache_kw), **cache_kw)
        out[cache] = {"greedy_rule": rule, "launches": {k: counts[k] for k in keys},
                      "blocks": stats["blocks"], "replays": stats["replays"],
                      "iswa": iswa}
    return out


def arch_serving(torch, model, label: str = "Command-R7B", need=(), attn=("fa_tc",)) -> dict:
    """A wave of 8 requests of 32-token prompts, 32 tokens each, over HTTP
    to a warmed-up ServerApp (bf16 cache): the served tokens equal the
    engine's own wave, every decode block and prompt chunk a replay and no
    capture after the warm-up; then B 1 and B 8 decode tok/s and the warm
    TTFT of a 32-token prompt; the kernels in ``need`` launched in the wave
    too, and ``attn``'s (fa_tc; none for MLA, whose attention is plain)."""
    import gc

    from superllama_tpu_torch.server.http import Server, ServerApp

    app = ServerApp(model, n_slots=8, n_ctx=512, model_name=model.name, device="cuda",
                    kv_dtype=torch.bfloat16)
    srv = Server(app, host="127.0.0.1", port=0)
    srv.start()
    eng, warm = app.engine, app.warmup_info
    try:
        prompts = token_prompts(model.hparams.n_vocab, [32] * 8, SEED + 82)
        results: list = [None] * len(prompts)

        def send(i):
            results[i] = http(srv.port, "/v1/completions",
                              {"prompt": prompts[i], "max_tokens": 32, "temperature": 0,
                               "return_tokens": True})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(prompts))]
        stats0 = block_stats(eng)
        reset_counts()
        in_one_wave(eng, lambda: [t.start() for t in threads], len(prompts))
        for t in threads:
            t.join(timeout=600)
        counts = read_counts()
        served = []
        for i, (st, data) in enumerate(results):
            ch = json.loads(data)["choices"][0]
            check(st == 200 and len(ch["tokens"]) == 32, f"{label} request {i}: HTTP {st}")
            served.append(ch["tokens"])
        fresh(eng)
        direct = [r["tokens"] for r in engine_wave(eng, prompts, 32)]
        check(direct == served, f"{label}: served tokens differ from the engine's wave")
        replayed = check_replayed(f"{label} wave", stats0, block_stats(eng))
        p32 = prompts[0]
        gen = lambda n: (fresh(eng), eng.generate(  # noqa: E731
            p32, max_tokens=n, sampling={"greedy": True}, stop_eog=False))[1]
        ttft = sorted(gen(1)["ttft_s"] * 1e3 for _ in range(3))[1]
        r1 = gen(64)
        fresh(eng)
        rs = engine_wave(eng, prompts, 64)
        after = block_stats(eng)
        check(after["captures"] == stats0["captures"]
              and after["chunk_captures"] == stats0["chunk_captures"],
              f"{label}: a graph was captured after the warm-up: {after}")
        b8 = (sum(r["n_generated"] - 1 for r in rs)
              / (max(r["total_s"] for r in rs) - max(r["ttft_s"] for r in rs)))
        info = {"iswa": eng.iswa, "warmup_keys": len(warm["keys"]), "warmup_s": warm["seconds"],
                "graph_pool_bytes": warm["pool_bytes"], "served_equal_engine": True,
                "wave_blocks": replayed,
                "launches": {k: counts[k] for k in ("qmv", "qmm", "fa_tc", "fd", "paged", *need)},
                "decode_tok_s_b1": (r1["n_generated"] - 1) / (r1["total_s"] - r1["ttft_s"]),
                "decode_tok_s_b8": b8, "ttft_ms_prompt32": ttft}
    finally:
        srv.stop()
        del app, srv, eng
        gc.collect()
        torch.cuda.empty_cache()
    # (the wave prefills as one 8-row chunk of 256 rows: the M > 32 path,
    # no qmm; the long prompt's last chunk holds qmm)
    for name in ("qmv", *attn, *need):
        check(info["launches"][name] > 0, f"{label} serving never launched {name}")
    return info


def cmdr7b(torch, d: str, smi_line: str) -> dict:
    """Command-R7B at full width, as a Q4_K_M-style file of rand_raw bytes
    (every layer layer 0's) with a 256,000-piece vocab: written, loaded
    packed onto the card, its hparams checked against the published
    config, then the long prompt, the three caches' decode and the
    serving wave."""
    import gc

    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams

    hp = llama3_8b_hparams(**CMDR7B)
    tok = grammar_tokenizer(hp.n_vocab)
    path = os.path.join(d, "synthetic-command-r7b-q4_k_m.gguf")
    t0 = time.perf_counter()
    write_file_model(path, hp, tok, CMDR7B_TYPES, "synthetic-command-r7b-q4_k_m",
                     shared_layers=True, arch="cohere2", keys=CMDR7B_KEYS, ffn_norm=False,
                     tied=True)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = load_model(path, dtype=torch.bfloat16, keep_quantized=True, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = model.hparams
    want = {"arch": "cohere2", "n_embd": 4096, "n_layer": ARCH_LAYERS, "n_head": 32, "n_head_kv": 8,
            "head_dim": 128, "n_ff": 14336, "n_vocab": 256000, "swa_window": 4096,
            "swa_pattern": 4, "rope_freq_base": 50000.0, "norm_type": "ln",
            "parallel_residual": True, "logit_scale": 0.25}
    have = {k: getattr(got, k) for k in want}
    check(have == want and bool(got.extra.get("rope_swa_only"))
          and model.params.get("output") is None,
          f"Command-R7B hparams from the file: {have} (want {want}), extra {got.extra}")
    check([got.is_swa_layer(il) for il in range(4)] == [True, True, True, False],
          "Command-R7B: the window is not on three layers of four")
    info = {"file_bytes": os.path.getsize(path), "write_s": write_s, "load_s": load_s,
            "hparams": have}
    os.remove(path)
    t0 = time.perf_counter()
    info["long_prompt"] = cmdr7b_long_prompt(torch, model)
    info["long_prompt"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["iswa"] = cmdr7b_iswa(torch, model)
    info["iswa"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["decode"] = arch_decode(torch, model)
    info["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (rec,) = phase_graph_vs_eager(torch, model, (("iswa bf16", {}, [32, 100] * 4),),
                                  ("greedy",), n_ctx=512)
    check(rec["iswa"], "Command-R7B: the graph-against-eager engines are not iSWA")
    info["iswa_graph_vs_eager"] = {k: rec[k] for k in ("tokens_equal", "rows_equal",
                                                       "graph_blocks")}
    info["iswa_graph_vs_eager_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["serving"] = arch_serving(torch, model)
    check(info["serving"]["iswa"], "Command-R7B: the server's engine is not iSWA")
    info["serving"]["seconds"] = time.perf_counter() - t0
    info["card"] = smi_line
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return info


def sweep_file(path: str, family: str) -> str:
    """A tiny-depth GGUF of one feature family at SWEEP's widths: Q4_K
    matmul weights of rand_raw bytes, F32 norms, biases and learned
    positions, no tokenizer; the architecture's own tensor names and
    metadata."""
    import numpy as np

    from superllama_tpu_torch.gguf import GGMLType, GGUFWriter
    from superllama_tpu_torch.models.synthetic import rand_raw

    E, H, D, F, L, V = (SWEEP[k] for k in ("E", "H", "D", "F", "L", "V"))
    arch = family
    HKV = {"bloom": H, "gpt2": H, "falcon": 1}.get(family, 2)
    if family == "gemma2":
        D = 256
    ln = family in ("bloom", "gpt2", "falcon")
    rng = np.random.default_rng([SEED + 90, *family.encode()])
    w = GGUFWriter(path, arch=arch)
    heads = [H, 0, H, H] if family == "deci" else H
    heads_kv = [0, 0, HKV, HKV] if family == "deci" else HKV
    ffs = [F, F, 0, F] if family == "deci" else F
    n_layer = 4 if family == "deci" else L
    meta = {"context_length": 2048, "embedding_length": E, "block_count": n_layer,
            "feed_forward_length": ffs, "attention.head_count": heads,
            "attention.head_count_kv": heads_kv, "attention.key_length": D,
            "attention.value_length": D, "rope.dimension_count": D, "vocab_size": V,
            "rope.freq_base": 10000.0,
            ("attention.layer_norm_epsilon" if ln else
             "attention.layer_norm_rms_epsilon"): 1e-5}
    meta.update({"gemma2": {"attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
                            "attention.sliding_window": 4096},
                 "qwen3vl": {"rope.dimension_sections": [24, 20, 20, 0],
                             "n_deepstack_layers": 0},
                 "chameleon": {"swin_norm": False}}.get(family, {}))
    w.add("general.name", f"sweep-{family}")
    for k, v in meta.items():
        w.add(f"{arch}.{k}", v)
    seed = iter(range(SEED + 100, SEED + 10_000))

    def q(name, N, K):
        w.add_tensor(name, rand_raw(GGMLType.Q4_K, N, K, next(seed)), GGMLType.Q4_K,
                     raw_ne=(K, N))

    def f32(name, *shape, scale=0.05, one=False):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        w.add_tensor(name, a + 1.0 if one else a)

    def norm(name, dim):
        f32(name + ".weight", dim, one=True)
        if ln:
            f32(name + ".bias", dim)

    q("token_embd.weight", V, E)
    if family == "gpt2":
        f32("position_embd.weight", 2048, E, scale=0.02)
    if family == "bloom":
        norm("token_embd_norm", E)
    norm("output_norm", E)
    if family not in ("bloom", "gemma2"):        # the others ship their head
        q("output.weight", V, E)
    fused = family in ("bloom", "phi3", "gpt2", "falcon")
    for il in range(n_layer):
        b = f"blk.{il}."
        h = heads[il] if family == "deci" else H
        hkv = heads_kv[il] if family == "deci" else HKV
        f = ffs[il] if family == "deci" else F
        if h:
            norm(b + "attn_norm", E)
            if fused:
                q(b + "attn_qkv.weight", (h + 2 * hkv) * D, E)
                if family in ("bloom", "gpt2"):
                    f32(b + "attn_qkv.bias", (h + 2 * hkv) * D)
            elif hkv:
                q(b + "attn_q.weight", h * D, E)
                q(b + "attn_k.weight", hkv * D, E)
                q(b + "attn_v.weight", hkv * D, E)
            q(b + "attn_output.weight", E, h * D if hkv else E)
            if family in ("bloom", "gpt2"):
                f32(b + "attn_output.bias", E)
        if family == "chameleon":
            for n_, hh in (("q", h), ("k", hkv)):
                f32(b + f"attn_{n_}_norm.weight", hh, D, one=True)
                f32(b + f"attn_{n_}_norm.bias", hh, D)
        if family == "qwen3vl":
            f32(b + "attn_q_norm.weight", D, one=True)
            f32(b + "attn_k_norm.weight", D, one=True)
        if family == "gemma2":
            f32(b + "post_attention_norm.weight", E, one=True)
            f32(b + "post_ffw_norm.weight", E, one=True)
        if not f:
            continue
        if family != "falcon":
            norm(b + "ffn_norm", E)
        if family == "phi3":
            q(b + "ffn_up.weight", 2 * f, E)        # gate ∥ up, split by rows at load
        else:
            if family not in ("bloom", "gpt2", "falcon"):
                q(b + "ffn_gate.weight", f, E)
            q(b + "ffn_up.weight", f, E)
            if family in ("bloom", "gpt2"):
                f32(b + "ffn_up.bias", f)
        q(b + "ffn_down.weight", E, f)
        if family in ("bloom", "gpt2"):
            f32(b + "ffn_down.bias", E)
    w.write()
    return path


def sweep_family(torch, d: str, family: str) -> dict:
    """One family's file loaded packed onto the card and onto the host: the
    32-token prompt's first-token logits through the card's kernels against
    the port's CPU plain forward (ARCH_NMSE); then 4 greedy requests on a
    warmed-up Q8_0 Engine, every block a replay and no capture after the
    warm-up (ALiBi: no fa and no fd launch)."""
    import gc

    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.runtime.engine import Engine
    from superllama_tpu_torch.runtime.kv_cache import kv_cache_init

    t0 = time.perf_counter()
    path = sweep_file(os.path.join(d, f"sweep-{family}.gguf"), family)
    models = {dev: load_model(path, dtype=torch.bfloat16, keep_quantized=True, device=dev)
              for dev in ("cuda", "cpu")}
    hp = models["cuda"].hparams
    prompt = token_prompts(hp.n_vocab, [32], SEED + 83)[0]
    first = {}
    reset_counts()
    for dev, m in models.items():
        cache = kv_cache_init(hp.n_layer, 1, 64, hp.n_head_kv, hp.head_dim, hp.head_dim_v,
                              dtype=torch.bfloat16, device=dev)
        with torch.no_grad():
            lg, _ = llama_forward(m.params, hp, torch.tensor([prompt], device=dev),
                                  torch.arange(32, dtype=torch.int32, device=dev)[None], cache)
        first[dev] = lg[0, -1].float().cpu()
    prefill = read_counts()
    err = nmse(first["cuda"], first["cpu"])
    check(err < ARCH_NMSE, f"sweep {family}: card against CPU plain forward nmse {err:g}")
    eng = Engine(models["cuda"], n_slots=4, n_ctx=256, kv_dtype="q8_0", device="cuda")
    warm = eng.warmup()
    eng.start()
    try:
        stats0 = block_stats(eng)
        reset_counts()
        outs = engine_wave(eng, token_prompts(hp.n_vocab, [32, 20, 27, 32], SEED + 84), 16)
        counts = read_counts()
        replayed = check_replayed(f"sweep {family}", stats0, block_stats(eng))
        after = block_stats(eng)
        check(after["captures"] == stats0["captures"]
              and after["chunk_captures"] == stats0["chunk_captures"],
              f"sweep {family}: a graph was captured after the warm-up")
    finally:
        eng.stop()
    check(all(len(r["tokens"]) == 16 and max(r["tokens"]) < hp.n_vocab for r in outs),
          f"sweep {family}: wrong tokens")
    sup = hp.extra.get("logit_suppress")
    if sup is not None:     # chameleon: decode steps never pick an image token
        check(not any(sup[0] <= t < sup[1] for r in outs for t in r["tokens"][1:]),
              f"sweep {family}: a decode step picked a suppressed image token")
    if hp.alibi:
        check(counts["fa"] + counts["fa_tc"] + counts["fd"] + prefill["fa"]
              + prefill["fa_tc"] == 0,
              f"sweep {family}: ALiBi launched fa or fd: {counts}")
    else:
        check(prefill["fa_tc"] > 0 and counts["fd"] > 0,
              f"sweep {family}: the flash prefill or the decode kernel never launched")
    check(counts["qmv"] > 0 and prefill["qmm"] > 0, f"sweep {family}: qmv / qmm never launched")
    info = {"family": family, "arch": hp.arch, "n_layer": hp.n_layer, "head_dim": hp.head_dim,
            "first_token_nmse": err, "nmse_bound": ARCH_NMSE,
            "argmax_agree": bool(first["cuda"].argmax() == first["cpu"].argmax()),
            "warmup_keys": len(warm["keys"]), "wave_blocks": replayed,
            "launches_prefill": {k: prefill[k] for k in ("qmm", "fa", "fa_tc")},
            "launches_wave": {k: counts[k] for k in ("qmv", "qmm", "fa", "fa_tc", "fd")},
            "seconds": time.perf_counter() - t0}
    os.remove(path)
    del models, eng
    gc.collect()
    torch.cuda.empty_cache()
    return info


def phase_archs(torch, smi_line: str) -> dict:
    """4k. The dense architecture registry on the card: Command-R7B at full
    width, then the sweep of the feature families."""
    import shutil
    import tempfile

    t_all = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    d = tempfile.mkdtemp(prefix="archs_", dir=build)
    try:
        info = {"phase": "archs", "card": smi_line, "command_r7b": cmdr7b(torch, d, smi_line)}
        info["sweep"] = [sweep_family(torch, d, fam) for fam in SWEEP_FAMILIES]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    info["seconds"] = time.perf_counter() - t_all
    emit(info)
    return info


# ------------------------------------------------------------ 4l. sparse mixture of experts

GMM_NMSE = 1e-9      # the kernel's f32 sums of exact products against the plain version's
# (label, experts, top-k, tokens, K, N): Qwen3-30B-A3B's gate/up and down at
# a decode step of 8 rows and a 256-token chunk, Mixtral-8x7B's at decode
# and a 256-token chunk; group G // 2 gets no row
GMM_CELLS = [("qwen3 decode gate/up", 128, 8, 8, 2048, 768),
             ("qwen3 decode down", 128, 8, 8, 768, 2048),
             ("qwen3 chunk gate/up", 128, 8, 256, 2048, 768),
             ("qwen3 chunk down", 128, 8, 256, 768, 2048),
             ("mixtral decode gate/up", 8, 2, 8, 4096, 14336),
             ("mixtral decode down", 8, 2, 8, 14336, 4096),
             ("mixtral chunk gate/up", 8, 2, 256, 4096, 14336)]
# (label, experts, top-k, tokens, K, N, the one group every row takes):
# many tiles of one group, and the plain-load path (no 16-byte alignment)
GMM_EDGE = [("one group of 300 rows", 16, 1, 300, 2048, 768, 7),
            ("unaligned K 100, N 50", 5, 2, 20, 100, 50, None)]
# the timed cells: (record key, label, experts, top-k, tokens, K, N)
GMM_TIMED = [("gmm", "qwen3 decode gate/up", 128, 8, 8, 2048, 768),
             ("gmm qwen3 chunk", "qwen3 chunk gate/up", 128, 8, 256, 2048, 768),
             ("gmm mixtral decode", "mixtral decode gate/up", 8, 2, 8, 4096, 14336)]


def gmm_offsets(torch, G: int, k: int, tokens: int, seed: int, only=None):
    """Group offsets (G + 1,) int32 on the card of tokens × k distinct
    random experts each, none of them group G // 2 (or every row in group
    ``only``), and how many groups hold a row."""
    import numpy as np

    rng = np.random.default_rng([seed, G, k, tokens])
    if only is not None:
        ids = np.full(tokens * k, only)
    else:
        pool = np.array([g for g in range(G) if g != G // 2])
        ids = np.concatenate([rng.choice(pool, k, replace=False) for _ in range(tokens)])
    counts = np.bincount(ids, minlength=G)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return torch.tensor(off, device="cuda"), int((counts > 0).sum())


def gmm_operands(torch, G: int, K: int, N: int, R: int, dtype, seed: int):
    """xs (R, K) and a bank (G, K, N) of dtype, random on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    xs = torch.randn((R, K), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((G, K, N), generator=gen, device="cuda") * K ** -0.5).to(dtype)
    return xs, w


def check_gmm(torch) -> list:
    """4l (a): gmm against its plain version at each GMM_CELLS and GMM_EDGE
    cell, bf16 and f32: NMSE < GMM_NMSE, finite, two calls bit-equal."""
    from superllama_tpu_torch.ops.grouped_matmul import grouped_matmul
    from superllama_tpu_torch.ops.ref import grouped_matmul_plain

    recs = []
    for label, G, k, tokens, K, N, only in [(*c, None) for c in GMM_CELLS] + GMM_EDGE:
        off, touched = gmm_offsets(torch, G, k, tokens, SEED + 120, only)
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            xs, w = gmm_operands(torch, G, K, N, tokens * k, dtype, SEED + 121)
            got = grouped_matmul(xs, w, off)
            again = grouped_matmul(xs, w, off)
            ref = grouped_matmul_plain(xs, w, off)
            torch.cuda.synchronize()
            rec = {"kernel": "gmm", "shape": f"{label} {dt}", "rows": tokens * k,
                   "groups": G, "groups_with_rows": touched, "nmse": nmse(got, ref),
                   "max_abs_err": float((got - ref).abs().max()),
                   "bit_equal_twice": bool(torch.equal(got, again))}
            recs.append(rec)
            check(bool(torch.isfinite(got).all()), f"gmm {label} {dt}: non-finite output")
            check(rec["nmse"] < GMM_NMSE, f"gmm {label} {dt}: nmse {rec['nmse']:g} against "
                  f"the plain version (limit {GMM_NMSE:g})")
            check(rec["bit_equal_twice"], f"gmm {label} {dt}: two calls differ")
            del xs, w, got, again, ref
    torch.cuda.empty_cache()
    emit({"phase": "moe_kernel_checks", "checks": recs})
    return recs


def gmm_library(torch, xs, w, offs):
    """One PyTorch call of the same product at each routing: (fn(i), its
    name). torch._grouped_mm with the same offsets (bf16 out) where this
    torch runs it on the card; else an eager per-expert torch.matmul loop
    over the host's bounds."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is not None:
        try:
            fn(xs, w, offs=offs[0][1:])
            torch.cuda.synchronize()
            return (lambda i: fn(xs, w, offs=offs[i % len(offs)][1:])), "torch._grouped_mm"
        except (RuntimeError, TypeError, ValueError) as e:
            emit({"phase": "moe_library", "torch._grouped_mm": str(e)[:300]})
    bounds = [o.tolist() for o in offs]

    def loop(i):
        o = bounds[i % len(bounds)]
        return [torch.matmul(xs[o[g]:o[g + 1]], w[g]) for g in range(w.shape[0])
                if o[g + 1] > o[g]]
    return loop, "per-expert torch.matmul loop"


def time_gmm(torch) -> dict:
    """4l (a): gmm's readings at GMM_TIMED, bf16, rotating over four
    routings of one bank (each call reads its experts from device memory:
    the experts a call touches exceed the L2). The bound counts the
    touched experts' bytes, xs and the f32 output once."""
    from superllama_tpu_torch.ops.grouped_matmul import grouped_matmul
    from superllama_tpu_torch.ops.ref import grouped_matmul_plain

    out = {}
    for key, label, G, k, tokens, K, N in GMM_TIMED:
        R = tokens * k
        xs, w = gmm_operands(torch, G, K, N, R, torch.bfloat16, SEED + 122)
        routes = [gmm_offsets(torch, G, k, tokens, SEED + 130 + j) for j in range(4)]
        offs = [o for o, _ in routes]
        touched = sum(t for _, t in routes) / len(routes)
        lib, lib_name = gmm_library(torch, xs, w, offs)
        row = kernel_reading(
            torch, f"gmm {label} R={R} bf16", lambda i: grouped_matmul(xs, w, offs[i % 4]),
            lambda i: grouped_matmul_plain(xs, w, offs[i % 4]), lib, 8,
            touched * K * N * 2 + R * K * 2 + R * N * 4, 2.0 * R * K * N, "bf16")
        row.update(library=lib_name, experts_touched=touched)
        out[key] = row
        del xs, w
    torch.cuda.empty_cache()
    return out


# Qwen3-30B-A3B's published widths (Qwen/Qwen3-30B-A3B config.json) at
# MOE_LAYERS of its 48 layers: 128 experts of 768, top 8, renormalised
MOE_LAYERS = 4
QWEN3_MOE = dict(arch="qwen3moe", n_embd=2048, n_layer=MOE_LAYERS, n_head=32, n_head_kv=4,
                 head_dim=128, head_dim_v=128, n_rot=128, n_ff=6144, n_vocab=151936,
                 rope_freq_base=1e6, rms_eps=1e-6)
QWEN3_MOE_EXPERTS = (128, 768)
QWEN3_MOE_KEYS = {"expert_count": 128, "expert_used_count": 8,
                  "expert_feed_forward_length": 768, "attention.key_length": 128,
                  "attention.value_length": 128}
# llama.cpp's Q4_K_M rules (ffn_down and its banks Q6_K); the router stays F32
QWEN3_MOE_TYPES = {**Q4_K_M_TYPES, "ffn_gate_exps": "Q4_K", "ffn_up_exps": "Q4_K",
                   "ffn_down_exps": "Q6_K"}


def router_weight(n: int, E: int, seed: int):
    """A router (n, E) f32 of logits' std about 2 over normed inputs."""
    import numpy as np

    return (np.random.default_rng([seed, n, E]).standard_normal((n, E))
            * (2.0 / math.sqrt(E))).astype(np.float32)


def qwen3_moe(torch, d: str, smi_line: str) -> dict:
    """4l (b): Qwen3-30B-A3B at full width, MOE_LAYERS deep, as a
    Q4_K_M-style file of rand_raw bytes (expert banks Q4_K / Q6_K, every
    layer layer 0's; the routers F32, seeded): written, loaded onto the
    card (banks as bf16) and its hparams checked; 16 greedy tokens on bf16,
    Q8_0 and paged caches held to the eager plain route by greedy_rule; a
    wave replayed against eager; the served wave of 8, B 1 / B 8 decode
    and the warm TTFT."""
    import gc

    import numpy as np

    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams

    hp = llama3_8b_hparams(**QWEN3_MOE)
    tok = grammar_tokenizer(hp.n_vocab)
    n, _ = QWEN3_MOE_EXPERTS
    f32 = {}
    for il in range(hp.n_layer):
        f32[f"blk.{il}.ffn_gate_inp.weight"] = router_weight(n, hp.n_embd, SEED + 140 + il)
        for qk in ("q", "k"):
            f32[f"blk.{il}.attn_{qk}_norm.weight"] = np.ones(hp.head_dim, np.float32)
    path = os.path.join(d, "synthetic-qwen3-30b-a3b-q4_k_m.gguf")
    t0 = time.perf_counter()
    write_file_model(path, hp, tok, QWEN3_MOE_TYPES, "synthetic-qwen3-30b-a3b-q4_k_m",
                     shared_layers=True, arch="qwen3moe", keys=QWEN3_MOE_KEYS,
                     experts=QWEN3_MOE_EXPERTS, f32_tensors=f32)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = load_model(path, dtype=torch.bfloat16, keep_quantized=True, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = model.hparams
    want = {"arch": "qwen3moe", "n_embd": 2048, "n_layer": MOE_LAYERS, "n_head": 32,
            "n_head_kv": 4, "head_dim": 128, "n_vocab": 151936, "n_expert": 128,
            "n_expert_used": 8, "n_ff_exp": 768, "expert_weights_norm": True,
            "expert_gating_softmax": True, "rope_freq_base": 1e6,
            "rms_eps": float(np.float32(1e-6))}     # the file's f32
    have = {k: getattr(got, k) for k in want}
    bank = model.params["layers"][0]["ffn_up_exps"]
    check(have == want and tuple(bank.shape) == (128, 2048, 768)
          and bank.dtype == torch.bfloat16,
          f"Qwen3-30B-A3B from the file: {have} (want {want}), bank {tuple(bank.shape)}")
    info = {"file_bytes": os.path.getsize(path), "write_s": write_s, "load_s": load_s,
            "depth": MOE_LAYERS, "hparams": have,
            "bank_bytes": sum(t.numel() * t.element_size() for layer in model.params["layers"]
                              for k, t in layer.items() if k.endswith("_exps"))}
    os.remove(path)
    label = "Qwen3-30B-A3B"
    t0 = time.perf_counter()
    info["decode"] = arch_decode(torch, model, label, need=("gmm",))
    info["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (rec,) = phase_graph_vs_eager(torch, model, GRAPH_CASES[:1], ("greedy",), n_ctx=512)
    check(rec["launches"]["gmm"] > 0, f"{label}: the graph wave never launched gmm")
    info["graph_vs_eager"] = {k: rec[k] for k in ("tokens_equal", "rows_equal", "graph_blocks")}
    info["graph_vs_eager_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["serving"] = arch_serving(torch, model, label, need=("gmm",))
    info["serving"]["seconds"] = time.perf_counter() - t0
    info["card"] = smi_line
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return info


# the sweep: 2 layers, 1,024 wide, 8 heads of 128 over 2 kv heads, 8 experts
# of 1,024 (top 2), a 32,000-piece vocab; Q4_K matmul weights and banks of
# rand_raw bytes (gpt-oss: MXFP4 banks), F32 routers, norms and biases
MOE_SWEEP = dict(E=1024, H=8, HKV=2, D=128, F=2816, L=2, V=32000, n=8, k=2, f=1024)
MOE_SWEEP_FAMILIES = ("mixtral", "gpt-oss", "grovemoe", "arctic", "grok", "qwen2moe",
                      "glm4moe")


def moe_sweep_file(path: str, family: str) -> str:
    """A 2-layer GGUF of one MoE family at MOE_SWEEP's widths: the family's
    own tensors and metadata (gpt-oss: MXFP4 banks, q/k/v/o, router and
    expert biases, sinks, a 128 window; grovemoe: two chunk experts of 256
    over groups of 4; arctic: a dense FFN and ffn_norm_exps; grok: a dense
    FFN beside the MoE; qwen2moe: a shared expert with a 1-D gate, qkv
    biases; glm4moe: a dense first layer, sigmoid routing over 2 groups
    with the selection bias, a shared expert, routed scale 2.5)."""
    import numpy as np

    from superllama_tpu_torch.gguf import GGMLType, GGUFWriter
    from superllama_tpu_torch.models.synthetic import rand_raw

    E, H, HKV, D, F, L, V, n, k, f = (MOE_SWEEP[x] for x in
                                      ("E", "H", "HKV", "D", "F", "L", "V", "n", "k", "f"))
    rng = np.random.default_rng([SEED + 150, *family.encode()])
    seed = iter(range(SEED + 200, SEED + 10_000))
    w = GGUFWriter(path, arch=family)
    meta = {"context_length": 2048, "embedding_length": E, "block_count": L,
            "feed_forward_length": F, "attention.head_count": H,
            "attention.head_count_kv": HKV, "attention.key_length": D,
            "attention.value_length": D, "rope.dimension_count": D, "vocab_size": V,
            "rope.freq_base": 10000.0, "attention.layer_norm_rms_epsilon": 1e-5,
            "expert_count": n, "expert_used_count": k, "expert_feed_forward_length": f}
    meta.update({"gpt-oss": {"attention.sliding_window": 128},
                 "grovemoe": {"experts_per_group": 4, "expert_group_scale": 0.05,
                              "expert_chunk_feed_forward_length": 256},
                 "qwen2moe": {"expert_shared_feed_forward_length": f},
                 "glm4moe": {"expert_shared_feed_forward_length": f, "expert_gating_func": 2,
                             "expert_group_count": 2, "expert_group_used_count": 1,
                             "expert_weights_scale": 2.5, "expert_weights_norm": True,
                             "leading_dense_block_count": 1, "rope.dimension_count": 64}
                 }.get(family, {}))
    w.add("general.name", f"moe-sweep-{family}")
    for key, v in meta.items():
        w.add(f"{family}.{key}", v)

    def q(name, N, K, t=GGMLType.Q4_K, n_exp=0):
        raw = rand_raw(t, N * max(n_exp, 1), K, next(seed))
        w.add_tensor(name, raw, t, raw_ne=(K, N, n_exp) if n_exp else (K, N))

    def f32(name, *shape, scale=0.05, one=False):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        w.add_tensor(name, a + 1.0 if one else a)

    q("token_embd.weight", V, E)
    f32("output_norm.weight", E, one=True)
    q("output.weight", V, E)
    bank_t = GGMLType.MXFP4 if family == "gpt-oss" else GGMLType.Q4_K
    for il in range(L):
        b = f"blk.{il}."
        f32(b + "attn_norm.weight", E, one=True)
        f32(b + "ffn_norm.weight", E, one=True)
        q(b + "attn_q.weight", H * D, E)
        q(b + "attn_k.weight", HKV * D, E)
        q(b + "attn_v.weight", HKV * D, E)
        q(b + "attn_output.weight", E, H * D)
        if family in ("gpt-oss", "qwen2moe", "glm4moe"):
            for x, width in (("q", H * D), ("k", HKV * D), ("v", HKV * D)):
                f32(b + f"attn_{x}.bias", width)
        if family == "gpt-oss":
            f32(b + "attn_output.bias", E)
            f32(b + "attn_sinks.weight", H, scale=1.0)
        if family == "grovemoe":
            f32(b + "attn_q_norm.weight", D, one=True)
            f32(b + "attn_k_norm.weight", D, one=True)
        if family == "grok":
            f32(b + "attn_output_norm.weight", E, one=True)
            f32(b + "layer_output_norm.weight", E, one=True)
        if family in ("arctic", "grok") or (family == "glm4moe" and il == 0):
            q(b + "ffn_gate.weight", F, E)
            q(b + "ffn_up.weight", F, E)
            q(b + "ffn_down.weight", E, F)
        if family == "glm4moe" and il == 0:
            continue                               # the dense lead layer
        if family == "arctic":
            f32(b + "ffn_norm_exps.weight", E, one=True)
        w.add_tensor(b + "ffn_gate_inp.weight", router_weight(n, E, next(seed)))
        q(b + "ffn_gate_exps.weight", f, E, bank_t, n)
        q(b + "ffn_up_exps.weight", f, E, bank_t, n)
        q(b + "ffn_down_exps.weight", E, f, bank_t, n)
        if family == "gpt-oss":
            f32(b + "ffn_gate_inp.bias", n, scale=0.5)
            for part, width in (("gate", f), ("up", f), ("down", E)):
                f32(b + f"ffn_{part}_exps.bias", n, width)
        if family == "grovemoe":
            q(b + "ffn_gate_chexps.weight", 256, E, n_exp=n // 4)
            q(b + "ffn_up_chexps.weight", 256, E, n_exp=n // 4)
            q(b + "ffn_down_chexps.weight", E, 256, n_exp=n // 4)
        if family in ("qwen2moe", "glm4moe"):
            q(b + "ffn_gate_shexp.weight", f, E)
            q(b + "ffn_up_shexp.weight", f, E)
            q(b + "ffn_down_shexp.weight", E, f)
        if family == "qwen2moe":
            f32(b + "ffn_gate_inp_shexp.weight", E, scale=E ** -0.5)
        if family == "glm4moe":
            f32(b + "exp_probs_b.bias", n, scale=0.1)
    w.write()
    return path


def moe_sweep_family(torch, d: str, family: str) -> dict:
    """One family's file loaded onto the card and onto the host: a 32-token
    prompt's first-token logits through the card's kernels (gmm launched)
    against the port's CPU plain forward of the same file (ARCH_NMSE)."""
    import gc

    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.runtime.kv_cache import kv_cache_init

    t0 = time.perf_counter()
    path = moe_sweep_file(os.path.join(d, f"moe-sweep-{family}.gguf"), family)
    models = {dev: load_model(path, dtype=torch.bfloat16, keep_quantized=True, device=dev)
              for dev in ("cuda", "cpu")}
    hp = models["cuda"].hparams
    prompt = token_prompts(hp.n_vocab, [32], SEED + 86)[0]
    first = {}
    reset_counts()
    for dev, m in models.items():
        cache = kv_cache_init(hp.n_layer, 1, 64, hp.n_head_kv, hp.head_dim, hp.head_dim_v,
                              dtype=torch.bfloat16, device=dev)
        with torch.no_grad():
            lg, _ = llama_forward(m.params, hp, torch.tensor([prompt], device=dev),
                                  torch.arange(32, dtype=torch.int32, device=dev)[None], cache)
        first[dev] = lg[0, -1].float().cpu()
    counts = read_counts()
    err = nmse(first["cuda"], first["cpu"])
    check(bool(torch.isfinite(first["cuda"]).all()), f"MoE sweep {family}: non-finite logits")
    check(err < ARCH_NMSE, f"MoE sweep {family}: card against CPU plain forward nmse {err:g}")
    check(counts["gmm"] > 0, f"MoE sweep {family}: gmm never launched")
    info = {"family": family, "arch": hp.arch, "n_expert": hp.n_expert,
            "first_token_nmse": err, "nmse_bound": ARCH_NMSE,
            "argmax_agree": bool(first["cuda"].argmax() == first["cpu"].argmax()),
            "launches": {k: counts[k] for k in ("gmm", "qmm", "fa_tc")},
            "seconds": time.perf_counter() - t0}
    os.remove(path)
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return info


def phase_moe(torch, smi_line: str) -> dict:
    """4l. Sparse mixture of experts on the card: gmm against its plain
    version and its times (a), the Qwen3-30B-A3B-width model served (b),
    the sweep of MoE families against the CPU (c). ``launches`` is gmm's
    count in (b)'s serving wave."""
    import shutil
    import tempfile

    t_all = time.perf_counter()
    checks = check_gmm(torch)
    times = time_gmm(torch)
    emit({"phase": "moe_kernel_times", "card": smi_line, "kernels": times})
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    d = tempfile.mkdtemp(prefix="moe_", dir=build)
    try:
        info = {"phase": "moe", "card": smi_line, "qwen3_30b_a3b": qwen3_moe(torch, d, smi_line)}
        info["sweep"] = [moe_sweep_family(torch, d, fam) for fam in MOE_SWEEP_FAMILIES]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    info["seconds"] = time.perf_counter() - t_all
    emit(info)
    return {"checks": checks, "times": times,
            "launches": info["qwen3_30b_a3b"]["serving"]["launches"]["gmm"]}


# ------------------------------------------------------------ 4m. MLA and llama4

MLA_LAYERS = 4
# DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite config.json): 2,048 wide, 16
# heads of qk_nope 128 + qk_rope 64 over a 512-wide KV latent, v 128, no q
# LoRA; layer 0 dense (10,944), then 64 routed experts of 1,408 (top 6,
# softmax, not renormalised) and 2 shared; a 102,400-piece vocab; its YaRN
# keys (the forward keeps the JAX package's linear rope, ROADMAP §3).
# MLA_LAYERS of its 27 layers: 1 dense, 3 MoE
DSV2_LITE = dict(arch="deepseek2", n_embd=2048, n_layer=MLA_LAYERS, n_head=16, n_head_kv=16,
                 head_dim=192, head_dim_v=128, n_rot=64, n_ff=10944, n_vocab=102400,
                 rope_freq_base=10000.0, rms_eps=1e-6)
DSV2_LITE_EXPERTS = (64, 1408)
DSV2_LITE_KEYS = {"attention.key_length": 192, "attention.value_length": 128,
                  "attention.kv_lora_rank": 512, "expert_count": 64, "expert_used_count": 6,
                  "expert_shared_count": 2, "expert_feed_forward_length": 1408,
                  "leading_dense_block_count": 1, "expert_weights_scale": 1.0,
                  "rope.scaling.type": "yarn", "rope.scaling.factor": 40.0,
                  "rope.scaling.original_context_length": 4096}
# llama.cpp's Q4_K_M rules by role (attn_kv_b, whose V half is attn_v's
# role, Q6_K); a K that is no multiple of 256 (the dense ffn_down's 10,944,
# the experts' 1,408) takes Q6_K's fallback, Q8_0
DSV2_LITE_TYPES = {**Q4_K_M_TYPES, "attn_kv_a_mqa": "Q4_K", "attn_kv_b": "Q6_K",
                   "ffn_down": "Q8_0", "ffn_gate_exps": "Q4_K", "ffn_up_exps": "Q4_K",
                   "ffn_down_exps": "Q8_0", "ffn_gate_shexp": "Q4_K", "ffn_up_shexp": "Q4_K",
                   "ffn_down_shexp": "Q6_K"}
# Llama-4-Scout-17B-16E (meta-llama/Llama-4-Scout-17B-16E config.json, its
# text_config): 5,120 wide, 40 heads over 8 kv heads of 128, 16 experts of
# 8,192 (top 1 on raw logits, the sigmoid after, weights before the
# experts) and a shared expert of 8,192, a 202,048-piece vocab, chunked
# attention of 8,192 on the rope layers, NoPE every 4th layer with
# temperature tuning (floor 8,192, scale 0.1), the L2 q/k norm; rope theta
# 500,000 without its llama3 per-dim factors. MLA_LAYERS of its 48 layers:
# layer 3 NoPE
SCOUT = dict(arch="llama4", n_embd=5120, n_layer=MLA_LAYERS, n_head=40, n_head_kv=8,
             head_dim=128, head_dim_v=128, n_rot=128, n_ff=16384, n_vocab=202048,
             rope_freq_base=500000.0, rms_eps=1e-5)
SCOUT_EXPERTS = (16, 8192)
SCOUT_KEYS = {"expert_count": 16, "expert_used_count": 1, "expert_feed_forward_length": 8192,
              "attention.chunk_size": 8192, "attention.temperature_tuning": True,
              "attention.floor_scale": 8192.0, "no_rope_layer_step": 4,
              "attention.key_length": 128, "attention.value_length": 128}
SCOUT_TYPES = {**Q4_K_M_TYPES, "ffn_gate_exps": "Q4_K", "ffn_up_exps": "Q4_K",
               "ffn_down_exps": "Q6_K", "ffn_gate_shexp": "Q4_K", "ffn_up_shexp": "Q4_K",
               "ffn_down_shexp": "Q6_K"}
# a prompt past Scout's 8,192-token chunk: its last 208 positions attend
# within the second chunk, and from position 8,191 on the NoPE layer's
# temperature term is above 1
SCOUT_PROMPT = 8400
SCOUT_N_CTX = 8704
MLA_KEYS = ("qmv", "qmm", "gmm", "fa_tc", "fa", "fd", "paged")


def shexp_shapes(b: str, E: int, F: int) -> dict:
    return {b + "ffn_gate_shexp.weight": ("ffn_gate_shexp", F, E),
            b + "ffn_up_shexp.weight": ("ffn_up_shexp", F, E),
            b + "ffn_down_shexp.weight": ("ffn_down_shexp", E, F)}


def mla_file_model(torch, d: str, which: str):
    """DeepSeek-V2-Lite or Llama-4-Scout at its published widths,
    MLA_LAYERS deep, as a Q4_K_M-style file of rand_raw bytes (every layer
    of a kind layer 0's or 1's; routers F32, seeded): written, loaded
    packed onto the card (banks as bf16), its hparams checked against the
    published config. Returns (model, info)."""
    import numpy as np

    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams

    ds = which == "deepseek2"
    hp = llama3_8b_hparams(**(DSV2_LITE if ds else SCOUT))
    E, V = hp.n_embd, hp.n_vocab
    n, f = DSV2_LITE_EXPERTS if ds else SCOUT_EXPERTS
    f32 = {}
    if ds:
        H, dn, dr, dv, rkv = 16, 128, 64, 128, 512
        shapes = {"token_embd.weight": ("token_embd", V, E), "output.weight": ("output", V, E)}
        for il in range(hp.n_layer):
            b = f"blk.{il}."
            shapes.update({b + "attn_q.weight": ("attn_q", H * (dn + dr), E),
                           b + "attn_kv_a_mqa.weight": ("attn_kv_a_mqa", rkv + dr, E),
                           b + "attn_kv_b.weight": ("attn_kv_b", H * (dn + dv), rkv),
                           b + "attn_output.weight": ("attn_output", E, H * dv)})
            f32[b + "attn_kv_a_norm.weight"] = np.ones(rkv, np.float32)
            if il == 0:
                shapes.update({b + "ffn_gate.weight": ("ffn_gate", hp.n_ff, E),
                               b + "ffn_up.weight": ("ffn_up", hp.n_ff, E),
                               b + "ffn_down.weight": ("ffn_down", E, hp.n_ff)})
                continue
            shapes.update({b + "ffn_gate_exps.weight": ("ffn_gate_exps", n * f, E, n),
                           b + "ffn_up_exps.weight": ("ffn_up_exps", n * f, E, n),
                           b + "ffn_down_exps.weight": ("ffn_down_exps", n * E, f, n),
                           **shexp_shapes(b, E, 2 * f)})
            f32[b + "ffn_gate_inp.weight"] = router_weight(n, E, SEED + 160 + il)
        types, keys, name = DSV2_LITE_TYPES, DSV2_LITE_KEYS, "synthetic-deepseek-v2-lite"
    else:
        shapes = weight_shapes(hp, experts=(n, f))
        for il in range(hp.n_layer):
            shapes.update(shexp_shapes(f"blk.{il}.", E, f))
            f32[f"blk.{il}.ffn_gate_inp.weight"] = router_weight(n, E, SEED + 170 + il)
        types, keys, name = SCOUT_TYPES, SCOUT_KEYS, "synthetic-llama4-scout"
    tok = grammar_tokenizer(V)
    path = os.path.join(d, f"{name}-q4_k_m.gguf")
    t0 = time.perf_counter()
    write_file_model(path, hp, tok, types, f"{name}-q4_k_m", shared_layers=True, arch=hp.arch,
                     keys=keys, f32_tensors=f32, shapes=shapes)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = load_model(path, dtype=torch.bfloat16, keep_quantized=True, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = model.hparams
    if ds:
        want = {"arch": "deepseek2", "n_embd": 2048, "n_layer": MLA_LAYERS, "n_head": 16,
                "n_head_kv": 16, "head_dim": 192, "head_dim_v": 128, "n_rot": 64,
                "q_lora_rank": 0, "kv_lora_rank": 512, "n_expert": 64, "n_expert_used": 6,
                "n_ff_exp": 1408, "n_expert_shared": 2, "n_layer_dense_lead": 1,
                "expert_weights_norm": False, "expert_gating_softmax": True, "n_vocab": 102400}
    else:
        want = {"arch": "llama4", "n_embd": 5120, "n_layer": MLA_LAYERS, "n_head": 40,
                "n_head_kv": 8, "head_dim": 128, "n_expert": 16, "n_expert_used": 1,
                "n_ff_exp": 8192, "n_vocab": 202048, "swa_window": 0,
                "n_no_rope_layer_step": 4, "rope_freq_base": 500000.0}
    have = {k: getattr(got, k) for k in want}
    ok = have == want
    if not ds:
        ok &= got.extra.get("llama4") == {"temp_tuning": True, "floor_scale": 8192.0,
                                          "attn_scale": 0.1, "chunk": 8192}
    bank = model.params["layers"][1]["ffn_up_exps"]
    check(ok and tuple(bank.shape) == (n, E, f) and bank.dtype == torch.bfloat16,
          f"{which} from the file: {have} (want {want}), extra {got.extra}, "
          f"bank {tuple(bank.shape)}")
    info = {"file_bytes": os.path.getsize(path), "write_s": write_s, "load_s": load_s,
            "depth": MLA_LAYERS, "hparams": have,
            "bank_bytes": sum(t.numel() * t.element_size() for layer in model.params["layers"]
                              for k, t in layer.items() if k.endswith("_exps"))}
    os.remove(path)
    return model, info


def scout_long_prompt(torch, model) -> dict:
    """The SCOUT_PROMPT-token prompt and ARCH_DECODE greedy tokens on a
    one-slot Engine (its measured run after a warm one: every chunk and
    block a replay), held to the eager plain route by greedy_rule; gmm and
    fa_tc (the NoPE layer's chunks) launched; the TTFT."""
    import gc

    from superllama_tpu_torch.runtime.engine import Engine

    hp = model.hparams
    prompt = token_prompts(hp.n_vocab, [SCOUT_PROMPT], SEED + 84)[0]
    eng = Engine(model, n_slots=1, n_ctx=SCOUT_N_CTX, device="cuda", kv_dtype=torch.bfloat16)

    def gen():
        fresh(eng)
        return eng.generate(prompt, max_tokens=ARCH_DECODE, sampling={"greedy": True},
                            stop_eog=False)

    try:
        gen()                           # captures its chunks and blocks
        with eng._step_lock:
            stats0 = block_stats(eng)
            reset_counts()
        r = gen()
        with eng._step_lock:
            torch.cuda.synchronize()
            counts = read_counts()
            replayed = check_replayed("Llama-4-Scout long prompt", stats0, block_stats(eng))
    finally:
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("qmv", "gmm", "fa_tc"):
        check(counts[name] > 0, f"Llama-4-Scout long prompt never launched {name}")
    ref = plain_greedy(torch, model, prompt, ARCH_DECODE, n_ctx=SCOUT_N_CTX)
    # top-1 routing: where the paths part beyond their limit, a router near
    # tie must explain it (router_tie)
    taps: dict = {}
    rule = greedy_rule(torch, model, "Llama-4-Scout long prompt", prompt, ref, r["tokens"], 1, 1,
                       paths=route_paths(torch, model, prompt, n_ctx=SCOUT_N_CTX, taps=taps),
                       n_ctx=SCOUT_N_CTX, taps=taps)
    return {"tokens": len(prompt), "greedy_rule": rule, "ttft_ms": r["ttft_s"] * 1e3,
            "blocks": replayed, "launches": {k: counts[k] for k in MLA_KEYS}}


def mla_refuses_q8_0(torch, model) -> bool:
    """A DeepSeek2 request on a Q8_0 cache fails with the forward's
    ValueError rather than serve (eager engine: the refusal comes before
    any step)."""
    from superllama_tpu_torch.runtime.engine import Engine

    eng = Engine(model, n_slots=1, n_ctx=64, device="cuda", kv_dtype="q8_0", graphs=False)
    try:
        eng.generate(token_prompts(model.hparams.n_vocab, [8], SEED + 85)[0], max_tokens=2,
                     stop_eog=False)
    except ValueError as e:
        return "float KV cache" in str(e)
    finally:
        del eng
    return False


def mla_model_phase(torch, d: str, which: str, smi_line: str) -> dict:
    """One model of 4m: written and loaded (mla_file_model); DeepSeek2's
    greedy tokens on a bf16 cache held to the plain route (arch_decode) and
    its Q8_0 refusal, or Scout's long prompt (scout_long_prompt); a wave
    replayed against eager; the served wave, B 1 / B 8 and the warm TTFT."""
    import gc

    label = "DeepSeek-V2-Lite" if which == "deepseek2" else "Llama-4-Scout"
    t_all = time.perf_counter()
    model, info = mla_file_model(torch, d, which)
    t0 = time.perf_counter()
    if which == "deepseek2":
        info["decode"] = arch_decode(torch, model, label, need=("gmm",),
                                     caches=DECODE_CACHES[:1])
        info["refuses_q8_0_cache"] = mla_refuses_q8_0(torch, model)
        check(info["refuses_q8_0_cache"], f"{label}: a Q8_0 cache was not refused")
    else:
        info["long_prompt"] = scout_long_prompt(torch, model)
    info["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (rec,) = phase_graph_vs_eager(torch, model, GRAPH_CASES[:1], ("greedy",), n_ctx=512)
    check(rec["launches"]["gmm"] > 0, f"{label}: the graph wave never launched gmm")
    info["graph_vs_eager"] = {k: rec[k] for k in ("tokens_equal", "rows_equal", "graph_blocks",
                                                  "launches")}
    info["graph_vs_eager_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["serving"] = arch_serving(torch, model, label, need=("gmm",),
                                   attn=() if which == "deepseek2" else ("fa_tc",))
    info["serving"]["seconds"] = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    info = {"phase": f"mla_{which}", "model": label, "card": smi_line, **info,
            "seconds": time.perf_counter() - t_all}
    emit(info)
    return info


def held_route_times(torch) -> dict:
    """The attention routes that ROADMAP §2 holds (items 17-19), timed by
    CUDA events at served shapes (bf16, random inputs), beside the kernel
    each could take: MLA's plain attention (DeepSeek-V2-Lite's 16 heads, D
    192, Dv 128; ``attention_ref``, as ``deepseek2_forward`` calls it) at a
    decode step of 8 rows over 512 slots and at a 512-token chunk, the
    chunk also through fa_tc; llama4's chunked rope layer on the plain
    path (a 2,048-token chunk at positions 6,352-8,399 over 8,704 slots,
    40/8 heads of 128; ``attention_gqa`` with the chunk mask) against
    fa_tc without the chunk bound; an iSWA decode step's plain attention
    over Command-R7B's wrapped 4,352-slot ring (8 rows, 32/8 heads,
    window 4,096) against fd over it."""
    from superllama_tpu_torch.models.llama import _chunk_mask
    from superllama_tpu_torch.ops import ref as ops
    from superllama_tpu_torch.ops.flash_attention import (flash_attention,
                                                          flash_decode_attention)
    from superllama_tpu_torch.runtime.kv_cache import causal_mask

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 90)
    i32 = dict(dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    out = {}
    # MLA: a decode step, then a chunk
    S = 512
    kv_pos = torch.arange(S, **i32)[None].expand(8, S).contiguous()
    k, v = rnd(8, 16, S, 192), rnd(8, 16, S, 128)
    q = rnd(8, 1, 16, 192)
    q_pos = torch.full((8, 1), S - 1, **i32)
    mask = causal_mask(kv_pos, q_pos)
    out["mla_decode_b8_s512_plain_ms"] = cuda_ms(
        torch, lambda i: ops.attention_ref(q, k, v, mask, scale=192 ** -0.5), 20)
    q, k, v = rnd(1, S, 16, 192), k[:1].contiguous(), v[:1].contiguous()
    q_pos = torch.arange(S, **i32)[None]
    mask = causal_mask(kv_pos[:1], q_pos)
    out["mla_chunk512_plain_ms"] = cuda_ms(
        torch, lambda i: ops.attention_ref(q, k, v, mask, scale=192 ** -0.5), 10)
    out["mla_chunk512_fa_tc_ms"] = cuda_ms(
        torch, lambda i: flash_attention(q, k, v, q_pos, kv_pos[:1], scale=192 ** -0.5), 20)
    # llama4: a rope layer's 2,048-token chunk past the 8,192 chunk bound
    S, T, end = 8704, 2048, SCOUT_PROMPT
    kv_pos = torch.where(torch.arange(S, **i32) < end, torch.arange(S, **i32), -1)[None]
    k, v, q = rnd(1, 8, S, 128), rnd(1, 8, S, 128), rnd(1, T, 40, 128)
    q_pos = torch.arange(end - T, end, **i32)[None]
    mask = _chunk_mask(causal_mask(kv_pos, q_pos), kv_pos, q_pos, 8192)
    out["llama4_chunk2048_plain_ms"] = cuda_ms(
        torch, lambda i: ops.attention_gqa(q, k, v, mask, scale=128 ** -0.5), 5)
    out["llama4_chunk2048_fa_tc_no_bound_ms"] = cuda_ms(
        torch, lambda i: flash_attention(q, k, v, q_pos, kv_pos, scale=128 ** -0.5), 20)
    del mask
    # iSWA: a decode step of 8 rows over the wrapped ring
    S = ISWA_RING
    p = torch.arange(4600 - S, 4600, **i32)
    kv_pos = torch.empty(S, **i32)
    kv_pos[p % S] = p
    kv_pos = kv_pos[None].expand(8, S).contiguous()
    k, v, q = rnd(8, 8, S, 128), rnd(8, 8, S, 128), rnd(8, 1, 32, 128)
    q_pos = torch.full((8, 1), 4599, **i32)
    mask = causal_mask(kv_pos, q_pos, 4096)
    out["iswa_decode_b8_ring4352_plain_ms"] = cuda_ms(
        torch, lambda i: ops.attention_gqa(q, k, v, mask, scale=128 ** -0.5), 20)
    out["iswa_decode_b8_ring4352_fd_ms"] = cuda_ms(
        torch, lambda i: flash_decode_attention(q, k, v, q_pos, kv_pos, scale=128 ** -0.5,
                                                swa_window=4096), 20)
    torch.cuda.empty_cache()
    return out


def phase_mla(torch, smi_line: str) -> dict:
    """4m. The remaining attention forms at full width: DeepSeek-V2-Lite's
    multi-head latent attention and Llama-4-Scout's chunked attention, each
    MLA_LAYERS deep from a rand_raw file."""
    import shutil
    import tempfile

    t_all = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    d = tempfile.mkdtemp(prefix="mla_", dir=build)
    try:
        out = {which: mla_model_phase(torch, d, which, smi_line)
               for which in ("deepseek2", "llama4")}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out["held_routes"] = held_route_times(torch)
    emit({"phase": "mla_held_routes", "card": smi_line, **out["held_routes"]})
    emit({"phase": "mla", "card": smi_line, "seconds": time.perf_counter() - t_all})
    return out


# ------------------------------------------------------------ 4n. state-space models

SCAN_NMSE = 1e-9     # the kernel's y (its sum over the states in another order) and state
# (label, rows, T, heads, head dim, d_state, groups, A a state): falcon-mamba-7B's
# Mamba-1 (d_inner 8,192 channels of one, d_state 16) and Bamba-9B's Mamba-2
# (128 heads of 64, d_state 128, one group; and 8 groups) at a decode step of 8
# rows and a 256-token chunk
SCAN_CASES = [("falcon-mamba-7B decode", 8, 1, 8192, 1, 16, 1, True),
              ("falcon-mamba-7B chunk", 1, 256, 8192, 1, 16, 1, True),
              ("Bamba-9B decode", 8, 1, 128, 64, 128, 1, False),
              ("Bamba-9B chunk", 1, 256, 128, 64, 128, 1, False),
              ("Bamba-9B G8 chunk", 1, 256, 128, 64, 128, 8, False)]
SCAN_RECORD = "Bamba-9B decode"      # the kernel record's reading: a served decode step


def scan_operands(torch, Bt, T, nh, hd, ds, G, a2, seed: int, state_dtype):
    """[state, x, dt, A, B, C] of one scan call, random on the card: dt
    softplus'd, A = -exp(.), the state of state_dtype."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return [(0.5 * rnd(Bt, nh, hd, ds)).to(state_dtype), rnd(Bt, T, nh, hd),
            torch.nn.functional.softplus(rnd(Bt, T, nh)),
            -torch.exp(0.5 * (rnd(nh, ds) if a2 else rnd(nh))), rnd(Bt, T, G, ds),
            rnd(Bt, T, G, ds)]


def scan_work(Bt, T, nh, hd, ds, G, a2, state_bytes: int) -> tuple[float, float]:
    """(bytes, f32 operations) of one scan call: the state read and written,
    x, dt, A, B, C read and y written once; five operations a state element
    a step (two products, the decay, the add, the read-out's product and
    sum), the exp of a decay (a state element's with mamba1's A, a head's
    with a scalar one) and dt·x."""
    n = Bt * nh * hd * ds
    nbytes = (2 * n * state_bytes + 2 * Bt * T * nh * hd * 4 + Bt * T * nh * 4
              + 2 * Bt * T * G * ds * 4 + (nh * ds if a2 else nh) * 4)
    ops = T * (5 * n + (n if a2 else Bt * nh) + Bt * nh * hd)
    return nbytes, ops


# the (K, N) the SSM models add to qmv's and qmm's served shapes: Bamba-9B's
# ssm_in (N = 2 d_inner + 2 G d_state + heads) and ssm_out, falcon-mamba-7B's
# ssm_in, ssm_x (N = dt rank + 2 d_state) and ssm_dt (K = the dt rank, one
# super-block)
SSM_KN = {"Bamba-9B ssm_in": (4096, 16768), "Bamba-9B ssm_out": (8192, 4096),
          "falcon-mamba-7B ssm_in": (4096, 16384), "falcon-mamba-7B ssm_x": (8192, 288),
          "falcon-mamba-7B ssm_dt": (256, 8192)}


def time_ssm_matmuls(torch) -> dict:
    """4n (a): qmv (M 8, a decode step's rows) and qmm (M 32, a chunk's at
    most) at each SSM_KN shape, Q4_K, beside torch.matmul on the
    dequantized weight (matmul_reading)."""
    from superllama_tpu_torch.ops.qmatmul import qmm, qmm_plain, qmv, qmv_plain

    out = {}
    for label, (K, N) in SSM_KN.items():
        out[f"qmv {label}"] = matmul_reading(torch, qmv, qmv_plain, "Q4_K", 8, K, N, "int8")
        out[f"qmm {label}"] = matmul_reading(torch, qmm, qmm_plain, "Q4_K", 32, K, N, "bf16")
    torch.cuda.empty_cache()
    return out


def check_ssm_scan(torch) -> tuple[list, dict]:
    """4n (a): ssm_scan against its plain loop at each SCAN_CASES shape, with
    f32 and bf16 state, all rows and every other row idle: y and the state
    within SCAN_NMSE, finite, the idle rows' state untouched, two calls
    bit-equal. Then each shape's reading (bf16 state, the served type), over
    copies of the inputs past the L2, from a CUDA graph; no PyTorch call
    computes a scan, so the row has no library time."""
    from superllama_tpu_torch.ops.ref import ssm_scan_plain
    from superllama_tpu_torch.ops.ssm_scan import ssm_scan

    recs = []
    for label, Bt, T, nh, hd, ds, G, a2 in SCAN_CASES:
        for sd, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            st, *ins = scan_operands(torch, Bt, T, nh, hd, ds, G, a2, SEED + 200, dtype)
            idle = torch.arange(Bt, device="cuda") % 2 == 0
            for act in [None] + ([idle] if Bt > 1 else []):
                s1, s2, s3 = st.clone(), st.clone(), st.clone()
                got = ssm_scan(s1, *ins, act)
                again = ssm_scan(s3, *ins, act)
                ref = ssm_scan_plain(s2, *ins, act)
                torch.cuda.synchronize()
                rec = {"kernel": "ssm_scan", "shape": f"{label} B{Bt} T{T} {sd} state"
                       + (" idle rows" if act is not None else ""),
                       "nmse": nmse(got, ref), "state_nmse": nmse(s1.float(), s2.float()),
                       "max_abs_err": float((got - ref).abs().max()),
                       "state_equal": bool(torch.equal(s1, s2)),
                       "bit_equal_twice": bool(torch.equal(got, again) and torch.equal(s1, s3))}
                recs.append(rec)
                check(bool(torch.isfinite(got).all() and torch.isfinite(s1.float()).all()),
                      f"ssm_scan {rec['shape']}: non-finite output")
                check(rec["nmse"] < SCAN_NMSE and rec["state_nmse"] < SCAN_NMSE,
                      f"ssm_scan {rec['shape']}: nmse {rec['nmse']:g}, state "
                      f"{rec['state_nmse']:g} against the plain loop (limit {SCAN_NMSE:g})")
                check(rec["bit_equal_twice"], f"ssm_scan {rec['shape']}: two calls differ")
                if act is not None:
                    check(bool(torch.equal(s1[1::2], st[1::2])),
                          f"ssm_scan {rec['shape']}: an idle row's state changed")
            del st, ins
    emit({"phase": "ssm_kernel_checks", "checks": recs})
    times = {}
    for label, Bt, T, nh, hd, ds, G, a2 in SCAN_CASES:
        nbytes, ops = scan_work(Bt, T, nh, hd, ds, G, a2, 2)
        n = n_copies(nbytes)
        sets = [scan_operands(torch, Bt, T, nh, hd, ds, G, a2, SEED + 210 + j, torch.bfloat16)
                for j in range(n)]
        call = lambda i: ssm_scan(*sets[i % n])              # noqa: E731
        plain = lambda i: ssm_scan_plain(*sets[i % n])       # noqa: E731
        ms = graph_ms(torch, call, n)
        b, by = bound(nbytes, ops, "f32")
        row = {"shape": f"{label} B{Bt} T{T} bf16 state", "ms": ms,
               "ms_eager": cuda_ms(torch, call, 2 * n), "plain_ms": cuda_ms(torch, plain, 3, 1),
               "library_ms": None, "bound_ms": b, "bound_by": by, "bytes": nbytes, "ops": ops,
               "gbps": nbytes / ms / 1e6, "share_of_bound": b / ms, "rotated_copies": n}
        check(row["share_of_bound"] <= 1.0,
              f"ssm_scan {label}: {ms:g} ms is below the {b:g} ms bound: a mis-measurement")
        times[label] = row
        del sets
    torch.cuda.empty_cache()
    return recs, times


# Bamba-9B (ibm-ai-platform/Bamba-9B config.json, GGUF arch granitehybrid):
# 4,096 wide, 32 layers, attention (32 heads over 8 kv heads of 128, rope) at
# layers 9, 18 and 27, the others Mamba-2 (128 heads of 64, d_state 128, one
# group, d_conv 4, d_inner 8,192), an FFN of 14,336 after every layer, a
# 128,256-piece vocab, multipliers 1. SSM_LAYERS of its layers: the first
# ten keep attention layer 9
SSM_LAYERS = 10
BAMBA = dict(arch="granitehybrid", n_embd=4096, n_layer=SSM_LAYERS, n_head=32, n_head_kv=8,
             head_dim=128, head_dim_v=128, n_rot=128, n_ff=14336, n_vocab=128256,
             rope_freq_base=10000.0, rms_eps=1e-5)
BAMBA_ATTN = (9, 18, 27)
BAMBA_SSM = dict(d_inner=8192, d_state=128, n_head=128, groups=1)
# falcon-mamba-7B (tiiuae/falcon-mamba-7b config.json, GGUF arch mamba): 4,096
# wide, 64 Mamba-1 layers (d_inner 8,192, d_state 16, dt rank 256, d_conv 4,
# the non-parametric dt / B / C norms), no FFN, a 65,024-piece vocab.
# MAMBA_LAYERS of them
MAMBA_LAYERS = 8
FALCON_MAMBA = dict(arch="mamba", n_embd=4096, n_layer=MAMBA_LAYERS, n_head=0, n_head_kv=0,
                    head_dim=0, head_dim_v=0, n_rot=0, n_ff=0, n_vocab=65024, rms_eps=1e-5)
SSM_TYPES = {**Q4_K_M_TYPES, "ssm_in": "Q4_K", "ssm_x": "Q4_K", "ssm_dt": "Q4_K",
             "ssm_out": "Q4_K"}
SSM_KEYS = ("qmv", "qmm", "ssm_scan", "fa", "fa_tc", "fd", "paged")
SSM_BUCKETS = (32, 128, 256)     # the TTFT engine's: pow2 chunks of at most 256 tokens
# greedy_rule's path limit on the SSM models. Their paths part further than
# a dense model's whatever the kernels do: the decode projections quantize
# their activations to int8 (qmv, as the JAX package's) and the prefill's
# do not, and in bf16 (the activations, the conv's sums, the residual, as
# in JAX) an ulp anywhere moves roundings the recurrence carries on.
# Measured on the card (Bamba-9B's widths, 10 layers): a 1e-7 relative
# change of one layer's scan output moves the bf16 prefill logits by NMSE
# 3e-4 to 5e-4 (3e-11 with f32 activations); the kernels against the plain
# route 4.7e-4 in bf16 and 1.2e-10 in f32; the decode against the prefill
# path up to 1.4e-3, in bf16 and in f32 alike
SSM_PATH_NMSE = 5e-3


def ssm_f32(il: int, conv_dim: int, di: int, ds: int, nh: int, mamba2: bool) -> dict:
    """A mamba layer's F32 tensors, seeded: the conv kernel (conv_dim, 4)
    and bias, dt's bias, A = -exp(.) and D, Mamba-2's group norm."""
    import numpy as np

    rng = np.random.default_rng([SEED + 220, il])
    b = f"blk.{il}."
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    out = {b + "ssm_conv1d.weight": f(conv_dim, 4, scale=0.3),
           b + "ssm_conv1d.bias": f(conv_dim, scale=0.05),
           b + "ssm_dt.bias": f(nh if mamba2 else di, scale=0.3),
           b + "ssm_a": -np.exp(f(*((nh, 1) if mamba2 else (di, ds)), scale=0.5)),
           b + "ssm_d": f(*((nh, 1) if mamba2 else (di,)), scale=0.5)}
    if mamba2:
        out[b + "ssm_norm.weight"] = np.ones((1, di), np.float32)
    return out


def ssm_file_model(torch, d: str, which: str):
    """Bamba-9B or falcon-mamba-7B at published widths, cut in depth, as a
    Q4_K_M-style file of rand_raw bytes (every layer of a kind layer 0's;
    the conv, A, D, biases and norms F32, seeded): written, loaded packed
    onto the card (bf16) and its hparams checked. Returns (model, info,
    the file's path): the caller loads it again in f32 (ssm_decode), then
    removes it."""
    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams

    bamba = which == "granitehybrid"
    hp = llama3_8b_hparams(**(BAMBA if bamba else FALCON_MAMBA))
    E, V, L = hp.n_embd, hp.n_vocab, hp.n_layer
    shapes = {"token_embd.weight": ("token_embd", V, E), "output.weight": ("output", V, E)}
    f32 = {}
    if bamba:
        di, ds, nh = BAMBA_SSM["d_inner"], BAMBA_SSM["d_state"], BAMBA_SSM["n_head"]
        G = BAMBA_SSM["groups"]
        conv_dim = di + 2 * G * ds
        qd, kvd = hp.n_head * hp.head_dim, hp.n_head_kv * hp.head_dim
        for il in range(L):
            b = f"blk.{il}."
            if il in BAMBA_ATTN:
                for role, N, K in (("attn_q", qd, E), ("attn_k", kvd, E), ("attn_v", kvd, E),
                                   ("attn_output", E, qd)):
                    shapes[b + role + ".weight"] = (role, N, K)
            else:
                shapes[b + "ssm_in.weight"] = ("ssm_in", 2 * di + 2 * G * ds + nh, E)
                shapes[b + "ssm_out.weight"] = ("ssm_out", E, di)
                f32.update(ssm_f32(il, conv_dim, di, ds, nh, True))
            for role, N, K in (("ffn_gate", hp.n_ff, E), ("ffn_up", hp.n_ff, E),
                               ("ffn_down", E, hp.n_ff)):
                shapes[b + role + ".weight"] = (role, N, K)
        keys = {"attention.head_count_kv": [hp.n_head_kv if il in BAMBA_ATTN else 0
                                            for il in range(L)],
                "attention.key_length": 128, "attention.value_length": 128,
                "rope.scaling.finetuned": True, "ssm.conv_kernel": 4, "ssm.inner_size": di,
                "ssm.state_size": ds, "ssm.time_step_rank": nh, "ssm.group_count": G}
        name = "synthetic-bamba-9b"
    else:
        di, ds, rank = 8192, 16, 256
        for il in range(L):
            b = f"blk.{il}."
            shapes.update({b + "ssm_in.weight": ("ssm_in", 2 * di, E),
                           b + "ssm_x.weight": ("ssm_x", rank + 2 * ds, di),
                           b + "ssm_dt.weight": ("ssm_dt", di, rank),
                           b + "ssm_out.weight": ("ssm_out", E, di)})
            f32.update(ssm_f32(il, di, di, ds, 0, False))
        keys = {"attention.head_count": 0, "attention.head_count_kv": 0,
                "feed_forward_length": 0, "ssm.conv_kernel": 4, "ssm.inner_size": di,
                "ssm.state_size": ds, "ssm.time_step_rank": rank, "ssm.dt_b_c_rms": True}
        name = "synthetic-falcon-mamba-7b"
    tok = grammar_tokenizer(V)
    path = os.path.join(d, f"{name}-q4_k_m.gguf")
    t0 = time.perf_counter()
    write_file_model(path, hp, tok, SSM_TYPES, f"{name}-q4_k_m", shared_layers=True,
                     arch=hp.arch, keys=keys, ffn_norm=bamba, f32_tensors=f32, shapes=shapes)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = load_model(path, dtype=torch.bfloat16, keep_quantized=True, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = model.hparams
    want = {"arch": which, "n_embd": 4096, "n_layer": L, "n_vocab": V, "ssm_d_inner": 8192,
            "ssm_d_state": ds, "ssm_d_conv": 4,
            "ssm_dt_rank": nh if bamba else rank, "ssm_n_group": 1 if bamba else 0,
            "is_hybrid": bamba, "is_recurrent": not bamba}
    if bamba:
        want.update(n_head=32, n_head_kv=8, head_dim=128, n_ff=14336, rope_finetuned=True)
    have = {k: getattr(got, k) for k in want}
    ok = have == want and (bamba or got.extra.get("ssm_dt_b_c_rms") is True)
    if bamba:
        ok &= [il for il in range(L) if got.n_head_kv_il(il)] == [
            il for il in BAMBA_ATTN if il < L]
    check(ok, f"{which} from the file: {have} (want {want}), extra {got.extra}")
    info = {"file_bytes": os.path.getsize(path), "write_s": write_s, "load_s": load_s,
            "depth": L, "hparams": have}
    return model, info, path


def ssm_path_nmse(torch, model, prompt) -> float:
    """The prompt's prefill logits through the kernels against the plain
    route (PlainKernels), on the model's own activation and state type."""
    kv = model.params["layers"][0]["attn_norm"].dtype
    a = forward_run(torch, model, [prompt], kv_dtype=kv, n_ctx=512)[0]
    with PlainKernels():
        b = forward_run(torch, model, [prompt], kv_dtype=kv, n_ctx=512)[0]
    return nmse(a, b)


def ssm_decode(torch, model, label: str, n_prompts: int = 3, need=("ssm_scan",)) -> dict:
    """ARCH_DECODE greedy tokens of n_prompts 32-token prompts, each on a
    one-slot bf16 Engine (warmed up, so every block and chunk is a replay),
    held to the eager plain route (the plain recurrence loops called
    explicitly through PlainKernels) by greedy_rule at SSM_PATH_NMSE; the
    kernels in ``need`` (ssm_scan) and qmv launched, fa, fa_tc and fd not."""
    from superllama_tpu_torch.runtime.engine import Engine

    prompts = token_prompts(model.hparams.n_vocab, [32] * n_prompts, SEED + 230)
    eng = Engine(model, n_slots=1, n_ctx=512, device="cuda", kv_dtype=torch.bfloat16)
    warm = eng.warmup()
    rules, stats0 = [], block_stats(eng)
    reset_counts()
    outs = []
    for p in prompts:
        fresh(eng)
        outs.append(eng.generate(p, max_tokens=ARCH_DECODE, sampling={"greedy": True},
                                 stop_eog=False)["tokens"])
    counts = read_counts()
    replayed = check_replayed(f"{label} decode", stats0, block_stats(eng))
    del eng
    for p, got in zip(prompts, outs):
        ref = plain_greedy(torch, model, p, ARCH_DECODE, n_ctx=512)
        rules.append(greedy_rule(torch, model, f"{label} decode", p, ref, got, 1, 1,
                                 paths=route_paths(torch, model, p, n_ctx=512), n_ctx=512,
                                 path_nmse=SSM_PATH_NMSE))
    check(all(counts[k] > 0 for k in ("qmv", *need)),
          f"{label} decode: {'/'.join(need)} or qmv never launched: {counts}")
    check(counts["fa"] + counts["fa_tc"] + counts["fd"] == 0,
          f"{label} decode: the plain attention path launched fa or fd: {counts}")
    return {"greedy_rule": rules, "warmup_keys": len(warm["keys"]),
            "warmup_s": warm["seconds"], "blocks": replayed,
            "launches": {k: counts[k] for k in SSM_KEYS + tuple(need)}}


def ssm_ttft_and_state(torch, model, label: str) -> dict:
    """On a warmed 8-slot Engine of SSM_BUCKETS (pow2 chunks of at most 256
    tokens, in place as (8, P) rows): the warm-up's keys and seconds; the
    TTFT of a 32- and a 1,000-token prompt (medians of three, every chunk
    and block a replay, no capture after the warm-up); a slot save / erase /
    restore round trip bit-equal."""
    from superllama_tpu_torch.runtime.cache_policy import get_row
    from superllama_tpu_torch.runtime.engine import Engine

    eng = Engine(model, n_slots=8, n_ctx=1280, device="cuda", kv_dtype=torch.bfloat16,
                 prefill_buckets=SSM_BUCKETS)
    warm = eng.warmup()
    p32, p1000 = token_prompts(model.hparams.n_vocab, [32, 1000], SEED + 231)
    stats0 = block_stats(eng)
    reset_counts()
    ttft = {}
    for n, p in ((32, p32), (1000, p1000)):
        runs = []
        for _ in range(3):
            fresh(eng)
            runs.append(eng.generate(p, max_tokens=2, sampling={"greedy": True},
                                     stop_eog=False)["ttft_s"] * 1e3)
        ttft[f"ttft_ms_prompt{n}"] = sorted(runs)[1]
    counts = read_counts()
    after = block_stats(eng)
    replayed = check_replayed(f"{label} TTFT", stats0, after)
    check(after["captures"] == stats0["captures"]
          and after["chunk_captures"] == stats0["chunk_captures"],
          f"{label}: a graph was captured after the warm-up: {after}")
    # slot state: the 1,000-token request's row saved, trashed, restored
    (s,) = [s for s in eng.slots if s.cache_tokens]
    snap = eng.slot_save(s.idx)
    before = get_row(eng.cache, s.idx)
    eng.generate(p32, max_tokens=4, sampling={"greedy": True}, stop_eog=False)
    eng.slot_erase(s.idx)
    eng.slot_restore(s.idx, snap)
    again = get_row(eng.cache, s.idx)
    flat = lambda b: {f"{k}.{j}": v for k, x in b.items()  # noqa: E731
                      for j, v in (x.items() if isinstance(x, dict) else [("", x)])}
    fb, fa = flat(before), flat(again)
    equal = fb.keys() == fa.keys() and all(
        (fb[k] == fa[k]).all() if hasattr(fb[k], "shape") else fb[k] == fa[k] for k in fb)
    check(bool(equal), f"{label}: the restored slot state differs from the saved one")
    keys = [list(k) for k in warm["keys"]]
    del eng
    torch.cuda.empty_cache()
    return {**ttft, "warmup_keys": keys, "warmup_capture_s": warm["capture_s"],
            "warmup_s": warm["seconds"], "graph_pool_bytes": warm["pool_bytes"],
            "blocks": replayed, "launches": {k: counts[k] for k in SSM_KEYS},
            "slot_state_restored_equal": True, "slot_state_n_past": snap["n_past"]}


def ssm_refusals(torch, model) -> dict:
    """A recurrent or hybrid Engine refuses the modes whose state would have
    to rewind, with ValueError before it allocates a cache."""
    from superllama_tpu_torch.runtime.engine import Engine

    out = {}
    for mode, kw in (("paged", {"paged": True}), ("q8_0", {"kv_dtype": "q8_0"}),
                     ("speculative", {"draft_model": model}), ("lookup", {"lookup_ngrams": 3}),
                     ("ctx_shift", {"ctx_shift": True})):
        try:
            Engine(model, n_slots=1, n_ctx=64, device="cuda", **kw)
            out[mode] = False
        except ValueError:
            out[mode] = True
    check(all(out.values()), f"an SSM engine accepted a mode it must refuse: {out}")
    return out


def ssm_held_routes(torch) -> dict:
    """The routes ROADMAP §2 holds for the hybrids, by CUDA events at
    Bamba-9B's widths (bf16): its attention layer on the plain path
    (``attention_ref`` over the whole flat cache, as the hybrid forwards
    call it) against fa_tc for a 1,000-token prompt (one chunk of 1,024
    slots) and against fd for a decode step of 8 rows over 1,024 slots; and
    the plain depthwise conv of a Mamba-2 layer (8,448 channels, d_conv 4)
    at a decode step of 8 rows and a 256-token chunk."""
    from superllama_tpu_torch.models.mamba import _conv
    from superllama_tpu_torch.ops import ref as ops
    from superllama_tpu_torch.ops.flash_attention import (flash_attention,
                                                          flash_decode_attention)
    from superllama_tpu_torch.runtime.kv_cache import causal_mask

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 232)
    i32 = dict(dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    out, S, T = {}, 1024, 1000
    kv_pos = torch.where(torch.arange(S, **i32) < T, torch.arange(S, **i32), -1)[None]
    k, v, q = rnd(1, 8, S, 128), rnd(1, 8, S, 128), rnd(1, T, 32, 128)
    q_pos = torch.arange(T, **i32)[None]
    mask = causal_mask(kv_pos, q_pos)
    out["bamba_attn_prompt1000_plain_ms"] = cuda_ms(
        torch, lambda i: ops.attention_ref(q, k, v, mask, scale=128 ** -0.5), 10)
    out["bamba_attn_prompt1000_fa_tc_ms"] = cuda_ms(
        torch, lambda i: flash_attention(q, k, v, q_pos, kv_pos, scale=128 ** -0.5), 20)
    kv_pos = torch.arange(S, **i32)[None].expand(8, S).contiguous()
    k, v, q = rnd(8, 8, S, 128), rnd(8, 8, S, 128), rnd(8, 1, 32, 128)
    q_pos = torch.full((8, 1), S - 1, **i32)
    mask = causal_mask(kv_pos, q_pos)
    out["bamba_attn_decode_b8_s1024_plain_ms"] = cuda_ms(
        torch, lambda i: ops.attention_ref(q, k, v, mask, scale=128 ** -0.5), 20)
    out["bamba_attn_decode_b8_s1024_fd_ms"] = cuda_ms(
        torch, lambda i: flash_decode_attention(q, k, v, q_pos, kv_pos, scale=128 ** -0.5), 20)
    C = 8192 + 2 * 128
    layer = {"ssm_conv1d": rnd(4, C), "ssm_conv1d_b": rnd(C)}
    for B, Tc in ((8, 1), (1, 256)):
        xs, state = rnd(B, Tc, C), rnd(B, 3, C)
        out[f"bamba_conv1d_b{B}_t{Tc}_plain_ms"] = cuda_ms(
            torch, lambda i: _conv(layer, xs, state, None), 20)
    torch.cuda.empty_cache()
    return out


SSM_SWEEP_FAMILIES = ("mamba2", "jamba", "nemotron_h", "nemotron_h_moe", "falcon-h1", "plamo2")


def ssm_sweep_file(path: str, family: str) -> str:
    """One SSM family at the CPU tests' tiny widths (64 wide, a 512-piece
    vocab), 4 layers, seeded F32 weights, written by the port's GGUFWriter:
    mamba2 (G 2, the group norm), jamba (Mamba-1 with its dt / B / C norms
    beside rope-less attention, MoE FFNs on the attention layers),
    nemotron_h (Mamba-2, attention, relu² FFN, Mamba-2), nemotron_h_moe (its
    FFN layer gate-less relu² experts and a shared expert), falcon-h1
    (attention and Mamba-2 in every layer) and plamo2 (its mixer, fused-qkv
    attention with per-head norms, post-norms, a fused gate ∥ up)."""
    import numpy as np

    from superllama_tpu_torch.gguf import GGUFWriter

    rng = np.random.default_rng([SEED + 240, len(family)])
    E, V, H, HKV, D, F, L = 64, 512, 4, 2, 16, 128, 4
    t = {}

    def w(name, *shape, scale=None):
        t[name] = (rng.standard_normal(shape) * (scale or 0.7 * shape[-1] ** -0.5)).astype(
            np.float32)

    def norm(name, *shape):
        t[name] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    def mamba(b, di=128, ds=16, nh=8, G=1, rank=0, norms=False, plamo=False):
        if plamo:
            w(b + "ssm_in.weight", 2 * di, E)
            w(b + "ssm_conv1d.weight", di, 4, scale=0.3)
            w(b + "ssm_x.weight", 64 + 2 * ds, di)
            w(b + "ssm_dt.weight", nh, 64, scale=0.1)
            for n, k in (("ssm_dt_norm", 64), ("ssm_b_norm", ds), ("ssm_c_norm", ds)):
                norm(b + n, k)
        elif rank:
            w(b + "ssm_in.weight", 2 * di, E)
            w(b + "ssm_conv1d.weight", di, 4, scale=0.3)
            w(b + "ssm_conv1d.bias", di, scale=0.05)
            w(b + "ssm_x.weight", rank + 2 * ds, di)
            w(b + "ssm_dt.weight", di, rank, scale=0.3)
            if norms:
                for n, k in (("ssm_dt_norm", rank), ("ssm_b_norm", ds), ("ssm_c_norm", ds)):
                    norm(b + n + ".weight", k)
        else:
            cd = di + 2 * G * ds
            w(b + "ssm_in.weight", 2 * di + 2 * G * ds + nh, E)
            w(b + "ssm_conv1d.weight", cd, 4, scale=0.3)
            w(b + "ssm_conv1d.bias", cd, scale=0.05)
            norm(b + "ssm_norm.weight", G, di // G)
        n_a = di if rank else nh
        w(b + "ssm_dt.bias", n_a, scale=0.3)
        t[b + "ssm_a"] = -np.exp(rng.standard_normal((di, ds) if rank else (nh, 1)) * 0.5
                                 ).astype(np.float32)
        w(b + "ssm_d", *((di,) if rank else (nh, 1)), scale=0.5)
        w(b + "ssm_out.weight", E, di)
        return {"ssm.conv_kernel": 4, "ssm.inner_size": di, "ssm.state_size": ds,
                "ssm.time_step_rank": rank or nh, "ssm.group_count": 0 if rank or plamo else G}

    def attn(b, hkv=HKV, fused=False):
        if fused:
            w(b + "attn_qkv.weight", (H + 2 * hkv) * D, E)
            norm(b + "attn_q_norm.weight", H, D)
            norm(b + "attn_k_norm.weight", hkv, D)
        else:
            w(b + "attn_q.weight", H * D, E)
            w(b + "attn_k.weight", hkv * D, E)
            w(b + "attn_v.weight", hkv * D, E)
        w(b + "attn_output.weight", E, H * D)

    def ffn(b, f=F, gate=True, fused=False):
        if fused:
            w(b + "ffn_up.weight", 2 * f, E)
        else:
            if gate:
                w(b + "ffn_gate.weight", f, E)
            w(b + "ffn_up.weight", f, E)
        w(b + "ffn_down.weight", E, f)

    def experts(b, gate=True, shared=0):
        w(b + "ffn_gate_inp.weight", 4, E, scale=1.0)
        for part, shape in (("gate", (4, 48, E)), ("up", (4, 48, E)), ("down", (4, E, 48))):
            if part != "gate" or gate:
                w(b + f"ffn_{part}_exps.weight", *shape)
        if shared:
            w(b + "ffn_up_shexp.weight", shared, E)
            w(b + "ffn_down_shexp.weight", E, shared)
        return {"expert_count": 4, "expert_used_count": 2, "expert_feed_forward_length": 48}

    w("token_embd.weight", V, E, scale=0.5)
    norm("output_norm.weight", E)
    w("output.weight", V, E)
    md = {"context_length": 256, "embedding_length": E, "block_count": L, "vocab_size": V,
          "attention.head_count": H, "attention.head_count_kv": HKV,
          "attention.key_length": D, "attention.value_length": D,
          "rope.dimension_count": D, "rope.freq_base": 10000.0,
          "attention.layer_norm_rms_epsilon": 1e-5, "feed_forward_length": F}
    for il in range(L):
        b = f"blk.{il}."
        norm(b + "attn_norm.weight", E)
        if family == "mamba2":
            md.update(mamba(b, G=2))
        elif family == "jamba":
            norm(b + "ffn_norm.weight", E)
            if il % 2 == 0:
                md.update(mamba(b, ds=8, rank=8, norms=True))
                ffn(b)
            else:
                attn(b)
                md.update(experts(b))
        elif family in ("nemotron_h", "nemotron_h_moe"):
            kind = "M*-M"[il]
            if kind == "M":
                md.update(mamba(b))
            elif kind == "*":
                attn(b)
            elif family == "nemotron_h":
                ffn(b, f=96, gate=False)
            else:
                w(b + "exp_probs_b.bias", 4, scale=0.5)
                md.update(experts(b, gate=False, shared=64))
            md["attention.head_count_kv"] = [HKV if k == "*" else 0 for k in "M*-M"]
            md["feed_forward_length"] = [96 if k == "-" else 0 for k in "M*-M"]
        elif family == "falcon-h1":
            norm(b + "ffn_norm.weight", E)
            attn(b)
            md.update(mamba(b))
            ffn(b)
        elif family == "plamo2":
            if il % 2 == 0:
                md.update(mamba(b, di=64, ds=8, nh=4, plamo=True))
            else:
                attn(b, fused=True)
            norm(b + "post_attention_norm", E)
            norm(b + "ffn_norm.weight", E)
            norm(b + "post_ffw_norm", E)
            ffn(b, f=64, fused=True)
            md["attention.head_count_kv"] = [0, HKV, 0, HKV]
            md["feed_forward_length"] = 64
    if family == "mamba2":
        md.update({"attention.head_count": 0, "attention.head_count_kv": 0,
                   "feed_forward_length": 0})
    if family == "jamba":
        md["attention.head_count_kv"] = [0, HKV, 0, HKV]
    if family == "nemotron_h_moe":
        md.update({"expert_shared_feed_forward_length": 64, "expert_shared_count": 1,
                   "expert_weights_norm": True, "expert_weights_scale": 1.0})
    wr = GGUFWriter(path, arch=family)
    wr.add("general.name", f"sweep-{family}")
    for k, v in md.items():
        wr.add(f"{family}.{k}", v)
    for name, a in t.items():
        wr.add_tensor(name, a)
    wr.write()
    return path


def ssm_sweep_family(torch, d: str, family: str) -> dict:
    """One family's file loaded onto the card and onto the host (f32): a
    12-token prompt's first-token logits through the card (ssm_scan, gmm on
    the MoE ones) against the port's CPU plain forward of the same file
    (ARCH_NMSE), and the launches by route."""
    import gc

    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.runtime.context import Context

    t0 = time.perf_counter()
    path = ssm_sweep_file(os.path.join(d, f"ssm-sweep-{family}.gguf"), family)
    prompt = token_prompts(512, [12], SEED + 241)[0]
    first = {}
    reset_counts()
    for dev in ("cuda", "cpu"):
        m = load_model(path, dtype=torch.float32, device=dev)
        ctx = Context(m, n_batch=1, n_ctx=64, kv_dtype=torch.float32, device=dev)
        first[dev] = ctx.forward(prompt)[0, -1].float().cpu()
        if dev == "cuda":
            counts = read_counts()
    hp = m.hparams
    err = nmse(first["cuda"], first["cpu"])
    check(bool(torch.isfinite(first["cuda"]).all()), f"SSM sweep {family}: non-finite logits")
    check(err < ARCH_NMSE, f"SSM sweep {family}: card against CPU plain forward nmse {err:g}")
    check(counts["ssm_scan"] > 0, f"SSM sweep {family}: ssm_scan never launched")
    if family in ("jamba", "nemotron_h_moe"):
        check(counts["gmm"] > 0, f"SSM sweep {family}: gmm never launched")
    info = {"family": family, "arch": hp.arch, "hybrid": hp.is_hybrid,
            "first_token_nmse": err, "nmse_bound": ARCH_NMSE,
            "argmax_agree": bool(first["cuda"].argmax() == first["cpu"].argmax()),
            "launches": {k: counts[k] for k in ("ssm_scan", "gmm", "qmv", "fa_tc", "fd")},
            "seconds": time.perf_counter() - t0}
    os.remove(path)
    del m, ctx
    gc.collect()
    return info


def ssm_model_phase(torch, d: str, which: str, smi_line: str) -> dict:
    """One model of 4n written and loaded (ssm_file_model); its greedy
    tokens held to the plain route (ssm_decode); the prefill logits through
    the kernels against the plain route of the bf16 load and of an f32 load
    of the same file (f32 within 1e-6: the kernels' own error); Bamba: a wave replayed
    against eager, the served wave with B 1 / B 8 (arch_serving), the TTFTs,
    warm-up and slot state (ssm_ttft_and_state) and the refusals;
    falcon-mamba: B 1 / B 8 from the served wave."""
    import gc

    from superllama_tpu_torch.models.loader import load_model

    label = "Bamba-9B" if which == "granitehybrid" else "falcon-mamba-7B"
    t_all = time.perf_counter()
    model, info, path = ssm_file_model(torch, d, which)
    t0 = time.perf_counter()
    m32 = load_model(path, dtype=torch.float32, keep_quantized=True, device="cuda")
    os.remove(path)
    info["decode"] = ssm_decode(torch, model, label, 3 if which == "granitehybrid" else 1)
    p = token_prompts(model.hparams.n_vocab, [32], SEED + 230)[0]
    info["prefill_path_nmse"] = {"f32": ssm_path_nmse(torch, m32, p),
                                 "bf16": ssm_path_nmse(torch, model, p)}
    check(info["prefill_path_nmse"]["f32"] < 1e-6,
          f"{label}: the f32 model's kernels against the plain route, NMSE "
          f"{info['prefill_path_nmse']['f32']:g}")
    del m32
    info["decode_s"] = time.perf_counter() - t0
    if which == "granitehybrid":
        t0 = time.perf_counter()
        (rec,) = phase_graph_vs_eager(torch, model, GRAPH_CASES[:1], ("greedy",), n_ctx=512)
        check(rec["launches"]["ssm_scan"] > 0, f"{label}: the graph wave never launched ssm_scan")
        info["graph_vs_eager"] = {k: rec[k] for k in ("tokens_equal", "rows_equal",
                                                      "graph_blocks", "launches")}
        info["graph_vs_eager_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["ttft_state"] = ssm_ttft_and_state(torch, model, label)
        info["ttft_state_s"] = time.perf_counter() - t0
        info["refusals"] = ssm_refusals(torch, model)
    t0 = time.perf_counter()
    info["serving"] = arch_serving(torch, model, label, need=("ssm_scan",), attn=())
    info["serving"]["seconds"] = time.perf_counter() - t0
    check(info["serving"]["launches"]["fa_tc"] + info["serving"]["launches"]["fd"] == 0,
          f"{label}: the served wave launched fa_tc or fd")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    info = {"phase": f"ssm_{which}", "model": label, "card": smi_line, **info,
            "seconds": time.perf_counter() - t_all}
    emit(info)
    return info


def phase_ssm(torch, smi_line: str) -> dict:
    """4n. State-space models: ssm_scan against its plain loop and its
    times, qmv's and qmm's at the new shapes (a); Bamba-9B (granitehybrid) and falcon-mamba-7B (mamba) at full
    width from rand_raw files, served (b); the held routes' times (c); the
    other six SSM names at the tests' widths against the CPU (d).
    ``launches`` is ssm_scan's count in Bamba's served wave."""
    import shutil
    import tempfile

    t_all = time.perf_counter()
    checks, times = check_ssm_scan(torch)
    emit({"phase": "ssm_kernel_times", "card": smi_line, "kernels": times})
    emit({"phase": "ssm_matmul_times", "card": smi_line, "kernels": time_ssm_matmuls(torch)})
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    d = tempfile.mkdtemp(prefix="ssm_", dir=build)
    try:
        out = {which: ssm_model_phase(torch, d, which, smi_line)
               for which in ("granitehybrid", "mamba")}
        held = ssm_held_routes(torch)
        emit({"phase": "ssm_held_routes", "card": smi_line, **held})
        sweep = [ssm_sweep_family(torch, d, fam) for fam in SSM_SWEEP_FAMILIES]
        emit({"phase": "ssm_sweep", "card": smi_line, "families": sweep})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "ssm", "card": smi_line, "seconds": time.perf_counter() - t_all})
    return {"checks": checks, "times": {"ssm_scan": times[SCAN_RECORD], **{
        f"ssm_scan {k}": v for k, v in times.items()}},
        "launches": out["granitehybrid"]["serving"]["launches"]["ssm_scan"]}


# ------------------------------------------------------------ 4o. linear attention and short convs

WKV_NMSE = 1e-10     # the kernel's y and f32 state against the plain loop's (sums in another order)
# (label, rule, rows, T, heads, head size): RWKV-6-7B's wkv6 (64 heads of 64),
# rwkv6qwen2's gla at head sizes 64 and 128, RWKV-7-2.9B's wkv7 (40 heads of
# 64) and Qwen3-Next's delta net (32 v-heads of 128), at a decode step of 8
# rows and a 256-token chunk
WKV_CASES = [(f"{name} {kind}", rule, B, T, H, D)
             for name, rule, H, D in (("RWKV-6-7B", "wkv6", 64, 64),
                                      ("rwkv6qwen2 D64", "gla", 64, 64),
                                      ("rwkv6qwen2 D128", "gla", 32, 128),
                                      ("RWKV-7-2.9B", "wkv7", 40, 64),
                                      ("Qwen3-Next", "delta_net", 32, 128))
             for kind, B, T in (("decode", 8, 1), ("chunk", 1, 256))]
# f32 operations a state element a step: wkv6 k·v, u·kv, + S, · r, the sum,
# S·w, + kv; gla k·v, S·w, +, · r·scale, the sum; wkv7 a·S and its sum, S·w,
# v·k, sa·b, two adds, · r and its sum; the delta net e^g·S, k·S and its
# sum, k·δ and its add, q·S and its sum
WKV_OPS = {"wkv6": 7, "gla": 5, "wkv7": 9, "delta_net": 7}
WKV_VECS = {"wkv6": 4, "gla": 4, "wkv7": 6, "delta_net": 3}
WKV_STATE = {"wkv6": 5, "gla": 4, "wkv7": 6, "delta_net": 5}   # the state's argument
# each rule's kernel record: a served decode step (Qwen3-Next's bf16 state)
WKV_RECORD = {"wkv6": "RWKV-6-7B decode f32 state",
              "gla": "rwkv6qwen2 D64 decode f32 state",
              "wkv7": "RWKV-7-2.9B decode f32 state",
              "delta_net": "Qwen3-Next decode bf16 state"}


def wkv_operands(torch, rule: str, B: int, T: int, H: int, D: int, seed: int, state_dtype):
    """The arguments of one call of ``rule``, random on the card in the
    ranges the models give them: decays in (0, 1), wkv7's a = −kk and b =
    kk·a' (kk l2-normed), the delta net's log-decay below 0."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    v = lambda s=1.0: rnd(B, T, H, D, s=s)        # noqa: E731
    state = (0.3 * rnd(B, H, D, D)).to(state_dtype)
    if rule in ("wkv6", "gla"):
        r, k, val, w = v(), v(0.5), v(), torch.exp(-torch.exp(v(0.5)))
        return [r, k, val, rnd(H, D), w, state] if rule == "wkv6" else [r, k, val, w, state,
                                                                        D ** -0.5]
    if rule == "wkv7":
        kk = torch.nn.functional.normalize(v(), dim=-1)
        return [v(), torch.exp(-0.606531 * torch.sigmoid(v())), v(0.5), v(), -kk,
                kk * torch.sigmoid(v()), state]
    return [v(), v(), v(), -torch.nn.functional.softplus(rnd(B, T, H)), rnd(B, T, H), state,
            1e-6]


def wkv_work(rule: str, B: int, T: int, H: int, D: int, state_bytes: int):
    """(bytes, f32 operations) of one call: the state read and written once,
    the step vectors (and u, g, β) read and y written once; WKV_OPS a state
    element a step."""
    n = B * H * D * D
    extra = H * D * 4 if rule == "wkv6" else 2 * B * T * H * 4 if rule == "delta_net" else 0
    nbytes = 2 * n * state_bytes + (WKV_VECS[rule] + 1) * B * T * H * D * 4 + extra
    return nbytes, T * n * WKV_OPS[rule]


def check_wkv(torch) -> tuple[list, dict]:
    """4o (a): each rule of csrc/wkv.cu against its plain loop at every
    WKV_CASES shape (the delta net with an f32 and a bf16 state), all rows
    and with row 3 idle: y and the f32 state within WKV_NMSE, the bf16 state
    one rounding of the plain loop's f32 state (within half a bf16 ulp, the
    f32 sums' order aside), finite, the idle row's state untouched and its y 0,
    two calls bit-equal. Then each shape's reading in its served state type
    (f32; bf16 for the delta net, and f32 at its decode), over copies of the
    inputs past the L2, from a CUDA graph; the delta net's call includes its
    wrapper's l2 norms (plain torch). No PyTorch call computes these
    recurrences, so no row has a library time."""
    from superllama_tpu_torch.ops import ref, wkv

    recs = []
    for label, rule, B, T, H, D in WKV_CASES:
        kernel, plain, si = getattr(wkv, rule), getattr(ref, f"{rule}_plain"), WKV_STATE[rule]
        dtypes = (("f32", torch.float32),) + ((("bf16", torch.bfloat16),)
                                              if rule == "delta_net" else ())
        for sd, dtype in dtypes:
            args = wkv_operands(torch, rule, B, T, H, D, SEED + 250, dtype)
            st = args[si]
            idle = torch.arange(B, device="cuda") != 3
            for act in [None] + ([idle] if B > 3 else []):
                def call(fn, s):
                    return fn(*args[:si], s, *args[si + 1:], active=act)
                s1, s2, s3, s4 = st.clone(), st.clone(), st.clone(), st.float()
                got, again, want = call(kernel, s1), call(kernel, s3), call(plain, s2)
                call(plain, s4)             # the plain loop's state before its last rounding
                torch.cuda.synchronize()
                # one rounding to nearest of the f32 state: within half a bf16 ulp (2^-8 of
                # the value at most), beside the f32 sums' order (1e-6 of the largest)
                one = ((s1.float() - s4).abs()
                       <= 2.0 ** -8 * s4.abs() + 1e-6 * s4.abs().max()).all()
                rec = {"kernel": rule, "shape": f"{label} B{B} T{T} {sd} state"
                       + (" idle row" if act is not None else ""),
                       "nmse": nmse(got, want), "state_nmse": nmse(s1.float(), s2.float()),
                       "max_abs_err": float((got - want).abs().max()),
                       "state_equal": bool(torch.equal(s1, s2)),
                       "state_one_rounding": bool(one),
                       "finite": bool(torch.isfinite(got).all()
                                      and torch.isfinite(s1.float()).all()),
                       "bit_equal_twice": bool(torch.equal(got, again) and torch.equal(s1, s3))}
                if act is not None:
                    rec["idle_row_kept"] = bool(torch.equal(s1[3], st[3])
                                                and not bool(got[3].any()))
                rec["state_ok"] = (rec["state_nmse"] < WKV_NMSE if dtype == torch.float32
                                   else rec["state_one_rounding"])
                recs.append(rec)
            del args, st
    emit({"phase": "wkv_kernel_checks", "checks": recs})
    for rec in recs:
        what = f"{rec['kernel']} {rec['shape']}"
        check(rec["finite"], f"{what}: non-finite output")
        check(rec["nmse"] < WKV_NMSE and rec["state_ok"],
              f"{what}: nmse {rec['nmse']:g}, state {rec['state_nmse']:g} against the plain "
              f"loop (limit {WKV_NMSE:g})")
        check(rec["bit_equal_twice"], f"{what}: two calls differ")
        check(rec.get("idle_row_kept", True), f"{what}: the idle row's state or y changed")
    times = {}
    for label, rule, B, T, H, D in WKV_CASES:
        kernel, plain, si = getattr(wkv, rule), getattr(ref, f"{rule}_plain"), WKV_STATE[rule]
        served = torch.bfloat16 if rule == "delta_net" else torch.float32
        for dtype in (served,) + ((torch.float32,) if served != torch.float32
                                  and label.endswith("decode") else ()):
            sb = 2 if dtype == torch.bfloat16 else 4
            nbytes, ops = wkv_work(rule, B, T, H, D, sb)
            n = n_copies(nbytes)
            sets = [wkv_operands(torch, rule, B, T, H, D, SEED + 260 + j, dtype)
                    for j in range(n)]
            call = lambda i: kernel(*sets[i % n])               # noqa: E731
            slow = lambda i: plain(*sets[i % n])                # noqa: E731
            ms = graph_ms(torch, call, n)
            b, by = bound(nbytes, ops, "f32")
            key = f"{label} {'bf16' if sb == 2 else 'f32'} state"
            row = {"shape": f"{key} B{B} T{T}", "ms": ms, "ms_eager": cuda_ms(torch, call, 2 * n),
                   "plain_ms": cuda_ms(torch, slow, 3, 1), "library_ms": None, "bound_ms": b,
                   "bound_by": by, "bytes": nbytes, "ops": ops, "gbps": nbytes / ms / 1e6,
                   "share_of_bound": b / ms, "rotated_copies": n}
            check(row["share_of_bound"] <= 1.0,
                  f"{rule} {key}: {ms:g} ms is below the {b:g} ms bound: a mis-measurement")
            times[key] = row
            del sets
    torch.cuda.empty_cache()
    return recs, times


# RWKV-6 Finch 7B (RWKV/v6-Finch-7B-HF config.json): 4,096 wide, 32 layers,
# head size 64, an FFN of 14,336, a 65,536-piece vocab, rescale every 6
# layers, the converter's time-mix / decay extra dims 64 / 128. RWKV-7 Goose
# 2.9B (fla-hub/rwkv7-2.9B-world config.json): 2,560 wide, 32 layers, head
# size 64, an FFN of 10,240, low-rank w / a 96, v 64, g 320. Each at
# LINEAR_LAYERS of its layers. Qwen3-Next-80B-A3B
# (Qwen/Qwen3-Next-80B-A3B-Instruct config.json): 2,048 wide, 16 q / 2 kv
# heads of 256 (a quarter of each roped, θ 1e7), 16 k- / 32 v-heads of 128
# in the delta net (conv 4), 512 experts of 512 (top 10) and a shared expert
# of 512, a 151,936-piece vocab; QWEN3NEXT_LAYERS (three delta-net layers,
# then the gated attention layer: one full interval)
LINEAR_LAYERS = CUT_LAYERS
QWEN3NEXT_LAYERS = 4
RWKV6_7B = dict(E=4096, F=14336, V=65536, ed=64, dd=128)
RWKV7_3B = dict(E=2560, F=10240, V=65536, rw=96, ra=96, rv=64, rg=320)
QWEN3NEXT = dict(E=2048, H=16, HKV=2, D=256, Hk=16, Hv=32, Dk=128, n=512, k=10, f=512,
                 V=151936)
LINEAR_TYPES = {**Q4_K_M_TYPES, "tm": "Q4_K", "lr_in": "Q4_K", "lr_out": "Q8_0", "cm": "Q4_K",
                "ssm_in": "Q4_K", "ssm_ba": "Q4_K", "ssm_out": "Q4_K", "shexp": "Q4_K",
                "ffn_gate_exps": "Q4_K", "ffn_up_exps": "Q4_K", "ffn_down_exps": "Q6_K"}
LINEAR_KEYS = ("qmv", "qmm", "wkv6", "gla", "wkv7", "delta_net", "gmm", "fa", "fa_tc", "fd")
LINEAR_LABEL = {"rwkv6": "RWKV-6-7B", "rwkv7": "RWKV-7-2.9B", "qwen3next": "Qwen3-Next"}
LINEAR_KERNEL = {"rwkv6": "wkv6", "rwkv7": "wkv7", "qwen3next": "delta_net"}


def linear_tensors(which: str, L: int):
    """(shapes {name: (role, N, K[, n])}, F32 tensors, metadata keys) of one
    of the three models at published widths, L layers (rand_raw bytes for
    the shapes; the F32 lerps, decays, bonuses, norms, convs and routers
    seeded)."""
    import numpy as np

    rng = np.random.default_rng([SEED + 270, len(which)])
    f = lambda *s, scale=1.0, loc=0.0: (loc + rng.standard_normal(s) * scale  # noqa: E731
                                        ).astype(np.float32)
    ones = lambda *s: np.ones(s, np.float32)                   # noqa: E731
    shapes, f32 = {}, {}
    if which in ("rwkv6", "rwkv7"):
        c = RWKV6_7B if which == "rwkv6" else RWKV7_3B
        E, F, V = c["E"], c["F"], c["V"]
        shapes.update({"token_embd.weight": ("token_embd", V, E),
                       "output.weight": ("output", V, E)})
        f32.update({"token_embd_norm.weight": ones(E), "token_embd_norm.bias": f(E, scale=0.0)})
        for il in range(L):
            b = f"blk.{il}."
            for n in ("key", "value", "receptance", "output"):
                shapes[f"{b}time_mix_{n}.weight"] = ("tm", E, E)
            shapes.update({f"{b}channel_mix_key.weight": ("cm", F, E),
                           f"{b}channel_mix_value.weight": ("cm", E, F)})
            f32.update({b + "attn_norm_2.weight": ones(E), b + "time_mix_ln.weight": ones(E),
                        b + "time_mix_ln.bias": f(E, scale=0.0),
                        b + "channel_mix_lerp_k.weight": f(E, scale=0.1, loc=0.5)})
            if which == "rwkv6":
                ed, dd, H = c["ed"], c["dd"], E // 64
                shapes.update({f"{b}time_mix_gate.weight": ("tm", E, E),
                               f"{b}channel_mix_receptance.weight": ("cm", E, E),
                               f"{b}time_mix_w1.weight": ("lr_in", 5 * ed, E),
                               f"{b}time_mix_decay_w1.weight": ("lr_in", dd, E),
                               f"{b}time_mix_decay_w2.weight": ("lr_out", E, dd)})
                f32.update({b + "time_mix_lerp_x.weight": f(E, scale=0.1, loc=0.5),
                            b + "time_mix_lerp_fused.weight": f(5, 1, 1, E, scale=0.1, loc=0.5),
                            b + "time_mix_w2.weight": f(5, E, ed, scale=0.01),
                            b + "time_mix_first.weight": f(H, 64, scale=0.5),
                            b + "time_mix_decay.weight": f(E, scale=1.0, loc=-3.0),
                            b + "channel_mix_lerp_r.weight": f(E, scale=0.1, loc=0.5)})
            else:
                for n, r in (("w", c["rw"]), ("a", c["ra"]), ("v", c["rv"]), ("g", c["rg"])):
                    shapes.update({f"{b}time_mix_{n}1.weight": ("lr_in", r, E),
                                   f"{b}time_mix_{n}2.weight": ("lr_out", E, r)})
                f32.update({b + "time_mix_lerp_fused.weight": f(6, 1, 1, E, scale=0.1, loc=0.5),
                            b + "time_mix_w0.weight": f(E, scale=0.3),
                            b + "time_mix_a0.weight": f(E, scale=0.3),
                            b + "time_mix_v0.weight": f(E, scale=0.3),
                            b + "time_mix_k_k.weight": f(E, scale=0.3, loc=1.0),
                            b + "time_mix_k_a.weight": f(E, scale=0.3),
                            b + "time_mix_r_k.weight": f(E, scale=0.3)})
        keys = {"attention.head_count": 0, "attention.head_count_kv": 0, "wkv.head_size": 64,
                "attention.layer_norm_epsilon": 1e-5, "feed_forward_length": F}
        if which == "rwkv6":
            keys.update({"rescale_every_n_layers": 6, "time_mix_extra_dim": c["ed"],
                         "time_decay_extra_dim": c["dd"]})
        else:
            keys.update({"attention.decay_lora_rank": c["rw"], "attention.iclr_lora_rank": c["ra"],
                         "attention.value_residual_mix_lora_rank": c["rv"],
                         "attention.gate_lora_rank": c["rg"]})
        return shapes, f32, keys
    c = QWEN3NEXT
    E, H, HKV, D, Hk, Hv, Dk, n = (c[k] for k in ("E", "H", "HKV", "D", "Hk", "Hv", "Dk", "n"))
    C = 2 * Hk * Dk + Hv * Dk
    shapes.update({"token_embd.weight": ("token_embd", c["V"], E),
                   "output.weight": ("output", c["V"], E)})
    for il in range(L):
        b = f"blk.{il}."
        f32[b + "post_attention_norm.weight"] = ones(E)
        if (il + 1) % 4 == 0:
            shapes.update({b + "attn_q.weight": ("attn_q", 2 * H * D, E),
                           b + "attn_k.weight": ("attn_k", HKV * D, E),
                           b + "attn_v.weight": ("attn_v", HKV * D, E),
                           b + "attn_output.weight": ("attn_output", E, H * D)})
            f32.update({b + "attn_q_norm.weight": ones(D), b + "attn_k_norm.weight": ones(D)})
        else:
            shapes.update({b + "ssm_in.weight": ("ssm_in", Hk * (2 * Dk + 2 * (Hv // Hk) * Dk), E),
                           b + "ssm_ba.weight": ("ssm_ba", 2 * Hv, E),
                           b + "ssm_out.weight": ("ssm_out", E, Hv * Dk)})
            f32.update({b + "ssm_conv1d.weight": f(C, 4, scale=0.3),
                        b + "ssm_a": -np.exp(f(Hv, scale=0.5)),
                        b + "ssm_dt.bias": f(Hv, scale=0.3), b + "ssm_norm.weight": ones(Dk)})
        shapes.update({b + "ffn_gate_exps.weight": ("ffn_gate_exps", n * c["f"], E, n),
                       b + "ffn_up_exps.weight": ("ffn_up_exps", n * c["f"], E, n),
                       b + "ffn_down_exps.weight": ("ffn_down_exps", n * E, c["f"], n),
                       b + "ffn_gate_shexp.weight": ("shexp", c["f"], E),
                       b + "ffn_up_shexp.weight": ("shexp", c["f"], E),
                       b + "ffn_down_shexp.weight": ("shexp", E, c["f"])})
        f32.update({b + "ffn_gate_inp.weight": router_weight(n, E, SEED + 280 + il),
                    b + "ffn_gate_inp_shexp.weight": f(E, scale=E ** -0.5)})
    keys = {"attention.key_length": D, "attention.value_length": D,
            "attention.layer_norm_rms_epsilon": 1e-6, "ssm.conv_kernel": 4,
            "ssm.state_size": Dk, "ssm.group_count": Hk, "ssm.time_step_rank": Hv,
            "ssm.inner_size": Hv * Dk, "expert_count": n, "expert_used_count": c["k"],
            "expert_feed_forward_length": c["f"], "expert_shared_feed_forward_length": c["f"]}
    return shapes, f32, keys


def linear_file_model(torch, d: str, which: str):
    """One of the three models at published widths, cut in depth, as a
    Q4_K_M-style file of rand_raw bytes (every layer of a kind layer 0's):
    written, loaded packed onto the card (bf16; Qwen3-Next's banks as bf16)
    and its hparams checked. Returns (model, info)."""
    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams

    q3n = which == "qwen3next"
    L = QWEN3NEXT_LAYERS if q3n else LINEAR_LAYERS
    if q3n:
        c = QWEN3NEXT
        hp = llama3_8b_hparams(arch=which, n_embd=c["E"], n_layer=L, n_head=c["H"],
                               n_head_kv=c["HKV"], head_dim=c["D"], head_dim_v=c["D"],
                               n_rot=c["D"] // 4, n_ff=5120, n_vocab=c["V"],
                               rope_freq_base=1e7, rms_eps=1e-6)
    else:
        c = RWKV6_7B if which == "rwkv6" else RWKV7_3B
        hp = llama3_8b_hparams(arch=which, n_embd=c["E"], n_layer=L, n_head=0, n_head_kv=0,
                               head_dim=0, head_dim_v=0, n_rot=0, n_ff=c["F"], n_vocab=c["V"])
    shapes, f32, keys = linear_tensors(which, L)
    tok = grammar_tokenizer(hp.n_vocab)
    name = {"rwkv6": "synthetic-rwkv6-finch-7b", "rwkv7": "synthetic-rwkv7-goose-2.9b",
            "qwen3next": "synthetic-qwen3-next-80b-a3b"}[which]
    path = os.path.join(d, f"{name}-q4_k_m.gguf")
    t0 = time.perf_counter()
    write_file_model(path, hp, tok, LINEAR_TYPES, f"{name}-q4_k_m", shared_layers=True,
                     arch=which, keys=keys, ffn_norm=False, f32_tensors=f32, shapes=shapes)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = load_model(path, dtype=torch.bfloat16, keep_quantized=True, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = model.hparams
    want = {"arch": which, "n_embd": c["E"], "n_layer": L, "n_vocab": hp.n_vocab}
    if q3n:
        want.update(n_head=16, n_head_kv=2, head_dim=256, n_rot=64, ssm_d_state=128,
                    ssm_n_group=16, ssm_dt_rank=32, ssm_d_inner=4096, n_expert=512,
                    n_expert_used=10, n_ff_exp=512, is_hybrid=True)
    else:
        want.update(wkv_head_size=64, is_recurrent=True, n_ff=c["F"])
    have = {k: getattr(got, k) for k in want}
    ok = have == want
    if q3n:
        ok &= [got.is_recurrent_layer(il) for il in range(L)] == [True, True, True, False]
        bank = model.params["layers"][0]["ffn_up_exps"]
        ok &= tuple(bank.shape) == (512, 2048, 512) and bank.dtype == torch.bfloat16
    check(ok, f"{which} from the file: {have} (want {want})")
    info = {"file_bytes": os.path.getsize(path), "write_s": write_s, "load_s": load_s,
            "depth": L, "hparams": have}
    os.remove(path)
    return model, info


def linear_engine_run(torch, model, label: str, kernel: str, state: bool) -> dict:
    """On a warmed 8-slot Engine of SSM_BUCKETS (pow2 chunks of at most 256
    tokens, in place): the warm TTFT of a 32- and a 1,000-token prompt
    (medians of three), B 1 and B 8 decode tok/s (64 greedy tokens a
    request), every chunk and block a replay and no capture after the
    warm-up, ``kernel`` (and Qwen3-Next's gmm) launched; with ``state`` a
    slot save / erase / restore round trip bit-equal."""
    from superllama_tpu_torch.runtime.cache_policy import get_row
    from superllama_tpu_torch.runtime.engine import Engine

    eng = Engine(model, n_slots=8, n_ctx=1280, device="cuda", kv_dtype=torch.bfloat16,
                 prefill_buckets=SSM_BUCKETS)
    warm = eng.warmup()
    eng.start()
    try:
        p32, p1000 = token_prompts(model.hparams.n_vocab, [32, 1000], SEED + 231)
        wave = token_prompts(model.hparams.n_vocab, [32] * 8, SEED + 82)
        stats0 = block_stats(eng)
        reset_counts()
        ttft = {}
        for n, p in ((32, p32), (1000, p1000)):
            runs = []
            for _ in range(3):
                fresh(eng)
                runs.append(eng.generate(p, max_tokens=2, sampling={"greedy": True},
                                         stop_eog=False)["ttft_s"] * 1e3)
            ttft[f"ttft_ms_prompt{n}"] = sorted(runs)[1]
        fresh(eng)
        r1 = eng.generate(p32, max_tokens=64, sampling={"greedy": True}, stop_eog=False)
        fresh(eng)
        rs = engine_wave(eng, wave, 64)
        counts = read_counts()
        after = block_stats(eng)
        replayed = check_replayed(f"{label} engine", stats0, after)
        check(after["captures"] == stats0["captures"]
              and after["chunk_captures"] == stats0["chunk_captures"],
              f"{label}: a graph was captured after the warm-up: {after}")
        for name in (kernel, "qmv") + (("gmm",) if kernel == "delta_net" else ()):
            check(counts[name] > 0, f"{label} engine never launched {name}: {counts}")
        V = model.hparams.n_vocab
        check(all(len(r["tokens"]) == 64 and max(r["tokens"]) < V for r in rs),
              f"{label}: the wave gave the wrong tokens")
        b8_s = max(r["total_s"] for r in rs) - max(r["ttft_s"] for r in rs)
        out = {**ttft, "decode_tok_s_b1": (r1["n_generated"] - 1) / (r1["total_s"] - r1["ttft_s"]),
               "decode_tok_s_b8": sum(r["n_generated"] - 1 for r in rs) / b8_s,
               "warmup_keys": len(warm["keys"]), "warmup_s": warm["seconds"],
               "graph_pool_bytes": warm["pool_bytes"], "blocks": replayed,
               "launches": {k: counts[k] for k in LINEAR_KEYS}}
        if state:               # the 64-token wave's row 0 saved, trashed, restored
            (s,) = [s for s in eng.slots if list(s.cache_tokens[:32]) == list(wave[0])]
            snap = eng.slot_save(s.idx)
            before = get_row(eng.cache, s.idx)
            eng.generate(p32, max_tokens=4, sampling={"greedy": True}, stop_eog=False)
            eng.slot_erase(s.idx)
            eng.slot_restore(s.idx, snap)
            again = get_row(eng.cache, s.idx)
            check(before.keys() == again.keys()
                  and all((before[k] == again[k]).all() for k in before),
                  f"{label}: the restored slot state differs from the saved one")
            out["slot_state_restored_equal"] = True
        return out
    finally:
        eng.stop()
        del eng
        torch.cuda.empty_cache()


def linear_model_phase(torch, d: str, which: str, smi_line: str) -> dict:
    """One model of 4o (b): written and loaded (linear_file_model); 16
    greedy tokens held to the eager plain route (ssm_decode: the plain
    loops called through PlainKernels) by greedy_rule at SSM_PATH_NMSE; a
    wave of 4 requests replayed against eager (tokens, every state and KV
    row, launches); the TTFTs and B 1 / B 8 on a warmed engine
    (linear_engine_run; RWKV-6's slot state); fa, fa_tc and fd never
    launched (the hybrid's attention is plain, as in JAX)."""
    import gc

    label, kernel = LINEAR_LABEL[which], LINEAR_KERNEL[which]
    t_all = time.perf_counter()
    model, info = linear_file_model(torch, d, which)
    t0 = time.perf_counter()
    info["decode"] = ssm_decode(torch, model, label, 1, need=(kernel,))
    info["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (rec,) = phase_graph_vs_eager(torch, model, (("bf16", {}, [32, 100] * 2),), ("greedy",),
                                  n_ctx=512, max_tokens=16)
    check(rec["launches"][kernel] > 0, f"{label}: the graph wave never launched {kernel}")
    info["graph_vs_eager"] = {k: rec[k] for k in ("tokens_equal", "rows_equal",
                                                  "graph_blocks", "launches_equal")}
    info["graph_vs_eager_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["engine"] = linear_engine_run(torch, model, label, kernel, state=which == "rwkv6")
    info["engine_s"] = time.perf_counter() - t0
    launches = info["engine"]["launches"]
    check(launches["fa"] + launches["fa_tc"] + launches["fd"] == 0,
          f"{label}: the engine launched fa, fa_tc or fd")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    info = {"phase": f"linear_{which}", "model": label, "card": smi_line, **info,
            "seconds": time.perf_counter() - t_all}
    emit(info)
    return info


LINEAR_SWEEP_FAMILIES = ("arwkv7", "rwkv6qwen2", "lfm2", "lfm2moe", "gemma3n")
LINEAR_SWEEP_V = 8192        # the sweep files' vocabulary


def linear_sweep_file(path: str, family: str) -> str:
    """One family at 1,024 wide, seeded F32 weights, a LINEAR_SWEEP_V-piece
    vocab, written by the port's GGUFWriter: arwkv7 and rwkv6qwen2 (2 layers, 16
    heads of 64; rwkv6qwen2's k / v over 4 kv heads with biases), lfm2
    (a short-conv layer, then 8 heads of 128 over 2 kv heads), lfm2moe (the
    same, its attention layer's FFN 8 experts of 1,024, top 2) and gemma3n
    (7 layers: an iSWA full layer at 4, a shared-KV tail at 5-6; AltUp 4
    streams of 256 per-layer inputs, LAUREL rank 64)."""
    import numpy as np

    from superllama_tpu_torch.gguf import GGUFWriter

    rng = np.random.default_rng([SEED + 290, len(family)])
    E, V, F = 1024, LINEAR_SWEEP_V, 2816
    t = {}

    def w(name, *shape, scale=None):
        t[name] = (rng.standard_normal(shape) * (scale or 0.7 * shape[-1] ** -0.5)).astype(
            np.float32)

    def norm(name, *shape, loc=1.0):
        t[name] = (loc + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    w("token_embd.weight", V, E, scale=0.5 if family != "gemma3n" else 0.02)
    w("output.weight", V, E)
    md = {"context_length": 256, "embedding_length": E, "vocab_size": V,
          "feed_forward_length": F, "attention.layer_norm_rms_epsilon": 1e-5}
    if family in ("arwkv7", "rwkv6qwen2"):
        L, D = 2, 64
        norm("output_norm.weight", E)
        md.update({"block_count": L, "attention.head_count": E // D, "wkv.head_size": D,
                   "token_shift_count": 1})
        for il in range(L):
            b = f"blk.{il}."
            norm(b + "attn_norm.weight", E)
            norm(b + "ffn_norm.weight", E)
            for n in ("gate", "up"):
                w(b + f"ffn_{n}.weight", F, E)
            w(b + "ffn_down.weight", E, F)
            w(b + "time_mix_receptance.weight", E, E)
            w(b + "time_mix_output.weight", E, E)
            if family == "arwkv7":
                w(b + "time_mix_key.weight", E, E)
                w(b + "time_mix_value.weight", E, E)
                for n, r in (("w", 32), ("a", 32), ("v", 32)):
                    w(b + f"time_mix_{n}1.weight", r, E, scale=0.1)
                    w(b + f"time_mix_{n}2.weight", E, r, scale=0.1)
                    w(b + f"time_mix_{n}0.weight", E, scale=0.3)
                norm(b + "time_mix_lerp_fused.weight", 5, 1, 1, E, loc=0.5)
                for n in ("k_k", "k_a", "r_k"):
                    w(b + f"time_mix_{n}.weight", E, scale=0.3)
                md.update({"attention.decay_lora_rank": 32, "attention.iclr_lora_rank": 32,
                           "attention.value_residual_mix_lora_rank": 32,
                           "attention.head_count_kv": E // D})
            else:
                kv = 4 * D
                w(b + "time_mix_key.weight", kv, E)
                w(b + "time_mix_value.weight", kv, E)
                for n, dim in (("key", kv), ("value", kv), ("receptance", E)):
                    w(b + f"time_mix_{n}.bias", dim, scale=0.1)
                w(b + "time_mix_gate.weight", E, E)
                w(b + "time_mix_w1.weight", 5 * 32, E, scale=0.1)
                w(b + "time_mix_w2.weight", 5, E, 32, scale=0.1)
                norm(b + "time_mix_lerp_x.weight", E, loc=0.5)
                norm(b + "time_mix_lerp_fused.weight", 5, 1, 1, E, loc=0.5)
                w(b + "time_mix_decay.weight", E, scale=0.3)
                w(b + "time_mix_decay_w1.weight", 64, E, scale=0.1)
                w(b + "time_mix_decay_w2.weight", E, 64, scale=0.1)
                md.update({"attention.head_count_kv": 4, "time_mix_extra_dim": 32,
                           "time_decay_extra_dim": 64})
    elif family in ("lfm2", "lfm2moe"):
        H, HKV, D = 8, 2, 128
        norm("token_embd_norm.weight", E)        # lfm2's final norm
        for il, kind in enumerate(("conv", "attn")):
            b = f"blk.{il}."
            norm(b + "attn_norm.weight", E)
            norm(b + "ffn_norm.weight", E)
            if kind == "conv":
                w(b + "shortconv.conv.weight", E, 3, scale=0.5)
                w(b + "shortconv.in_proj.weight", 3 * E, E)
                w(b + "shortconv.out_proj.weight", E, E)
            else:
                w(b + "attn_q.weight", H * D, E)
                w(b + "attn_k.weight", HKV * D, E)
                w(b + "attn_v.weight", HKV * D, E)
                w(b + "attn_output.weight", E, H * D)
                norm(b + "attn_q_norm.weight", D)
                norm(b + "attn_k_norm.weight", D)
            if family == "lfm2moe" and kind == "attn":
                w(b + "ffn_gate_inp.weight", 8, E, scale=1.0)
                w(b + "exp_probs_b.bias", 8, scale=0.5)
                for part, shape in (("gate", (8, 1024, E)), ("up", (8, 1024, E)),
                                    ("down", (8, E, 1024))):
                    w(b + f"ffn_{part}_exps.weight", *shape)
            else:
                for n in ("gate", "up"):
                    w(b + f"ffn_{n}.weight", F, E)
                w(b + "ffn_down.weight", E, F)
        md.update({"block_count": 2, "attention.head_count": H,
                   "attention.head_count_kv": [0, HKV], "attention.key_length": D,
                   "attention.value_length": D, "rope.dimension_count": D,
                   "rope.freq_base": 1e6, "shortconv.l_cache": 3})
        if family == "lfm2moe":
            md.update({"expert_count": 8, "expert_used_count": 2,
                       "expert_feed_forward_length": 1024, "leading_dense_block_count": 1,
                       "expert_gating_func": 2})
    else:                                        # gemma3n
        H, HKV, D, L, A, EA, R = 8, 2, 128, 7, 4, 256, 64
        norm("output_norm.weight", E)
        w("per_layer_token_embd.weight", V, EA * L, scale=0.05)
        w("per_layer_model_proj.weight", EA * L, E)
        norm("per_layer_proj_norm.weight", EA)
        w("altup_proj.weight", A - 1, E, E)
        w("altup_unembd_proj.weight", A - 1, E, E)
        for il in range(L):
            b = f"blk.{il}."
            for n in ("attn_norm", "post_attention_norm", "ffn_norm", "post_ffw_norm",
                      "post_norm", "altup_router_norm", "laurel_post_norm"):
                norm(b + n + ".weight", E)
            w(b + "attn_q.weight", H * D, E)
            w(b + "attn_k.weight", HKV * D, E)
            w(b + "attn_v.weight", HKV * D, E)
            w(b + "attn_output.weight", E, H * D)
            norm(b + "attn_q_norm.weight", D)
            norm(b + "attn_k_norm.weight", D)
            for n in ("gate", "up"):
                w(b + f"ffn_{n}.weight", F, E)
            w(b + "ffn_down.weight", E, F)
            w(b + "inp_gate.weight", EA, E)
            w(b + "proj.weight", E, EA)
            w(b + "altup_correct_coef.weight", A, A, scale=0.2)
            w(b + "altup_correct_scale.weight", E, scale=0.5)
            w(b + "altup_predict_coef.weight", A * A, A, scale=0.1)
            w(b + "altup_router.weight", A, E)
            w(b + "laurel_l.weight", R, E)
            w(b + "laurel_r.weight", E, R)
        md.update({"block_count": L, "attention.head_count": H, "attention.head_count_kv": HKV,
                   "attention.key_length": D, "attention.value_length": D,
                   "rope.dimension_count": D, "rope.freq_base": 1e6,
                   "attention.sliding_window": 32, "rope.freq_base_swa": 10000.0,
                   "final_logit_softcapping": 30.0, "attention.shared_kv_layers": 2})
    wr = GGUFWriter(path, arch=family)
    wr.add("general.name", f"sweep-{family}")
    for k, v in md.items():
        wr.add(f"{family}.{k}", v)
    for name, a in t.items():
        wr.add_tensor(name, a)
    wr.write()
    return path


def linear_sweep_family(torch, d: str, family: str) -> dict:
    """One family's file loaded onto the card and onto the host (f32): a
    12-token prompt's first-token logits through the card against the port's
    CPU plain forward of the same file (ARCH_NMSE); then 4 greedy requests
    (the same prompt first) on a warmed Engine on the card, its first token
    the card's argmax; the launches by route."""
    import gc

    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.runtime.context import Context
    from superllama_tpu_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    path = linear_sweep_file(os.path.join(d, f"linear-sweep-{family}.gguf"), family)
    prompts = token_prompts(LINEAR_SWEEP_V, [12, 20, 7, 33], SEED + 291)
    first = {}
    for dev in ("cpu", "cuda"):
        m = load_model(path, dtype=torch.float32, device=dev)
        ctx = Context(m, n_batch=1, n_ctx=64, kv_dtype=torch.float32, device=dev)
        first[dev] = ctx.forward(prompts[0])[0, -1].float().cpu()
        del ctx
    hp = m.hparams
    err = nmse(first["cuda"], first["cpu"])
    check(bool(torch.isfinite(first["cuda"]).all()), f"linear sweep {family}: non-finite logits")
    check(err < ARCH_NMSE, f"linear sweep {family}: card against CPU plain forward nmse {err:g}")
    eng = Engine(m, n_slots=4, n_ctx=128, device="cuda", kv_dtype=torch.float32,
                 prefill_buckets=(16,))
    eng.warmup()
    eng.start()
    try:
        reset_counts()
        outs = [r["tokens"] for r in engine_wave(eng, prompts, 8)]
        counts = read_counts()
    finally:
        eng.stop()
    check(outs[0][0] == int(first["cuda"].argmax()) and all(len(t) == 8 for t in outs),
          f"linear sweep {family}: the engine's first token {outs[0][0]} is not the argmax "
          f"{int(first['cuda'].argmax())}")
    need = {"arwkv7": "wkv7", "rwkv6qwen2": "gla", "lfm2moe": "gmm"}.get(family)
    if need:
        check(counts[need] > 0, f"linear sweep {family}: {need} never launched")
    info = {"family": family, "arch": hp.arch, "hybrid": hp.is_hybrid, "iswa": eng.iswa,
            "first_token_nmse": err, "nmse_bound": ARCH_NMSE,
            "argmax_agree": bool(first["cuda"].argmax() == first["cpu"].argmax()),
            "engine_tokens": outs, "launches": {k: counts[k] for k in LINEAR_KEYS},
            "seconds": time.perf_counter() - t0}
    os.remove(path)
    del m, eng
    gc.collect()
    torch.cuda.empty_cache()
    return info


def phase_linear(torch, smi_line: str) -> dict:
    """4o. Linear attention and short convs: the four rules of wkv against
    their plain loops and their times (a); RWKV-6-7B, RWKV-7-2.9B and
    Qwen3-Next-80B-A3B at full width from rand_raw files, served (b); the
    other five names of the slice at 1,024 wide against the CPU (c).
    ``launches``: each rule's count in its served model's engine run
    (gla's in rwkv6qwen2's engine run)."""
    import shutil
    import tempfile

    t_all = time.perf_counter()
    checks, times = check_wkv(torch)
    emit({"phase": "wkv_kernel_times", "card": smi_line, "kernels": times})
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    d = tempfile.mkdtemp(prefix="linear_", dir=build)
    try:
        out = {which: linear_model_phase(torch, d, which, smi_line)
               for which in ("rwkv6", "rwkv7", "qwen3next")}
        sweep = {fam: linear_sweep_family(torch, d, fam) for fam in LINEAR_SWEEP_FAMILIES}
        emit({"phase": "linear_sweep", "card": smi_line, "families": list(sweep.values())})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "linear", "card": smi_line, "seconds": time.perf_counter() - t_all})
    launches = {rule: out[which]["engine"]["launches"][rule] for which, rule in
                LINEAR_KERNEL.items()}
    launches["gla"] = sweep["rwkv6qwen2"]["launches"]["gla"]
    return {"checks": checks, "launches": launches,
            "times": {**times, **{rule: times[key] for rule, key in WKV_RECORD.items()}}}


# ------------------------------------------------------------ 4p. encoders, T5, diffusion, TTS

ITEM5_KEYS = ("qmv", "qmm", "fa", "fa_tc", "fd", "gmm")
EMBED_COS = 0.999    # an embedding through the kernels against the plain route's
# nomic-embed-text-v1.5 (nomic-bert), EmbeddingGemma-300M, a bge-reranker-v2-m3-width
# bert and nomic-embed-text-v2-moe (nomic-bert-moe): their published widths
NOMIC_V15 = dict(E=768, L=12, H=12, F=3072, V=30528)
EGEMMA = dict(E=768, L=24, H=3, HKV=1, D=256, F=1152, V=262144, window=512)
BGE_M3 = dict(E=1024, L=24, H=16, F=4096, V=250002, P=8194)
NOMIC_V2_MOE = dict(E=768, L=12, H=12, F=3072, V=250048, n=8, k=2, every=2)
ENC_TYPES = {"qkv": "Q4_K", "attn": "Q4_K", "ffn": "Q4_K", "ffn_down": "Q6_K",
             "token_embd": "Q4_K", "q8": "Q8_0", "bank": "Q4_K", "bank_down": "Q6_K"}
# the diffusion LMs at published widths, cut in depth (DIFFUSION_LAYERS)
DIFFUSION_LAYERS = 4
LLADA_8B = dict(arch="llada", n_embd=4096, n_head=32, n_head_kv=32, head_dim=128, n_ff=12288,
                n_vocab=126464, rope_freq_base=500000.0, mask=126336, max_length=16)
DREAM_7B = dict(arch="dream", n_embd=3584, n_head=28, n_head_kv=4, head_dim=128, n_ff=18944,
                n_vocab=152064, rope_freq_base=1e6, rms_eps=1e-6, mask=151666, max_length=32)
RND1 = dict(arch="rnd1", n_embd=2048, n_head=32, n_head_kv=4, head_dim=128, n_ff=6144,
            n_vocab=151936, rope_freq_base=1e6, rms_eps=1e-6, mask=151669, max_length=16)
DIFFUSION_STEPS = 8
# flan-t5-large, full depth; OuteTTS-0.2-500M's voice LM (Qwen2.5-0.5B widths, the
# 157,696-piece vocab) and WavTokenizer-large's decoder
FLAN_T5_LARGE = dict(E=1024, L=24, H=16, D=64, F=2816, V=32128, buckets=32)
T5_SRC, T5_GEN = 32, 16
OUTETTS = dict(E=896, L=24, H=14, HKV=2, D=64, F=4864, V=157696)
WAVTOK = dict(feat=512, pe=768, ce=768, F=2304, V=4096, n_out=1282, convnext=12)
TTS_CONTROL = ("<|im_start|>", "<|im_end|>", "<|text_start|>", "<|text_sep|>", "<|text_end|>",
               "<|audio_start|>", "<|audio_end|>")
TTS_TEXT = "the quick brown fox jumps over the lazy dog"
TTS_CODES = 32


def item5_file(path: str, arch: str, md: dict, tok, shapes: dict, f32: dict,
               types=ENC_TYPES, shared_layers: bool = True) -> None:
    """A GGUF of ``arch``: metadata ``md`` (under the arch's prefix, or
    as given for general./tokenizer. keys), tok's vocab (None: none), the
    ``shapes``' weights of rand_raw bytes in ``types`` by role (every
    layer's of a name layer 0's with ``shared_layers``) and the F32 tensors
    ``f32``, written by the port's GGUFWriter."""
    from superllama_tpu_torch.gguf import GGUFWriter

    w = GGUFWriter(path, arch=arch)
    w.add("general.name", f"synthetic-{arch}")
    for k, v in md.items():
        w.add(k if k.startswith(("general.", "tokenizer.")) else f"{arch}.{k}", v)
    if tok is not None:
        add_vocab(w, tok)
    add_raws(w, shapes, rand_raws(shapes, types, shared_layers))
    for n, a in f32.items():
        w.add_tensor(n, a)
    w.write()


def seeded(seed: int):
    """(f(*shape, scale, loc), ones(*shape)) of one seeded numpy stream."""
    import numpy as np

    rng = np.random.default_rng([SEED + 300, seed])
    return ((lambda *s, scale=1.0, loc=0.0: (loc + rng.standard_normal(s) * scale).astype(
        np.float32)), (lambda *s: np.ones(s, np.float32)))


def bert_file(path: str, which: str, tok) -> None:
    """nomic-embed-text-v1.5 ("nomic-v1.5"), the bge-reranker-v2-m3-width bert
    ("bge") or nomic-embed-text-v2-moe ("nomic-v2-moe") at published widths,
    full depth: LayerNorm post-norms with biases, token types; nomic's
    fused qkv and NEOX rope (base 1,000), v1.5's SiLU-gated FFN, v2's GELU
    FFN with biases and 8 experts of 3,072 (top 2) on every second layer;
    bge's learned positions, q/k/v/o and FFN biases and classification
    head."""
    c = {"nomic-v1.5": NOMIC_V15, "bge": BGE_M3, "nomic-v2-moe": NOMIC_V2_MOE}[which]
    E, L, F = c["E"], c["L"], c["F"]
    f, ones = seeded(len(which))
    shapes = {"token_embd.weight": ("q8" if which == "bge" else "token_embd", c["V"], E)}
    f32 = {"token_types.weight": f(1 if which == "bge" else 2, E, scale=0.02),
           "token_embd_norm.weight": ones(E), "token_embd_norm.bias": f(E, scale=0.02)}
    md = {"context_length": 2048, "embedding_length": E, "block_count": L,
          "feed_forward_length": F, "attention.head_count": c["H"],
          "attention.layer_norm_epsilon": 1e-12, "attention.causal": False,
          "pooling_type": 1, "vocab_size": c["V"]}
    if which == "bge":
        shapes["position_embd.weight"] = ("q8", c["P"], E)
        shapes.update({"cls.weight": ("q8", E, E), "cls.output.weight": ("q8", 1, E)})
        f32.update({"cls.bias": f(E, scale=0.02), "cls.output.bias": f(1, scale=0.02)})
        md.update({"context_length": c["P"], "attention.layer_norm_epsilon": 1e-5,
                   "pooling_type": 4})
    else:
        md["rope.freq_base"] = 1000.0
    if which == "nomic-v2-moe":
        md.update({"expert_count": c["n"], "expert_used_count": c["k"],
                   "moe_every_n_layers": c["every"]})
    for il in range(L):
        b = f"blk.{il}."
        for n in ("attn_output_norm", "layer_output_norm"):
            f32[b + n + ".weight"] = ones(E)
            f32[b + n + ".bias"] = f(E, scale=0.02)
        if which == "bge":
            for n in ("q", "k", "v"):
                shapes[f"{b}attn_{n}.weight"] = ("q8", E, E)
                f32[f"{b}attn_{n}.bias"] = f(E, scale=0.02)
            f32[b + "attn_output.bias"] = f(E, scale=0.02)
        else:
            shapes[b + "attn_qkv.weight"] = ("qkv", 3 * E, E)
        shapes[b + "attn_output.weight"] = ("q8" if which == "bge" else "attn", E, E)
        if which == "nomic-v2-moe" and il % c["every"] == 1:
            n = c["n"]
            shapes.update({b + "ffn_up_exps.weight": ("bank", n * F, E, n),
                           b + "ffn_down_exps.weight": ("bank_down", n * E, F, n)})
            f32[b + "ffn_gate_inp.weight"] = router_weight(n, E, SEED + 310 + il)
            continue
        shapes.update({b + "ffn_up.weight": ("q8" if which == "bge" else "ffn", F, E),
                       b + "ffn_down.weight": ("q8" if which == "bge" else "ffn_down", E, F)})
        if which == "nomic-v1.5":
            shapes[b + "ffn_gate.weight"] = ("ffn", F, E)
        else:
            f32.update({b + "ffn_up.bias": f(F, scale=0.02), b + "ffn_down.bias": f(E, scale=0.02)})
    arch = {"nomic-v1.5": "nomic-bert", "bge": "bert", "nomic-v2-moe": "nomic-bert-moe"}[which]
    item5_file(path, arch, md, tok, shapes, f32)


def gemma_embedding_file(path: str, tok) -> None:
    """EmbeddingGemma-300M at published widths (24 layers; 3 heads over 1
    kv head of 256; FFN 1,152; a symmetric window of 512 on five layers of
    six; the 262,144-piece vocab), Q8_0 (its FFN width is no multiple of a
    K-quant's 256)."""
    c = EGEMMA
    E, L, D = c["E"], c["L"], c["D"]
    _, ones = seeded(7)
    shapes = {"token_embd.weight": ("q8", c["V"], E)}
    f32 = {"output_norm.weight": ones(E)}
    for il in range(L):
        b = f"blk.{il}."
        shapes.update({b + "attn_q.weight": ("q8", c["H"] * D, E),
                       b + "attn_k.weight": ("q8", c["HKV"] * D, E),
                       b + "attn_v.weight": ("q8", c["HKV"] * D, E),
                       b + "attn_output.weight": ("q8", E, c["H"] * D),
                       b + "ffn_gate.weight": ("q8", c["F"], E),
                       b + "ffn_up.weight": ("q8", c["F"], E),
                       b + "ffn_down.weight": ("q8", E, c["F"])})
        for n in ("attn_norm", "post_attention_norm", "ffn_norm", "post_ffw_norm"):
            f32[b + n + ".weight"] = ones(E)
        f32.update({b + "attn_q_norm.weight": ones(D), b + "attn_k_norm.weight": ones(D)})
    md = {"context_length": 2048, "embedding_length": E, "block_count": L,
          "feed_forward_length": c["F"], "attention.head_count": c["H"],
          "attention.head_count_kv": c["HKV"], "attention.key_length": D,
          "attention.value_length": D, "attention.layer_norm_rms_epsilon": 1e-6,
          "attention.sliding_window": c["window"], "rope.freq_base": 1e6,
          "rope.freq_base_swa": 10000.0, "pooling_type": 1, "vocab_size": c["V"]}
    item5_file(path, "gemma-embedding", md, tok, shapes, f32)


def texts_of(n: int, chars: int, seed: int) -> list[str]:
    """n seeded lowercase texts of ``chars`` characters (byte tokens)."""
    import numpy as np

    rng = np.random.default_rng([SEED + 320, seed])
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    return ["".join(rng.choice(letters, chars)) for _ in range(n)]


def embed_vs_plain(torch, emb, texts) -> dict:
    """The Embedder's embeddings of ``texts`` through the kernels (its
    launches counted) against the plain route's: each row's cosine (≥
    EMBED_COS) and the NMSE."""
    reset_counts()
    got, n_tok = emb.embed(texts)
    counts = read_counts()
    with PlainKernels():
        ref, _ = emb.embed(texts)
    got_t, ref_t = torch.from_numpy(got), torch.from_numpy(ref)
    cos = torch.nn.functional.cosine_similarity(got_t.double(), ref_t.double(), dim=-1)
    check(bool(torch.isfinite(got_t).all()) and float(cos.min()) >= EMBED_COS,
          f"embeddings through the kernels against the plain route: cosine {cos.tolist()}")
    return {"rows": len(texts), "tokens": n_tok, "min_cosine": float(cos.min()),
            "nmse": nmse(got_t, ref_t), "launches": {k: counts[k] for k in ITEM5_KEYS}}


def texts_per_s(torch, emb, texts, reps: int = 3) -> float:
    emb.embed(texts)
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb.embed(texts)
        runs.append(time.perf_counter() - t0)
    return len(texts) / sorted(runs)[len(runs) // 2]


def encoders_part(torch, d: str) -> dict:
    """4p (a): nomic-embed-text-v1.5 packed (Q4_K / Q6_K, bf16) through the
    Embedder at 16 rows (qmv) and 32 rows (qmm) against the plain route;
    EmbeddingGemma-300M dense f32 (as ``serve --embed-model`` loads it) at
    B 8 × T 512, its texts a second; nomic-embed-text-v2-moe dense f32 at
    B 8 × T 512, its experts through gmm (the gather form would hold
    about 150 GB), against the plain route."""
    import gc

    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.runtime.embedder import Embedder

    out = {}
    # nomic-embed-text-v1.5, packed
    t0 = time.perf_counter()
    path = os.path.join(d, "nomic-embed-text-v1.5.gguf")
    bert_file(path, "nomic-v1.5", grammar_tokenizer(NOMIC_V15["V"]))
    m = load_model(path, dtype=torch.bfloat16, keep_quantized=True, device="cuda")
    os.remove(path)
    emb = Embedder(m)
    part = {"file_s": time.perf_counter() - t0}
    part["rows16"] = embed_vs_plain(torch, emb, texts_of(1, 15, 1))
    part["rows32"] = embed_vs_plain(torch, emb, texts_of(2, 15, 2))
    check(part["rows16"]["launches"]["qmv"] > 0 and part["rows32"]["launches"]["qmm"] > 0,
          f"nomic-embed-text-v1.5: qmv / qmm not launched: {part}")
    part["texts_per_s_b8_t64"] = texts_per_s(torch, emb, texts_of(8, 60, 3))
    out["nomic-embed-text-v1.5"] = part
    del m, emb
    gc.collect()
    torch.cuda.empty_cache()
    # EmbeddingGemma-300M, dense f32
    t0 = time.perf_counter()
    path = os.path.join(d, "embeddinggemma-300m.gguf")
    gemma_embedding_file(path, grammar_tokenizer(EGEMMA["V"]))
    m = load_model(path, device="cuda")
    os.remove(path)
    hp = m.hparams
    check((hp.arch, hp.n_layer, hp.n_head, hp.n_head_kv, hp.head_dim, hp.swa_window)
          == ("gemma-embedding", 24, 3, 1, 256, 512)
          and [hp.is_swa_layer(il) for il in range(6)] == [True] * 5 + [False],
          f"EmbeddingGemma from the file: {hp}")
    emb = Embedder(m)
    texts = texts_of(8, 500, 4)
    got, n_tok = emb.embed(texts)
    norms = torch.from_numpy(got).norm(dim=-1)
    check(got.shape == (8, 768) and bool(torch.isfinite(norms).all())
          and float((norms - 1).abs().max()) < 1e-4, f"EmbeddingGemma embeddings: {norms}")
    out["EmbeddingGemma-300M"] = {"file_s": time.perf_counter() - t0, "batch": [8, 512],
                                  "tokens": n_tok,
                                  "texts_per_s_b8_t512": texts_per_s(torch, emb, texts)}
    del m, emb
    gc.collect()
    torch.cuda.empty_cache()
    # nomic-embed-text-v2-moe, dense f32, gmm
    t0 = time.perf_counter()
    path = os.path.join(d, "nomic-embed-text-v2-moe.gguf")
    bert_file(path, "nomic-v2-moe", grammar_tokenizer(NOMIC_V2_MOE["V"]))
    m = load_model(path, device="cuda")
    os.remove(path)
    check(m.hparams.extra.get("moe_every_n_layers") == 2
          and tuple(m.params["layers"][1]["ffn_up_exps"].shape) == (8, 768, 3072),
          "nomic-embed-text-v2-moe from the file: no expert banks on layer 1")
    emb = Embedder(m)
    texts = texts_of(8, 500, 5)
    gather_bytes = 8 * 512 * 2 * 2 * 768 * 3072 * 4       # (B, T, K, E, F) f32, up and down
    part = embed_vs_plain(torch, emb, texts)
    check(part["launches"]["gmm"] > 0, f"nomic-embed-text-v2-moe: gmm not launched: {part}")
    part.update({"file_s": time.perf_counter() - t0, "gather_form_bytes": gather_bytes,
                 "texts_per_s_b8_t512": texts_per_s(torch, emb, texts)})
    out["nomic-embed-text-v2-moe"] = part
    del m, emb
    gc.collect()
    torch.cuda.empty_cache()
    return out


def chat_file(path: str, tok) -> None:
    """A one-layer 256-wide llama (Q4_K) over tok's vocab: the chat model a
    ``serve`` beside an embedding model needs."""
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams

    hp = llama3_8b_hparams(n_embd=256, n_layer=1, n_head=4, n_head_kv=2, head_dim=64,
                           n_rot=64, n_ff=512, n_vocab=len(tok.vocab.tokens))
    write_file_model(path, hp, tok, {**Q4_K_M_TYPES, "token_embd": "Q8_0", "output": "Q8_0"},
                     "synthetic-chat-tiny")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reranker_part(torch, d: str) -> dict:
    """4p (b): the bge-reranker-v2-m3-width bert behind ``serve
    --embed-model`` (a server process of the CLI beside a tiny chat model):
    /v1/embeddings (normalized, 1,024 wide) and /rerank (the scores sorted,
    equal to the in-process Embedder's on the same file within 1e-4) over
    HTTP; the server's start and each request's seconds."""
    import gc

    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.runtime.embedder import Embedder

    t0 = time.perf_counter()
    tok = grammar_tokenizer(BGE_M3["V"])
    enc = os.path.join(d, "bge-reranker-v2-m3.gguf")
    chat = os.path.join(d, "chat-tiny.gguf")
    bert_file(enc, "bge", tok)
    chat_file(chat, grammar_tokenizer(512))
    write_s = time.perf_counter() - t0
    port = free_port()
    log = open(os.path.join(OUT_DIR, "serve_embed_model.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "superllama_tpu_torch", "serve", "-m", chat,
                             "--embed-model", enc, "--port", str(port), "--no-warmup",
                             "-np", "1", "-c", "128"], stdout=log, stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    query = "where does the eiffel tower stand"
    docs = ["the eiffel tower stands in paris", "bananas are yellow", "paris is in france",
            "a tower of blocks"]
    try:
        import urllib.error
        import urllib.request

        while True:
            check(proc.poll() is None, "serve --embed-model exited; see serve_embed_model.log")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5):
                    break
            except (urllib.error.URLError, OSError):
                check(time.perf_counter() - t0 < 300, "serve --embed-model did not start")
                time.sleep(0.5)
        start_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        st, body = http(port, "/v1/embeddings", {"input": docs})
        emb_s = time.perf_counter() - t1
        data = json.loads(body)["data"]
        vecs = torch.tensor([r["embedding"] for r in data])
        check(st == 200 and vecs.shape == (4, 1024) and bool(torch.isfinite(vecs).all())
              and float((vecs.norm(dim=-1) - 1).abs().max()) < 1e-4,
              f"/v1/embeddings: {st} {tuple(vecs.shape)}")
        t1 = time.perf_counter()
        st, body = http(port, "/rerank", {"query": query, "documents": docs,
                                          "return_documents": True})
        rerank_s = time.perf_counter() - t1
        results = json.loads(body)["results"]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    scores = [r["relevance_score"] for r in results]
    check(st == 200 and sorted(r["index"] for r in results) == [0, 1, 2, 3]
          and scores == sorted(scores, reverse=True)
          and all(r["document"]["text"] == docs[r["index"]] for r in results),
          f"/rerank: {st} {results}")
    m = load_model(enc, device="cuda")
    own, _ = Embedder(m).rerank(query, docs)
    diff = max(abs(r["relevance_score"] - own[r["index"]]) for r in results)
    check(diff <= 1e-4 * max(1.0, max(abs(s) for s in own)),
          f"/rerank scores against the in-process Embedder's: {scores} vs {own}")
    hp = m.hparams
    check((hp.arch, hp.n_layer, hp.n_embd, m.params["position_embd"].shape[0])
          == ("bert", 24, 1024, 8194) and m.params["cls_out"] is not None,
          f"the reranker from the file: {hp}")
    del m
    gc.collect()
    torch.cuda.empty_cache()
    for p in (enc, chat):
        os.remove(p)
    return {"write_s": write_s, "server_start_s": start_s, "embeddings_s": emb_s,
            "rerank_s": rerank_s, "rerank_scores": scores, "score_diff_in_process": diff}


class DiffusionTap:
    """Within the block, ``runtime.diffusion.diffusion_generate`` (as the
    CLI calls it) records its model, prompt, params and tokens, each forward
    call's window, f32 logits and device ms (synchronized around it), and
    each step's start; ``plain()`` then runs the same generation through
    the plain route (PlainKernels) with the same records."""

    def __enter__(self):
        from superllama_tpu_torch.runtime import diffusion as mod

        self.mod, self.real, self.runs = mod, mod.diffusion_generate, []
        mod.diffusion_generate = self.generate
        return self

    def __exit__(self, *exc):
        self.mod.diffusion_generate = self.real

    def generate(self, forward_fn, params, hp, ids, dp, step_callback=None):
        import torch

        rec = {"forward": forward_fn, "params": params, "hp": hp, "ids": list(ids), "dp": dp,
               "calls": [], "steps": []}

        def fwd(p, h, t, pos, cache):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, c = forward_fn(p, h, t, pos, cache)
            torch.cuda.synchronize()
            rec["calls"].append((t[0].tolist(), logits[0].float().cpu(),
                                 (time.perf_counter() - t0) * 1e3))
            return logits, c

        def on_step(s, n, toks):
            rec["steps"].append(time.perf_counter())
            if step_callback:
                step_callback(s, n, toks)

        t0 = time.perf_counter()
        rec["tokens"] = self.real(fwd, params, hp, ids, dp, on_step)
        rec["end"], rec["start"] = time.perf_counter(), t0
        self.runs.append(rec)
        return rec["tokens"]

    def plain(self, run: dict) -> dict:
        with PlainKernels():
            self.generate(run["forward"], run["params"], run["hp"], run["ids"], run["dp"])
        return self.runs.pop()


def step_split(run: dict) -> dict:
    """A generation's ms a step, its forward's ms and the host's rest."""
    steps = run["steps"] + [run["end"]]
    wall = [(b - a) * 1e3 for a, b in zip(steps, steps[1:])]
    fwd = [c[2] for c in run["calls"]]
    n = len(wall)
    return {"steps": n, "ms_a_step": sum(wall) / n, "forward_ms": sum(fwd) / n,
            "host_ms": (sum(wall) - sum(fwd)) / n}


def diffusion_rule(got: dict, ref: dict) -> dict:
    """The kernel route's tokens (got) against the plain route's (ref):
    equal, or parted at a step whose input window both routes shared, where
    their logits agree within PATH_NMSE and every decision that differs is
    a near tie: a position sampled to another token has the two
    candidates' plain logits within 2 D (D the routes' largest logit
    difference over the window); where no position's token differs (the
    transfer sets parted), two positions' plain confidences lie within 2 ×
    the routes' largest confidence difference."""
    if got["tokens"] == ref["tokens"]:
        return {"equal": True}
    calls = list(zip(got["calls"], ref["calls"]))
    j = next((i for i, (a, b) in enumerate(calls) if a[0] != b[0]), len(calls))
    check(j > 0, "the routes' first windows differ")
    (win, lg, _), (_, lr, _) = calls[j - 1]
    D = float((lg - lr).abs().max())
    err = nmse(lg, lr)
    check(err <= PATH_NMSE, f"diffusion: the routes' logits at step {j - 1} NMSE {err}")
    mask = got["dp"].mask_token_id
    shift = got["dp"].shift_logits
    worst = 0.0
    for i, t in enumerate(win):
        if t != mask:
            continue
        row_g, row_r = (lg[max(i - 1, 0)], lr[max(i - 1, 0)]) if shift else (lg[i], lr[i])
        x, y = int(row_r.argmax()), int(row_g.argmax())
        if x != y:
            gap = float(row_r[x] - row_r[y])
            worst = max(worst, gap)
            check(gap <= 2 * D, f"diffusion step {j - 1}, position {i}: tokens {x} / {y} "
                                f"{gap} apart, the routes only {D}")
    if worst == 0.0:            # the same tokens: the transfer sets parted
        rows = [max(i - 1, 0) if shift else i for i, t in enumerate(win) if t == mask]
        cg = lg[rows].double().softmax(-1).amax(-1)
        cr = lr[rows].double().softmax(-1).amax(-1)
        cdiff = float((cg - cr).abs().max())
        srt = cr.sort().values
        tie = float((srt[1:] - srt[:-1]).min()) if len(rows) > 1 else float("inf")
        check(tie <= 2 * cdiff, f"diffusion step {j - 1}: the transfer sets part, but the "
                                f"nearest confidences lie {tie} apart, the routes {cdiff}")
        worst = tie
    return {"equal": False, "parted_at_step": j - 1, "logit_nmse": err, "spread": D,
            "worst_gap": worst}


def diffusion_file(path: str, cfg: dict, tok) -> None:
    """A diffusion LM at published widths, DIFFUSION_LAYERS deep, Q4_K_M-style
    (rand_raw bytes; every layer layer 0's), with the vocab's mask token:
    LLaDA-8B's llama block, Dream-v0-7B's qwen2 block (q/k/v biases), or
    RND1's qwen3-moe block (per-head q/k norms, 128 experts of 768, top
    8)."""
    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams

    arch = cfg["arch"]
    hp = llama3_8b_hparams(**{k: v for k, v in cfg.items() if k not in ("mask", "max_length")},
                           n_layer=DIFFUSION_LAYERS, head_dim_v=cfg["head_dim"],
                           n_rot=cfg["head_dim"])
    f, ones = seeded(len(arch))
    f32, experts, keys, types = {}, None, {}, Q4_K_M_TYPES
    for il in range(hp.n_layer):
        b = f"blk.{il}."
        if arch == "dream":
            for n, w in (("q", hp.n_head), ("k", hp.n_head_kv), ("v", hp.n_head_kv)):
                f32[f"{b}attn_{n}.bias"] = f(w * hp.head_dim, scale=0.02)
        if arch == "rnd1":
            f32[b + "ffn_gate_inp.weight"] = router_weight(QWEN3_MOE_EXPERTS[0], hp.n_embd,
                                                           SEED + 330 + il)
            f32.update({b + "attn_q_norm.weight": ones(hp.head_dim),
                        b + "attn_k_norm.weight": ones(hp.head_dim)})
    if arch == "rnd1":
        experts, keys, types = QWEN3_MOE_EXPERTS, dict(QWEN3_MOE_KEYS), QWEN3_MOE_TYPES
    keys.update({"attention.key_length": hp.head_dim, "attention.value_length": hp.head_dim,
                 "tokenizer.ggml.mask_token_id": cfg["mask"]})
    write_file_model(path, hp, tok, types, f"synthetic-{arch}", shared_layers=True, arch=arch,
                     keys=keys, experts=experts, f32_tensors=f32)


def diffusion_part(torch, d: str, cfg: dict, label: str, need=()) -> dict:
    """4p (c): one diffusion LM written, then the ``diffusion`` CLI on it
    (--keep-quantized; the mask token the vocab's; Dream's shifted logits),
    its generation recorded (DiffusionTap) and run again through the plain
    route on the same params: tokens equal or parted at a near tie
    (diffusion_rule); the launches of ``need`` (and qmv at a window of ≤ 16
    tokens, qmm at 17-32), a step's ms split into the forward and the
    host."""
    import contextlib
    import gc
    import io

    from superllama_tpu_torch import cli

    tok = grammar_tokenizer(cfg["n_vocab"])
    path = os.path.join(d, f"{cfg['arch']}.gguf")
    t0 = time.perf_counter()
    diffusion_file(path, cfg, tok)
    write_s = time.perf_counter() - t0
    argv = ["diffusion", "-m", path, "-p", "Hi", "--steps", str(DIFFUSION_STEPS),
            "--max-length", str(cfg["max_length"]), "--keep-quantized"]
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with DiffusionTap() as tap, contextlib.redirect_stdout(out):
        check(cli.main(argv) == 0, f"{label}: the diffusion CLI failed")
        counts = read_counts()
        cli_s = time.perf_counter() - t0
        (run,) = tap.runs
        tap.runs = []
        ref = tap.plain(run)
    os.remove(path)
    kind = "qmv" if cfg["max_length"] <= 16 else "qmm"
    for k in (kind,) + tuple(need):
        check(counts[k] > 0, f"{label}: the diffusion run never launched {k}: {counts}")
    toks = run["tokens"]
    n_in = len(run["ids"])
    check(len(toks) == cfg["max_length"] and cfg["mask"] not in toks[n_in:]
          and out.getvalue().strip() != "", f"{label}: the CLI's window {toks}")
    info = {"write_s": write_s, "cli_s": cli_s, "max_length": cfg["max_length"],
            "prompt_tokens": n_in, "steps": DIFFUSION_STEPS, **step_split(run),
            "plain": step_split(ref), "rule": diffusion_rule(run, ref),
            "launches": {k: counts[k] for k in ITEM5_KEYS},
            "hparams": {"arch": run["hp"].arch, "n_embd": run["hp"].n_embd,
                        "n_layer": run["hp"].n_layer, "n_vocab": run["hp"].n_vocab}}
    del run, ref, tap
    gc.collect()
    torch.cuda.empty_cache()
    return info


def t5_file(path: str, tok) -> None:
    """flan-t5-large at published widths, full depth (24 + 24 layers, 16
    heads of 64, a GELU-gated FFN of 2,816, 32 relative buckets on layer 0
    of each stack), Q4_K_M-style rand_raw bytes (every layer layer 0's)."""
    c = FLAN_T5_LARGE
    E, L, HD, F = c["E"], c["L"], c["H"] * c["D"], c["F"]
    f, ones = seeded(5)
    shapes = {"token_embd.weight": ("token_embd", c["V"], E), "output.weight": ("output", c["V"], E)}
    f32 = {"enc.output_norm.weight": ones(E), "dec.output_norm.weight": ones(E)}
    for side in ("enc", "dec"):
        for il in range(L):
            b = f"{side}.blk.{il}."
            names = [("attn", "attn_q"), ("attn", "attn_k"), ("attn_v", "attn_v")]
            if side == "dec":
                names += [("attn", "cross_attn_q"), ("attn", "cross_attn_k"),
                          ("attn_v", "cross_attn_v")]
                shapes[b + "cross_attn_o.weight"] = ("attn_output", E, HD)
                f32[b + "cross_attn_norm.weight"] = ones(E)
            for role, n in names:
                shapes[f"{b}{n}.weight"] = ({"attn": "attn_q", "attn_v": "attn_v"}[role], HD, E)
            shapes.update({b + "attn_o.weight": ("attn_output", E, HD),
                           b + "ffn_gate.weight": ("ffn_gate", F, E),
                           b + "ffn_up.weight": ("ffn_up", F, E),
                           b + "ffn_down.weight": ("ffn_down", E, F)})
            f32.update({b + "attn_norm.weight": ones(E), b + "ffn_norm.weight": ones(E)})
            if il == 0:
                f32[b + "attn_rel_b.weight"] = f(c["buckets"], c["H"], scale=0.5)
    md = {"context_length": 512, "embedding_length": E, "block_count": L,
          "decoder_block_count": L, "feed_forward_length": F, "attention.head_count": c["H"],
          "attention.head_count_kv": c["H"], "attention.key_length": c["D"],
          "attention.value_length": c["D"], "attention.layer_norm_rms_epsilon": 1e-6,
          "attention.relative_buckets_count": c["buckets"], "decoder_start_token_id": 0,
          "vocab_size": c["V"]}
    item5_file(path, "t5", md, tok, shapes, f32, Q4_K_M_TYPES)


def t5_part(torch, d: str) -> dict:
    """4p (d): flan-t5-large packed (bf16), full depth: the bucket table on
    the card equal to the CPU's (|rel| ≤ 512, 32 buckets, both
    directions); ``T5Model.generate`` (a 32-token source through qmm, each
    decode step through qmv) against the plain route, tokens equal or
    parted where the two candidates' logits lie within the routes'
    difference (teacher-forced over the plain tokens, NMSE ≤ PATH_NMSE);
    the encoder's ms and the decoder's ms a token."""
    import gc

    import numpy as np

    from superllama_tpu_torch.models import t5 as t5mod
    from superllama_tpu_torch.models.loader import load_model
    from superllama_tpu_torch.runtime.kv_cache import kv_cache_init

    c = FLAN_T5_LARGE
    path = os.path.join(d, "flan-t5-large.gguf")
    t0 = time.perf_counter()
    t5_file(path, grammar_tokenizer(c["V"]))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = load_model(path, dtype=torch.bfloat16, keep_quantized=True, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    os.remove(path)
    hp = m.hparams
    check((hp.arch, hp.n_layer, hp.dec_n_layer, hp.n_rel_attn_bkts) == ("t5", 24, 24, 32)
          and len(m.params["dec_layers"]) == 24, f"flan-t5-large from the file: {hp}")
    rel = torch.arange(-512, 513, dtype=torch.int32)[None]
    for bi in (True, False):
        on = t5mod.relative_position_bucket(rel.cuda(), 32, bi).cpu()
        check(torch.equal(on, t5mod.relative_position_bucket(rel, 32, bi)),
              f"the bucket table on the card differs from the CPU's (bidirectional {bi})")
    src = token_prompts(c["V"], [T5_SRC], SEED + 340)[0]
    model = t5mod.T5Model(m, n_ctx=64)
    reset_counts()
    with torch.no_grad():
        enc = t5mod.t5_encode(m.params, hp, torch.tensor([src], device="cuda"))
    enc_counts = read_counts()
    reset_counts()
    got = model.generate(src, T5_GEN)
    counts = read_counts()
    check(enc_counts["qmm"] > 0 and counts["qmv"] > 0,
          f"flan-t5-large: qmm {enc_counts['qmm']} in the encoder, qmv {counts['qmv']}")
    with PlainKernels():
        ref = model.generate(src, T5_GEN)

    def last_logits(prefix):
        with torch.no_grad():
            e = t5mod.t5_encode(m.params, hp, torch.tensor([src], device="cuda"))
            ckv = t5mod.t5_cross_kv(m.params, hp, e)
            cache = kv_cache_init(hp.dec_n_layer, 1, 64, hp.n_head, hp.head_dim, hp.head_dim,
                                  dtype=torch.float32, device="cuda")
            ids = [hp.dec_start_token_id] + list(prefix)
            pos = torch.arange(len(ids), dtype=torch.int32, device="cuda")[None]
            lg, _ = t5mod.t5_decode(m.params, hp, torch.tensor([ids], device="cuda"), pos,
                                    cache, ckv)
            return lg[0, -1].float().cpu()

    rule = {"equal": got == ref}
    if got != ref:
        i = first_divergence(ref, got)
        check(i is not None, f"flan-t5-large: {len(got)} tokens against {len(ref)}")
        b = last_logits(ref[:i])
        with PlainKernels():
            a = last_logits(ref[:i])
        gap, D = abs(float(a[ref[i]] - a[got[i]])), float((a - b).abs().max())
        check(gap <= D and nmse(b, a) <= PATH_NMSE,
              f"flan-t5-large: tokens part at {i}, {gap} apart, routes {D} apart")
        rule.update({"parted_at": i, "logit_gap": gap, "path_diff": D, "nmse": nmse(b, a)})
    enc_ms = cuda_ms(torch, lambda i: t5mod.t5_encode(m.params, hp,
                                                      torch.tensor([src], device="cuda")), 3, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = len(model.generate(src, T5_GEN))
    gen_s = time.perf_counter() - t0
    info = {"write_s": write_s, "load_s": load_s, "src_tokens": T5_SRC, "tokens": n,
            "rule": rule, "encoder_ms": enc_ms, "ms_a_token": (gen_s * 1e3 - enc_ms) / n,
            "launches_encoder": {k: enc_counts[k] for k in ITEM5_KEYS},
            "launches_generate": {k: counts[k] for k in ITEM5_KEYS},
            "enc_finite": bool(torch.isfinite(enc.float()).all())}
    check(info["enc_finite"] and np.all(np.asarray(got) < c["V"]), "flan-t5-large outputs")
    del m, model, enc
    gc.collect()
    torch.cuda.empty_cache()
    return info


def voice_file(path: str, tok) -> None:
    """OuteTTS-0.2-500M's voice LM (Qwen2.5-0.5B widths: 24 layers, 14 heads
    over 2 kv heads of 64, FFN 4,864, q/k/v biases, a tied head; the
    157,696-piece vocab), Q8_0 rand_raw bytes (every layer layer 0's), its
    head's bias lifting the audio-code rows (151,672-155,767) so that greedy
    decoding of random weights emits codes."""
    import numpy as np

    from superllama_tpu_torch.models.synthetic import llama3_8b_hparams
    from superllama_tpu_torch.tools.tts import CODE_OFFSET

    c = OUTETTS
    hp = llama3_8b_hparams(arch="qwen2", n_embd=c["E"], n_layer=c["L"], n_head=c["H"],
                           n_head_kv=c["HKV"], head_dim=c["D"], head_dim_v=c["D"],
                           n_rot=c["D"], n_ff=c["F"], n_vocab=c["V"], rope_freq_base=1e6,
                           rms_eps=1e-6)
    f, _ = seeded(11)
    bias = np.zeros(c["V"], np.float32)
    bias[CODE_OFFSET:CODE_OFFSET + WAVTOK["V"]] = 8.0
    f32 = {"output.bias": bias}
    for il in range(hp.n_layer):
        for n, w in (("q", c["H"]), ("k", c["HKV"]), ("v", c["HKV"])):
            f32[f"blk.{il}.attn_{n}.bias"] = f(w * c["D"], scale=0.02)
    q8 = {role: "Q8_0" for role in Q4_K_M_TYPES}
    write_file_model(path, hp, tok, q8, "synthetic-outetts-0.2-500m", shared_layers=True,
                     arch="qwen2", tied=True, f32_tensors=f32)


def wavtokenizer_file(path: str) -> None:
    """WavTokenizer-large's decoder at published widths (512 features, a
    768-wide posnet of 6 blocks and 12 ConvNeXt blocks of 768 / 2,304, 4,096
    codes, a 1,282-wide head for n_fft 1,280), seeded F32 weights."""
    from superllama_tpu_torch.gguf import GGUFWriter

    c = WAVTOK
    f, ones = seeded(13)
    t = {"token_embd.weight": f(c["V"], c["feat"], scale=1.0),
         "conv1d.weight": f(c["pe"], c["feat"], 7, scale=(c["feat"] * 7) ** -0.5),
         "conv1d.bias": f(c["pe"], 1, scale=0.02)}
    for il, kind in enumerate(("res", "res", "attn", "res", "res", "norm")):
        b = f"posnet.{il}."
        if kind == "res":
            for n in ("norm1", "norm2"):
                t[b + n + ".weight"], t[b + n + ".bias"] = ones(c["pe"], 1), f(c["pe"], 1, scale=0.02)
            for n in ("conv1", "conv2"):
                t[b + n + ".weight"] = f(c["pe"], c["pe"], 3, scale=0.5 * (c["pe"] * 3) ** -0.5)
                t[b + n + ".bias"] = f(c["pe"], 1, scale=0.02)
        elif kind == "attn":
            t[b + "attn_norm.weight"], t[b + "attn_norm.bias"] = ones(c["pe"], 1), f(c["pe"], 1,
                                                                                    scale=0.02)
            for n in ("attn_q", "attn_k", "attn_v", "attn_output"):
                t[b + n + ".weight"] = f(c["pe"], c["pe"], 1, scale=c["pe"] ** -0.5)
                t[b + n + ".bias"] = f(c["pe"], 1, scale=0.02)
        else:
            t[b + "norm.weight"], t[b + "norm.bias"] = ones(c["pe"], 1), f(c["pe"], 1, scale=0.02)
    t["token_embd_norm.weight"], t["token_embd_norm.bias"] = ones(c["pe"]), f(c["pe"], scale=0.02)
    for il in range(c["convnext"]):
        b = f"convnext.{il}."
        t.update({b + "dw.weight": f(c["ce"], 1, 7, scale=7 ** -0.5),
                  b + "dw.bias": f(c["ce"], 1, scale=0.02), b + "norm.weight": ones(c["ce"]),
                  b + "norm.bias": f(c["ce"], scale=0.02),
                  b + "pw1.weight": f(c["F"], c["ce"], scale=c["ce"] ** -0.5),
                  b + "pw1.bias": f(c["F"], scale=0.02),
                  b + "pw2.weight": f(c["ce"], c["F"], scale=c["F"] ** -0.5),
                  b + "pw2.bias": f(c["ce"], scale=0.02),
                  b + "gamma.weight": f(c["ce"], scale=0.1)})
    t["output_norm.weight"], t["output_norm.bias"] = ones(c["ce"]), f(c["ce"], scale=0.02)
    t["output.weight"] = f(c["n_out"], c["ce"], scale=0.3 * c["ce"] ** -0.5)
    t["output.bias"] = f(c["n_out"], scale=0.1)
    md = {"embedding_length": c["ce"], "features_length": c["feat"],
          "posnet.embedding_length": c["pe"], "posnet.block_count": 6,
          "convnext.embedding_length": c["ce"], "convnext.block_count": c["convnext"],
          "attention.group_norm_groups": 32, "attention.group_norm_epsilon": 1e-6,
          "feed_forward_length": c["F"], "vocab_size": c["V"],
          "attention.layer_norm_epsilon": 1e-6}
    w = GGUFWriter(path, arch="wavtokenizer-dec")
    w.add("general.name", "synthetic-wavtokenizer-large")
    for k, v in md.items():
        w.add(f"wavtokenizer-dec.{k}", v)
    for n, a in t.items():
        w.add_tensor(n, a)
    w.write()


class TTSTap:
    """Within the block, ``tools.tts.tts_generate`` (as the CLI calls it)
    records its two models, its seconds and its audio."""

    def __enter__(self):
        from superllama_tpu_torch.tools import tts as mod

        self.mod, self.real, self.rec = mod, mod.tts_generate, {}
        mod.tts_generate = self.generate
        return self

    def __exit__(self, *exc):
        self.mod.tts_generate = self.real

    def generate(self, ttc, cts, text, n_predict=1024):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = self.real(ttc, cts, text, n_predict)
        self.rec.update(ttc=ttc, cts=cts, seconds=time.perf_counter() - t0, audio=audio)
        return audio


def tts_part(torch, d: str) -> dict:
    """4p (e): the ``tts`` CLI with the OuteTTS-width voice LM and the
    WavTokenizer-large-width decoder (both dense f32, as the CLI loads
    them): a prompt of ≥ 32 tokens (its prefill through fa's CUDA-core
    kernel: an f32 cache), TTS_CODES greedy codes, a WAV of non-zero
    samples; the pipeline's seconds a second of audio; the decoder's frames
    on fixed codes against its CPU run on the same weights (NMSE ≤
    ARCH_NMSE: cuDNN's convolutions may take TF32)."""
    import gc
    import wave

    import numpy as np

    from superllama_tpu_torch import cli
    from superllama_tpu_torch.models.wavtokenizer import wavtokenizer_decode
    from superllama_tpu_torch.tools.tts import SAMPLE_RATE, tts_prompt

    tok = grammar_tokenizer(OUTETTS["V"], control=TTS_CONTROL)
    voice, vocoder = os.path.join(d, "outetts.gguf"), os.path.join(d, "wavtokenizer.gguf")
    wav_out = os.path.join(d, "out.wav")
    t0 = time.perf_counter()
    voice_file(voice, tok)
    wavtokenizer_file(vocoder)
    write_s = time.perf_counter() - t0
    n_prompt = len(tok.encode(tts_prompt(TTS_TEXT), add_special=True, parse_special=True))
    check(n_prompt >= 32, f"the TTS prompt is {n_prompt} tokens")
    reset_counts()
    t0 = time.perf_counter()
    with TTSTap() as tap:
        check(cli.main(["tts", "-m", voice, "-mv", vocoder, "-p", TTS_TEXT, "-o", wav_out,
                        "-n", str(TTS_CODES)]) == 0, "the tts CLI failed")
    cli_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["fa"] > 0, f"the TTS prompt never launched fa: {counts}")
    with wave.open(wav_out) as w:
        check(w.getframerate() == SAMPLE_RATE and w.getnchannels() == 1, "the WAV's format")
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    audio = tap.rec["audio"]
    check(pcm.size == audio.size == (TTS_CODES - 1) * 320 + 1280 - 960
          and int(np.abs(pcm).max()) > 0, f"the WAV: {pcm.size} samples, max {np.abs(pcm).max()}")
    cts = tap.rec["cts"]
    codes = torch.arange(64, device="cuda")[None] * 61 % WAVTOK["V"]
    with torch.no_grad():
        got = wavtokenizer_decode(cts.params, cts.hparams, codes).float().cpu()
        cpu = {k: ([{n: t.cpu() for n, t in layer.items()} for layer in v]
                   if isinstance(v, list) else (v.cpu() if v is not None else None))
               for k, v in cts.params.items()}
        ref = wavtokenizer_decode(cpu, cts.hparams, codes.cpu())
    err = nmse(got, ref)
    check(err <= ARCH_NMSE, f"the WavTokenizer frames on the card against the CPU: NMSE {err}")
    with torch.no_grad():
        decoder_ms = cuda_ms(torch, lambda i: wavtokenizer_decode(
            cts.params, cts.hparams, codes[:, :TTS_CODES]), 5, 1)
    info = {"write_s": write_s, "cli_s": cli_s, "prompt_tokens": n_prompt, "codes": TTS_CODES,
            "samples": int(pcm.size), "audio_s": pcm.size / SAMPLE_RATE,
            "pipeline_s": tap.rec["seconds"],
            "s_per_audio_s": tap.rec["seconds"] / (pcm.size / SAMPLE_RATE),
            "decoder_ms": decoder_ms, "decoder_frames_nmse_vs_cpu": err,
            "launches": {k: counts[k] for k in ITEM5_KEYS}}
    for p in (voice, vocoder, wav_out):
        os.remove(p)
    del tap, cts, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return info


def item5_attention_times(torch) -> dict:
    """The plain attention the encoders and the diffusion LMs run (ROADMAP §2
    holds its kernel form), timed by CUDA events, beside fa_tc's causal
    time at the same shape (bf16): EmbeddingGemma's B 8 × T 512 (3 heads
    over 1 kv head of 256; ``attention_ref`` with the key-padding mask, f32
    as served, and bf16) and LLaDA-8B's window of 128 (the CLI's default
    max_length; 32 heads of 128; ``llada.bidirectional_attention``, bf16)."""
    from superllama_tpu_torch.models.llada import bidirectional_attention
    from superllama_tpu_torch.ops import ref as ops
    from superllama_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 350)
    i32 = dict(dtype=torch.int32, device="cuda")

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    out = {}
    B, T, H, D = 8, 512, 3, 256
    pos = torch.arange(T, **i32)[None].expand(B, T).contiguous()
    mask = torch.zeros((B, 1, 1, T), device="cuda")
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = rnd(B, T, H, D, dtype=dt), rnd(B, 1, T, D, dtype=dt), rnd(B, 1, T, D, dtype=dt)
        out[f"egemma_b8_t512_plain_{name}_ms"] = cuda_ms(
            torch, lambda i: ops.attention_ref(q, k, v, mask, scale=D ** -0.5), 10)
    q, k, v = rnd(B, T, H, D), rnd(B, 1, T, D), rnd(B, 1, T, D)
    out["egemma_b8_t512_fa_tc_causal_ms"] = cuda_ms(
        torch, lambda i: flash_attention(q, k, v, pos, pos, scale=D ** -0.5), 20)
    T, H, D = 128, 32, 128
    pos = torch.arange(T, **i32)[None]
    q, k, v = rnd(1, T, H, D), rnd(1, T, H, D), rnd(1, T, H, D)
    out["llada8b_t128_plain_bf16_ms"] = cuda_ms(
        torch, lambda i: bidirectional_attention(q, k, v, D ** -0.5), 20)
    kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    out["llada8b_t128_fa_tc_causal_ms"] = cuda_ms(
        torch, lambda i: flash_attention(q, kc, vc, pos, pos, scale=D ** -0.5), 20)
    torch.cuda.empty_cache()
    return out


def phase_item5(torch, smi_line: str) -> dict:
    """4p. Encoders, T5, diffusion LMs and TTS: each part's line with its
    seconds so far (``at_s``), the card's name and power limit, and the
    launches of its own run (counts set to 0 just before it)."""
    import shutil
    import tempfile

    t_all = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    d = tempfile.mkdtemp(prefix="item5_", dir=build)
    out = {}
    try:
        parts = [("encoders", lambda: encoders_part(torch, d)),
                 ("reranker_server", lambda: reranker_part(torch, d)),
                 ("diffusion_llada_8b", lambda: diffusion_part(torch, d, LLADA_8B, "LLaDA-8B")),
                 ("diffusion_dream_7b", lambda: diffusion_part(torch, d, DREAM_7B, "Dream-v0-7B")),
                 ("diffusion_rnd1", lambda: diffusion_part(torch, d, RND1, "RND1", ("gmm",))),
                 ("t5_flan_large", lambda: t5_part(torch, d)),
                 ("tts_outetts", lambda: tts_part(torch, d)),
                 ("attention_times", lambda: item5_attention_times(torch))]
        for name, run in parts:
            t0 = time.perf_counter()
            out[name] = run()
            emit({"phase": f"item5_{name}", "card": smi_line, **out[name],
                  "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    launches = {}

    def add(obj):
        for key, v in obj.items():
            if key.startswith("launches"):
                for k, n in v.items():
                    launches[k] = launches.get(k, 0) + n
            elif isinstance(v, dict):
                add(v)

    add(out)
    for k in ("qmv", "qmm", "fa", "gmm"):
        check(launches.get(k, 0) > 0, f"phase 4p never launched {k}: {launches}")
    emit({"phase": "item5", "card": smi_line, "launches": launches,
          "seconds": time.perf_counter() - t_all})
    return {"launches": launches}


# ------------------------------------------------------------ main

# (name, source, the TPU kernel it replaces, the timing entry of its record)
KERNELS = [
    ("qmv", "superllama_tpu_torch/csrc/qmv.cu", "superllama_tpu/ops/qmatmul.py:235", "qmv"),
    ("qmm", "superllama_tpu_torch/csrc/qmm.cu", "superllama_tpu/ops/qmatmul.py:94", "qmm"),
    ("fa", "superllama_tpu_torch/csrc/fa.cu", "superllama_tpu/ops/flash_attention.py:36", "fa"),
    ("fa_tc", "superllama_tpu_torch/csrc/fa.cu", "superllama_tpu/ops/flash_attention.py:36",
     "fa_tc"),
    ("fd", "superllama_tpu_torch/csrc/fd.cu", "superllama_tpu/ops/flash_attention.py:326",
     "fd_q8"),
    ("paged", "superllama_tpu_torch/csrc/paged.cu",
     "superllama_tpu/ops/paged_attention.py:138", "paged"),
    ("paged_tc", "superllama_tpu_torch/csrc/paged.cu",
     "superllama_tpu/ops/paged_attention.py:138", "paged prefill B=1 T=128"),
] + [(f"{k}_{fam}", f"superllama_tpu_torch/csrc/{k}.cu", f"superllama_tpu/ops/qmatmul.py:{line}",
       f"{k}_{fam}") for k, line in (("qmv", 235), ("qmm", 94)) for fam in ("i8", "nib", "q5k")
] + [(f"qmv_probe_{v}", "superllama_tpu_torch/csrc/qmv_probe.cu",
      f"superllama_tpu/tools/qmv_probe.py:{line}", f"qmv_probe_{v} N=14336")
     for v, line in (("v1", 53), ("v2", 64), ("v3", 91), ("v4", 78))] + [
    # not a Pallas kernel: ragged_dot's grouped GEMM in _experts_apply
    ("gmm", "superllama_tpu_torch/csrc/gmm.cu", "superllama_tpu/models/llama.py:194", "gmm"),
    # not a Pallas kernel: the jax.lax.scan of the mixers' selective scan
    ("ssm_scan", "superllama_tpu_torch/csrc/ssm_scan.cu", "superllama_tpu/models/mamba.py:134",
     "ssm_scan")] + [
    # not Pallas kernels: the jax.lax.scan recurrences of the linear-attention models
    (rule, "superllama_tpu_torch/csrc/wkv.cu", replaces, rule)
    for rule, replaces in (("wkv6", "superllama_tpu/models/rwkv.py:53"),
                           ("gla", "superllama_tpu/models/rwkv.py:89"),
                           ("wkv7", "superllama_tpu/models/rwkv.py:73"),
                           ("delta_net", "superllama_tpu/models/qwen3next.py:60"))]


# ------------------------------------------------------------ 4h. the front door

FRONT_KEYS = {"sk-alice": "alice", "sk-bob": "bob", "sk-carol": "carol"}
ALICE = {"x-api-key": "sk-alice"}
FIM_PIECES = ("<|fim_prefix|>", "<|fim_suffix|>", "<|fim_middle|>")
FRONT_SYSTEM = "You are a terse assistant."
FRONT_USER = "Name three colours."
# a short name and short values: a grammar token costs about 0.5 s of mask here
PICK_TOOL = {"name": "tint", "description": "pick a colour",
             "input_schema": {"type": "object",
                              "properties": {"c": {"enum": ["red", "green", "blue"]}},
                              "required": ["c"], "additionalProperties": False}}
FRONT_CACHES = (("q8_0", {"kv_dtype": "q8_0"}, ("qmv", "fd")),
                ("paged", {"paged": True, "page_size": 256}, ("qmv", "paged")))
FRONT_RPM = 30          # the flooding client's limit: 30 a minute + RateLimiter's burst of 10


class FrontDoor:
    """HTTP calls to one server with their status (errors included),
    counting those that pass the key and rate checks (each adds one line to
    the server's JSONL metrics log)."""

    def __init__(self, port: int):
        self.port, self.passed = port, 0

    def call(self, path: str, body=None, headers=ALICE, timeout: float = 600.0):
        import urllib.error
        import urllib.request

        r = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}",
            data=json.dumps(body).encode() if body is not None else None,
            method="POST" if body is not None else "GET",
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(r, timeout=timeout) as resp:
                st, ctype, data = resp.status, resp.headers["Content-Type"], resp.read()
        except urllib.error.HTTPError as e:
            st, ctype, data = e.code, e.headers["Content-Type"], e.read()
        if body is not None and st not in (401, 429):
            self.passed += 1
        return st, (json.loads(data) if "json" in (ctype or "") else data.decode())

    def ok(self, path: str, body=None, headers=ALICE):
        st, out = self.call(path, body, headers)
        check(st == 200, f"{path}: HTTP {st}: {str(out)[:300]}")
        return out


def sse_events(raw: str) -> list:
    out = []
    for block in raw.strip().split("\n\n"):
        ev = data = None
        for ln in block.split("\n"):
            if ln.startswith("event: "):
                ev = ln[7:]
            elif ln.startswith("data: "):
                data = json.loads(ln[6:])
        out.append((ev, data))
    return out


def graph_captures(eng) -> tuple:
    return tuple(graph_stats(eng, k).get("captures", 0) for k in ("chunk", "block"))


def front_messages(door: FrontDoor, eng, label: str) -> dict:
    """A greedy /v1/messages request of 64 tokens against /v1/completions of
    the same rendered prompt (each on erased slots): the same text, the
    usage of the same tokens; the walls of both."""
    body = {"system": FRONT_SYSTEM, "messages": [{"role": "user", "content": FRONT_USER}],
            "max_tokens": 64, "temperature": 0}
    fresh(eng)
    t0 = time.perf_counter()
    msg = door.ok("/v1/messages", body)
    t_msg = time.perf_counter() - t0
    prompt = door.ok("/apply-template", {"messages": [
        {"role": "system", "content": FRONT_SYSTEM},
        {"role": "user", "content": FRONT_USER}]})["prompt"]
    fresh(eng)
    t0 = time.perf_counter()
    comp = door.ok("/v1/completions", {"prompt": prompt, "max_tokens": 64, "temperature": 0})
    t_comp = time.perf_counter() - t0
    text = msg["content"][0]["text"]
    check(msg["type"] == "message" and msg["content"][0]["type"] == "text",
          f"{label} /v1/messages: {str(msg)[:300]}")
    check(text == comp["choices"][0]["text"],
          f"{label}: /v1/messages text differs from /v1/completions of its prompt")
    check(msg["usage"]["output_tokens"] == comp["usage"]["completion_tokens"] == 64,
          f"{label}: usage {msg['usage']} against {comp['usage']}")
    check(msg["stop_reason"] == "max_tokens", f"{label}: stop_reason {msg['stop_reason']}")
    return {"text": text, "messages_wall_s": t_msg, "completions_wall_s": t_comp,
            "body": body, "prompt": prompt}


def front_door_checks(door: FrontDoor, app) -> dict:
    """401 without a key and with a bad one (audited), 200 by Bearer and by
    x-api-key, a third client flooding past its rate (429, audited),
    /health "healthy"."""
    st, out = door.call("/tokenize", {"content": "hi"}, headers={})
    check(st == 401 and out["error"]["type"] == "authentication_error", f"no key: {st} {out}")
    st, out = door.call("/tokenize", {"content": "hi"}, headers={"x-api-key": "sk-eve"})
    check(st == 401 and out["error"]["message"] == "invalid API key", f"bad key: {st} {out}")
    door.ok("/tokenize", {"content": "hi"}, headers={"Authorization": "Bearer sk-alice"})
    door.ok("/tokenize", {"content": "hi"}, headers={"x-api-key": "sk-bob"})
    codes = [door.call("/tokenize", {"content": "x"}, headers={"x-api-key": "sk-carol"})[0]
             for _ in range(FRONT_RPM + 11)]
    check(codes == [200] * (FRONT_RPM + 10) + [429], f"rate limit: {codes}")
    door.ok("/tokenize", {"content": "hi"})           # another client is not limited
    fails = [e["err"] for e in app.audit.query("auth_failure")]
    limited = [e["client"] for e in app.audit.query("rate_limited")]
    check(fails == ["missing API key", "invalid API key"] and limited == ["carol"],
          f"audit log: {fails} {limited}")
    health = door.ok("/health")
    check(health == {"status": "healthy"}, f"/health: {health}")
    return {"unauthorized": [401, 401], "rate_limited_after": FRONT_RPM + 10,
            "audit_failures": len(fails) + len(limited), "health": health["status"]}


def front_stream_and_tools(door: FrontDoor, eng, plain: dict) -> dict:
    """The greedy request streamed (the Messages API's events in order, the
    text deltas joined equal to the plain reply), a tools request with
    tool_choice any (a tool_use block whose input satisfies the schema,
    stop_reason tool_use), and count_tokens against /tokenize."""
    fresh(eng)
    raw = door.ok("/v1/messages", {**plain["body"], "stream": True})
    events = sse_events(raw)
    names = [e for e, _ in events]
    deltas = names[2:-3]
    check(names[:2] == ["message_start", "content_block_start"]
          and names[-3:] == ["content_block_stop", "message_delta", "message_stop"]
          and deltas and set(deltas) == {"content_block_delta"}
          and all(e == d["type"] for e, d in events), f"stream events {names}")
    text = "".join(d["delta"]["text"] for e, d in events if e == "content_block_delta")
    check(text == plain["text"], "streamed text_deltas differ from the plain reply")
    stop = events[-2][1]
    check(stop["delta"]["stop_reason"] == "max_tokens" and stop["usage"]["output_tokens"] == 64,
          f"message_delta {stop}")
    fresh(eng)
    t0 = time.perf_counter()
    tools = door.ok("/v1/messages", {"messages": [{"role": "user",
                                                   "content": "Pick a colour for the sky."}],
                                     "tools": [PICK_TOOL], "tool_choice": {"type": "any"},
                                     "max_tokens": 48, "temperature": 0})
    t_tools = time.perf_counter() - t0
    use = [b for b in tools["content"] if b["type"] == "tool_use"]
    check(tools["stop_reason"] == "tool_use" and len(use) == 1
          and use[0]["name"] == "tint" and use[0]["id"].startswith("toolu_")
          and use[0]["input"] in ({"c": "red"}, {"c": "green"}, {"c": "blue"}),
          f"tools: {str(tools)[:400]}")
    n = door.ok("/v1/messages/count_tokens", {"system": FRONT_SYSTEM, "messages": [
        {"role": "user", "content": [{"type": "text", "text": FRONT_USER}]}]})["input_tokens"]
    ids = door.ok("/tokenize", {"content": plain["prompt"], "add_special": True})["tokens"]
    check(n == len(ids), f"count_tokens {n} against /tokenize {len(ids)}")
    return {"stream_events": len(events), "tool_use": use[0]["input"],
            "tool_tokens": tools["usage"]["output_tokens"], "tool_wall_s": t_tools,
            "count_tokens": n}


def front_routes(door: FrontDoor, eng, tok) -> dict:
    """/v1/responses and /api/chat against the chat route's text for the
    same messages, /api/tags and /api/show, /infill against /v1/completions
    of the FIM ids (its short prompt through qmm), /embeddings 501."""
    msgs = [{"role": "system", "content": FRONT_SYSTEM},
            {"role": "user", "content": "Say hello."}]

    def greedy(path, body):
        fresh(eng)
        return door.ok(path, {**body, "temperature": 0})

    chat = greedy("/v1/chat/completions", {"messages": msgs, "max_tokens": 16})
    text = chat["choices"][0]["message"]["content"]
    resp = greedy("/v1/responses", {"input": msgs, "max_output_tokens": 16})
    r_text = "".join(c["text"] for o in resp["output"] if o["type"] == "message"
                     for c in o["content"])
    check(r_text == text and resp["usage"]["output_tokens"] == 16,
          f"/v1/responses {r_text!r} against the chat route's {text!r}")
    ollama = greedy("/api/chat", {"messages": msgs, "max_tokens": 16})
    check(ollama["choices"][0]["message"]["content"] == text, "/api/chat differs from the chat route")
    tags = door.ok("/api/tags")
    show = door.ok("/api/show", {"model": "llama-3-8b"})
    check(tags["models"][0]["name"] == "llama-3-8b" and show["details"]["family"] == "llama",
          f"/api/tags {tags} /api/show {show}")
    fim = [tok.vocab.token_to_id[p] for p in FIM_PIECES]
    prefix, suffix = "def add(a, b):", "\n"
    ids = [fim[0], *tok.encode(prefix, add_special=False), fim[1],
           *tok.encode(suffix, add_special=False), fim[2]]
    qmm0 = read_counts()["qmm"]
    infill = greedy("/infill", {"input_prefix": prefix, "input_suffix": suffix,
                                "max_tokens": 16})
    qmm_launches = read_counts()["qmm"] - qmm0
    direct = greedy("/v1/completions", {"prompt": ids, "max_tokens": 16})
    check(infill["choices"][0]["text"] == direct["choices"][0]["text"]
          and infill["usage"] == direct["usage"], "/infill differs from the FIM ids' completion")
    check(qmm_launches > 0, f"/infill's {len(ids)}-token prompt launched qmm {qmm_launches} times")
    st, out = door.call("/embeddings", {"input": "hi"})
    check(st == 501 and out["error"]["message"] == "no embedding model loaded",
          f"/embeddings: {st} {out}")
    return {"chat_text_equal": True, "infill_prompt_tokens": len(ids),
            "infill_qmm_launches": qmm_launches, "embeddings_status": st}


PROFILE_TOKENS = 24      # each request's tokens in the profile window (3 blocks)


def front_wave(door: FrontDoor, eng, prompts) -> dict:
    """The prompts over HTTP at once (greedy, PROFILE_TOKENS each) on
    erased slots; decode tok/s from the engine's counters."""
    fresh(eng)
    m0 = dict(eng.metrics)
    results: list = [None] * len(prompts)

    def send(i):
        results[i] = door.call("/v1/completions", {"prompt": prompts[i],
                                                   "max_tokens": PROFILE_TOKENS,
                                                   "temperature": 0})

    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    in_one_wave(eng, lambda: [t.start() for t in threads], len(prompts))
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(all(r is not None and r[0] == 200 for r in results), f"profile wave: {results}")
    n = eng.metrics["n_tokens_generated"] - m0["n_tokens_generated"]
    dec = eng.metrics["decode_s"] - m0["decode_s"]
    return {"tokens": n, "wall_s": wall, "decode_tok_s": n / dec}


def front_profile(door: FrontDoor, eng) -> dict:
    """/profile/start, 4 requests, /profile/stop: the trace names the
    engine's two spans and the qmv and fa kernels, launched from replayed
    graphs (every block and chunk of the window a replay, one
    cudaGraphLaunch a replay, and as many qmv and fa kernels in the trace
    as the replays' launch counts); decode tok/s inside the window and
    outside it."""
    import shutil
    import tempfile

    prompts = token_prompts(eng.hp.n_vocab, [32] * 4, SEED + 70)
    outside = front_wave(door, eng, prompts)
    tdir = tempfile.mkdtemp(prefix="front_door_trace_")
    try:
        st, _ = door.call("/profile/start", {"dir": tdir})
        check(st == 200, f"/profile/start: {st}")
        st2, _ = door.call("/profile/start", {"dir": tdir})
        stats0, counts0 = block_stats(eng), read_counts()
        inside = front_wave(door, eng, prompts)
        replays = check_replayed("profile window", stats0, block_stats(eng))
        launched = {k: n - counts0[k] for k, n in read_counts().items()}
        t0 = time.perf_counter()
        stop = door.ok("/profile/stop", {})
        t_stop = time.perf_counter() - t0
        st3, _ = door.call("/profile/stop", {})
        check(st2 == 409 and st3 == 409 and stop["dir"] == tdir,
              f"profile statuses {st2} {stop} {st3}")
        path = os.path.join(tdir, "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    names = [e.get("name", "") for e in events]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by = lambda s: sum(s in e.get("name", "") for e in kernels)
    found = {"engine.prefill": names.count("engine.prefill"),
             "engine.decode": names.count("engine.decode"),
             "qmv_kernel": by("qmv_kernel"), "fa_tc_kernel": by("fa_tc_kernel"),
             "cudaGraphLaunch": sum("cudaGraphLaunch" in n for n in names)}
    check(all(found.values()), f"the trace lacks a span or kernel: {found}")
    check(found["qmv_kernel"] == launched["qmv"] and found["fa_tc_kernel"] == launched["fa_tc"]
          and found["cudaGraphLaunch"] == replays["replays"] + replays["chunk_replays"],
          f"the trace's kernels {found} against the replays' launches {launched}, {replays}")
    return {"trace_bytes": size, "trace_events": len(events), "kernels_in_trace": len(kernels),
            "found": found, "window_launches": {k: n for k, n in launched.items() if n},
            "window_replays": replays,
            "stop_s": t_stop, "decode_tok_s_outside": outside["decode_tok_s"],
            "decode_tok_s_inside": inside["decode_tok_s"],
            "wave_wall_s_outside": outside["wall_s"], "wave_wall_s_inside": inside["wall_s"]}


def front_host_cost(app) -> dict:
    """Microseconds a call of each front-door step, over 1,000 calls: the
    key check, the rate check (a new client each call), the audit event and
    the JSONL metrics line (a file of its own)."""
    import tempfile

    from superllama_tpu_torch.server.metrics import JsonlMetricsLogger

    fd, path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    log = JsonlMetricsLogger(path)
    steps = {"auth": lambda i: app.auth(ALICE),
             "allow_request": lambda i: app.rate.allow_request(f"timing-{i}"),
             "audit.log": lambda i: app.audit.log("request", "alice", {"path": "/x"}),
             "jsonl.log": lambda i: log.log(app.engine)}
    out = {}
    for name, fn in steps.items():
        t0 = time.perf_counter()
        for i in range(1000):
            fn(i)
        out[name] = (time.perf_counter() - t0) * 1e3      # µs a call over 1,000 calls
    os.unlink(path)
    out["total"] = sum(out.values())
    return out


def front_router(torch, door_cls, gmodel) -> dict:
    """A ModelRouter on the card with the 8B and the 1B-width model: each
    answers a request routed by ``model``, an unknown model gets 404, no
    graph is captured after a model's warm-up, and unloading the 1B brings
    the allocated device memory back to within 64 MB of its value before
    the load."""
    import gc

    from superllama_tpu_torch.server.http import Server
    from superllama_tpu_torch.server.router import ModelRouter

    router = ModelRouter(n_slots=1, n_ctx=128, kv_dtype=torch.bfloat16, device="cuda",
                         api_keys=FRONT_KEYS)
    srv = Server(router, host="127.0.0.1", port=0)
    srv.start()
    try:
        door = door_cls(srv.port)
        t0 = time.perf_counter()
        router.load("llama-3-8b", gmodel)     # an in-memory model: no GGUF to name
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        router.load("llama-3.2-1b", build_draft(torch))
        torch.cuda.synchronize()
        mem_loaded = torch.cuda.memory_allocated()
        t_load = time.perf_counter() - t0
        caps = {name: graph_captures(router.app_for({"model": name}).engine)
                for name in ("llama-3-8b", "llama-3.2-1b")}
        prompt = token_prompts(gmodel.hparams.n_vocab, [24], SEED + 80)[0]
        models = door.ok("/v1/models")
        check([m["id"] for m in models["data"]] == ["llama-3-8b", "llama-3.2-1b"],
              f"router models {models}")
        for name in caps:
            out = door.ok("/v1/completions", {"model": name, "prompt": prompt,
                                              "max_tokens": 16, "temperature": 0})
            check(out["usage"]["completion_tokens"] == 16 and out["model"] == name,
                  f"router {name}: {out}")
            # (no local name for the app or its engine: it would keep the
            # model alive past its unload)
            check(graph_captures(router.app_for({"model": name}).engine) == caps[name],
                  f"router {name}: a graph was captured after the warm-up")
        st, out = door.call("/v1/completions", {"model": "llama-2", "prompt": prompt,
                                                "max_tokens": 2})
        check(st == 404 and out["error"]["type"] == "model_not_found", f"unknown model: {st} {out}")
        st, _ = door.call("/models/unload", {"model": "llama-3.2-1b"}, headers={})
        check(st == 401, f"/models/unload without a key: {st}")
        door.ok("/models/unload", {"model": "llama-3.2-1b"})
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        check(abs(mem_after - mem0) <= 64 << 20,
              f"unload left {(mem_after - mem0) / 2**20:.1f} MB of the 1B allocated")
        # what is left: torch's per-stream cuBLAS workspaces (the 1B engine's
        # threads and capture stream) stay cached until cleared
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        mem_cleared = torch.cuda.memory_allocated()
        return {"load_s": t_load, "mem_before_load": mem0, "mem_loaded": mem_loaded,
                "mem_after_unload": mem_after, "mem_after_cublas_clear": mem_cleared,
                "unload_returned_bytes": mem_loaded - mem_after,
                "left_after_unload_bytes": mem_after - mem0}
    finally:
        srv.stop()
        for name in [m["id"] for m in router.models()]:
            router.unload(name)
        del router, srv
        gc.collect()
        torch.cuda.empty_cache()


def phase_front_door(torch, model, smi_line: str) -> dict:
    """The server's front door on warmed-up servers of the synthetic 8B
    with a 128,256-piece tokenizer that carries FIM pieces
    (``grammar_tokenizer(control=FIM_PIECES)``):

     - bf16, 4 slots, three API keys, 30 requests a minute a client, a
       JSONL metrics file: 401 without a key and with a bad one, 200 by
       Bearer and by x-api-key, 429 for the client past its rate, the
       failures audited, /health "healthy"; /v1/messages greedy (64
       tokens) equal to /v1/completions of the rendered prompt, streamed
       (events in order, text deltas equal), tools with tool_choice any (a
       tool_use block within the schema), count_tokens equal to /tokenize;
       /v1/responses and /api/chat equal to the chat route; /api/tags,
       /api/show; /infill equal to the FIM ids' completion (through qmm);
       /embeddings 501; /profile around 4 requests (the trace names both
       engine spans and the qmv and fa kernels; tok/s inside and outside);
       one JSONL line per request past the front door; each step's host
       cost over 1,000 calls;
     - Q8_0 and paged servers of 2 slots: the greedy /v1/messages
       against /v1/completions;
     - a ModelRouter serving the 8B and the 1B-width model (build_draft),
       routed by ``model``, 404 for another, the 1B unloaded back to
       within 64 MB of the memory before its load;
     - every server: no graph captured after its warm-up; launches of qmv,
       qmm and fa's tensor-core kernel on bf16, fd on Q8_0, paged on the
       paged cache (the counts set to 0 before each server's requests and
       read after). Prints the seconds of each part."""
    import gc
    import tempfile

    from superllama_tpu_torch.server.http import Server, ServerApp

    t_phase = time.perf_counter()
    parts: dict = {}
    by_part: dict = {}
    mark = [time.perf_counter(), read_counts()]

    def part(name):
        """The seconds and the kernel launches since the last part ended."""
        now, counts = time.perf_counter(), read_counts()
        parts[name] = now - mark[0]
        by_part[name] = {k: n - mark[1][k] for k, n in counts.items() if n != mark[1][k]}
        mark[:] = [now, counts]

    def zero():
        """The counts set to 0 before a server's requests (read after)."""
        reset_counts()
        mark[1] = read_counts()

    tok = grammar_tokenizer(model.hparams.n_vocab, control=FIM_PIECES)
    gmodel = type(model)(**{**vars(model), "tokenizer": tok})
    tmp = tempfile.mkdtemp(prefix="front_door_")
    metrics_path = os.path.join(tmp, "metrics.jsonl")
    rec = {"phase": "front_door", "card": smi_line}
    part("tokenizer")
    app = ServerApp(gmodel, n_slots=4, n_ctx=256, kv_dtype=torch.bfloat16,
                    model_name="llama-3-8b", device="cuda", api_keys=FRONT_KEYS,
                    rate_limit_rpm=FRONT_RPM, metrics_path=metrics_path)
    srv = Server(app, host="127.0.0.1", port=0)
    srv.start()
    eng = app.engine
    rec["warmup_graphs"] = {"bf16": len(app.warmup_info["keys"])}
    part("bf16_warmup")
    try:
        door = FrontDoor(srv.port)
        caps0 = graph_captures(eng)
        zero()
        rec["front_door"] = front_door_checks(door, app)
        part("front_door")
        plain = front_messages(door, eng, "bf16")
        rec["messages_bf16"] = {k: plain[k] for k in ("messages_wall_s", "completions_wall_s")}
        rec["stream_tools"] = front_stream_and_tools(door, eng, plain)
        part("messages_bf16")
        rec["routes"] = front_routes(door, eng, tok)
        part("routes")
        rec["profile"] = front_profile(door, eng)
        part("profile")
        counts = read_counts()
        for name in ("qmv", "qmm", "fa_tc"):
            check(counts[name] > 0, f"the front door's bf16 server never launched {name}")
        check(counts["fa"] == 0, f"the bf16 server launched the CUDA-core fa {counts['fa']} times")
        check(graph_captures(eng) == caps0,
              f"bf16: graphs captured after the warm-up ({caps0} -> {graph_captures(eng)})")
        with open(metrics_path) as f:
            lines = [json.loads(ln) for ln in f]
        check(len(lines) == door.passed and {"slots_busy", "queue_depth"} <= set(lines[-1]),
              f"{len(lines)} JSONL lines for {door.passed} requests past the front door")
        bill = app.cost.bill("alice")
        check(bill["requests"] > 0 and app.cost.bill("anonymous")["requests"] == 0,
              f"billing: {bill}")
        rec["launches"] = {"bf16": counts}
        rec["jsonl_lines"] = len(lines)
        rec["host_cost_us"] = front_host_cost(app)
        part("host_cost")
    finally:
        srv.stop()
        del app, srv, eng
        gc.collect()
        torch.cuda.empty_cache()
    for label, kw, expect in FRONT_CACHES:
        app = ServerApp(gmodel, n_slots=2, n_ctx=256, model_name="llama-3-8b", device="cuda",
                        api_keys=FRONT_KEYS, **{"kv_dtype": torch.bfloat16, **kw})
        srv = Server(app, host="127.0.0.1", port=0)
        srv.start()
        eng = app.engine
        rec["warmup_graphs"][label] = len(app.warmup_info["keys"])
        part(f"{label}_warmup")
        try:
            caps0 = graph_captures(eng)
            zero()
            out = front_messages(FrontDoor(srv.port), eng, label)
            counts = read_counts()
            for name in expect:
                check(counts[name] + counts.get(name + "_tc", 0) > 0,
                      f"the {label} server never launched {name}")
            check(graph_captures(eng) == caps0, f"{label}: graphs captured after the warm-up")
            rec[f"messages_{label}"] = {k: out[k] for k in ("messages_wall_s",
                                                             "completions_wall_s")}
            rec["launches"][label] = counts
        finally:
            srv.stop()
            del app, srv, eng
            gc.collect()
            torch.cuda.empty_cache()
        part(f"messages_{label}")
    try:
        rec["router"] = front_router(torch, FrontDoor, gmodel)
    except BaseException:
        emit({**rec, "seconds_by_part": parts, "failed_in": "router"})   # what was read
        raise
    part("router")
    os.unlink(metrics_path)
    os.rmdir(tmp)
    rec["seconds_by_part"] = parts
    rec["launches_by_part"] = by_part
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the chip smoke runs on a GPU", file=sys.stderr)
        return 2
    try:
        import superllama_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: superllama_tpu_torch not importable ({e}); run from "
              f"the repo root", file=sys.stderr)
        return 2
    info = phase_device(torch)
    phase_build()
    if "--kernel-times" in sys.argv[1:]:
        # the timed kernel rows and the lone chunk's profile alone, for
        # comparing two trees in one call
        kernels = kernel_times(torch)
        emit({"phase": "kernel_times", "card": info["nvidia_smi"], "kernels": kernels,
              "qmm_per_chunk": qmm_chunk(kernels)})
        model = build_model(torch)
        profile_chunks(torch, model)
        return 0
    if "--fa-times" in sys.argv[1:]:
        # fa's rows of phase 6 alone, for comparing versions of its kernels
        emit({"phase": "fa_times", "card": info["nvidia_smi"], "kernels": time_fa(torch)})
        return 0
    if "--qmv-times" in sys.argv[1:]:
        # qmv's rows of phase 6 and a bf16 decode block's profile, for
        # comparing versions of its kernel
        emit({"phase": "qmv_times", "card": info["nvidia_smi"], "kernels": time_qmv(torch)})
        emit({"phase": "profile", "what": "one engine step = 8 greedy decode steps, 8 rows",
              **profile_block(torch, build_model(torch), "bf16")})
        return 0
    if "--paged-times" in sys.argv[1:]:
        # paged's rows of phase 6 alone (decode and four prefill shapes)
        emit({"phase": "paged_times", "card": info["nvidia_smi"], "kernels": time_paged(torch)})
        return 0
    if "--prefill" in sys.argv[1:]:
        # the prompt path's phases alone, for comparing two trees in one
        # call (an unpacked parent tree lacks the warm-up and the row view:
        # it reads only the TTFTs and the lone prompts' profiles)
        phase_prefill(torch, build_model(torch), info["nvidia_smi"])
        return 0
    if "--graphs" in sys.argv[1:]:
        # the decode blocks' graphs alone: graph against eager blocks on
        # each cache, DecodeLoop, and the bf16 serving waves
        phase_graph_vs_eager(torch, build_model(torch, n_layer=GRAPH_LAYERS))
        phase_decode_loop(torch, build_model(torch, n_layer=CUT_LAYERS))
        phase_serving(torch, build_model(torch))
        return 0
    if "--checks" in sys.argv[1:]:
        # the kernels against their plain versions alone
        phase_kernels(torch)
        return 0
    if "--formats" in sys.argv[1:]:
        # the weight formats on the serving path alone (phase 4i; their
        # kernel checks run with --checks)
        phase_mixes(torch, info["nvidia_smi"])
        phase_gguf_file(torch, info["nvidia_smi"])
        return 0
    if "--format-times" in sys.argv[1:]:
        # each new format's qmv and qmm readings beside the three redesigned
        # formats' at the same shapes (an argument after the flag names the
        # formats, comma-separated: those alone)
        i = sys.argv.index("--format-times") + 1
        named = i < len(sys.argv) and not sys.argv[i].startswith("--")
        names = tuple(sys.argv[i].split(",")) if named else NEW_FORMATS
        emit({"phase": "format_times", "card": info["nvidia_smi"],
              "kernels": {**time_base_formats(torch), **time_formats(torch, names)}})
        if not named:   # qmm of a format of each layout at every served shape
            emit({"phase": "qmm_shape_times", "card": info["nvidia_smi"],
                  "kernels": time_qmm_shapes(torch)})
        return 0
    if "--qmv-clusters" in sys.argv[1:]:
        # the planned clusters of qmv's formats against none, at the served
        # shapes (with --sweep, against every grid, Q8_0 / Q4_K / Q6_K too)
        sweep = "--sweep" in sys.argv[1:]
        names = ("Q8_0", "Q4_K", "Q6_K") + SHAPE_FORMATS if sweep else SHAPE_FORMATS
        emit({"phase": "qmv_clusters", "card": info["nvidia_smi"],
              "rows": time_qmv_clusters(torch, names, sweep)})
        return 0
    if "--qmm-plans" in sys.argv[1:]:
        # qmm's plan against every power-of-two k-tiles-a-split grid, at the
        # served shapes (an argument after the flag names the formats)
        i = sys.argv.index("--qmm-plans") + 1
        names = (tuple(sys.argv[i].split(",")) if i < len(sys.argv)
                 and not sys.argv[i].startswith("--") else QMM_SHAPE_FORMATS)
        emit({"phase": "qmm_plans", "card": info["nvidia_smi"],
              "rows": time_qmm_plans(torch, names)})
        return 0
    if "--base-times" in sys.argv[1:]:
        # the redesigned formats' rows alone (also for a parent tree)
        emit({"phase": "base_times", "card": info["nvidia_smi"],
              "kernels": time_base_formats(torch)})
        return 0
    if "--toolchain" in sys.argv[1:]:
        # the model-file toolchain alone (phase 4j)
        phase_toolchain(torch, info["nvidia_smi"])
        return 0
    if "--archs" in sys.argv[1:]:
        # the dense architecture registry alone (phase 4k)
        phase_archs(torch, info["nvidia_smi"])
        return 0
    if "--moe" in sys.argv[1:]:
        # the sparse mixtures of experts alone (phase 4l)
        phase_moe(torch, info["nvidia_smi"])
        return 0
    if "--mla" in sys.argv[1:]:
        # DeepSeek-V2-Lite's MLA and Llama-4-Scout's chunked attention alone
        # (phase 4m)
        phase_mla(torch, info["nvidia_smi"])
        return 0
    if "--ssm" in sys.argv[1:]:
        # the state-space models alone (phase 4n)
        phase_ssm(torch, info["nvidia_smi"])
        return 0
    if "--linear" in sys.argv[1:]:
        # linear attention and short convs alone (phase 4o)
        phase_linear(torch, info["nvidia_smi"])
        return 0
    if "--encoders" in sys.argv[1:]:
        # encoders, T5, diffusion LMs and TTS alone (phase 4p)
        phase_item5(torch, info["nvidia_smi"])
        return 0
    if "--state" in sys.argv[1:]:
        # the engine's state between requests alone (phase 4e)
        phase_state(torch, build_model(torch, n_layer=CUT_LAYERS), info["nvidia_smi"])
        return 0
    if "--grammar" in sys.argv[1:]:
        # structured output alone (phase 4f)
        phase_grammar(torch, build_model(torch, n_layer=CUT_LAYERS), info["nvidia_smi"])
        return 0
    if "--spec" in sys.argv[1:]:
        # the decode variants alone (phase 4g)
        phase_spec(torch, build_model(torch, n_layer=CUT_LAYERS), info["nvidia_smi"])
        return 0
    if "--server" in sys.argv[1:]:
        # the server's front door alone (phase 4h)
        phase_front_door(torch, build_model(torch, n_layer=CUT_LAYERS), info["nvidia_smi"])
        return 0
    checks = phase_kernels(torch)
    model = build_model(torch)
    # each kernel's launches come from the serving run of its own path
    counts = phase_serving(torch, model)
    counts["fd"] = phase_serving_q8(torch, model)["fd"]
    paged_counts = phase_serving_paged(torch, model)
    counts["paged"], counts["paged_tc"] = paged_counts["paged"], paged_counts["paged_tc"]
    counts["fa"] = phase_serving_f32(torch, model)["fa"]
    # graph against eager, DecodeLoop, the warm-up, the engine's state,
    # grammars, the decode variants and the profiles at a cut depth (their
    # checks do not depend on it; eager runs, warm-ups and host steps take
    # most of their time)
    phase_graph_vs_eager(torch, build_model(torch, n_layer=GRAPH_LAYERS))
    cut = build_model(torch, n_layer=CUT_LAYERS)
    phase_decode_loop(torch, cut)
    phase_warmup(torch, cut)
    phase_state(torch, cut, info["nvidia_smi"])
    phase_grammar(torch, cut, info["nvidia_smi"])
    phase_spec(torch, cut, info["nvidia_smi"])
    phase_front_door(torch, cut, info["nvidia_smi"])
    # the new formats' kernels launch on the serving mixes' path
    counts.update(phase_mixes(torch, info["nvidia_smi"]))
    phase_gguf_file(torch, info["nvidia_smi"])
    phase_toolchain(torch, info["nvidia_smi"])
    phase_archs(torch, info["nvidia_smi"])
    # gmm's checks, times and launches come from the MoE phase
    moe = phase_moe(torch, info["nvidia_smi"])
    checks += moe["checks"]
    counts["gmm"] = moe["launches"]
    phase_mla(torch, info["nvidia_smi"])
    # ssm_scan's checks, times and launches come from the SSM phase
    ssm = phase_ssm(torch, info["nvidia_smi"])
    checks += ssm["checks"]
    counts["ssm_scan"] = ssm["launches"]
    # wkv's checks, times and launches come from the linear-attention phase
    lin = phase_linear(torch, info["nvidia_smi"])
    checks += lin["checks"]
    counts.update(lin["launches"])
    # encoders, T5, diffusion LMs and TTS: their paths' qmv, qmm, fa and gmm
    # launches are read in the phase's own lines
    phase_item5(torch, info["nvidia_smi"])
    phase_parity(torch, model)
    phase_cache_parity(torch, model)
    phase_chunk_parity(torch, model)
    times = phase_times(torch, model, info["nvidia_smi"])
    phase_profile(torch, cut)
    # the probe kernels' launches come from the tools' path
    tool_counts = phase_tools(torch, model)
    counts.update({name: n for name, n in tool_counts.items() if name.startswith("qmv_probe")})
    times.update(time_probe(torch, info["nvidia_smi"]))
    times.update(time_formats(torch, tuple(FAMILY_FORMAT.values()), m1=False))
    times.update(moe["times"])
    times.update(ssm["times"])
    times.update(lin["times"])
    record = []
    for name, source, replaces, timing in KERNELS:
        t = times[timing]
        record.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in checks if c["kernel"] == name),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(info["nvidia_smi"])
    emit({"kernels": record})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
