"""Command-line entry points of the port, with the flag names of the JAX
package's CLI:

  run            generate text from a prompt (llama-cli)
  serve          the HTTP server: OpenAI, Anthropic and Ollama APIs (llama-server)
  llama-bench    the pp/tg perf matrix
  batched-bench  decode scaling with the batch
  tokenize       a prompt's token ids and pieces (llama-tokenize)
  gguf-dump      a GGUF's metadata and tensor table
  encrypt-model  AES-256-GCM encrypt or decrypt a GGUF (SLT_MODEL_KEY loads it)
  quantize       re-quantize a GGUF (llama-quantize), optionally with an imatrix
  imatrix        collect an importance matrix over a calibration text
  perplexity     perplexity, or hellaswag / winogrande / multiple-choice scores
  cvector-generator  a control vector from positive and negative prompts
  diffusion      diffusion-LM generation by iterative demasking (LLaDA, Dream, RND1)
  tts            text to speech: an OuteTTS voice LM and a WavTokenizer decoder

Usage:  python -m superllama_tpu_torch <command> [options]

``run`` and ``serve`` take the option table of ``args.py`` (the JAX
package's, each option with its LLAMA_ARG_* environment mirror: flag > env
> default); ``--control-vector FILE[:SCALE]`` (repeatable) adds each
vector, scaled, to the residual stream after every layer; ``serve
--embed-model FILE`` loads an encoder (dense, as the JAX CLI loads it) for
``/embeddings`` and ``/rerank``. A flag of a feature the port does not have
yet (``UNPORTED``) makes them (and ``perplexity`` and ``diffusion``) exit
with code 2; flags the JAX CLI
accepts and ignores are accepted and ignored. All run on the GPU unless
``--device cpu`` is given (``quantize`` runs on the host).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

_KV_DTYPES = ("bfloat16", "float32", "q8_0", "q4_0")
# dest -> flag of the options whose feature is not ported yet
UNPORTED = {"lora": "--lora", "mmproj": "--mmproj",
            "hf_repo": "-hf/--hf-repo", "model_url": "-mu/--model-url"}


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-m", "--model", required=True, help="GGUF model path")
    p.add_argument("-c", "--ctx-size", type=int, default=2048, help="context window size")
    p.add_argument("--keep-quantized", action="store_true",
                   help="keep repackable weights packed for the quantized kernels")
    p.add_argument("--kv-dtype", default="bfloat16", choices=_KV_DTYPES,
                   help="KV cache dtype")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def _add_adapter_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's adapter flags of its model commands (``UNPORTED``)."""
    p.add_argument("--lora", action="append", metavar="FILE[:SCALE]",
                   help="apply a LoRA adapter (repeatable; not ported yet)")
    p.add_argument("--control-vector", action="append", metavar="FILE[:SCALE]",
                   help="apply a control vector (repeatable; run and serve)")


def _file_scale(spec: str) -> tuple[str, float]:
    """``FILE[:SCALE]`` → (file, scale), scale 1.0 when none parses."""
    if ":" in spec and not spec.rsplit(":", 1)[0].endswith(("/", "\\")):
        path, s = spec.rsplit(":", 1)
        try:
            return path, float(s)
        except ValueError:
            pass
    return spec, 1.0


def _unported(args) -> bool:
    """Print and return True when a flag of ``UNPORTED`` is set (by flag or
    environment)."""
    given = [flag for dest, flag in UNPORTED.items() if getattr(args, dest, None)]
    if given:
        print(f"error: {', '.join(given)}: not ported yet", file=sys.stderr)
    return bool(given)


def api_keys_from(specs) -> dict[str, str]:
    """``--api-key NAME=KEY`` (repeatable), or a bare KEY (client
    "default", as ``LLAMA_API_KEY`` holds one), as ``{key: client}``."""
    out = {}
    for spec in specs or []:
        name, sep, key = spec.partition("=")
        out[key if sep else name] = name if sep else "default"
    return out


def _load(args):
    import torch

    from .models import load_model

    if not getattr(args, "model", None):
        print("error: -m/--model is required (or set LLAMA_ARG_MODEL)", file=sys.stderr)
        raise SystemExit(2)
    t0 = time.perf_counter()
    model = load_model(args.model, keep_quantized=args.keep_quantized,
                       device=args.device)
    for spec in getattr(args, "control_vector", None) or []:
        from .models.cvector import load_control_vector

        path, scale = _file_scale(spec)
        cv = load_control_vector(path, model.hparams.n_layer, model.hparams.n_embd, scale,
                                 device=args.device)
        prev = model.params.get("cvec")
        model.params["cvec"] = cv if prev is None else prev + cv
        print(f"applied control vector {path} x{scale}", file=sys.stderr)
    print(f"loaded {args.model} [{model.hparams.arch}] on {args.device} "
          f"in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    kvd = args.kv_dtype
    return model, getattr(torch, kvd) if kvd in ("bfloat16", "float32") else kvd


def _grammar(args) -> str | None:
    """The run's GBNF: ``--grammar``, replaced by ``--grammar-file``'s text,
    replaced by ``--json-schema`` converted."""
    grammar = args.grammar
    if args.grammar_file:
        with open(args.grammar_file) as f:
            grammar = f.read()
    if args.json_schema:
        from .grammar import json_schema_to_gbnf

        grammar = json_schema_to_gbnf(json.loads(args.json_schema))
    return grammar


def cmd_run(args) -> int:
    """Greedy, not streamed and without a grammar, on a dense model:
    ``DecodeLoop`` (prefill + captured decode steps), as the JAX CLI routes
    it; otherwise the engine (always for a recurrent or hybrid model: the
    JAX ``DecodeLoop`` builds a flat KV cache whatever the model, and its
    padded prefill would advance a recurrent state), which applies the grammar and the sampler chain of the
    sampling flags (``--preset`` merged under them). ``--profile-dir``
    writes a torch.profiler trace of the run there."""
    from .args import sampling_from_args
    from .runtime.cache_policy import cache_kind
    from .runtime.decode_loop import DecodeLoop
    from .runtime.engine import Engine, GenRequest

    if _unported(args):
        return 2
    if args.profile_dir:
        from .utils import profiler

        trace_dir, args.profile_dir = args.profile_dir, None
        with profiler.device_trace(trace_dir, cuda=str(args.device).startswith("cuda")):
            rc = cmd_run(args)
        print(f"[trace written to {trace_dir}/{profiler.TRACE_FILE}]", file=sys.stderr)
        return rc
    if args.preset:
        from .presets import apply_preset, load_preset

        merged = apply_preset({"temp": args.temp, "top_k": args.top_k, "top_p": args.top_p},
                              load_preset(args.preset))
        args.temp, args.top_k, args.top_p = merged["temp"], merged["top_k"], merged["top_p"]
    grammar = _grammar(args)
    model, kvd = _load(args)
    tok = model.tokenizer
    if tok is None:
        print("error: the model has no tokenizer", file=sys.stderr)
        return 2
    ids = tok.encode(args.prompt, add_special=True, parse_special=True)
    if (args.temp <= 0 and not args.stream and grammar is None
            and cache_kind(model.hparams) == "dense"):
        loop = DecodeLoop(model, n_ctx=args.ctx_size, kv_dtype=kvd, temp=0.0,
                          device=args.device)
        t0 = time.perf_counter()
        gen = loop.generate(ids, args.n_predict, seed=args.seed)[len(ids):]
        dt = time.perf_counter() - t0
        print(tok.decode(gen))
        print(f"[{len(gen)} tokens, {len(gen) / max(dt, 1e-9):.1f} tok/s with the prefill]",
              file=sys.stderr)
        return 0
    sampling = {"greedy": True} if args.temp <= 0 else sampling_from_args(args)
    eng = Engine(model, n_slots=1, n_ctx=args.ctx_size, kv_dtype=kvd,
                 device=args.device)
    req = GenRequest(
        prompt_ids=ids, max_tokens=args.n_predict, sampling=sampling, grammar=grammar,
        stop_eog=not args.ignore_eos,
        stream=(lambda t, piece: print(piece, end="", flush=True))
        if args.stream else None)
    eng.submit(req)
    eng.run_until_drained()
    res = req.result()
    print() if args.stream else print(res["text"])
    print(f"[{res['n_generated']} tokens, ttft {res['ttft_s'] * 1e3:.0f} ms, "
          f"{res['n_generated'] / max(res['total_s'] - res['ttft_s'], 1e-9):.1f} tok/s]",
          file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """The HTTP server; ``--api-key``, ``--rate-limit``, ``--metrics-file``
    and ``--ssl-cert-file`` / ``--ssl-key-file`` set its front door."""
    from .server.http import Server, ServerApp

    if _unported(args):
        return 2
    from .models import load_model

    model, kvd = _load(args)
    draft = None
    if args.draft_model:
        draft = load_model(args.draft_model, keep_quantized=args.keep_quantized,
                           device=args.device)
    embed = load_model(args.embed_model, device=args.device) if args.embed_model else None
    # -np/--slots/--parallel: the table names it by its longest flag
    app = ServerApp(model, n_slots=args.parallel, n_ctx=args.ctx_size, kv_dtype=kvd,
                    device=args.device, paged=args.paged_kv,
                    page_size=args.kv_page_size, n_pages=args.kv_pages,
                    warmup=not args.no_warmup, draft_model=draft, n_draft=args.draft_n,
                    api_keys=api_keys_from(args.api_key) or None,
                    rate_limit_rpm=args.rate_limit, metrics_path=args.metrics_file,
                    embed_model=embed)
    tls = ({"tls_cert": args.ssl_cert_file, "tls_key": args.ssl_key_file}
           if args.ssl_cert_file else {})
    srv = Server(app, host=args.host, port=args.port, **tls)
    srv.start()
    if app.warmup_info is not None:
        w = app.warmup_info
        print(f"warmup: {len(w['keys'])} graphs captured in {w['seconds']:.1f} s, "
              f"graph pool {w['pool_bytes'] / 2**20:.0f} MiB", file=sys.stderr)
    scheme = "https" if tls else "http"
    print(f"listening on {scheme}://{args.host}:{srv.port}", file=sys.stderr)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def cmd_llama_bench(args) -> int:
    """Perf matrix (tools/llama-bench counterpart)."""
    from .tools.llama_bench import FORMATTERS, run_bench

    model, kvd = _load(args)
    res = run_bench(
        model,
        pp=[int(x) for x in args.n_prompt.split(",") if int(x) > 0],
        tg=[int(x) for x in args.n_gen.split(",") if int(x) > 0],
        depths=[int(x) for x in args.depth.split(",")],
        reps=args.reps, n_ctx=args.ctx_size, kv_dtype=kvd)
    print(FORMATTERS[args.output](res))
    return 0


def cmd_batched_bench(args) -> int:
    """Batched decode scaling (tools/batched-bench counterpart)."""
    import json

    from .tools.batched_bench import format_table, run_batched_bench

    model, kvd = _load(args)
    rows = run_batched_bench(model, [(args.pp, args.tg, b) for b in args.batch],
                             kv_dtype=kvd)
    print(format_table(rows))
    print(json.dumps([r.as_dict() for r in rows]))
    return 0


def cmd_tokenize(args) -> int:
    """Each token id of the text and its piece, as the JAX CLI prints them."""
    from .models.loader import load_tokenizer

    tok = load_tokenizer(args.model)
    if tok is None:
        print("error: the model has no tokenizer", file=sys.stderr)
        return 2
    for t in tok.encode(args.text, add_special=True, parse_special=True):
        print(f"{t:>8} -> {tok.token_to_piece(t)!r}")
    return 0


def cmd_gguf_dump(args) -> int:
    from .tools.gguf_dump import dump

    print(dump(args.model, show_tensors=not args.no_tensors))
    return 0


def cmd_encrypt(args) -> int:
    from .server.security import ModelEncryptor

    enc = ModelEncryptor(args.key)
    if args.decrypt:
        enc.decrypt_file(args.input, args.output)
    else:
        enc.encrypt_file(args.input, args.output)
    print(f"{'decrypted' if args.decrypt else 'encrypted'} -> {args.output}")
    return 0


def cmd_quantize(args) -> int:
    """Re-quantize a GGUF to a file type (tools/quantize counterpart); runs
    on the host."""
    from .tools.imatrix import load_imatrix
    from .tools.quantize import quantize_model

    imx = load_imatrix(args.imatrix) if args.imatrix else None
    t0 = time.perf_counter()
    stats = quantize_model(args.input, args.output, args.ftype, imatrix=imx,
                           progress=(lambda name, t: print(f"  {name}: {t}", file=sys.stderr))
                           if args.verbose else None)
    print(f"quantized {args.input} -> {args.output} ({args.ftype}) in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    print(json.dumps(stats))
    return 0


def cmd_imatrix(args) -> int:
    """Collect an importance matrix over ``ctx_size``-token chunks of a
    calibration text (tools/imatrix counterpart)."""
    from .models import load_model
    from .tools.imatrix import collect_imatrix, save_imatrix

    model = load_model(args.model, device=args.device)
    with open(args.file) as f:
        ids = model.tokenizer.encode(f.read(), add_special=True)
    n = args.ctx_size
    batches = [ids[i:i + n] for i in range(0, len(ids) - n + 1, n)][: args.chunks]
    imx = collect_imatrix(model, batches, n_ctx=n, device=args.device)
    save_imatrix(args.output, imx, arch=model.hparams.arch)
    print(f"wrote {args.output} ({len(imx)} tensors, {len(batches)} chunks)")
    return 0


def cmd_perplexity(args) -> int:
    """Perplexity of a text file, or the accuracy of hellaswag, winogrande or
    multiple-choice tasks (tools/perplexity counterpart)."""
    from .models import load_model
    from .tools.perplexity import (compute_perplexity, score_hellaswag,
                                   score_multiple_choice, score_winogrande)

    if _unported(args):
        return 2
    model = load_model(args.model, keep_quantized=args.keep_quantized, device=args.device)
    with open(args.file) as f:
        text = f.read()
    scorer = (score_hellaswag if args.hellaswag else score_winogrande if args.winogrande
              else score_multiple_choice if args.multiple_choice else None)
    if scorer is None:
        ids = model.tokenizer.encode(text, add_special=False)
        if args.chunks:
            ids = ids[: args.chunks * args.ctx_size]
        print(compute_perplexity(model, ids, n_ctx=args.ctx_size, device=args.device))
        return 0
    res = scorer(model, text, args.tasks or None, args.ctx_size, device=args.device)
    print(f"{res['task']}: acc = {100.0 * res['acc']:.4f}% over {res['n']} tasks")
    return 0


def cmd_cvector_generator(args) -> int:
    """PCA steering directions from positive and negative prompt files, one
    prompt a line (tools/cvector-generator counterpart)."""
    from .models import load_model
    from .models.cvector import generate_control_vector, save_control_vector

    model = load_model(args.model, device=args.device)
    with open(args.positive_file) as f:
        pos = [line for line in f.read().splitlines() if line.strip()]
    with open(args.negative_file) as f:
        neg = [line for line in f.read().splitlines() if line.strip()]
    n = min(len(pos), len(neg))
    dirs = generate_control_vector(model, pos[:n], neg[:n])
    save_control_vector(args.output, dirs)
    print(f"wrote {args.output} ({dirs.shape[0]} layers)", file=sys.stderr)
    return 0


def cmd_diffusion(args) -> int:
    """Diffusion-LM demasking generation (examples/diffusion counterpart):
    the mask token from ``--mask-token-id`` or the vocab's, Dream's shifted
    logits."""
    from .models.registry import get_forward
    from .runtime.diffusion import DiffusionParams, diffusion_generate

    if _unported(args):
        return 2
    model, _ = _load(args)
    tok = model.tokenizer
    ids = tok.encode(args.prompt, add_special=True, parse_special=True)
    mask_id = args.mask_token_id
    if mask_id < 0:
        mask_id = int(model.metadata.get("tokenizer.ggml.mask_token_id", -1))
    if mask_id < 0:
        print("error: no mask token (set --mask-token-id)", file=sys.stderr)
        return 1
    dp = DiffusionParams(
        steps=args.steps, max_length=args.max_length, mask_token_id=mask_id,
        algorithm=args.algorithm, schedule=args.schedule, temperature=args.temp,
        top_k=args.top_k, top_p=args.top_p, block_length=args.block_length,
        cfg_scale=args.cfg_scale, shift_logits=(model.hparams.arch == "dream"), seed=args.seed)
    out = diffusion_generate(get_forward(model.hparams.arch), model.params, model.hparams, ids,
                             dp, step_callback=(lambda s, n, t: print(
                                 f"\rstep {s}/{n}", end="", file=sys.stderr))
                             if args.progress else None)
    if args.progress:
        print(file=sys.stderr)
    print(tok.decode(out[len(ids):]))
    return 0


def cmd_tts(args) -> int:
    """OuteTTS text to speech (tools/tts counterpart): both models dense."""
    from .models import load_model
    from .tools.tts import SAMPLE_RATE, save_wav, tts_generate

    ttc = load_model(args.model, device=args.device)
    cts = load_model(args.model_vocoder, device=args.device)
    audio = tts_generate(ttc, cts, args.prompt, n_predict=args.n_predict)
    if audio.size == 0:
        print("error: no audio codes generated", file=sys.stderr)
        return 1
    save_wav(args.output, audio)
    print(f"wrote {args.output} ({audio.size} samples, {audio.size / SAMPLE_RATE:.2f}s)",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    from .args import add_options

    ap = argparse.ArgumentParser(prog="superllama_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="generate text")
    add_options(p, "run")
    p.add_argument("-p", "--prompt", required=True)
    p.add_argument("--stream", action="store_true")
    p.add_argument("--profile-dir", help="write a torch.profiler trace of the run "
                   "(trace.json, Chrome trace format) into this directory")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("diffusion", help="diffusion-LM generation (LLaDA/Dream)")
    _add_model_args(p)
    _add_adapter_args(p)
    p.add_argument("-p", "--prompt", required=True)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--max-length", type=int, default=128)
    p.add_argument("--mask-token-id", type=int, default=-1)
    p.add_argument("--algorithm", default="confidence",
                   choices=["confidence", "entropy", "margin", "random", "origin"])
    p.add_argument("--schedule", default="timestep", choices=["timestep", "block"])
    p.add_argument("--block-length", type=int, default=32)
    p.add_argument("--cfg-scale", type=float, default=0.0)
    p.add_argument("--temp", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--progress", action="store_true")
    p.set_defaults(fn=cmd_diffusion)

    p = sub.add_parser("serve", help="HTTP server")
    add_options(p, "serve")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("llama-bench", help="perf matrix (pp/tg × depth × reps)")
    _add_model_args(p)
    p.add_argument("-p", "--n-prompt", default="512", help="prompt lengths, comma-separated")
    p.add_argument("-n", "--n-gen", default="128", help="decode lengths, comma-separated")
    p.add_argument("-d", "--depth", default="0", help="context depths, comma-separated")
    p.add_argument("-r", "--reps", type=int, default=3, help="timed repetitions")
    p.add_argument("-o", "--output", default="md", choices=["md", "json", "jsonl", "csv"])
    p.set_defaults(fn=cmd_llama_bench)

    p = sub.add_parser("batched-bench", help="batched decode scaling bench")
    _add_model_args(p)
    p.add_argument("--pp", type=int, default=512, help="prompt tokens per sequence")
    p.add_argument("--tg", type=int, default=32, help="generated tokens per sequence")
    p.add_argument("--batch", type=int, nargs="+", default=[1, 4, 8],
                   help="parallel sequences, one row each")
    p.set_defaults(fn=cmd_batched_bench)

    p = sub.add_parser("tokenize", help="tokenizer inspection")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("text")
    p.set_defaults(fn=cmd_tokenize)

    p = sub.add_parser("gguf-dump", help="inspect GGUF metadata + tensors")
    p.add_argument("model")
    p.add_argument("--no-tensors", action="store_true")
    p.set_defaults(fn=cmd_gguf_dump)

    p = sub.add_parser("encrypt-model", help="AES-256-GCM encrypt/decrypt a GGUF")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--key", required=True, help="32-byte hex key or passphrase")
    p.add_argument("--decrypt", action="store_true")
    p.set_defaults(fn=cmd_encrypt)

    p = sub.add_parser("quantize", help="re-quantize a GGUF")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("ftype", nargs="?", default="Q4_K_M")
    p.add_argument("--imatrix", default=None, help="an imatrix GGUF (from `imatrix`)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser("imatrix", help="collect importance matrix")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-f", "--file", required=True, help="calibration text")
    p.add_argument("-o", "--output", default="imatrix.gguf")
    p.add_argument("-c", "--ctx-size", type=int, default=512)
    p.add_argument("--chunks", type=int, default=32)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(fn=cmd_imatrix)

    p = sub.add_parser("cvector-generator",
                       help="generate a control vector from +/- prompts")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--positive-file", required=True)
    p.add_argument("--negative-file", required=True)
    p.add_argument("-o", "--output", default="control_vector.gguf")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(fn=cmd_cvector_generator)

    p = sub.add_parser("perplexity", help="perplexity over a text file")
    _add_model_args(p)
    _add_adapter_args(p)
    p.add_argument("-f", "--file", required=True)
    p.add_argument("--chunks", type=int, default=0)
    p.add_argument("--hellaswag", action="store_true",
                   help="score 6-line hellaswag tasks (acc_norm)")
    p.add_argument("--winogrande", action="store_true",
                   help="score winogrande CSV tasks")
    p.add_argument("--multiple-choice", action="store_true",
                   help="score JSONL multiple-choice tasks (MMLU-style)")
    p.add_argument("--tasks", type=int, default=0, help="max tasks to score")
    p.set_defaults(fn=cmd_perplexity)

    p = sub.add_parser("tts", help="text-to-speech (OuteTTS + WavTokenizer)")
    p.add_argument("-m", "--model", required=True, help="voice LM GGUF")
    p.add_argument("-mv", "--model-vocoder", required=True, help="WavTokenizer decoder GGUF")
    p.add_argument("-p", "--prompt", required=True)
    p.add_argument("-o", "--output", default="output.wav")
    p.add_argument("-n", "--n-predict", type=int, default=1024)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(fn=cmd_tts)

    args = ap.parse_args(argv)
    return args.fn(args)
