"""Command-line entry points of the port: ``run`` (generate text from a
prompt), ``serve`` (the OpenAI-compatible HTTP server), ``llama-bench``
(the pp/tg perf matrix) and ``batched-bench`` (decode scaling with the
batch), with the flag names of the JAX package's CLI for what exists.

Usage:  python -m superllama_tpu_torch <run|serve|llama-bench|batched-bench> -m model.gguf [options]

All run on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

_KV_DTYPES = ("bfloat16", "float32", "q8_0", "q4_0")


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-m", "--model", required=True, help="GGUF model path")
    p.add_argument("-c", "--ctx-size", type=int, default=2048, help="context window size")
    p.add_argument("--keep-quantized", action="store_true",
                   help="keep Q8_0/Q4_K/Q6_K weights packed for the quantized kernels")
    p.add_argument("--kv-dtype", default="bfloat16", choices=_KV_DTYPES,
                   help="KV cache dtype")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def _load(args):
    import torch

    from .models import load_model

    t0 = time.perf_counter()
    model = load_model(args.model, keep_quantized=args.keep_quantized,
                       device=args.device)
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
    """Greedy, not streamed and without a grammar: ``DecodeLoop`` (prefill
    + captured decode steps), as the JAX CLI routes it; otherwise the
    engine, which applies the grammar."""
    from .runtime.decode_loop import DecodeLoop
    from .runtime.engine import Engine, GenRequest

    grammar = _grammar(args)
    model, kvd = _load(args)
    tok = model.tokenizer
    if tok is None:
        print("error: the model has no tokenizer", file=sys.stderr)
        return 2
    ids = tok.encode(args.prompt, add_special=True, parse_special=True)
    if args.temp <= 0 and not args.stream and grammar is None:
        loop = DecodeLoop(model, n_ctx=args.ctx_size, kv_dtype=kvd, temp=0.0,
                          device=args.device)
        t0 = time.perf_counter()
        gen = loop.generate(ids, args.n_predict, seed=args.seed)[len(ids):]
        dt = time.perf_counter() - t0
        print(tok.decode(gen))
        print(f"[{len(gen)} tokens, {len(gen) / max(dt, 1e-9):.1f} tok/s with the prefill]",
              file=sys.stderr)
        return 0
    sampling = ({"greedy": True} if args.temp <= 0 else
                {"temp": args.temp, "top_k": args.top_k, "top_p": args.top_p,
                 "min_p": args.min_p, "seed": args.seed})
    eng = Engine(model, n_slots=1, n_ctx=args.ctx_size, kv_dtype=kvd,
                 device=args.device)
    req = GenRequest(
        prompt_ids=ids, max_tokens=args.n_predict, sampling=sampling, grammar=grammar,
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
    from .server.http import Server, ServerApp

    model, kvd = _load(args)
    draft = None
    if args.draft_model:
        from .models import load_model

        draft = load_model(args.draft_model, keep_quantized=args.keep_quantized,
                           device=args.device)
    app = ServerApp(model, n_slots=args.slots, n_ctx=args.ctx_size, kv_dtype=kvd,
                    device=args.device, paged=args.paged_kv,
                    page_size=args.kv_page_size, n_pages=args.kv_pages,
                    warmup=args.warmup, draft_model=draft, n_draft=args.draft_n)
    srv = Server(app, host=args.host, port=args.port)
    srv.start()
    if app.warmup_info is not None:
        w = app.warmup_info
        print(f"warmup: {len(w['keys'])} graphs captured in {w['seconds']:.1f} s, "
              f"graph pool {w['pool_bytes'] / 2**20:.0f} MiB", file=sys.stderr)
    print(f"listening on http://{args.host}:{srv.port}", file=sys.stderr)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="superllama_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="generate text")
    _add_model_args(p)
    p.add_argument("-p", "--prompt", required=True)
    p.add_argument("-n", "--n-predict", type=int, default=128, help="tokens to generate")
    p.add_argument("--temp", type=float, default=0.8, help="temperature (<=0 → greedy)")
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--min-p", type=float, default=0.05)
    p.add_argument("-s", "--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--grammar", help="GBNF grammar for constrained decoding")
    p.add_argument("--grammar-file", help="file with a GBNF grammar")
    p.add_argument("-j", "--json-schema", help="JSON schema to constrain output to")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("serve", help="HTTP server")
    _add_model_args(p)
    p.add_argument("--host", default="127.0.0.1", help="bind address")
    p.add_argument("--port", type=int, default=8080, help="bind port")
    p.add_argument("-np", "--slots", "--parallel", type=int, default=4,
                   help="concurrent generation slots")
    p.add_argument("--paged-kv", action="store_true",
                   help="serve with the paged KV cache (device⇄host spill)")
    p.add_argument("--kv-page-size", type=int, default=256, help="tokens per KV page")
    p.add_argument("--kv-pages", type=int, default=None,
                   help="device-resident page pool size (default: slots*ctx/page + 1)")
    p.add_argument("--warmup", dest="warmup", action="store_true", default=True,
                   help="run a warmup pass (default): capture every graph before serving")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   help="skip model warmup")
    p.add_argument("-md", "--draft-model",
                   help="draft model for speculative decoding (loaded on --device)")
    p.add_argument("--draft-n", "--draft", dest="draft_n", type=int, default=8,
                   help="draft tokens per round")
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

    args = ap.parse_args(argv)
    return args.fn(args)
