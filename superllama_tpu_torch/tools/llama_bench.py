"""Perf-matrix benchmark: (pp, tg, depth) × repetitions with mean ± stddev
and markdown / json / jsonl / csv output.

Counterpart of the JAX package's ``tools/llama_bench.py`` (itself after
tools/llama-bench/llama-bench.cpp): each test row measures prompt-processing
throughput (ppN — N tokens in one batch) or text-generation throughput (tgN
— N sequential decode steps, each fed the previous step's greedy token),
optionally at a prefilled context depth (dN), repeated R times after one
warm-up repetition. Steps run through the port's ``Context``; a timed span
ends when the device has finished its work.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from ..models.loader import LoadedModel
from ..runtime.context import Context, model_device


@dataclasses.dataclass
class BenchResult:
    model: str
    n_params: int
    test: str            # "pp512" | "tg128" | "pp512@d1024" …
    n_tokens: int
    avg_ts: float        # tokens/sec mean
    stddev_ts: float
    samples: list[float] = dataclasses.field(default_factory=list)
    backend: str = ""    # the device the steps ran on


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _n_elements(tree) -> int:
    """Elements of every tensor in the parameter tree (a quantized weight
    counts its planes), as the JAX package counts its pytree leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(_n_elements(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_n_elements(v) for v in tree)
    if hasattr(tree, "planes"):
        return sum(p.numel() for p in tree.planes().values())
    return 0


def _decode_chain(ctx: Context, n: int, seed_tok: int) -> float:
    """n sequential data-dependent decode steps; returns elapsed seconds.
    Each step's greedy token comes back to the host to feed the next, as a
    serving loop does."""
    tok = np.asarray([[seed_tok]], np.int64)
    t0 = time.perf_counter()
    for _ in range(n):
        logits = ctx.forward(tok)
        tok = (torch.argmax(logits[:, -1:], dim=-1) % ctx.hp.n_vocab).cpu().numpy()
    return time.perf_counter() - t0


def run_bench(model: LoadedModel, pp=(512,), tg=(128,), depths=(0,), reps: int = 3,
              n_ctx: int = 4096, kv_dtype=torch.bfloat16) -> list[BenchResult]:
    """The pp/tg × depth matrix on the device that holds the model."""
    rng = np.random.default_rng(0)
    hp = model.hparams
    dev = model_device(model)
    n_params = _n_elements(model.params)
    name = model.name or hp.arch

    def result(test, n, samples):
        return BenchResult(model=name, n_params=n_params, test=test, n_tokens=n,
                           avg_ts=statistics.mean(samples),
                           stddev_ts=statistics.stdev(samples) if len(samples) > 1 else 0.0,
                           samples=samples, backend=dev.type)

    results = []
    for d in depths:
        for n in pp:
            ctx = Context(model, n_ctx=max(n_ctx, d + n + 1), kv_dtype=kv_dtype, device=dev)
            samples = []
            for rep in range(reps + 1):  # the first repetition warms up
                ctx.reset()
                if d:
                    ctx.forward(rng.integers(0, hp.n_vocab, (1, d)))
                prompt = rng.integers(0, hp.n_vocab, (1, n))
                _sync(dev)
                t0 = time.perf_counter()
                ctx.forward(prompt)
                _sync(dev)
                if rep > 0:
                    samples.append(n / (time.perf_counter() - t0))
            results.append(result(f"pp{n}" + (f"@d{d}" if d else ""), n, samples))
        for n in tg:
            ctx = Context(model, n_ctx=max(n_ctx, d + n + 2), kv_dtype=kv_dtype, device=dev)
            samples = []
            for rep in range(reps + 1):
                ctx.reset()
                if d:
                    ctx.forward(rng.integers(0, hp.n_vocab, (1, d)))
                else:  # seed one token so decode has context
                    ctx.forward(np.asarray([[1]], np.int64))
                _sync(dev)
                steps = n if rep > 0 else min(n, 3)  # short warm-up
                dt = _decode_chain(ctx, steps, 2)
                if rep > 0:
                    samples.append(n / dt)
            results.append(result(f"tg{n}" + (f"@d{d}" if d else ""), n, samples))
    return results


def format_markdown(results: list[BenchResult]) -> str:
    rows = ["| model | params | backend | test | t/s |",
            "| ----- | ------ | ------- | ---- | --- |"]
    for r in results:
        rows.append(f"| {r.model} | {r.n_params / 1e6:.1f}M | {r.backend} "
                    f"| {r.test} | {r.avg_ts:.2f} ± {r.stddev_ts:.2f} |")
    return "\n".join(rows)


def format_json(results: list[BenchResult]) -> str:
    return json.dumps([dataclasses.asdict(r) for r in results], indent=2)


def format_jsonl(results: list[BenchResult]) -> str:
    return "\n".join(json.dumps(dataclasses.asdict(r)) for r in results)


def format_csv(results: list[BenchResult]) -> str:
    hdr = "model,n_params,test,n_tokens,avg_ts,stddev_ts"
    rows = [hdr] + [f"{r.model},{r.n_params},{r.test},{r.n_tokens},"
                    f"{r.avg_ts:.4f},{r.stddev_ts:.4f}" for r in results]
    return "\n".join(rows)


FORMATTERS = {"md": format_markdown, "json": format_json,
              "jsonl": format_jsonl, "csv": format_csv}
