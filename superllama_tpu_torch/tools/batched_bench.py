"""Batched decode benchmark, the llama-batched-bench counterpart: for each
(PP, TG, B) config, prompt-processing throughput, text-generation throughput
and total speed with B parallel sequences.

Counterpart of the JAX package's ``tools/batched_bench.py`` with its
``BenchRow`` and table. Prefill runs eagerly; the timed decode phase is a
data-dependent chain (each step's greedy token feeds the next) of TG - 4
steps captured in one CUDA graph and replayed on a CUDA device, run eagerly
on the CPU. A timed span ends when the device has finished its work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.loader import LoadedModel
from ..models.registry import get_forward
from ..runtime.context import model_device
from ..runtime.graphs import GraphCache
from ..runtime.kv_cache import kv_cache_init
from .llama_bench import _sync


@dataclass
class BenchRow:
    pp: int
    tg: int
    batch: int
    t_pp_s: float
    t_tg_s: float

    @property
    def s_pp(self) -> float:  # prompt tokens/s across the batch
        return self.pp * self.batch / self.t_pp_s

    @property
    def s_tg(self) -> float:  # generated tokens/s across the batch
        return self.tg * self.batch / self.t_tg_s

    @property
    def s_total(self) -> float:
        return (self.pp + self.tg) * self.batch / (self.t_pp_s + self.t_tg_s)

    def as_dict(self) -> dict:
        return {"pp": self.pp, "tg": self.tg, "batch": self.batch,
                "s_pp_tok_s": round(self.s_pp, 2),
                "s_tg_tok_s": round(self.s_tg, 2),
                "s_total_tok_s": round(self.s_total, 2)}


def run_batched_bench(model: LoadedModel, configs: list[tuple[int, int, int]],
                      n_ctx: int | None = None, kv_dtype=torch.bfloat16,
                      seed: int = 0) -> list[BenchRow]:
    """One BenchRow per (pp, tg, batch), on the device the model lies on."""
    hp = model.hparams
    dev = model_device(model)
    fwd = get_forward(hp.arch)
    rng = np.random.default_rng(seed)
    rows = []

    def new_cache(b: int, S: int):
        return kv_cache_init(hp.n_layer, b, S, hp.n_head_kv, hp.head_dim, hp.head_dim_v,
                             dtype=kv_dtype, device=dev)

    def chain(cache, io: dict, n: int) -> None:
        tok, pos = io["tok"], io["pos"]
        live = pos[:, 0] >= 0
        for _ in range(n):
            logits, _ = fwd(model.params, hp, tok, pos, cache)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            pos = torch.where(live[:, None], pos + 1, pos)
        io["tok_l"].copy_(tok)

    with torch.no_grad():
        for pp, tg, b in configs:
            S = n_ctx or (pp + tg + 8)
            prompt = torch.from_numpy(rng.integers(1, hp.n_vocab, (b, pp))).to(dev)
            pos = torch.arange(pp, dtype=torch.int32, device=dev)[None].expand(b, pp)

            # warm the prefill path on a throwaway cache; its argmax is the
            # timed run's prompt (data-dependent)
            wl, _ = fwd(model.params, hp, prompt, pos, new_cache(b, S))
            prompt2 = torch.argmax(wl, dim=-1) % hp.n_vocab
            cache = new_cache(b, S)
            _sync(dev)
            t0 = time.perf_counter()
            logits, _ = fwd(model.params, hp, prompt2, pos, cache)
            _sync(dev)
            t_pp = time.perf_counter() - t0

            io = {"tok": torch.argmax(logits[:, -1:], dim=-1),
                  "pos": torch.full((b, 1), pp, dtype=torch.int32, device=dev)}
            io["tok_l"] = torch.empty_like(io["tok"])
            warm = min(tg, 4)
            chain(cache, io, warm)          # warm decode steps, eager
            io["tok"].copy_(io["tok_l"])
            io["pos"].fill_(pp + warm)
            remaining = tg - warm
            t_tg = 1e-9
            if remaining > 0:
                run = lambda: chain(cache, io, remaining)   # noqa: E731
                graphs = GraphCache(dev) if dev.type == "cuda" else None
                if graphs is not None:   # captured before the timed span
                    idle = {"tok": torch.zeros_like(io["tok"]),
                            "pos": torch.full_like(io["pos"], -1),
                            "tok_l": torch.empty_like(io["tok"])}
                    graphs.capture("tg", run, lambda: chain(cache, idle, remaining))
                    run = lambda: graphs.replay("tg")   # noqa: E731
                _sync(dev)
                t0 = time.perf_counter()
                run()
                _sync(dev)
                t_tg = (time.perf_counter() - t0) * tg / remaining
            rows.append(BenchRow(pp, tg, b, t_pp, t_tg))
            del cache
    return rows


def format_table(rows: list[BenchRow]) -> str:
    hdr = f"| {'PP':>6} | {'TG':>5} | {'B':>3} | {'S_PP t/s':>10} | {'S_TG t/s':>10} | {'S t/s':>10} |"
    sep = "|" + "-" * (len(hdr) - 2) + "|"
    lines = [hdr, sep]
    for r in rows:
        lines.append(f"| {r.pp:>6} | {r.tg:>5} | {r.batch:>3} "
                     f"| {r.s_pp:>10.2f} | {r.s_tg:>10.2f} | {r.s_total:>10.2f} |")
    return "\n".join(lines)
