"""Perplexity + KL-divergence evaluation.

The port's counterpart of the JAX package's ``tools/perplexity.py``, on the
port's ``Context`` (``device``: default CUDA; the model's weights must be
there). Methodology replicates tools/perplexity/perplexity.cpp: the corpus
is split into non-overlapping n_ctx-token chunks; each chunk is evaluated
and NLL is accumulated over positions [first, n_ctx) with first =
min(512, n_ctx/2); PPL = exp(mean NLL). KL mode compares per-token
distributions against saved base-model logits (the fp16-vs-quant quality
gate).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.loader import LoadedModel
from ..runtime.context import Context


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """(T, V) logits → f32 log-probabilities."""
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


@dataclasses.dataclass
class PerplexityResult:
    ppl: float
    nll_sum: float
    n_tokens: int
    per_chunk_ppl: list[float]

    def __str__(self):
        return f"PPL = {self.ppl:.4f} over {self.n_tokens} tokens"


def compute_perplexity(model: LoadedModel, token_ids: np.ndarray, n_ctx: int = 512,
                       n_batch: int = 1, add_bos: bool = True,
                       logits_sink=None, device=None) -> PerplexityResult:
    """token_ids: 1-D array of the full corpus tokenization."""
    ids = np.asarray(token_ids, np.int32)
    bos = model.tokenizer.vocab.bos_id if model.tokenizer else -1
    first = min(512, n_ctx // 2)
    # reference chunk count (perplexity.cpp): floor(n_tokens / n_ctx) — the
    # eval window first..n_ctx-2 never needs a target beyond the chunk itself
    n_chunks = len(ids) // n_ctx
    if n_chunks < 1:
        raise ValueError(f"need ≥{n_ctx} tokens, got {len(ids)}")

    ctx = Context(model, n_batch=1, n_ctx=n_ctx, device=device)
    nll_sum, count = 0.0, 0
    per_chunk = []
    for c in range(n_chunks):
        chunk = ids[c * n_ctx : (c + 1) * n_ctx + 1]
        if len(chunk) == n_ctx:       # final chunk: pad the unused last target
            chunk = np.concatenate([chunk, chunk[-1:]])
        inp = chunk[:n_ctx].copy()
        if add_bos and bos >= 0:
            inp0 = inp.copy()
            inp0[0] = bos  # llama.cpp replaces the first token of each chunk with BOS
        else:
            inp0 = inp
        ctx.reset()
        logits = ctx.forward(inp0[None, :])  # (1, n_ctx, V)
        logp = _log_softmax(logits[0])
        targets = torch.as_tensor(chunk[1 : n_ctx + 1].astype(np.int64), device=logp.device)
        tok_logp = torch.gather(logp, 1, targets[:, None])[:, 0].cpu().numpy()
        # exact reference window (perplexity.cpp:625-631): logits rows
        # first..n_ctx-2 predicting chunk[first+1..n_ctx-1] — n_ctx-1-first
        # positions per chunk
        sel = tok_logp[first : n_ctx - 1]
        if logits_sink is not None:
            logits_sink.append(logp.cpu().numpy())
        chunk_nll = -float(sel.sum())
        nll_sum += chunk_nll
        count += sel.size
        per_chunk.append(math.exp(chunk_nll / sel.size))
    return PerplexityResult(
        ppl=math.exp(nll_sum / count), nll_sum=nll_sum, n_tokens=count,
        per_chunk_ppl=per_chunk,
    )


def compute_kl_divergence(model: LoadedModel, token_ids: np.ndarray,
                          base_logp_chunks: list[np.ndarray],
                          n_ctx: int = 512, device=None) -> dict:
    """KL(base ‖ model) per token vs saved base log-probs (perplexity.cpp
    --kl-divergence mode)."""
    sink: list[np.ndarray] = []
    res = compute_perplexity(model, token_ids, n_ctx=n_ctx, logits_sink=sink,
                             device=device)
    kls = []
    same_top = 0
    total = 0
    for ours, base in zip(sink, base_logp_chunks):
        kl = np.sum(np.exp(base) * (base - ours), axis=-1)
        kls.append(kl)
        same_top += int((ours.argmax(-1) == base.argmax(-1)).sum())
        total += ours.shape[0]
    allkl = np.concatenate(kls)
    return {
        "ppl": res.ppl,
        "kl_mean": float(allkl.mean()),
        "kl_p99": float(np.percentile(allkl, 99)),
        "kl_max": float(allkl.max()),
        "same_top_p": same_top / total,
    }


# --- benchmark-task scoring (hellaswag / winogrande / multiple-choice) --------
#
# Counterparts of hellaswag_score / winogrande_score / multiple_choice_score
# in tools/perplexity/perplexity.cpp:741,1091,1274. Input formats:
#   hellaswag: 6 lines per task — context, gold index, 4 endings (:752-760)
#   winogrande: CSV — index,"sentence with _","opt1","opt2",answer∈{1,2}
#   multiple-choice: JSONL {"question","choices","answer"} (the reference
#     uses a packed binary; JSONL carries the same fields readably)


def _continuation_logprob(ctx: Context, ctx_ids: list[int],
                          cont_ids: list[int]) -> tuple[float, int]:
    """Σ log p(cont | context) teacher-forced, and the token count."""
    ids = np.asarray(ctx_ids + cont_ids, np.int32)
    ctx.reset()
    logits = ctx.forward(ids[None, :-1] if len(cont_ids) else ids[None])
    logp = _log_softmax(logits[0])
    start = len(ctx_ids) - 1
    tgt = torch.as_tensor(ids[len(ctx_ids):].astype(np.int64), device=logp.device)
    sel = torch.gather(logp[start:start + len(cont_ids)], 1, tgt[:, None])[:, 0]
    return float(sel.cpu().numpy().sum()), len(cont_ids)


def score_hellaswag(model: LoadedModel, text: str, n_tasks: int | None = None,
                    n_ctx: int = 512, device=None) -> dict:
    """acc_norm over 6-line tasks; endings scored by mean token log-prob."""
    lines = [l for l in text.split("\n") if l != ""]
    assert len(lines) % 6 == 0, "hellaswag input must be 6 lines per task"
    tasks = [lines[i:i + 6] for i in range(0, len(lines), 6)]
    if n_tasks:
        tasks = tasks[:n_tasks]
    tok = model.tokenizer
    ctx = Context(model, n_batch=1, n_ctx=n_ctx, device=device)
    correct = 0
    for t in tasks:
        context, gold, endings = t[0], int(t[1]), t[2:6]
        ctx_ids = tok.encode(context, add_special=True)
        scores = []
        for e in endings:
            cont = tok.encode(" " + e.strip(), add_special=False)
            lp, n = _continuation_logprob(ctx, ctx_ids, cont)
            scores.append(lp / max(n, 1))
        if int(np.argmax(scores)) == gold:
            correct += 1
    return {"task": "hellaswag", "acc": correct / len(tasks), "n": len(tasks)}


def score_winogrande(model: LoadedModel, text: str, n_tasks: int | None = None,
                     n_ctx: int = 512, device=None) -> dict:
    """Each choice fills the blank; score the sentence part AFTER the blank
    given the filled prefix (perplexity.cpp:1091 partial evaluation)."""
    import csv
    import io

    rows = [r for r in csv.reader(io.StringIO(text)) if r and r[0].strip()]
    if rows and rows[0][-1].lower() in ("answer",):
        rows = rows[1:]
    if n_tasks:
        rows = rows[:n_tasks]
    tok = model.tokenizer
    ctx = Context(model, n_batch=1, n_ctx=n_ctx, device=device)
    correct = 0
    for r in rows:
        _, sentence, opt1, opt2, answer = r[:5]
        gold = int(answer) - 1
        scores = []
        for opt in (opt1, opt2):
            blank = sentence.index("_")
            prefix = sentence[:blank] + opt
            suffix = sentence[blank + 1:]
            pre_ids = tok.encode(prefix, add_special=True)
            suf_ids = tok.encode(suffix, add_special=False)
            lp, n = _continuation_logprob(ctx, pre_ids, suf_ids)
            scores.append(lp / max(n, 1))
        if int(np.argmax(scores)) == gold:
            correct += 1
    return {"task": "winogrande", "acc": correct / len(rows), "n": len(rows)}


def score_multiple_choice(model: LoadedModel, text: str,
                          n_tasks: int | None = None, n_ctx: int = 512,
                          device=None) -> dict:
    """JSONL tasks {"question", "choices", "answer"}: pick the choice with
    the highest mean token log-prob given the question."""
    import json

    tasks = [json.loads(l) for l in text.splitlines() if l.strip()]
    if n_tasks:
        tasks = tasks[:n_tasks]
    tok = model.tokenizer
    ctx = Context(model, n_batch=1, n_ctx=n_ctx, device=device)
    correct = 0
    for t in tasks:
        q_ids = tok.encode(t["question"], add_special=True)
        scores = []
        for choice in t["choices"]:
            cont = tok.encode(" " + str(choice).strip(), add_special=False)
            lp, n = _continuation_logprob(ctx, q_ids, cont)
            scores.append(lp / max(n, 1))
        if int(np.argmax(scores)) == int(t["answer"]):
            correct += 1
    return {"task": "multiple_choice", "acc": correct / len(tasks),
            "n": len(tasks)}
