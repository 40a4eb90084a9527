"""Embeddings and rerank pipeline (the server's /embeddings and /rerank).

Counterpart of the JAX package's ``runtime/embedder.py``: texts are
tokenized, padded to a bucket (16, 32, …, 512 tokens, else the longest
text's length) and run through ``bert_forward`` in one batch, then pooled
(``pool``: mean, cls or last, L2-normalized by default). ``rerank`` scores
documents against a query with the classification head where the model has
one (the query and each document joined by a space, as the JAX package
joins them), else by the cosine of their embeddings. The JAX package
jit-compiles one function a bucket; here each batch runs eagerly on the
model's device, one forward a call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.bert import ENCODER_ARCHS, bert_forward, pool, rerank_score
from ..models.loader import LoadedModel
from .context import model_device

BUCKETS = (16, 32, 64, 128, 256, 512)


class Embedder:
    """Batched text → embedding, and query / document rerank scores."""

    def __init__(self, model: LoadedModel, pooling: str = "mean", normalize: bool = True):
        if model.hparams.arch not in ENCODER_ARCHS:
            raise ValueError(f"not an encoder arch: {model.hparams.arch}")
        self.model = model
        self.pooling = pooling
        self.normalize = normalize
        self.device = model_device(model)

    def batch(self, texts: list[str]) -> tuple[torch.Tensor, torch.Tensor, int]:
        """(tokens (B, T), mask (B, T) on the device, the texts' token count)."""
        tok = self.model.tokenizer
        ids = [tok.encode(t, add_special=True) for t in texts]
        n = max(len(i) for i in ids)
        T = next((b for b in BUCKETS if n <= b), n)
        tokens = np.zeros((len(ids), T), np.int64)
        mask = np.zeros((len(ids), T), np.int64)
        for r, seq in enumerate(ids):
            tokens[r, :len(seq)] = seq[:T]
            mask[r, :len(seq)] = 1
        return (torch.from_numpy(tokens).to(self.device), torch.from_numpy(mask).to(self.device),
                sum(len(i) for i in ids))

    @torch.no_grad()
    def embed(self, texts: list[str]) -> tuple[np.ndarray, int]:
        tokens, mask, n_tok = self.batch(texts)
        hidden = bert_forward(self.model.params, self.model.hparams, tokens, mask)
        out = pool(hidden, mask, self.pooling, self.normalize)
        return out.to(torch.float32).cpu().numpy(), n_tok

    @torch.no_grad()
    def rerank(self, query: str, documents: list[str]) -> tuple[list[float], int]:
        """Each document's score against the query: the classification head
        on "query document" where the model has one, else the cosine of the
        embeddings."""
        params = self.model.params
        if params.get("cls_out") is not None:
            tokens, mask, n_tok = self.batch([f"{query} {d}" for d in documents])
            hidden = bert_forward(params, self.model.hparams, tokens, mask)
            s = rerank_score(params, hidden, mask).to(torch.float32).cpu().numpy()
            return [float(x) for x in s], n_tok
        embs, n_tok = self.embed([query] + list(documents))
        qe, de = embs[0], embs[1:]
        return [float(x) for x in de @ qe], n_tok
