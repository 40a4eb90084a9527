"""GGUF → device params loader for the llama family.

Counterpart of the JAX package's ``models/loader.py::load_model`` (llama
branch): reads tensors by name, keeps repackable 2-D matmul weights packed as
QTensors when asked (or dequantizes them), transposes matmul weights to
(in, out) so the forward uses ``x @ w``, and places every tensor on the
device once.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..gguf import GGUFReader
from ..ops.qtensor import REPACKABLE, repack
from ..server.security import decrypted
from .hparams import HParams, hparams_from_gguf
from .registry import get_forward


@dataclass
class LoadedModel:
    hparams: HParams
    params: dict[str, Any]
    tokenizer: Any
    metadata: dict[str, Any]
    name: str = ""


# Tensors load on a pool of LOAD_WORKERS threads (numpy and the native
# library release the GIL in their array work). A native repack spreads one
# tensor over threads of its own: each gets cores // workers of them, so the
# pool and the library together keep each core busy once, with no more
# threads than cores.
LOAD_WORKERS = 8


def load_threads() -> tuple[int, int]:
    """(pool workers, native repack threads a worker) on this host."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else (
        os.cpu_count() or 1)
    workers = min(LOAD_WORKERS, cores)
    return workers, max(1, cores // workers)


def _get(reader: GGUFReader, name: str, dtype: torch.dtype, device,
         transpose: bool = True, keep_quantized: bool = False, threads: int = 0):
    ti = reader.tensors.get(name)
    if ti is None:
        return None
    if (keep_quantized and transpose and len(ti.ne) == 2
            and ti.ggml_type in REPACKABLE):
        return repack(ti.raw(), ti.ggml_type, ti.shape, device=device, threads=threads)
    arr = ti.astype_f32()
    if transpose and arr.ndim == 2:
        arr = arr.T                       # (out, in) → (in, out)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)


def load_model(path: str, dtype: torch.dtype = torch.float32,
               keep_quantized: bool = False, device=None) -> LoadedModel:
    """Load a llama-family GGUF: hparams + tokenizer + params on ``device``
    (default CUDA).

    keep_quantized=True keeps the matmul weights of every ``REPACKABLE``
    type packed as QTensors for the quantized kernels; other tensors are
    dequantized to ``dtype``. A split model loads from all its shards given
    the first one's path (``*-00001-of-0000N.gguf``, which carries the
    metadata). Tensors are decoded and repacked on a pool of threads
    (``load_threads``; Q4_0, Q8_0 and the K-quants through the native
    repack, bit-identical to numpy's). An encrypted GGUF
    (``server/security.py``'s AES-256-GCM container) is decrypted with
    ``SLT_MODEL_KEY`` to a temporary file, removed once the tensors are on
    the device."""
    dev = resolve_device(device)
    with decrypted(path) as plain:
        return _load(plain, dtype, keep_quantized, dev)


def _load(path: str, dtype: torch.dtype, keep_quantized: bool, dev) -> LoadedModel:
    reader = GGUFReader(path)
    extra: list[GGUFReader] = []
    workers, threads = load_threads()
    pool = ThreadPoolExecutor(max_workers=workers)
    try:
        if int(reader.metadata.get("split.count", 1) or 1) > 1:
            # a multi-shard model: merge the shards' tensor indices
            from ..tools.gguf_split import shard_paths

            for p in shard_paths(path):
                if p != path:
                    extra.append(GGUFReader(p))
                    reader.tensors.update(extra[-1].tensors)
        hp = hparams_from_gguf(reader)
        get_forward(hp.arch)              # raises for unported architectures
        tok = None
        if "tokenizer.ggml.tokens" in reader.metadata:
            from ..tokenizer import Tokenizer, vocab_from_gguf

            tok = Tokenizer(vocab_from_gguf(reader))

        def g(name, t=True):       # a future of the tensor (or of None)
            return pool.submit(_get, reader, name, dtype, dev, t, keep_quantized, threads)

        params: dict[str, Any] = {
            "token_embd": g("token_embd.weight", t=False),    # (V, E) lookup
            "output_norm": g("output_norm.weight", t=False),
            "output": g("output.weight"),                      # None → tied
            "output_b": g("output.bias", t=False),
            "rope_freqs": g("rope_freqs.weight", t=False),     # llama3 factors
            "layers": [],
        }
        for il in range(hp.n_layer):
            p = f"blk.{il}."
            if p + "attn_qkv.weight" in reader.tensors:
                raise NotImplementedError("fused qkv tensors are not ported yet")
            layer = {
                "attn_norm": g(p + "attn_norm.weight", t=False),
                "wq": g(p + "attn_q.weight"),
                "wk": g(p + "attn_k.weight"),
                "wv": g(p + "attn_v.weight"),
                "wo": g(p + "attn_output.weight"),
                "bq": g(p + "attn_q.bias", t=False),
                "bk": g(p + "attn_k.bias", t=False),
                "bv": g(p + "attn_v.bias", t=False),
                "bo": g(p + "attn_output.bias", t=False),
                "attn_q_norm": g(p + "attn_q_norm.weight", t=False),
                "attn_k_norm": g(p + "attn_k_norm.weight", t=False),
                "ffn_norm": g(p + "ffn_norm.weight", t=False),
                "ffn_gate": g(p + "ffn_gate.weight"),
                "ffn_up": g(p + "ffn_up.weight"),
                "ffn_down": g(p + "ffn_down.weight"),
                "ffn_gate_b": g(p + "ffn_gate.bias", t=False),
                "ffn_up_b": g(p + "ffn_up.bias", t=False),
                "ffn_down_b": g(p + "ffn_down.bias", t=False),
                "attn_sinks": g(p + "attn_sinks.weight", t=False),
            }
            params["layers"].append(layer)
        params = {k: [{n: f.result() for n, f in layer.items()} for layer in v]
                  if k == "layers" else v.result() for k, v in params.items()}
        params["layers"] = [{k: v for k, v in layer.items() if v is not None}
                            for layer in params["layers"]]
        md = dict(reader.metadata)
    finally:
        pool.shutdown(cancel_futures=True)   # no thread reads a file past here
        for r in [reader, *extra]:
            r.close()
    return LoadedModel(hparams=hp, params=params, tokenizer=tok, metadata=md,
                       name=md.get("general.name", ""))


def load_tokenizer(path: str):
    """The GGUF's tokenizer alone (no tensor is read), or None when it has
    none; an encrypted file is decrypted as ``load_model`` does."""
    from ..tokenizer import Tokenizer, vocab_from_gguf

    with decrypted(path) as plain:
        reader = GGUFReader(plain)
        try:
            if "tokenizer.ggml.tokens" not in reader.metadata:
                return None
            return Tokenizer(vocab_from_gguf(reader))
        finally:
            reader.close()
