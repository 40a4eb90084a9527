"""Control vectors: per-layer steering directions added to the residual
stream, and the PCA generator.

Counterpart of the JAX package's ``models/cvector.py``: a control vector's
GGUF holds ``direction.<il>`` tensors (1-based; llama_adapter_cvec), added
as ``x + direction[il]`` after each layer (``params["cvec"]``, read by
``llama_forward``); ``generate_control_vector`` takes the top principal
component of the per-layer mean hidden-state differences between positive
and negative prompts (tools/cvector-generator).
"""

from __future__ import annotations

import numpy as np
import torch

from ..gguf import GGMLType, GGUFReader, GGUFWriter
from ..runtime.kv_cache import kv_cache_init
from .hparams import HParams
from .llama import llama_forward


def load_control_vector(path: str, n_layer: int, n_embd: int, scale: float = 1.0,
                        device="cpu") -> torch.Tensor:
    """(n_layer, E) f32 directions times ``scale`` for ``params["cvec"]``;
    layers the file lacks are zero."""
    r = GGUFReader(path)
    out = np.zeros((n_layer, n_embd), np.float32)
    try:
        for name, ti in r.tensors.items():
            if name.startswith("direction."):
                il = int(name.split(".")[1])
                if 0 <= il - 1 < n_layer:       # the file's layers are 1-based
                    out[il - 1] = ti.astype_f32().reshape(-1)[:n_embd]
    finally:
        r.close()
    return torch.from_numpy(out * np.float32(scale)).to(device)


def save_control_vector(path: str, directions: np.ndarray) -> None:
    """directions (n_layer, E), written 1-based as direction.<il>."""
    w = GGUFWriter(path, arch="controlvector")
    w.add("controlvector.model_hint", "llama")
    w.add("controlvector.layer_count", int(directions.shape[0]))
    for il in range(directions.shape[0]):
        w.add_tensor(f"direction.{il + 1}", directions[il].astype(np.float32), GGMLType.F32)
    w.write()


def _power_iteration(mat: np.ndarray, iters: int = 100) -> np.ndarray:
    """Top principal component of the row matrix mat (n_samples, E)."""
    cov = mat.T @ mat
    v = np.random.default_rng(0).normal(size=cov.shape[0]).astype(np.float64)
    v /= np.linalg.norm(v)
    for _ in range(iters):
        v = cov @ v
        n = np.linalg.norm(v)
        if n < 1e-12:
            return np.zeros_like(v, dtype=np.float32)
        v /= n
    return v.astype(np.float32)


@torch.no_grad()
def generate_control_vector(model, positive: list[str], negative: list[str]) -> np.ndarray:
    """(n_layer, E) directions from paired prompts: per layer, the top
    principal component of the mean-hidden-state differences, its sign
    aligned with the mean difference. Each prompt runs once, on a cache of
    its own length, through the plain attention path."""
    hp: HParams = model.hparams
    dev = model.params["token_embd"].device
    diffs = [[] for _ in range(hp.n_layer)]
    for p_pos, p_neg in zip(positive, negative):
        per_prompt = []
        for text in (p_pos, p_neg):
            ids = model.tokenizer.encode(text, add_special=True)
            cache = kv_cache_init(hp.n_layer, 1, max(len(ids), 8), hp.n_head_kv,
                                  hp.head_dim, hp.head_dim_v, dtype=torch.float32,
                                  device=dev)
            sink: list = []
            llama_forward(model.params, hp, torch.tensor([ids], device=dev),
                          torch.arange(len(ids), dtype=torch.int32, device=dev)[None],
                          cache, flash=False, hidden_sink=sink)
            per_prompt.append([h[0].to(torch.float32).cpu().numpy().mean(axis=0)
                               for h in sink])
        for il in range(hp.n_layer):
            diffs[il].append(per_prompt[0][il] - per_prompt[1][il])

    out = np.zeros((hp.n_layer, hp.n_embd), np.float32)
    for il in range(hp.n_layer):
        mat = np.stack(diffs[il])
        v = _power_iteration(mat)
        if float(mat.mean(axis=0) @ v) < 0:    # align the sign with the mean diff
            v = -v
        out[il] = v
    return out
