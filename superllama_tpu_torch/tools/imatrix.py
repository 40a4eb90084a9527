"""Importance-matrix collector + GGUF I/O.

The port's counterpart of the JAX package's ``tools/imatrix.py``
(IMatrixCollector, imatrix.cpp:64-219): run a calibration corpus through the
model on ``device`` while accumulating per-input-channel Σx² for every
matmul weight, then persist as an imatrix GGUF (general.type="imatrix";
per-weight tensors "<name>.in_sum2" + "<name>.counts" — the modern GGUF
imatrix layout). The collection hook is the ``imatrix`` dict of
``llama_forward``; the forward runs eagerly, one chunk a call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..gguf import GGMLType, GGUFReader, GGUFWriter
from ..models.loader import LoadedModel
from ..models.registry import get_forward
from ..runtime.context import check_model_device
from ..runtime.kv_cache import kv_cache_init

# keys whose input activations equal another recorded key (shared input)
_ALIASES = {
    "attn_q.weight": ("attn_k.weight", "attn_v.weight"),
    "ffn_up.weight": ("ffn_gate.weight",),
    "ffn_up_exps.weight": ("ffn_gate_exps.weight",),
}


@torch.no_grad()
def collect_imatrix(model: LoadedModel, batches: list[list[int]],
                    n_ctx: int = 512, device=None) -> dict[str, np.ndarray]:
    """Accumulate Σx² stats over token batches on ``device`` (default
    CUDA; the model's weights must be there). Returns {weight: sum2/count}."""
    dev = resolve_device(device)
    check_model_device(model, dev)
    hp = model.hparams
    fwd = get_forward(hp.arch)
    sums: dict[str, np.ndarray] = {}
    counts: dict[str, float] = {}
    for ids in batches:
        ids = list(ids)[:n_ctx]
        cache = kv_cache_init(hp.n_layer, 1, len(ids), hp.n_head_kv, hp.head_dim,
                              hp.head_dim_v, dtype=torch.float32, device=dev)
        tokens = torch.tensor([ids], dtype=torch.int64, device=dev)
        pos = torch.arange(len(ids), dtype=torch.int32, device=dev)[None, :]
        imx: dict = {}
        fwd(model.params, hp, tokens, pos, cache, imatrix=imx)
        del cache
        for k, v in imx.items():
            if k.endswith(".__count"):
                counts[k[:-8]] = counts.get(k[:-8], 0) + float(v)
            else:
                sums[k] = sums.get(k, 0) + v.cpu().numpy().astype(np.float64)

    out: dict[str, np.ndarray] = {}
    for k, s in sums.items():
        w = (s / max(counts.get(k, 1), 1)).astype(np.float32)
        out[k] = w
        base = k.split(".", 2)[-1] if k.startswith("blk.") else k
        for alias in _ALIASES.get(base, ()):
            out[k.replace(base, alias)] = w
    return out


def save_imatrix(path: str, imatrix: dict[str, np.ndarray],
                 counts: dict[str, float] | None = None,
                 arch: str = "llama") -> None:
    w = GGUFWriter(path, arch=arch)
    w.add("general.type", "imatrix")
    for name, v in imatrix.items():
        w.add_tensor(name + ".in_sum2", np.asarray(v, np.float32), GGMLType.F32)
        w.add_tensor(name + ".counts",
                     np.asarray([(counts or {}).get(name, 1.0)], np.float32),
                     GGMLType.F32)
    w.write()


def load_imatrix(path: str) -> dict[str, np.ndarray]:
    r = GGUFReader(path)
    if r.metadata.get("general.type") != "imatrix":
        raise ValueError("not an imatrix GGUF")
    sums, cnts = {}, {}
    for name, ti in r.tensors.items():
        if name.endswith(".in_sum2"):
            sums[name[:-8]] = ti.astype_f32()
        elif name.endswith(".counts"):
            cnts[name[:-7]] = float(ti.astype_f32().reshape(-1)[0])
    r.close()
    return {k: v / max(cnts.get(k, 1.0), 1e-9) for k, v in sums.items()}
