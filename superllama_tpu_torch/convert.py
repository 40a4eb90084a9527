"""Parameters of the JAX package → parameters of the port.

``params_from_jax`` turns the JAX package's parameter tree, with its arrays
given as numpy arrays, into the port's: the same function computed by both
packages, which the parity tests rely on. This module reads plain attributes
and numpy arrays only; it imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .gguf.constants import GGMLType
from .models.hparams import HParams
from .ops.qtensor import QTensor

_QT_META = ("group", "offset", "nibble", "K", "N", "hi_bits", "sb")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bf16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _qtensor(q, device) -> QTensor:
    planes = {n: (None if getattr(q, n) is None else _tensor(getattr(q, n), device))
              for n in QTensor.PLANES}
    meta = {k: bool(q.nibble) if k == "nibble" else int(getattr(q, k)) for k in _QT_META}
    return QTensor(**planes, **meta, ggml_type=GGMLType(int(q.ggml_type)))


def params_from_jax(params_np, hp: HParams, device=None):
    """Nested dict/list of numpy arrays, QTensor leaves as objects with
    numpy planes (``jax.tree_util.tree_map(np.asarray, params)`` gives
    that) → the port's params on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    if len(params_np.get("layers", [])) != hp.n_layer:
        raise ValueError(f"expected {hp.n_layer} layers, got "
                         f"{len(params_np.get('layers', []))}")

    def conv(v):
        if v is None:
            return None
        if hasattr(v, "codes") and hasattr(v, "ggml_type"):   # a QTensor
            return _qtensor(v, dev)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return _tensor(v, dev)

    return conv(params_np)
