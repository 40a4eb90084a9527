"""Grouped matmul: the expert GEMM of a sparse mixture of experts.

Counterpart of ``jax.lax.ragged_dot(xs, w, group_sizes,
preferred_element_type=f32)`` in the JAX package's ``_experts_apply``
(``superllama_tpu/models/llama.py:194``, ``:199``, ``:206``): rows
``offsets[g]:offsets[g + 1]`` of ``xs`` (R, K), sorted by group, times
``w[g]`` of the (G, K, N) bank, in f32. The group offsets are a device
tensor, so a CUDA graph can capture the call: nothing is read on the host.

On CUDA tensors ``grouped_matmul`` launches the hand-written kernel of
``csrc/gmm.cu`` (bf16 on the tensor cores, f32 on the CUDA cores), counted
in ``grouped_matmul.launches``; on CPU tensors it runs
``ops/ref.py::grouped_matmul_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import grouped_matmul_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I] * 6 + [_P] * 5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """xs (R, K) f32 or bf16, rows sorted by group; w (G, K, N) of xs's
    type, contiguous; offsets (G + 1,) int32 group bounds (offsets[0] 0,
    offsets[G] R). Returns (R, N) f32; a group of 0 rows writes nothing."""
    if xs.device.type == "cpu":
        return grouped_matmul_plain(xs, w, offsets)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cuda or cpu tensors, not {xs.device}")
    kind = _DTYPES.get(xs.dtype)
    if kind is None or w.dtype != xs.dtype:
        raise TypeError(f"grouped_matmul takes f32 or bf16 operands of one type, got "
                        f"{xs.dtype} and {w.dtype}")
    if xs.dim() != 2 or w.dim() != 3 or xs.shape[1] != w.shape[1]:
        raise ValueError(f"grouped_matmul shapes: xs {tuple(xs.shape)}, w {tuple(w.shape)}")
    G, K, N = w.shape
    if offsets.shape != (G + 1,):
        raise ValueError(f"offsets must be ({G + 1},), got {tuple(offsets.shape)}")
    if not w.is_contiguous():
        raise ValueError("the expert bank must be contiguous (G, K, N)")
    fn = _build.load("gmm").slt_gmm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    xs = xs.contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    R = xs.shape[0]
    out = torch.empty((R, N), dtype=torch.float32, device=xs.device)
    if R == 0:
        return out
    epc = 16 // xs.element_size()
    vec = int(K % epc == 0 and N % epc == 0 and xs.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    err = fn(R, K, N, G, kind, vec, xs.data_ptr(), w.data_ptr(), offsets.data_ptr(),
             out.data_ptr(), _build.stream_ptr(xs.device))
    _build.check(err, "gmm")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
