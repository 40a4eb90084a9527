"""Quantized matmul: x (..., K) @ QTensor (K, N) → (..., N).

Counterpart of the JAX package's ``ops/qmatmul.py`` with the same three
regimes (the mmvq / mmq / dense-GEMM split):

 - ``act_quant`` with ``K % group == 0``: the int8-activation GEMV, ``qmv``
   (activations quantized per weight group, integer group dots): the decode
   path for up to 16 rows;
 - M > 32: dequantize, then a dense ``torch.matmul`` (a library product, as
   the JAX package leaves this regime to XLA outside Pallas);
 - otherwise the fused dequant + matmul, ``qmm``.

``qmv`` and ``qmm`` launch the hand-written CUDA kernels of
``csrc/qmv.cu`` and ``csrc/qmm.cu`` on CUDA tensors, and run their plain
PyTorch versions (``qmv_plain``, ``qmm_plain``) only on CPU tensors. Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..gguf.constants import GGMLType
from . import _build
from .qtensor import QTensor, dequant_qtensor, qt_codes, qt_scales_adds
from .ref import quant_scale

# weight formats the kernels decode (csrc FMT ids)
_FMT = {GGMLType.Q8_0: 0, GGMLType.Q4_K: 1, GGMLType.Q6_K: 2}
_UNIT = {0: 32, 1: 256, 2: 256}   # K elements per split unit
_QMV_COLS = 256                   # columns per qmv block (64 threads x 4)
_QMV_SLICES = 4                   # k-slices per qmv block
_QMV_TARGET_BLOCKS = 264          # two blocks per SM of the H100
_QMV_MAX_ROWS = 16
_QMM_BN = 128                     # columns per qmm tensor-core block
_QMM_BK = 128                     # k-tile of the qmm tensor-core kernel
_QMM_RESIDENT = 264               # blocks resident at once: two an SM of the H100

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float


def _lib(name: str, argtypes, entry: str | None = None) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, f"slt_{entry or name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_weight(x2: torch.Tensor, qt: QTensor) -> int:
    """Validate a CUDA launch; returns the kernel's format id."""
    fmt = _FMT.get(qt.ggml_type)
    if fmt is None:
        raise NotImplementedError(f"no CUDA kernel for {qt.ggml_type.name} weights")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be f32 or bf16, got {x2.dtype}")
    if qt.N % 4 or qt.K % _UNIT[fmt] or x2.shape[1] != qt.K:
        raise ValueError(f"unsupported shape: x {tuple(x2.shape)}, weight "
                         f"(K={qt.K}, N={qt.N}) {qt.ggml_type.name}")
    for name, plane in qt.planes().items():
        if plane.device != x2.device or not plane.is_contiguous():
            raise ValueError(f"weight plane {name} must be a contiguous "
                             f"tensor on {x2.device}")
    return fmt


# --- activation quantization (Q8_1 semantics of the mmvq path) -------------


def quantize_acts(x2: torch.Tensor, gs: int):
    """(M, K) → int8 codes (M, K), scales sx (M, K/gs), dequantized group
    sums xs (M, K/gs): inv = 127/amax, round half to even."""
    M, K = x2.shape
    g = x2.reshape(M, K // gs, gs).to(torch.float32)
    # true divisions, as the qmv kernel's quantizer and the JAX package do
    sx, inv = quant_scale(torch.amax(torch.abs(g), dim=-1), 127.0)
    xq = torch.round(g * inv[..., None]).to(torch.int8)
    xsum = xq.to(torch.float32).sum(dim=-1) * sx
    return xq.reshape(M, K), sx, xsum


# --- qmv: int8-activation GEMV ----------------------------------------------


def qmv_plain(x2: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """Plain version of the qmv kernel: per-group integer dots scaled by
    sx·s, plus the group-sum correction xs·(a − offset·s)."""
    M, K = x2.shape
    gs, G = qt.group, K // qt.group
    xq, sx, xs = quantize_acts(x2, gs)
    q = qt_codes(qt).to(torch.float32).reshape(G, gs, qt.N)
    # |dot| <= 32·127·63 < 2^24: the f32 products and sums are exact integers
    ig = torch.matmul(xq.to(torch.float32).reshape(M, G, gs).transpose(0, 1), q)
    s, a = qt_scales_adds(qt)
    acc = (ig * (sx.t()[:, :, None] * s[:, None, :])).sum(dim=0)
    corr = a
    if qt.offset:
        off = -float(qt.offset) * s
        corr = off if corr is None else corr + off
    if corr is not None:
        acc = acc + xs @ corr
    return acc.to(out_dtype)


def _qmv_split(fmt: int, K: int, N: int) -> tuple[int, int]:
    """(n_split, units_per_split) of the grid's K split: enough blocks to fill
    the card, each slice of a block at least one unit. Depends on (K, N)
    only, so a row's sums do not depend on the batch size."""
    n_units = K // _UNIT[fmt]
    n_col_blocks = -(-N // _QMV_COLS)
    split = max(1, min(-(-_QMV_TARGET_BLOCKS // n_col_blocks),
                       n_units // _QMV_SLICES))
    per = -(-n_units // split)
    return -(-n_units // per), per


def qmv(x2: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """int8-activation GEMV (M <= 16 per launch). CUDA: the qmv kernel; CPU:
    ``qmv_plain``."""
    if x2.device.type == "cpu":
        return qmv_plain(x2, qt, out_dtype)
    if x2.device.type != "cuda":
        raise ValueError(f"qmv runs on cuda or cpu tensors, not {x2.device}")
    fmt = _check_weight(x2, qt)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qmv output must be f32 or bf16, got {out_dtype}")
    x2 = x2.contiguous()
    M, K = x2.shape
    if M > _QMV_MAX_ROWS:
        return torch.cat([qmv(x2[i:i + _QMV_MAX_ROWS], qt, out_dtype)
                          for i in range(0, M, _QMV_MAX_ROWS)])
    fn = _lib("qmv", [_I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _I, _I, _P, _P, _I, _P])
    G = K // qt.group
    dev = x2.device
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    sx = torch.empty((M, G), dtype=torch.float32, device=dev)
    xs = torch.empty((M, G), dtype=torch.float32, device=dev)
    n_split, per = _qmv_split(fmt, K, qt.N)
    part = (torch.empty((n_split, M, qt.N), dtype=torch.float32, device=dev)
            if n_split > 1 else None)
    out = torch.empty((M, qt.N), dtype=out_dtype, device=dev)
    err = fn(fmt, M, K, qt.N, x2.data_ptr(), int(x2.dtype == torch.bfloat16),
             xq.data_ptr(), sx.data_ptr(), xs.data_ptr(),
             _ptr(qt.codes), _ptr(qt.hi), _ptr(qt.scales), _ptr(qt.sc),
             _ptr(qt.mn), _ptr(qt.d), _ptr(qt.dmin), n_split, per, _ptr(part),
             out.data_ptr(), int(out_dtype == torch.bfloat16),
             _build.stream_ptr(dev))
    _build.check(err, "qmv")
    qmv.launches += 1
    return out


qmv.launches = 0


# --- qmm: fused dequant + matmul ---------------------------------------------


def qmm_plain(x2: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """Plain version of the qmm kernel: dequantize in f32, round to the
    compute type (bf16 for bf16 x, else f32), multiply with f32
    accumulation."""
    cdt = torch.bfloat16 if x2.dtype == torch.bfloat16 else torch.float32
    w = dequant_qtensor(qt).to(cdt).to(torch.float32)
    return (x2.to(cdt).to(torch.float32) @ w).to(out_dtype)


def qmm_plan(K: int, N: int) -> tuple[int, int]:
    """(n_split, tiles_per_split) of the tensor-core qmm kernel's K split, in
    k-tiles of 128 (a Q8_0 K's last tile may be shorter). N's column blocks
    alone when they fill the resident slots (two blocks an SM); else the
    split, up to one resident wave of blocks, whose waves times k-tiles a
    block is least (the smallest such: each split adds M x N partials).
    Depends on (K, N) only, so a row's sums do not depend on M."""
    n_tiles = -(-K // _QMM_BK)
    n_col_blocks = -(-N // _QMM_BN)

    def rounds(split):
        per = -(-n_tiles // split)
        return -(-n_col_blocks * -(-n_tiles // per) // _QMM_RESIDENT) * per

    most = min(n_tiles, -(-_QMM_RESIDENT // n_col_blocks))
    split = min(range(1, most + 1), key=lambda sp: (rounds(sp), sp))
    per = -(-n_tiles // split)
    return -(-n_tiles // per), per


def qmm(x2: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """Fused dequant + matmul. CUDA: the qmm kernels (tensor cores for bf16
    x and N a multiple of 16, else the CUDA-core kernel); CPU:
    ``qmm_plain``."""
    if x2.device.type == "cpu":
        return qmm_plain(x2, qt, out_dtype)
    if x2.device.type != "cuda":
        raise ValueError(f"qmm runs on cuda or cpu tensors, not {x2.device}")
    fmt = _check_weight(x2, qt)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qmm output must be f32 or bf16, got {out_dtype}")
    x2 = x2.contiguous()
    M, K = x2.shape
    out_bf16 = int(out_dtype == torch.bfloat16)
    if x2.dtype == torch.bfloat16 and qt.N % 16 == 0:
        fn = _lib("qmm", [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _P, _P, _I, _P], entry="qmm_tc")
        out = torch.empty((M, qt.N), dtype=out_dtype, device=x2.device)
        if x2.data_ptr() % 16:   # x rows go in by 16-byte copies
            x2 = x2.clone()
        n_split, per = qmm_plan(K, qt.N)
        part = (torch.empty((n_split, M, qt.N), dtype=torch.float32, device=x2.device)
                if n_split > 1 else None)
        err = fn(fmt, M, K, qt.N, x2.data_ptr(), _ptr(qt.codes), _ptr(qt.hi),
                 _ptr(qt.scales), _ptr(qt.sc), _ptr(qt.mn), _ptr(qt.d), _ptr(qt.dmin),
                 n_split, per, _ptr(part), out.data_ptr(), out_bf16,
                 _build.stream_ptr(x2.device))
    else:
        fn = _lib("qmm", [_I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _P])
        out = torch.empty((M, qt.N), dtype=out_dtype, device=x2.device)
        err = fn(fmt, M, K, qt.N, x2.data_ptr(), int(x2.dtype == torch.bfloat16),
                 _ptr(qt.codes), _ptr(qt.hi), _ptr(qt.scales), _ptr(qt.sc),
                 _ptr(qt.mn), _ptr(qt.d), _ptr(qt.dmin), out.data_ptr(), out_bf16,
                 _build.stream_ptr(x2.device))
    _build.check(err, "qmm")
    qmm.launches += 1
    return out


qmm.launches = 0


# --- dispatch ------------------------------------------------------------------


def qmatmul(x: torch.Tensor, qt: QTensor, *, out_dtype=None,
            act_quant: bool = False, force_fused: bool = False) -> torch.Tensor:
    """x (..., K) @ quantized (K, N) → (..., N), in ``out_dtype`` (x's type
    by default)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    K = x.shape[-1]
    M = math.prod(lead)
    x2 = x.reshape(M, K)
    if act_quant and K % qt.group == 0:
        out = qmv(x2, qt, out_dtype)
    elif M > 32 and not force_fused:
        # compute-bound regime: dequantize once, dense GEMM in x's type
        # (bf16 stays bf16: f32 accumulation, one rounding of the output)
        wd = dequant_qtensor(qt, x2.dtype if x2.dtype == torch.bfloat16 else None)
        out = torch.matmul(x2.to(wd.dtype), wd).to(out_dtype)
    else:
        out = qmm(x2, qt, out_dtype)
    return out.reshape(*lead, qt.N)


def qmatmul_ref(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Dequantize then f32 matmul: the conformance baseline."""
    w = dequant_qtensor(qt, torch.float32)
    return (x.to(torch.float32) @ w).to(x.dtype)
