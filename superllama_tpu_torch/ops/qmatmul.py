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
from typing import NamedTuple

import torch

from ..gguf.constants import GGMLType
from . import _build
from .qtensor import QTensor, dequant_qtensor, qt_codes, qt_scales_adds
from .ref import quant_scale

# weight formats the kernels decode (csrc FMT ids)
_FMT = {GGMLType.Q8_0: 0, GGMLType.Q4_K: 1, GGMLType.Q6_K: 2}
_UNIT = {0: 32, 1: 256, 2: 256}   # K elements per split unit
_UNIT_BYTES = {0: 36, 1: 152, 2: 212}   # weight bytes of a column per unit
_QMV_TILES = (128, 64, 32)        # qmv column tiles, widest first
_QMV_MAX_CLUSTER = 8              # blocks of a cluster along K (the portable size)
_QMV_SMS = 132                    # SMs of the H100 the plan fills
_QMV_SM_SMEM = 228 * 1024         # shared memory of an SM (1 KB of it reserved a block)
_QMV_BLOCKS_SM = 2                # the kernel's launch bounds: two blocks an SM
# blocks of a cluster size resident at once on the H100 at two blocks an SM
# (cudaOccupancyMaxActiveClusters x size: the GPCs' SM counts leave some
# SMs without a whole cluster)
_QMV_CLUSTER_RESIDENT = {1: 264, 2: 264, 3: 237, 4: 248, 5: 235, 6: 234, 7: 224, 8: 240}
_QMV_BLOCK_COST = 16384           # a block's fixed cost (prologue, the sums) in bytes read
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


class QmvPlan(NamedTuple):
    """The qmv kernel's grid: column tile ``bn``, a cluster of ``cl`` blocks
    along K, ``per`` K units (superblocks; Q8_0 groups) a rank, ``blocks``
    in the grid, ``smem`` bytes of shared memory a block."""
    bn: int
    cl: int
    per: int
    blocks: int
    smem: int


def _qmv_smem(fmt: int, bn: int, rows: int = _QMV_MAX_ROWS) -> int:
    """Shared memory a qmv block of up to ``rows`` rows takes: the ring of
    weight tiles (a stage more for Q4_K at 8 rows), x's codes, sx and xs
    for a chunk of 32-groups, the barriers. Mirrors
    ``Geo<FMT, BN, NB>::SMEM`` of csrc/qmv.cu."""
    nb = 1 if rows <= 8 else 2
    gt = (8 if bn == 32 else 4) if fmt == 0 else 8          # 32-groups a tile
    nst, xg, qg = (2, 32, 2) if fmt == 2 else (4 if fmt == 1 and nb == 1 else 3, 64, 1)
    row = 32 if bn == 32 else bn + 32                       # code-plane row stride
    if fmt == 0:
        stage = gt * 32 * row + gt * bn * 4
    elif fmt == 1:
        stage = gt * 16 * row + 2 * gt * bn + 2 * bn * 4
    else:
        stage = gt * 16 * row + gt * 8 * row + 2 * gt * bn + bn * 4
    return nst * stage + xg * nb * 256 + xg * qg * 8 * nb * 8 + 2 * nst * 8


def qmv_plan(fmt: int, K: int, N: int) -> QmvPlan:
    """The qmv kernel's grid for a (K, N) weight of format ``fmt``: the
    column tile and the K split (a cluster of at most 8 blocks, each rank
    at least one unit) whose rounds of resident blocks (two an SM of the
    H100's 132, fewer for clusters that do not tile its GPCs) times a
    block's cost (its weight bytes, its x at 8 rows, a fixed
    ``_QMV_BLOCK_COST``) are least, among those of at least 132 blocks
    where any is; ties go to the wider tile, then the fewer blocks.
    Depends on (fmt, K, N) only, so a row's sums do not depend on how many
    rows share the call."""
    n_units = K // _UNIT[fmt]
    best = None
    for bn in _QMV_TILES:
        tiles = -(-N // bn)
        smem = max(_qmv_smem(fmt, bn, rows) for rows in (8, _QMV_MAX_ROWS))
        per_sm = min(_QMV_BLOCKS_SM, _QMV_SM_SMEM // (smem + 1024))
        for cl in range(1, min(_QMV_MAX_CLUSTER, n_units) + 1):
            per = -(-n_units // cl)
            if -(-n_units // per) != cl:   # a rank would hold no unit
                continue
            blocks = tiles * cl
            resident = _QMV_CLUSTER_RESIDENT[cl] * per_sm // _QMV_BLOCKS_SM
            block = per * (bn * _UNIT_BYTES[fmt] + _UNIT[fmt] * 16)   # weight, x at 8 rows
            cost = -(-blocks // resident) * (block + _QMV_BLOCK_COST)
            key = (blocks < _QMV_SMS, cost, -bn, blocks)
            if best is None or key < best[0]:
                best = (key, QmvPlan(bn, cl, per, blocks, smem))
    return best[1]


def qmv(x2: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """int8-activation GEMV (M <= 16 per launch). CUDA: the qmv kernel, one
    launch that quantizes x itself; CPU: ``qmv_plain``."""
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
    fn = _lib("qmv", [_I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _P, _I, _P])
    if x2.data_ptr() % 16:   # the kernel reads x rows in 8- and 16-byte words
        x2 = x2.clone()
    plan = qmv_plan(fmt, K, qt.N)
    out = torch.empty((M, qt.N), dtype=out_dtype, device=x2.device)
    err = fn(fmt, M, K, qt.N, x2.data_ptr(), int(x2.dtype == torch.bfloat16),
             _ptr(qt.codes), _ptr(qt.hi), _ptr(qt.scales), _ptr(qt.sc), _ptr(qt.mn),
             _ptr(qt.d), _ptr(qt.dmin), plan.bn, plan.cl, plan.per, out.data_ptr(),
             int(out_dtype == torch.bfloat16), _build.stream_ptr(x2.device))
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
