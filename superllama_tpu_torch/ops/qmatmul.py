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
``csrc/qmv.cu`` and ``csrc/qmm.cu`` on CUDA tensors, for every format of
``REPACKABLE``, and run their plain PyTorch versions (``qmv_plain``,
``qmm_plain``) only on CPU tensors. ``_FMT`` describes each type's repacked
planes (``Layout``: code width, hi bits, group size, scale source, adds,
offset). Both kernels read them in the same nine layouts, one table
(``qmv_fmt``): 0 int8 gs 32 (Q8_0 and the seven gs-32 int8 formats without
adds, on Q8_0's path), 1 Q4_K, 2 Q6_K, 3 int8 gs 32 with adds, 4 int8 gs
16, 5 int8 gs 8 with adds, 6 int8 gs 256, 7 nibbles with f32 scales, 8
Q5_K; group size is a compile-time parameter of each, and so are adds
(qmm's layouts 4 and 7 have an instantiation with and one without). Each
wrapper counts its launches in ``<wrapper>.launches``, and those of the
twenty formats beyond Q8_0, Q4_K and Q6_K also by family (``family``) in
``<wrapper>.launches_i8`` (int8 codes), ``launches_nib`` (Q4_0, Q4_1) and
``launches_q5k``.
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


class Layout(NamedTuple):
    """What the kernels read of a type's repacked planes (ops/qtensor.py):
    ``code_bits`` 8 (int8 codes (K, N)) or 4 (nibbles (K/2, N), group-local),
    ``hi_bits`` of a hi plane above the nibbles, ``group`` weights a scale,
    ``scales`` "plane" (f32 (K/gs, N)) or "superblock" (u8 / i8 sub-scales
    times an f32 d a superblock), ``adds`` an additive term (the f32 adds
    plane, or the mins times dmin), ``offset`` subtracted from the codes."""
    code_bits: int
    hi_bits: int
    group: int
    scales: str
    adds: bool
    offset: int


def layout(qt: QTensor) -> Layout:
    """A QTensor's layout, from its own fields."""
    return Layout(4 if qt.nibble else 8, qt.hi_bits, qt.group,
                  "superblock" if qt.sc is not None else "plane",
                  qt.adds is not None or qt.mn is not None, qt.offset)


_I8 = Layout(8, 0, 32, "plane", False, 0)
# each type's layout (tests hold them to ``layout`` of the type's repack)
_FMT = {t: _I8 for t in (GGMLType.Q8_0, GGMLType.Q5_0, GGMLType.MXFP4, GGMLType.IQ4_NL,
                         GGMLType.IQ4_XS, GGMLType.IQ2_XXS, GGMLType.IQ3_XXS, GGMLType.IQ3_S)}
_FMT.update({t: _I8._replace(adds=True) for t in (GGMLType.Q5_1, GGMLType.IQ1_S)})
_FMT.update({t: _I8._replace(group=16) for t in (GGMLType.Q3_K, GGMLType.IQ2_XS,
                                                  GGMLType.IQ2_S)})
_FMT.update({t: _I8._replace(group=256) for t in (GGMLType.Q8_K, GGMLType.TQ1_0,
                                                   GGMLType.TQ2_0)})
_FMT.update({
    GGMLType.Q2_K: _I8._replace(group=16, adds=True),
    GGMLType.IQ1_M: _I8._replace(group=8, adds=True),
    GGMLType.Q4_0: Layout(4, 0, 32, "plane", False, 8),
    GGMLType.Q4_1: Layout(4, 0, 32, "plane", True, 0),
    GGMLType.Q4_K: Layout(4, 0, 32, "superblock", True, 0),
    GGMLType.Q5_K: Layout(4, 1, 32, "superblock", True, 0),
    GGMLType.Q6_K: Layout(4, 2, 16, "superblock", False, 32)})


def family(ttype: GGMLType, lay: Layout) -> int:
    """The launch counters' family of a type: 0-2 Q8_0 / Q4_K / Q6_K, 3
    int8 codes, 4 nibbles with f32 scales, 5 Q5_K."""
    if ttype == GGMLType.Q8_0:
        return 0
    if lay.scales == "superblock":
        return {0: 1, 2: 2, 1: 5}[lay.hi_bits]
    return 4 if lay.code_bits == 4 else 3


def qmv_fmt(lay: Layout) -> int:
    """The kernels' layout of a type (csrc/qmv.cu and csrc/qmm.cu FMT): 0
    int8 gs 32, 1 Q4_K, 2 Q6_K, 3 int8 gs 32 with adds, 4 int8 gs 16, 5
    int8 gs 8, 6 int8 gs 256, 7 nibbles with f32 scales, 8 Q5_K."""
    if lay.scales == "superblock":
        return {0: 1, 2: 2, 1: 8}[lay.hi_bits]
    if lay.code_bits == 4:
        return 7
    return {8: 5, 16: 4, 256: 6}.get(lay.group, 3 if lay.adds or lay.offset else 0)


_FAMILY = {3: "i8", 4: "nib", 5: "q5k"}   # the families' launch counters
_QMV_UNIT = (32, 256, 256, 32, 32, 32, 256, 32, 256)    # K elements a split unit, by qmv FMT
# weight bytes of a column a unit (adds planes counted where the format may have one)
_QMV_UNIT_BYTES = (36, 152, 212, 40, 48, 64, 260, 24, 184)
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
_QMV_X_COST = 32                  # a K element of x in bytes read: 16 at 8 bf16 rows, twice
                                  # that with the quantizer's work (fit to the H100 readings
                                  # of chip_smoke.py --qmv-clusters --sweep)
_QMV_MAX_ROWS = 16
_QMM_BN = 128                     # columns per qmm tensor-core block
_QMM_BK = 128                     # k-tile of the qmm tensor-core kernel
_QMM_RESIDENT = 264               # blocks resident at once: two an SM of the H100
_QMM_SMS = 132                    # SMs of the H100
_QMM_SHORT = 16                   # k-tiles a block up to which one block a SM wins
_QMM_BM = 32                      # rows per qmm tensor-core block
_QMM_BLOCK_SMEM = 113 * 1024      # a block's share of an SM at two blocks an SM
# the tensor-core kernel's instantiations: (layout, an f32 adds plane)
_QMM_INSTANCES = ((0, False), (1, False), (2, False), (3, True), (4, False), (4, True),
                  (5, True), (6, False), (7, False), (7, True), (8, False))

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
    """Validate a CUDA launch; returns the weight's layout (``qmv_fmt``)."""
    lay = _FMT.get(qt.ggml_type)
    if lay is None:
        raise NotImplementedError(f"no CUDA kernel for {qt.ggml_type.name} weights")
    if layout(qt) != lay:
        raise ValueError(f"{qt.ggml_type.name} weight in layout {layout(qt)}, "
                         f"the kernels read {lay}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be f32 or bf16, got {x2.dtype}")
    if qt.N % 4 or qt.K % _QMV_UNIT[qmv_fmt(lay)] or x2.shape[1] != qt.K:
        raise ValueError(f"unsupported shape: x {tuple(x2.shape)}, weight "
                         f"(K={qt.K}, N={qt.N}) {qt.ggml_type.name}")
    for name, plane in qt.planes().items():
        if plane.device != x2.device or not plane.is_contiguous():
            raise ValueError(f"weight plane {name} must be a contiguous "
                             f"tensor on {x2.device}")
    return qmv_fmt(lay)


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
    along K, ``per`` K units (superblocks; 32-groups) a rank, ``blocks``
    in the grid, ``smem`` bytes of shared memory a block."""
    bn: int
    cl: int
    per: int
    blocks: int
    smem: int


def _qmv_smem(fmt: int, bn: int, rows: int = _QMV_MAX_ROWS) -> int:
    """Shared memory a qmv block of up to ``rows`` rows takes: the ring of
    weight tiles, x's codes, sx and xs for a chunk of 32-groups, the
    barriers. Mirrors ``Geo<FMT, BN, NB>::SMEM`` of csrc/qmv.cu."""
    nb = 1 if rows <= 8 else 2
    compact, mins = fmt in (1, 2, 8), fmt in (1, 8)
    nib = compact or fmt == 7
    hib = {2: 2, 8: 1}.get(fmt, 0)
    gs = {2: 16, 4: 16, 5: 8, 6: 256}.get(fmt, 32)
    kw = 8 // (bn // 32)                                    # k warps
    gt = 8 if nib or bn == 32 else 4                        # 32-groups a tile
    nst = 2 if fmt == 2 or (fmt == 5 and bn == 128) else 4 if fmt == 1 and nb == 1 else 3
    xg = 16 if fmt == 5 else 32 if fmt in (2, 4, 7, 8) else 64   # 32-groups of x a chunk
    qg = 1 if gs >= 32 else 32 // gs                        # quantizer groups a 32-group
    xq = xg // 8 if gs == 256 else xg * qg
    row = 32 if bn == 32 else bn + 32                       # code-plane row stride
    sr = kw if fmt == 6 else 0 if compact else gt * qg      # f32 scale rows
    stage = (gt * (16 if nib else 32) * row + gt * 4 * hib * row
             + ((2 if fmt == 2 else 1) * gt * bn if compact else 0) + (gt * bn if mins else 0)
             + (bn * 4 if compact else 0) + (bn * 4 if mins else 0)
             + sr * bn * 4 * (2 if fmt in (3, 4, 5, 7) else 1))
    return nst * stage + xg * nb * 256 + xq * 8 * nb * 8 + 2 * nst * 8


def qmv_plan(fmt: int, K: int, N: int) -> QmvPlan:
    """The qmv kernel's grid for a (K, N) weight of qmv format ``fmt``: the
    column tile and the K split (a cluster of at most 8 blocks, each rank
    at least one unit) whose rounds of resident blocks (two an SM of the
    H100's 132, fewer for clusters that do not tile its GPCs) times a
    block's cost (its weight bytes, its x and its quantizing,
    ``_QMV_X_COST`` a K element, a fixed ``_QMV_BLOCK_COST``) are least,
    among those of at least 132 blocks where any is; ties go to the wider
    tile, then the fewer blocks. Depends on (fmt, K, N) only, so a row's
    sums do not depend on how many rows share the call."""
    unit = _QMV_UNIT[fmt]
    n_units = K // unit
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
            block = per * (bn * _QMV_UNIT_BYTES[fmt] + unit * _QMV_X_COST)   # weight, x
            cost = -(-blocks // resident) * (block + _QMV_BLOCK_COST)
            key = (blocks < _QMV_SMS, cost, -bn, blocks)
            if best is None or key < best[0]:
                best = (key, QmvPlan(bn, cl, per, blocks, smem))
    return best[1]


def _count(fn, qt: QTensor) -> None:
    fn.launches += 1
    fam = _FAMILY.get(family(qt.ggml_type, _FMT[qt.ggml_type]))
    if fam is not None:
        setattr(fn, f"launches_{fam}", getattr(fn, f"launches_{fam}") + 1)


def qmv(x2: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """int8-activation GEMV (M <= 16 per launch). CUDA: the qmv kernel of
    the weight's format, one launch that quantizes x itself; CPU:
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
    fn = _lib("qmv", [_I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _P, _I, _P])
    if x2.data_ptr() % 16:   # the kernel reads x rows in 8- and 16-byte words
        x2 = x2.clone()
    plan = qmv_plan(fmt, K, qt.N)
    out = torch.empty((M, qt.N), dtype=out_dtype, device=x2.device)
    err = fn(fmt, M, K, qt.N, x2.data_ptr(), int(x2.dtype == torch.bfloat16),
             _ptr(qt.codes), _ptr(qt.hi), _ptr(qt.scales), _ptr(qt.sc), _ptr(qt.mn),
             _ptr(qt.d), _ptr(qt.dmin), _ptr(qt.adds), qt.offset, plan.bn, plan.cl, plan.per,
             out.data_ptr(), int(out_dtype == torch.bfloat16), _build.stream_ptr(x2.device))
    _build.check(err, "qmv")
    _count(qmv, qt)
    return out


qmv.launches = 0
qmv.launches_i8 = qmv.launches_nib = qmv.launches_q5k = 0


# --- qmm: fused dequant + matmul ---------------------------------------------


def qmm_plain(x2: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """Plain version of the qmm kernel: dequantize in f32, round to the
    compute type (bf16 for bf16 x, else f32), multiply with f32
    accumulation."""
    cdt = torch.bfloat16 if x2.dtype == torch.bfloat16 else torch.float32
    w = dequant_qtensor(qt).to(cdt).to(torch.float32)
    return (x2.to(cdt).to(torch.float32) @ w).to(out_dtype)


def _qmm_smem(fmt: int, adds: bool) -> tuple[int, int]:
    """(ring stages, shared bytes) of a tensor-core qmm block of layout
    ``fmt`` (with an f32 adds plane or not): the stage holds the k-tile's x
    rows, its code rows and only the scale, add, hi and sub-scale rows the
    layout reads; as many stages as fit in a block's share at two blocks an
    SM (Q4_K keeps its 4). Mirrors ``Stage<L, ADDS>`` of csrc/qmm.cu."""
    compact, kq = fmt in (1, 2, 8), fmt in (1, 8)
    i8 = fmt in (0, 3, 4, 5, 6)
    gs = {2: 16, 4: 16, 5: 8, 6: 256}.get(fmt, 32)
    bk, crow = _QMM_BK, _QMM_BN + 16
    code_rows = bk if i8 else bk // 2
    hi_rows = {2: bk // 4, 8: bk // 8}.get(fmt, 0)
    sc_rows = bk // 32 if kq else bk // 16 if fmt == 2 else 0
    scl_rows = 0 if compact else 1 if gs == 256 else bk // gs
    stage = (_QMM_BM * (bk * 2 + 16) + code_rows * crow + hi_rows * crow
             + sc_rows * _QMM_BN + (bk // 32 * _QMM_BN if kq else 0)
             + (_QMM_BN * 4 if compact else 0) + (_QMM_BN * 4 if kq else 0)
             + scl_rows * (2 if adds else 1) * _QMM_BN * 4)
    nst = 4 if fmt == 1 else _QMM_BLOCK_SMEM // (stage + 16)
    return nst, nst * stage + 2 * nst * 8


def qmm_plan(K: int, N: int) -> tuple[int, int]:
    """(n_split, tiles_per_split) of the tensor-core qmm kernel's K split, in
    k-tiles of 128 (a K of 32-element blocks may end in a shorter one).
    One block a SM where that leaves each block at most ``_QMM_SHORT``
    k-tiles: the largest split of at most 132 blocks (a second block on an
    SM then gains less than another split costs: its partials, its share
    of the reduce, its ring's fill). Else N's column blocks alone when they
    fill the resident slots (two blocks an SM); else the split, up to one
    resident wave of blocks, whose waves times k-tiles a block is least
    (the smallest such: each split adds M x N partials). Measured against
    every power-of-two split on the H100 (``chip_smoke.py --qmm-plans``).
    Depends on (K, N) only, so a row's sums do not depend on M."""
    n_tiles = -(-K // _QMM_BK)
    n_col_blocks = -(-N // _QMM_BN)
    valid = [sp for sp in range(1, n_tiles + 1) if -(-n_tiles // -(-n_tiles // sp)) == sp]
    alone = [sp for sp in valid if n_col_blocks * sp <= _QMM_SMS]
    if alone and -(-n_tiles // alone[-1]) <= _QMM_SHORT:
        return alone[-1], -(-n_tiles // alone[-1])

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
        fn = _lib("qmm", [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _P, _P, _I, _P], entry="qmm_tc")
        out = torch.empty((M, qt.N), dtype=out_dtype, device=x2.device)
        if x2.data_ptr() % 16:   # x rows go in by 16-byte copies
            x2 = x2.clone()
        n_split, per = qmm_plan(K, qt.N)
        part = (torch.empty((n_split, M, qt.N), dtype=torch.float32, device=x2.device)
                if n_split > 1 else None)
        err = fn(fmt, M, K, qt.N, x2.data_ptr(), _ptr(qt.codes), _ptr(qt.hi),
                 _ptr(qt.scales), _ptr(qt.sc), _ptr(qt.mn), _ptr(qt.d), _ptr(qt.dmin),
                 _ptr(qt.adds), qt.group, qt.offset, n_split, per, _ptr(part),
                 out.data_ptr(), out_bf16, _build.stream_ptr(x2.device))
    else:
        fn = _lib("qmm", [_I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _P, _I, _P])
        out = torch.empty((M, qt.N), dtype=out_dtype, device=x2.device)
        err = fn(fmt, M, K, qt.N, x2.data_ptr(), int(x2.dtype == torch.bfloat16),
                 _ptr(qt.codes), _ptr(qt.hi), _ptr(qt.scales), _ptr(qt.sc),
                 _ptr(qt.mn), _ptr(qt.d), _ptr(qt.dmin), _ptr(qt.adds), qt.group,
                 qt.offset, out.data_ptr(), out_bf16, _build.stream_ptr(x2.device))
    _build.check(err, "qmm")
    _count(qmm, qt)
    return out


qmm.launches = 0
qmm.launches_i8 = qmm.launches_nib = qmm.launches_q5k = 0


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
