"""QTensor: repacked quantized matmul weights as torch tensors.

The GGUF block formats interleave scales and codes per 32/256-element block.
At load each matmul weight (numpy shape (out=N, in=K), quantized along K) is
repacked into structure-of-arrays form with N contiguous:

    w[k, n] = (codes[k, n] - offset) * scales[k // gs, n] + adds[k // gs, n]

 - codes: int8 (K, N), or uint8 (K//2, N) with two 4-bit codes per byte when
   ``nibble`` is set. The packing is group-local: within each 32-element
   k-group the low nibbles of the 16 bytes hold elements 0..15 and the high
   nibbles elements 16..31.
 - scales: float32 (K // gs, N); adds: optional float32 (K // gs, N).

K-quants keep the compact factored form instead of the f32 planes:

    scale[g, n] = d[g // sb, n] * sc[g, n]
    add  [g, n] = -dmin[g // sb, n] * mn[g, n]
    code [k, n] = lo_nibble + (hi_plane << 4)

Repacking runs in numpy (the JAX package's ``_extract`` + ``_compact_kquant``
path, byte-identical planes) and the result moves to the device once.
``qt_codes``, ``qt_scales_adds`` and ``dequant_qtensor`` are the plain torch
decoders the kernels are held against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.quants import _f16, _unpack_scale_min_k4


@dataclass
class QTensor:
    codes: torch.Tensor                 # int8 (K, N) or uint8 (K//2, N) nibbles
    scales: torch.Tensor | None         # f32 (K//gs, N), full-precision form
    adds: torch.Tensor | None           # f32 (K//gs, N) additive term, or None
    group: int                          # gs
    offset: int                         # subtracted from codes before scaling
    nibble: bool                        # codes are 2-per-byte packed 4-bit
    K: int
    N: int
    ggml_type: GGMLType
    sc: torch.Tensor | None = None      # u8/i8 (K//gs, N) integer sub-scales
    mn: torch.Tensor | None = None      # u8 (K//gs, N) integer sub-mins
    d: torch.Tensor | None = None       # f32 (K//(gs·sb), N) superblock scale
    dmin: torch.Tensor | None = None    # f32 (K//(gs·sb), N) superblock min
    hi: torch.Tensor | None = None      # u8 packed high-bit planes of the codes
    hi_bits: int = 0                    # bits per element in `hi` (0 = none)
    sb: int = 0                         # groups per superblock (for d/dmin)

    PLANES = ("codes", "scales", "adds", "sc", "mn", "d", "dmin", "hi")

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.planes().values())

    def planes(self) -> dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in self.PLANES
                if getattr(self, n) is not None}


def _pack_nib4(codes_kn: np.ndarray) -> np.ndarray:
    """(K, N) uint8 values in [0,15] → (K//2, N), group-local layout."""
    K, N = codes_kn.shape
    c = codes_kn.reshape(K // 32, 32, N)
    return (c[:, :16] | (c[:, 16:] << 4)).astype(np.uint8).reshape(K // 2, N)


def _pack_bits(vals_kn: np.ndarray, bits: int) -> np.ndarray:
    """(K, N) uint8 values < 2**bits → (K·bits//8, N) bit-plane packing.

    Each 32-element k-group packs into 32·bits/8 bytes; element e of the group
    comes from byte e % nbytes, bit-field e // nbytes."""
    K, N = vals_kn.shape
    nbytes = 32 * bits // 8
    nf = 8 // bits
    v = vals_kn.reshape(K // 32, nf, nbytes, N).astype(np.uint8)
    out = np.zeros((K // 32, nbytes, N), np.uint8)
    for j in range(nf):
        out |= v[:, j] << (bits * j)
    return out.reshape(K * bits // 8, N)


def _extract(raw: np.ndarray, ttype: GGMLType, N: int, K: int):
    """Blocks (N, K/bs, type_size) → (codes (N, K/bs, bs) pre-pack, scales,
    adds or None, gs, offset, nibble) for the formats the port repacks."""
    t = GGMLType
    if ttype == t.Q8_0:
        b = raw.reshape(N, K // 32, 34)
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(N, K // 32)
        codes = b[:, :, 2:34].view(np.int8)
        return codes, d, None, 32, 0, False
    if ttype == t.Q4_K:
        b = raw.reshape(N, K // 256, 144)
        nb = N * K // 256
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(nb)
        dmin = _f16(b[:, :, 2:4].reshape(-1, 2)).reshape(nb)
        sc, mn = _unpack_scale_min_k4(b[:, :, 4:16].reshape(nb, 12))
        scales = (d[:, None] * sc).reshape(N, K // 256, 8)
        adds = (-(dmin[:, None] * mn)).reshape(N, K // 256, 8)
        qs = b[:, :, 16:144].reshape(N, K // 256, 4, 32)
        codes = np.concatenate([qs & 0x0F, qs >> 4], axis=3)       # (N,sb,4,64)
        codes = codes.reshape(N, K // 256, 256)
        return codes, scales.reshape(N, K // 32), adds.reshape(N, K // 32), 32, 0, True
    if ttype == t.Q6_K:
        b = raw.reshape(N, K // 256, 210)
        ql = b[:, :, 0:128]
        qh = b[:, :, 128:192]
        sc8 = b[:, :, 192:208].view(np.int8).astype(np.float32)
        d = _f16(b[:, :, 208:210].reshape(-1, 2)).reshape(N, K // 256, 1)
        scales = (d * sc8).reshape(N, K // 16)
        codes = np.empty((N, K // 256, 256), np.int8)
        for half, n0 in ((0, 0), (1, 128)):
            lq = ql[:, :, half * 64 : half * 64 + 64]
            hq = qh[:, :, half * 32 : half * 32 + 32]
            codes[:, :, n0 + 0 : n0 + 32] = (((lq[:, :, 0:32] & 0x0F) | (((hq >> 0) & 3) << 4)).astype(np.int16) - 32).astype(np.int8)
            codes[:, :, n0 + 32 : n0 + 64] = (((lq[:, :, 32:64] & 0x0F) | (((hq >> 2) & 3) << 4)).astype(np.int16) - 32).astype(np.int8)
            codes[:, :, n0 + 64 : n0 + 96] = (((lq[:, :, 0:32] >> 4) | (((hq >> 4) & 3) << 4)).astype(np.int16) - 32).astype(np.int8)
            codes[:, :, n0 + 96 : n0 + 128] = (((lq[:, :, 32:64] >> 4) | (((hq >> 6) & 3) << 4)).astype(np.int16) - 32).astype(np.int8)
        return codes, scales, None, 16, 0, False
    raise NotImplementedError(f"no repack for {ttype.name} in the port yet")


# formats repacked to the compact wire-bpw layout (factored superblock scales)
COMPACT = {GGMLType.Q4_K, GGMLType.Q6_K}
REPACKABLE = {GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K}


def _compact_kquant(raw: np.ndarray, ttype: GGMLType, N: int, K: int, codes):
    """Factor a K-quant into integer sub-scales × per-superblock f16 d/dmin
    (kept f32), codes as lo-nibble (+ hi bit-plane for Q6_K). scale = d·sc
    reproduces the f32 plane value-for-value."""
    if ttype == GGMLType.Q4_K:
        b = raw.reshape(N, K // 256, 144)
        nb = N * (K // 256)
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(N, K // 256)
        dmin = _f16(b[:, :, 2:4].reshape(-1, 2)).reshape(N, K // 256)
        sc, mn = _unpack_scale_min_k4(b[:, :, 4:16].reshape(nb, 12))
        return dict(
            codes=codes, hi=None, hi_bits=0, gs=32, offset=0, sb=8,
            sc=np.ascontiguousarray(sc.reshape(N, K // 32).T),
            mn=np.ascontiguousarray(mn.reshape(N, K // 32).T),
            d=np.ascontiguousarray(d.T, np.float32),
            dmin=np.ascontiguousarray(dmin.T, np.float32))
    # Q6_K: signed 8-bit sub-scales, no mins, codes offset by 32
    b = raw.reshape(N, K // 256, 210)
    sc8 = np.ascontiguousarray(b[:, :, 192:208]).view(np.int8)
    d = _f16(b[:, :, 208:210].reshape(-1, 2)).reshape(N, K // 256)
    q = (codes.astype(np.int16) + 32).astype(np.uint8)   # (K, N) 0..63
    return dict(
        codes=_pack_nib4(q & 0x0F), hi=_pack_bits(q >> 4, 2), hi_bits=2,
        gs=16, offset=32, sb=16,
        sc=np.ascontiguousarray(sc8.reshape(N, K // 16).T), mn=None,
        d=np.ascontiguousarray(d.T, np.float32), dmin=None)


def repack(raw: np.ndarray, ttype: GGMLType, out_in_shape: tuple[int, int],
           device="cpu") -> QTensor:
    """Repack GGUF packed bytes (row-major (N,K) blocks) into a QTensor on
    ``device``. Q8_0 keeps f32 scale planes; Q4_K and Q6_K factor into the
    compact form."""
    N, K = out_in_shape
    rawu8 = np.frombuffer(raw.tobytes(), np.uint8)
    codes, scales, adds, gs, offset, nibble = _extract(rawu8, ttype, N, K)
    codes = codes.reshape(N, K).T                       # (K, N)
    codes = _pack_nib4(codes.astype(np.uint8)) if nibble else codes.astype(np.int8)
    put = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(device)
    if ttype in COMPACT:
        c = _compact_kquant(rawu8, ttype, N, K, codes)
        return QTensor(
            codes=put(c["codes"]), scales=None, adds=None, group=c["gs"],
            offset=c["offset"], nibble=True, K=K, N=N, ggml_type=ttype,
            sc=put(c["sc"]), mn=put(c["mn"]), d=put(c["d"]),
            dmin=put(c["dmin"]), hi=put(c["hi"]), hi_bits=c["hi_bits"],
            sb=c["sb"])
    scales = np.ascontiguousarray(scales.reshape(N, K // gs).T, np.float32)
    return QTensor(codes=put(codes), scales=put(scales), adds=None, group=gs,
                   offset=offset, nibble=nibble, K=K, N=N, ggml_type=ttype)


def unpack_nib4(packed: torch.Tensor, K: int) -> torch.Tensor:
    """Inverse of _pack_nib4: (K//2, N) uint8 → (K, N) uint8 codes."""
    N = packed.shape[-1]
    p = packed.reshape(K // 32, 16, N)
    return torch.cat([p & 0x0F, p >> 4], dim=1).reshape(K, N)


def unpack_bits(packed: torch.Tensor, bits: int, K: int) -> torch.Tensor:
    """Inverse of _pack_bits."""
    N = packed.shape[-1]
    nbytes = 32 * bits // 8
    nf = 8 // bits
    mask = (1 << bits) - 1
    p = packed.reshape(K // 32, nbytes, N)
    return torch.cat([(p >> (bits * j)) & mask for j in range(nf)],
                     dim=1).reshape(K, N)


def qt_scales_adds(qt: QTensor):
    """(scales, adds) f32 planes, reconstructed from the factored compact form
    when present (f32 product of an exact f16 superblock scale and a small
    integer, bit-identical to the planes)."""
    if qt.d is None:
        return qt.scales, qt.adds
    scales = qt.d.repeat_interleave(qt.sb, dim=0) * qt.sc.to(torch.float32)
    adds = None
    if qt.mn is not None:
        adds = -(qt.dmin.repeat_interleave(qt.sb, dim=0)
                 * qt.mn.to(torch.float32))
    return scales, adds


def qt_codes(qt: QTensor) -> torch.Tensor:
    """Unpacked integer codes (K, N): lo nibble + hi bit-plane composed."""
    codes = unpack_nib4(qt.codes, qt.K) if qt.nibble else qt.codes
    if qt.hi_bits:
        hi = unpack_bits(qt.hi, qt.hi_bits, qt.K)
        codes = codes.to(torch.int32) + (hi.to(torch.int32) << 4)
    return codes


def dequant_qtensor(qt: QTensor, dtype=None) -> torch.Tensor:
    """Plain dequant of a QTensor → (K, N) tensor (f32 unless ``dtype``)."""
    q = qt_codes(qt).to(torch.float32) - qt.offset
    gs = qt.group
    scales, adds = qt_scales_adds(qt)
    w = q.reshape(qt.K // gs, gs, qt.N) * scales[:, None, :]
    if adds is not None:
        w = w + adds[:, None, :]
    w = w.reshape(qt.K, qt.N)
    return w.to(dtype) if dtype is not None else w
