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

Every format of ``REPACKABLE`` (the JAX package's 23) maps onto that form:
int8 codes for the 32-wide formats, the i-quants, Q2_K, Q3_K, Q8_K and the
ternary ones (gs 8, 16, 32 or 256, adds for Q5_1, Q2_K, IQ1_S and IQ1_M),
nibbles for Q4_0 (offset 8) and Q4_1 (adds). The K-quants of ``COMPACT``
(Q4_K, Q5_K, Q6_K) keep the compact factored form instead of the f32
planes:

    scale[g, n] = d[g // sb, n] * sc[g, n]
    add  [g, n] = -dmin[g // sb, n] * mn[g, n]
    code [k, n] = lo_nibble + (hi_plane << 4)      (hi_bits 0, 1 or 2)

Repacking runs in the native library for Q4_0, Q8_0 and the three
K-quants, in numpy otherwise (the JAX package's ``_extract`` +
``_compact_kquant`` path; the two give byte-identical planes), and the
result moves to the device once.
``qt_codes``, ``qt_scales_adds`` and ``dequant_qtensor`` are the plain torch
decoders the kernels are held against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.constants import KVALUES_IQ4NL, KVALUES_MXFP4, GGMLType
from ..gguf.quants import (
    _IQ1_DELTA,
    _KSIGNS,
    _e8m0_to_fp32_half,
    _f16,
    _iq_grids,
    _q3k_unpack_scales,
    _unpack_scale_min_k4,
)


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
    adds or None, gs, offset, nibble): the JAX package's ``_extract``."""
    t = GGMLType
    if ttype == t.Q4_0:
        b = raw.reshape(N, K // 32, 18)
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(N, K // 32)
        qs = b[:, :, 2:18]
        codes = np.concatenate([qs & 0x0F, qs >> 4], axis=2)      # (N, K/32, 32)
        return codes, d, None, 32, 8, True
    if ttype == t.Q4_1:
        b = raw.reshape(N, K // 32, 20)
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(N, K // 32)
        m = _f16(b[:, :, 2:4].reshape(-1, 2)).reshape(N, K // 32)
        qs = b[:, :, 4:20]
        codes = np.concatenate([qs & 0x0F, qs >> 4], axis=2)
        return codes, d, m, 32, 0, True
    if ttype == t.Q5_0:
        b = raw.reshape(N, K // 32, 22)
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(N, K // 32)
        qh = np.ascontiguousarray(b[:, :, 2:6]).view("<u4")[..., 0].astype(np.uint32)
        qs = b[:, :, 6:22]
        j = np.arange(16, dtype=np.uint32)
        lo = ((qs & 0x0F) | (((qh[..., None] >> j) << 4) & 0x10)).astype(np.int16) - 16
        hi = ((qs >> 4) | ((qh[..., None] >> (j + 12)) & 0x10)).astype(np.int16) - 16
        codes = np.concatenate([lo, hi], axis=2).astype(np.int8)
        return codes, d, None, 32, 0, False
    if ttype == t.Q5_1:
        b = raw.reshape(N, K // 32, 24)
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(N, K // 32)
        m = _f16(b[:, :, 2:4].reshape(-1, 2)).reshape(N, K // 32)
        qh = np.ascontiguousarray(b[:, :, 4:8]).view("<u4")[..., 0].astype(np.uint32)
        qs = b[:, :, 8:24]
        j = np.arange(16, dtype=np.uint32)
        lo = ((qs & 0x0F) | (((qh[..., None] >> j) << 4) & 0x10)).astype(np.uint8)
        hi = ((qs >> 4) | ((qh[..., None] >> (j + 12)) & 0x10)).astype(np.uint8)
        codes = np.concatenate([lo, hi], axis=2).astype(np.int8)
        return codes, d, m, 32, 0, False
    if ttype == t.Q8_0:
        b = raw.reshape(N, K // 32, 34)
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(N, K // 32)
        codes = b[:, :, 2:34].view(np.int8)
        return codes, d, None, 32, 0, False
    if ttype == t.MXFP4:
        b = raw.reshape(N, K // 32, 17)
        d = _e8m0_to_fp32_half(b[:, :, 0].reshape(-1)).reshape(N, K // 32)
        qs = b[:, :, 1:17]
        lut = np.array(KVALUES_MXFP4, np.int8)
        codes = np.concatenate([lut[qs & 0x0F], lut[qs >> 4]], axis=2)
        return codes, d, None, 32, 0, False
    if ttype == t.IQ4_NL:
        b = raw.reshape(N, K // 32, 18)
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(N, K // 32)
        qs = b[:, :, 2:18]
        lut = np.array(KVALUES_IQ4NL, np.int8)
        codes = np.concatenate([lut[qs & 0x0F], lut[qs >> 4]], axis=2)
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
    if ttype == t.Q5_K:
        b = raw.reshape(N, K // 256, 176)
        nb = N * K // 256
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(nb)
        dmin = _f16(b[:, :, 2:4].reshape(-1, 2)).reshape(nb)
        sc, mn = _unpack_scale_min_k4(b[:, :, 4:16].reshape(nb, 12))
        scales = (d[:, None] * sc).reshape(N, K // 32)
        adds = (-(dmin[:, None] * mn)).reshape(N, K // 32)
        qh = b[:, :, 16:48]
        ql = b[:, :, 48:176].reshape(N, K // 256, 4, 32)
        codes = np.empty((N, K // 256, 4, 64), np.int8)
        for j in range(4):
            h1 = np.where(qh & (1 << (2 * j)), 16, 0)
            h2 = np.where(qh & (2 << (2 * j)), 16, 0)
            codes[:, :, j, :32] = ((ql[:, :, j] & 0x0F) + h1).astype(np.int8)
            codes[:, :, j, 32:] = ((ql[:, :, j] >> 4) + h2).astype(np.int8)
        return codes.reshape(N, K // 256, 256), scales, adds, 32, 0, False
    if ttype == t.Q6_K:
        b = raw.reshape(N, K // 256, 210)
        nb = N * K // 256
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
    if ttype == t.Q2_K:
        b = raw.reshape(N, K // 256, 84)
        nb = N * K // 256
        sb = b[:, :, 0:16]
        qs = b[:, :, 16:80]
        d = _f16(b[:, :, 80:82].reshape(-1, 2)).reshape(N, K // 256, 1)
        dmin = _f16(b[:, :, 82:84].reshape(-1, 2)).reshape(N, K // 256, 1)
        scales = (d * (sb & 0x0F)).reshape(N, K // 16)
        adds = (-(dmin * (sb >> 4))).reshape(N, K // 16)
        codes = np.empty((N, K // 256, 256), np.int8)
        pos = 0
        i_s = 0
        for n0 in (0, 128):
            q = qs[:, :, n0 // 4 : n0 // 4 + 32]
            for shift in (0, 2, 4, 6):
                for half in (0, 16):
                    codes[:, :, pos : pos + 16] = (q[:, :, half : half + 16] >> shift) & 3
                    pos += 16
        return codes, scales, adds, 16, 0, False
    if ttype == t.Q3_K:
        b = raw.reshape(N, K // 256, 110)
        nb = N * K // 256
        hm = b[:, :, 0:32]
        qs = b[:, :, 32:96]
        sc6 = _q3k_unpack_scales(b[:, :, 96:108].reshape(nb, 12)).astype(np.float32) - 32.0
        d = _f16(b[:, :, 108:110].reshape(-1, 2)).reshape(N, K // 256, 1)
        scales = (d * sc6.reshape(N, K // 256, 16)).reshape(N, K // 16)
        codes = np.empty((N, K // 256, 256), np.int8)
        pos = 0
        m = 1
        for n0 in (0, 128):
            q = qs[:, :, n0 // 4 : n0 // 4 + 32]
            for shift in (0, 2, 4, 6):
                for half in (0, 16):
                    low = ((q[:, :, half : half + 16] >> shift) & 3).astype(np.int8)
                    hbit = np.where(hm[:, :, half : half + 16] & m, 0, 4).astype(np.int8)
                    codes[:, :, pos : pos + 16] = low - hbit
                    pos += 16
                m <<= 1
            m = m  # m continues across halves (1..128 over 8 shifts)
        return codes, scales, None, 16, 0, False
    if ttype == t.IQ4_XS:
        # per-32 6-bit scales (4 low bits in scales_l nibbles, 2 high bits in
        # scales_h) × the IQ4_NL codebook (ggml-quants.c dequantize_row_iq4_xs)
        nsb_ = N * (K // 256)
        b = raw.reshape(nsb_, 136)
        d = _f16(b[:, 0:2]).reshape(nsb_)
        scales_h = np.ascontiguousarray(b[:, 2:4]).view("<u2") \
            .reshape(nsb_).astype(np.uint32)
        scales_l = b[:, 4:8]
        qs = b[:, 8:136].reshape(nsb_, 8, 16)
        ib = np.arange(8)
        ls = (((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F).astype(np.uint32)
              | (((scales_h[:, None] >> (2 * ib)) & 3) << 4))
        scales = d[:, None] * (ls.astype(np.float32) - 32.0)      # (nsb, 8)
        lut = np.array(KVALUES_IQ4NL, np.int8)
        codes = np.concatenate([lut[qs & 0x0F], lut[qs >> 4]], axis=2)
        return (codes.reshape(N, K // 256, 256), scales.reshape(N, K // 32),
                None, 32, 0, False)
    if ttype == t.Q8_K:
        # f32 per-256 scale + raw int8 codes (block_q8_K, ggml-common.h);
        # bsums are activation-side metadata — not needed for weight matmul
        b = raw.reshape(N, K // 256, 292)
        d = np.ascontiguousarray(b[:, :, 0:4]).view("<f4").reshape(N, K // 256)
        codes = b[:, :, 4:260].view(np.int8)
        return codes, d, None, 256, 0, False
    if ttype == t.TQ1_0:
        # ternary, 5 trits/byte base-3 packing (dequantize_row_tq1_0)
        nsb_ = N * (K // 256)
        b = raw.reshape(nsb_, 54)
        qs, qh = b[:, 0:48], b[:, 48:52]
        d = _f16(b[:, 52:54]).reshape(nsb_)
        codes = np.empty((nsb_, 256), np.int8)
        pow3 = np.array([1, 3, 9, 27, 81], dtype=np.uint16)
        pos = 0
        for j, width in ((0, 32), (32, 16)):
            seg = qs[:, j : j + width].astype(np.uint16)
            for m in range(5):
                q = ((seg * pow3[m]) & 0xFF) * 3 // 256
                codes[:, pos : pos + width] = q.astype(np.int8) - 1
                pos += width
        seg = qh.astype(np.uint16)
        for m in range(4):
            q = ((seg * pow3[m]) & 0xFF) * 3 // 256
            codes[:, pos : pos + 4] = q.astype(np.int8) - 1
            pos += 4
        return (codes.reshape(N, K // 256, 256), d.reshape(N, K // 256),
                None, 256, 0, False)
    if ttype == t.TQ2_0:
        # ternary, 4 crumbs/byte (dequantize_row_tq2_0)
        nsb_ = N * (K // 256)
        b = raw.reshape(nsb_, 66)
        qs = b[:, 0:64]
        d = _f16(b[:, 64:66]).reshape(nsb_)
        codes = np.empty((nsb_, 256), np.int8)
        pos = 0
        for j in (0, 32):
            seg = qs[:, j : j + 32]
            for shift in (0, 2, 4, 6):
                codes[:, pos : pos + 32] = ((seg >> shift) & 3).astype(np.int8) - 1
                pos += 32
        return (codes.reshape(N, K // 256, 256), d.reshape(N, K // 256),
                None, 256, 0, False)
    # --- codebook i-quants: codes = signed grid values (int8), scales carry
    # the block scale; IQ1 additionally folds dl*delta into adds ---
    def _sgn_i8(sign_bytes):
        bits = (sign_bytes[..., None] >> np.arange(8, dtype=np.uint8)) & 1
        return (1 - 2 * bits.astype(np.int16))

    nsb = N * (K // 256)
    if ttype == t.IQ2_XXS:
        b = raw.reshape(nsb, 66)
        d = _f16(b[:, 0:2]).reshape(nsb)
        q16 = np.ascontiguousarray(b[:, 2:66]).view("<u2").reshape(nsb, 8, 4).astype(np.uint32)
        aux0 = q16[:, :, 0] | (q16[:, :, 1] << 16)
        aux1 = q16[:, :, 2] | (q16[:, :, 3] << 16)
        scales = (d[:, None] * (0.5 + (aux1 >> 28)) * 0.25).astype(np.float32)
        gidx = (aux0[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 255
        sidx = (aux1[..., None] >> (7 * np.arange(4, dtype=np.uint32))) & 127
        vals = _iq_grids()["iq2xxs"][gidx].astype(np.int16)
        codes = (vals * _sgn_i8(_KSIGNS[sidx])).astype(np.int8)
        return (codes.reshape(N, K // 256, 256), scales.reshape(N, K // 32),
                None, 32, 0, False)
    if ttype in (t.IQ2_XS, t.IQ2_S):
        if ttype == t.IQ2_XS:
            b = raw.reshape(nsb, 74)
            d = _f16(b[:, 0:2]).reshape(nsb)
            q16 = np.ascontiguousarray(b[:, 2:66]).view("<u2").reshape(nsb, 8, 4)
            sc = b[:, 66:74]
            vals = _iq_grids()["iq2xs"][q16 & 511].astype(np.int16)
            sgn = _sgn_i8(_KSIGNS[q16 >> 9])
        else:
            b = raw.reshape(nsb, 82)
            d = _f16(b[:, 0:2]).reshape(nsb)
            qs = b[:, 2:34].reshape(nsb, 8, 4).astype(np.uint16)
            signs = b[:, 34:66].reshape(nsb, 8, 4)
            qh = b[:, 66:74].astype(np.uint16)
            sc = b[:, 74:82]
            shift = (8 - 2 * np.arange(4, dtype=np.uint16))
            idx = qs | ((qh[:, :, None] << shift) & 0x300)
            vals = _iq_grids()["iq2s"][idx].astype(np.int16)
            sgn = _sgn_i8(signs)
        ls = np.stack([sc & 0x0F, sc >> 4], axis=-1).astype(np.float32)
        scales = (d[:, None, None] * (0.5 + ls) * 0.25).reshape(nsb, 16)
        codes = (vals * sgn).astype(np.int8)
        return (codes.reshape(N, K // 256, 256), scales.reshape(N, K // 16),
                None, 16, 0, False)
    if ttype == t.IQ3_XXS:
        b = raw.reshape(nsb, 98)
        d = _f16(b[:, 0:2]).reshape(nsb)
        qs = b[:, 2:66].reshape(nsb, 8, 4, 2)
        sas = np.ascontiguousarray(b[:, 66:98]).view("<u4").reshape(nsb, 8).astype(np.uint32)
        scales = (d[:, None] * (0.5 + (sas >> 28)) * 0.5).astype(np.float32)
        sidx = (sas[..., None] >> (7 * np.arange(4, dtype=np.uint32))) & 127
        vals = _iq_grids()["iq3xxs"][qs].astype(np.int16).reshape(nsb, 8, 4, 8)
        codes = (vals * _sgn_i8(_KSIGNS[sidx])).astype(np.int8)
        return (codes.reshape(N, K // 256, 256), scales.reshape(N, K // 32),
                None, 32, 0, False)
    if ttype == t.IQ3_S:
        b = raw.reshape(nsb, 110)
        d = _f16(b[:, 0:2]).reshape(nsb)
        qs = b[:, 2:66].reshape(nsb, 8, 4, 2).astype(np.uint16)
        qh = b[:, 66:74].astype(np.uint16)
        signs = b[:, 74:106].reshape(nsb, 8, 4)
        sc = b[:, 106:110]
        ls = np.stack([sc & 0x0F, sc >> 4], axis=-1).reshape(nsb, 8).astype(np.float32)
        scales = (d[:, None] * (1.0 + 2.0 * ls)).astype(np.float32)
        sh1 = (8 - 2 * np.arange(4, dtype=np.uint16))
        sh2 = (7 - 2 * np.arange(4, dtype=np.uint16))
        idx = np.stack([qs[:, :, :, 0] | ((qh[:, :, None] << sh1) & 256),
                        qs[:, :, :, 1] | ((qh[:, :, None] << sh2) & 256)], axis=-1)
        vals = _iq_grids()["iq3s"][idx].astype(np.int16).reshape(nsb, 8, 4, 8)
        codes = (vals * _sgn_i8(signs)).astype(np.int8)
        return (codes.reshape(N, K // 256, 256), scales.reshape(N, K // 32),
                None, 32, 0, False)
    if ttype == t.IQ1_S:
        b = raw.reshape(nsb, 50)
        d = _f16(b[:, 0:2]).reshape(nsb)
        qs = b[:, 2:34].reshape(nsb, 8, 4).astype(np.uint16)
        qh = np.ascontiguousarray(b[:, 34:50]).view("<u2").reshape(nsb, 8)
        dl = (d[:, None] * (2.0 * ((qh >> 12) & 7).astype(np.float32) + 1.0))
        delta = np.where(qh & 0x8000, -_IQ1_DELTA, _IQ1_DELTA).astype(np.float32)
        idx = qs | ((((qh[:, :, None] >> (3 * np.arange(4, dtype=np.uint16))) & 7) << 8))
        codes = _iq_grids()["iq1s"][idx]                     # (nsb,8,4,8) int8
        return (codes.reshape(N, K // 256, 256), dl.reshape(N, K // 32),
                (dl * delta).reshape(N, K // 32), 32, 0, False)
    if ttype == t.IQ1_M:
        b = raw.reshape(nsb, 56)
        qs = b[:, 0:32].reshape(nsb, 8, 4).astype(np.uint16)
        qh = b[:, 32:48].reshape(nsb, 8, 2).astype(np.uint16)
        sc = np.ascontiguousarray(b[:, 48:56]).view("<u2").reshape(nsb, 4).astype(np.uint16)
        d16 = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0)
               | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000)).astype("<u2")
        d = d16.view(np.dtype("<f2")).astype(np.float32)
        ib = np.arange(8)
        sh = 6 * (ib % 2)
        sc_ib = sc[:, ib // 2]
        dl1 = d[:, None] * (2.0 * ((sc_ib >> sh) & 7).astype(np.float32) + 1.0)
        dl2 = d[:, None] * (2.0 * ((sc_ib >> (sh + 3)) & 7).astype(np.float32) + 1.0)
        dl = np.stack([dl1, dl1, dl2, dl2], axis=-1)         # (nsb,8,4) per 8
        idx = np.empty((nsb, 8, 4), np.uint16)
        idx[:, :, 0] = qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700)
        idx[:, :, 1] = qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700)
        idx[:, :, 2] = qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700)
        idx[:, :, 3] = qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)
        hbit = np.stack([qh[:, :, 0] & 0x08, qh[:, :, 0] & 0x80,
                         qh[:, :, 1] & 0x08, qh[:, :, 1] & 0x80], axis=-1)
        delta = np.where(hbit, -_IQ1_DELTA, _IQ1_DELTA).astype(np.float32)
        codes = _iq_grids()["iq1s"][idx]                     # (nsb,8,4,8) int8
        return (codes.reshape(N, K // 256, 256), dl.reshape(N, K // 8),
                (dl * delta).reshape(N, K // 8), 8, 0, False)
    raise NotImplementedError(f"no repack for {ttype.name}")


# formats repacked to the compact wire-bpw layout (factored superblock scales)
COMPACT = {GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K}


def _compact_kquant(raw: np.ndarray, ttype: GGMLType, N: int, K: int,
                    codes, nibble: bool):
    """Factor a K-quant into wire-bpw parts: integer sub-scales (u8/i8) ×
    per-superblock f16 d/dmin (kept f32), codes as lo-nibble (+ hi bit-plane
    for Q5_K/Q6_K). Bit-exact: scale = d·sc reproduces the legacy f32 plane
    value-for-value (f32 product of an exact f16 and a small int).

    Byte budget per weight: Q4_K 0.59 (wire 0.5625), Q5_K 0.72 (wire 0.6875),
    Q6_K 0.83 (wire 0.8203) — vs 0.75/1.25/1.28 for the legacy f32-plane form.
    Layouts: ggml-common.h block_q4_K/q5_K/q6_K."""
    t = GGMLType
    if ttype in (t.Q4_K, t.Q5_K):
        tsz = 144 if ttype == t.Q4_K else 176
        b = raw.reshape(N, K // 256, tsz)
        nb = N * (K // 256)
        d = _f16(b[:, :, 0:2].reshape(-1, 2)).reshape(N, K // 256)
        dmin = _f16(b[:, :, 2:4].reshape(-1, 2)).reshape(N, K // 256)
        sc, mn = _unpack_scale_min_k4(b[:, :, 4:16].reshape(nb, 12))
        parts = dict(
            sc=np.ascontiguousarray(sc.reshape(N, K // 32).T),
            mn=np.ascontiguousarray(mn.reshape(N, K // 32).T),
            d=np.ascontiguousarray(d.T, np.float32),
            dmin=np.ascontiguousarray(dmin.T, np.float32),
            sb=8, offset=0)
        if ttype == t.Q4_K:        # codes already nibble-packed (K//2, N)
            return dict(parts, codes=codes, nibble=True, hi=None, hi_bits=0,
                        gs=32)
        q = codes.astype(np.uint8)                 # (K, N) values 0..31
        return dict(parts, codes=_pack_nib4(q & 0x0F), nibble=True,
                    hi=_pack_bits(q >> 4, 1), hi_bits=1, gs=32)
    if ttype == t.Q6_K:
        b = raw.reshape(N, K // 256, 210)
        sc8 = np.ascontiguousarray(b[:, :, 192:208]).view(np.int8)
        d = _f16(b[:, :, 208:210].reshape(-1, 2)).reshape(N, K // 256)
        q = (codes.astype(np.int16) + 32).astype(np.uint8)   # (K, N) 0..63
        return dict(
            codes=_pack_nib4(q & 0x0F), nibble=True,
            hi=_pack_bits(q >> 4, 2), hi_bits=2,
            sc=np.ascontiguousarray(sc8.reshape(N, K // 16).T),
            mn=None, d=np.ascontiguousarray(d.T, np.float32), dmin=None,
            sb=16, offset=32, gs=16)
    raise NotImplementedError(ttype)


def repack(raw: np.ndarray, ttype: GGMLType, out_in_shape: tuple[int, int],
           device="cpu", threads: int = 0) -> QTensor:
    """Repack GGUF packed bytes (row-major (N,K) blocks) into a QTensor on
    ``device``: f32 scale (and add) planes for the planar formats, the
    compact factored form for Q4_K, Q5_K and Q6_K.

    Q4_0, Q8_0, Q4_K, Q5_K and Q6_K take the native repack
    (``native/quants.cpp::slq_repack`` on ``threads`` host threads, 0: every
    core), whose planes are bit-identical to ``_extract``'s; the other types
    (and every type under ``SLT_NO_NATIVE=1``) take ``_extract`` in numpy."""
    from .. import native

    N, K = out_in_shape
    rawu8 = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    nat = native.repack(rawu8, int(ttype), N, K, threads)
    if nat is not None:
        codes, scales, adds, gs, offset, nibble = nat
    else:
        codes, scales, adds, gs, offset, nibble = _extract(rawu8, ttype, N, K)
        codes = codes.reshape(N, K).T                       # (K, N)
        codes = _pack_nib4(codes.astype(np.uint8)) if nibble else codes.astype(np.int8)
        scales, adds = (None if a is None else np.ascontiguousarray(
            a.reshape(N, K // gs).T, np.float32) for a in (scales, adds))
    put = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(device)
    if ttype in COMPACT:
        c = _compact_kquant(rawu8, ttype, N, K, codes, nibble)
        return QTensor(
            codes=put(c["codes"]), scales=None, adds=None, group=c["gs"],
            offset=c["offset"], nibble=c["nibble"], K=K, N=N, ggml_type=ttype,
            sc=put(c["sc"]), mn=put(c["mn"]), d=put(c["d"]),
            dmin=put(c["dmin"]), hi=put(c["hi"]), hi_bits=c["hi_bits"],
            sb=c["sb"])
    return QTensor(codes=put(codes), scales=put(scales), adds=put(adds), group=gs,
                   offset=offset, nibble=nibble, K=K, N=N, ggml_type=ttype)


REPACKABLE = {
    GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
    GGMLType.MXFP4, GGMLType.IQ4_NL, GGMLType.Q2_K, GGMLType.Q3_K,
    GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
    GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S,
    GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M,
    GGMLType.IQ4_XS, GGMLType.Q8_K, GGMLType.TQ1_0, GGMLType.TQ2_0,
}


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
