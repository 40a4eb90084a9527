"""Numpy decoders for every ggml block format the JAX package loads.

The port's copy of the decoders of the JAX package's ``gguf/quants.py``
(``dequantize_row_*`` semantics of ggml-quants.c, vectorized over blocks),
bit-exact with them: the float formats, the 32-wide formats (Q4_0, Q4_1,
Q5_0, Q5_1, Q8_0, MXFP4, IQ4_NL), the K-quants (Q2_K .. Q8_K, IQ4_XS), the
codebook i-quants (IQ1/IQ2/IQ3, through the lattice grids of
``iq_grids.npz`` in this directory) and the ternary TQ1_0 / TQ2_0. The
float encoders serve ``GGUFWriter``; the quantized encoders are not ported.
"""

from __future__ import annotations

import numpy as np

from .constants import GGMLType, KVALUES_IQ4NL, KVALUES_MXFP4

_IQ4NL = np.array(KVALUES_IQ4NL, dtype=np.float32)


_MXFP4 = np.array(KVALUES_MXFP4, dtype=np.float32)


def _f16(raw: np.ndarray) -> np.ndarray:
    """View little-endian fp16 bytes (N,2) as float32 (N,)."""
    return np.ascontiguousarray(raw).view(np.dtype("<f2")).astype(np.float32).reshape(raw.shape[0], -1)


def _blocks(raw: np.ndarray, type_size: int) -> np.ndarray:
    raw = np.frombuffer(raw.tobytes(), dtype=np.uint8) if not raw.flags.c_contiguous else raw
    if raw.size % type_size != 0:
        raise ValueError(f"byte size {raw.size} not a multiple of block type size {type_size}")
    return raw.reshape(-1, type_size)


def _e8m0_to_fp32_half(e: np.ndarray) -> np.ndarray:
    """Decode E8M0 exponent byte to 0.5 * 2^(e-127) (ggml-impl.h:467-485)."""
    e = e.astype(np.uint32)
    bits = np.where(e < 2, np.uint32(0x00200000) << e, (e - 1) << np.uint32(23))
    return bits.astype(np.uint32).view(np.float32)


def dequant_q4_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2])                      # (nb,1)
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)


def dequant_q4_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 20)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return (np.concatenate([lo, hi], axis=1) * d + m).astype(np.float32).reshape(-1)


def dequant_q5_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 22)
    d = _f16(b[:, 0:2])
    qh = np.ascontiguousarray(b[:, 2:6]).view(np.dtype("<u4")).reshape(-1, 1).astype(np.uint32)
    qs = b[:, 6:22]
    j = np.arange(16, dtype=np.uint32)
    xh0 = ((qh >> j) << 4) & 0x10
    xh1 = (qh >> (j + 12)) & 0x10
    lo = (((qs & 0x0F) | xh0).astype(np.int16) - 16).astype(np.float32)
    hi = (((qs >> 4) | xh1).astype(np.int16) - 16).astype(np.float32)
    return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)


def dequant_q5_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 24)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qh = np.ascontiguousarray(b[:, 4:8]).view(np.dtype("<u4")).reshape(-1, 1).astype(np.uint32)
    qs = b[:, 8:24]
    j = np.arange(16, dtype=np.uint32)
    xh0 = ((qh >> j) << 4) & 0x10
    xh1 = (qh >> (j + 12)) & 0x10
    lo = ((qs & 0x0F) | xh0).astype(np.float32)
    hi = ((qs >> 4) | xh1).astype(np.float32)
    return (np.concatenate([lo, hi], axis=1) * d + m).astype(np.float32).reshape(-1)


def dequant_q8_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 34)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].view(np.int8).astype(np.float32)
    return (qs * d).astype(np.float32).reshape(-1)


def dequant_mxfp4(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 17)
    d = _e8m0_to_fp32_half(b[:, 0]).reshape(-1, 1)
    qs = b[:, 1:17]
    lo = _MXFP4[qs & 0x0F]
    hi = _MXFP4[qs >> 4]
    return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)


def dequant_iq4_nl(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:18]
    lo = _IQ4NL[qs & 0x0F]
    hi = _IQ4NL[qs >> 4]
    return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)


def _unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack 12-byte 6-bit scale/min pairs → (nb,8),(nb,8) (get_scale_min_k4)."""
    sc = np.empty((scales.shape[0], 8), dtype=np.uint8)
    mn = np.empty((scales.shape[0], 8), dtype=np.uint8)
    for j in range(4):
        sc[:, j] = scales[:, j] & 63
        mn[:, j] = scales[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (scales[:, j + 4] & 0x0F) | ((scales[:, j - 4] >> 6) << 4)
        mn[:, j] = (scales[:, j + 4] >> 4) | ((scales[:, j] >> 6) << 4)
    return sc, mn


def _ieee(fn):
    """Run a dequant under errstate(ignore): random/garbage f16 scales decode
    to inf/NaN which must PROPAGATE (the reference memcpys and multiplies,
    ggml-quants.c — oracle bit-exactness forbids masking); the numpy warning
    is noise, not a defect."""
    import functools

    @functools.wraps(fn)
    def wrap(*a, **k):
        with np.errstate(invalid="ignore", over="ignore"):
            return fn(*a, **k)
    return wrap


@_ieee
def dequant_q2_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 84)
    scales = b[:, 0:16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    nb = b.shape[0]
    y = np.empty((nb, 256), dtype=np.float32)
    dl = d * (scales & 0x0F).astype(np.float32)      # (nb,16) per-group scale
    ml = dmin * (scales >> 4).astype(np.float32)     # (nb,16) per-group min
    out_pos = 0
    is_ = 0
    for n in (0, 128):
        q = qs[:, n // 4 : n // 4 + 32]
        for shift in (0, 2, 4, 6):
            for half in (0, 16):
                g = (q[:, half : half + 16] >> shift) & 3
                y[:, out_pos : out_pos + 16] = dl[:, is_ : is_ + 1] * g - ml[:, is_ : is_ + 1]
                out_pos += 16
                is_ += 1
    return y.reshape(-1)


def _q3k_unpack_scales(scales12: np.ndarray) -> np.ndarray:
    """Unpack q3_K 12-byte scales to (nb,16) int8 6-bit values (pre -32 offset)."""
    a = np.ascontiguousarray(scales12).view(np.dtype("<u4")).reshape(-1, 3).astype(np.uint32)
    kmask1, kmask2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    tmp = a[:, 2]
    out = np.empty((a.shape[0], 4), dtype=np.uint32)
    out[:, 0] = (a[:, 0] & kmask2) | (((tmp >> 0) & kmask1) << 4)
    out[:, 1] = (a[:, 1] & kmask2) | (((tmp >> 2) & kmask1) << 4)
    out[:, 2] = ((a[:, 0] >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4)
    out[:, 3] = ((a[:, 1] >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4)
    return out.astype("<u4").view(np.int8).reshape(-1, 16)


def dequant_q3_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 110)
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    scales = _q3k_unpack_scales(b[:, 96:108]).astype(np.float32) - 32.0
    d = _f16(b[:, 108:110])
    nb = b.shape[0]
    y = np.empty((nb, 256), dtype=np.float32)
    out_pos = 0
    is_ = 0
    m = 1
    for n in (0, 128):
        q = qs[:, n // 4 : n // 4 + 32]
        for shift in (0, 2, 4, 6):
            for half in (0, 16):
                low = ((q[:, half : half + 16] >> shift) & 3).astype(np.int8)
                hb = np.where(hmask[:, half : half + 16] & m, 0, 4).astype(np.int8)
                y[:, out_pos : out_pos + 16] = (d * scales[:, is_ : is_ + 1]) * (low - hb)
                out_pos += 16
                is_ += 1
            m <<= 1
    return y.reshape(-1)


@_ieee
def dequant_q4_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 144)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144]
    nb = b.shape[0]
    y = np.empty((nb, 256), dtype=np.float32)
    for j in range(4):  # 4 chunks of 64 elements; each uses 32 qs bytes
        q = qs[:, j * 32 : (j + 1) * 32]
        d1 = d * sc[:, 2 * j : 2 * j + 1].astype(np.float32)
        m1 = dmin * mn[:, 2 * j : 2 * j + 1].astype(np.float32)
        d2 = d * sc[:, 2 * j + 1 : 2 * j + 2].astype(np.float32)
        m2 = dmin * mn[:, 2 * j + 1 : 2 * j + 2].astype(np.float32)
        y[:, j * 64 : j * 64 + 32] = d1 * (q & 0x0F).astype(np.float32) - m1
        y[:, j * 64 + 32 : j * 64 + 64] = d2 * (q >> 4).astype(np.float32) - m2
    return y.reshape(-1)


@_ieee
def dequant_q5_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 176)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]
    ql = b[:, 48:176]
    nb = b.shape[0]
    y = np.empty((nb, 256), dtype=np.float32)
    u1, u2 = 1, 2
    for j in range(4):
        q = ql[:, j * 32 : (j + 1) * 32]
        d1 = d * sc[:, 2 * j : 2 * j + 1].astype(np.float32)
        m1 = dmin * mn[:, 2 * j : 2 * j + 1].astype(np.float32)
        d2 = d * sc[:, 2 * j + 1 : 2 * j + 2].astype(np.float32)
        m2 = dmin * mn[:, 2 * j + 1 : 2 * j + 2].astype(np.float32)
        h1 = np.where(qh & u1, 16, 0).astype(np.float32)
        h2 = np.where(qh & u2, 16, 0).astype(np.float32)
        y[:, j * 64 : j * 64 + 32] = d1 * ((q & 0x0F).astype(np.float32) + h1) - m1
        y[:, j * 64 + 32 : j * 64 + 64] = d2 * ((q >> 4).astype(np.float32) + h2) - m2
        u1 <<= 2
        u2 <<= 2
    return y.reshape(-1)


def dequant_q6_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 210)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc = b[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(b[:, 208:210])
    nb = b.shape[0]
    y = np.empty((nb, 256), dtype=np.float32)
    for n in (0, 128):
        lq = ql[:, n // 2 : n // 2 + 64]
        hq = qh[:, n // 4 : n // 4 + 32]
        s = sc[:, n // 16 : n // 16 + 8]
        l = np.arange(32)
        is_ = l // 16  # 0 or 1
        q1 = ((lq[:, 0:32] & 0x0F) | (((hq >> 0) & 3) << 4)).astype(np.int16) - 32
        q2 = ((lq[:, 32:64] & 0x0F) | (((hq >> 2) & 3) << 4)).astype(np.int16) - 32
        q3 = ((lq[:, 0:32] >> 4) | (((hq >> 4) & 3) << 4)).astype(np.int16) - 32
        q4 = ((lq[:, 32:64] >> 4) | (((hq >> 6) & 3) << 4)).astype(np.int16) - 32
        y[:, n + 0 : n + 32] = d * s[:, is_ + 0] * q1
        y[:, n + 32 : n + 64] = d * s[:, is_ + 2] * q2
        y[:, n + 64 : n + 96] = d * s[:, is_ + 4] * q3
        y[:, n + 96 : n + 128] = d * s[:, is_ + 6] * q4
    return y.reshape(-1)


def dequant_q8_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 292)
    d = np.ascontiguousarray(b[:, 0:4]).view(np.dtype("<f4")).reshape(-1, 1)
    qs = b[:, 4:260].view(np.int8).astype(np.float32)
    return (qs * d).astype(np.float32).reshape(-1)


def dequant_iq4_xs(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 136)
    d = _f16(b[:, 0:2])
    scales_h = np.ascontiguousarray(b[:, 2:4]).view(np.dtype("<u2")).reshape(-1).astype(np.uint32)
    scales_l = b[:, 4:8]
    qs = b[:, 8:136]
    nb = b.shape[0]
    y = np.empty((nb, 256), dtype=np.float32)
    for ib in range(8):  # 8 groups of 32
        ls = ((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F).astype(np.uint32) | (
            ((scales_h >> (2 * ib)) & 3) << 4
        )
        dl = d[:, 0] * (ls.astype(np.float32) - 32.0)
        q = qs[:, ib * 16 : (ib + 1) * 16]
        y[:, ib * 32 : ib * 32 + 16] = dl[:, None] * _IQ4NL[q & 0x0F]
        y[:, ib * 32 + 16 : ib * 32 + 32] = dl[:, None] * _IQ4NL[q >> 4]
    return y.reshape(-1)


_IQ_GRIDS: dict | None = None


def _iq_grids() -> dict:
    global _IQ_GRIDS
    if _IQ_GRIDS is None:
        import os

        with np.load(os.path.join(os.path.dirname(__file__), "iq_grids.npz")) as z:
            g = {k: z[k] for k in z.files}
        _IQ_GRIDS = {
            "iq2xxs": g["iq2xxs_grid"].view(np.uint8).reshape(-1, 8),
            "iq2xs": g["iq2xs_grid"].view(np.uint8).reshape(-1, 8),
            "iq2s": g["iq2s_grid"].view(np.uint8).reshape(-1, 8),
            "iq3xxs": g["iq3xxs_grid"].view(np.uint8).reshape(-1, 4),
            "iq3s": g["iq3s_grid"].view(np.uint8).reshape(-1, 4),
            "iq1s": g["iq1s_grid"].view(np.int8).reshape(-1, 8),
        }
    return _IQ_GRIDS


_KSIGNS = (np.arange(128, dtype=np.uint8)
           | ((np.unpackbits(np.arange(128, dtype=np.uint8)[:, None], axis=1)
               .sum(axis=1) & 1) << 7).astype(np.uint8))


_IQ1_DELTA = 0.125  # IQ1S_DELTA / IQ1M_DELTA


def _signs8(sign_bytes: np.ndarray) -> np.ndarray:
    """uint8 (...,) → float32 (..., 8): bit j set ⇒ −1 else +1."""
    bits = (sign_bytes[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return 1.0 - 2.0 * bits.astype(np.float32)


def dequant_iq2_xxs(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 66)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(nb)
    q16 = np.ascontiguousarray(b[:, 2:66]).view("<u2").reshape(nb, 8, 4).astype(np.uint32)
    aux0 = q16[:, :, 0] | (q16[:, :, 1] << 16)              # 4 grid bytes
    aux1 = q16[:, :, 2] | (q16[:, :, 3] << 16)              # signs + scale
    db = d[:, None] * (0.5 + (aux1 >> 28)) * 0.25           # (nb, 8)
    gidx = (aux0[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 255
    sidx = (aux1[..., None] >> (7 * np.arange(4, dtype=np.uint32))) & 127
    vals = _iq_grids()["iq2xxs"][gidx].astype(np.float32)   # (nb,8,4,8)
    sgn = _signs8(_KSIGNS[sidx])
    return (db[..., None, None] * vals * sgn).astype(np.float32).reshape(-1)


def dequant_iq2_xs(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 74)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(nb)
    q16 = np.ascontiguousarray(b[:, 2:66]).view("<u2").reshape(nb, 8, 4)
    sc = b[:, 66:74]                                        # (nb, 8)
    ls = np.stack([sc & 0x0F, sc >> 4], axis=-1).astype(np.float32)
    db = d[:, None, None] * (0.5 + ls) * 0.25               # (nb,8,2)
    vals = _iq_grids()["iq2xs"][q16 & 511].astype(np.float32)
    sgn = _signs8(_KSIGNS[q16 >> 9])
    dbl = db[:, :, [0, 0, 1, 1]]                            # (nb,8,4)
    return (dbl[..., None] * vals * sgn).astype(np.float32).reshape(-1)


def dequant_iq2_s(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 82)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(nb)
    qs = b[:, 2:34].reshape(nb, 8, 4).astype(np.uint16)
    signs = b[:, 34:66].reshape(nb, 8, 4)
    qh = b[:, 66:74].astype(np.uint16)
    sc = b[:, 74:82]
    ls = np.stack([sc & 0x0F, sc >> 4], axis=-1).astype(np.float32)
    db = d[:, None, None] * (0.5 + ls) * 0.25
    shift = (8 - 2 * np.arange(4, dtype=np.uint16))
    idx = qs | ((qh[:, :, None] << shift) & 0x300)
    vals = _iq_grids()["iq2s"][idx].astype(np.float32)
    sgn = _signs8(signs)
    dbl = db[:, :, [0, 0, 1, 1]]
    return (dbl[..., None] * vals * sgn).astype(np.float32).reshape(-1)


def dequant_iq3_xxs(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 98)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(nb)
    qs = b[:, 2:66].reshape(nb, 8, 4, 2)                    # 2 grid bytes per l
    sas = np.ascontiguousarray(b[:, 66:98]).view("<u4").reshape(nb, 8).astype(np.uint32)
    db = d[:, None] * (0.5 + (sas >> 28)) * 0.5             # (nb,8)
    sidx = (sas[..., None] >> (7 * np.arange(4, dtype=np.uint32))) & 127
    vals = _iq_grids()["iq3xxs"][qs].astype(np.float32).reshape(nb, 8, 4, 8)
    sgn = _signs8(_KSIGNS[sidx])
    return (db[..., None, None] * vals * sgn).astype(np.float32).reshape(-1)


def dequant_iq3_s(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 110)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(nb)
    qs = b[:, 2:66].reshape(nb, 8, 4, 2).astype(np.uint16)
    qh = b[:, 66:74].astype(np.uint16)
    signs = b[:, 74:106].reshape(nb, 8, 4)
    sc = b[:, 106:110]                                      # (nb,4) nibble pairs
    ls = np.stack([sc & 0x0F, sc >> 4], axis=-1).reshape(nb, 8).astype(np.float32)
    db = d[:, None] * (1.0 + 2.0 * ls)                      # (nb,8) per ib32
    sh1 = (8 - 2 * np.arange(4, dtype=np.uint16))
    sh2 = (7 - 2 * np.arange(4, dtype=np.uint16))
    idx1 = qs[:, :, :, 0] | ((qh[:, :, None] << sh1) & 256)
    idx2 = qs[:, :, :, 1] | ((qh[:, :, None] << sh2) & 256)
    idx = np.stack([idx1, idx2], axis=-1)                   # (nb,8,4,2)
    vals = _iq_grids()["iq3s"][idx].astype(np.float32).reshape(nb, 8, 4, 8)
    sgn = _signs8(signs)
    return (db[..., None, None] * vals * sgn).astype(np.float32).reshape(-1)


def dequant_iq1_s(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 50)
    nb = b.shape[0]
    d = _f16(b[:, 0:2]).reshape(nb)
    qs = b[:, 2:34].reshape(nb, 8, 4).astype(np.uint16)
    qh = np.ascontiguousarray(b[:, 34:50]).view("<u2").reshape(nb, 8)
    dl = d[:, None] * (2.0 * ((qh >> 12) & 7).astype(np.float32) + 1.0)
    delta = np.where(qh & 0x8000, -_IQ1_DELTA, _IQ1_DELTA).astype(np.float32)
    idx = qs | ((((qh[:, :, None] >> (3 * np.arange(4, dtype=np.uint16))) & 7) << 8))
    vals = _iq_grids()["iq1s"][idx].astype(np.float32)      # (nb,8,4,8)
    y = dl[..., None, None] * (vals + delta[..., None, None])
    return y.astype(np.float32).reshape(-1)


def dequant_iq1_m(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 56)
    nb = b.shape[0]
    qs = b[:, 0:32].reshape(nb, 8, 4).astype(np.uint16)
    qh = b[:, 32:48].reshape(nb, 8, 2).astype(np.uint16)
    sc = np.ascontiguousarray(b[:, 48:56]).view("<u2").reshape(nb, 4).astype(np.uint16)
    d16 = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0)
           | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000)).astype("<u2")
    d = d16.view(np.dtype("<f2")).astype(np.float32)
    ib = np.arange(8)
    sh = 6 * (ib % 2)
    sc_ib = sc[:, ib // 2]                                  # (nb,8)
    dl1 = d[:, None] * (2.0 * ((sc_ib >> sh) & 7).astype(np.float32) + 1.0)
    dl2 = d[:, None] * (2.0 * ((sc_ib >> (sh + 3)) & 7).astype(np.float32) + 1.0)
    dl = np.stack([dl1, dl1, dl2, dl2], axis=-1)            # (nb,8,4)
    idx = np.empty((nb, 8, 4), np.uint16)
    idx[:, :, 0] = qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700)
    idx[:, :, 1] = qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700)
    idx[:, :, 2] = qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700)
    idx[:, :, 3] = qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)
    hbit = np.stack([qh[:, :, 0] & 0x08, qh[:, :, 0] & 0x80,
                     qh[:, :, 1] & 0x08, qh[:, :, 1] & 0x80], axis=-1)
    delta = np.where(hbit, -_IQ1_DELTA, _IQ1_DELTA).astype(np.float32)
    vals = _iq_grids()["iq1s"][idx].astype(np.float32)
    y = dl[..., None] * (vals + delta[..., None])
    return y.astype(np.float32).reshape(-1)


def dequant_tq1_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 54)
    qs = b[:, 0:48]
    qh = b[:, 48:52]
    d = _f16(b[:, 52:54])
    nb = b.shape[0]
    y = np.empty((nb, 256), dtype=np.float32)
    pow3 = np.array([1, 3, 9, 27, 81], dtype=np.uint16)
    pos = 0
    # first 32 bytes → 5 elements each stride 32 (ggml dequantize_row_tq1_0)
    for j, width in ((0, 32), (32, 16)):
        nseg = 5
        seg = qs[:, j : j + width].astype(np.uint16)
        for m in range(nseg):
            q = ((seg * pow3[m]) & 0xFF) * 3 // 256
            y[:, pos : pos + width] = (q.astype(np.float32) - 1.0) * d
            pos += width
    seg = qh.astype(np.uint16)
    for m in range(4):
        q = ((seg * pow3[m]) & 0xFF) * 3 // 256
        y[:, pos : pos + 4] = (q.astype(np.float32) - 1.0) * d
        pos += 4
    return y.reshape(-1)


def dequant_tq2_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 66)
    qs = b[:, 0:64]
    d = _f16(b[:, 64:66])
    nb = b.shape[0]
    y = np.empty((nb, 256), dtype=np.float32)
    pos = 0
    for j in (0, 32):
        seg = qs[:, j : j + 32]
        for shift in (0, 2, 4, 6):
            q = ((seg >> shift) & 3).astype(np.float32) - 1.0
            y[:, pos : pos + 32] = q * d
            pos += 32
    return y.reshape(-1)


def dequant_f32(raw: np.ndarray) -> np.ndarray:
    return np.frombuffer(raw.tobytes(), dtype="<f4").astype(np.float32)


def dequant_f16(raw: np.ndarray) -> np.ndarray:
    return np.frombuffer(raw.tobytes(), dtype="<f2").astype(np.float32)


def dequant_bf16(raw: np.ndarray) -> np.ndarray:
    u = np.frombuffer(raw.tobytes(), dtype="<u2").astype(np.uint32) << 16
    return u.view(np.float32)


def dequant_f64(raw: np.ndarray) -> np.ndarray:
    return np.frombuffer(raw.tobytes(), dtype="<f8").astype(np.float32)


def quant_f32(x: np.ndarray) -> np.ndarray:
    return x.astype("<f4").view(np.uint8).reshape(-1)


def quant_f16(x: np.ndarray) -> np.ndarray:
    return x.astype("<f2").view(np.uint8).reshape(-1)


def quant_bf16(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.float32).view(np.uint32)
    # round-to-nearest-even on the truncated mantissa
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return rounded.astype("<u2").view(np.uint8).reshape(-1)


DEQUANTIZERS = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.BF16: dequant_bf16,
    GGMLType.F64: dequant_f64,
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.MXFP4: dequant_mxfp4,
    GGMLType.Q2_K: dequant_q2_k,
    GGMLType.Q3_K: dequant_q3_k,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q5_K: dequant_q5_k,
    GGMLType.Q6_K: dequant_q6_k,
    GGMLType.Q8_K: dequant_q8_k,
    GGMLType.IQ4_NL: dequant_iq4_nl,
    GGMLType.IQ4_XS: dequant_iq4_xs,
    GGMLType.IQ2_XXS: dequant_iq2_xxs,
    GGMLType.IQ2_XS: dequant_iq2_xs,
    GGMLType.IQ2_S: dequant_iq2_s,
    GGMLType.IQ3_XXS: dequant_iq3_xxs,
    GGMLType.IQ3_S: dequant_iq3_s,
    GGMLType.IQ1_S: dequant_iq1_s,
    GGMLType.IQ1_M: dequant_iq1_m,
    GGMLType.TQ1_0: dequant_tq1_0,
    GGMLType.TQ2_0: dequant_tq2_0,
}


def dequantize(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Decode a byte buffer of the given wire type to float32 (optionally
    reshaped)."""
    fn = DEQUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"no dequantizer for {ggml_type.name}")
    buf = np.frombuffer(raw.tobytes() if isinstance(raw, np.ndarray) else bytes(raw), dtype=np.uint8)
    out = fn(buf)
    return out.reshape(shape) if shape is not None else out


QUANTIZERS = {
    GGMLType.F32: quant_f32,
    GGMLType.F16: quant_f16,
    GGMLType.BF16: quant_bf16,
}


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Encode float data to a float wire type (F32, F16, BF16) as a 1-D
    uint8 array; the block-quant encoders are not ported."""
    fn = QUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"no encoder for {ggml_type.name} in the port")
    return fn(np.asarray(x))
