"""Numpy codecs for every ggml block format the JAX package reads and writes.

The port's copy of the JAX package's ``gguf/quants.py``: the decoders
(``dequantize_row_*`` semantics of ggml-quants.c) and the encoders
(``quant_*``: one-shot scale rounds for the 32-wide formats, codebook
searches for the i-quants, and the weighted K-quant searches of
``kquant_search.py`` for Q2_K-Q6_K), vectorized over blocks and bit-exact
with the JAX package's. ``dequantize`` and ``quantize`` route a type the
native library covers through it (``native/quants.cpp``, bit-identical by
the tests); these numpy functions stay its plain version and the only route
of the other types (and of every type under ``SLT_NO_NATIVE=1``). The
i-quant decoders read the lattice grids of ``iq_grids.npz`` in this
directory.

Data layout convention: quantized tensors are 1-D uint8 byte arrays covering
``n_blocks * type_size`` bytes; float tensors are float32. A tensor of logical
shape (..., ne0) is quantized row-wise along the last axis (ne0 must be a
multiple of the block size), matching ggml row layout.
"""

from __future__ import annotations

import numpy as np

from .constants import GGML_TYPE_TRAITS, KVALUES_IQ4NL, KVALUES_MXFP4, GGMLType

_IQ4NL = np.array(KVALUES_IQ4NL, dtype=np.float32)
_MXFP4 = np.array(KVALUES_MXFP4, dtype=np.float32)


def _f16(raw: np.ndarray) -> np.ndarray:
    """View little-endian fp16 bytes (N,2) as float32 (N,)."""
    return np.ascontiguousarray(raw).view(np.dtype("<f2")).astype(np.float32).reshape(raw.shape[0], -1)


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    return x.astype(np.dtype("<f2")).view(np.uint8)


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


def _fp32_to_e8m0_half(d: np.ndarray) -> np.ndarray:
    """Inverse of _e8m0_to_fp32_half, rounding the scale up (ceil exponent)."""
    d = np.asarray(d, dtype=np.float32)
    out = np.zeros(d.shape, dtype=np.uint8)
    pos = d > 0
    # want smallest e such that 2^(e-128) >= d  →  e = ceil(log2(d)) + 128
    e = np.ceil(np.log2(d, where=pos, out=np.zeros_like(d))) + 128
    out[pos] = np.clip(e[pos], 0, 254).astype(np.uint8)
    return out


# =========================== simple 32-wide formats ==========================


def dequant_q4_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2])                      # (nb,1)
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)


def quant_q4_0(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 32)
    # scale from the signed absolute max, like the reference encoder
    idx = np.abs(v).argmax(axis=1)
    mx = v[np.arange(v.shape[0]), idx]
    d = mx / -8.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(v * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    return np.concatenate([_to_f16_bytes(d.astype(np.float32)).reshape(-1, 2), lo | (hi << 4)], axis=1).reshape(-1)


def dequant_q4_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 20)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return (np.concatenate([lo, hi], axis=1) * d + m).astype(np.float32).reshape(-1)


def quant_q4_1(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 32)
    mn, mx = v.min(axis=1), v.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round((v - mn[:, None]) * inv[:, None]), 0, 15).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    return np.concatenate(
        [_to_f16_bytes(d).reshape(-1, 2), _to_f16_bytes(mn).reshape(-1, 2), lo | (hi << 4)], axis=1
    ).reshape(-1)


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


def quant_q5_0(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 32)
    idx = np.abs(v).argmax(axis=1)
    mx = v[np.arange(v.shape[0]), idx]
    d = mx / -16.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(v * inv[:, None]) + 16, 0, 31).astype(np.uint8)
    lo5, hi5 = q[:, :16], q[:, 16:]
    qs = (lo5 & 0x0F) | ((hi5 & 0x0F) << 4)
    j = np.arange(16, dtype=np.uint32)
    qh = ((lo5 >> 4).astype(np.uint32) << j).sum(axis=1, dtype=np.uint32) | (
        (hi5 >> 4).astype(np.uint32) << (j + 16)
    ).sum(axis=1, dtype=np.uint32)
    return np.concatenate(
        [_to_f16_bytes(d).reshape(-1, 2), qh.astype("<u4").view(np.uint8).reshape(-1, 4), qs], axis=1
    ).reshape(-1)


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


def quant_q5_1(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 32)
    mn, mx = v.min(axis=1), v.max(axis=1)
    d = (mx - mn) / 31.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round((v - mn[:, None]) * inv[:, None]), 0, 31).astype(np.uint8)
    lo5, hi5 = q[:, :16], q[:, 16:]
    qs = (lo5 & 0x0F) | ((hi5 & 0x0F) << 4)
    j = np.arange(16, dtype=np.uint32)
    qh = ((lo5 >> 4).astype(np.uint32) << j).sum(axis=1, dtype=np.uint32) | (
        (hi5 >> 4).astype(np.uint32) << (j + 16)
    ).sum(axis=1, dtype=np.uint32)
    return np.concatenate(
        [
            _to_f16_bytes(d).reshape(-1, 2),
            _to_f16_bytes(mn).reshape(-1, 2),
            qh.astype("<u4").view(np.uint8).reshape(-1, 4),
            qs,
        ],
        axis=1,
    ).reshape(-1)


def dequant_q8_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 34)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].view(np.int8).astype(np.float32)
    return (qs * d).astype(np.float32).reshape(-1)


def quant_q8_0(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 32)
    amax = np.abs(v).max(axis=1)
    d = amax / 127.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.round(v * inv[:, None]).astype(np.int8)
    return np.concatenate([_to_f16_bytes(d).reshape(-1, 2), q.view(np.uint8)], axis=1).reshape(-1)


def dequant_mxfp4(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 17)
    d = _e8m0_to_fp32_half(b[:, 0]).reshape(-1, 1)
    qs = b[:, 1:17]
    lo = _MXFP4[qs & 0x0F]
    hi = _MXFP4[qs >> 4]
    return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)


def quant_mxfp4(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 32)
    amax = np.abs(v).max(axis=1)
    e = _fp32_to_e8m0_half(amax / 12.0)
    d = _e8m0_to_fp32_half(e)[:, None]
    scaled = np.where(d > 0, v / np.where(d == 0, 1, d), 0.0)
    # nearest code in the signed fp4 table
    idx = np.abs(scaled[:, :, None] - _MXFP4[None, None, :]).argmin(axis=2).astype(np.uint8)
    lo, hi = idx[:, :16], idx[:, 16:]
    return np.concatenate([e.reshape(-1, 1), lo | (hi << 4)], axis=1).reshape(-1)


def dequant_iq4_nl(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:18]
    lo = _IQ4NL[qs & 0x0F]
    hi = _IQ4NL[qs >> 4]
    return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)


def quant_iq4_nl(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 32)
    idx_amax = np.abs(v).argmax(axis=1)
    mx = v[np.arange(v.shape[0]), idx_amax]
    d = mx / -127.0
    scaled = np.where(d[:, None] != 0, v / np.where(d[:, None] == 0, 1, d[:, None]), 0.0)
    code = np.abs(scaled[:, :, None] - _IQ4NL[None, None, :]).argmin(axis=2).astype(np.uint8)
    lo, hi = code[:, :16], code[:, 16:]
    return np.concatenate([_to_f16_bytes(d.astype(np.float32)).reshape(-1, 2), lo | (hi << 4)], axis=1).reshape(-1)


def quant_iq4_xs(x: np.ndarray) -> np.ndarray:
    """IQ4_XS encoder: per-32-block scale search over the NL codebook, block
    scales stored as 6-bit (ls−32) against an f16 superscale. Layout matches
    dequant_iq4_xs bit-for-bit (validated by the reference-decoder test);
    scale selection is straightforward search, not the reference's."""
    v = x.astype(np.float32).reshape(-1, 256)
    nsb = v.shape[0]
    blocks = v.reshape(nsb, 8, 32)
    amax = np.abs(blocks).max(axis=2)                         # (nsb, 8)
    # candidate scales: both sign conventions × a few multipliers
    cands = []
    for base in (-127.0, 113.0):
        for m in (0.85, 0.95, 1.0, 1.05):
            cands.append(amax / base * m)
    best_err = np.full((nsb, 8), np.inf, np.float32)
    best_s = np.zeros((nsb, 8), np.float32)
    for s in cands:
        s_safe = np.where(s == 0, 1.0, s)
        scaled = blocks / s_safe[:, :, None]
        code = np.abs(scaled[..., None] - _IQ4NL[None, None, None, :]).argmin(-1)
        rec = s[:, :, None] * _IQ4NL[code]
        err = ((blocks - rec) ** 2).sum(axis=2)
        upd = err < best_err
        best_err = np.where(upd, err, best_err)
        best_s = np.where(upd, s, best_s)
    # superscale: 6-bit signed block scales ls−32 ∈ [−32, 31]
    d = np.abs(best_s).max(axis=1) / 31.0                     # (nsb,)
    d16 = _f16(_to_f16_bytes(d).reshape(-1, 2)).reshape(-1)   # store-rounded
    d_safe = np.where(d16 == 0, 1.0, d16)
    ls = np.clip(np.round(best_s / d_safe[:, None]) + 32, 0, 63).astype(np.uint8)
    dl = d16[:, None] * (ls.astype(np.float32) - 32.0)
    dl_safe = np.where(dl == 0, 1.0, dl)
    code = np.abs((blocks / dl_safe[:, :, None])[..., None]
                  - _IQ4NL[None, None, None, :]).argmin(-1).astype(np.uint8)
    code = np.where((dl == 0)[:, :, None], 0, code)
    # pack: d f16 | scales_h u16 (2 hi bits per block) | scales_l 4B | qs 128B
    scales_h = np.zeros(nsb, np.uint16)
    for ib in range(8):
        scales_h |= ((ls[:, ib].astype(np.uint16) >> 4) & 3) << (2 * ib)
    scales_l = np.zeros((nsb, 4), np.uint8)
    for ib in range(8):
        scales_l[:, ib // 2] |= (ls[:, ib] & 0x0F) << (4 * (ib % 2))
    qs = (code[:, :, :16] | (code[:, :, 16:] << 4)).reshape(nsb, 128)
    out = np.concatenate([
        _to_f16_bytes(d16).reshape(-1, 2),
        scales_h.astype("<u2").view(np.uint8).reshape(-1, 2),
        scales_l, qs.astype(np.uint8)], axis=1)
    return out.reshape(-1)


# ================================ K-quants ==================================


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


def _pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_scale_min_k4; sc/mn are (nb,8) uint8 in [0,63]."""
    out = np.zeros((sc.shape[0], 12), dtype=np.uint8)
    for j in range(4):
        out[:, j] = (sc[:, j] & 63) | ((sc[:, j + 4] >> 4) << 6)
        out[:, j + 4] = (mn[:, j] & 63) | ((mn[:, j + 4] >> 4) << 6)
        out[:, j + 8] = (sc[:, j + 4] & 0x0F) | ((mn[:, j + 4] & 0x0F) << 4)
    return out


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


def quant_q2_k(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 16, 16)
    gmin = np.minimum(g.min(axis=2), 0.0)
    gmax = g.max(axis=2)
    dg = (gmax - gmin) / 3.0
    mg = -gmin
    d = dg.max(axis=1) / 15.0
    dmin = mg.max(axis=1) / 15.0
    ls = np.clip(np.round(np.where(d[:, None] > 0, dg / np.where(d[:, None] == 0, 1, d[:, None]), 0)), 0, 15)
    lm = np.clip(np.round(np.where(dmin[:, None] > 0, mg / np.where(dmin[:, None] == 0, 1, dmin[:, None]), 0)), 0, 15)
    d16 = _to_f16_bytes(d).view(np.dtype("<f2")).astype(np.float32)
    m16 = _to_f16_bytes(dmin).view(np.dtype("<f2")).astype(np.float32)
    dl = d16[:, None] * ls
    ml = m16[:, None] * lm
    q = np.clip(
        np.round(np.where(dl[:, :, None] > 0, (g + ml[:, :, None]) / np.where(dl[:, :, None] == 0, 1, dl[:, :, None]), 0)),
        0,
        3,
    ).astype(np.uint8)
    scales = (ls.astype(np.uint8) | (lm.astype(np.uint8) << 4)).astype(np.uint8)
    qs = np.zeros((nb, 64), dtype=np.uint8)
    is_ = 0
    for n in (0, 128):
        base = n // 4
        for shift in (0, 2, 4, 6):
            for half in (0, 16):
                qs[:, base + half : base + half + 16] |= q[:, is_] << shift
                is_ += 1
    return np.concatenate([scales, qs, _to_f16_bytes(d).reshape(-1, 2), _to_f16_bytes(dmin).reshape(-1, 2)], axis=1).reshape(-1)


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


def _q3k_pack_scales(sc: np.ndarray) -> np.ndarray:
    """Pack (nb,16) values in [0,63] into the q3_K 12-byte layout."""
    sc = sc.astype(np.uint32).reshape(-1, 4, 4)
    lo = sc & 0x0F          # low nibble of each 6-bit value
    hi = sc >> 4            # top 2 bits
    w = np.zeros((sc.shape[0], 3, 4), dtype=np.uint32)
    w[:, 0] = lo[:, 0] | (lo[:, 2] << 4)
    w[:, 1] = lo[:, 1] | (lo[:, 3] << 4)
    w[:, 2] = hi[:, 0] | (hi[:, 1] << 2) | (hi[:, 2] << 4) | (hi[:, 3] << 6)
    packed = np.zeros((sc.shape[0], 3), dtype=np.uint32)
    for byte in range(4):
        packed |= (w[:, :, byte] & 0xFF) << (8 * byte)
    return packed.astype("<u4").view(np.uint8).reshape(-1, 12)


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


def quant_q3_k(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 16, 16)
    amax = np.abs(g).max(axis=2)
    sg = amax / 4.0  # q in [-4,3]
    dmax = np.abs(sg).max(axis=1)
    d = dmax / 31.0  # scales stored as (s-32) in [-32,31]
    ls = np.clip(np.round(np.where(d[:, None] > 0, sg / np.where(d[:, None] == 0, 1, d[:, None]), 0)) + 32, 0, 63).astype(np.uint8)
    d16 = _to_f16_bytes(d).view(np.dtype("<f2")).astype(np.float32)
    dl = d16[:, None] * (ls.astype(np.float32) - 32.0)
    q = np.clip(
        np.round(np.where(np.abs(dl[:, :, None]) > 0, g / np.where(dl[:, :, None] == 0, 1, dl[:, :, None]), 0)),
        -4,
        3,
    ).astype(np.int8) + 4  # store 0..7
    qs = np.zeros((nb, 64), dtype=np.uint8)
    hm = np.zeros((nb, 32), dtype=np.uint8)
    is_ = 0
    m = 1
    for n in (0, 128):
        base = n // 4
        for shift in (0, 2, 4, 6):
            for half in (0, 16):
                grp = q[:, is_].astype(np.uint8)
                qs[:, base + half : base + half + 16] |= (grp & 3) << shift
                hm[:, half : half + 16] |= np.where(grp & 4, m, 0).astype(np.uint8)
                is_ += 1
            m <<= 1
    return np.concatenate([hm, qs, _q3k_pack_scales(ls), _to_f16_bytes(d).reshape(-1, 2)], axis=1).reshape(-1)


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


def quant_q4_k(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 8, 32)
    gmin = np.minimum(g.min(axis=2), 0.0)
    gmax = g.max(axis=2)
    dg = (gmax - gmin) / 15.0
    mg = -gmin
    d = dg.max(axis=1) / 63.0
    dmin = mg.max(axis=1) / 63.0
    ls = np.clip(np.round(np.where(d[:, None] > 0, dg / np.where(d[:, None] == 0, 1, d[:, None]), 0)), 0, 63).astype(np.uint8)
    lm = np.clip(np.round(np.where(dmin[:, None] > 0, mg / np.where(dmin[:, None] == 0, 1, dmin[:, None]), 0)), 0, 63).astype(np.uint8)
    d16 = _to_f16_bytes(d).view(np.dtype("<f2")).astype(np.float32)
    m16 = _to_f16_bytes(dmin).view(np.dtype("<f2")).astype(np.float32)
    dl = d16[:, None] * ls
    ml = m16[:, None] * lm
    q = np.clip(
        np.round(np.where(dl[:, :, None] > 0, (g + ml[:, :, None]) / np.where(dl[:, :, None] == 0, 1, dl[:, :, None]), 0)),
        0,
        15,
    ).astype(np.uint8)
    qs = np.empty((nb, 128), dtype=np.uint8)
    for j in range(4):
        qs[:, j * 32 : (j + 1) * 32] = q[:, 2 * j] | (q[:, 2 * j + 1] << 4)
    return np.concatenate(
        [_to_f16_bytes(d).reshape(-1, 2), _to_f16_bytes(dmin).reshape(-1, 2), _pack_scale_min_k4(ls, lm), qs], axis=1
    ).reshape(-1)


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


def quant_q5_k(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 8, 32)
    gmin = np.minimum(g.min(axis=2), 0.0)
    gmax = g.max(axis=2)
    dg = (gmax - gmin) / 31.0
    mg = -gmin
    d = dg.max(axis=1) / 63.0
    dmin = mg.max(axis=1) / 63.0
    ls = np.clip(np.round(np.where(d[:, None] > 0, dg / np.where(d[:, None] == 0, 1, d[:, None]), 0)), 0, 63).astype(np.uint8)
    lm = np.clip(np.round(np.where(dmin[:, None] > 0, mg / np.where(dmin[:, None] == 0, 1, dmin[:, None]), 0)), 0, 63).astype(np.uint8)
    d16 = _to_f16_bytes(d).view(np.dtype("<f2")).astype(np.float32)
    m16 = _to_f16_bytes(dmin).view(np.dtype("<f2")).astype(np.float32)
    dl = d16[:, None] * ls
    ml = m16[:, None] * lm
    q = np.clip(
        np.round(np.where(dl[:, :, None] > 0, (g + ml[:, :, None]) / np.where(dl[:, :, None] == 0, 1, dl[:, :, None]), 0)),
        0,
        31,
    ).astype(np.uint8)
    ql = np.empty((nb, 128), dtype=np.uint8)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for j in range(4):
        q1, q2 = q[:, 2 * j], q[:, 2 * j + 1]
        ql[:, j * 32 : (j + 1) * 32] = (q1 & 0x0F) | ((q2 & 0x0F) << 4)
        qh |= np.where(q1 & 16, 1 << (2 * j), 0).astype(np.uint8)
        qh |= np.where(q2 & 16, 2 << (2 * j), 0).astype(np.uint8)
    return np.concatenate(
        [_to_f16_bytes(d).reshape(-1, 2), _to_f16_bytes(dmin).reshape(-1, 2), _pack_scale_min_k4(ls, lm), qh, ql],
        axis=1,
    ).reshape(-1)


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


def quant_q6_k(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 256)
    nb = v.shape[0]
    g = v.reshape(nb, 16, 16)
    idx = np.abs(g).argmax(axis=2)
    mx = np.take_along_axis(g, idx[:, :, None], axis=2)[:, :, 0]
    sg = mx / -32.0
    amax_s = np.abs(sg).max(axis=1)
    d = amax_s / 127.0
    ls = np.clip(np.round(np.where(d[:, None] > 0, sg / np.where(d[:, None] == 0, 1, d[:, None]), 0)), -128, 127).astype(np.int8)
    d16 = _to_f16_bytes(d).view(np.dtype("<f2")).astype(np.float32)
    dl = d16[:, None] * ls.astype(np.float32)
    q = (
        np.clip(
            np.round(np.where(np.abs(dl[:, :, None]) > 0, g / np.where(dl[:, :, None] == 0, 1, dl[:, :, None]), 0)),
            -32,
            31,
        ).astype(np.int8)
        + 32
    ).astype(np.uint8)  # (nb,16,16) values 0..63
    q = q.reshape(nb, 256)
    ql = np.zeros((nb, 128), dtype=np.uint8)
    qh = np.zeros((nb, 64), dtype=np.uint8)
    for n in (0, 128):
        q1 = q[:, n + 0 : n + 32]
        q2 = q[:, n + 32 : n + 64]
        q3 = q[:, n + 64 : n + 96]
        q4 = q[:, n + 96 : n + 128]
        ql[:, n // 2 : n // 2 + 32] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
        ql[:, n // 2 + 32 : n // 2 + 64] = (q2 & 0x0F) | ((q4 & 0x0F) << 4)
        qh[:, n // 4 : n // 4 + 32] = (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
    return np.concatenate([ql, qh, ls.view(np.uint8), _to_f16_bytes(d).reshape(-1, 2)], axis=1).reshape(-1)


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


# ===================== codebook i-quants (IQ1/IQ2/IQ3) ======================
#
# These decode through trained lattice codebooks shipped as wire-format data
# (iq_grids.npz, extracted from the ecosystem's shared tables — see
# _gen_iq_grids.py). Semantics mirror dequantize_row_iq* in the reference
# (ggml/src/ggml-quants.c:2275-2510), vectorized over blocks.

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


# 7-bit sign index → 8 sign bits, bit 7 = odd parity (ksigns_iq2xs)
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


# ============================ scalar fp formats =============================


# ================= i-quant / ternary / Q8_K encoders =======================
#
# Layouts are the exact inverses of the dequantizers above (validated by the
# reference-decoder oracle tests). Codeword selection is a vectorized
# two-pass fit — scale-free cosine pick over the lattice grid, then a shared
# least-squares scale per scale-group — rather than the reference's greedy
# neighbour-table search (ggml-quants.c quantize_row_iq*): simpler, fully
# vectorized, and within a few percent of its round-trip error.


def quant_q8_k(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 256)
    amax = np.abs(v).max(axis=1)
    d = amax / 127.0
    d_safe = np.where(d == 0, 1.0, d)
    q = np.clip(np.round(v / d_safe[:, None]), -127, 127).astype(np.int8)
    q = np.where((d == 0)[:, None], np.int8(0), q)
    bsums = q.reshape(-1, 16, 16).astype(np.int32).sum(axis=2).astype("<i2")
    out = np.concatenate([
        d.astype("<f4").view(np.uint8).reshape(-1, 4),
        q.view(np.uint8), bsums.view(np.uint8).reshape(-1, 32)], axis=1)
    return out.reshape(-1)


def quant_tq2_0(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 256)
    d = np.abs(v).max(axis=1)
    d_safe = np.where(d == 0, 1.0, d)
    q = (np.clip(np.round(v / d_safe[:, None]), -1, 1) + 1).astype(np.uint8)
    qs = np.zeros((v.shape[0], 64), np.uint8)
    pos = 0
    for j in (0, 32):
        for shift in (0, 2, 4, 6):
            qs[:, j:j + 32] |= q[:, pos:pos + 32] << shift
            pos += 32
    return np.concatenate([qs, _to_f16_bytes(d).reshape(-1, 2)],
                          axis=1).reshape(-1)


def quant_tq1_0(x: np.ndarray) -> np.ndarray:
    """Ternary base-3 packing (quantize_row_tq1_0_ref): 5 trits per byte for
    the first 240 elements, 4 trits per byte for the last 16."""
    v = x.astype(np.float32).reshape(-1, 256)
    nb = v.shape[0]
    d = np.abs(v).max(axis=1)
    d_safe = np.where(d == 0, 1.0, d)
    q = (np.clip(np.round(v / d_safe[:, None]), -1, 1) + 1).astype(np.uint16)
    qs = np.zeros((nb, 48), np.uint16)
    pos = 0
    for j, width in ((0, 32), (32, 16)):
        acc = np.zeros((nb, width), np.uint16)
        for _m in range(5):
            acc = acc * 3 + q[:, pos:pos + width]
            pos += width
        qs[:, j:j + width] = (acc * 256 + 242) // 243
    acc = np.zeros((nb, 4), np.uint16)
    for _m in range(4):
        acc = acc * 3 + q[:, pos:pos + 4]
        pos += 4
    qh = (acc * 256 + 80) // 81     # 4 trits/byte → 3⁴ divisor
    return np.concatenate([
        qs.astype(np.uint8), qh.astype(np.uint8),
        _to_f16_bytes(d).reshape(-1, 2)], axis=1).reshape(-1)


def _cos_pick(a: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Scale-free codeword pick: argmax <a, c>/||c|| over grid rows.
    a: (..., n) non-negative magnitudes; grid: (C, n) float."""
    gn = grid / np.sqrt((grid ** 2).sum(-1, keepdims=True))
    return (a @ gn.T).argmax(-1)


def _l2_pick(a: np.ndarray, grid: np.ndarray, db: np.ndarray) -> np.ndarray:
    """Refinement pick: argmin ||db·c − a||² given the quantized group scale
    db (broadcast per row); beats the scale-free cosine pick on short
    segments (IQ3's 4-element codewords)."""
    g2 = (grid ** 2).sum(-1)
    dots = a @ grid.T
    score = db[..., None] ** 2 * g2 - 2.0 * db[..., None] * dots
    return score.argmin(-1)


def _ls_fit(a: np.ndarray, c: np.ndarray, axes) -> np.ndarray:
    """Least-squares shared scale β = <a,c>/<c,c> over the given axes."""
    num = (a * c).sum(axis=axes)
    den = (c * c).sum(axis=axes)
    return np.maximum(num, 0.0) / np.where(den == 0, 1.0, den)


def _sign_index_parity(v: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """7-bit ksigns index for groups of 8 (bit 7 of the decoded pattern is
    the parity of bits 0-6): when the desired sign pattern is unrepresentable
    flip the element with the smallest |contribution|."""
    neg = v < 0                                    # (..., 8)
    par7 = (neg[..., :7].sum(-1) & 1).astype(bool)
    mism = par7 != neg[..., 7]
    jmin = cost.argmin(-1)                         # cheapest element to flip
    s = neg[..., :7].copy()
    flip = (mism & (jmin < 7))[..., None] & (
        np.arange(7) == jmin[..., None])
    s = s ^ flip
    return (s << np.arange(7)).sum(-1).astype(np.uint32)


def _quant_scales_4bit(beta: np.ndarray, mult: float):
    """Map per-group scales β to (d f16, 4-bit ls) with db = d·(0.5+ls)·mult;
    beta: (nb, G)."""
    d = beta.max(axis=1) / (15.5 * mult)
    d16 = _f16(_to_f16_bytes(d).reshape(-1, 2)).reshape(-1)
    d_safe = np.where(d16 == 0, 1.0, d16)
    ls = np.clip(np.round(beta / d_safe[:, None] / mult - 0.5),
                 0, 15).astype(np.uint32)
    return d16, ls


def quant_iq2_xxs(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 8, 4, 8)   # (nb, sub, group, 8)
    nb = v.shape[0]
    a = np.abs(v)
    grid = _iq_grids()["iq2xxs"].astype(np.float32)
    gidx = _cos_pick(a, grid)                       # (nb, 8, 4)
    c = grid[gidx]
    beta = _ls_fit(a, c, (2, 3))                    # per sub-block
    d16, ls = _quant_scales_4bit(beta, 0.25)
    db = d16[:, None] * (0.5 + ls) * 0.25           # (nb, 8)
    gidx = _l2_pick(a, grid, db[:, :, None])        # refine vs quantized db
    c = grid[gidx]
    beta = _ls_fit(a, c, (2, 3))
    d16, ls = _quant_scales_4bit(beta, 0.25)
    sidx = _sign_index_parity(v, a * c)             # (nb, 8, 4)
    aux0 = (gidx.astype(np.uint32)
            << (8 * np.arange(4, dtype=np.uint32))).sum(-1)
    aux1 = ((sidx << (7 * np.arange(4, dtype=np.uint32))).sum(-1)
            | (ls << 28))
    q16 = np.empty((nb, 8, 4), "<u2")
    q16[:, :, 0] = aux0 & 0xFFFF
    q16[:, :, 1] = aux0 >> 16
    q16[:, :, 2] = aux1 & 0xFFFF
    q16[:, :, 3] = aux1 >> 16
    return np.concatenate([
        _to_f16_bytes(d16).reshape(-1, 2),
        q16.view(np.uint8).reshape(nb, 64)], axis=1).reshape(-1)


def quant_iq2_xs(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 8, 4, 8)
    nb = v.shape[0]
    a = np.abs(v)
    grid = _iq_grids()["iq2xs"].astype(np.float32)
    gidx = _cos_pick(a, grid)                       # (nb, 8, 4)
    c = grid[gidx]
    # scale per 16 elements (2 groups): (nb, 8, 2)
    beta = _ls_fit(a.reshape(nb, 8, 2, 16), c.reshape(nb, 8, 2, 16), (3,))
    d16, ls = _quant_scales_4bit(beta.reshape(nb, 16), 0.25)
    ls = ls.reshape(nb, 8, 2)
    db = d16[:, None, None] * (0.5 + ls) * 0.25     # (nb, 8, 2)
    gidx = _l2_pick(a, grid, db[:, :, [0, 0, 1, 1]])
    c = grid[gidx]
    beta = _ls_fit(a.reshape(nb, 8, 2, 16), c.reshape(nb, 8, 2, 16), (3,))
    d16, ls = _quant_scales_4bit(beta.reshape(nb, 16), 0.25)
    ls = ls.reshape(nb, 8, 2)
    sidx = _sign_index_parity(v, a * c)
    q16 = (gidx.astype("<u2") | (sidx.astype("<u2") << 9))
    sc = (ls[:, :, 0] | (ls[:, :, 1] << 4)).astype(np.uint8)
    return np.concatenate([
        _to_f16_bytes(d16).reshape(-1, 2),
        q16.view(np.uint8).reshape(nb, 64), sc], axis=1).reshape(-1)


def quant_iq2_s(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 8, 4, 8)
    nb = v.shape[0]
    a = np.abs(v)
    grid = _iq_grids()["iq2s"].astype(np.float32)
    gidx = _cos_pick(a, grid).astype(np.uint32)     # (nb, 8, 4) 10-bit
    c = grid[gidx]
    beta = _ls_fit(a.reshape(nb, 8, 2, 16), c.reshape(nb, 8, 2, 16), (3,))
    d16, ls = _quant_scales_4bit(beta.reshape(nb, 16), 0.25)
    ls = ls.reshape(nb, 8, 2)
    db = d16[:, None, None] * (0.5 + ls) * 0.25
    gidx = _l2_pick(a, grid, db[:, :, [0, 0, 1, 1]]).astype(np.uint32)
    c = grid[gidx]
    beta = _ls_fit(a.reshape(nb, 8, 2, 16), c.reshape(nb, 8, 2, 16), (3,))
    d16, ls = _quant_scales_4bit(beta.reshape(nb, 16), 0.25)
    ls = ls.reshape(nb, 8, 2)
    signs = ((v < 0) << np.arange(8)).sum(-1).astype(np.uint8)  # explicit
    qs = (gidx & 0xFF).astype(np.uint8)
    hi = gidx >> 8                                  # 2 bits per group
    qh = (hi << (2 * np.arange(4, dtype=np.uint32))).sum(-1).astype(np.uint8)
    sc = (ls[:, :, 0] | (ls[:, :, 1] << 4)).astype(np.uint8)
    return np.concatenate([
        _to_f16_bytes(d16).reshape(-1, 2),
        qs.reshape(nb, 32), signs.reshape(nb, 32), qh, sc],
        axis=1).reshape(-1)


def quant_iq3_xxs(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 8, 4, 8)
    nb = v.shape[0]
    a4 = np.abs(v).reshape(nb, 8, 8, 4)             # 4-element segments
    grid = _iq_grids()["iq3xxs"].astype(np.float32)
    gidx = _cos_pick(a4, grid)                      # (nb, 8, 8)
    c = grid[gidx].reshape(nb, 8, 4, 8)
    beta = _ls_fit(np.abs(v), c, (2, 3))            # per sub-block
    d16, ls = _quant_scales_4bit(beta, 0.5)
    db = d16[:, None] * (0.5 + ls) * 0.5            # (nb, 8)
    gidx = _l2_pick(a4, grid, np.broadcast_to(
        db[:, :, None], (nb, 8, 8)))
    c = grid[gidx].reshape(nb, 8, 4, 8)
    beta = _ls_fit(np.abs(v), c, (2, 3))
    d16, ls = _quant_scales_4bit(beta, 0.5)
    sidx = _sign_index_parity(v, np.abs(v) * c)     # (nb, 8, 4)
    sas = ((sidx << (7 * np.arange(4, dtype=np.uint32))).sum(-1)
           | (ls << 28)).astype("<u4")
    return np.concatenate([
        _to_f16_bytes(d16).reshape(-1, 2),
        gidx.astype(np.uint8).reshape(nb, 64),
        sas.view(np.uint8).reshape(nb, 32)], axis=1).reshape(-1)


def quant_iq3_s(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 8, 4, 8)
    nb = v.shape[0]
    a4 = np.abs(v).reshape(nb, 8, 8, 4)
    grid = _iq_grids()["iq3s"].astype(np.float32)
    gidx = _cos_pick(a4, grid).astype(np.uint32)    # (nb, 8, 8) 9-bit

    def _fit_scales(c):
        beta = _ls_fit(np.abs(v), c, (2, 3))        # per sub-block (nb, 8)
        d = beta.max(axis=1) / 31.0                 # db = d·(1+2·ls), ls≤15
        d16 = _f16(_to_f16_bytes(d).reshape(-1, 2)).reshape(-1)
        d_safe = np.where(d16 == 0, 1.0, d16)
        ls = np.clip(np.round((beta / d_safe[:, None] - 1.0) / 2.0),
                     0, 15).astype(np.uint8)
        return d16, ls

    c = grid[gidx].reshape(nb, 8, 4, 8)
    d16, ls = _fit_scales(c)
    db = d16[:, None] * (1.0 + 2.0 * ls.astype(np.float32))
    gidx = _l2_pick(a4, grid, np.broadcast_to(
        db[:, :, None], (nb, 8, 8))).astype(np.uint32)
    c = grid[gidx].reshape(nb, 8, 4, 8)
    d16, ls = _fit_scales(c)
    signs = ((v < 0) << np.arange(8)).sum(-1).astype(np.uint8)
    gseg = gidx.reshape(nb, 8, 4, 2)
    qs = (gseg & 0xFF).astype(np.uint8)
    hi = gseg >> 8                                  # 1 bit per segment
    qh = ((hi[..., 0] << (2 * np.arange(4, dtype=np.uint32)))
          | (hi[..., 1] << (2 * np.arange(4, dtype=np.uint32) + 1))
          ).sum(-1).astype(np.uint8)
    sc = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    return np.concatenate([
        _to_f16_bytes(d16).reshape(-1, 2),
        qs.reshape(nb, 64), qh, signs.reshape(nb, 32), sc],
        axis=1).reshape(-1)


def _iq1_pick(v: np.ndarray, grid: np.ndarray, deltas) -> tuple:
    """Joint (codeword, δ) pick for IQ1 groups of 8: cosine over the signed
    candidates (g + δ); returns (gidx, dsel, c) with c the chosen signed
    codeword including δ."""
    cands = np.concatenate([grid + dl for dl in deltas])  # (|Δ|·C, 8)
    pick = _cos_pick(v, cands)                            # signed match
    C = grid.shape[0]
    dsel = (pick // C).astype(np.uint8)
    gidx = (pick % C).astype(np.uint32)
    c = cands[pick]
    return gidx, dsel, c


def quant_iq1_s(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 8, 4, 8)
    nb = v.shape[0]
    grid = _iq_grids()["iq1s"].astype(np.float32)
    # one δ sign per SUB-BLOCK: pick by the sign of the sub-block mean
    dneg = v.reshape(nb, 8, 32).sum(-1) < 0         # (nb, 8)
    # cosine pick against (g + δ_ib) per sub-block
    gidx = np.empty((nb, 8, 4), np.uint32)
    c = np.empty_like(v)
    for s in (False, True):                         # two δ signs, vectorized
        m = dneg == s
        if not m.any():
            continue
        g = grid + (-_IQ1_DELTA if s else _IQ1_DELTA)
        sel = _cos_pick(v[m], g)
        gidx[m] = sel.astype(np.uint32)
        c[m] = g[sel]
    beta = _ls_fit(v, c, (2, 3))                    # per sub-block (nb, 8)
    d = beta.max(axis=1) / 15.0                     # dl = d·(2s+1), s≤7
    d16 = _f16(_to_f16_bytes(d).reshape(-1, 2)).reshape(-1)
    d_safe = np.where(d16 == 0, 1.0, d16)
    sc = np.clip(np.round((beta / d_safe[:, None] - 1.0) / 2.0),
                 0, 7).astype(np.uint16)
    qs = (gidx & 0xFF).astype(np.uint8)
    hi3 = (gidx >> 8).astype(np.uint16)             # 3 bits per group
    qh = ((hi3 << (3 * np.arange(4, dtype=np.uint16))).sum(-1)
          | (sc << 12) | (dneg.astype(np.uint16) << 15)).astype("<u2")
    return np.concatenate([
        _to_f16_bytes(d16).reshape(-1, 2),
        qs.reshape(nb, 32), qh.view(np.uint8)], axis=1).reshape(-1)


def quant_iq1_m(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.float32).reshape(-1, 8, 4, 8)
    nb = v.shape[0]
    grid = _iq_grids()["iq1s"].astype(np.float32)
    # per-GROUP δ sign: joint (codeword, δ) cosine pick
    gidx, dsel, c = _iq1_pick(v, grid, (_IQ1_DELTA, -_IQ1_DELTA))
    beta = _ls_fit(v.reshape(nb, 8, 2, 16), c.reshape(nb, 8, 2, 16), (3,))
    d = beta.max(axis=(1, 2)) / 15.0                # dl = d·(2s+1), s≤7
    d16 = _f16(_to_f16_bytes(d).reshape(-1, 2)).reshape(-1)
    d_safe = np.where(d16 == 0, 1.0, d16)
    s3 = np.clip(np.round((beta / d_safe[:, None, None] - 1.0) / 2.0),
                 0, 7).astype(np.uint16)            # (nb, 8, 2)
    qs = (gidx & 0xFF).astype(np.uint8)             # (nb, 8, 4)
    hi3 = (gidx >> 8).astype(np.uint8)
    hb = dsel                                       # 1 = negative δ
    qh = np.zeros((nb, 8, 2), np.uint8)
    qh[:, :, 0] = hi3[:, :, 0] | (hb[:, :, 0] << 3) | (hi3[:, :, 1] << 4) \
        | (hb[:, :, 1] << 7)
    qh[:, :, 1] = hi3[:, :, 2] | (hb[:, :, 2] << 3) | (hi3[:, :, 3] << 4) \
        | (hb[:, :, 3] << 7)
    # sc: four u16 words — two 3-bit scales per sub-block in bits 0-11,
    # the f16 superscale split as a nibble in bits 12-15 of each word
    d16u = _to_f16_bytes(d16).reshape(-1, 2).view("<u2").reshape(-1)
    sc = np.zeros((nb, 4), np.uint16)
    for ib in range(8):
        sh = 6 * (ib % 2)
        sc[:, ib // 2] |= (s3[:, ib, 0] << sh) | (s3[:, ib, 1] << (sh + 3))
    sc[:, 0] |= ((d16u >> 0) & 0xF) << 12
    sc[:, 1] |= ((d16u >> 4) & 0xF) << 12
    sc[:, 2] |= ((d16u >> 8) & 0xF) << 12
    sc[:, 3] |= ((d16u >> 12) & 0xF) << 12
    return np.concatenate([
        qs.reshape(nb, 32), qh.reshape(nb, 16),
        sc.astype("<u2").view(np.uint8).reshape(nb, 8)], axis=1).reshape(-1)


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


# ============================== dispatch ====================================

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

QUANTIZERS = {
    GGMLType.F32: quant_f32,
    GGMLType.F16: quant_f16,
    GGMLType.BF16: quant_bf16,
    GGMLType.Q4_0: quant_q4_0,
    GGMLType.Q4_1: quant_q4_1,
    GGMLType.Q5_0: quant_q5_0,
    GGMLType.Q5_1: quant_q5_1,
    GGMLType.Q8_0: quant_q8_0,
    GGMLType.MXFP4: quant_mxfp4,
    GGMLType.Q2_K: quant_q2_k,
    GGMLType.Q3_K: quant_q3_k,
    GGMLType.Q4_K: quant_q4_k,
    GGMLType.Q5_K: quant_q5_k,
    GGMLType.Q6_K: quant_q6_k,
    GGMLType.IQ4_NL: quant_iq4_nl,
    GGMLType.IQ4_XS: quant_iq4_xs,
    GGMLType.Q8_K: quant_q8_k,
    GGMLType.TQ1_0: quant_tq1_0,
    GGMLType.TQ2_0: quant_tq2_0,
    GGMLType.IQ2_XXS: quant_iq2_xxs,
    GGMLType.IQ2_XS: quant_iq2_xs,
    GGMLType.IQ2_S: quant_iq2_s,
    GGMLType.IQ3_XXS: quant_iq3_xxs,
    GGMLType.IQ3_S: quant_iq3_s,
    GGMLType.IQ1_S: quant_iq1_s,
    GGMLType.IQ1_M: quant_iq1_m,
}


def dequantize(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Decode a byte buffer of the given wire type to float32 (optionally
    reshaped), through the native codecs for the types they cover."""
    fn = DEQUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"no dequantizer for {ggml_type.name}")
    buf = np.frombuffer(raw.tobytes() if isinstance(raw, np.ndarray) else bytes(raw), dtype=np.uint8)
    tr = GGML_TYPE_TRAITS.get(ggml_type)
    if tr is not None:
        from .. import native

        out = native.dequantize(buf, int(ggml_type), tr.block_size, tr.type_size)
        if out is not None:
            return out.reshape(shape) if shape is not None else out
    out = fn(buf)
    return out.reshape(shape) if shape is not None else out


def _by_rows(fn, x: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """``fn(x, qw)`` over slices of about 128K values of x's rows: their
    temporaries stay in cache, about twice as fast as one call over a large
    tensor (threads over the slices were slower still: the searches' many
    small array operations hold the GIL). Every superblock is encoded on
    its own, so the bytes are those of one call."""
    rows = x.reshape(-1, x.shape[-1])
    step = max(1, (1 << 17) // rows.shape[1])
    return np.concatenate([fn(rows[i:i + step], qw) for i in range(0, len(rows), step)])


def quantize(x: np.ndarray, ggml_type: GGMLType,
             qw: np.ndarray | None = None) -> np.ndarray:
    """Encode float data (row length = last axis, multiple of block size) to
    bytes, through the native encoders for the types they cover.

    ``qw``: optional imatrix importance row (n_per_row floats) — routes
    K-quants through the imatrix-weighted searches (quantize_row_*_K_impl
    semantics, src/llama-quant.cpp:431-457; numpy, over slices of rows);
    other types ignore it (callers apply their own weighted rescale)."""
    fn = QUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"no quantizer for {ggml_type.name}")
    tr = GGML_TYPE_TRAITS[ggml_type]
    if x.shape[-1] % tr.block_size != 0:
        raise ValueError(f"row size {x.shape[-1]} not a multiple of {tr.block_size} for {ggml_type.name}")
    xf = np.ascontiguousarray(x, dtype=np.float32)
    if qw is not None and ggml_type in SEARCH_IMATRIX:
        return _by_rows(SEARCH_IMATRIX[ggml_type], xf, np.ascontiguousarray(qw, np.float32))
    from .. import native

    out = native.quantize(xf, int(ggml_type), tr.block_size, tr.type_size)
    if out is not None:
        return out
    return fn(xf)


# --- weighted-search K-quant encoders override the one-shot min/max rounds
# (quantize_row_*_K_ref run the same searches in llama.cpp; the min/max
# versions above remain importable). Bottom import: kquant_search needs the
# packing helpers defined above.
from .kquant_search import SEARCH_QUANTIZERS as _SEARCH  # noqa: E402

QUANTIZERS[GGMLType.Q2_K] = _SEARCH["Q2_K"]
QUANTIZERS[GGMLType.Q3_K] = _SEARCH["Q3_K"]
QUANTIZERS[GGMLType.Q4_K] = _SEARCH["Q4_K"]
QUANTIZERS[GGMLType.Q5_K] = _SEARCH["Q5_K"]
QUANTIZERS[GGMLType.Q6_K] = _SEARCH["Q6_K"]
# imatrix-weighted impl variants (used by quantize(..., qw=...))
SEARCH_IMATRIX = {
    GGMLType.Q2_K: lambda x, qw: _SEARCH["Q2_K"](x, qw),
    GGMLType.Q3_K: lambda x, qw: _SEARCH["Q3_K"](x, qw),
    GGMLType.Q4_K: lambda x, qw: _SEARCH["Q4_K"](x, qw),
    GGMLType.Q5_K: lambda x, qw: _SEARCH["Q5_K"](x, qw),
    GGMLType.Q6_K: lambda x, qw: _SEARCH["Q6_K"](x, qw),
}
