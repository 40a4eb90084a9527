"""Numpy decoders for the ggml block formats the port loads.

A subset of the JAX package's ``gguf/quants.py``: the float formats plus the
Q8_0, Q4_K and Q6_K block decoders (``dequantize_row_*`` semantics of
ggml-quants.c), bit-exact with the JAX package's decoders. Other formats raise
``NotImplementedError`` until a later slice ports them.
"""

from __future__ import annotations

import numpy as np

from .constants import GGMLType


def _f16(raw: np.ndarray) -> np.ndarray:
    """View little-endian fp16 bytes (N,2) as float32 (N,)."""
    return np.ascontiguousarray(raw).view(np.dtype("<f2")).astype(np.float32).reshape(raw.shape[0], -1)


def _blocks(raw: np.ndarray, type_size: int) -> np.ndarray:
    raw = np.frombuffer(raw.tobytes(), dtype=np.uint8) if not raw.flags.c_contiguous else raw
    if raw.size % type_size != 0:
        raise ValueError(f"byte size {raw.size} not a multiple of block type size {type_size}")
    return raw.reshape(-1, type_size)


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


def dequant_q8_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 34)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].view(np.int8).astype(np.float32)
    return (qs * d).astype(np.float32).reshape(-1)


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


def dequant_f32(raw: np.ndarray) -> np.ndarray:
    return np.frombuffer(raw.tobytes(), dtype="<f4").astype(np.float32)


def dequant_f16(raw: np.ndarray) -> np.ndarray:
    return np.frombuffer(raw.tobytes(), dtype="<f2").astype(np.float32)


def dequant_bf16(raw: np.ndarray) -> np.ndarray:
    u = np.frombuffer(raw.tobytes(), dtype="<u2").astype(np.uint32) << 16
    return u.view(np.float32)


DEQUANTIZERS = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.BF16: dequant_bf16,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q6_K: dequant_q6_k,
}


def dequantize(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Decode a byte buffer of the given wire type to float32 (optionally
    reshaped)."""
    fn = DEQUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"no dequantizer for {ggml_type.name} in the port yet")
    buf = np.frombuffer(raw.tobytes() if isinstance(raw, np.ndarray) else bytes(raw), dtype=np.uint8)
    out = fn(buf)
    return out.reshape(shape) if shape is not None else out
