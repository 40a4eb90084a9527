"""GGUF v2/v3 container reader (mmap-backed, zero-copy tensor views).

Implements the byte layout documented in reference ggml/include/gguf.h:1-33.
Replaces the reference's llama_model_loader + gguf.cpp reader
(src/llama-model-loader.cpp, ggml/src/gguf.cpp) for the TPU framework.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .constants import (
    GGML_TYPE_TRAITS,
    GGMLType,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_KEY_ALIGNMENT,
    GGUF_MAGIC,
    GGUFValueType,
)
from .quants import dequantize

_SCALAR_FMT = {
    GGUFValueType.UINT8: ("<B", 1),
    GGUFValueType.INT8: ("<b", 1),
    GGUFValueType.UINT16: ("<H", 2),
    GGUFValueType.INT16: ("<h", 2),
    GGUFValueType.UINT32: ("<I", 4),
    GGUFValueType.INT32: ("<i", 4),
    GGUFValueType.FLOAT32: ("<f", 4),
    GGUFValueType.BOOL: ("<b", 1),
    GGUFValueType.UINT64: ("<Q", 8),
    GGUFValueType.INT64: ("<q", 8),
    GGUFValueType.FLOAT64: ("<d", 8),
}

_SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.BOOL: np.int8,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


@dataclass
class TensorInfo:
    """One tensor entry: logical shape uses ggml order ne[0..n] where ne[0] is
    the contiguous (row) dimension; ``shape`` here is numpy order (reversed)."""

    name: str
    ggml_type: GGMLType
    ne: tuple[int, ...]          # ggml dim order, ne[0] = innermost
    offset: int                  # relative to data section start
    reader: "GGUFReader" = field(repr=False, default=None)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(reversed(self.ne))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        tr = GGML_TYPE_TRAITS[self.ggml_type]
        return self.n_elements // tr.block_size * tr.type_size

    def raw(self) -> np.ndarray:
        """Zero-copy uint8 view of the packed tensor bytes."""
        start = self.reader.data_offset + self.offset
        return self.reader.buf[start : start + self.n_bytes]

    def astype_f32(self) -> np.ndarray:
        """Dequantize to a float32 array of numpy shape."""
        return dequantize(self.raw(), self.ggml_type, self.shape)


class GGUFReader:
    """Memory-mapped GGUF reader.

    >>> r = GGUFReader(path)
    >>> r.metadata["general.architecture"]
    >>> r.tensors["token_embd.weight"].astype_f32()
    """

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self.buf = np.frombuffer(self._mm, dtype=np.uint8)
        self._pos = 0

        magic = self._read_bytes(4)
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic={magic!r})")
        self.version = self._unpack("<I")
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = self._unpack("<q")
        n_kv = self._unpack("<q")

        self.metadata: dict[str, Any] = {}
        self.metadata_types: dict[str, GGUFValueType] = {}
        for _ in range(n_kv):
            key = self._read_str()
            vtype = GGUFValueType(self._unpack("<i"))
            self.metadata[key] = self._read_value(vtype)
            self.metadata_types[key] = vtype

        self.alignment = int(self.metadata.get(GGUF_KEY_ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))

        self.tensors: dict[str, TensorInfo] = {}
        self.tensor_list: list[TensorInfo] = []
        for _ in range(n_tensors):
            name = self._read_str()
            n_dims = self._unpack("<I")
            ne = tuple(self._unpack("<q") for _ in range(n_dims))
            ttype = GGMLType(self._unpack("<i"))
            offset = self._unpack("<Q")
            ti = TensorInfo(name=name, ggml_type=ttype, ne=ne, offset=offset, reader=self)
            self.tensors[name] = ti
            self.tensor_list.append(ti)

        pad = (-self._pos) % self.alignment
        self.data_offset = self._pos + pad

    # --- low-level cursor reads ---

    def _read_bytes(self, n: int) -> bytes:
        b = self._mm[self._pos : self._pos + n]
        self._pos += n
        return b

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        (v,) = struct.unpack_from(fmt, self._mm, self._pos)
        self._pos += size
        return v

    def _read_str(self) -> str:
        n = self._unpack("<Q")
        return self._read_bytes(n).decode("utf-8", errors="replace")

    def _read_value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self._read_str()
        if vtype == GGUFValueType.ARRAY:
            etype = GGUFValueType(self._unpack("<i"))
            n = self._unpack("<Q")
            if etype == GGUFValueType.STRING:
                return [self._read_str() for _ in range(n)]
            if etype == GGUFValueType.ARRAY:
                return [self._read_value(GGUFValueType.ARRAY) for _ in range(n)]
            npt = np.dtype(_SCALAR_NP[etype]).newbyteorder("<")
            nbytes = npt.itemsize * n
            # copy: metadata arrays are small and must outlive the mmap
            arr = np.frombuffer(self._mm, dtype=npt, count=n, offset=self._pos).copy()
            self._pos += nbytes
            if etype == GGUFValueType.BOOL:
                return arr.astype(bool)
            return arr
        fmt, _ = _SCALAR_FMT[vtype]
        v = self._unpack(fmt)
        if vtype == GGUFValueType.BOOL:
            return bool(v)
        return v

    # --- convenience ---

    def get(self, key: str, default=None):
        return self.metadata.get(key, default)

    def arch(self) -> str:
        return self.metadata["general.architecture"]

    def close(self):
        self.buf = None
        try:
            self._mm.close()
        except BufferError:
            pass  # zero-copy tensor views still alive; OS reclaims at GC/exit
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
