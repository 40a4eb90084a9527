"""GGUF v3 writer (streaming, single pass over tensor data).

The port's copy of the JAX package's ``gguf/writer.py``: the same bytes for
the same metadata and tensors. Tensors go in as pre-packed block bytes
(``raw_ne``) or as float arrays encoded to any type of ``QUANTIZERS``
(``gguf/quants.py``); a type without an encoder raises.
"""

from __future__ import annotations

import struct
from typing import Any, Sequence

import numpy as np

from .constants import (
    GGMLType,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGUFValueType,
)
from .quants import quantize

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<b",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _infer_vtype(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if (v < 0 or v > 0xFFFFFFFF) else GGUFValueType.UINT32
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF type for {type(v)}")


class GGUFWriter:
    def __init__(self, path: str, arch: str | None = None, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        self._kv_index: dict[str, int] = {}
        self._tensors: list[tuple[str, GGMLType, tuple[int, ...], np.ndarray]] = []
        if arch is not None:
            self.add("general.architecture", arch)

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        """Set a metadata KV; re-adding a key overwrites (last write wins),
        so per-arch converters can refine generic defaults without emitting
        duplicate keys."""
        item = (key, vtype or _infer_vtype(value), value)
        i = self._kv_index.get(key)
        if i is not None:
            self._kv[i] = item
        else:
            self._kv_index[key] = len(self._kv)
            self._kv.append(item)

    def add_tensor(
        self,
        name: str,
        data: np.ndarray,
        ggml_type: GGMLType | None = None,
        raw_ne: Sequence[int] | None = None,
    ):
        """Add a tensor. ``data`` is a float array in numpy shape order
        (innermost dim last); it is encoded to ``ggml_type`` (default: F32).
        Pass pre-packed bytes with ``raw_ne`` (ggml dim order) to store
        as-is.
        """
        if raw_ne is not None:
            assert data.dtype == np.uint8
            self._tensors.append((name, ggml_type, tuple(raw_ne), data.reshape(-1)))
            return
        ggml_type = ggml_type or GGMLType.F32
        ne = tuple(reversed(data.shape))
        packed = quantize(np.asarray(data), ggml_type)
        self._tensors.append((name, ggml_type, ne, packed))

    # --- serialization ---

    def _w_str(self, f, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _w_value(self, f, vtype: GGUFValueType, v: Any):
        if vtype == GGUFValueType.STRING:
            self._w_str(f, v)
        elif vtype == GGUFValueType.ARRAY:
            if isinstance(v, np.ndarray):
                etype = _NP_TO_VTYPE[v.dtype.newbyteorder("=")] if v.dtype != bool else GGUFValueType.BOOL
                f.write(struct.pack("<iQ", int(etype), v.size))
                if etype == GGUFValueType.BOOL:
                    f.write(v.astype(np.int8).tobytes())
                else:
                    f.write(np.ascontiguousarray(v, dtype=v.dtype.newbyteorder("<")).tobytes())
            else:
                v = list(v)
                etype = _infer_vtype(v[0]) if v else GGUFValueType.UINT32
                if etype == GGUFValueType.UINT32 and any(isinstance(e, int) and (e < 0 or e > 0xFFFFFFFF) for e in v):
                    etype = GGUFValueType.INT64
                f.write(struct.pack("<iQ", int(etype), len(v)))
                for e in v:
                    self._w_value(f, etype, e)
        else:
            f.write(struct.pack(_SCALAR_FMT[vtype], v))

    def write(self):
        with open(self.path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<I", GGUF_VERSION))
            f.write(struct.pack("<q", len(self._tensors)))
            f.write(struct.pack("<q", len(self._kv)))
            for key, vtype, v in self._kv:
                self._w_str(f, key)
                f.write(struct.pack("<i", int(vtype)))
                self._w_value(f, vtype, v)

            offset = 0
            for name, ttype, ne, packed in self._tensors:
                self._w_str(f, name)
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<q", d))
                f.write(struct.pack("<i", int(ttype)))
                f.write(struct.pack("<Q", offset))
                offset += len(packed)
                offset += (-offset) % self.alignment

            f.write(b"\x00" * ((-f.tell()) % self.alignment))
            for _, _, _, packed in self._tensors:
                f.write(packed.tobytes())
                f.write(b"\x00" * ((-len(packed)) % self.alignment))
