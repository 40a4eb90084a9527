"""GGUF container reader and the block decoders the port loads."""

from .constants import GGML_TYPE_TRAITS, GGMLType, GGUFValueType, Keys, QK_K
from .quants import DEQUANTIZERS, dequantize
from .reader import GGUFReader, TensorInfo

__all__ = [
    "GGML_TYPE_TRAITS",
    "GGMLType",
    "GGUFValueType",
    "GGUFReader",
    "Keys",
    "QK_K",
    "TensorInfo",
    "DEQUANTIZERS",
    "dequantize",
]
