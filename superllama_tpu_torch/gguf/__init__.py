"""GGUF container reader and writer, and the block codecs of every ggml format."""

from .constants import GGML_TYPE_TRAITS, GGMLType, GGUFValueType, Keys, QK_K
from .quants import DEQUANTIZERS, QUANTIZERS, dequantize, quantize
from .reader import GGUFReader, TensorInfo
from .writer import GGUFWriter

__all__ = [
    "GGML_TYPE_TRAITS",
    "GGMLType",
    "GGUFValueType",
    "GGUFReader",
    "GGUFWriter",
    "Keys",
    "QK_K",
    "TensorInfo",
    "DEQUANTIZERS",
    "QUANTIZERS",
    "dequantize",
    "quantize",
]
