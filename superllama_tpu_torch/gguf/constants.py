"""GGUF / GGML file-format constants.

These are *file format facts* of the GGUF v3 container and the ggml block-quant
layouts, required for binary compatibility with models produced by the llama.cpp
ecosystem (format spec: reference ggml/include/gguf.h:1-33, enum values:
ggml/include/ggml.h:389-431, block layouts: ggml/src/ggml-common.h:170-345).
The implementation here is original.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32
GGUF_KEY_ALIGNMENT = "general.alignment"

# Superblock size for K-quants.
QK_K = 256
K_SCALE_SIZE = 12


class GGUFValueType(enum.IntEnum):
    """Metadata value types (gguf.h:53-72)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor storage dtypes (ggml.h:389-431). Values are wire-format IDs."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39


@dataclass(frozen=True)
class TypeTraits:
    """block_size = elements per block; type_size = bytes per block."""

    block_size: int
    type_size: int

    @property
    def bits_per_weight(self) -> float:
        return self.type_size * 8 / self.block_size


# elements-per-block and bytes-per-block for every wire type
# (struct sizes from ggml-common.h static_asserts).
GGML_TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4),
    GGMLType.F16: TypeTraits(1, 2),
    GGMLType.BF16: TypeTraits(1, 2),
    GGMLType.F64: TypeTraits(1, 8),
    GGMLType.I8: TypeTraits(1, 1),
    GGMLType.I16: TypeTraits(1, 2),
    GGMLType.I32: TypeTraits(1, 4),
    GGMLType.I64: TypeTraits(1, 8),
    GGMLType.Q4_0: TypeTraits(32, 2 + 16),
    GGMLType.Q4_1: TypeTraits(32, 4 + 16),
    GGMLType.Q5_0: TypeTraits(32, 2 + 4 + 16),
    GGMLType.Q5_1: TypeTraits(32, 4 + 4 + 16),
    GGMLType.Q8_0: TypeTraits(32, 2 + 32),
    GGMLType.Q8_1: TypeTraits(32, 4 + 32),
    GGMLType.MXFP4: TypeTraits(32, 1 + 16),
    GGMLType.Q2_K: TypeTraits(QK_K, QK_K // 16 + QK_K // 4 + 4),
    GGMLType.Q3_K: TypeTraits(QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGMLType.Q4_K: TypeTraits(QK_K, 4 + K_SCALE_SIZE + QK_K // 2),
    GGMLType.Q5_K: TypeTraits(QK_K, 4 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2),
    GGMLType.Q6_K: TypeTraits(QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGMLType.Q8_K: TypeTraits(QK_K, 4 + QK_K + QK_K // 16 * 2),
    GGMLType.IQ4_NL: TypeTraits(32, 2 + 16),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 2 + QK_K // 8 * 2),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 2 + QK_K // 8 * 2 + QK_K // 32),
    GGMLType.IQ2_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 8),
    GGMLType.IQ3_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 8 + QK_K // 32 + 4),
    GGMLType.IQ1_S: TypeTraits(QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGMLType.IQ1_M: TypeTraits(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
    GGMLType.TQ1_0: TypeTraits(QK_K, 2 + QK_K // 64 + (QK_K - 4 * (QK_K // 64)) // 5),
    GGMLType.TQ2_0: TypeTraits(QK_K, 2 + QK_K // 4),
}

# 4-bit code value tables (format constants, ggml-common.h:1088-1096).
KVALUES_IQ4NL = (-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113)
KVALUES_MXFP4 = (0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12)


def row_byte_size(ggml_type: GGMLType, n_elements: int) -> int:
    """Bytes needed to store n_elements (must be a multiple of block_size)."""
    tr = GGML_TYPE_TRAITS[ggml_type]
    if n_elements % tr.block_size != 0:
        raise ValueError(
            f"{ggml_type.name}: {n_elements} elements not divisible by block size {tr.block_size}"
        )
    return n_elements // tr.block_size * tr.type_size


# --- common GGUF metadata keys (general + per-arch patterns) ---------------

class Keys:
    """Well-known GGUF metadata keys (same key strings as the ecosystem)."""

    class General:
        ARCHITECTURE = "general.architecture"
        NAME = "general.name"
        QUANTIZATION_VERSION = "general.quantization_version"
        ALIGNMENT = "general.alignment"
        FILE_TYPE = "general.file_type"

    # per-architecture keys use "{arch}." prefix
    CONTEXT_LENGTH = "{arch}.context_length"
    EMBEDDING_LENGTH = "{arch}.embedding_length"
    BLOCK_COUNT = "{arch}.block_count"
    FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
    ATTN_HEAD_COUNT = "{arch}.attention.head_count"
    ATTN_HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
    ATTN_LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
    ATTN_LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
    ATTN_KEY_LENGTH = "{arch}.attention.key_length"
    ATTN_VALUE_LENGTH = "{arch}.attention.value_length"
    ATTN_SLIDING_WINDOW = "{arch}.attention.sliding_window"
    ROPE_DIMENSION_COUNT = "{arch}.rope.dimension_count"
    ROPE_FREQ_BASE = "{arch}.rope.freq_base"
    ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
    ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
    ROPE_SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
    ROPE_SCALING_ATTN_FACTOR = "{arch}.rope.scaling.attn_factor"
    EXPERT_COUNT = "{arch}.expert_count"
    EXPERT_USED_COUNT = "{arch}.expert_used_count"
    EXPERT_FEED_FORWARD_LENGTH = "{arch}.expert_feed_forward_length"
    VOCAB_SIZE = "{arch}.vocab_size"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"
        PRE = "tokenizer.ggml.pre"
        TOKENS = "tokenizer.ggml.tokens"
        TOKEN_TYPE = "tokenizer.ggml.token_type"
        SCORES = "tokenizer.ggml.scores"
        MERGES = "tokenizer.ggml.merges"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        EOT_ID = "tokenizer.ggml.eot_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        SEP_ID = "tokenizer.ggml.seperator_token_id"
        PAD_ID = "tokenizer.ggml.padding_token_id"
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
        REMOVE_EXTRA_WS = "tokenizer.ggml.remove_extra_whitespaces"
        CHAT_TEMPLATE = "tokenizer.chat_template"
