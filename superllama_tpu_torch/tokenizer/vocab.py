"""Vocabulary model: tokens, attributes, special-token handling.

Behavioral reference: src/llama-vocab.{h,cpp} (tokenize entry at
llama_vocab::impl::tokenize, special-token partition at
tokenizer_st_partition). Original implementation.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..gguf import GGUFReader


class TokenAttr(enum.IntFlag):
    UNDEFINED = 0
    UNKNOWN = 1 << 1
    UNUSED = 1 << 2
    NORMAL = 1 << 3
    CONTROL = 1 << 4
    USER_DEFINED = 1 << 5
    BYTE = 1 << 6
    LSTRIP = 1 << 9
    RSTRIP = 1 << 10


# gguf token_type integer → attr (token type ids are wire values)
_TOKEN_TYPE_TO_ATTR = {
    0: TokenAttr.UNDEFINED,
    1: TokenAttr.NORMAL,
    2: TokenAttr.UNKNOWN,
    3: TokenAttr.CONTROL,
    4: TokenAttr.USER_DEFINED,
    5: TokenAttr.UNUSED,
    6: TokenAttr.BYTE,
}


@dataclass
class Vocab:
    model: str                      # "llama" (SPM) | "gpt2" (BPE) | "bert" (WPM) | ...
    pre: str                        # BPE pretokenizer variant name
    tokens: list[str]
    scores: list[float]
    attrs: list[TokenAttr]
    merges: list[str] = field(default_factory=list)

    bos_id: int = -1
    eos_id: int = -1
    eot_id: int = -1
    unk_id: int = -1
    sep_id: int = -1
    pad_id: int = -1
    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = True
    chat_template: str | None = None

    def __post_init__(self):
        self.token_to_id: dict[str, int] = {}
        for i, t in enumerate(self.tokens):
            self.token_to_id[t] = i  # last occurrence wins, like the ecosystem
        # special tokens for text partitioning, longest first
        self._special_ids = [
            i
            for i, a in enumerate(self.attrs)
            if a & (TokenAttr.CONTROL | TokenAttr.USER_DEFINED | TokenAttr.UNKNOWN)
            and self.tokens[i]
        ]
        self._special_ids.sort(key=lambda i: -len(self.tokens[i]))
        self._byte_cache: dict[int, int] = {}

    # --- predicates ---

    def is_normal(self, tid: int) -> bool:
        return bool(self.attrs[tid] & TokenAttr.NORMAL)

    def is_control(self, tid: int) -> bool:
        return bool(self.attrs[tid] & TokenAttr.CONTROL)

    def is_byte(self, tid: int) -> bool:
        return bool(self.attrs[tid] & TokenAttr.BYTE)

    def is_user_defined(self, tid: int) -> bool:
        return bool(self.attrs[tid] & TokenAttr.USER_DEFINED)

    def is_unknown(self, tid: int) -> bool:
        return bool(self.attrs[tid] & TokenAttr.UNKNOWN)

    def is_eog(self, tid: int) -> bool:
        return tid >= 0 and (tid == self.eos_id or tid == self.eot_id)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def byte_to_token(self, byte: int) -> int:
        """SPM-style byte-fallback token id for one byte (e.g. "<0x0A>")."""
        tid = self._byte_cache.get(byte)
        if tid is None:
            tid = self.token_to_id.get(f"<0x{byte:02X}>", -1)
            if tid < 0:
                # some vocabs store raw single bytes
                tid = self.token_to_id.get(chr(byte), -1)
            self._byte_cache[byte] = tid
        return tid

    # --- special-token partition (tokenizer_st_partition semantics) ---

    def partition_specials(self, text: str, parse_special: bool) -> list[tuple[str, int]]:
        """Split text into fragments: (raw_text, -1) or ("", token_id).

        Scans special tokens longest-first; when parse_special is False only
        USER_DEFINED tokens are matched (control/unknown pass through as text).
        """
        fragments: list[tuple[str, int]] = [(text, -1)] if text else []
        for sid in self._special_ids:
            attr = self.attrs[sid]
            if not parse_special and (attr & (TokenAttr.CONTROL | TokenAttr.UNKNOWN)):
                continue
            stext = self.tokens[sid]
            out: list[tuple[str, int]] = []
            for frag, tid in fragments:
                if tid >= 0 or not frag:
                    out.append((frag, tid))
                    continue
                rest = frag
                while True:
                    pos = rest.find(stext)
                    if pos < 0:
                        if rest:
                            out.append((rest, -1))
                        break
                    left = rest[:pos]
                    if attr & TokenAttr.LSTRIP:
                        left = left.rstrip(" \t\n\r\x0b\f")
                    if left:
                        out.append((left, -1))
                    out.append(("", sid))
                    rest = rest[pos + len(stext):]
                    if attr & TokenAttr.RSTRIP:
                        rest = rest.lstrip(" \t\n\r\x0b\f")
            fragments = out
        return fragments


def vocab_from_gguf(reader: "GGUFReader") -> Vocab:
    md = reader.metadata
    tokens = list(md["tokenizer.ggml.tokens"])
    n = len(tokens)
    scores = list(md.get("tokenizer.ggml.scores", [0.0] * n))
    ttypes = md.get("tokenizer.ggml.token_type", [1] * n)
    attrs = [_TOKEN_TYPE_TO_ATTR.get(int(t), TokenAttr.UNDEFINED) for t in ttypes]
    model = md.get("tokenizer.ggml.model", "llama")
    defaults = {"llama": (True, False, True), "gpt2": (False, False, False),
                "t5": (False, True, True)}  # UGM: append </s>, space prefix
    d_bos, d_eos, d_sp = defaults.get(model, (False, False, False))
    return Vocab(
        model=model,
        pre=md.get("tokenizer.ggml.pre", "default"),
        tokens=tokens,
        scores=scores,
        attrs=attrs,
        merges=list(md.get("tokenizer.ggml.merges", [])),
        bos_id=int(md.get("tokenizer.ggml.bos_token_id", -1)),
        eos_id=int(md.get("tokenizer.ggml.eos_token_id", -1)),
        eot_id=int(md.get("tokenizer.ggml.eot_token_id", -1)),
        unk_id=int(md.get("tokenizer.ggml.unknown_token_id", -1)),
        sep_id=int(md.get("tokenizer.ggml.seperator_token_id", -1)),
        pad_id=int(md.get("tokenizer.ggml.padding_token_id", -1)),
        add_bos=bool(md.get("tokenizer.ggml.add_bos_token", d_bos)),
        add_eos=bool(md.get("tokenizer.ggml.add_eos_token", d_eos)),
        add_space_prefix=bool(md.get("tokenizer.ggml.add_space_prefix", d_sp)),
        chat_template=md.get("tokenizer.chat_template"),
    )
