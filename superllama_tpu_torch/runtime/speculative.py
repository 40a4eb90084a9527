"""Draft/target vocab compatibility + translation for speculative decoding.

The JAX package's ``runtime/speculative.py``, kept as the port's own copy.
Counterpart of common/speculative.cpp: `common_speculative_are_compatible`
(vocab type, BOS/EOS wiring, size delta ≤ 100, token-text match from id 256 —
speculative.cpp:89-148) and the retokenization path used when the vocabs
differ (detokenize → string replacements → tokenize, :156-182,200-222,351-359).
"""

from __future__ import annotations

from ..tokenizer.tokenizer import Tokenizer

SPEC_VOCAB_MAX_SIZE_DIFFERENCE = 100
SPEC_VOCAB_CHECK_START_TOKEN_ID = 256


def are_compatible(tok_tgt: Tokenizer | None, tok_dft: Tokenizer | None) -> bool:
    """True when draft token ids can be used directly in target space."""
    if tok_tgt is None or tok_dft is None:
        return False
    vt, vd = tok_tgt.vocab, tok_dft.vocab
    if tok_tgt.model != tok_dft.model:
        return False
    if (vt.add_bos != vd.add_bos or vt.add_eos != vd.add_eos
            or vt.bos_id != vd.bos_id or vt.eos_id != vd.eos_id):
        return False
    n_t, n_d = vt.n_tokens, vd.n_tokens
    if abs(n_t - n_d) > SPEC_VOCAB_MAX_SIZE_DIFFERENCE:
        return False
    for i in range(SPEC_VOCAB_CHECK_START_TOKEN_ID, min(n_t, n_d)):
        if vt.tokens[i] != vd.tokens[i]:
            return False
    return True


class VocabTranslator:
    """Target↔draft token translation through text, with the optional
    string-replacement map (common_speculative_add_replacement_tgt_dft)."""

    def __init__(self, tok_tgt: Tokenizer, tok_dft: Tokenizer):
        self.tok_tgt = tok_tgt
        self.tok_dft = tok_dft
        self.replacements: list[tuple[str, str]] = []  # (tgt_str, dft_str)

    def add_replacement(self, source: str, dest: str) -> None:
        self.replacements.append((source, dest))

    def _text(self, tok: Tokenizer, ids: list[int]) -> str:
        return b"".join(tok.token_to_piece(int(t)) for t in ids).decode(
            "utf-8", errors="replace")

    def tgt_to_dft(self, ids: list[int]) -> list[int]:
        if not ids:
            return []
        text = self._text(self.tok_tgt, ids)
        for src, dst in self.replacements:
            text = text.replace(src, dst)
        return self.tok_dft.encode(text, add_special=False, parse_special=True)

    def dft_to_tgt(self, ids: list[int]) -> list[int]:
        if not ids:
            return []
        text = self._text(self.tok_dft, ids)
        for src, dst in self.replacements:
            text = text.replace(dst, src)
        return self.tok_tgt.encode(text, add_special=False, parse_special=True)
