"""Tokenizers: SPM, BPE (46 pretokenizer variants), WPM."""

from .tokenizer import Tokenizer
from .vocab import TokenAttr, Vocab, vocab_from_gguf

__all__ = ["Tokenizer", "TokenAttr", "Vocab", "vocab_from_gguf"]
