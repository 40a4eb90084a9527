"""GBNF grammars and JSON-schema conversion for constrained decoding: the
port's own copy of the JAX package's ``grammar`` package (pure Python)."""

from .gbnf import Grammar, GrammarState, parse_gbnf
from .json_schema import json_schema_to_gbnf

__all__ = ["Grammar", "GrammarState", "parse_gbnf", "json_schema_to_gbnf"]
