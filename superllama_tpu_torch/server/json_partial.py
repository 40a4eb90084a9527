"""Tolerant scanning of *incomplete* JSON — the streaming side of tool-call
parsing (common/json-partial.cpp counterpart; the reference heals a truncated
document by appending a magic marker + closing brackets, then re-parses).

Here the primitives work directly on the raw text instead:

 - ``scan_value(s, i)``   → (end, complete): span of the JSON value at ``i``,
   tolerating truncation (end == len(s), complete=False).
 - ``object_items(s, i)`` → iterates the key/value spans of the object at
   ``i`` even when the tail is cut mid-string/mid-value.
 - ``parse_partial(s, i)``→ healed Python value of the (possibly truncated)
   value at ``i``.

Raw *spans* (not healed values) are what the streaming tool-call parser
emits as OpenAI ``function.arguments`` deltas: the source buffer only grows,
so span prefixes are stable across feeds — healed re-serializations are not.
"""

from __future__ import annotations

import json
from typing import Any, Iterator

_WS = " \t\n\r"


def skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] in _WS:
        i += 1
    return i


def scan_string(s: str, i: int) -> tuple[int, bool]:
    """Span of the string literal at s[i] == '"'. Returns (end, complete);
    end is one past the closing quote, or len(s) when truncated."""
    assert s[i] == '"'
    i += 1
    while i < len(s):
        c = s[i]
        if c == "\\":
            i += 2
            continue
        if c == '"':
            return i + 1, True
        i += 1
    return len(s), False


def _scan_atom(s: str, i: int) -> tuple[int, bool]:
    """Number / true / false / null starting at i."""
    j = i
    while j < len(s) and s[j] not in ",}] \t\n\r":
        j += 1
    frag = s[i:j]
    for lit in ("true", "false", "null"):
        if frag == lit:
            return j, True   # literals cannot grow, complete even at EOF
    if j == len(s):
        # could still grow ("tru" → "true", "12" → "123")
        return j, False
    try:
        json.loads(frag)
        return j, True
    except json.JSONDecodeError:
        return j, True  # malformed but delimited; caller decides
    return j, True


def scan_value(s: str, i: int) -> tuple[int, bool]:
    """Span of any JSON value at i (after whitespace). (end, complete)."""
    i = skip_ws(s, i)
    if i >= len(s):
        return i, False
    c = s[i]
    if c == '"':
        return scan_string(s, i)
    if c == "{" or c == "[":
        close = "}" if c == "{" else "]"
        depth_end, complete = _scan_container(s, i, c, close)
        return depth_end, complete
    return _scan_atom(s, i)


def _scan_container(s: str, i: int, open_c: str, close_c: str) -> tuple[int, bool]:
    """Span of the {...} or [...] starting at i, skipping nested strings."""
    depth = 0
    while i < len(s):
        c = s[i]
        if c == '"':
            i, ok = scan_string(s, i)
            if not ok:
                return len(s), False
            continue
        if c in "{[":
            depth += 1
        elif c in "}]":
            depth -= 1
            if depth == 0:
                return i + 1, True
        i += 1
    return len(s), False


def object_items(s: str, i: int) -> Iterator[tuple[str, int, int, bool]]:
    """Iterate (key, value_start, value_end, value_complete) for the object
    literal at s[i] == '{', tolerating truncation anywhere. Keys with an
    incomplete key-string are not yielded."""
    assert s[i] == "{"
    i = skip_ws(s, i + 1)
    while i < len(s) and s[i] != "}":
        if s[i] != '"':
            return
        kend, ok = scan_string(s, i)
        if not ok:
            return
        key = json.loads(s[i:kend])
        i = skip_ws(s, kend)
        if i >= len(s) or s[i] != ":":
            return
        vstart = skip_ws(s, i + 1)
        vend, vok = scan_value(s, vstart)
        yield key, vstart, vend, vok
        if not vok:
            return
        i = skip_ws(s, vend)
        if i < len(s) and s[i] == ",":
            i = skip_ws(s, i + 1)


def parse_partial(s: str, i: int = 0) -> tuple[Any, int, bool]:
    """Healed Python value of the (possibly truncated) JSON value at i.

    Returns (value, end, complete). Truncated strings yield their decoded
    prefix; truncated containers yield whatever elements were complete;
    truncated atoms yield None.
    """
    i = skip_ws(s, i)
    if i >= len(s):
        return None, i, False
    c = s[i]
    if c == '"':
        end, ok = scan_string(s, i)
        if ok:
            return json.loads(s[i:end]), end, True
        # heal: drop a trailing lone backslash, close the quote
        frag = s[i:]
        if frag.endswith("\\") and not frag.endswith("\\\\"):
            frag = frag[:-1]
        try:
            return json.loads(frag + '"'), len(s), False
        except json.JSONDecodeError:
            return "", len(s), False
    if c == "{":
        out: dict = {}
        complete = False
        j = skip_ws(s, i + 1)
        if j < len(s) and s[j] == "}":
            return out, j + 1, True
        for key, vs, ve, vok in object_items(s, i):
            val, _, _ = parse_partial(s, vs)
            out[key] = val
        end, complete = scan_value(s, i)
        return out, end, complete
    if c == "[":
        arr: list = []
        j = skip_ws(s, i + 1)
        if j < len(s) and s[j] == "]":
            return arr, j + 1, True
        while j < len(s) and s[j] != "]":
            val, vend, vok = parse_partial(s, j)
            if vok or val is not None:
                arr.append(val)   # keep a healed partial tail element
            j = skip_ws(s, vend)
            if j < len(s) and s[j] == ",":
                j = skip_ws(s, j + 1)
            if not vok:
                break
        end, complete = scan_value(s, i)
        return arr, end, complete
    end, ok = _scan_atom(s, i)
    frag = s[i:end]
    if not ok:
        for lit, v in (("true", True), ("false", False), ("null", None)):
            if lit.startswith(frag):
                return None, end, False
        try:
            return json.loads(frag), end, False  # number prefix, may grow
        except json.JSONDecodeError:
            return None, end, False
    try:
        return json.loads(frag), end, True
    except json.JSONDecodeError:
        return None, end, True
