"""GBNF grammar engine for constrained decoding.

Counterpart of the reference's GBNF parser + pushdown acceptor
(src/llama-grammar.{h,cpp}; API surface include/llama.h:1381-1462), designed
clean-room: a grammar is parsed into rules of alternates of atoms, repetition
operators are desugared into auxiliary rules, and acceptance is tracked as a
set of pushdown stacks advanced one codepoint at a time (with epsilon-closure
over rule references). Token-level filtering asks, per candidate token,
whether its UTF-8 piece keeps at least one stack alive.

Grammar syntax (the public GBNF dialect):
    root  ::= "yes" | "no"
    expr  ::= term (("+" | "-") term)*
    ws    ::= [ \t\n]*
Literals "...", char classes [a-z0-9] / negated [^"], grouping (...),
repetition * + ? {m} {m,} {m,n}, rule refs by name, '.' for any char,
comments with '#'.
"""

from __future__ import annotations

from typing import Iterable

# ---------------------------------------------------------------------------
# Atoms. Kept as plain tuples so stacks hash/compare fast.
#   ("c", ranges, neg) — one codepoint in/not-in ranges ((lo, hi) inclusive)
#   ("r", name)        — rule reference
# ---------------------------------------------------------------------------

CharAtom = tuple  # ("c", tuple[tuple[int, int], ...], bool)
RefAtom = tuple   # ("r", str)

ANY_CHAR = ("c", ((0, 0x10FFFF),), False)


def _char(ranges: Iterable[tuple[int, int]], neg: bool = False) -> CharAtom:
    return ("c", tuple(ranges), neg)


def _matches(atom: CharAtom, cp: int) -> bool:
    _, ranges, neg = atom
    hit = any(lo <= cp <= hi for lo, hi in ranges)
    return hit != neg


def _matches_some_in(atom: CharAtom, lo: int, hi: int) -> bool:
    """True if some codepoint in [lo, hi] matches the atom (conservatively
    true for negated classes unless they exclude everything plausible)."""
    _, ranges, neg = atom
    if neg:
        # exists cp in [lo,hi] outside all ranges — only false if the ranges
        # fully cover [lo,hi]; checking coverage exactly is rarely needed, so
        # be permissive (a later byte will disambiguate)
        return True
    return any(rlo <= hi and lo <= rhi for rlo, rhi in ranges)


class GrammarError(ValueError):
    pass


class Grammar:
    """Parsed grammar: rule name → tuple of alternates (tuples of atoms)."""

    def __init__(self, rules: dict[str, tuple], root: str = "root"):
        if root not in rules:
            raise GrammarError(f"missing root rule {root!r}")
        for name, alts in rules.items():
            for alt in alts:
                for atom in alt:
                    if atom[0] == "r" and atom[1] not in rules:
                        raise GrammarError(
                            f"rule {name!r} references undefined {atom[1]!r}")
        self.rules = rules
        self.root = root

    def start_stacks(self) -> frozenset[tuple]:
        return _expand(self.rules, (("r", self.root),))


# ---------------------------------------------------------------------------
# Parser (recursive descent)
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.i = 0
        self.rules: dict[str, list[tuple]] = {}
        self.aux_n = 0

    # -- lexing helpers --
    def _ws(self, newlines: bool = True) -> None:
        while self.i < len(self.text):
            c = self.text[self.i]
            if c == "#":
                while self.i < len(self.text) and self.text[self.i] != "\n":
                    self.i += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.i += 1
            elif c == "\\" and newlines is False and self.i + 1 < len(self.text) \
                    and self.text[self.i + 1] in "\r\n":
                self.i += 2  # line continuation
            else:
                break

    def _peek(self) -> str:
        return self.text[self.i] if self.i < len(self.text) else ""

    def _name(self) -> str:
        j = self.i
        while j < len(self.text) and (self.text[j].isalnum() or self.text[j] in "-_"):
            j += 1
        if j == self.i:
            raise GrammarError(f"expected name at offset {self.i}")
        name, self.i = self.text[self.i:j], j
        return name

    def _escape(self) -> int:
        """Consume one escape sequence after the backslash, return codepoint."""
        c = self.text[self.i]
        self.i += 1
        simple = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91, "]": 93,
                  "-": 45, "^": 94, "/": 47}
        if c in simple:
            return simple[c]
        if c in "xuU":
            n = {"x": 2, "u": 4, "U": 8}[c]
            hexs = self.text[self.i:self.i + n]
            if len(hexs) != n:
                raise GrammarError(f"bad \\{c} escape at {self.i}")
            self.i += n
            return int(hexs, 16)
        raise GrammarError(f"unknown escape \\{c}")

    # -- grammar constructs --
    def parse(self) -> dict[str, tuple]:
        self._ws()
        while self.i < len(self.text):
            name = self._name()
            self._ws()
            if self.text[self.i:self.i + 3] != "::=":
                raise GrammarError(f"expected '::=' after rule {name!r}")
            self.i += 3
            self._ws(newlines=False)
            alts = self._alternates(name)
            self.rules.setdefault(name, []).extend(alts)
            self._ws()
        return {k: tuple(v) for k, v in self.rules.items()}

    def _alternates(self, ctx: str) -> list[tuple]:
        alts = [self._sequence(ctx)]
        while True:
            self._ws(newlines=False)
            # a '|' may start a continuation line
            save = self.i
            self._ws()
            if self._peek() == "|":
                self.i += 1
                self._ws(newlines=False)
                alts.append(self._sequence(ctx))
            else:
                self.i = save
                break
        return alts

    def _sequence(self, ctx: str) -> tuple:
        seq: list = []
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c == '"':
                for cp in self._literal():
                    seq.append(_char([(cp, cp)]))
            elif c == "[":
                seq.append(self._char_class())
            elif c == "(":
                self.i += 1
                aux = self._aux_name(ctx)
                alts = self._alternates(ctx)
                self._ws()
                if self._peek() != ")":
                    raise GrammarError(f"missing ')' at {self.i}")
                self.i += 1
                self.rules[aux] = alts
                seq.append(("r", aux))
            elif c == ".":
                self.i += 1
                seq.append(ANY_CHAR)
            elif c and (c.isalnum() or c in "-_"):
                save = self.i
                name = self._name()
                self._ws(newlines=False)
                if self.text[self.i:self.i + 3] == "::=":
                    self.i = save  # start of the next rule
                    break
                seq.append(("r", name))
            else:
                break
            # repetition suffix applies to the last atom
            self._ws(newlines=False)
            rep = self._peek()
            if rep and rep in "*+?{" and seq:
                seq.append(self._repeat(seq.pop(), ctx))
        return tuple(seq)

    def _literal(self) -> list[int]:
        assert self._peek() == '"'
        self.i += 1
        cps = []
        while self._peek() != '"':
            if self.i >= len(self.text):
                raise GrammarError("unterminated string literal")
            c = self.text[self.i]
            self.i += 1
            cps.append(self._escape() if c == "\\" else ord(c))
        self.i += 1
        return cps

    def _char_class(self) -> CharAtom:
        assert self._peek() == "["
        self.i += 1
        neg = self._peek() == "^"
        if neg:
            self.i += 1
        ranges: list[tuple[int, int]] = []
        while self._peek() != "]":
            if self.i >= len(self.text):
                raise GrammarError("unterminated char class")
            c = self.text[self.i]
            self.i += 1
            lo = self._escape() if c == "\\" else ord(c)
            hi = lo
            if self._peek() == "-" and self.text[self.i + 1:self.i + 2] != "]":
                self.i += 1
                c = self.text[self.i]
                self.i += 1
                hi = self._escape() if c == "\\" else ord(c)
            ranges.append((lo, hi))
        self.i += 1
        return _char(ranges, neg)

    def _aux_name(self, ctx: str) -> str:
        self.aux_n += 1
        return f"{ctx}__{self.aux_n}"

    def _repeat(self, atom, ctx: str):
        """Desugar one repetition operator into an auxiliary rule ref."""
        c = self._peek()
        if c == "*":
            self.i += 1
            aux = self._aux_name(ctx)
            self.rules[aux] = [(atom, ("r", aux)), ()]
            return ("r", aux)
        if c == "+":
            self.i += 1
            aux = self._aux_name(ctx)
            self.rules[aux] = [(atom, ("r", aux)), (atom,)]
            return ("r", aux)
        if c == "?":
            self.i += 1
            aux = self._aux_name(ctx)
            self.rules[aux] = [(atom,), ()]
            return ("r", aux)
        # {m} {m,} {m,n}
        assert c == "{"
        self.i += 1
        j = self.text.index("}", self.i)
        spec = self.text[self.i:j].replace(" ", "")
        self.i = j + 1
        if "," in spec:
            lo_s, hi_s = spec.split(",", 1)
            m = int(lo_s) if lo_s else 0
            n = int(hi_s) if hi_s else None
        else:
            m = n = int(spec)
        aux = self._aux_name(ctx)
        if n is None:  # {m,} = m copies then star
            star = self._aux_name(ctx)
            self.rules[star] = [(atom, ("r", star)), ()]
            self.rules[aux] = [tuple([atom] * m) + (("r", star),)]
        else:
            if n < m:
                raise GrammarError(f"bad repetition bounds {{{m},{n}}}")
            # m copies + (n-m) nested optionals
            tail: tuple = ()
            for _ in range(n - m):
                opt = self._aux_name(ctx)
                self.rules[opt] = [(atom,) + tail, ()]
                tail = (("r", opt),)
            self.rules[aux] = [tuple([atom] * m) + tail]
        return ("r", aux)


def parse_gbnf(text: str, root: str = "root") -> Grammar:
    return Grammar(_Parser(text).parse(), root)


# ---------------------------------------------------------------------------
# Pushdown acceptance. A stack is a tuple of atoms; the NEXT atom to match is
# the LAST element. _expand rewrites stacks until every top is a char atom
# (epsilon closure over rule refs); empty stack = grammar can terminate.
# ---------------------------------------------------------------------------

_MAX_STACKS = 512


def _expand(rules: dict, stack: tuple, seen: set | None = None) -> frozenset:
    if seen is None:
        seen = set()
    if stack in seen:
        return frozenset()
    seen.add(stack)
    if not stack or stack[-1][0] == "c":
        return frozenset([stack])
    out: set = set()
    name = stack[-1][1]
    base = stack[:-1]
    for alt in rules[name]:
        out |= _expand(rules, base + tuple(reversed(alt)), seen)
    return frozenset(out)


def _advance(rules: dict, stacks: frozenset, cp: int) -> frozenset:
    out: set = set()
    for st in stacks:
        if st and _matches(st[-1], cp):
            out |= _expand(rules, st[:-1])
    if len(out) > _MAX_STACKS:
        out = set(sorted(out, key=len)[:_MAX_STACKS])
    return frozenset(out)


class GrammarState:
    """Incremental acceptance state over a Grammar (one decoding stream)."""

    def __init__(self, grammar: Grammar):
        self.grammar = grammar
        self.stacks = grammar.start_stacks()
        self._partial = b""  # pending bytes of an incomplete UTF-8 sequence

    def copy(self) -> "GrammarState":
        st = GrammarState.__new__(GrammarState)
        st.grammar = self.grammar
        st.stacks = self.stacks
        st._partial = self._partial
        return st

    @property
    def alive(self) -> bool:
        return bool(self.stacks)

    @property
    def can_terminate(self) -> bool:
        return not self._partial and any(not s for s in self.stacks)

    def accept_cp(self, cp: int) -> bool:
        self.stacks = _advance(self.grammar.rules, self.stacks, cp)
        return self.alive

    def accept_text(self, text: str) -> bool:
        for ch in text:
            if not self.accept_cp(ord(ch)):
                return False
        return True

    def accept_bytes(self, data: bytes) -> bool:
        """Advance by a token piece, tolerating UTF-8 splits across tokens
        (byte-fallback tokens may carry partial multi-byte sequences)."""
        buf = self._partial + data
        self._partial = b""
        i, n = 0, len(buf)
        while i < n:
            b0 = buf[i]
            if b0 < 0x80:
                ln = 1
            elif b0 >> 5 == 0b110:
                ln = 2
            elif b0 >> 4 == 0b1110:
                ln = 3
            elif b0 >> 3 == 0b11110:
                ln = 4
            else:
                return self._fail()  # stray continuation byte
            if i + ln > n:
                # trailing incomplete sequence: viable only if some codepoint
                # it could encode is acceptable to a live stack
                part = buf[i:]
                bits = {1: 0x7F, 2: 0x1F, 3: 0x0F, 4: 0x07}[ln]
                acc = part[0] & bits
                for b in part[1:]:
                    if b >> 6 != 0b10:
                        return self._fail()
                    acc = (acc << 6) | (b & 0x3F)
                rem = 6 * (ln - len(part))
                lo, hi = acc << rem, (acc << rem) | ((1 << rem) - 1)
                lo = max(lo, {1: 0, 2: 0x80, 3: 0x800, 4: 0x10000}[ln])
                if not any(st and _matches_some_in(st[-1], lo, hi)
                           for st in self.stacks):
                    return self._fail()
                self._partial = part
                break
            try:
                ch = buf[i:i + ln].decode("utf-8")
            except UnicodeDecodeError:
                return self._fail()
            if not self.accept_cp(ord(ch)):
                return False
            i += ln
        return True

    def _fail(self) -> bool:
        self.stacks = frozenset()
        return False

    def would_accept(self, data: bytes) -> bool:
        return self.copy().accept_bytes(data)


def filter_token_ids(state: GrammarState, pieces: list[bytes],
                     candidate_ids: Iterable[int], eos_ids: set[int]) -> list[int]:
    """Subset of candidate ids whose pieces the grammar accepts next."""
    ok = []
    for tid in candidate_ids:
        if tid in eos_ids:
            if state.can_terminate:
                ok.append(tid)
        elif state.would_accept(pieces[tid]):
            ok.append(tid)
    return ok
