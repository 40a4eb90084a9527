"""The port's GBNF grammars, JSON-schema conversion and grammar sampler
against the JAX package's, on the same inputs (pure Python and numpy; no
model):

 - for a corpus of GBNF grammars and texts (the cases of
   ``tests/test_grammar.py``), ``accept_text`` / ``accept_bytes`` /
   ``can_terminate`` / ``alive`` agree after every step, UTF-8 split across
   byte chunks included, and a bad grammar is refused by both;
 - ``json_schema_to_gbnf`` gives identical text for every schema of
   ``tests/test_grammar.py`` and a few more (``$ref``, ``definitions``,
   ``additionalProperties`` schemas, ``allOf``, formats), and both
   grammars accept and reject the same texts;
 - ``filter_token_ids`` over multi-character pieces agrees;
 - ``GrammarSampler`` in both chains gives the same tokens over seeded
   logits: greedy, sampled, the full-vocab rescan when the cutting stages
   leave no legal token, and a lazy grammar woken by a trigger pattern or
   a trigger token.
"""

import numpy as np
import pytest

from superllama_tpu import grammar as jg
from superllama_tpu.grammar import gbnf as jgbnf
from superllama_tpu.runtime import sampling as jsamp
from superllama_tpu_torch import grammar as tg
from superllama_tpu_torch.grammar import gbnf as tgbnf
from superllama_tpu_torch.runtime import sampling as tsamp

# (grammar, texts): each text is fed in byte chunks of 1, 2 and whole
CORPUS = {
    "alternates": ('root ::= "yes" | "no"', ["yes", "no", "maybe", "ye", ""]),
    "class": ("root ::= [a-fA-F0-9]", ["a", "F", "3", "g", "ab"]),
    "negated": ('root ::= [^"\\n]*', ["hello world", 'has"quote', "", "x\ny"]),
    "plus": ("root ::= [0-9]+", ["123", "", "1a"]),
    "star": ("root ::= [0-9]*", ["", "42"]),
    "optional": ('root ::= "a"?', ["", "a", "aa"]),
    "bounded": ("root ::= [ab]{2,3}", ["a", "ab", "aba", "abab"]),
    "at_least": ("root ::= [x]{2,}", ["x", "xx", "xxxxx"]),
    "exact": ("root ::= [x]{3}", ["xx", "xxx", "xxxx"]),
    "refs": ('root ::= greeting " " name\ngreeting ::= ("hi" | "hello")\n'
             "name ::= [A-Z] [a-z]+", ["hi Bob", "hello Alice", "hey Bob", "hi bob"]),
    "recursive": ('root ::= expr\nexpr ::= "(" expr ")" | "x"', ["x", "(((x)))", "((x)"]),
    "escapes": ('root ::= "\\"" . "\\"" | "\\u0041" | [\\t\\n ]+',
                ['"z"', "A", " \t\n", '"zz"']),
    "comments": ('# a grammar\nroot ::= a   # trailing\na ::= "ok"\n    | "fine"',
                 ["ok", "fine", "okfine"]),
    "utf8": ('root ::= "é" "x" | [α-ω]+ "!"', ["éx", "αβγ!", "é", "ex", "ω!"]),
    "json_like": ('root ::= "{" ws "\\"k\\":" ws [0-9]+ ws "}"\nws ::= [ \\t\\n]*',
                  ['{"k": 12}', '{ "k":1 }', '{"k": }', '{"k":1']),
}


def _trace(gbnf_mod, grammar: str, text: str, chunk: int) -> list:
    """(accepted, alive, can_terminate) after each byte chunk of the text."""
    st = gbnf_mod.GrammarState(gbnf_mod.parse_gbnf(grammar))
    raw = text.encode("utf-8")
    out = [(st.alive, st.can_terminate)]
    for i in range(0, max(len(raw), 1), chunk or max(len(raw), 1)):
        ok = st.accept_bytes(raw[i:i + (chunk or len(raw))])
        out.append((ok, st.alive, st.can_terminate))
    return out


@pytest.mark.parametrize("chunk", [1, 2, 0], ids=["bytes1", "bytes2", "whole"])
@pytest.mark.parametrize("case", list(CORPUS))
def test_acceptance_matches_jax(case, chunk):
    grammar, texts = CORPUS[case]
    for text in texts:
        assert _trace(tgbnf, grammar, text, chunk) == _trace(jgbnf, grammar, text, chunk), text
        ts = tgbnf.GrammarState(tgbnf.parse_gbnf(grammar))
        js = jgbnf.GrammarState(jgbnf.parse_gbnf(grammar))
        assert (ts.accept_text(text), ts.can_terminate) == (js.accept_text(text),
                                                             js.can_terminate)


def test_utf8_split_across_tokens():
    raw = "éx".encode("utf-8")
    for mod in (tgbnf, jgbnf):
        st = mod.GrammarState(mod.parse_gbnf('root ::= "é" "x"'))
        assert st.accept_bytes(raw[:1]) and st.would_accept(raw[1:2])
        assert not st.would_accept(b"x")
        assert st.accept_bytes(raw[1:]) and st.can_terminate


@pytest.mark.parametrize("bad", ["root ::= ((", 'root ::= "a', "root ::= [a-z", "a ::= b",
                                 "root ::= undefined", "root ::= ]"])
def test_bad_grammar_refused_by_both(bad):
    for mod in (tgbnf, jgbnf):
        with pytest.raises(ValueError):
            mod.parse_gbnf(bad)
    assert issubclass(tgbnf.GrammarError, ValueError)


SCHEMAS = [
    ({"type": "boolean"}, ["true", "false"], ["yes", "1"]),
    ({"type": "integer"}, ["0", "-5", "123"], ["1.5", "01", "+-"]),
    ({"type": "number"}, ["0", "-1.25", "2e10", "3.5e-2"], ["1.", ".5"]),
    ({"type": "string"}, ['"hi"', '""', '"a\\nb"', '"\\u00e9"'], ['"', "hi"]),
    ({"enum": ["red", "green", 3]}, ['"red"', '"green"', "3"], ['"blue"']),
    ({"const": 42}, ["42"], ["43"]),
    ({"type": "array", "items": {"type": "integer"}}, ["[]", "[1]", "[1, 2, 3]"],
     ["[1,]", "[,1]"]),
    ({"type": "array", "items": {"type": "integer"}, "minItems": 2, "maxItems": 3},
     ["[1, 2]", "[1, 2, 3]"], ["[1]", "[1, 2, 3, 4]"]),
    ({"type": "object", "properties": {"a": {"type": "integer"}}, "required": ["a"],
      "additionalProperties": False}, ['{"a": 1}'], ["{}", '{"b": 1}']),
    ({"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "string"}},
      "required": ["a"], "additionalProperties": False},
     ['{"a": 1}', '{"a": 1, "b": "x"}'], ['{"b": "x"}', '{"a": 1 "b": "x"}']),
    ({"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "integer"}},
      "additionalProperties": False},
     ["{}", '{"a": 1}', '{"b": 2}', '{"a": 1, "b": 2}'], ['{"a": 1,}', "{,}"]),
    ({"anyOf": [{"type": "integer"}, {"type": "boolean"}]}, ["5", "true"], ['"x"']),
    ({"type": "string", "minLength": 2, "maxLength": 3}, ['"ab"', '"abc"'],
     ['"a"', '"abcd"']),
    ({"type": "string", "format": "uuid"}, ['"123e4567-e89b-12d3-a456-426614174000"'],
     ['"nope"']),
    ({"type": "string", "pattern": "^[0-9]{3}-[a-z]+$"}, ['"123-abc"'], ['"12-abc"', '"123-"']),
    ({"type": "integer", "minimum": 3, "maximum": 7}, ["3", "5", "7"], ["2", "8"]),
    ({"$defs": {"pt": {"type": "object", "properties": {"x": {"type": "number"}},
                       "required": ["x"], "additionalProperties": False}},
      "type": "array", "items": {"$ref": "#/$defs/pt"}}, ['[{"x": 1}]', "[]"], ['[{"y": 1}]']),
    ({"type": ["integer", "null"]}, ["3", "null"], ['"x"']),
    ({"prefixItems": [{"type": "integer"}, {"type": "boolean"}]}, ["[1, true]"],
     ["[1]", "[true, 1]"]),
    ({"definitions": {"c": {"enum": ["a", "b"]}}, "type": "object",
      "properties": {"c": {"$ref": "#/definitions/c"}}, "required": ["c"]},
     ['{"c": "a"}'], ['{"c": "z"}']),
    ({"type": "object", "additionalProperties": {"type": "integer"}},
     ["{}", '{"k": 1, "j": 2}'], ['{"k": 1', '{k: 1}']),
    ({"type": "object", "properties": {"a": {"type": "boolean"}}},
     ['{"a": true}', "{}"], ['{"a": 1']),
    ({"allOf": [{"type": "object", "properties": {"a": {"type": "integer"}},
                 "required": ["a"]},
                {"type": "object", "properties": {"b": {"type": "boolean"}},
                 "required": ["b"]}]}, [], []),
    ({"type": "string", "format": "date"}, ['"2024-02-29"'], ['"2024-2-29"']),
    ({"type": "string", "format": "date-time"}, ['"2024-02-29T12:30:00Z"'], ['"noon']),
    ({"oneOf": [{"const": "x"}, {"type": "array", "items": {"const": 1}, "maxItems": 2}]},
     ['"x"', "[1, 1]"], ["[1, 1, 1]"]),
]


@pytest.mark.parametrize("schema,good,bad", SCHEMAS, ids=[str(i) for i in range(len(SCHEMAS))])
def test_json_schema_gbnf_matches_jax(schema, good, bad):
    text = tg.json_schema_to_gbnf(schema)
    assert text == jg.json_schema_to_gbnf(schema)
    g, jgram = tgbnf.parse_gbnf(text), jgbnf.parse_gbnf(text)
    for s in good + bad:
        st, js = tgbnf.GrammarState(g), jgbnf.GrammarState(jgram)
        got = st.accept_text(s) and st.can_terminate
        assert got == (js.accept_text(s) and js.can_terminate)
        assert got == (s in good), (s, text)


def test_unsatisfiable_schema_refused_by_both():
    for mod in (tg, jg):
        with pytest.raises(ValueError):
            mod.json_schema_to_gbnf(False)


def test_filter_token_ids_matches_jax():
    pieces = [b"true", b"false", b"tr", b"ue", b"x", b"", b"t", b"fa", b"lse"]
    eos = {5}
    steps = [b"", b"tr", b"ue"]
    for mod in (tgbnf, jgbnf):
        st = mod.GrammarState(mod.parse_gbnf('root ::= "true" | "false"'))
        seen = []
        for step in steps:
            st.accept_bytes(step)
            seen.append(mod.filter_token_ids(st, pieces, range(len(pieces)), eos))
        if mod is tgbnf:
            want = seen
    assert seen == want == [[0, 1, 2, 6, 7], [3], [5]]


# ----------------------------------------------------------- the sampler


def _vocab():
    """Printable ASCII bytes, JSON punctuation pairs, a partial UTF-8 byte,
    an empty piece and EOS."""
    pieces = [bytes([b]) for b in range(32, 127)]
    pieces += [b'{"', b'":', b'",', b'"}', b"true", b"false", b"12", b"\xc3", b"\xa9", b""]
    eos = len(pieces)
    pieces.append(b"")
    return pieces, eos


GRAMMAR = tg.json_schema_to_gbnf({
    "type": "object", "properties": {"ok": {"type": "boolean"},
                                     "n": {"type": "integer", "minimum": 0, "maximum": 99},
                                     "w": {"enum": ["é", "yes"]}},
    "required": ["ok", "n", "w"], "additionalProperties": False})


def _run(samp, chain_of, n_steps: int, seed: int, grammar: str = GRAMMAR,
         trigger_at: dict | None = None, **lazy) -> list[int]:
    """Tokens of a chain with a GrammarSampler (lazy when ``lazy`` gives its
    triggers) over seeded normal logits; ``trigger_at``: step -> a token
    whose logit that step pushes to the top."""
    pieces, eos = _vocab()
    gs = samp.GrammarSampler(grammar, pieces, {eos}, lazy=bool(lazy), **lazy)
    chain = samp.SamplerChain(chain_of(samp, gs, seed), seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_steps):
        logits = rng.normal(size=len(pieces)).astype(np.float32)
        if trigger_at and i in trigger_at:
            logits[trigger_at[i]] = 50.0
        tok = chain.sample(logits)
        out.append(tok)
        if tok == eos:
            break
    return out


CHAINS = {
    "greedy": lambda s, gs, seed: [s.Penalties(64, 1.0, 0.0, 0.0), gs, s.Greedy()],
    "sampled": lambda s, gs, seed: [s.TopK(40), s.TopP(0.95), s.MinP(0.05),
                                    s.Temperature(0.8), gs, s.Dist(seed)],
    # a cut to 2 candidates leaves no legal token at most steps: the
    # sampler rescans the whole vocab against the pre-chain logits
    "rescan": lambda s, gs, seed: [s.TopK(2), gs, s.Dist(seed)],
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("chain", list(CHAINS))
def test_grammar_sampler_matches_jax(chain, seed):
    got = _run(tsamp, CHAINS[chain], 200, seed)
    ref = _run(jsamp, CHAINS[chain], 200, seed)
    assert got == ref
    pieces, eos = _vocab()
    assert got[-1] == eos
    st = tgbnf.GrammarState(tgbnf.parse_gbnf(GRAMMAR))
    assert st.accept_bytes(b"".join(pieces[t] for t in got[:-1])) and st.can_terminate


@pytest.mark.parametrize("how", ["pattern", "token"])
def test_lazy_grammar_matches_jax(how):
    """Unconstrained until the trigger, then held to the grammar (from the
    pattern's start; after a trigger token, which the grammar does not see)."""
    pieces, eos = _vocab()
    lt = pieces.index(b"<")
    lazy = ({"trigger_patterns": [r"<"]} if how == "pattern" else {"trigger_tokens": {lt}})
    runs = [_run(samp, CHAINS["sampled"], 60, 4, grammar='root ::= "<"? [a-z]+ ">"',
                 trigger_at={10: lt}, **lazy) for samp in (tsamp, jsamp)]
    assert runs[0] == runs[1]
    toks = runs[0]
    text = b"".join(pieces[t] for t in toks if t != eos)
    tail = text[text.index(b"<") + 1:]
    assert len(toks) > 11 and toks[-1] == eos
    assert tail.endswith(b">") and tail[:-1].lstrip(b"<").isalpha()
