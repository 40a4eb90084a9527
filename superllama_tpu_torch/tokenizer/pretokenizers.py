"""BPE pre-tokenizer split patterns, keyed by the GGUF ``tokenizer.ggml.pre``
name (name→pattern mapping mirrors src/llama-vocab.cpp:1851-2045; the patterns
themselves are the models' published tokenizer.json regexes — we use the
originals directly since Python ``regex`` supports ``(?i:)`` and lookarounds
that the reference had to approximate).
"""

from __future__ import annotations

import regex

# canonical pattern fragments
_GPT2 = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"
_LLAMA3 = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_QWEN2 = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_TEKKEN = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_GPT4O = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
    r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
    r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_DEEPSEEK_LLM_LETTERS = (
    r"\s?[A-Za-zµÀ-ÖØ-öø-ƺƼ-ƿǄ-ʓʕ-ʯͰ-ͳͶͷͻ-ͽͿΆΈ-ΊΌΎ-ΡΣ-ϵϷ-ҁҊ-ԯԱ-ՖႠ-ჅᎠ-Ᏽᏸ-ᏽᲐ-ᲺᲽ-Ჿᴀ-ᴫᵫ-ᵷᵹ-ᶚḀ-ἕἘ-Ἕἠ-ὅὈ-Ὅὐ-ὗὙὛὝὟ-ώᾀ-ᾴᾶ-ᾼιῂ-ῄῆ-ῌῐ-ΐῖ-Ίῠ-Ῥῲ-ῴῶ-ῼℂℇℊ-ℓℕℙ-ℝℤΩℨK-ℭℯ-ℴℹℼ-ℿⅅ-ⅉⅎↃↄⰀ-ⱻⱾ-ⳤⳫ-ⳮⳲⳳꙀ-ꙭꚀ-ꚛꜢ-ꝯꝱ-ꞇꞋ-ꞎꭰ-ꮿﬀ-ﬆﬓ-ﬗＡ-Ｚａ-ｚ𐐀-𐑏𐒰-𐓓𐓘-𐓻𐲀-𐲲𐳀-𐳲𑢠-𑣟𞤀-𞥃]+"
)
_HUNYUAN_DENSE_MAIN = (
    r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+"
    r"|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

# pre-name → ordered list of split patterns (applied sequentially, matches kept)
PRE_PATTERNS: dict[str, list[str]] = {
    "default": [_GPT2],
    # llama3 family
    **{k: [_LLAMA3] for k in ("llama3", "llama-v3", "llama-bpe", "falcon3", "falcon-h1",
                               "pixtral", "midm-2.0", "lfm2", "dbrx", "smaug-bpe",
                               "glm4", "chatglm-bpe", "grok-2")},
    "deepseek-llm": ["[\r\n]", _DEEPSEEK_LLM_LETTERS, r"\s?[!-/:-~！-／：-～‘-‟　-。]+",
                      r"\s+$", r"[一-龥ࠀ-一가-퟿]+", r"\p{N}+"],
    "deepseek-coder": ["[\r\n]", r"\s?\p{L}+", r"\s?\p{P}+", r"[一-龥ࠀ-一가-퟿]+", r"\p{N}"],
    **{k: [r"\p{N}{1,3}", r"[一-龥぀-ゟ゠-ヿ]+", _HUNYUAN_DENSE_MAIN]
       for k in ("deepseek-v3", "hunyuan-dense")},
    "falcon": [r"[\p{P}\$\+<=>\^~\|`]+", _GPT2, r"[0-9][0-9][0-9]"],
    # starcoder family (digit-first)
    **{k: [r"\p{N}", _GPT2] for k in ("starcoder", "refact", "command-r", "smollm",
                                       "codeshell", "exaone", "minerva-7b")},
    # gpt-2 family
    **{k: [_GPT2] for k in ("gpt-2", "phi-2", "jina-es", "jina-de", "gigachat",
                             "jina-v2-es", "jina-v2-de", "a.x-4.0", "mellum",
                             "modern-bert", "mpt", "olmo", "jais", "trillion",
                             "granite-docling", "jina-v1-en", "jina-v2-code",
                             "roberta-bpe", "megrez", "exaone4")},
    # qwen2 family
    **{k: [_QWEN2] for k in ("qwen2", "deepseek-r1-qwen", "kormo", "stablelm2",
                              "hunyuan", "solar-open")},
    **{k: [r" ?[^(\s|.,!?…。，、।۔،)]+"] for k in ("poro-chat", "bloom", "gpt3-finnish")},
    "viking": [r" ?[^(\s|.,!?…。，、।۔،)]+", r"\p{N}"],
    "tekken": [_TEKKEN],
    "chameleon": [r"<sentinel:[0-9]+>", r"(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z",
                   r"([\t\n]|    |  )", r"\p{N}", r"[\p{P}!-/:-@\[-`{-~]", _GPT2],
    **{k: [_GPT4O] for k in ("gpt-4o", "llama4", "minimax-m2")},
    "superbpe": [r"\p{N}+", r"(?=(\d{3})+(?!\d))"],
    **{k: [r"'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"]
       for k in ("bailingmoe", "bailingmoe2", "llada-moe")},
    "seed-coder": [r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1}| ?[^\s\p{L}\p{N}\r\n]+|\s*[\r\n]+|\s+(?!\S)|\s+"],
    # kimi-k2: the model's published pattern (the reference re-implements this in C++)
    "kimi-k2": [r"\p{Han}+",
                 r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}&&[^\p{Han}]]*[\p{Ll}\p{Lm}\p{Lo}\p{M}&&[^\p{Han}]]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
                 r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}&&[^\p{Han}]]+[\p{Ll}\p{Lm}\p{Lo}\p{M}&&[^\p{Han}]]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
                 r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"],
    "youtu": [r"[가-힣ㄱ-ㆎ]+|[！…“”‘’—：；，、-〿︰-﹏]+|[ㄅ-ㄯ]+|[一-龥぀-ゟ゠-ヿ]+",
               r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
               r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
               r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"],
    "afmoe": [r"\p{N}{1,3}",
               r"[一-鿿㐀-䶿豈-﫿぀-ゟ゠-ヿ･-ﾟ⼀-⿟เ-๿຀-໿ក-៿က-႟ꩠ-ꩿꧠ-꧿가-힯ᄀ-ᇿ]+",
               r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"],
    "exaone-moe": [r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?(?:\p{L}\p{M}*(?: \p{L}\p{M}*)*)+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]?|\s*[\r\n]|\s+(?!\S)|\s+"],
}

_COMPILED: dict[str, list["regex.Pattern"]] = {}


def _sanitize_ranges(pattern: str) -> str:
    """Swap descending character-class ranges (e.g. ``Ὗ-ώ``) that some
    published patterns contain; other engines tolerate them, Python doesn't."""
    chars = list(pattern)
    out = []
    i = 0
    in_class = False
    while i < len(chars):
        c = chars[i]
        if c == "\\" and i + 1 < len(chars):
            out.extend(chars[i : i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            i += 1
            continue
        if c == "]" and in_class:
            in_class = False
            out.append(c)
            i += 1
            continue
        if (
            in_class
            and c == "-"
            and out
            and i + 1 < len(chars)
            and out[-1] not in "[\\"
            and chars[i + 1] != "]"
            and len(out[-1]) == 1
            and ord(out[-1]) > ord(chars[i + 1])
        ):
            lo, hi = chars[i + 1], out[-1]
            out[-1] = lo
            out.append("-")
            out.append(hi)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def get_patterns(pre: str) -> list["regex.Pattern"]:
    pats = _COMPILED.get(pre)
    if pats is None:
        raw = PRE_PATTERNS.get(pre)
        if raw is None:
            raw = PRE_PATTERNS["default"]
        pats = [regex.compile(_sanitize_ranges(p)) for p in raw]
        _COMPILED[pre] = pats
    return pats


def regex_split(text: str, pre: str) -> list[str]:
    """Split text into pre-tokenized words: each pattern is applied in turn to
    every fragment; matches become fragments, as do the spans between them
    (semantics of the reference's unicode_regex_split)."""
    fragments = [text]
    for pat in get_patterns(pre):
        out: list[str] = []
        for frag in fragments:
            pos = 0
            for m in pat.finditer(frag):
                s, e = m.span()
                if s == e:  # zero-width match → pure split point (superbpe style)
                    if s > pos:
                        out.append(frag[pos:s])
                        pos = s
                    continue
                if s > pos:
                    out.append(frag[pos:s])
                out.append(frag[s:e])
                pos = e
            if pos < len(frag):
                out.append(frag[pos:])
        fragments = out
    return fragments
