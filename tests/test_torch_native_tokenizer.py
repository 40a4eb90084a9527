"""The port's native tokenizer core (``native/tokenizer.cpp``: SPM bigram
merges, BPE rank merges) against the JAX package's Python tokenizer paths
on two tiny vocabularies built here from a seeded corpus: a SentencePiece
vocab with scored pieces and byte fallback, and a byte-level BPE vocab
with learned merges. The ids of the port's native path, the port's Python
path (the plain version, ``SLT_NO_NATIVE=1``) and the JAX package's Python
path must be equal for every text."""

import collections
import re

import pytest

from superllama_tpu.tokenizer import Tokenizer as JTokenizer
from superllama_tpu.tokenizer.vocab import TokenAttr as JAttr
from superllama_tpu.tokenizer.vocab import Vocab as JVocab
from superllama_tpu_torch.tokenizer import Tokenizer
from superllama_tpu_torch.tokenizer.tokenizer import _byte_to_unicode
from superllama_tpu_torch.tokenizer.vocab import TokenAttr, Vocab

CORPUS = ("The quick brown fox jumps over the lazy dog. Then the fox rests; the dog "
          "barks at the other fox, and the farmer laughs. In the evening there is rain "
          "in the hills and on the river: 1234 drops, 56.78 liters. Internationalisation "
          "is hard, interesting and entertaining. ") * 3

TEXTS = [
    "The fox jumps over the lazy dog.",
    "the the the, there then: other",
    "  leading and   inner   spaces\tand tabs\n\nnew lines  ",
    "numbers 1234567890 and 3.14159 and 2,718",
    "Internationalisation — naïve café, façade, coöperate",
    "日本語のテキストと中文",
    "emoji 🙂🚀 and symbols ©®™ ∑∫√",
    "unknownwordsxyzqq zzzz qqqq",
    "",
    "a",
]


def spm_fields():
    """<unk>, <s>, </s>, the 256 byte pieces, then word pieces of the
    corpus (▁-prefixed words and their prefixes / suffixes) scored by
    log frequency."""
    counts = collections.Counter()
    for w in re.findall(r"\w+|[^\w\s]", CORPUS):
        w = "▁" + w
        for n in range(1, min(len(w), 6) + 1):
            counts[w[:n]] += 1
            counts[w[-n:]] += 1
    pieces = [p for p, _ in counts.most_common(300)]
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += [p for p in pieces if p not in tokens]
    scores = [0.0, 0.0, 0.0] + [0.0] * 256 + [-float(i) * 0.25 for i in range(len(tokens) - 259)]
    attrs = ["UNKNOWN", "CONTROL", "CONTROL"] + ["BYTE"] * 256 + ["NORMAL"] * (len(tokens) - 259)
    return dict(model="llama", pre="default", tokens=tokens, scores=scores, attrs=attrs,
                unk_id=0, bos_id=1, eos_id=2, add_bos=True)


def bpe_fields(n_merges: int = 120):
    """The 256 byte-level pieces plus the merges of a greedy BPE trained on
    the corpus' pre-split words."""
    b2u = _byte_to_unicode()
    words = collections.Counter("".join(b2u[b] for b in w.encode())
                                for w in re.findall(r" ?\w+| ?[^\w\s]+|\s+", CORPUS))
    seqs = {w: list(w) for w in words}
    tokens = [b2u[b] for b in range(256)]
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, s in seqs.items():
            for a, b in zip(s, s[1:]):
                pairs[a, b] += words[w]
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        tokens.append(a + b)
        for w, s in seqs.items():
            i, out = 0, []
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = out
    tokens += ["<|bos|>", "<|eos|>"]
    n = len(tokens)
    attrs = ["NORMAL"] * (n - 2) + ["CONTROL"] * 2
    return dict(model="gpt2", pre="default", tokens=tokens, scores=[0.0] * n, attrs=attrs,
                merges=merges, bos_id=n - 2, eos_id=n - 1, add_bos=True)


def make(fields, vocab_cls, attr_cls, tok_cls, native: bool):
    f = dict(fields, attrs=[getattr(attr_cls, a) for a in fields["attrs"]])
    tok = tok_cls(vocab_cls(**f))
    if not native:                       # the Python path, the plain version
        tok._nat, tok._nat_tried = None, True
    return tok


FIELDS = {"spm": spm_fields(), "bpe": bpe_fields()}


@pytest.fixture(scope="module")
def toks():
    return {name: (make(f, Vocab, TokenAttr, Tokenizer, True),
                   make(f, Vocab, TokenAttr, Tokenizer, False),
                   make(f, JVocab, JAttr, JTokenizer, False))
            for name, f in FIELDS.items()}


@pytest.mark.parametrize("text", TEXTS, ids=[f"t{i}" for i in range(len(TEXTS))])
@pytest.mark.parametrize("model", list(FIELDS))
def test_native_ids_equal_python_and_jax(toks, model, text):
    native, plain, jax_plain = toks[model]
    got = native.encode(text, add_special=True)
    assert native._nat is not None
    assert got == plain.encode(text, add_special=True)
    assert got == jax_plain.encode(text, add_special=True)
    # the vocab really merges: a corpus sentence takes fewer ids than bytes
    assert len(native.encode(CORPUS[:200], add_special=False)) < 120


def test_corpus_round_trip(toks):
    """The whole corpus encodes to the same ids natively and in Python, and
    decodes back to its text."""
    for native, plain, _ in toks.values():
        ids = native.encode(CORPUS, add_special=False)
        assert ids == plain.encode(CORPUS, add_special=False)
        assert native.decode(ids).strip() == CORPUS.strip()
