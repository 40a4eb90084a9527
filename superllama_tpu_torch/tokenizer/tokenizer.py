"""SPM / BPE / WPM tokenizers (behavioral parity with src/llama-vocab.cpp
llm_tokenizer_{spm,bpe,wpm}; original implementation). SPM and byte-level
BPE merges run in the native core (``native/tokenizer.cpp``), whose ids
are the Python paths' here."""

from __future__ import annotations

import heapq
import unicodedata
from functools import lru_cache

from .pretokenizers import regex_split
from .vocab import TokenAttr, Vocab


@lru_cache(maxsize=1)
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2 byte↔unicode bijection used by byte-level BPE."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@lru_cache(maxsize=1)
def _unicode_to_byte() -> dict[str, int]:
    return {v: k for k, v in _byte_to_unicode().items()}


class Tokenizer:
    """Unified tokenizer front-end; dispatches on vocab.model."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.model = vocab.model
        self._nat = None        # native (C++) core, built lazily
        self._nat_tried = False
        if self.model in ("gpt2",):
            self._merge_rank = {m: i for i, m in enumerate(vocab.merges)}
        elif self.model == "rwkv":
            # byte trie over unescaped token bytes (llm_tokenizer_rwkv,
            # src/llama-vocab.cpp:1190-1204); -1 key holds the token id
            trie: dict = {}
            for tid, tok in enumerate(vocab.tokens):
                node = trie
                for byte in _rwkv_unescape(tok):
                    node = node.setdefault(byte, {})
                node[-1] = tid
            self._rwkv_trie = trie

    # ------------------------------------------------------------- encode

    def encode(self, text: str, add_special: bool = True, parse_special: bool = False) -> list[int]:
        v = self.vocab
        out: list[int] = []
        fragments = v.partition_specials(text, parse_special)

        if self.model == "llama":  # SPM
            is_prev_special = True
            if add_special and v.add_bos and v.bos_id >= 0:
                out.append(v.bos_id)
            for frag, tid in fragments:
                if tid >= 0:
                    out.append(tid)
                    is_prev_special = True
                else:
                    t = frag
                    if v.add_space_prefix and is_prev_special:
                        t = " " + t
                    self._spm_tokenize(t.replace(" ", "▁"), out)
                    is_prev_special = False
            if add_special and v.add_eos and v.eos_id >= 0:
                out.append(v.eos_id)
        elif self.model == "gpt2":  # BPE
            if add_special and v.add_bos and v.bos_id >= 0:
                out.append(v.bos_id)
            for frag, tid in fragments:
                if tid >= 0:
                    out.append(tid)
                else:
                    self._bpe_tokenize(frag, out)
            if add_special and v.add_eos and v.eos_id >= 0:
                out.append(v.eos_id)
        elif self.model == "t5":  # UGM (unigram LM, Viterbi)
            if add_special and v.add_bos and v.bos_id >= 0:
                out.append(v.bos_id)
            first = True
            for frag, tid in fragments:
                if tid >= 0:
                    out.append(tid)
                    first = True
                else:
                    t = frag
                    if v.add_space_prefix and first:
                        t = " " + t
                    self._ugm_tokenize(t.replace(" ", "▁"), out)
                    first = False
            if add_special and v.add_eos and v.eos_id >= 0:
                out.append(v.eos_id)
        elif self.model == "bert":  # WPM
            if add_special and v.bos_id >= 0:
                out.append(v.bos_id)
            for frag, tid in fragments:
                if tid >= 0:
                    out.append(tid)
                else:
                    self._wpm_tokenize(frag, out)
            if add_special and v.sep_id >= 0:
                out.append(v.sep_id)
        elif self.model == "plamo2":  # suffix-table Viterbi
            if add_special and v.add_bos and v.bos_id >= 0:
                out.append(v.bos_id)
            for frag, tid in fragments:
                if tid >= 0:
                    out.append(tid)
                else:
                    self._plamo2_tokenize(frag, out)
            if add_special and v.add_eos and v.eos_id >= 0:
                out.append(v.eos_id)
        elif self.model == "rwkv":  # greedy longest byte match via trie
            for frag, tid in fragments:
                if tid >= 0:
                    out.append(tid)
                    continue
                data = frag.encode("utf-8")
                i = 0
                while i < len(data):
                    node = self._rwkv_trie.get(data[i])
                    if node is None:
                        out.append(v.unk_id if v.unk_id >= 0 else 0)
                        i += 1
                        continue
                    # walk as deep as possible, remembering the last token end
                    # (llm_tokenizer_rwkv_session::tokenize semantics)
                    best_id, best_end = -1, i + 1
                    j = i + 1
                    while node is not None:
                        if -1 in node:
                            best_id, best_end = node[-1], j
                        node = node.get(data[j]) if j < len(data) else None
                        j += 1
                    if best_id < 0:
                        out.append(v.unk_id if v.unk_id >= 0 else 0)
                        i += 1
                    else:
                        out.append(best_id)
                        i = best_end
        else:
            raise NotImplementedError(f"tokenizer model {self.model!r}")
        return out

    # ------------------------------------------------------------- UGM

    def _ugm_tokenize(self, text: str, out: list[int]):
        """Unigram-LM Viterbi segmentation (llm_tokenizer_ugm semantics):
        maximize the sum of vocab log-prob scores over a segmentation;
        unmatchable codepoints take unk with (min_score − 10) penalty,
        consecutive unknowns fuse into one unk token."""
        v = self.vocab
        n = len(text)
        if n == 0:
            return
        if not hasattr(self, "_ugm_max_len"):
            self._ugm_max_len = max((len(t) for t in v.token_to_id), default=1)
            finite = [s for s in v.scores if s > -1e30]
            self._ugm_unk_score = (min(finite) if finite else 0.0) - 10.0
        max_len = self._ugm_max_len
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        best[0] = 0.0
        back: list[tuple[int, int]] = [(-1, -2)] * (n + 1)
        for i in range(n):
            if best[i] == NEG:
                continue
            for j in range(i + 1, min(i + max_len, n) + 1):
                tid = v.token_to_id.get(text[i:j])
                if tid is None:
                    continue
                s = best[i] + v.scores[tid]
                if s > best[j]:
                    best[j] = s
                    back[j] = (i, tid)
            s = best[i] + self._ugm_unk_score  # unk fallback, one codepoint
            if s > best[i + 1]:
                best[i + 1] = s
                back[i + 1] = (i, -1)
        ids: list[int] = []
        j = n
        while j > 0:
            i, tid = back[j]
            ids.append(tid)
            j = i
        ids.reverse()
        for k, tid in enumerate(ids):
            if tid >= 0:
                out.append(tid)
            elif not (k > 0 and ids[k - 1] < 0):  # fuse consecutive unknowns
                out.append(v.unk_id if v.unk_id >= 0 else 0)

    # ------------------------------------------------------------- PLAMO2

    def _plamo2_tokenize(self, text: str, out: list[int]):
        """PLaMo-2 tokenization (llm_tokenizer_plamo2 semantics,
        src/llama-vocab.cpp): right-to-left Viterbi MINIMIZING Σ(−score) with
        scores quantized to round(score·1e4); a 1-codepoint "unknown" piece
        costs −UNKNOWN_SCORE and decodes to UTF-8 byte-fallback tokens. The
        reference walks a suffix-automaton table; enumerating candidate pieces
        longest-first at each position is the same decision order."""
        import math

        v = self.vocab
        if text.startswith("﻿"):  # BOM skip
            text = text[1:]
        n = len(text)
        if n == 0:
            return
        if not hasattr(self, "_plamo2_scores"):
            UNKNOWN = -10000000
            q = {}
            max_len = 1
            for i, t in enumerate(v.tokens):
                if v.is_byte(i) or not t:
                    continue
                s = v.scores[i]
                if not math.isfinite(s):
                    continue
                q[t] = (i, int(math.copysign(math.floor(abs(s) * 1e4 + 0.5), s)))
                max_len = max(max_len, len(t))
            self._plamo2_scores = q
            self._plamo2_maxlen = max_len
            self._plamo2_unknown = UNKNOWN
        q = self._plamo2_scores
        UNKNOWN = self._plamo2_unknown

        BIG = 1 << 60
        scores = [BIG] * (n + 1)
        scores[n] = 0
        tok_len = [1] * (n + 1)
        tok_id = [-1] * (n + 1)
        for i in range(n - 1, -1, -1):
            # real pieces, longest first (suffix-table row order)
            for j in range(min(i + self._plamo2_maxlen, n), i, -1):
                hit = q.get(text[i:j])
                if hit is None:
                    continue
                s = scores[j] - hit[1]
                if s < scores[i]:
                    scores[i] = s
                    tok_len[i], tok_id[i] = j - i, hit[0]
            s = scores[i + 1] - UNKNOWN  # sentinel: unknown single codepoint
            if s < scores[i]:
                scores[i] = s
                tok_len[i], tok_id[i] = 1, -1

        pos = 0
        while pos < n:
            if tok_id[pos] >= 0:
                out.append(tok_id[pos])
            else:
                for b in text[pos].encode("utf-8"):
                    bt = v.byte_to_token(b)
                    out.append(bt if bt >= 0 else (v.unk_id if v.unk_id >= 0 else 0))
            pos += tok_len[pos]

    # ------------------------------------------------------------- SPM

    def _native(self):
        """Lazily build the native (C++) tokenizer core for this vocab; its
        ids are the Python paths' below, which stay the plain version (and
        run under ``SLT_NO_NATIVE=1``). A failed build raises, every call."""
        if not self._nat_tried:
            from .. import native

            if self.model == "llama":
                self._nat = native.native_spm(self.vocab)
            elif self.model == "gpt2":
                self._nat = native.native_bpe(self.vocab)
            self._nat_tried = True
        return self._nat

    def _spm_tokenize(self, text: str, out: list[int]):
        """Greedy bigram merge by vocab score (llm_tokenizer_spm semantics)."""
        nat = self._native()
        if nat is not None:
            out.extend(nat.encode(text))
            return
        v = self.vocab
        data = text.encode("utf-8")
        if not data:
            return
        # initial symbols: one per utf-8 character
        sym_start: list[int] = []
        i = 0
        while i < len(data):
            sym_start.append(i)
            b = data[i]
            i += 1 if b < 0x80 else (2 if b < 0xE0 else (3 if b < 0xF0 else 4))
            i = min(i, len(data))
        n_sym = len(sym_start)
        size = [
            (sym_start[k + 1] if k + 1 < n_sym else len(data)) - sym_start[k]
            for k in range(n_sym)
        ]
        prev = list(range(-1, n_sym - 1))
        nxt = list(range(1, n_sym + 1))
        nxt[-1] = -1

        rev_merge: dict[bytes, tuple[int, int]] = {}
        heap: list[tuple[float, int, int]] = []  # (-score, left_idx, combined_size)

        def try_add(left: int, right: int):
            if left < 0 or right < 0 or right >= n_sym:
                return
            txt = bytes(data[sym_start[left] : sym_start[right] + size[right]])
            tid = v.token_to_id.get(txt.decode("utf-8", errors="ignore") if False else None)
            # llama.cpp looks up the raw byte string as utf-8; we mirror exactly:
            try:
                s = txt.decode("utf-8")
            except UnicodeDecodeError:
                return
            tid = v.token_to_id.get(s)
            if tid is None or tid >= v.n_tokens or not v.is_normal(tid):
                return
            heapq.heappush(heap, (-v.scores[tid], left, len(txt)))

        for k in range(n_sym - 1):
            try_add(k, k + 1)

        while heap:
            negscore, left, bsize = heapq.heappop(heap)
            right = nxt[left]
            if size[left] == 0 or right < 0 or size[right] == 0 or size[left] + size[right] != bsize:
                continue
            merged = bytes(data[sym_start[left] : sym_start[left] + bsize])
            rev_merge[merged] = (left, right)
            size[left] += size[right]
            size[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add(prev[left], left)
            try_add(left, nxt[left])

        def resegment(k: int):
            txt = bytes(data[sym_start[k] : sym_start[k] + size[k]])
            try:
                tid = v.token_to_id.get(txt.decode("utf-8"))
            except UnicodeDecodeError:
                tid = None
            if tid is not None:
                out.append(tid)
                return
            pair = rev_merge.get(txt)
            if pair is None:
                for byte in txt:
                    bt = v.byte_to_token(byte)
                    out.append(bt if bt >= 0 else v.unk_id)
                return
            resegment(pair[0])
            resegment(pair[1])

        k = 0
        while k != -1 and k < n_sym:
            if size[k] > 0:
                resegment(k)
            k = nxt[k]

    # ------------------------------------------------------------- BPE

    def _bpe_tokenize(self, text: str, out: list[int]):
        v = self.vocab
        b2u = _byte_to_unicode()
        nat = self._native()
        for word in regex_split(text, v.pre):
            enc = "".join(b2u[b] for b in word.encode("utf-8"))
            if nat is not None:
                out.extend(nat.encode_word(enc))
                continue
            parts = self._bpe_merge(enc)
            for p in parts:
                tid = v.token_to_id.get(p)
                if tid is not None:
                    out.append(tid)
                else:
                    for ch in p:
                        tid = v.token_to_id.get(ch)
                        if tid is not None:
                            out.append(tid)

    def _bpe_merge(self, enc: str) -> list[str]:
        """Rank-based merge over byte-encoded characters."""
        rank = self._merge_rank
        n_sym = len(enc)
        if n_sym == 0:
            return []
        sym = list(enc)
        size = [1] * n_sym
        prev = list(range(-1, n_sym - 1))
        nxt = list(range(1, n_sym + 1))
        nxt[-1] = -1
        heap: list[tuple[int, int, int]] = []  # (rank, left, combined_len)

        def txt(k: int) -> str:
            return "".join(sym[k : k + size[k]]) if size[k] else ""

        def try_add(left: int, right: int):
            if left < 0 or right < 0:
                return
            lt, rt = txt(left), txt(right)
            r = rank.get(lt + " " + rt)
            if r is not None:
                heapq.heappush(heap, (r, left, size[left] + size[right]))

        for k in range(n_sym - 1):
            try_add(k, k + 1)

        while heap:
            _, left, csize = heapq.heappop(heap)
            right = nxt[left]
            if size[left] == 0 or right < 0 or size[right] == 0 or size[left] + size[right] != csize:
                continue
            size[left] += size[right]
            size[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add(prev[left], left)
            try_add(left, nxt[left])

        parts = []
        k = 0
        while 0 <= k < n_sym:
            if size[k] > 0:
                parts.append(txt(k))
            k = nxt[k]
        return parts

    # ------------------------------------------------------------- WPM

    def _wpm_tokenize(self, text: str, out: list[int]):
        """WPM preprocessing + greedy longest-match (llm_tokenizer_wpm_session):
        NFD (marks kept), tolower, words split on whitespace; punctuation,
        ASCII symbols, and CJK chars become single-char words; a word with no
        full tokenization collapses to a single UNK."""
        v = self.vocab
        words: list[str] = [""]
        # the reference's unicode_cpts_normalize_nfd maps each codepoint to the
        # first codepoint of its NFD decomposition (base char, marks dropped)
        for ch in text:
            d = unicodedata.normalize("NFD", ch)
            if d:
                ch = d[0]
            cp = ord(ch)
            cat = unicodedata.category(ch)
            if ch.isspace() or cat == "Zs":
                if words[-1]:
                    words.append("")
                continue
            if cp == 0 or cp == 0xFFFD or cat in ("Cc", "Cf"):
                continue
            ch = ch.lower()
            if cat.startswith("P") or (cp < 0x7F and cat.startswith("S")) or _is_cjk_wpm(cp):
                if words[-1]:
                    words.append("")
                words[-1] = ch
                words.append("")
            else:
                words[-1] += ch
        for word in words:
            if not word:
                continue
            word1 = "▁" + word
            toks: list[int] = []
            i = 0
            ok = True
            while i < len(word1):
                found = -1
                for j in range(len(word1), i, -1):
                    tid = v.token_to_id.get(word1[i:j])
                    if tid is not None:
                        found = tid
                        i = j
                        break
                if found < 0:
                    ok = False
                    break
                toks.append(found)
            if ok and toks:
                out.extend(toks)
            else:
                out.append(v.unk_id)

    # ------------------------------------------------------------- decode

    def token_to_piece(self, tid: int, special: bool = False) -> bytes:
        v = self.vocab
        text = v.tokens[tid]
        attr = v.attrs[tid]
        if attr & (TokenAttr.CONTROL | TokenAttr.UNKNOWN) and not special:
            return b""
        if attr & TokenAttr.BYTE:
            if self.model == "llama" and text.startswith("<0x"):
                return bytes([int(text[3:5], 16)])
        if self.model in ("llama", "bert"):
            return text.replace("▁", " ").encode("utf-8")
        if self.model == "rwkv":
            return _rwkv_unescape(text)
        if self.model == "gpt2":
            if attr & (TokenAttr.CONTROL | TokenAttr.USER_DEFINED) :
                return text.encode("utf-8")
            u2b = _unicode_to_byte()
            return bytes(u2b.get(ch, ord("?")) for ch in text)
        return text.encode("utf-8")

    def decode(self, ids: list[int], special: bool = False) -> str:
        data = b"".join(self.token_to_piece(t, special) for t in ids)
        text = data.decode("utf-8", errors="replace")
        # SPM: drop the leading dummy space that encode() inserted
        if self.model == "llama" and self.vocab.add_space_prefix and text.startswith(" "):
            text = text[1:]
        return text


def _rwkv_unescape(escaped: str) -> bytes:
    """RWKV world-vocab tokens are stored escaped (\\t \\n \\r \\xHH \\\\);
    decode to raw bytes (llama_unescape_rwkv_token, src/llama-vocab.cpp:1136)."""
    out = bytearray()
    i, n = 0, len(escaped)
    while i < n:
        c = escaped[i]
        if c == "\\" and i + 1 < n:
            nxt = escaped[i + 1]
            if nxt == "t":
                out.append(9)
            elif nxt == "n":
                out.append(10)
            elif nxt == "r":
                out.append(13)
            elif nxt == "x" and i + 3 < n:
                out.append(int(escaped[i + 2:i + 4], 16))
                i += 4
                continue
            else:
                out.extend(nxt.encode("utf-8", errors="replace"))
            i += 2
        else:
            out.extend(c.encode("utf-8", errors="replace"))
            i += 1
    return bytes(out)


def _is_cjk_wpm(cp: int) -> bool:
    # note: 0x2B920 lower bound (not 0x2B820) mirrors the HF rust tokenizer
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )
