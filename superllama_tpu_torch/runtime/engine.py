"""Continuous-batching inference engine over a dense or paged KV cache.

Counterpart of the JAX package's ``runtime/engine.py::Engine`` (the
reference server's update_slots semantics):

 - decode: one (n_slots, 1) forward over all slots; idle slots ride along
   with pos = -1 (masked, cursor not advanced);
 - prefill: prompts load in bucketed chunks (``PREFILL_BUCKETS``), one chunk
   per engine step. A lone prompt prefills into the engine's one-row
   scratch cache, which is then copied into its slot's row; a second lone
   prompt waits (``prefill_off`` 0) until the scratch is free, or joins a
   wave if one forms meanwhile. Two or more prompts load together in one
   (n_slots, P) wave straight into the big cache;
 - sampling: the first token of a request comes from its host
   ``SamplerChain``. When every generating slot's config is expressible by
   the device sampler chain (``ops/device_sampling.py``: all but DRY,
   mirostat, adaptive-p, more than 16 bias entries and a grammar), a block of
   ``block_size`` forward + sample steps runs on the device, keyed per row
   by the request's seed and the count of tokens it has sampled, so a
   seeded request gives the JAX package's tokens; greedy-only blocks take a
   plain argmax. Other configs take the host-sampled step decode;
 - the block is one function over static input and output buffers. On a
   CUDA device it is captured once per (cache, block size, slot window,
   greedy-only) in a CUDA graph (``runtime/graphs.py``) and replayed; on
   the CPU it runs eagerly. Dense-cache blocks are pipelined as in the JAX
   engine (``pipeline_depth``): the next block chains off the previous
   one's device-resident outputs while the host reads the tokens of the
   one before, and stops roll the cache back with ``kv_truncate_rows``;
 - a prompt chunk is one function over static buffers too (``_chunk``:
   tokens, positions, each row's last column in; each row's logits at that
   column out), captured once per ("chunk", cache, rows, P) and replayed:
   rows 1 for the lone prompt (the scratch) and for a paged chunk, n_slots
   for a wave. The first token is read from its static output after the
   replay;
 - ``warmup()`` (the JAX engine's ``warmup``) captures every key the engine
   can reach before the first request, then serves one micro-wave of two
   2-token prompts and leaves every slot as it found it. The server calls
   it before serving; the engine never warms up by itself;
 - the dense cache is f32/bf16, or Q8_0 / Q4_0 (``kv_dtype="q8_0"`` /
   ``"q4_0"``);
 - iSWA (``iswa``, on by default for a model with sliding-window layers
   unless a paged, speculative, lookup, context-shift or quantized cache is
   asked for, as in JAX): the two-tier ``ISWACache`` from ``make_cache``,
   its ring sized for the largest prefill bucket past the window. Every
   prompt prefills in place (its row truncated to 0 first, padding sent to
   the spare slot), with no scratch; rollbacks, slot state and erasure go
   through ``cache_policy``'s ``truncate_rows`` / ``get_row`` / ``set_row``;
   the slot window is always the whole cache; a prefix is reused only while
   the ring still holds its window (the old request and the blocks it may
   have rolled back wrote at most ring - window positions past it);
 - paged mode (``paged=True``): a page pool with host spill
   (``PagedKVManager``). Admission frees the slot's pages; prompts prefill
   one chunk of at most ``page_size`` tokens per step, one slot at a time,
   on a one-row view of the pool (``paged_row_view``: that slot's table
   row and cursors, so no padding rows are computed); decode picks the
   slots whose pages fit the pool (round robin, the rest wait while their
   pages spill) and runs host-sampled steps or (unpipelined) blocks rolled
   back with ``PagedKVManager.rollback``;
 - prompt-prefix reuse: each slot keeps the tokens its cache row holds
   (``cache_tokens``) across requests. A request takes the free slot with
   the longest common prefix; a prefix of 16 tokens or more (at most the
   prompt less one) stays in the cache, and only the rest prefills, in
   place: the dense row is truncated to the prefix first (stale cells past
   it would otherwise be attended), a paged chain is trimmed to it
   (``PagedKVManager.trim_to_position``) and its chunks start mid-page;
 - the queue is ordered by ``GenRequest.priority`` (higher first, FIFO
   within a priority);
 - ``slot_save`` / ``slot_restore`` / ``slot_erase`` snapshot, load and
   clear an idle slot's cache row and token history (dense caches; a paged
   cache can only erase), writing into the cache's own storage, which
   captured graphs address;
 - constrained decoding: a request's ``grammar`` (GBNF text; ``grammar_lazy``
   waits for one of ``grammar_triggers``, regexes over the emitted text)
   puts a ``GrammarSampler`` into its host chain after the cutting stages,
   before the terminal picker, over the pieces of every id below n_vocab
   (``_vocab_pieces``, built once per engine). Such a slot is never fast,
   so while it generates every slot takes the host-sampled step, and its
   first token comes from its chain, not from an argmax;
 - speculative decoding (``draft_model``, ``n_draft``): a dense draft cache
   of the engine's ``kv_dtype`` shadows the target's rows (dense even when
   the target is paged). Such an engine starts each prompt whole and
   synchronously (target chunks on the scratch or the paged row view, then
   the draft's prompt on a one-row draft scratch): no prompt wave, no prefix
   reuse. Each round, one function over tensors (``_d_rollout``) catches the
   draft up on each row's 1-2 unseen tokens and drafts K tokens greedily,
   read once; one batched target pass verifies [last token, drafts] at K+1
   positions (``_verify``); each slot's host chain samples position by
   position, the longest agreeing prefix plus one token is kept, and both
   caches roll back (``kv_truncate_rows``, ``PagedKVManager.rollback``).
   When the vocabs differ (or are not ``are_compatible``) a
   ``VocabTranslator`` retokenizes through text (dense targets only);
 - lookup decoding (``lookup_ngrams``): drafts from a per-slot
   ``NgramCache`` over the slot's tokens, verified the same way;
 - context shift (``ctx_shift``): a slot about to pass n_ctx drops the
   oldest half after its first ``min(n_prompt, n_ctx // 4)`` cells
   (``kv_context_shift``: K re-roped, the row compacted, in place; a paged
   chain goes through a dense row and back);
 - speculative, lookup and shift steps run eagerly; blocks in flight are
   landed before any other kind of step;
 - recurrent and hybrid memories (mamba, mamba2, the jamba / Mamba-2
   hybrids, plamo2, the RWKV models, lfm2, qwen3next;
   ``cache_policy.cache_kind``): as in JAX, a paged,
   speculative, lookup, context-shift or quantized cache is refused
   (``ValueError``: the state cannot rewind), and the engine decodes one
   token a step (``block_size`` 1, no pipeline). The forward keeps each
   idle row's state (pos[:, 0] < 0; the JAX engine's ``mask_rows`` after
   the step), inside the captured block and chunk graphs. A prompt never
   reuses a prefix: its row is reset (``truncate_rows`` with keep 0), then
   it loads in place in fully valid power-of-two chunks (``pow2_chunk``,
   never a padded bucket: a pad token would advance the state) as
   (n_slots, P) with the other rows idle, one slot a step (no wave).
   Greedy decode steps run as one-step blocks (argmax on the device,
   captured); a step with a sampled slot runs the host-sampled step, as
   the JAX non-dense engine samples every step on the host, so a seeded
   request gives its tokens. Slot state goes through ``get_row`` /
   ``set_row``;
 - ``metrics`` is the JAX engine's counter dict (requests, tokens,
   prefill and decode seconds, decode steps, prompt tokens reused, tokens
   drafted and accepted, context shifts), beside the port's own ``stats``.

Thread model: ``submit`` enqueues; one engine thread (``start``) or the
caller (``run_until_drained``) owns the device. The cache is updated in
place.
"""

from __future__ import annotations

import queue
import re
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.loader import LoadedModel
from ..models.registry import get_forward
from ..ops import device_sampling as dsamp
from ..ops.ref import rope_frequencies
from ..utils import profiler
from .context import check_model_device
from ..ops import _build
from .graphs import GraphCache
from .cache_policy import cache_kind, get_row, make_cache, pow2_chunk, set_row, truncate_rows
from .kv_cache import (ISWACache, KVCache, iswa_layer_split, kv_cache_init, kv_context_shift,
                       kv_insert_row)
from .ngram import NgramCache
from .paged_kv import PagedKVManager, paged_cache_init, paged_row_view
from .sampling import GrammarSampler, SamplerChain, make_chain
from .speculative import VocabTranslator, are_compatible

PREFILL_BUCKETS = (32, 128, 512, 1024, 2048)
KERNEL_SOURCES = ("qmv", "qmm", "fa", "fd", "paged")   # the kernels a step reaches
SSM_SOURCES = ("gmm", "ssm_scan", "wkv")     # and those of a recurrent or hybrid model


class SlotState(Enum):
    IDLE = 0
    GENERATING = 1
    PREFILL = 2


@dataclass
class GenRequest:
    prompt_ids: list[int]
    max_tokens: int = 128
    stop_eog: bool = True
    stop_strings: list[str] = field(default_factory=list)
    sampling: dict = field(default_factory=dict)
    grammar: str | None = None       # GBNF text (constrained decoding)
    grammar_lazy: bool = False
    grammar_triggers: list[str] = field(default_factory=list)
    stream: Optional[Callable[[int, str], None]] = None  # (token_id, piece)
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])
    priority: int = 1                # higher is admitted first
    # filled by the engine
    _done: threading.Event = field(default_factory=threading.Event)
    _result: dict = field(default_factory=dict)

    def result(self, timeout: float | None = None) -> dict:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.request_id} timed out")
        if "error" in self._result:
            raise RuntimeError(self._result["error"])
        return self._result


@dataclass
class _Slot:
    idx: int
    state: SlotState = SlotState.IDLE
    req: GenRequest | None = None
    sampler: SamplerChain | None = None
    n_past: int = 0
    n_prompt: int = 0
    generated: list[int] = field(default_factory=list)
    text: str = ""
    t_start: float = 0.0
    t_first_token: float = 0.0
    # the tokens whose K/V the slot's cache row holds, kept across requests
    # for prompt-prefix reuse
    cache_tokens: list[int] = field(default_factory=list)
    # chunked prefill: one chunk per engine step
    pending: list[int] = field(default_factory=list)
    prefill_off: int = 0             # positions already prefilled
    prefill_P: int = 0               # chunk bucket width
    in_place: bool = False           # prefilling straight into the big cache
    # the device sampler chain
    fast: bool = False               # config expressible by the device chain
    seed: int = 0
    n_sampled: int = 0               # tokens emitted: the key stream's position
    # speculative decoding
    d_past: int = 0                  # the draft cache's cells for this row
    draft_tail: list[int] = field(default_factory=list)   # tokens the draft has not seen


class Engine:
    """Continuous-batching engine on one device (default CUDA). kv_dtype is a
    float torch dtype, or "q8_0" / "q4_0" for a quantized dense cache.

    ``graphs`` (default: on for a CUDA device) replays decode blocks and
    prompt chunks from CUDA graphs; ``graphs=False`` runs them eagerly, the
    CPU's only way. ``pipeline_depth`` is the number of dense-cache blocks
    in flight. ``draft_model`` / ``n_draft``, ``lookup_ngrams`` and
    ``ctx_shift`` are the JAX engine's decode variants (module docstring),
    with its checks. ``iswa`` (None: on for a model with SWA layers when no
    incompatible mode is asked for) serves the two-tier cache. A recurrent
    or hybrid model refuses the paged, speculative, lookup, context-shift
    and quantized modes (``ValueError``) and decodes one token a step."""

    def __init__(self, model: LoadedModel, n_slots: int = 4, n_ctx: int = 2048,
                 kv_dtype: torch.dtype | str = torch.bfloat16,
                 prefill_buckets=PREFILL_BUCKETS, block_size: int = 8,
                 device=None, paged: bool = False, page_size: int = 256,
                 n_pages: int | None = None, max_pages_per_seq: int | None = None,
                 pipeline_depth: int = 2, graphs: bool | None = None,
                 draft_model: LoadedModel | None = None, n_draft: int = 8,
                 ctx_shift: bool = False, lookup_ngrams: int = 0,
                 iswa: bool | None = None):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        self.kind = cache_kind(model.hparams)
        if self.kind != "dense":
            off = [nm for nm, on in (("paged", paged), ("speculative", draft_model is not None),
                                     ("lookup", lookup_ngrams), ("ctx-shift", ctx_shift)) if on]
            if off:
                raise ValueError(f"{self.kind} memory: {'/'.join(off)} not supported "
                                 f"(recurrent state cannot rewind — same restriction as "
                                 f"llama_memory_recurrent::seq_rm p0>0)")
            if isinstance(kv_dtype, str):
                raise ValueError("quantized KV requires a dense cache")
            # a multi-token block would overshoot a stop and roll back, and
            # recurrent state cannot rewind: one token a step, no pipeline
            block_size, pipeline_depth = 1, 1
        if paged:
            if lookup_ngrams and lookup_ngrams + 1 > page_size:
                raise ValueError("lookup window must fit one page")
            if draft_model is not None and n_draft + 1 > page_size:
                raise ValueError(f"speculative window {n_draft}+1 must fit one page "
                                 f"({page_size})")
        if ctx_shift and kv_dtype == "q4_0":
            raise ValueError("ctx_shift needs an f32, bf16 or Q8_0 cache: the shift re-ropes "
                             "K, and the JAX package's re-rope of a Q4_0 K fails (its "
                             "per-32-group scales taken as Q8_0's per-row ones)")
        self.model = model
        self.hp = model.hparams
        self.n_slots = n_slots
        self.n_ctx = n_ctx
        self.buckets = tuple(b for b in sorted(prefill_buckets) if b <= n_ctx) or (n_ctx,)
        self._fwd = get_forward(self.hp.arch)
        self.kv_dtype = kv_dtype
        self.block_size = max(1, int(block_size))
        self.paged = bool(paged)
        # the iSWA two-tier cache (llama_kv_cache_iswa, src/llama-kv-cache-iswa.h):
        # on for SWA models unless an incompatible mode is asked for
        incompat = (self.paged or draft_model is not None or bool(lookup_ngrams)
                    or ctx_shift or isinstance(kv_dtype, str)
                    or cache_kind(self.hp) != "dense")
        if iswa is None:
            iswa = (not incompat and self.hp.swa_window > 0
                    and len(iswa_layer_split(self.hp)[1]) > 0)
        elif iswa and incompat:
            raise ValueError("iswa cache: incompatible with paged/speculative/lookup/"
                             "ctx-shift/quantized-KV modes and non-dense memory")
        self.iswa = bool(iswa)
        self.pipeline_depth = max(1, int(pipeline_depth))
        if self.paged:
            hp = self.hp
            self.page_size = int(page_size)
            mpps = max_pages_per_seq or -(-n_ctx // self.page_size)
            self.pkv = PagedKVManager(paged_cache_init(
                hp.n_layer, n_pages or (n_slots * mpps + 1), self.page_size, n_slots,
                mpps, hp.n_head_kv, hp.head_dim, hp.head_dim_v, dtype=kv_dtype,
                device=self.device))
            # a decode block plans its pages up front: it must fit one page
            self.block_size = min(self.block_size, self.page_size)
            self.cache = None
            self._paged_rr = 0         # round-robin admission cursor
            # prompt chunks run on one row of the pool: the loading slot's
            # table row, and (warm runs) an empty one that writes only the
            # NULL page
            self._pview = paged_row_view(self.pkv.cache)
            self._pview_idle = paged_row_view(self.pkv.cache)
            self._scratch = None
        else:
            self.cache = make_cache(self.hp, n_slots, n_ctx, kv_dtype, iswa=self.iswa,
                                    n_ubatch=self.buckets[-1], device=self.device)
            # the lone prompt's one-row scratch: engine-owned, since a
            # captured chunk needs fixed addresses (an iSWA engine prefills
            # every prompt in place)
            self._scratch = (None if self.iswa or self.kind != "dense"
                             else self._new_cache(1))
        self._scratch_owner: _Slot | None = None
        self._pieces: tuple[list[bytes], set[int]] | None = None   # _vocab_pieces
        self._chunk_bufs: dict = {}    # (rows, P) -> (static io, the warm runs' io)
        self.slots = [_Slot(i) for i in range(n_slots)]
        # decode blocks: static inputs and outputs (the warm-up's own set has
        # every row idle), the chain's per-row parameters, the blocks in
        # flight (dense cache) and their graphs
        self._io = self._block_io()
        self._idle_io = self._block_io()
        self._sp = dsamp.chain_tensors(dsamp.chain_params([None] * n_slots, self.hp.n_vocab),
                                       self.device)
        self._sp_key = None
        self._pending_q: list[dict] = []
        if graphs is None:
            graphs = self.device.type == "cuda"
        self._graphs = GraphCache(self.device) if graphs else None
        self.stats = {"blocks": 0, "chained": 0, "chunks": 0}
        self._init_variants(draft_model, n_draft, ctx_shift, lookup_ngrams)
        # the JAX engine's counters (what /metrics and /slots read)
        self.metrics = {
            "n_requests": 0, "n_tokens_generated": 0, "n_prompt_tokens": 0,
            "prefill_s": 0.0, "decode_s": 0.0, "n_decode_steps": 0,
            "n_spec_drafted": 0, "n_spec_accepted": 0, "n_prompt_cached": 0,
            "n_ctx_shifts": 0,
        }
        # (-priority, arrival, request): higher priority first, FIFO within one
        self._queue: "queue.PriorityQueue" = queue.PriorityQueue()
        self._qseq = 0
        self._lock = threading.Lock()
        # serializes step() against callers that must see a quiet engine
        self._step_lock = threading.RLock()
        self._running = False
        self._thread: threading.Thread | None = None
        self._calls: "queue.Queue" = queue.Queue()    # on_engine_thread's calls

    def _init_variants(self, draft_model, n_draft: int, ctx_shift: bool,
                       lookup_ngrams: int) -> None:
        """The draft model's shadow cache and vocab translator, the context
        shift's rope table and the n-gram caches (JAX ``Engine.__init__``)."""
        self.draft_model = draft_model
        self.n_draft = int(n_draft)
        self.spec_translator = None
        if draft_model is not None:
            check_model_device(draft_model, self.device)
            dhp = draft_model.hparams
            tt, td = self.model.tokenizer, draft_model.tokenizer
            if dhp.n_vocab != self.hp.n_vocab or (
                    tt is not None and td is not None and not are_compatible(tt, td)):
                if tt is None or td is None:
                    raise ValueError("draft/target vocab mismatch and no tokenizers to "
                                     "translate through (common/speculative.cpp:89-148)")
                if self.paged:
                    raise ValueError("a draft of another vocab needs a dense target cache: "
                                     "the JAX engine's paged round feeds draft ids to the "
                                     "target untranslated")
                self.spec_translator = VocabTranslator(tt, td)
            self._dfwd = get_forward(dhp.arch)
            self.d_cache = self._new_cache(self.n_slots, dhp)
            self._d_scratch = self._new_cache(1, dhp)
        self.ctx_shift = bool(ctx_shift)
        if self.ctx_shift:
            # the JAX engine's table: no rope scaling, no per-dim factors
            self._rope = rope_frequencies(self.hp.head_dim, self.hp.n_rot,
                                          self.hp.rope_freq_base, device=self.device)
        self.lookup_k = int(lookup_ngrams)
        self._ngrams: dict[int, NgramCache] = {}
        self._ngram_hwm: dict[int, int] = {}

    @property
    def _variant(self) -> bool:
        """A speculative or lookup engine: never a dense block, no micro-wave."""
        return self.draft_model is not None or bool(self.lookup_k)

    def _block_io(self) -> dict:
        B = self.n_slots
        i64 = dict(dtype=torch.int64, device=self.device)
        io = {"toks": {}}     # the block's (B, n_steps) tokens, by n_steps
        for pre in ("", "_l"):
            io["tok" + pre] = torch.zeros((B, 1), **i64)
            io["pos" + pre] = torch.full((B, 1), -1, dtype=torch.int32, device=self.device)
            io["ring" + pre] = torch.full((B, dsamp.RING), -1, **i64)
            io["counts" + pre] = torch.zeros((B,), **i64)
        io["keys"] = torch.zeros((B, 2), **i64)
        return io

    def _new_cache(self, batch: int, hp=None) -> KVCache:
        hp = hp or self.hp
        return kv_cache_init(hp.n_layer, batch, self.n_ctx, hp.n_head_kv,
                             hp.head_dim, hp.head_dim_v, dtype=self.kv_dtype,
                             device=self.device)

    def _cache_label(self) -> str:
        if self.paged:
            return "paged"
        if self.kind != "dense":
            return f"{self.kind} {self.kv_dtype}"
        return f"iswa {self.kv_dtype}" if self.iswa else str(self.kv_dtype)

    # ----------------------------------------------------------- public API

    def submit(self, req: GenRequest) -> GenRequest:
        with self._lock:     # server threads submit concurrently
            self._qseq += 1
            self._queue.put((-req.priority, self._qseq, req))
            self.metrics["n_requests"] += 1
        return req

    def generate(self, prompt_ids: list[int], **kw) -> dict:
        req = self.submit(GenRequest(prompt_ids=prompt_ids, **kw))
        if not self._running:
            self.run_until_drained()
        return req.result()

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=30)
        self._run_calls()          # a call that arrived as the thread ended

    def run_until_drained(self):
        """Synchronous mode: run steps until all work completes."""
        while not self._queue.empty() or any(s.state != SlotState.IDLE for s in self.slots):
            self.step()

    @torch.no_grad()
    def warmup(self) -> dict:
        """Capture every graph key the engine can reach, then serve one real
        micro-wave: the counterpart of the JAX engine's ``warmup``, which
        compiles the same variants ahead of time. Call it on an idle engine
        before ``start``.

        On a dense cache the keys are every decode block (each slot window
        ``_s_bucket`` can return, greedy-only or not) and every prompt chunk
        (each bucket, at 1 row, the scratch, and at n_slots rows, a wave); on
        a paged cache the chunks of one row at each min(bucket, page_size)
        and the two blocks. Each capture's warm run keeps every row idle (pos
        -1, or the view's empty table), and the micro-wave (two 2-token
        prompts, 2 tokens each, as the JAX engine serves) is erased from its
        slots afterwards, so no slot's state changes, and ``metrics`` is
        left as it was. Without graphs (the CPU) only the micro-wave runs. A
        speculative or lookup engine skips the micro-wave, as in JAX.
        Returns the keys captured, their capture seconds, the graph pool's
        bytes and the seconds taken."""
        if self._running:
            raise RuntimeError("warmup() runs before start()")
        if not self._queue.empty() or any(s.state != SlotState.IDLE for s in self.slots):
            raise RuntimeError("warmup() needs an idle engine")
        t0 = time.perf_counter()
        keys: list = []
        with self._step_lock:
            if self._graphs is not None:
                if self.device.type == "cuda":    # one nvcc a source, all at once
                    _build.build_all(KERNEL_SOURCES
                                     + (SSM_SOURCES if self.kind != "dense" else ()))
                for key, fn, warm, kind in self._graph_targets():
                    if key not in self._graphs.graphs:
                        self._graphs.capture(key, fn, warm, kind)
                        keys.append(key)
            if self.n_slots >= 2 and not self._variant:    # as the JAX engine
                t_wave = time.perf_counter()
                metrics = dict(self.metrics)
                reqs = [self.submit(GenRequest(prompt_ids=[1, 2], max_tokens=2,
                                               stop_eog=False)) for _ in range(2)]
                self.run_until_drained()
                for r in reqs:
                    r.result()
                for s in [s for s in self.slots if s.t_start >= t_wave]:
                    self.slot_erase(s.idx)
                self.metrics.clear()
                self.metrics.update(metrics)
        return {"keys": keys,
                "capture_s": [self._graphs.capture_s[k] for k in keys] if keys else [],
                "pool_bytes": self._graphs.pool_bytes() if self._graphs is not None else 0,
                "seconds": time.perf_counter() - t0}

    def _graph_targets(self) -> list:
        """(key, fn, warm, kind) of every graph the engine can reach: a
        dense speculative or lookup engine takes no block, and a speculative
        one starts its prompts at one row only."""
        out = []
        if self.kind != "dense":   # greedy one-step blocks; pow2 chunks in place
            return [self._block_graph(1, None, True)] + [
                self._chunk_graph(self.n_slots, P, main=True) for P in self._pow2_chunks()]
        if self.block_size > 1 and (self.paged or not self._variant):
            wins = [None] if self.paged else self._windows()
            out += [self._block_graph(self.block_size, win, greedy)
                    for win in wins for greedy in (True, False)]
        if self.paged:
            Ps = sorted({min(b, self.page_size) for b in self.buckets})
        else:
            Ps = list(self.buckets)
        if self.iswa:     # every prompt in place: (n_slots, P) on the big cache
            return out + [self._chunk_graph(self.n_slots, P, main=True) for P in Ps]
        one_row = self.paged or self.n_slots < 2 or self.draft_model is not None
        rows = (1,) if one_row else (1, self.n_slots)
        out += [self._chunk_graph(r, P) for r in rows for P in Ps]
        if not self.paged and self.n_slots == 1:    # a reused prefix's rest, in place
            out += [self._chunk_graph(1, P, main=True) for P in Ps]
        return out

    def _pow2_chunks(self) -> list[int]:
        """Every chunk width ``pow2_chunk`` can return: the powers of 2 up to
        the largest bucket."""
        out, p = [], 1
        while p <= self.buckets[-1]:
            out.append(p)
            p *= 2
        return out

    def _windows(self) -> list:
        """Every slot window ``_s_bucket`` can return: the powers of 2 from
        256 below n_ctx, then None (the full cache); None alone on an iSWA
        cache, whose tiers are read whole, and on a recurrent or hybrid one,
        whose forwards read the whole cache."""
        if self.iswa or self.kind != "dense":
            return [None]
        wins, w = [], 256
        while w < self.n_ctx:
            wins.append(w)
            w *= 2
        return wins + [None]

    # ------------------------------------------------- slot state

    def _idle_slot(self, idx: int) -> _Slot:
        s = self.slots[idx]
        if s.state != SlotState.IDLE:
            raise RuntimeError(f"slot {idx} is busy")
        return s

    def slot_save(self, idx: int) -> dict:
        """Snapshot an idle slot's cache row and token history (the JAX
        engine's ``slot_save``, llama_state_seq_get_data): ``k`` and ``v``
        (n_layer, H_kv, S, D), ``pos`` (S,), ``n_past``, ``cache_tokens``,
        and on a Q8_0 / Q4_0 cache ``k_scale`` and ``v_scale`` too (the JAX
        snapshot omits them). A float cache's K/V are saved as f32 (numpy
        has no bfloat16; the values are exact), so either package loads the
        file. On an iSWA, recurrent or hybrid cache the row's state is
        ``cache_policy.get_row``'s, flattened to ``full_k``, ``swa_pos``,
        ``conv``, ``attn_k``, ``rec_ssm``, ... (``np.savez`` takes no nested
        dict), beside ``n_past`` and ``cache_tokens``. A paged cache raises
        ``NotImplementedError``, as in JAX."""
        with self._step_lock:
            s = self._idle_slot(idx)
            if self.paged:
                raise NotImplementedError("slot save/restore needs a non-paged cache")
            self._flush_pending()
            if self.iswa or self.kind != "dense":
                out = {}
                for part, v in get_row(self.cache, idx).items():
                    if isinstance(v, dict):
                        out.update({f"{part}_{name}": a for name, a in v.items()})
                    else:
                        out[part] = v
                return {**out, "n_past": s.n_past,
                        "cache_tokens": np.asarray(s.cache_tokens, np.int32)}
            c, S = self.cache, self.cache.max_seq

            def host(t: torch.Tensor) -> np.ndarray:
                """A copy of the row's first S cells: a CPU tensor's numpy
                view would follow later writes to the cache."""
                t = t[..., :S] if t.ndim == 3 else t[:, :, :S]
                dtype = torch.float32 if t.is_floating_point() else t.dtype
                return t.to("cpu", dtype, copy=True).numpy()

            out = {"k": host(c.k[:, idx]), "v": host(c.v[:, idx]),
                   "pos": c.pos[idx, :S].to("cpu", copy=True).numpy(), "n_past": s.n_past,
                   "cache_tokens": np.asarray(s.cache_tokens, np.int32)}
            if c.quantized:
                out["k_scale"] = host(c.k_scale[:, idx])
                out["v_scale"] = host(c.v_scale[:, idx])
            return out

    def slot_restore(self, idx: int, data: dict) -> int:
        """Load a ``slot_save`` snapshot (or the JAX engine's) into an idle
        slot's row, in place: the row's spare cell comes back empty. A
        quantized cache needs the snapshot's scales (``ValueError``
        without them). Returns the count of tokens restored."""
        with self._step_lock:
            s = self._idle_slot(idx)
            if self.paged:
                raise NotImplementedError("slot save/restore needs a non-paged cache")
            if self.iswa or self.kind != "dense":
                return self._state_restore(s, data)
            if any(k in data for k in ("swa_pos", "state", "conv", "rec_ssm")):
                raise ValueError("an iSWA, recurrent or hybrid snapshot restores only into "
                                 "an engine of its kind")
            c, S = self.cache, self.cache.max_seq
            parts = [("k", c.k), ("v", c.v)]
            if c.quantized:
                if "k_scale" not in data or "v_scale" not in data:
                    raise ValueError("a quantized cache restores only a snapshot "
                                     "with its scales (k_scale, v_scale)")
                parts += [("k_scale", c.k_scale), ("v_scale", c.v_scale)]
            rows = {}
            for name, t in parts:
                a = torch.as_tensor(np.asarray(data[name]))
                want = tuple(t[:, idx, :, :S].shape)
                if tuple(a.shape) != want:
                    raise ValueError(f"snapshot {name} has shape {tuple(a.shape)}, "
                                     f"the cache row {want}")
                rows[name] = a
            pos = torch.as_tensor(np.asarray(data["pos"]).astype(np.int32))
            if tuple(pos.shape) != (S,):
                raise ValueError(f"snapshot pos has shape {tuple(pos.shape)}, want ({S},)")
            self._flush_pending()
            for name, t in parts:
                t[:, idx, :, :S].copy_(rows[name].to(t.dtype))
                t[:, idx, :, S:].zero_()
            c.pos[idx, :S].copy_(pos)
            c.pos[idx, S:].fill_(-1)
            n_past = int(data["n_past"])
            c.cursor[idx].fill_(n_past)
            s.n_past = n_past
            s.cache_tokens = [int(t) for t in np.asarray(data["cache_tokens"])]
            return len(s.cache_tokens)

    def _state_restore(self, s: _Slot, data: dict) -> int:
        """``slot_restore`` on an iSWA, recurrent or hybrid cache: a
        flattened ``slot_save`` snapshot, or the JAX engine's ({"state":
        get_row's blob}), loaded through ``cache_policy.set_row`` (which
        refuses a state of another shape or kind)."""
        parts = {"hybrid": ("attn", "rec")}.get(self.kind, ("full", "swa"))
        if "state" in data:
            blob = data["state"]
        elif self.kind == "recurrent":
            blob = {k: v for k, v in data.items() if k not in ("n_past", "cache_tokens")}
        else:
            blob = {part: {k[len(part) + 1:]: v for k, v in data.items()
                           if k.startswith(part + "_")} for part in parts}
        if self.iswa and (not blob.get("swa") or "pos" not in blob["swa"]):
            raise ValueError("an iSWA engine restores only an iSWA snapshot")
        self._flush_pending()
        set_row(self.cache, s.idx, blob)
        s.n_past = int(data["n_past"])
        s.cache_tokens = [int(t) for t in np.asarray(data["cache_tokens"])]
        return len(s.cache_tokens)

    def slot_erase(self, idx: int) -> None:
        """Empty an idle slot: a fresh slot record, an empty cache row (both
        tiers' on an iSWA cache; no pages on a paged cache), written in
        place."""
        with self._step_lock:
            self._idle_slot(idx)
            self.slots[idx] = _Slot(idx)
            if self.paged:
                self.pkv.free_seq(idx)
                return
            self._flush_pending()
            if self.kind != "dense":     # the recurrent row reset, the KV row emptied
                keep = self._keep_vector()
                keep[idx] = 0
                self._truncate(keep)
                return
            for tier in ((self.cache.full, self.cache.swa) if self.iswa else (self.cache,)):
                tier.pos[idx].fill_(-1)
                tier.cursor[idx].fill_(0)

    # ----------------------------------------------------------- engine loop

    def _loop(self):
        while self._running:
            self._run_calls()
            try:
                busy = self.step()
            except Exception as e:  # noqa: BLE001 — fail the requests, keep serving
                self._fail_all(f"engine step failed: {e!r}")
                busy = False
            if not busy:
                time.sleep(0.002)

    def _fail_all(self, msg: str) -> None:
        for s in self.slots:
            if s.req is not None:
                s.req._result["error"] = msg
                s.req._done.set()
                s.cache_tokens = []          # the row's contents are undefined now
            s.state, s.req, s.pending = SlotState.IDLE, None, []
        self._pending_q = []
        if self._scratch_owner is not None:
            self._release_scratch()

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduling iteration: admit waiting requests, advance each
        loading slot by one prompt chunk, then decode the generating slots.
        Returns True if any work was done."""
        with self._step_lock:
            launched = self._launch_waiting()
            with profiler.annotate("engine.prefill"):
                prefilled = self._prefill_step()
            with profiler.annotate("engine.decode"):
                decoded = self._decode_step()
            return launched or prefilled or decoded

    def on_engine_thread(self, fn: Callable[[], object], timeout: float = 60.0):
        """``fn()`` run between two steps on the engine's thread while it
        runs (else here, holding the step lock); returns its result or
        raises its exception. torch.profiler records the CPU spans of the
        thread that starts it, so ``/profile/start`` starts it here."""
        if not self._running or threading.current_thread() is self._thread:
            with self._step_lock:
                return fn()
        box: dict = {"done": threading.Event()}
        self._calls.put((fn, box))
        if not box["done"].wait(timeout):
            raise TimeoutError("the engine thread did not take the call")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _run_calls(self) -> None:
        while True:
            try:
                fn, box = self._calls.get_nowait()
            except queue.Empty:
                return
            try:
                box["result"] = fn()
            except Exception as e:  # noqa: BLE001 — raised in the caller
                box["error"] = e
            box["done"].set()

    def _launch_waiting(self) -> bool:
        launched = False
        while True:
            free = [s for s in self.slots if s.state == SlotState.IDLE]
            if not free or self._queue.empty():
                break
            try:
                _, _, req = self._queue.get_nowait()
            except queue.Empty:
                break
            # the free slot with the longest cached common prefix
            slot = max(free, key=lambda s: self._common_prefix(s.cache_tokens, req.prompt_ids))
            try:
                self._start_request(slot, req)
                launched = True
            except (ValueError, RuntimeError) as e:   # surface to the caller
                req._result["error"] = str(e)
                req._done.set()
                slot.state, slot.req, slot.pending = SlotState.IDLE, None, []
                slot.cache_tokens = []       # the row's contents are undefined now
        return launched

    @staticmethod
    def _common_prefix(a: list[int], b: list[int]) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    def _reusable(self, slot: _Slot, ids: list[int]) -> int:
        """Prompt tokens the slot's cache row already holds: the common
        prefix with its ``cache_tokens``, at most the prompt less one (the
        last token's logits are needed), 0 below 16. On an iSWA cache, 0
        where the ring may no longer hold the prefix's window: positions p
        past the prefix overwrote ring slot p - S_swa, and the old request
        wrote up to n_past less one, its blocks up to block_size x
        pipeline_depth more before they rolled back (the JAX guard counts
        n_past only). A recurrent or hybrid row reuses nothing."""
        if self.kind != "dense":     # a recurrent state cannot rewind to a prefix
            return 0
        n = min(self._common_prefix(slot.cache_tokens, ids), len(ids) - 1)
        if n and self.iswa:
            s_swa = self.cache.swa.max_seq
            ahead = self.block_size * self.pipeline_depth
            if slot.n_past + ahead - n > s_swa - self.hp.swa_window:
                n = 0
        return n if n >= 16 else 0

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """A host int array on the device: token ids as int64, positions
        (and other int32 arrays) as int32."""
        dtype = torch.int64 if arr.dtype == np.int64 else torch.int32
        return torch.as_tensor(arr, dtype=dtype).to(self.device)

    def _forward(self, tokens: np.ndarray, pos: np.ndarray, cache: KVCache,
                 s_window: int | None = None) -> torch.Tensor:
        logits, _ = self._fwd(self.model.params, self.hp, self._dev(tokens), self._dev(pos),
                              cache, s_window=s_window)
        return logits

    def _chunk_width(self, n: int) -> int:
        """The next chunk's width for n pending tokens: a recurrent or hybrid
        row takes a fully valid power of two, anything else its bucket."""
        if self.kind != "dense":
            return pow2_chunk(n, self.buckets[-1])
        return self._bucket(n)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @staticmethod
    def _greedy_cfg(sm: dict | None) -> bool:
        """True iff plain argmax is exact for this sampling config: greedy
        and no sampler stage before Greedy in make_chain (logit bias,
        penalties, DRY at their no-op defaults)."""
        sm = sm or {}
        greedy = (not sm or sm.get("greedy") or sm.get("temp", 1.0) == 0.0)
        return bool(greedy) and not (
            sm.get("logit_bias")
            or sm.get("dry_multiplier", 0.0) > 0
            or sm.get("penalty_repeat", 1.0) != 1.0
            or sm.get("penalty_freq", 0.0) != 0.0
            or sm.get("penalty_present", 0.0) != 0.0)

    @classmethod
    def _greedy_fast(cls, req: GenRequest) -> bool:
        """True iff the request's next token is the argmax of its logits:
        a greedy config (``_greedy_cfg``) without a grammar."""
        return req.grammar is None and cls._greedy_cfg(req.sampling)

    def _vocab_pieces(self) -> tuple[list[bytes], set[int]]:
        """The bytes of every id below n_vocab and the end-of-generation
        ids, for grammar filtering: built at the first grammar request,
        then kept."""
        if self._pieces is None:
            tok = self.model.tokenizer
            if tok is None:
                raise ValueError("a grammar needs the model's tokenizer")
            n = self.hp.n_vocab
            self._pieces = ([tok.token_to_piece(t) for t in range(n)],
                            {t for t in range(n) if tok.vocab.is_eog(t)})
        return self._pieces

    def _keep_vector(self) -> np.ndarray:
        """Rows each slot owns in its cache row: n_past, or the prefilled
        offset of a slot midway through an in-place prefill."""
        keep = np.zeros(self.n_slots, np.int32)
        for s in self.slots:
            keep[s.idx] = (s.prefill_off
                           if s.state == SlotState.PREFILL and s.in_place
                           else s.n_past)
        return keep

    def _make_sampler(self, req: GenRequest) -> SamplerChain:
        """The request's host chain; with a grammar, a ``GrammarSampler``
        after the cutting stages and before the terminal picker, so only the
        surviving candidates take the grammar test (the sampler rescans the
        whole vocab when none of them is legal)."""
        sampler = make_chain(**req.sampling) if req.sampling else make_chain(greedy=True)
        if req.grammar:
            pieces, eos_ids = self._vocab_pieces()
            chain = sampler.samplers
            at = next((i for i, st in enumerate(chain) if hasattr(st, "sample")), len(chain))
            try:
                chain.insert(at, GrammarSampler(req.grammar, pieces, eos_ids,
                                                lazy=req.grammar_lazy,
                                                trigger_patterns=req.grammar_triggers))
            except re.error as e:
                raise ValueError(f"bad grammar trigger: {e}") from e
        return sampler

    def _start_request(self, slot: _Slot, req: GenRequest):
        ids = [int(t) for t in req.prompt_ids]
        if not ids:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self.hp.n_vocab for t in ids):
            raise ValueError(f"prompt token ids must lie in [0, {self.hp.n_vocab})")
        if not self.ctx_shift and len(ids) + req.max_tokens > self.n_ctx:
            raise ValueError(
                f"prompt ({len(ids)}) + max_tokens ({req.max_tokens}) exceeds "
                f"n_ctx ({self.n_ctx})")
        if len(ids) + 1 > self.n_ctx:
            raise ValueError(f"prompt ({len(ids)}) exceeds n_ctx ({self.n_ctx})")
        sampler = self._make_sampler(req)    # a bad grammar fails before the slot changes
        if not self.paged:
            # the truncate below keeps rows by host counts
            self._flush_pending()
        if self.draft_model is not None:
            return self._start_request_sync(slot, req, ids, sampler)
        n_cached = self._reusable(slot, ids)
        t0 = time.perf_counter()
        if self.paged:
            # keep the cached prefix's pages (the chunks then start
            # mid-page), or give every page back
            if not (n_cached and self.pkv.trim_to_position(slot.idx, n_cached)):
                n_cached = 0
                self.pkv.free_seq(slot.idx)
        elif n_cached or self.iswa or self.kind != "dense":
            # cut the row to the prefix (an iSWA row to 0 without one, a
            # recurrent row reset): fa attends every cell whose position lies
            # at or below the query's, so the older request's cells past it
            # must go before the rest loads in place
            keep = self._keep_vector()
            keep[slot.idx] = n_cached
            self._truncate(keep)
        slot.req = req
        slot.state = SlotState.PREFILL
        slot.n_prompt = len(ids)
        slot.n_past = 0
        slot.generated = []
        slot.text = ""
        slot.t_start = t0
        slot.in_place = self.paged or self.iswa or self.kind != "dense" or bool(n_cached)
        slot.pending = ids[n_cached:]
        slot.prefill_off = n_cached
        slot.prefill_P = self._chunk_width(len(slot.pending))
        if self.paged:
            slot.prefill_P = min(slot.prefill_P, self.page_size)
        slot.cache_tokens = list(ids)
        self.metrics["n_prompt_tokens"] += len(ids)
        self.metrics["n_prompt_cached"] += n_cached
        self._setup_sampler(slot, req, ids, sampler)

    def _setup_sampler(self, slot: _Slot, req: GenRequest, ids: list[int],
                       sampler: SamplerChain) -> None:
        slot.sampler = sampler
        slot.fast = req.grammar is None and dsamp.chain_supported(req.sampling or {})
        slot.seed = int((req.sampling or {}).get("seed", 0))
        slot.n_sampled = 0
        for t in ids[-64:]:
            slot.sampler.ctx.recent_tokens.append(t)

    # ------------------------------------------------- speculative start

    def _start_request_sync(self, slot: _Slot, req: GenRequest, ids: list[int],
                            sampler: SamplerChain) -> None:
        """Whole-prompt synchronous start of a speculative engine (the JAX
        engine's ``_start_request_sync`` / ``_start_request_spec_paged``):
        the target's prompt in chunks of one bucket (dense: on the scratch,
        then copied into the slot's row; paged: on the row view, chunks of
        at most a page), the draft's shadow prefill, then the first token
        from the request's chain."""
        t0 = time.perf_counter()
        n = len(ids)
        slot.req = req
        slot.state = SlotState.GENERATING
        slot.n_past = slot.n_prompt = n
        slot.generated = []
        slot.cache_tokens = list(ids)
        slot.text = ""
        slot.t_start = t0
        slot.in_place, slot.pending, slot.prefill_off = False, [], 0
        self._setup_sampler(slot, req, ids, sampler)
        self.metrics["n_prompt_tokens"] += n
        P = self._bucket(n)
        if self.paged:
            P = min(P, self.page_size)
            self.pkv.free_seq(slot.idx)
            slot.pending, slot.prefill_P = list(ids), P
            while slot.pending:
                finals = self._paged_prefill_chunk(slot)
            logits = finals[0][1]
        else:
            for off in range(0, n, P):
                io = self._run_chunk(1, P, {0: (ids[off:off + P], off)})
            logits = io["logits"][0].clone()
            kv_insert_row(self.cache, self._scratch, slot.idx, n)
            self._release_scratch()
        slot.prefill_off = 0
        self.metrics["prefill_s"] += time.perf_counter() - t0
        self._draft_prefill_prompt(slot, ids, P)
        self._emit(slot, slot.sampler.sample(logits.float().cpu().numpy()))
        if slot.state == SlotState.GENERATING:
            slot.draft_tail = [slot.generated[-1]]

    def _draft_prefill_prompt(self, slot: _Slot, ids: list[int], P: int) -> None:
        """The draft's shadow prefill of the prompt (retokenized into the
        draft vocab when translating), eagerly on the one-row draft scratch
        in chunks of P, then copied into the slot's draft row."""
        dm = self.draft_model
        d_ids = (self.spec_translator.tgt_to_dft(ids)
                 if self.spec_translator is not None else ids)
        dn = len(d_ids)
        sc = self._d_scratch
        for off in range(0, dn, P):
            chunk = d_ids[off:off + P]
            tok = np.zeros((1, P), np.int64)
            pos = np.full((1, P), -1, np.int32)
            tok[0, :len(chunk)] = chunk
            pos[0, :len(chunk)] = np.arange(off, off + len(chunk))
            self._dfwd(dm.params, dm.hparams, self._dev(tok), self._dev(pos), sc)
        kv_insert_row(self.d_cache, sc, slot.idx, dn)
        sc.pos.fill_(-1)
        sc.cursor.zero_()
        slot.d_past = dn

    def _prefill_step(self) -> bool:
        """Advance every loading slot by one prompt chunk."""
        loading = [s for s in self.slots if s.state == SlotState.PREFILL]
        if not loading:
            return False
        # a wave's truncate keeps rows by host counts: land the blocks in
        # flight first
        self._flush_pending()
        t0 = time.perf_counter()
        finals: list[tuple[_Slot, torch.Tensor]] = []   # (slot, its first token's logits)
        if self.paged:
            for slot in loading:
                try:
                    finals += self._paged_prefill_chunk(slot)
                except (ValueError, RuntimeError) as e:  # pool exhausted etc.
                    slot.req._result["error"] = str(e)
                    slot.req._done.set()
                    slot.state, slot.req, slot.pending = SlotState.IDLE, None, []
                    slot.cache_tokens = []
                    self.pkv.free_seq(slot.idx)
            loading = []
        # the scratch's owner must stay on the scratch path: its chunks live
        # only there; a recurrent row never joins a wave (each loads its own
        # fully valid chunks)
        batch = ([] if self.kind != "dense" else
                 [s for s in loading if s.in_place or s.prefill_off == 0])
        if len(batch) >= 2:
            # one (n_slots, P) wave carries every loading prompt's next chunk
            P = max(s.prefill_P for s in batch)
            keep = self._keep_vector()
            for s in batch:
                keep[s.idx] = s.prefill_off
            self._truncate(keep)
            parts = {s.idx: (s.pending[:P], s.prefill_off) for s in batch}
            io = self._run_chunk(self.n_slots, P, parts)
            for s in batch:
                n = len(parts[s.idx][0])
                s.pending = s.pending[n:]
                s.prefill_off += n
                s.in_place = True
                if not s.pending:
                    finals.append((s, io["logits"][s.idx].clone()))
            loading = [s for s in loading if s not in batch]
        for slot in loading:
            if not slot.in_place:
                if self._scratch_owner is None:
                    self._scratch_owner = slot
                elif self._scratch_owner is not slot:
                    continue       # the scratch is busy: wait, or join a later wave
            P = slot.prefill_P
            chunk = slot.pending[:P]
            row = slot.idx if slot.in_place else 0
            io = self._run_chunk(self.n_slots if slot.in_place else 1, P,
                                 {row: (chunk, slot.prefill_off)}, main=slot.in_place)
            slot.pending = slot.pending[len(chunk):]
            slot.prefill_off += len(chunk)
            if slot.pending and self.kind != "dense":
                slot.prefill_P = self._chunk_width(len(slot.pending))
            if not slot.pending:
                finals.append((slot, io["logits"][row].clone()))
                if not slot.in_place:
                    kv_insert_row(self.cache, self._scratch, slot.idx, slot.n_prompt)
                    self._release_scratch()
        self.metrics["prefill_s"] += time.perf_counter() - t0
        for slot, logits in finals:
            slot.state = SlotState.GENERATING
            slot.n_past = slot.n_prompt
            if self._greedy_fast(slot.req):
                tok1 = int(torch.argmax(logits))
                slot.sampler.accept(tok1)
            else:
                tok1 = slot.sampler.sample(logits.cpu().numpy())
            self._emit(slot, tok1)
        return True

    def _release_scratch(self) -> None:
        """Empty the scratch (positions -1, cursor 0) for the next lone prompt."""
        self._scratch.pos.fill_(-1)
        self._scratch.cursor.zero_()
        self._scratch_owner = None

    # ------------------------------------------------------ prompt chunks

    def _chunk(self, cache, io: dict) -> None:
        """One prompt chunk, the JAX engine's jitted ``prefill`` (or a chunk
        through ``_decode``): the forward of io's (rows, P) tokens at their
        positions (pos -1: padding, masked and not counted), every
        position's logits, then each row's logits at its column ``last``
        into io's (rows, V) f32 output. The head runs at every position, so
        its matmul takes the route of rows x P (a one-row head would take
        the int8-activation GEMV, and the first token's logits would no
        longer be the reference's). Only tensor ops without a host sync: a
        CUDA graph captures it."""
        logits, _ = self._fwd(self.model.params, self.hp, io["tok"], io["pos"], cache)
        rows = torch.arange(logits.shape[0], device=logits.device)
        io["logits"].copy_(logits[rows, io["last"]])

    def _chunk_io(self, rows: int, P: int) -> tuple[dict, dict]:
        """The static inputs and output of a (rows, P) chunk, and the warm
        runs' own set (every row idle), allocated at first use."""
        bufs = self._chunk_bufs.get((rows, P))
        if bufs is None:
            def new() -> dict:
                dev = self.device
                return {"tok": torch.zeros((rows, P), dtype=torch.int64, device=dev),
                        "pos": torch.full((rows, P), -1, dtype=torch.int32, device=dev),
                        "last": torch.zeros((rows,), dtype=torch.int64, device=dev),
                        "logits": torch.zeros((rows, self.hp.n_vocab), dtype=torch.float32,
                                              device=dev)}
            bufs = self._chunk_bufs[(rows, P)] = (new(), new())
        return bufs

    def _chunk_graph(self, rows: int, P: int, main: bool | None = None) -> tuple:
        """(key, fn, warm, "chunk") of a (rows, P) chunk: a paged chunk on
        the one-row view (warm: the empty-table view); a dense one on the
        big cache when ``main`` (default: rows > 1, a wave or an in-place
        chunk), else on the scratch. Only an engine of one slot has both at
        one row: the big cache's key then ends in "main"."""
        io, idle = self._chunk_io(rows, P)
        key = ("chunk", self._cache_label(), rows, P)
        if self.paged:
            cache, warm_cache = self._pview, self._pview_idle
        else:
            main = rows > 1 if main is None else main
            cache = warm_cache = self.cache if main else self._scratch
            if main and rows == 1:
                key += ("main",)
        return (key, lambda: self._chunk(cache, io), lambda: self._chunk(warm_cache, idle),
                "chunk")

    def _run_chunk(self, rows: int, P: int, parts: dict[int, tuple[list[int], int]],
                   main: bool | None = None) -> dict:
        """Stage ``parts`` (row -> (tokens, first position)) into the static
        inputs of a (rows, P) chunk by pinned non-blocking copies, then run
        it (``main``: as in ``_chunk_graph``): a graph replay on CUDA
        (captured first if its key is new), eager without graphs. Returns
        its static io."""
        tok = np.zeros((rows, P), np.int64)
        pos = np.full((rows, P), -1, np.int32)
        last = np.zeros(rows, np.int64)
        for r, (chunk, off) in parts.items():
            tok[r, : len(chunk)] = chunk
            pos[r, : len(chunk)] = np.arange(off, off + len(chunk))
            last[r] = len(chunk) - 1
        key, fn, warm, kind = self._chunk_graph(rows, P, main)
        io = self._chunk_io(rows, P)[0]
        for name, arr in (("tok", tok), ("pos", pos), ("last", last)):
            self._h2d(io[name], arr)
        if self._graphs is None:
            fn()
        else:
            self._graphs.run(key, fn, warm, kind)
        self.stats["chunks"] += 1
        return io

    def _s_bucket(self, need: int) -> int | None:
        """Decode-length bucket: smallest power-of-2 slot window ≥ need
        (min 256); None = the full cache."""
        return next((w for w in self._windows()[:-1] if w >= need), None)

    def _decode_step(self) -> bool:
        """Decode the generating slots, routed as the JAX engine routes
        them: a context shift first where a slot is about to pass n_ctx;
        then a speculative round, a lookup round (when some slot has a
        draft) while K+1 more cells fit every slot; else a device block when
        every slot's sampler fits the device chain and the context allows
        (a dense speculative or lookup engine never takes one); else one
        host-sampled step."""
        generating = lambda: [s for s in self.slots if s.state == SlotState.GENERATING]
        if not generating():
            return False
        t0 = time.perf_counter()
        if self.ctx_shift:
            self._maybe_context_shift()
        active = generating()
        nb = self.block_size
        if self.kind != "dense":     # one-step blocks for greedy slots only
            fast = lambda: all(self._greedy_fast(s.req) for s in active)
        else:
            fast = lambda: nb > 1 and all(s.fast for s in active)
        fits = lambda k: all(s.n_past + k + 1 <= self.n_ctx for s in active)
        block = not self.paged and not self._variant and fast() and fits(2 * nb)
        if self._pending_q and not block:
            # land the blocks in flight before another kind of step: they may
            # end some slots
            self._flush_pending()
            active = generating()
            if not active:
                return True
        if self.draft_model is not None and fits(self.n_draft):
            if self.spec_translator is not None:
                self._spec_translate_step(active)
            else:
                self._spec_decode_step(active)
        elif self.lookup_k and fits(self.lookup_k) and self._lookup_decode_step(active):
            pass
        elif self.paged:
            if fast() and fits(nb):
                self._paged_block_decode_step(active)
            else:
                self._paged_decode_step(active)
            self.metrics["paged"] = dict(self.pkv.stats)
        elif block:
            self._block_decode_step(active)
        else:
            self._host_decode_step(active)
        self.metrics["decode_s"] += time.perf_counter() - t0
        self.metrics["n_decode_steps"] += 1
        return True

    # ------------------------------------------------- speculative decoding

    @torch.no_grad()
    def _d_rollout(self, tail: torch.Tensor, dpos: torch.Tensor, tail_len: torch.Tensor,
                   base_pos: torch.Tensor) -> torch.Tensor:
        """The whole greedy draft rollout as one function over tensors (the
        JAX engine's ``d_rollout``): the draft catches up on each row's
        (B, W) tail at dpos (-1: padding; a row whose first column is -1 is
        idle), its argmax after the tail's last token is draft 0, then K-1
        single-token steps at base_pos + k, each fed the argmax before it.
        Returns the (B, K) drafts on the device; no host read inside."""
        dm, dc = self.draft_model, self.d_cache
        logits, _ = self._dfwd(dm.params, dm.hparams, tail, dpos, dc)
        nxt = torch.argmax(logits, dim=-1)
        tok = torch.gather(nxt, 1, (tail_len.to(torch.int64) - 1)[:, None])[:, 0]
        live = dpos[:, 0] >= 0
        drafts = [tok]
        for k in range(1, self.n_draft):
            pos = torch.where(live, base_pos + k, -1).to(torch.int32)[:, None]
            lg, _ = self._dfwd(dm.params, dm.hparams, tok[:, None], pos, dc)
            tok = torch.argmax(lg[:, 0], dim=-1)
            drafts.append(tok)
        return torch.stack(drafts, dim=1)

    def _verify(self, rows: list[_Slot], vtok: np.ndarray, vpos: np.ndarray) -> tuple:
        """One target pass over (B, K+1) tokens at their positions: the
        slots' verify. A paged target plans K+1 cells a row (the rows made
        resident and pinned) and saves each row's cursor for the rollback.
        Returns (logits (B, K+1, V) f32 on the host, saved cursors)."""
        if not self.paged:
            return self._forward(vtok, vpos, self.cache).float().cpu().numpy(), {}
        with self._paged_hold(rows):
            saved = {s.idx: self.pkv.save_cursor(s.idx) for s in rows}
            self.pkv.plan_step({s.idx: vtok.shape[1] for s in rows})
            logits = self._forward(vtok, vpos, self.pkv.cache)
            self.pkv.finish_step()
        return logits.float().cpu().numpy(), saved

    def _accept(self, s: _Slot, vlogits: np.ndarray, drafts: np.ndarray, L: int) -> int:
        """Sample the slot's verify positions from its chain in order,
        emitting each token, while it equals the draft before it (at most L
        drafts) and the slot still generates: the longest agreeing prefix
        plus one token. Returns the drafts accepted."""
        accepted = 0
        for i in range(L + 1):
            t = s.sampler.sample(vlogits[s.idx, i])
            self._emit(s, t)
            if i < L and t == int(drafts[i]) and s.state == SlotState.GENERATING:
                accepted += 1
                continue
            break
        return accepted

    def _verify_tokens(self, rows: list[_Slot], drafts: np.ndarray) -> tuple:
        """(tokens, positions) (B, K+1) of the verify: each row's last
        token then its K drafts, at n_past on; idle rows at -1."""
        B, K1 = self.n_slots, drafts.shape[1] + 1
        vtok = np.zeros((B, K1), np.int64)
        vpos = np.full((B, K1), -1, np.int32)
        for s in rows:
            vtok[s.idx, 0] = s.generated[-1]
            vtok[s.idx, 1:] = drafts[s.idx]
            vpos[s.idx] = s.n_past + np.arange(K1)
        return vtok, vpos

    def _verify_and_commit(self, active: list[_Slot], drafts: np.ndarray,
                           lens: np.ndarray) -> dict[int, int]:
        """The batched verify of each slot's last token and its lens[idx]
        drafts, accepted per slot (``_accept``), the spec counters, then
        the target rolls back to each slot's new n_past (a paged row to
        its saved cursor). Returns each slot's count of tokens emitted."""
        vtok, vpos = self._verify_tokens(active, drafts)
        vlogits, saved = self._verify(active, vtok, vpos)
        keep_t = self._keep_vector()
        emitted = {}
        for s in active:
            L = int(lens[s.idx])
            accepted = self._accept(s, vlogits, drafts[s.idx], L)
            self.metrics["n_spec_drafted"] += L
            self.metrics["n_spec_accepted"] += accepted
            n = emitted[s.idx] = accepted + 1
            s.n_past += n
            s.cache_tokens.extend(int(x) for x in vtok[s.idx, :n])
            keep_t[s.idx] = s.n_past
            if self.paged:
                self.pkv.rollback(s.idx, saved[s.idx], n, vtok.shape[1])
        if not self.paged:
            self._truncate(keep_t)
        return emitted

    def _spec_decode_step(self, active: list[_Slot]) -> None:
        """One speculative round for every generating slot (the JAX
        engine's ``_spec_decode_step``): the draft rollout over each row's
        1-2 unseen tokens, the batched verify, accept per slot, then both
        caches roll back: the target to n_past, the draft to the cells it
        was fed that the target kept."""
        K, B = self.n_draft, self.n_slots
        tok = np.zeros((B, 2), np.int64)
        dpos = np.full((B, 2), -1, np.int32)
        tlen = np.ones(B, np.int32)
        bpos = np.zeros(B, np.int32)
        for s in active:
            tail = s.draft_tail[:2]
            tok[s.idx, :len(tail)] = tail
            dpos[s.idx, :len(tail)] = s.d_past + np.arange(len(tail))
            tlen[s.idx] = len(tail)
            bpos[s.idx] = s.d_past + len(tail) - 1
        drafts = self._d_rollout(self._dev(tok), self._dev(dpos), self._dev(tlen),
                                 self._dev(bpos)).cpu().numpy()
        for s in active:
            s.d_past += len(s.draft_tail[:2]) + K - 1
        self._verify_and_commit(active, drafts, np.full(B, K, np.int32))
        keep_d = np.asarray([s.d_past for s in self.slots], np.int32)
        for s in active:
            keep_d[s.idx] = s.d_past = min(s.n_past, s.d_past)
            if s.state == SlotState.GENERATING:
                # the tokens the draft has not been fed (1 or 2)
                s.draft_tail = s.generated[s.d_past - s.n_prompt:s.n_past + 1 - s.n_prompt]
        self._truncate(keep_d, self.d_cache)

    def _spec_translate_step(self, active: list[_Slot]) -> None:
        """A speculative round through the vocab translator (the JAX
        engine's ``_spec_translate_step``, common/speculative.cpp:200-222,
        351-359): each slot's unseen target tokens are retokenized into the
        draft vocab and committed to the draft cache (a bucketed width W),
        the K draft tokens go back through text to target ids (any count up
        to K) for the batched verify; the draft cache keeps only the
        committed tails."""
        K, B = self.n_draft, self.n_slots
        tr = self.spec_translator
        tails = {s.idx: tr.tgt_to_dft(s.draft_tail) for s in active}
        live = [s for s in active if tails[s.idx]]
        drafts = np.zeros((B, K), np.int64)
        lens = np.zeros(B, np.int32)
        if live:
            W = 2
            while W < max(len(tails[s.idx]) for s in live):
                W *= 2
            tok = np.zeros((B, W), np.int64)
            dpos = np.full((B, W), -1, np.int32)
            tlen = np.ones(B, np.int32)
            bpos = np.zeros(B, np.int32)
            for s in live:
                tl = tails[s.idx][:W]
                tok[s.idx, :len(tl)] = tl
                dpos[s.idx, :len(tl)] = s.d_past + np.arange(len(tl))
                tlen[s.idx] = len(tl)
                bpos[s.idx] = s.d_past + len(tl) - 1
            dd = self._d_rollout(self._dev(tok), self._dev(dpos), self._dev(tlen),
                                 self._dev(bpos)).cpu().numpy()
            for s in live:
                s.d_past += len(tails[s.idx][:W])     # committed; the drafts roll back
                s.draft_tail = []
                tgt = tr.dft_to_tgt([int(x) for x in dd[s.idx]])[:K]
                lens[s.idx] = len(tgt)
                drafts[s.idx, :len(tgt)] = tgt
        keep_d = np.asarray([s.d_past for s in self.slots], np.int32)
        emitted = self._verify_and_commit(active, drafts, lens)
        for s in active:
            if s.state == SlotState.GENERATING:
                s.draft_tail = s.draft_tail + s.generated[-emitted[s.idx]:]
        self._truncate(keep_d, self.d_cache)

    def _lookup_decode_step(self, active: list[_Slot]) -> bool:
        """One lookup round (the JAX engine's ``_lookup_decode_step``):
        n-gram drafts per slot (up to K, maybe none) from the slot's
        ``NgramCache``, grown from its high-water mark, then the batched
        verify and accept. Returns False, untouched, when no slot has a
        draft."""
        K, B = self.lookup_k, self.n_slots
        drafts = np.zeros((B, K), np.int64)
        lens = np.zeros(B, np.int32)
        for s in active:
            seq = s.cache_tokens + s.generated[-1:]
            ng = self._ngrams.get(s.idx)
            hwm = self._ngram_hwm.get(s.idx, 0)
            if ng is None or hwm > len(seq):
                ng = self._ngrams[s.idx] = NgramCache()
                hwm = 0
            if len(seq) > hwm:
                ng.extend(seq[max(hwm - ng.n_max, 0):hwm], seq[hwm:])
                self._ngram_hwm[s.idx] = len(seq)
            d = ng.draft(seq, K)
            lens[s.idx] = len(d)
            drafts[s.idx, :len(d)] = d
        if not lens.any():
            return False
        self._verify_and_commit(active, drafts, lens)
        return True

    # ------------------------------------------------------ context shift

    def _shift_plan(self, s: _Slot) -> tuple[int, int]:
        """(n_keep, n_discard) of a slot's shift: keep min(n_prompt,
        n_ctx // 4) cells, drop half of the rest (at least one)."""
        n_keep = min(s.n_prompt, self.n_ctx // 4)
        return n_keep, max((s.n_past - n_keep) // 2, 1)

    def _maybe_context_shift(self) -> None:
        """Shift every generating slot about to pass n_ctx (the JAX
        engine's ``_maybe_context_shift`` and ``_maybe_paged_context_shift``):
        evict the oldest half after its kept cells, re-rope and compact, in
        the cache's own storage; a paged chain is exported to a dense row,
        shifted there and imported back. Blocks in flight land first."""
        hit = lambda: [s for s in self.slots if s.state == SlotState.GENERATING
                       and s.n_past + 1 > self.n_ctx - 1]
        if not hit():
            return
        self._flush_pending()
        plans = [(s, *self._shift_plan(s)) for s in hit()]
        if self.paged:
            for s, n_keep, n_discard in plans:
                self._paged_shift(s, n_keep, n_discard)
        else:
            keep = np.zeros(self.n_slots, np.int32)
            discard = np.zeros(self.n_slots, np.int32)
            for s, n_keep, n_discard in plans:
                keep[s.idx], discard[s.idx] = n_keep, n_discard
            inv_freq, mscale = self._rope
            kv_context_shift(self.cache, self._dev(keep), self._dev(discard), inv_freq,
                             self.hp.rope_type, mscale)
        for s, n_keep, n_discard in plans:
            s.n_past -= n_discard
            s.cache_tokens = s.cache_tokens[:n_keep] + s.cache_tokens[n_keep + n_discard:]
            self.metrics["n_ctx_shifts"] += 1

    def _paged_shift(self, s: _Slot, n_keep: int, n_discard: int) -> None:
        """A paged slot's shift: its chain's cells as one dense row of n_ctx
        cells, shifted there, and the row's valid cells imported back as a
        new chain. The gap cells of closed pages are left out: the JAX
        engine keeps them in the row (at position -1), which its compaction
        then drops, but a chain with gaps may hold more than n_ctx cells."""
        k, v, pos = self.pkv.export_row(s.idx)
        cells = pos >= 0
        k, v, pos = k[:, :, cells], v[:, :, cells], pos[cells]
        n = int(pos.shape[0])
        row = self._new_cache(1)
        row.k[:, 0, :, :n] = k.to(row.k.device)
        row.v[:, 0, :, :n] = v.to(row.v.device)
        row.pos[0, :n] = pos.to(row.pos.device)
        row.cursor.fill_(n)
        inv_freq, mscale = self._rope
        kv_context_shift(row, torch.tensor([n_keep]), torch.tensor([n_discard]), inv_freq,
                         self.hp.rope_type, mscale)
        n_new = int(row.cursor[0])
        self.pkv.import_row(s.idx, row.k[:, 0, :, :n_new], row.v[:, 0, :, :n_new],
                            row.pos[0, :n_new])

    def _host_decode_step(self, active: list[_Slot]) -> None:
        """One host-sampled decode token for every generating slot."""
        tokens = np.zeros((self.n_slots, 1), np.int64)
        pos = np.full((self.n_slots, 1), -1, np.int32)
        for s in active:
            tokens[s.idx, 0] = s.generated[-1]
            pos[s.idx, 0] = s.n_past
        logits = self._forward(tokens, pos, self.cache, s_window=self._s_bucket(
            max(s.n_past for s in active) + 2))
        logits_np = logits[:, 0].float().cpu().numpy()
        for s in active:
            s.n_past += 1
            s.cache_tokens.append(s.generated[-1])     # the fed token entered the cache
            self._emit(s, s.sampler.sample(logits_np[s.idx]))

    # ----------------------------------------------------- device blocks

    def _block(self, cache, io: dict, n_steps: int, win: int | None, greedy: bool) -> None:
        """One decode block, the JAX engine's ``decode_block``: n_steps
        forward + sample steps from io's inputs, written into io's outputs
        (the tokens, the last token and position, the ring, the counts
        advanced by n_steps). Rows with pos < 0 ride along unchanged. Only
        tensor ops without a host sync: a CUDA graph captures it."""
        tok, pos, ring = io["tok"], io["pos"], io["ring"]
        live = pos[:, 0] >= 0
        if not greedy:
            u_xtc, u_gumbel = dsamp.chain_noise(io["keys"], io["counts"], n_steps)
        steps = []
        for i in range(n_steps):
            logits, _ = self._fwd(self.model.params, self.hp, tok, pos, cache,
                                  s_window=win)
            if greedy:
                nxt = torch.argmax(logits[:, -1], dim=-1)
            else:
                nxt, ring = dsamp.chain_step_core(logits[:, -1].to(torch.float32), ring,
                                                  self._sp, u_xtc[:, i], u_gumbel[:, i])
            nxt = torch.where(live, nxt, tok[:, 0])
            pos = torch.where(live[:, None], pos + 1, pos)
            tok = nxt[:, None]
            steps.append(nxt)
        io["toks"][n_steps].copy_(torch.stack(steps, dim=1))
        io["tok_l"].copy_(tok)
        io["pos_l"].copy_(pos)
        io["ring_l"].copy_(ring)
        io["counts_l"].copy_(io["counts"] + n_steps)

    def _h2d(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """Host array into a static device tensor, asynchronously from
        pinned memory on a CUDA device."""
        src = torch.from_numpy(np.ascontiguousarray(arr)).to(dst.dtype)
        if dst.is_cuda:
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _stage_block(self, rows: list[_Slot]) -> bool:
        """Write the rows' block inputs (last token, position, recent-token
        ring, seed key, sampled count) into the static inputs, and the
        chain's parameters when the request set changed. Returns whether
        every row is greedy (the argmax block)."""
        B = self.n_slots
        tok0 = np.zeros((B, 1), np.int64)
        pos0 = np.full((B, 1), -1, np.int32)
        ring = np.full((B, dsamp.RING), -1, np.int64)
        keys = np.zeros((B, 2), np.int64)
        counts = np.zeros(B, np.int64)
        cfgs: list[dict | None] = [None] * B
        for s in rows:
            tok0[s.idx, 0] = s.generated[-1]
            pos0[s.idx, 0] = s.n_past
            recent = s.sampler.ctx.recent_tokens[-dsamp.RING:]
            if recent:
                ring[s.idx, -len(recent):] = recent
            keys[s.idx] = ((s.seed >> 32) & 0xFFFFFFFF, s.seed & 0xFFFFFFFF)
            counts[s.idx] = s.n_sampled
            cfgs[s.idx] = s.req.sampling or {"greedy": True}
        for name, arr in (("tok", tok0), ("pos", pos0), ("ring", ring), ("keys", keys),
                          ("counts", counts)):
            self._h2d(self._io[name], arr)
        sp_key = tuple((s.idx, s.req.request_id) for s in rows)
        if sp_key != self._sp_key:     # the parameters change with the request set
            for name, arr in dsamp.chain_params(cfgs, self.hp.n_vocab).items():
                self._h2d(self._sp[name], arr)
            self._sp_key = sp_key
        return all(c is None or self._greedy_cfg(c) for c in cfgs)

    def _block_graph(self, nb: int, win: int | None, greedy: bool) -> tuple:
        """(key, fn, warm, "block") of a decode block of nb steps; warm runs
        it with every row idle."""
        cache = self.pkv.cache if self.paged else self.cache
        if nb not in self._io["toks"]:
            for io in (self._io, self._idle_io):
                io["toks"][nb] = torch.zeros((self.n_slots, nb), dtype=torch.int64,
                                             device=self.device)
        return ((self._cache_label(), nb, win, greedy),
                lambda: self._block(cache, self._io, nb, win, greedy),
                lambda: self._block(cache, self._idle_io, nb, win, greedy), "block")

    def _run_block(self, ids: tuple, win: int | None, greedy: bool) -> dict:
        """Run one block on the static inputs (a graph replay on CUDA, eager
        on the CPU) and start the copy of its tokens to the host."""
        nb = self.block_size
        key, fn, warm, kind = self._block_graph(nb, win, greedy)
        if self._graphs is None:
            fn()
        else:
            self._graphs.run(key, fn, warm, kind)
        self.stats["blocks"] += 1
        toks, event = self._io["toks"][nb], None
        if toks.is_cuda:
            # ordered before the next block overwrites the graph's output
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = toks.clone()
        return {"ids": ids, "toks": host, "event": event, "win": win, "greedy": greedy}

    @staticmethod
    def _land(pend: dict) -> np.ndarray:
        if pend["event"] is not None:
            pend["event"].synchronize()
        return pend["toks"].numpy()

    def _launch_block(self, active: list[_Slot]) -> dict:
        """Dispatch one block from host-built inputs."""
        greedy = self._stage_block(active)
        win = self._s_bucket(max(s.n_past for s in active) + 2 * self.block_size + 1)
        return self._run_block(tuple(s.idx for s in active), win, greedy)

    def _chain_block(self, pend: dict) -> dict:
        """Dispatch the next block off the previous block's outputs, copied
        into the static inputs on the device: no host round trip."""
        io = self._io
        for name in ("tok", "pos", "ring", "counts"):
            io[name].copy_(io[name + "_l"])
        self.stats["chained"] += 1
        return self._run_block(pend["ids"], pend["win"], pend["greedy"])

    def _truncate(self, keep: np.ndarray, cache: KVCache | ISWACache | None = None) -> None:
        """Cut each row of the cache (default: the target's) to its keep
        count, in place (``truncate_rows``: an iSWA cache by position)."""
        keep_t = torch.from_numpy(np.asarray(keep, np.int32))
        if self.device.type == "cuda":
            keep_t = keep_t.pin_memory().to(self.device, non_blocking=True)
        truncate_rows(self.cache if cache is None else cache, keep_t)

    def _consume_block(self, pend: dict, inflight_extra: int = 0) -> None:
        """Read a landed block's tokens, emit them per slot, roll the cache
        back past a stop. ``inflight_extra``: cache rows that blocks still in
        flight have already appended for the surviving slots."""
        nb = self.block_size
        toks = self._land(pend)
        keep = self._keep_vector()
        overshoot = False
        for idx in pend["ids"]:
            s = self.slots[idx]
            if s.req is None or s.state != SlotState.GENERATING:
                overshoot = True             # the slot stopped earlier: discard
                continue
            accepted = self._consume_row(s, toks[idx])
            overshoot |= accepted < nb
            keep[idx] = s.n_past + (inflight_extra if s.state == SlotState.GENERATING else 0)
        if overshoot:
            self._truncate(keep)

    def _flush_pending(self) -> None:
        """Land every block in flight, before a cache mutation that keeps
        rows by host counts (a host-sampled step, a prefill)."""
        q, self._pending_q = self._pending_q, []
        while q:
            pend = q.pop(0)
            self._consume_block(pend, inflight_extra=self.block_size * len(q))

    def _block_decode_step(self, active: list[_Slot]) -> None:
        """Pipelined block decode (the JAX engine's ``_block_decode_step``):
        chain blocks k+1.. off the device-resident outputs before reading
        block k's tokens, so the host's stop checks overlap device work. A
        change of the active set or an outgrown slot window lands the whole
        pipeline; so does a stop, after the surviving slots emit."""
        nb = self.block_size
        q = self._pending_q
        cur_ids = tuple(s.idx for s in active)
        max_past = max(s.n_past for s in active)
        win_ok = all(p["win"] is None or max_past + (len(q) + 1) * nb + 1 <= p["win"]
                     for p in q)
        if q and (q[0]["ids"] != cur_ids or not win_ok):
            self._flush_pending()
            return
        if not q:
            q.append(self._launch_block(active))
        # top up the pipeline while the window covers the extra depth, but
        # never past every slot's max_tokens: such a block would only roll back
        need = max(s.req.max_tokens - len(s.generated) for s in active)
        while len(q) < self.pipeline_depth and need > len(q) * nb:
            last_win = q[-1]["win"]
            if last_win is not None and max_past + (len(q) + 1) * nb + 1 > last_win:
                break
            q.append(self._chain_block(q[-1]))
        pend = q.pop(0)
        self._consume_block(pend, inflight_extra=nb * len(q))
        if any(self.slots[i].state != SlotState.GENERATING for i in pend["ids"]):
            self._flush_pending()

    # ------------------------------------------------------------ paged mode

    @contextmanager
    def _paged_hold(self, slots: list[_Slot]):
        """Make each slot's pages resident and pin them for one step (a later
        slot's restore must not spill an earlier slot's pages)."""
        try:
            for s in slots:
                self.pkv.ensure_resident(s.idx)
                self.pkv.pin(s.idx, True)
            yield
        finally:
            for s in slots:
                self.pkv.pin(s.idx, False)

    def _paged_prefill_chunk(self, slot: _Slot) -> list:
        """One prompt chunk (≤ page_size tokens) into the slot's page chain,
        a one-row chunk on the pool's row view: the JAX engine's
        (n_slots, P) chunk without the padding rows, which never reach the
        slot's row. Returns the finals entry of a slot whose prompt is
        done."""
        P = slot.prefill_P
        chunk = slot.pending[:P]
        with self._paged_hold([slot]):
            self.pkv.plan_step({slot.idx: len(chunk)})
            self.pkv.load_row(self._pview, slot.idx)
            io = self._run_chunk(1, P, {0: (chunk, slot.prefill_off)})
            self.pkv.finish_step()
        slot.pending = slot.pending[len(chunk):]
        slot.prefill_off += len(chunk)
        return [] if slot.pending else [(slot, io["logits"][0].clone())]

    def _paged_pick(self, active: list[_Slot]) -> list[_Slot]:
        """Swap-scheduling admission: the slots whose page chains fit the
        pool this step, in round-robin order; the rest wait, their pages
        spilling to host as the picked ones allocate."""
        cap = self.pkv.n_pool_pages
        k = self._paged_rr % len(active)
        self._paged_rr += 1
        picked, used = [], 0
        for s in active[k:] + active[:k]:
            need = self.pkv.seq_pages(s.idx) + 1     # +1: a new open page
            if used + need <= cap:
                picked.append(s)
                used += need
        if not picked:
            raise RuntimeError(f"page pool too small for any sequence (cap {cap} pages)")
        return picked

    def _paged_decode_step(self, active: list[_Slot]) -> None:
        """One host-sampled decode token for every picked slot."""
        picked = self._paged_pick(active)
        tokens = np.zeros((self.n_slots, 1), np.int64)
        pos = np.full((self.n_slots, 1), -1, np.int32)
        for s in picked:
            tokens[s.idx, 0] = s.generated[-1]
            pos[s.idx, 0] = s.n_past
        with self._paged_hold(picked):
            self.pkv.plan_step({s.idx: 1 for s in picked})
            logits = self._forward(tokens, pos, self.pkv.cache)
            self.pkv.finish_step()
        logits_np = logits[:, 0].float().cpu().numpy()
        for s in picked:
            s.n_past += 1
            s.cache_tokens.append(s.generated[-1])
            self._emit(s, s.sampler.sample(logits_np[s.idx]))

    def _paged_block_decode_step(self, active: list[_Slot]) -> None:
        """A decode block on the paged cache (not pipelined, as in the JAX
        engine): the block's pages are planned up front (one page per row),
        and a row that stops inside the block rolls back to its accepted
        tokens."""
        picked = self._paged_pick(active)
        nb = self.block_size
        greedy = self._stage_block(picked)
        saved = {s.idx: self.pkv.save_cursor(s.idx) for s in picked}
        with self._paged_hold(picked):
            self.pkv.plan_step({s.idx: nb for s in picked})
            pend = self._run_block(tuple(s.idx for s in picked), None, greedy)
            self.pkv.finish_step()
        toks = self._land(pend)
        for s in picked:
            accepted = self._consume_row(s, toks[s.idx])
            if accepted < nb:
                self.pkv.rollback(s.idx, saved[s.idx], accepted, nb)

    def _consume_row(self, s: _Slot, row: np.ndarray) -> int:
        """Accept a slot's block tokens until it stops; returns the count.
        Each accepted token's step fed the one before it into the cache:
        tokens generated past a stop never enter ``cache_tokens``."""
        accepted = 0
        for t in row:
            s.n_past += 1
            s.cache_tokens.append(s.generated[-1])
            s.sampler.accept(int(t))
            self._emit(s, int(t))
            accepted += 1
            if s.state != SlotState.GENERATING:
                break
        return accepted

    def _emit(self, slot: _Slot, token: int):
        req = slot.req
        slot.generated.append(token)
        slot.n_sampled += 1
        self.metrics["n_tokens_generated"] += 1
        if len(slot.generated) == 1:
            slot.t_first_token = time.perf_counter()
        tok = self.model.tokenizer
        piece = ""
        if tok is not None:
            piece = tok.token_to_piece(token).decode("utf-8", errors="replace")
            slot.text += piece
        if req.stream:
            try:
                req.stream(token, piece)
            except Exception:  # noqa: BLE001 — a dead client must not stop the engine
                pass
        vocab = tok.vocab if tok else None
        eog = req.stop_eog and vocab is not None and vocab.is_eog(token)
        hit_stop = any(ss in slot.text for ss in req.stop_strings)
        done = eog or hit_stop or len(slot.generated) >= req.max_tokens
        if done or (slot.n_past + 1 > self.n_ctx and not self.ctx_shift):
            self._finish(slot, "stop" if (eog or hit_stop) else "length")

    def _finish(self, slot: _Slot, finish_reason: str):
        req = slot.req
        text = slot.text
        for ss in req.stop_strings:
            i = text.find(ss)
            if i >= 0:
                text = text[:i]
        req._result.update({
            "tokens": list(slot.generated),
            "text": text,
            "finish_reason": finish_reason,
            "n_prompt": slot.n_prompt,
            "n_generated": len(slot.generated),
            "ttft_s": slot.t_first_token - slot.t_start,
            "total_s": time.perf_counter() - slot.t_start,
        })
        slot.state = SlotState.IDLE
        slot.req = None
        slot.sampler = None
        req._done.set()
