"""Continuous-batching inference engine over a dense or paged KV cache.

Counterpart of the JAX package's ``runtime/engine.py::Engine`` (the
reference server's update_slots semantics):

 - decode: one (n_slots, 1) forward over all slots; idle slots ride along
   with pos = -1 (masked, cursor not advanced);
 - prefill: prompts load in bucketed chunks (``PREFILL_BUCKETS``), one chunk
   per engine step. A lone prompt prefills into a one-row scratch cache that
   is then copied into its slot's row; two or more prompts load together in
   one (n_slots, P) wave straight into the big cache;
 - sampling: the first token of a request comes from its host
   ``SamplerChain``. When every generating slot's config is expressible by
   the device sampler chain (``ops/device_sampling.py``: all but DRY,
   mirostat, adaptive-p and more than 16 bias entries), a block of
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
 - the dense cache is f32/bf16, or Q8_0 / Q4_0 (``kv_dtype="q8_0"`` /
   ``"q4_0"``);
 - paged mode (``paged=True``): a page pool with host spill
   (``PagedKVManager``). Admission frees the slot's pages; prompts prefill
   one chunk of at most ``page_size`` tokens per step, one slot at a time,
   the other rows riding on the NULL page; decode picks the slots whose
   pages fit the pool (round robin, the rest wait while their pages spill)
   and runs host-sampled steps or (unpipelined) blocks rolled back with
   ``PagedKVManager.rollback``.

Thread model: ``submit`` enqueues; one engine thread (``start``) or the
caller (``run_until_drained``) owns the device. The cache is updated in
place.

Not ported yet: speculative and lookup decoding, context shift,
grammars, prompt-prefix reuse and slot save/restore.
"""

from __future__ import annotations

import queue
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
from .context import check_model_device
from .graphs import GraphCache
from .kv_cache import KVCache, kv_cache_init, kv_insert_row, kv_truncate_rows
from .paged_kv import PagedKVManager, paged_cache_init
from .sampling import SamplerChain, make_chain

PREFILL_BUCKETS = (32, 128, 512, 1024, 2048)


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
    stream: Optional[Callable[[int, str], None]] = None  # (token_id, piece)
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])
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
    # chunked prefill: one chunk per engine step
    pending: list[int] = field(default_factory=list)
    prefill_off: int = 0             # positions already prefilled
    prefill_P: int = 0               # chunk bucket width
    in_place: bool = False           # prefilling straight into the big cache
    scratch: KVCache | None = None   # one-row scratch cache
    # the device sampler chain
    fast: bool = False               # config expressible by the device chain
    seed: int = 0
    n_sampled: int = 0               # tokens emitted: the key stream's position


class Engine:
    """Continuous-batching engine on one device (default CUDA). kv_dtype is a
    float torch dtype, or "q8_0" / "q4_0" for a quantized dense cache.

    ``graphs`` (default: on for a CUDA device) replays decode blocks from
    CUDA graphs; ``graphs=False`` runs them eagerly, the CPU's only way.
    ``pipeline_depth`` is the number of dense-cache blocks in flight."""

    def __init__(self, model: LoadedModel, n_slots: int = 4, n_ctx: int = 2048,
                 kv_dtype: torch.dtype | str = torch.bfloat16,
                 prefill_buckets=PREFILL_BUCKETS, block_size: int = 8,
                 device=None, paged: bool = False, page_size: int = 256,
                 n_pages: int | None = None, max_pages_per_seq: int | None = None,
                 pipeline_depth: int = 2, graphs: bool | None = None):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        self.model = model
        self.hp = model.hparams
        self.n_slots = n_slots
        self.n_ctx = n_ctx
        self.buckets = tuple(b for b in sorted(prefill_buckets) if b <= n_ctx) or (n_ctx,)
        self._fwd = get_forward(self.hp.arch)
        self.kv_dtype = kv_dtype
        self.block_size = max(1, int(block_size))
        self.paged = bool(paged)
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
        else:
            self.cache = self._new_cache(n_slots)
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
        self.pipeline_depth = max(1, int(pipeline_depth))
        if graphs is None:
            graphs = self.device.type == "cuda"
        self._graphs = GraphCache(self.device) if graphs else None
        self.stats = {"blocks": 0, "chained": 0}
        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
        # serializes step() against callers that must see a quiet engine
        self._step_lock = threading.RLock()
        self._running = False
        self._thread: threading.Thread | None = None

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

    def _new_cache(self, batch: int) -> KVCache:
        hp = self.hp
        return kv_cache_init(hp.n_layer, batch, self.n_ctx, hp.n_head_kv,
                             hp.head_dim, hp.head_dim_v, dtype=self.kv_dtype,
                             device=self.device)

    # ----------------------------------------------------------- public API

    def submit(self, req: GenRequest) -> GenRequest:
        self._queue.put(req)
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

    def run_until_drained(self):
        """Synchronous mode: run steps until all work completes."""
        while not self._queue.empty() or any(s.state != SlotState.IDLE for s in self.slots):
            self.step()

    # ----------------------------------------------------------- engine loop

    def _loop(self):
        while self._running:
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
            s.state, s.req, s.pending, s.scratch = SlotState.IDLE, None, [], None
        self._pending_q = []

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduling iteration: admit waiting requests, advance each
        loading slot by one prompt chunk, then decode the generating slots.
        Returns True if any work was done."""
        with self._step_lock:
            launched = self._launch_waiting()
            prefilled = self._prefill_step()
            decoded = self._decode_step()
            return launched or prefilled or decoded

    def _launch_waiting(self) -> bool:
        launched = False
        while True:
            free = [s for s in self.slots if s.state == SlotState.IDLE]
            if not free or self._queue.empty():
                break
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            slot = free[0]
            try:
                self._start_request(slot, req)
                launched = True
            except (ValueError, RuntimeError) as e:   # surface to the caller
                req._result["error"] = str(e)
                req._done.set()
                slot.state, slot.req, slot.pending, slot.scratch = (
                    SlotState.IDLE, None, [], None)
        return launched

    def _forward(self, tokens: np.ndarray, pos: np.ndarray, cache: KVCache,
                 s_window: int | None = None) -> torch.Tensor:
        logits, _ = self._fwd(
            self.model.params, self.hp,
            torch.as_tensor(tokens, dtype=torch.int64).to(self.device),
            torch.as_tensor(pos, dtype=torch.int32).to(self.device), cache,
            s_window=s_window)
        return logits

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

    def _keep_vector(self) -> np.ndarray:
        """Rows each slot owns in its cache row: n_past, or the prefilled
        offset of a slot midway through an in-place prefill."""
        keep = np.zeros(self.n_slots, np.int32)
        for s in self.slots:
            keep[s.idx] = (s.prefill_off
                           if s.state == SlotState.PREFILL and s.in_place
                           else s.n_past)
        return keep

    def _start_request(self, slot: _Slot, req: GenRequest):
        ids = [int(t) for t in req.prompt_ids]
        if not ids:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self.hp.n_vocab for t in ids):
            raise ValueError(f"prompt token ids must lie in [0, {self.hp.n_vocab})")
        if len(ids) + req.max_tokens > self.n_ctx:
            raise ValueError(
                f"prompt ({len(ids)}) + max_tokens ({req.max_tokens}) exceeds "
                f"n_ctx ({self.n_ctx})")
        slot.req = req
        slot.state = SlotState.PREFILL
        slot.n_prompt = len(ids)
        slot.n_past = 0
        slot.generated = []
        slot.text = ""
        slot.t_start = time.perf_counter()
        slot.in_place = False
        slot.pending = ids
        slot.prefill_off = 0
        slot.scratch = None
        slot.prefill_P = self._bucket(len(ids))
        if self.paged:     # no prefix reuse yet: the slot's pages go back
            self.pkv.free_seq(slot.idx)
            slot.in_place = True
            slot.prefill_P = min(slot.prefill_P, self.page_size)
        slot.sampler = make_chain(**req.sampling) if req.sampling else make_chain(greedy=True)
        slot.fast = dsamp.chain_supported(req.sampling or {})
        slot.seed = int((req.sampling or {}).get("seed", 0))
        slot.n_sampled = 0
        for t in ids[-64:]:
            slot.sampler.ctx.recent_tokens.append(t)

    def _prefill_step(self) -> bool:
        """Advance every loading slot by one prompt chunk."""
        loading = [s for s in self.slots if s.state == SlotState.PREFILL]
        if not loading:
            return False
        # a wave's truncate keeps rows by host counts: land the blocks in
        # flight first
        self._flush_pending()
        finals: list[tuple[_Slot, torch.Tensor, int, int]] = []  # (slot, logits, row, col)
        if self.paged:
            for slot in loading:
                try:
                    finals += self._paged_prefill_chunk(slot)
                except (ValueError, RuntimeError) as e:  # pool exhausted etc.
                    slot.req._result["error"] = str(e)
                    slot.req._done.set()
                    slot.state, slot.req, slot.pending = SlotState.IDLE, None, []
                    self.pkv.free_seq(slot.idx)
            loading = []
        # slots midway through a scratch prefill must stay on the scratch
        # path: their chunks live only in slot.scratch
        batch = [s for s in loading if s.in_place or s.prefill_off == 0]
        if len(batch) >= 2:
            # one (n_slots, P) wave carries every loading prompt's next chunk
            P = max(s.prefill_P for s in batch)
            keep = self._keep_vector()
            for s in batch:
                keep[s.idx] = s.prefill_off
            kv_truncate_rows(self.cache, torch.from_numpy(keep))
            tok = np.zeros((self.n_slots, P), np.int64)
            pos = np.full((self.n_slots, P), -1, np.int32)
            for s in batch:
                chunk = s.pending[:P]
                tok[s.idx, : len(chunk)] = chunk
                pos[s.idx, : len(chunk)] = np.arange(s.prefill_off, s.prefill_off + len(chunk))
            logits = self._forward(tok, pos, self.cache)
            for s in batch:
                n = len(s.pending[:P])
                s.pending = s.pending[n:]
                s.prefill_off += n
                s.in_place = True
                if not s.pending:
                    finals.append((s, logits, s.idx, n - 1))
            loading = [s for s in loading if s not in batch]
        for slot in loading:
            P = slot.prefill_P
            chunk = slot.pending[:P]
            if slot.in_place:
                tok = np.zeros((self.n_slots, P), np.int64)
                pos = np.full((self.n_slots, P), -1, np.int32)
                row, cache = slot.idx, self.cache
            else:
                if slot.scratch is None:
                    slot.scratch = self._new_cache(1)
                tok = np.zeros((1, P), np.int64)
                pos = np.full((1, P), -1, np.int32)
                row, cache = 0, slot.scratch
            tok[row, : len(chunk)] = chunk
            pos[row, : len(chunk)] = np.arange(slot.prefill_off, slot.prefill_off + len(chunk))
            logits = self._forward(tok, pos, cache)
            slot.pending = slot.pending[len(chunk):]
            slot.prefill_off += len(chunk)
            if not slot.pending:
                if not slot.in_place:
                    kv_insert_row(self.cache, slot.scratch, slot.idx, slot.n_prompt)
                    slot.scratch = None
                finals.append((slot, logits, row, len(chunk) - 1))
        for slot, logits, row, col in finals:
            slot.state = SlotState.GENERATING
            slot.n_past = slot.n_prompt
            if self._greedy_cfg(slot.req.sampling):
                tok1 = int(torch.argmax(logits[row, col]))
                slot.sampler.accept(tok1)
            else:
                tok1 = slot.sampler.sample(logits[row, col].float().cpu().numpy())
            self._emit(slot, tok1)
        return True

    def _s_bucket(self, need: int) -> int | None:
        """Decode-length bucket: smallest power-of-2 slot window ≥ need
        (min 256); None = the full cache."""
        w = 256
        while w < need:
            w *= 2
        return w if w < self.n_ctx else None

    def _decode_step(self) -> bool:
        """Decode the generating slots: a device block when every one's
        sampler fits the device chain and the context allows (the JAX
        engine's routing), else one host-sampled step."""
        active = [s for s in self.slots if s.state == SlotState.GENERATING]
        if not active:
            return False
        nb = self.block_size
        fast = nb > 1 and all(s.fast for s in active)
        if self.paged:
            if fast and all(s.n_past + nb + 1 <= self.n_ctx for s in active):
                self._paged_block_decode_step(active)
            else:
                self._paged_decode_step(active)
            return True
        if fast and all(s.n_past + 2 * nb + 1 <= self.n_ctx for s in active):
            self._block_decode_step(active)
            return True
        self._flush_pending()
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
            self._emit(s, s.sampler.sample(logits_np[s.idx]))
        return True

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

    def _run_block(self, ids: tuple, win: int | None, greedy: bool) -> dict:
        """Run one block on the static inputs (a graph replay on CUDA, eager
        on the CPU) and start the copy of its tokens to the host."""
        nb = self.block_size
        cache = self.pkv.cache if self.paged else self.cache
        if nb not in self._io["toks"]:
            for io in (self._io, self._idle_io):
                io["toks"][nb] = torch.zeros((self.n_slots, nb), dtype=torch.int64,
                                             device=self.device)
        run = lambda: self._block(cache, self._io, nb, win, greedy)   # noqa: E731
        if self._graphs is None:
            run()
        else:
            key = ("paged" if self.paged else str(self.kv_dtype), nb, win, greedy)
            self._graphs.run(key, run,
                             lambda: self._block(cache, self._idle_io, nb, win, greedy))
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

    def _truncate(self, keep: np.ndarray) -> None:
        keep_t = torch.from_numpy(keep)
        if self.device.type == "cuda":
            keep_t = keep_t.pin_memory().to(self.device, non_blocking=True)
        kv_truncate_rows(self.cache, keep_t)

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
        """One prompt chunk (≤ page_size tokens) into the slot's page chain;
        the other rows ride along on the NULL page. Returns the finals entry
        of a slot whose prompt is done."""
        P = slot.prefill_P
        chunk = slot.pending[:P]
        with self._paged_hold([slot]):
            self.pkv.plan_step({slot.idx: len(chunk)})
            tok = np.zeros((self.n_slots, P), np.int64)
            pos = np.full((self.n_slots, P), -1, np.int32)
            tok[slot.idx, : len(chunk)] = chunk
            pos[slot.idx, : len(chunk)] = np.arange(slot.prefill_off,
                                                    slot.prefill_off + len(chunk))
            logits = self._forward(tok, pos, self.pkv.cache)
            self.pkv.finish_step()
        slot.pending = slot.pending[len(chunk):]
        slot.prefill_off += len(chunk)
        return [] if slot.pending else [(slot, logits, slot.idx, len(chunk) - 1)]

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
        """Accept a slot's block tokens until it stops; returns the count."""
        accepted = 0
        for t in row:
            s.n_past += 1
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
        if done or slot.n_past + 1 > self.n_ctx:
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
