"""Continuous-batching inference engine over a dense KV cache.

Counterpart of the JAX package's ``runtime/engine.py::Engine`` (the
reference server's update_slots semantics):

 - decode: one (n_slots, 1) forward over all slots; idle slots ride along
   with pos = -1 (masked, cursor not advanced);
 - prefill: prompts load in bucketed chunks (``PREFILL_BUCKETS``), one chunk
   per engine step. A lone prompt prefills into a one-row scratch cache that
   is then copied into its slot's row; two or more prompts load together in
   one (n_slots, P) wave straight into the big cache;
 - sampling: a host ``SamplerChain`` per slot; when every generating slot is
   greedy, a block of ``block_size`` forward + argmax steps runs on the
   device and the host rolls back the overshoot past a stop with
   ``kv_truncate_rows``.

Thread model: ``submit`` enqueues; one engine thread (``start``) or the
caller (``run_until_drained``) owns the device. The cache is updated in
place.

Not ported yet: paged KV, speculative and lookup decoding, context shift,
grammars, prompt-prefix reuse, slot save/restore and the device sampler
chain; non-greedy requests take the host-sampled step decode.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.loader import LoadedModel
from ..models.registry import get_forward
from .context import check_model_device
from .kv_cache import KVCache, kv_cache_init, kv_insert_row, kv_truncate_rows
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


class Engine:
    """Continuous-batching engine on one device (default CUDA)."""

    def __init__(self, model: LoadedModel, n_slots: int = 4, n_ctx: int = 2048,
                 kv_dtype: torch.dtype = torch.bfloat16,
                 prefill_buckets=PREFILL_BUCKETS, block_size: int = 8,
                 device=None):
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
        self.cache = self._new_cache(n_slots)
        self.slots = [_Slot(i) for i in range(n_slots)]
        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
        # serializes step() against callers that must see a quiet engine
        self._step_lock = threading.RLock()
        self._running = False
        self._thread: threading.Thread | None = None

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
        slot.sampler = make_chain(**req.sampling) if req.sampling else make_chain(greedy=True)
        for t in ids[-64:]:
            slot.sampler.ctx.recent_tokens.append(t)

    def _prefill_step(self) -> bool:
        """Advance every loading slot by one prompt chunk."""
        loading = [s for s in self.slots if s.state == SlotState.PREFILL]
        if not loading:
            return False
        finals: list[tuple[_Slot, torch.Tensor, int, int]] = []  # (slot, logits, row, col)
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
        active = [s for s in self.slots if s.state == SlotState.GENERATING]
        if not active:
            return False
        if (self.block_size > 1
                and all(self._greedy_cfg(s.req.sampling) for s in active)
                and all(s.n_past + 2 * self.block_size + 1 <= self.n_ctx for s in active)):
            self._block_decode(active)
        else:
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

    def _block_decode(self, active: list[_Slot]) -> None:
        """Greedy block decode: block_size forward + argmax steps on the
        device with no host round-trip between them, then the host accepts
        each slot's tokens and rolls back the rows that ran past a stop."""
        nb = self.block_size
        tok0 = np.zeros((self.n_slots, 1), np.int64)
        pos0 = np.full((self.n_slots, 1), -1, np.int32)
        for s in active:
            tok0[s.idx, 0] = s.generated[-1]
            pos0[s.idx, 0] = s.n_past
        win = self._s_bucket(max(s.n_past for s in active) + 2 * nb + 1)
        tok = torch.as_tensor(tok0).to(self.device)
        pos = torch.as_tensor(pos0).to(self.device)
        live = pos[:, 0] >= 0
        steps = []
        for _ in range(nb):
            logits, _ = self._fwd(self.model.params, self.hp, tok, pos,
                                  self.cache, s_window=win)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            nxt = torch.where(live, nxt, tok[:, 0])
            pos = torch.where(live[:, None], pos + 1, pos)
            tok = nxt[:, None]
            steps.append(nxt)
        toks = torch.stack(steps, dim=1).cpu().numpy()      # (n_slots, nb)
        keep = self._keep_vector()
        overshoot = False
        for s in active:
            accepted = self._consume_row(s, toks[s.idx])
            overshoot |= accepted < nb
            keep[s.idx] = s.n_past
        if overshoot:
            kv_truncate_rows(self.cache, torch.from_numpy(keep))

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
