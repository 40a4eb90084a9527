"""Paged KV cache: a device page pool with page tables, and a host-side
manager that allocates pages and spills cold ones to host memory.

Counterpart of the JAX package's ``runtime/paged_kv.py``:

 - device side: per layer a pool of ``N`` pages of ``P`` slots each, shared
   by all sequences, with one page table per sequence; attention reads the
   pool through the table (``ops/paged_attention.py``). Page 0 is the NULL
   page: its positions stay −1, absent table entries read it, and idle rows
   write their junk there.
 - host side: ``PagedKVManager`` owns allocation, LRU spill of unpinned pages
   to host memory (CPU tensors), pinning, coalesced restore, rollback of a
   decode block's overshoot, and the telemetry counters of the JAX manager.

The JAX cache is a functional pytree donated to each jitted step; this one
is updated IN PLACE. ``paged_advance`` and ``paged_update_layer`` write into
the cache's tensors, and the manager writes tables and page positions with
ordinary copies, which the stream orders before the next launch. Float
caches only, as in the JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class PagedKVCache:
    k_pages: torch.Tensor    # (L, N, H_kv, P, D)
    v_pages: torch.Tensor    # (L, N, H_kv, P, Dv)
    page_pos: torch.Tensor   # (N, P) int32 global positions, -1 = empty
    table: torch.Tensor      # (B, MAXP) int32 pool page per logical page, -1 absent
    cur_page: torch.Tensor   # (B,) int32 logical index of the open page
    cur_off: torch.Tensor    # (B,) int32 next write offset in the open page

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]


def paged_cache_init(n_layer: int, n_pages: int, page_size: int, n_seqs: int,
                     max_pages_per_seq: int, n_head_kv: int, head_dim: int,
                     head_dim_v: int | None = None, dtype=torch.bfloat16,
                     device="cpu") -> PagedKVCache:
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"paged KV cache type {dtype!r}: the paged cache keeps "
                         "f32/bf16 pages (q8_0/q4_0 need the dense cache)")
    head_dim_v = head_dim_v or head_dim
    i32 = dict(dtype=torch.int32, device=device)
    return PagedKVCache(
        k_pages=torch.zeros((n_layer, n_pages, n_head_kv, page_size, head_dim),
                            dtype=dtype, device=device),
        v_pages=torch.zeros((n_layer, n_pages, n_head_kv, page_size, head_dim_v),
                            dtype=dtype, device=device),
        page_pos=torch.full((n_pages, page_size), -1, **i32),
        table=torch.full((n_seqs, max_pages_per_seq), -1, **i32),
        cur_page=torch.zeros((n_seqs,), **i32),
        cur_off=torch.zeros((n_seqs,), **i32),
    )


def paged_row_view(cache: PagedKVCache) -> PagedKVCache:
    """A one-row view of the page pool: ``k_pages``, ``v_pages`` and
    ``page_pos`` shared with ``cache``, a table (1, MAXP) of -1 (absent)
    and cursors (1,) of its own, static buffers that
    ``PagedKVManager.load_row`` fills with one sequence's. A step on the
    view writes that sequence's pages; on an empty table its writes land on
    the NULL page."""
    i32 = dict(dtype=torch.int32, device=cache.table.device)
    return PagedKVCache(k_pages=cache.k_pages, v_pages=cache.v_pages,
                        page_pos=cache.page_pos,
                        table=torch.full((1, cache.table.shape[1]), -1, **i32),
                        cur_page=torch.zeros((1,), **i32), cur_off=torch.zeros((1,), **i32))


# ------------------------------------------------------- in-step updates


def _write_cells(cache: PagedKVCache, slots: torch.Tensor, offs: torch.Tensor,
                 T: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(page, cell) int64 indices (B, T) of each row's next T cells. Cells
    past the page end (only rows that write nothing real reach them) go to
    the NULL page, where the JAX package drops the write."""
    col = offs[:, None].to(torch.int64) + torch.arange(T, device=offs.device)[None, :]
    page = slots[:, None].to(torch.int64).expand(-1, T)
    over = col >= cache.page_size
    return torch.where(over, 0, page), torch.clamp(col, max=cache.page_size - 1)


def paged_advance(cache: PagedKVCache, pos_new: torch.Tensor):
    """Record positions for the incoming (B, T) tokens and advance offsets,
    in place. Precondition (the manager's): a row's real tokens fit its open
    page. Returns (slots (B,) pool pages, offs (B,) write offsets)."""
    B, T = pos_new.shape
    b_idx = torch.arange(B, device=pos_new.device)
    # idle rows (no open page) write into the NULL page: its positions stay
    # -1, so their junk is masked
    slots = torch.clamp(cache.table[b_idx, cache.cur_page.to(torch.int64)], min=0)
    offs = cache.cur_off.clone()
    valid = pos_new >= 0
    page, col = _write_cells(cache, slots, offs, T)
    cache.page_pos[page, col] = torch.where(valid, pos_new, -1).to(torch.int32)
    cache.cur_off += valid.sum(dim=1, dtype=torch.int32)
    return slots, offs


def paged_update_layer(cache: PagedKVCache, layer: int, slots: torch.Tensor,
                       offs: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor) -> PagedKVCache:
    """Write (B, T, H_kv, D) K/V into each row's open page at its offset, in
    place."""
    page, col = _write_cells(cache, slots, offs, k_new.shape[1])
    cache.k_pages[layer][page, :, col] = k_new.to(cache.k_pages.dtype)
    cache.v_pages[layer][page, :, col] = v_new.to(cache.v_pages.dtype)
    return cache


# ---------------------------------------------------------- host manager


@dataclass
class _PageMeta:
    seq: int = -1
    logical: int = -1
    last_use: float = 0.0
    pinned: bool = False


@dataclass
class PagedKVManager:
    """Host-side page allocator and device⇄host tiering: allocate on write,
    LRU eviction of unpinned pages to host memory under pool pressure,
    pin/unpin, coalesced restore of adjacent pages, stats."""
    cache: PagedKVCache
    stats: dict = field(default_factory=lambda: {
        "allocs": 0, "evictions": 0, "restores": 0, "coalesced_restores": 0,
        "spill_bytes": 0, "restore_bytes": 0,
    })

    def __post_init__(self):
        n = self.cache.k_pages.shape[1]
        self.meta = [_PageMeta() for _ in range(n)]
        self.meta[0].pinned = True      # the NULL page is never allocated
        self.free = list(range(n - 1, 0, -1))
        # host store: (seq, logical) → (k (L,Hkv,P,D), v, pos (P,)) CPU tensors
        self.host: dict[tuple[int, int], tuple] = {}
        self._table_np = self.cache.table.cpu().numpy().copy()
        self._cur_page = self.cache.cur_page.cpu().numpy().copy()
        self._cur_off = self.cache.cur_off.cpu().numpy().copy()
        self._plan: dict[int, int] = {}

    @property
    def page_size(self) -> int:
        return self.cache.page_size

    @property
    def n_pool_pages(self) -> int:
        return self.cache.k_pages.shape[1] - 1   # page 0 is the NULL page

    def _sync_cursors(self):
        self.cache.cur_page.copy_(torch.from_numpy(self._cur_page))
        self.cache.cur_off.copy_(torch.from_numpy(self._cur_off))

    def _sync_table(self):
        # synchronous copies from pageable memory: ordered on the stream
        # before the next launch, and the host mirrors may change at once
        self.cache.table.copy_(torch.from_numpy(self._table_np))
        self._sync_cursors()

    def _release(self, slot: int):
        m = self.meta[slot]
        m.seq = m.logical = -1
        m.pinned = False
        self.free.append(slot)
        self.cache.page_pos[slot] = -1

    def _alloc_slot(self, seq: int, logical: int) -> int:
        if not self.free:
            self._evict_lru()
        slot = self.free.pop()
        m = self.meta[slot]
        m.seq, m.logical, m.last_use, m.pinned = seq, logical, time.monotonic(), False
        self.stats["allocs"] += 1
        return slot

    def _evict_lru(self, n: int = 1):
        """Spill the n least-recently-used unpinned resident pages to host."""
        resident = [(m.last_use, s) for s, m in enumerate(self.meta)
                    if m.seq >= 0 and not m.pinned]
        if len(resident) < n:
            raise RuntimeError("page pool exhausted: all pages pinned")
        resident.sort()
        for _, slot in resident[:n]:
            m = self.meta[slot]
            k = self.cache.k_pages[:, slot].to("cpu", copy=True)
            v = self.cache.v_pages[:, slot].to("cpu", copy=True)
            p = self.cache.page_pos[slot].to("cpu", copy=True)
            self.host[(m.seq, m.logical)] = (k, v, p)
            self.stats["evictions"] += 1
            self.stats["spill_bytes"] += k.nbytes + v.nbytes
            self._table_np[m.seq, m.logical] = -1
            self.cache.page_pos[slot] = -1
            m.seq = m.logical = -1
            self.free.append(slot)

    def touch(self, seq: int):
        now = time.monotonic()
        for lg in range(int(self._cur_page[seq]) + 1):
            slot = self._table_np[seq, lg]
            if slot >= 0:
                self.meta[slot].last_use = now

    def pin(self, seq: int, pinned: bool = True):
        for slot in self._table_np[seq]:
            if slot >= 0:
                self.meta[slot].pinned = pinned

    def ensure_resident(self, seq: int):
        """Restore all spilled pages of a sequence, runs of adjacent pages
        together. The sequence's pages are pinned meanwhile, so a restore's
        own allocation cannot spill them; prior pins come back on exit."""
        prev_pin: dict[int, bool] = {}

        def pin_now(slot: int):
            prev_pin.setdefault(slot, self.meta[slot].pinned)
            self.meta[slot].pinned = True

        for slot in self._table_np[seq]:
            if slot >= 0:
                pin_now(int(slot))
        while True:
            logicals = sorted(lg for (s, lg) in self.host if s == seq)
            if not logicals:
                break
            run: list[int] = []
            for lg in logicals + [None]:
                if lg is not None and (not run or lg == run[-1] + 1):
                    run.append(lg)
                    continue
                if run:
                    if len(run) >= 4:
                        self.stats["coalesced_restores"] += 1
                    for r in run:
                        self._restore_page(seq, r)
                        pin_now(int(self._table_np[seq, r]))
                run = [lg] if lg is not None else []
        for slot, pinned in prev_pin.items():
            if self.meta[slot].seq == seq:      # may have been evicted and reused
                self.meta[slot].pinned = pinned
        self._sync_table()

    def _restore_page(self, seq: int, logical: int):
        k, v, p = self.host.pop((seq, logical))
        slot = self._alloc_slot(seq, logical)
        self.cache.k_pages[:, slot].copy_(k)
        self.cache.v_pages[:, slot].copy_(v)
        self.cache.page_pos[slot].copy_(p)
        self._table_np[seq, logical] = slot
        self.meta[slot].last_use = time.monotonic()
        self.stats["restores"] += 1
        self.stats["restore_bytes"] += k.nbytes + v.nbytes

    def plan_step(self, active: dict[int, int]):
        """Prepare one step appending ``active[seq]`` tokens per row. A row's
        tokens must fit one page (callers chunk prefills to ≤ P); when the
        open page cannot hold them it is closed (its tail stays empty and
        masked) and a fresh page opens. The device tables and cursors are
        synced to the write starts."""
        P = self.page_size
        self._plan = dict(active)
        for seq, n in active.items():
            if n > P:
                raise ValueError(f"step of {n} tokens exceeds page size {P}")
            pg = int(self._cur_page[seq])
            if int(self._cur_off[seq]) + n > P:
                pg += 1
                if pg >= self._table_np.shape[1]:
                    raise ValueError("sequence exceeds max_pages_per_seq")
                self._cur_page[seq] = pg
                self._cur_off[seq] = 0
            if self._table_np[seq, pg] < 0:
                if (seq, pg) in self.host:
                    # a spilled copy exists: restore it, or the stale host
                    # copy would clobber new tokens on a later restore
                    self._restore_page(seq, pg)
                else:
                    self._table_np[seq, pg] = self._alloc_slot(seq, pg)
            self.touch(seq)
        self._sync_table()

    def load_row(self, view: PagedKVCache, seq: int) -> None:
        """Copy one sequence's table row and cursors from the host mirrors
        into a ``paged_row_view`` (after ``plan_step``: the cursors at its
        write start), with ``_sync_table``'s synchronous copies. The
        manager's mirrors stay the source of truth: ``finish_step``
        advances them."""
        view.table.copy_(torch.from_numpy(self._table_np[seq:seq + 1]))
        view.cur_page.copy_(torch.from_numpy(self._cur_page[seq:seq + 1]))
        view.cur_off.copy_(torch.from_numpy(self._cur_off[seq:seq + 1]))

    def finish_step(self):
        """Advance the host offsets past the planned tokens (the step wrote
        the device cache in place)."""
        for seq, n in self._plan.items():
            self._cur_off[seq] += n
        self._plan = {}
        self._sync_cursors()

    def save_cursor(self, seq: int) -> tuple[int, int]:
        """(cur_page, cur_off) snapshot for block-overshoot rollback."""
        return int(self._cur_page[seq]), int(self._cur_off[seq])

    def rollback(self, seq: int, cursor: tuple[int, int], accepted: int,
                 planned: int) -> None:
        """Of the ``planned`` tokens appended from the pre-plan ``cursor``,
        keep the first ``accepted`` and invalidate the rest (positions → -1).
        plan_step put the whole block in ONE page (the open page, or a fresh
        one if it could not fit)."""
        pg0, off0 = cursor
        if off0 + planned > self.page_size:   # the plan opened a fresh page
            pg, off = pg0 + 1, accepted
        else:
            pg, off = pg0, off0 + accepted
        for g in range(pg, int(self._cur_page[seq]) + 1):
            slot = int(self._table_np[seq, g])
            if slot >= 0:
                self.cache.page_pos[slot, (off if g == pg else 0):] = -1
        self._cur_page[seq] = pg
        self._cur_off[seq] = off
        self._sync_cursors()

    def seq_pages(self, seq: int) -> int:
        """Logical pages a sequence owns (resident + spilled)."""
        return (int((self._table_np[seq] >= 0).sum())
                + sum(1 for (s, _) in self.host if s == seq))

    def free_seq(self, seq: int):
        for lg, slot in enumerate(self._table_np[seq]):
            if slot >= 0:
                self._release(int(slot))
            self._table_np[seq, lg] = -1
        for key in [k for k in self.host if k[0] == seq]:
            del self.host[key]
        self._cur_page[seq] = 0
        self._cur_off[seq] = 0
        self._sync_table()

    def export_row(self, seq: int):
        """A sequence's resident cells as dense per-layer tensors, in page
        order: (k (L, Hkv, n_cells, D), v (L, Hkv, n_cells, Dv), pos
        (n_cells,)). Gap cells (closed-page tails) carry pos -1."""
        self.ensure_resident(seq)
        pgs = [int(self._table_np[seq, g]) for g in range(int(self._cur_page[seq]) + 1)]
        pgs = [p for p in pgs if p >= 0]
        if not pgs:
            L, _, Hkv, _, D = self.cache.k_pages.shape
            Dv = self.cache.v_pages.shape[-1]
            dt = self.cache.k_pages.dtype
            return (torch.zeros((L, Hkv, 0, D), dtype=dt),
                    torch.zeros((L, Hkv, 0, Dv), dtype=dt),
                    torch.zeros((0,), dtype=torch.int32))
        idx = torch.tensor(pgs, device=self.cache.page_pos.device)
        k = torch.cat(list(self.cache.k_pages[:, idx].unbind(1)), dim=2).cpu()
        v = torch.cat(list(self.cache.v_pages[:, idx].unbind(1)), dim=2).cpu()
        return k, v, self.cache.page_pos[idx].reshape(-1).cpu()

    def import_row(self, seq: int, k, v, pos) -> None:
        """Replace a sequence's pages with dense cells (cell i at slot i of
        the page chain; pos already position-ordered)."""
        self.free_seq(seq)
        n = int(pos.shape[0])
        P = self.page_size
        n_pages = max(1, -(-n // P))
        for g in range(n_pages):
            slot = self._alloc_slot(seq, g)
            self._table_np[seq, g] = slot
            lo, hi = g * P, min((g + 1) * P, n)
            self.cache.k_pages[:, slot] = 0
            self.cache.v_pages[:, slot] = 0
            self.cache.k_pages[:, slot, :, : hi - lo] = torch.as_tensor(k)[:, :, lo:hi]
            self.cache.v_pages[:, slot, :, : hi - lo] = torch.as_tensor(v)[:, :, lo:hi]
            self.cache.page_pos[slot] = -1
            self.cache.page_pos[slot, : hi - lo] = torch.as_tensor(pos)[lo:hi]
        self._cur_page[seq] = n_pages - 1
        self._cur_off[seq] = n - (n_pages - 1) * P
        self._sync_table()

    def trim_to_position(self, seq: int, keep_pos: int) -> bool:
        """Invalidate every cell with position ≥ keep_pos, park the cursor
        right after the last kept cell and free the pages past it. Returns
        False when the sequence has no cell to keep."""
        self.ensure_resident(seq)
        last = None                     # (logical page, cell index)
        rows = {}
        for g in range(int(self._cur_page[seq]) + 1):
            slot = int(self._table_np[seq, g])
            if slot < 0:
                continue
            row = self.cache.page_pos[slot].cpu().numpy()
            rows[g] = (slot, row)
            kept = np.nonzero((row >= 0) & (row < keep_pos))[0]
            if kept.size:
                last = (g, int(kept[-1]))
        if last is None:
            return False
        gk, ck = last
        for g, (slot, row) in rows.items():
            if g > gk:
                self._table_np[seq, g] = -1
                self._release(slot)
                continue
            cut = ck + 1 if g == gk else self.page_size
            mask = (np.arange(self.page_size) < cut) & (row < keep_pos)
            new_row = np.where(mask, row, -1).astype(np.int32)
            if not np.array_equal(new_row, row):
                self.cache.page_pos[slot].copy_(torch.from_numpy(new_row))
        for key in [k for k in self.host if k[0] == seq and k[1] > gk]:
            del self.host[key]      # spilled copies past the cut are stale
        self._cur_page[seq] = gk
        self._cur_off[seq] = ck + 1
        self._sync_table()
        return True
