"""CUDA graphs of decode blocks and prompt chunks, and the launch
accounting that replays need.

The JAX package compiles a block of decode steps into one dispatch
(``jax.jit`` over a ``lax.scan``), and a prompt chunk into another
(``jax.jit`` of the forward). The port's counterpart captures the eager
block or chunk once per key in a ``torch.cuda.CUDAGraph`` and replays it:
one host call launches every kernel of every step.

The kernel wrappers count their launches in Python (``qmv.launches``, …).
A replay runs no Python, so ``GraphCache`` records each counter's increase
during a capture (when nothing launches), takes it back, and adds it on
every replay: a replayed block counts what the eager block counts.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def launch_counters() -> list[tuple[object, str]]:
    """(wrapper, attribute) of every kernel launch counter a decode block
    or a prompt chunk can reach."""
    from ..ops import flash_attention as fa_mod
    from ..ops import grouped_matmul as gm_mod
    from ..ops import paged_attention as pa_mod
    from ..ops import qmatmul as qm_mod
    from ..ops import ssm_scan as ss_mod
    from ..ops import wkv as wkv_mod

    fa, pa = fa_mod.flash_attention, pa_mod.paged_flash_attention
    fams = [(fn, f"launches_{f}") for fn in (qm_mod.qmv, qm_mod.qmm)
            for f in qm_mod._FAMILY.values()]
    return [(qm_mod.qmv, "launches"), (qm_mod.qmm, "launches"), *fams,
            (fa, "launches"), (fa, "launches_tc"),
            (fa_mod.flash_decode_attention, "launches"),
            (pa, "launches"), (pa, "launches_tc"), (gm_mod.grouped_matmul, "launches"),
            (ss_mod.ssm_scan, "launches"),
            *((getattr(wkv_mod, rule), "launches") for rule in ("wkv6", "gla", "wkv7",
                                                                 "delta_net"))]


def _read_counts() -> list[int]:
    return [getattr(fn, attr) for fn, attr in launch_counters()]


def _add_counts(deltas: list[int]) -> None:
    for (fn, attr), d in zip(launch_counters(), deltas):
        setattr(fn, attr, getattr(fn, attr) + d)


KINDS = ("block", "chunk")


class GraphCache:
    """Captured graphs by key, sharing one memory pool, on one CUDA device
    (one stream replays them, so their scratch memory may overlap: no
    output of a graph may live in the pool past its replay).

    ``run(key, fn, warm, kind)`` replays the graph of ``key``, capturing
    ``fn`` first when the key is new. ``fn`` must read and write only
    tensors that outlive the graph (static inputs, static outputs, the
    cache). ``warm`` runs the same kernels as ``fn`` eagerly without
    changing any state that ``fn`` reads: it builds the kernels and sets
    their function attributes before the capture, which must not. Both run
    on a side stream, as a capture must; a failed capture raises.

    ``stats[kind]`` counts the captures, replays and capture seconds of
    each kind of key (decode ``"block"``, prompt ``"chunk"``) apart;
    ``capture_s[key]`` holds each key's capture seconds."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.graphs: dict = {}
        self._deltas: dict = {}
        self._kinds: dict = {}
        self.capture_s: dict = {}
        self._pool = None
        self._stream = None
        self.stats = {k: {"captures": 0, "replays": 0, "capture_s": 0.0} for k in KINDS}

    def keys(self) -> list:
        """The captured keys, in the order of their capture."""
        return list(self.graphs)

    def run(self, key, fn: Callable[[], None], warm: Callable[[], None],
            kind: str = "block") -> None:
        if key not in self.graphs:
            self.capture(key, fn, warm, kind)
        self.replay(key)

    def replay(self, key) -> None:
        self.graphs[key].replay()
        _add_counts(self._deltas[key])
        self.stats[self._kinds[key]]["replays"] += 1

    def capture(self, key, fn: Callable[[], None], warm: Callable[[], None],
                kind: str = "block") -> None:
        """Warm up, then capture ``fn`` as the graph of ``key`` (nothing
        runs on the device during the capture itself)."""
        if kind not in KINDS:
            raise ValueError(f"graph kind {kind!r}: one of {KINDS}")
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            warm()
        main.wait_stream(self._stream)
        before = _read_counts()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the engine thread captures; another thread's CUDA
        # call (none is expected) would not be refused meanwhile
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            fn()
        after = _read_counts()
        _add_counts([b - a for a, b in zip(after, before)])   # nothing launched
        if self._pool is None:
            self._pool = graph.pool()
        self.graphs[key] = graph
        self._deltas[key] = [a - b for a, b in zip(after, before)]
        self._kinds[key] = kind
        self.capture_s[key] = time.perf_counter() - t0
        self.stats[kind]["captures"] += 1
        self.stats[kind]["capture_s"] += self.capture_s[key]

    def clear(self) -> None:
        """Destroy every captured graph and let go of their pool: its
        memory returns to the allocator once nothing else holds the pool."""
        for graph in self.graphs.values():
            graph.reset()
        self.graphs.clear()
        self._deltas.clear()
        self._kinds.clear()
        self._pool = None
        self._stream = None

    def pool_bytes(self) -> int:
        """Bytes the graphs' private pool holds on the device."""
        if self._pool is None:
            return 0
        total = 0
        for seg in torch.cuda.memory_snapshot():
            if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(self._pool):
                total += seg["total_size"]
        return total
