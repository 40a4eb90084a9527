"""Metrics registry with the Prometheus text exposition (``/metrics``),
OTel-style trace spans and the JSONL metrics logger.

Counterpart of the JAX package's ``server/metrics.py``:

 - ``MetricsRegistry``: counters, gauges and histograms, each under an
   optional label set, exposed as ``<namespace>_<name>`` with HELP and
   TYPE lines (namespace ``sllm``; src/llama-prometheus.h);
 - ``TraceSpan`` / ``Tracer``: named spans with attributes, events and a
   status, handed to a sink when they end (llama_trace_span);
 - ``JsonlMetricsLogger``: a snapshot of an engine's counters, busy slots
   and queue depth, appended as one JSON line per call or per interval
   (llama_metrics_logger, src/llama-metrics.h). The server logs one after
   every POST that passes its key and rate checks (``serve
   --metrics-file``).
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any


class MetricsRegistry:
    def __init__(self, namespace: str = "sllm"):
        self.ns = namespace
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = defaultdict(float)
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, list] = {}
        self._hist_buckets: dict[str, list[float]] = {}
        self._help: dict[str, str] = {}

    @staticmethod
    def _key(name: str, labels: dict | None):
        return (name, tuple(sorted((labels or {}).items())))

    def describe(self, name: str, help_text: str):
        self._help[name] = help_text

    def counter_inc(self, name: str, value: float = 1.0, labels: dict | None = None):
        with self._lock:
            self._counters[self._key(name, labels)] += value

    def gauge_set(self, name: str, value: float, labels: dict | None = None):
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def histogram_declare(self, name: str, buckets: list[float]):
        self._hist_buckets[name] = sorted(buckets)

    def histogram_observe(self, name: str, value: float, labels: dict | None = None):
        buckets = self._hist_buckets.setdefault(
            name, [0.001, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 30, 60])
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = [[0] * (len(buckets) + 1), 0.0, 0]   # bucket counts, sum, count
                self._hists[key] = h
            for i, b in enumerate(buckets):
                if value <= b:
                    h[0][i] += 1
            h[0][-1] += 1
            h[1] += value
            h[2] += 1

    @staticmethod
    def _fmt_labels(label_items, extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in label_items]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def _head(self, out: list, seen: set, name: str, kind: str) -> str:
        full = f"{self.ns}_{name}"
        if full not in seen:
            seen.add(full)
            out.append(f"# HELP {full} {self._help.get(name, name)}")
            out.append(f"# TYPE {full} {kind}")
        return full

    def expose(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        out: list[str] = []
        seen: set = set()
        with self._lock:
            for kind, items in (("counter", self._counters), ("gauge", self._gauges)):
                for (name, labels), v in sorted(items.items()):
                    full = self._head(out, seen, name, kind)
                    out.append(f"{full}{self._fmt_labels(labels)} {v}")
            for (name, labels), (bcounts, total, count) in sorted(self._hists.items()):
                full = self._head(out, seen, name, "histogram")
                for i, b in enumerate(self._hist_buckets[name]):
                    le = self._fmt_labels(labels, f'le="{b}"')
                    out.append(f"{full}_bucket{le} {bcounts[i]}")
                le = self._fmt_labels(labels, 'le="+Inf"')
                out.append(f"{full}_bucket{le} {bcounts[-1]}")
                out.append(f"{full}_sum{self._fmt_labels(labels)} {total}")
                out.append(f"{full}_count{self._fmt_labels(labels)} {count}")
        return "\n".join(out) + "\n"


@dataclass
class TraceSpan:
    """OTel-style span (llama_trace_span, src/llama-prometheus.h:183-207)."""

    name: str
    trace_id: str = ""
    attributes: dict = field(default_factory=dict)
    events: list = field(default_factory=list)
    status: str = "ok"
    t_start: float = field(default_factory=time.perf_counter)
    t_end: float | None = None

    def set_attribute(self, k, v):
        self.attributes[k] = v

    def add_event(self, name: str, attrs: dict | None = None):
        self.events.append({"name": name, "ts": time.perf_counter(), **(attrs or {})})

    def set_status(self, status: str):
        self.status = status

    def end(self):
        self.t_end = time.perf_counter()

    @property
    def duration_s(self) -> float:
        return (self.t_end or time.perf_counter()) - self.t_start


class Tracer:
    def __init__(self, sink=None):
        self.sink = sink  # callable(span) or None
        self.spans: list[TraceSpan] = []

    @contextmanager
    def span(self, name: str, **attrs):
        s = TraceSpan(name=name, attributes=dict(attrs))
        try:
            yield s
        except Exception:
            s.set_status("error")
            raise
        finally:
            s.end()
            self.spans.append(s)
            if self.sink:
                self.sink(s)


class JsonlMetricsLogger:
    """Interval or per-event JSONL snapshots (llama_metrics_logger,
    src/llama-metrics.h:60-143). The snapshot field set mirrors
    llama_metrics_snapshot (h:11-57) where applicable."""

    def __init__(self, path: str | None = None, interval_s: float = 0.0):
        self.path = path
        self.interval_s = interval_s
        self._fh = open(path, "a") if path else None
        self._last = 0.0
        self._lock = threading.Lock()

    def snapshot(self, engine=None, extra: dict | None = None) -> dict:
        snap: dict[str, Any] = {"ts": time.time()}
        if engine is not None:
            m = engine.metrics
            dec_s = max(m["decode_s"], 1e-9)
            snap.update({
                "n_requests": m["n_requests"],
                "n_prompt_tokens": m["n_prompt_tokens"],
                "n_tokens_generated": m["n_tokens_generated"],
                "n_decode_steps": m["n_decode_steps"],
                "prefill_s_total": round(m["prefill_s"], 4),
                "decode_s_total": round(m["decode_s"], 4),
                "decode_tok_per_s": round(m["n_tokens_generated"] / dec_s, 2),
                "slots_busy": sum(s.state.value != 0 for s in engine.slots),
                "slots_total": engine.n_slots,
                "queue_depth": engine._queue.qsize(),
            })
        if extra:
            snap.update(extra)
        return snap

    def log(self, engine=None, extra: dict | None = None, force: bool = False):
        now = time.time()
        if not force and self.interval_s > 0 and now - self._last < self.interval_s:
            return None
        self._last = now
        snap = self.snapshot(engine, extra)
        with self._lock:
            if self._fh:
                self._fh.write(json.dumps(snap) + "\n")
                self._fh.flush()
        return snap
