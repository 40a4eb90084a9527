"""Metrics registry with the Prometheus text exposition (``/metrics``).

Counterpart of the JAX package's ``server/metrics.py::MetricsRegistry``:
counters, gauges and histograms, each under an optional label set, exposed
as ``<namespace>_<name>`` with HELP and TYPE lines (namespace ``sllm``).
"""

from __future__ import annotations

import threading
from collections import defaultdict


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
