"""Serving accounting: ``CostTracker`` (per-model pricing and per-client
billing windows, llama_cost_tracker) and ``SLAMonitor`` (latency
percentiles, error rate and availability over a window, with an alert
callback, llama_sla_monitor), as in the JAX package's
``server/enterprise.py``. The server records every request in both."""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Callable, Optional


class CostTracker:
    def __init__(self):
        self._pricing: dict[str, tuple[float, float]] = {}   # model -> ($/1M in, $/1M out)
        self._usage: dict[str, list] = defaultdict(list)
        self._lock = threading.Lock()

    def set_pricing(self, model: str, per_m_input: float, per_m_output: float):
        self._pricing[model] = (per_m_input, per_m_output)

    def record(self, client_id: str, model: str, n_in: int, n_out: int) -> float:
        pi, po = self._pricing.get(model, (0.0, 0.0))
        cost = n_in * pi / 1e6 + n_out * po / 1e6
        with self._lock:
            self._usage[client_id].append((time.time(), model, n_in, n_out, cost))
        return cost

    def bill(self, client_id: str, since: float = 0.0) -> dict:
        with self._lock:
            rows = [r for r in self._usage[client_id] if r[0] >= since]
        return {
            "client": client_id,
            "requests": len(rows),
            "input_tokens": sum(r[2] for r in rows),
            "output_tokens": sum(r[3] for r in rows),
            "cost_usd": sum(r[4] for r in rows),
        }


class SLAMonitor:
    def __init__(self, latency_p95_target_s: float = 5.0, error_rate_target: float = 0.01,
                 alert: Optional[Callable[[str, dict], None]] = None, window: int = 1000):
        self.p95_target = latency_p95_target_s
        self.error_target = error_rate_target
        self.alert = alert
        self._lat: deque = deque(maxlen=window)
        self._ok: deque = deque(maxlen=window)
        self._lock = threading.Lock()

    def record(self, latency_s: float, ok: bool = True):
        with self._lock:
            self._lat.append(latency_s)
            self._ok.append(ok)
        snap = self.snapshot()
        if self.alert:
            if snap["p95_s"] > self.p95_target:
                self.alert("latency_sla_violation", snap)
            if snap["error_rate"] > self.error_target:
                self.alert("error_rate_sla_violation", snap)

    @staticmethod
    def _pct(sorted_vals, q):
        if not sorted_vals:
            return 0.0
        return sorted_vals[min(int(q * len(sorted_vals)), len(sorted_vals) - 1)]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            ok = list(self._ok)
        n = len(ok)
        return {
            "n": n,
            "p50_s": self._pct(lat, 0.50),
            "p95_s": self._pct(lat, 0.95),
            "p99_s": self._pct(lat, 0.99),
            "error_rate": (n - sum(ok)) / n if n else 0.0,
            "availability": sum(ok) / n if n else 1.0,
        }
