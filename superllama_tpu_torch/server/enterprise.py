"""Enterprise serving ops, the port's copy of the JAX package's
``server/enterprise.py`` (clean-room counterparts of src/llama-enterprise.h
and src/llama-security.h):

 - Priority, PriorityRequestQueue (llama_request_queue): four levels, fair
   per-client picks within a level, timeout expiry;
 - RateLimiter (llama_rate_limiter): per-client sliding windows of requests
   and tokens a minute, with a burst allowance;
 - Permission, Role, RBAC (llama_rbac) and ApiKeyManager
   (llama_api_key_manager): SHA-256-hashed keys with scopes and expiry;
 - ContentFilter (llama_content_filter): word and regex filters;
 - AuditLogger (llama_audit_logger): structured events, an in-memory query
   buffer, an optional JSONL file with rotation;
 - CostTracker (llama_cost_tracker) and SLAMonitor (llama_sla_monitor);
 - HealthMonitor (llama_health_monitor): HEALTHY / DEGRADED / UNHEALTHY
   from registered checks;
 - CheckpointManager and RecoveryManager (llama_checkpoint_manager,
   llama_recovery_manager): periodic slot snapshots, retry with backoff.

The server checks every POST's key and rate, audits it, records it in the
SLA monitor and bills its client; ``/health`` serves HealthMonitor.status().
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Callable, Optional

import numpy as np


class Priority(IntEnum):
    CRITICAL = 3
    HIGH = 2
    NORMAL = 1
    LOW = 0


@dataclass(order=True)
class _QItem:
    sort_key: tuple
    payload: Any = field(compare=False)


class PriorityRequestQueue:
    """4 priority levels + per-client fair round-robin within a level +
    timeout expiry (llama_request_queue semantics)."""

    def __init__(self, max_size: int = 1024, default_timeout_s: float = 300.0):
        self.max_size = max_size
        self.default_timeout_s = default_timeout_s
        self._lock = threading.Condition()
        self._levels: dict[int, deque] = {p: deque() for p in Priority}
        self._client_counts: dict[str, int] = defaultdict(int)
        self._served: dict[str, int] = {}
        self.stats = {"enqueued": 0, "dequeued": 0, "expired": 0, "rejected": 0}

    def __len__(self):
        with self._lock:
            return sum(len(d) for d in self._levels.values())

    def enqueue(self, payload, priority: Priority = Priority.NORMAL,
                client_id: str = "", timeout_s: float | None = None) -> bool:
        with self._lock:
            if len(self) >= self.max_size:
                self.stats["rejected"] += 1
                return False
            deadline = time.monotonic() + (timeout_s or self.default_timeout_s)
            self._levels[priority].append((deadline, client_id, payload))
            self._client_counts[client_id] += 1
            self.stats["enqueued"] += 1
            self._lock.notify()
            return True

    def dequeue(self, timeout: float | None = None):
        """Highest priority first; within a level, prefer the client with the
        fewest in-flight dequeues (fairness)."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                self._expire_locked()
                for p in sorted(Priority, reverse=True):
                    level = self._levels[p]
                    if level:
                        # fair pick: least-recently-served client
                        best_i = min(
                            range(len(level)),
                            key=lambda i: self._served.get(level[i][1], 0),
                        )
                        deadline, client, payload = level[best_i]
                        del level[best_i]
                        self._client_counts[client] -= 1
                        self._served[client] = self._served.get(client, 0) + 1
                        self.stats["dequeued"] += 1
                        return payload
                wait = None if end is None else end - time.monotonic()
                if wait is not None and wait <= 0:
                    return None
                self._lock.wait(wait)

    def _expire_locked(self):
        now = time.monotonic()
        for level in self._levels.values():
            alive = deque(e for e in level if e[0] > now)
            self.stats["expired"] += len(level) - len(alive)
            level.clear()
            level.extend(alive)


class RateLimiter:
    """Per-client sliding windows: requests/min and tokens/min with burst
    allowance (llama_rate_limiter semantics)."""

    def __init__(self, requests_per_minute: int = 60, tokens_per_minute: int = 100_000,
                 burst: int = 10):
        self.rpm = requests_per_minute
        self.tpm = tokens_per_minute
        self.burst = burst
        self._lock = threading.Lock()
        self._req_times: dict[str, deque] = defaultdict(deque)
        self._tok_events: dict[str, deque] = defaultdict(deque)

    def _prune(self, dq: deque, now: float):
        while dq and dq[0][0] < now - 60.0:
            dq.popleft()

    def allow_request(self, client_id: str) -> bool:
        now = time.monotonic()
        with self._lock:
            dq = self._req_times[client_id]
            self._prune(dq, now)
            if len(dq) >= self.rpm + self.burst:
                return False
            dq.append((now, 1))
            return True

    def allow_tokens(self, client_id: str, n_tokens: int) -> bool:
        now = time.monotonic()
        with self._lock:
            dq = self._tok_events[client_id]
            self._prune(dq, now)
            used = sum(n for _, n in dq)
            if used + n_tokens > self.tpm:
                return False
            dq.append((now, n_tokens))
            return True

    def usage(self, client_id: str) -> dict:
        now = time.monotonic()
        with self._lock:
            rq, tk = self._req_times[client_id], self._tok_events[client_id]
            self._prune(rq, now)
            self._prune(tk, now)
            return {"requests_last_min": len(rq),
                    "tokens_last_min": sum(n for _, n in tk)}


class Permission(IntEnum):
    """7 permissions (llama_rbac, src/llama-enterprise.h:349-397)."""
    INFERENCE = 0
    MODEL_LOAD = 1
    MODEL_UNLOAD = 2
    CONFIG_READ = 3
    CONFIG_WRITE = 4
    METRICS_READ = 5
    ADMIN = 6


@dataclass
class Role:
    name: str
    permissions: set[Permission]
    rate_limit_rpm: int = 0           # 0 = unlimited
    allowed_models: set[str] = field(default_factory=set)  # empty = all


class RBAC:
    def __init__(self):
        self._roles: dict[str, Role] = {}
        self._user_roles: dict[str, set[str]] = defaultdict(set)
        self.add_role(Role("admin", set(Permission)))
        self.add_role(Role("user", {Permission.INFERENCE, Permission.METRICS_READ}))
        self.add_role(Role("readonly", {Permission.METRICS_READ, Permission.CONFIG_READ}))

    def add_role(self, role: Role):
        self._roles[role.name] = role

    def assign(self, user: str, role: str):
        if role not in self._roles:
            raise KeyError(f"unknown role {role!r}")
        self._user_roles[user].add(role)

    def check(self, user: str, perm: Permission, model: str | None = None) -> bool:
        for rname in self._user_roles.get(user, ()):  # any role grants
            role = self._roles[rname]
            if perm in role.permissions:
                if model and role.allowed_models and model not in role.allowed_models:
                    continue
                return True
        return False


class ApiKeyManager:
    """Hashed API keys with scopes + expiry (llama_api_key_manager)."""

    def __init__(self):
        self._keys: dict[str, dict] = {}  # sha256 → {user, scopes, expires}
        self._lock = threading.Lock()

    @staticmethod
    def _hash(key: str) -> str:
        return hashlib.sha256(key.encode()).hexdigest()

    def create(self, key: str, user: str, scopes: set[str] | None = None,
               expires_at: float | None = None):
        with self._lock:
            self._keys[self._hash(key)] = {
                "user": user, "scopes": scopes or {"inference"},
                "expires_at": expires_at,
            }

    def revoke(self, key: str):
        with self._lock:
            self._keys.pop(self._hash(key), None)

    def validate(self, key: str, scope: str = "inference") -> str | None:
        """Returns the user name, or None if invalid/expired/out-of-scope."""
        with self._lock:
            info = self._keys.get(self._hash(key))
        if info is None:
            return None
        if info["expires_at"] is not None and time.time() > info["expires_at"]:
            return None
        if scope not in info["scopes"]:
            return None
        return info["user"]


class ContentFilter:
    """Word + regex filters on input/output (llama_content_filter)."""

    def __init__(self):
        self._words: list[str] = []
        self._patterns: list[re.Pattern] = []

    def add_word(self, w: str):
        self._words.append(w.lower())

    def add_pattern(self, p: str):
        self._patterns.append(re.compile(p))

    def check(self, text: str) -> tuple[bool, str | None]:
        low = text.lower()
        for w in self._words:
            if w in low:
                return False, f"blocked word: {w}"
        for p in self._patterns:
            if p.search(text):
                return False, f"blocked pattern: {p.pattern}"
        return True, None


class AuditLogger:
    """Structured audit events with rotation + in-memory query buffer
    (llama_audit_logger; 12 event types)."""

    EVENT_TYPES = (
        "request", "response", "error", "auth_success", "auth_failure",
        "rate_limited", "model_load", "model_unload", "config_change",
        "key_created", "key_revoked", "shutdown",
    )

    def __init__(self, path: str | None = None, buffer_size: int = 1000,
                 rotate_bytes: int = 64 << 20):
        self.path = path
        self.rotate_bytes = rotate_bytes
        self._buf: deque = deque(maxlen=buffer_size)
        self._lock = threading.Lock()
        self._fh = open(path, "a") if path else None

    def log(self, event_type: str, client_id: str = "", detail: dict | None = None):
        assert event_type in self.EVENT_TYPES, event_type
        ev = {"ts": time.time(), "type": event_type, "client": client_id,
              **(detail or {})}
        with self._lock:
            self._buf.append(ev)
            if self._fh:
                self._fh.write(json.dumps(ev) + "\n")
                self._fh.flush()
                if self._fh.tell() > self.rotate_bytes:
                    self._rotate()
        return ev

    def _rotate(self):
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a")

    def query(self, event_type: str | None = None, client_id: str | None = None,
              since: float = 0.0) -> list[dict]:
        with self._lock:
            return [e for e in self._buf
                    if (event_type is None or e["type"] == event_type)
                    and (client_id is None or e["client"] == client_id)
                    and e["ts"] >= since]


class CostTracker:
    """Per-model pricing + per-client billing windows (llama_cost_tracker)."""

    def __init__(self):
        self._pricing: dict[str, tuple[float, float]] = {}  # model → ($/1M in, $/1M out)
        self._usage: dict[str, list] = defaultdict(list)
        self._lock = threading.Lock()

    def set_pricing(self, model: str, per_m_input: float, per_m_output: float):
        self._pricing[model] = (per_m_input, per_m_output)

    def record(self, client_id: str, model: str, n_in: int, n_out: int):
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
    """p50/p95/p99 latency + availability + error-rate targets with alert
    callback (llama_sla_monitor)."""

    def __init__(self, latency_p95_target_s: float = 5.0,
                 error_rate_target: float = 0.01,
                 alert: Optional[Callable[[str, dict], None]] = None,
                 window: int = 1000):
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
        i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
        return sorted_vals[i]

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


class HealthMonitor:
    """Custom health-check registry + background monitor thread
    (llama_health_monitor; HEALTHY/DEGRADED/UNHEALTHY)."""

    HEALTHY, DEGRADED, UNHEALTHY = "healthy", "degraded", "unhealthy"

    def __init__(self, interval_s: float = 10.0):
        self._checks: dict[str, Callable[[], bool]] = {}
        self._results: dict[str, bool] = {}
        self._lock = threading.Lock()
        self._interval = interval_s
        self._thread: threading.Thread | None = None
        self._running = False

    def register(self, name: str, fn: Callable[[], bool]):
        with self._lock:
            self._checks[name] = fn

    def run_checks(self) -> str:
        with self._lock:
            checks = dict(self._checks)
        results = {}
        for name, fn in checks.items():
            try:
                results[name] = bool(fn())
            except Exception:
                results[name] = False
        with self._lock:
            self._results = results
        return self.status()

    def status(self) -> str:
        with self._lock:
            vals = list(self._results.values())
        if not vals or all(vals):
            return self.HEALTHY
        return self.UNHEALTHY if not any(vals) else self.DEGRADED

    def start(self):
        self._running = True

        def loop():
            while self._running:
                self.run_checks()
                time.sleep(self._interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False


# ---------------------------------------------------------------------------
# Checkpoint + recovery (llama_checkpoint_manager / llama_recovery_manager
# counterparts, src/llama-security.h:86-219)
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Periodic per-request KV snapshots with retention + recovery lookup
    (llama_checkpoint_manager: snapshot every N tokens to a directory,
    in-memory index, cleanup of stale checkpoints)."""

    def __init__(self, directory: str | None = None, every_n_tokens: int = 256,
                 max_per_request: int = 4):
        self.dir = directory or tempfile.mkdtemp(prefix="slt_ckpt_")
        os.makedirs(self.dir, exist_ok=True)
        self.every_n = every_n_tokens
        self.max_per_request = max_per_request
        self._index: dict[str, list[tuple[int, str]]] = {}
        self._last: dict[str, int] = {}
        self._lock = threading.Lock()

    def maybe_checkpoint(self, request_id: str, n_tokens: int,
                         snapshot_fn) -> str | None:
        """Call with the engine's slot_save as snapshot_fn; returns the path
        written, or None when below the interval."""
        with self._lock:
            if n_tokens - self._last.get(request_id, 0) < self.every_n:
                return None
            self._last[request_id] = n_tokens
        data = snapshot_fn()
        path = os.path.join(self.dir, f"{request_id}-{n_tokens}.npz")
        np.savez(path, **data)
        with self._lock:
            lst = self._index.setdefault(request_id, [])
            lst.append((n_tokens, path))
            while len(lst) > self.max_per_request:
                _, old = lst.pop(0)
                try:
                    os.unlink(old)
                except OSError:
                    pass
        return path

    def latest(self, request_id: str) -> str | None:
        with self._lock:
            lst = self._index.get(request_id) or []
            return lst[-1][1] if lst else None

    def cleanup(self, request_id: str) -> None:
        with self._lock:
            for _, p in self._index.pop(request_id, []):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            self._last.pop(request_id, None)


class FailureType(IntEnum):
    OOM = 0
    DEVICE_ERROR = 1
    TIMEOUT = 2
    INVALID_STATE = 3


class RecoveryManager:
    """Retry-with-backoff + degradation policy (llama_recovery_manager:
    failure taxonomy, exponential backoff, reduce-batch-on-OOM)."""

    def __init__(self, max_retries: int = 3, backoff_s: float = 0.1,
                 backoff_mult: float = 2.0):
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_mult = backoff_mult
        self.stats = {"attempts": 0, "recoveries": 0, "failures": 0}

    @staticmethod
    def classify(exc: BaseException) -> FailureType:
        msg = str(exc).lower()
        if "resource_exhausted" in msg or "out of memory" in msg or "oom" in msg:
            return FailureType.OOM
        if "timeout" in msg or "deadline" in msg:
            return FailureType.TIMEOUT
        if isinstance(exc, (ValueError, AssertionError)):
            return FailureType.INVALID_STATE
        return FailureType.DEVICE_ERROR

    def run(self, fn, *, on_oom=None, on_retry=None):
        """Execute fn with retries. on_oom() is invoked before retrying an
        OOM-classified failure (e.g. halve the batch / spill pages)."""
        delay = self.backoff_s
        last: BaseException | None = None
        for attempt in range(self.max_retries + 1):
            self.stats["attempts"] += 1
            try:
                out = fn()
                if attempt > 0:
                    self.stats["recoveries"] += 1
                return out
            except Exception as e:  # noqa: BLE001 — policy layer
                last = e
                kind = self.classify(e)
                if attempt >= self.max_retries:
                    break
                if kind == FailureType.OOM and on_oom is not None:
                    on_oom()
                if on_retry is not None:
                    on_retry(attempt, kind, e)
                time.sleep(delay)
                delay *= self.backoff_mult
        self.stats["failures"] += 1
        raise last  # type: ignore[misc]
