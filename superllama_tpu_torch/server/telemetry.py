"""Device and host memory telemetry (the JAX package's
``server/telemetry.py``, llama_mem_telemetry): cached polling with
pressure (0.85) and critical (0.95) predicates and a refresh interval. The
device side is read from torch's CUDA allocator on the engine's device
(``memory_allocated``, and ``mem_get_info``'s total as the limit); a CPU
device reports 0 for both. Host memory comes from /proc/meminfo."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class MemStats:
    device_used: int = 0
    device_limit: int = 0
    host_used: int = 0
    host_total: int = 0

    @property
    def device_frac(self) -> float:
        return self.device_used / self.device_limit if self.device_limit else 0.0

    @property
    def host_frac(self) -> float:
        return self.host_used / self.host_total if self.host_total else 0.0


@dataclass
class MemTelemetry:
    device: torch.device | str = "cpu"
    pressure_threshold: float = 0.85
    critical_threshold: float = 0.95
    refresh_s: float = 0.1
    _stats: MemStats = field(default_factory=MemStats)
    _t_last: float = 0.0

    def refresh(self, force: bool = False) -> MemStats:
        now = time.monotonic()
        if not force and now - self._t_last < self.refresh_s:
            return self._stats
        self._t_last = now
        s = MemStats()
        dev = torch.device(self.device)
        if dev.type == "cuda":
            s.device_used = int(torch.cuda.memory_allocated(dev))
            s.device_limit = int(torch.cuda.mem_get_info(dev)[1])
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.strip().split()[0]) * 1024
            s.host_total = info.get("MemTotal", 0)
            s.host_used = s.host_total - info.get("MemAvailable", 0)
        except OSError:
            pass
        self._stats = s
        return s

    def under_pressure(self) -> bool:
        return self.refresh().device_frac >= self.pressure_threshold

    def critical(self) -> bool:
        return self.refresh().device_frac >= self.critical_threshold

    def snapshot(self) -> dict:
        s = self.refresh()
        return {
            "device_used_bytes": s.device_used,
            "device_limit_bytes": s.device_limit,
            "device_frac": round(s.device_frac, 4),
            "host_used_bytes": s.host_used,
            "host_total_bytes": s.host_total,
            "host_frac": round(s.host_frac, 4),
            "pressure": s.device_frac >= self.pressure_threshold,
            "critical": s.device_frac >= self.critical_threshold,
        }
