"""Device profiling through ``torch.profiler``: the port's counterpart of
the JAX package's ``utils/profiler.py`` (jax.profiler / XProf).

- ``start(dir)`` / ``stop()``: one trace at a time, process-wide; ``stop``
  writes it as a Chrome trace (``trace.json``, for Perfetto or
  chrome://tracing) into the directory and returns the directory. The
  server's ``/profile/start`` and ``/profile/stop`` call them on the
  engine's thread, since torch.profiler records the CPU spans of the thread
  that started it only (the device's kernels it records from every thread).
- ``device_trace(dir)``: a context manager around a region (``run
  --profile-dir``).
- ``annotate(name)``: ``torch.profiler.record_function``, a named span in
  the trace; the engine's ``step`` runs its prefill and decode under
  ``engine.prefill`` and ``engine.decode``. An exception raised inside the
  span passes through unchanged.

A CUDA trace asks for ``ProfilerActivity.CUDA`` (CUPTI; the kernels of
replayed CUDA graphs appear by name): where torch cannot trace the card,
``start`` raises rather than record the CPU alone.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"

_lock = threading.Lock()
_active: tuple[str, profile] | None = None     # (directory, the running profiler)


def start(trace_dir: str, cuda: bool | None = None) -> bool:
    """Begin a trace that ``stop`` writes into ``trace_dir``; False when a
    trace is already active. ``cuda`` (default: a GPU is present) adds the
    device's activity; RuntimeError when torch cannot trace it."""
    global _active
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot trace the CUDA device here")
        activities.append(ProfilerActivity.CUDA)
    with _lock:
        if _active is not None:
            return False
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
        _active = (trace_dir, prof)
        return True


def stop() -> str | None:
    """End the active trace and write it to ``<dir>/trace.json``; returns
    the directory, None when no trace is active."""
    global _active
    with _lock:
        if _active is None:
            return None
        (trace_dir, prof), _active = _active, None
    prof.stop()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    return trace_dir


def active() -> str | None:
    """The active trace's directory, or None."""
    return _active[0] if _active is not None else None


@contextlib.contextmanager
def device_trace(trace_dir: str | None, cuda: bool | None = None) -> Iterator[None]:
    """Trace the enclosed region when ``trace_dir`` is set; no-op otherwise."""
    if not trace_dir:
        yield
        return
    started = start(trace_dir, cuda)
    try:
        yield
    finally:
        if started:
            stop()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span of the trace (``record_function``); costs one
    dispatcher call when no trace is active."""
    with record_function(name):
        yield
