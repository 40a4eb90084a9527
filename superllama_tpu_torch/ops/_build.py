"""Build and load the port's CUDA kernels.

Each source ``superllama_tpu_torch/csrc/<name>.cu`` has a plain C interface
and compiles with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/superllama_tpu_torch/`` at the repo root, at first use. The library
file name carries a hash of the source and flags, so an edited source
rebuilds and an unchanged one loads at once. Libraries load with ``ctypes``.
Every C entry point returns the ``cudaError_t`` of its launch; ``check``
raises on anything but 0.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "superllama_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("qmv", "qmm", "fa", "fd", "paged", "qmv_probe", "gmm", "ssm_scan", "wkv")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
SECONDS: dict[str, float] = {}   # nvcc seconds of each source this process built


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build with "
                       "the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for hdr in sorted(CSRC.glob("*.cuh")):
        src += hdr.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start one nvcc process for csrc/<name>.cu, its output going to a log
    file beside the library (no pipe to fill); None if already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = tmp.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name: str, job) -> str:
    proc, tmp, out, logf = job
    proc.wait()
    log = logf.read_text()
    logf.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named source at once (one nvcc each, all started
    together) and load them. Returns the compiler log of each source built;
    ``SECONDS`` gets each one's time from the start to its nvcc's exit."""
    with _lock:
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in names if n not in _libs}
        running = {n: j for n, j in jobs.items() if j is not None}
        while running:
            for n in [n for n, j in running.items() if j[0].poll() is not None]:
                SECONDS[n] = time.perf_counter() - t0
                del running[n]
            time.sleep(0.05)
        logs = {n: _finish(n, j) for n, j in jobs.items() if j is not None}
        for n in jobs:
            _libs[n] = ctypes.CDLL(str(_lib_path(n)))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def sm_count(device) -> int:
    """Streaming multiprocessors of the card a CUDA device names."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
