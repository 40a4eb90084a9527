"""The port's native (C++) codecs and tokenizer core, bound with ctypes.

``quants.cpp`` decodes, encodes and repacks the ggml block formats on every
core; ``tokenizer.cpp`` runs the SPM and BPE merge loops. Both are the
port's own copies of the JAX package's sources (the codecs take a thread
count and spread a repack over column slices). The numpy codecs of
``gguf/quants.py``, ``gguf/kquant_search.py`` and
``ops/qtensor.py::_extract`` and the Python tokenizer stay the plain
versions: the native results are bit-identical to them (the tests hold
them so).

Each source compiles with ``g++`` at first use into ``build/superllama_tpu_torch/``
at the repo root, as ``ops/_build.py`` builds the CUDA kernels: the library
name carries a hash of the source and flags, the compiler writes to a file
named for its process, and a file lock lets one process build while the
others wait (pytest-xdist workers start together). A failed build or load
raises with the compiler's output. Nothing is built at import.

Two cases take numpy: a type ``slq_supported`` does not cover (numpy is its
only route; ``dequantize`` / ``quantize`` / ``repack`` return None), and
the explicit opt-out ``SLT_NO_NATIVE=1`` (every entry returns None, the
tokenizer keeps its Python paths).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent.parent / "build" / "superllama_tpu_torch"
FLAGS = {
    # -ffp-contract=off: the weighted K-quant searches must stay bit-identical
    # to numpy (a fused multiply-add changes their sums and flips decisions)
    "quants": ["-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-pthread"],
    "tokenizer": ["-O3", "-std=c++17", "-shared", "-fPIC"],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def disabled() -> bool:
    """True when ``SLT_NO_NATIVE`` asks for the numpy and Python paths."""
    return bool(os.environ.get("SLT_NO_NATIVE"))


def cxx_path() -> str:
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if not cxx:
        raise RuntimeError(f"{os.environ.get('CXX') or 'g++'} not found: the port's "
                           f"native codecs build with a C++17 compiler (set CXX)")
    return cxx


def lib_path(src: Path, flags: list[str], build_dir: Path = BUILD_DIR) -> Path:
    tag = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return build_dir / f"lib{src.stem}-{tag}.so"


def build(src: Path, flags: list[str], build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` into a shared library under ``build_dir`` unless it is
    there; returns its path. Raises RuntimeError with the compiler's output
    when g++ fails."""
    out = lib_path(src, flags, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when the file closes
        if out.exists():                      # another process built it
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            r = subprocess.run([cxx_path(), *flags, str(src), "-o", str(tmp)],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed for {src.name} (exit {r.returncode}):\n"
                                   f"{r.stdout}{r.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(NATIVE_DIR / f"{name}.cpp", FLAGS[name])
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading {path} failed: {e}") from e
            _BIND[name](lib)
            _libs[name] = lib
    return lib


# ------------------------------------------------------------------ codecs

def _bind_quants(lib: ctypes.CDLL) -> None:
    i, i64, p = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    for fn, args in (("slq_supported", [i, i]),
                     ("slq_dequantize", [i, p, i64, p, i]),
                     ("slq_quantize", [i, p, i64, p, i]),
                     ("slq_repack", [i, p, i64, i64, p, p, p, i]),
                     ("slq_set_iq_grids", [p] * 6)):
        getattr(lib, fn).restype = i
        getattr(lib, fn).argtypes = args
    _inject_iq_grids(lib)


def _inject_iq_grids(lib: ctypes.CDLL) -> None:
    """Hand the i-quant lattice codebooks (the port's gguf/iq_grids.npz) to
    the C++ decoders."""
    with np.load(NATIVE_DIR.parent / "gguf" / "iq_grids.npz") as z:
        bufs = [np.ascontiguousarray(z[k].view(np.uint8))
                for k in ("iq2xxs_grid", "iq2xs_grid", "iq2s_grid",
                          "iq3xxs_grid", "iq3s_grid", "iq1s_grid")]
    lib.slq_set_iq_grids(*[b.ctypes.data for b in bufs])


def available(ttype: int, for_encode: bool = False) -> bool:
    """Whether the native library decodes (or encodes) ``ttype``."""
    return not disabled() and bool(load("quants").slq_supported(int(ttype), int(for_encode)))


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"{what} refused its arguments (rc {rc})")


def dequantize(raw: np.ndarray, ttype: int, block_size: int, type_size: int,
               threads: int = 0) -> np.ndarray | None:
    """Decode block bytes to f32 on ``threads`` threads (0: every core);
    None when the type is not native."""
    if not available(ttype):
        return None
    raw = np.ascontiguousarray(raw.reshape(-1), dtype=np.uint8)
    out = np.empty(raw.size // type_size * block_size, np.float32)
    _check(load("quants").slq_dequantize(int(ttype), raw.ctypes.data, raw.size,
                                         out.ctypes.data, int(threads)),
           f"slq_dequantize of type {int(ttype)}")
    return out


def quantize(x: np.ndarray, ttype: int, block_size: int, type_size: int,
             threads: int = 0) -> np.ndarray | None:
    """Encode f32 values to block bytes; None when the type has no native
    encoder."""
    if not available(ttype, for_encode=True):
        return None
    x = np.ascontiguousarray(x.reshape(-1), dtype=np.float32)
    out = np.empty(x.size // block_size * type_size, np.uint8)
    _check(load("quants").slq_quantize(int(ttype), x.ctypes.data, x.size,
                                       out.ctypes.data, int(threads)),
           f"slq_quantize of type {int(ttype)}")
    return out


# (gs, offset, nibble) of the natively repackable types: Q4_0, Q8_0, Q4_K,
# Q5_K, Q6_K
_REPACK_META = {2: (32, 8, True), 8: (32, 0, False), 12: (32, 0, True),
                13: (32, 0, False), 14: (16, 0, False)}


def repack(raw: np.ndarray, ttype: int, N: int, K: int, threads: int = 0):
    """The load-path repack of a (N, K) weight's block bytes into
    ``ops/qtensor.py``'s planes: (codes, scales, adds, gs, offset, nibble),
    bit-identical to ``_extract`` followed by the transpose and nibble
    packing; None for a type (or a K-quant with K % 256) it does not cover."""
    meta = _REPACK_META.get(int(ttype))
    if disabled() or meta is None or K % 256 and int(ttype) not in (2, 8):
        return None
    gs, offset, nibble = meta
    raw = np.ascontiguousarray(raw.reshape(-1), dtype=np.uint8)
    codes = np.empty((K // 2 if nibble else K, N), np.uint8)
    scales = np.empty((K // gs, N), np.float32)
    adds = np.empty((K // gs, N), np.float32) if int(ttype) in (12, 13) else None
    _check(load("quants").slq_repack(int(ttype), raw.ctypes.data, N, K, codes.ctypes.data,
                                     scales.ctypes.data,
                                     adds.ctypes.data if adds is not None else None,
                                     int(threads)),
           f"slq_repack of type {int(ttype)} at (N, K) = ({N}, {K})")
    return codes if nibble else codes.view(np.int8), scales, adds, gs, offset, nibble


# --------------------------------------------------------------- tokenizer

def _bind_tokenizer(lib: ctypes.CDLL) -> None:
    p, i32, i64, s = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p
    lib.slt_spm_new.restype = p
    lib.slt_spm_new.argtypes = [s, p, p, p, i32, p, i32]
    lib.slt_spm_free.argtypes = [p]
    lib.slt_spm_encode.restype = i32
    lib.slt_spm_encode.argtypes = [p, s, i64, p, i32]
    lib.slt_bpe_new.restype = p
    lib.slt_bpe_new.argtypes = [s, p, i32, s, p, i32]
    lib.slt_bpe_free.argtypes = [p]
    lib.slt_bpe_encode_word.restype = i32
    lib.slt_bpe_encode_word.argtypes = [p, s, i64, p, i32]


_BIND = {"quants": _bind_quants, "tokenizer": _bind_tokenizer}


def _blob(strings: list[str]) -> tuple[bytes, np.ndarray]:
    enc = [s.encode("utf-8") for s in strings]
    off = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=off[1:])
    return b"".join(enc), off


def _encode(fn, h, data: bytes) -> list[int]:
    out = np.empty(max(len(data) * 2, 16), np.int32)
    n = fn(h, data, len(data), out.ctypes.data, out.size)
    if n > out.size:          # more ids than the guess: again at the exact size
        out = np.empty(n, np.int32)
        n = fn(h, data, len(data), out.ctypes.data, out.size)
    return out[:n].tolist()


class NativeSPM:
    """Native SPM tokenize: the ids of ``Tokenizer._spm_tokenize``'s Python
    path."""

    def __init__(self, vocab):
        self._lib = lib = load("tokenizer")
        blob, off = _blob(vocab.tokens)
        scores = np.asarray(vocab.scores, np.float32)
        normal = np.asarray([1 if vocab.is_normal(i) else 0
                             for i in range(vocab.n_tokens)], np.uint8)
        bytes_map = np.asarray([vocab.byte_to_token(b) for b in range(256)], np.int32)
        self._h = lib.slt_spm_new(blob, off.ctypes.data, scores.ctypes.data,
                                  normal.ctypes.data, vocab.n_tokens, bytes_map.ctypes.data,
                                  vocab.unk_id if vocab.unk_id >= 0 else 0)

    def encode(self, text: str) -> list[int]:
        return _encode(self._lib.slt_spm_encode, self._h, text.encode("utf-8"))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.slt_spm_free(self._h)


class NativeBPE:
    """Native BPE merge and lookup of one byte-encoded word: the ids of
    ``Tokenizer._bpe_tokenize``'s Python path for that word."""

    def __init__(self, vocab):
        self._lib = lib = load("tokenizer")
        tblob, toff = _blob(vocab.tokens)
        mblob, moff = _blob(vocab.merges)
        self._h = lib.slt_bpe_new(tblob, toff.ctypes.data, vocab.n_tokens,
                                  mblob, moff.ctypes.data, len(vocab.merges))

    def encode_word(self, enc: str) -> list[int]:
        return _encode(self._lib.slt_bpe_encode_word, self._h, enc.encode("utf-8"))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.slt_bpe_free(self._h)


def native_spm(vocab) -> NativeSPM | None:
    """The native SPM core of ``vocab``; None only under ``SLT_NO_NATIVE``."""
    return None if disabled() else NativeSPM(vocab)


def native_bpe(vocab) -> NativeBPE | None:
    """The native BPE core of ``vocab``; None only under ``SLT_NO_NATIVE``."""
    return None if disabled() else NativeBPE(vocab)
