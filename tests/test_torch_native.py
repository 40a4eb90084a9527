"""The port's native codecs (``superllama_tpu_torch/native``) against the JAX
package's numpy codecs and the port's own numpy repack, on the CPU (this
machine class has ``g++``, so the native library really runs here):

 - ``native.dequantize`` / ``native.quantize`` byte-equal to the JAX
   package's numpy ``dequant_*`` / ``quant_*`` functions (called directly,
   so the JAX package's own native build cannot change what is compared)
   for every type the library covers;
 - the port's ``QUANTIZERS`` and ``quantize`` (its native route) byte-equal
   to the JAX ``QUANTIZERS`` for every type, the K-quants also with an
   imatrix row (``SEARCH_IMATRIX``), and the writer encoding float arrays
   to any of them;
 - ``native.repack`` bit-equal to the port's ``_extract`` planes for Q4_0,
   Q8_0, Q4_K, Q5_K and Q6_K (K % 256 ≠ 0 for the 32-wide two), on one
   thread or several; ``repack``'s QTensor equal with and without it;
 - the build: two processes building at once both load the library, a
   broken source or a missing compiler raises with the reason, a failed
   build or load raises from every entry point (no quiet numpy fallback),
   and ``SLT_NO_NATIVE=1`` takes numpy.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from superllama_tpu.gguf import quants as jq
from superllama_tpu_torch import native
from superllama_tpu_torch.gguf import GGUFReader, GGUFWriter
from superllama_tpu_torch.gguf import quants as tq
from superllama_tpu_torch.gguf.constants import GGML_TYPE_TRAITS, GGMLType
from superllama_tpu_torch.models.synthetic import rand_raw
from superllama_tpu_torch.ops import qtensor

T = GGMLType
DEQ_TYPES = [T.Q4_0, T.Q4_1, T.Q5_0, T.Q5_1, T.Q8_0, T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K,
             T.Q6_K, T.Q8_K, T.IQ4_NL, T.IQ4_XS, T.MXFP4, T.TQ1_0, T.TQ2_0, T.IQ2_XXS,
             T.IQ2_XS, T.IQ2_S, T.IQ3_XXS, T.IQ3_S, T.IQ1_S, T.IQ1_M]
ENC_TYPES = [T.Q4_0, T.Q4_1, T.Q5_0, T.Q5_1, T.Q8_0, T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K,
             T.Q6_K, T.Q8_K, T.IQ4_NL, T.MXFP4, T.TQ1_0, T.TQ2_0]
ALL_QUANTIZERS = list(jq.QUANTIZERS)
KQUANTS = [T.Q2_K, T.Q3_K, T.Q4_K, T.Q5_K, T.Q6_K]


def ids(types):
    return [t.name for t in types]


def values(t: GGMLType, n_blocks: int = 16, seed: int = 0) -> np.ndarray:
    """Seeded normal values with a zero block, a constant block and an
    outlier (the encoders' edge cases); two rows."""
    bs = GGML_TYPE_TRAITS[t].block_size
    x = np.random.default_rng(seed).normal(0, 1.5, n_blocks * bs).astype(np.float32)
    x[:bs] = 0.0
    x[bs:2 * bs] = 0.25
    x[2 * bs] = 1e4
    return x.reshape(2, -1)


def test_supported_types():
    """The library decodes the 23 types and encodes the 15 of the JAX
    package's library; the i-quant encoders stay numpy searches."""
    assert [t for t in T if native.available(t)] == sorted(DEQ_TYPES)
    assert [t for t in T if native.available(t, for_encode=True)] == sorted(ENC_TYPES)


@pytest.mark.parametrize("t", DEQ_TYPES, ids=ids(DEQ_TYPES))
def test_native_decode_matches_jax(t):
    tr = GGML_TYPE_TRAITS[t]
    raw = np.random.default_rng(3).integers(0, 256, 64 * tr.type_size).astype(np.uint8)
    with np.errstate(all="ignore"):
        ref = jq.DEQUANTIZERS[t](raw)
    got = native.dequantize(raw, int(t), tr.block_size, tr.type_size)
    # random f16 bytes decode to NaN and inf too: compare the bits
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    np.testing.assert_array_equal(tq.dequantize(raw, t).view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("t", ENC_TYPES, ids=ids(ENC_TYPES))
def test_native_encode_matches_jax(t):
    tr = GGML_TYPE_TRAITS[t]
    x = values(t)
    got = native.quantize(x, int(t), tr.block_size, tr.type_size, threads=3)
    np.testing.assert_array_equal(got, jq.QUANTIZERS[t](x))


@pytest.mark.parametrize("t", ALL_QUANTIZERS, ids=ids(ALL_QUANTIZERS))
def test_quantizers_match_jax(t):
    """The port's numpy encoder and its public ``quantize`` (native where
    the library covers the type) give the JAX encoder's bytes; the writer
    stores them."""
    x = values(t, n_blocks=8 if GGML_TYPE_TRAITS[t].block_size == 256 else 16, seed=1)
    ref = jq.QUANTIZERS[t](x)
    np.testing.assert_array_equal(tq.QUANTIZERS[t](x), ref)
    np.testing.assert_array_equal(tq.quantize(x, t), ref)


@pytest.mark.parametrize("t", KQUANTS, ids=ids(KQUANTS))
def test_imatrix_searches_match_jax(t):
    """With an imatrix row the K-quants run the weighted numpy searches in
    slices of rows; the bytes equal one JAX call over the whole tensor."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (600, 512)).astype(np.float32)
    qw = rng.uniform(0.05, 3.0, 512).astype(np.float32)
    ref = jq.SEARCH_IMATRIX[t](x, qw)
    np.testing.assert_array_equal(tq.quantize(x, t, qw=qw), ref)
    np.testing.assert_array_equal(tq.SEARCH_IMATRIX[t](x[:2], qw), jq.SEARCH_IMATRIX[t](x[:2], qw))


def test_writer_encodes_every_quantizer(tmp_path):
    """A float array given any type of ``QUANTIZERS`` is written as the JAX
    encoder's bytes and reads back as them."""
    w = GGUFWriter(str(tmp_path / "q.gguf"), arch="llama")
    xs = {t: values(t, n_blocks=4, seed=int(t)) for t in ALL_QUANTIZERS}
    for t, x in xs.items():
        w.add_tensor(f"t{int(t)}", x, t)
    w.write()
    r = GGUFReader(str(tmp_path / "q.gguf"))
    try:
        for t, x in xs.items():
            ti = r.tensors[f"t{int(t)}"]
            assert ti.ggml_type == t and ti.shape == x.shape
            np.testing.assert_array_equal(ti.raw().reshape(-1), jq.QUANTIZERS[t](x))
    finally:
        r.close()


REPACK_CASES = [(T.Q4_0, 24, 96), (T.Q4_0, 40, 256), (T.Q8_0, 33, 160), (T.Q8_0, 8, 512),
                (T.Q4_K, 300, 512), (T.Q5_K, 24, 256), (T.Q6_K, 520, 768)]


def plain_planes(raw, t, N, K):
    codes, scales, adds, gs, offset, nibble = qtensor._extract(raw, t, N, K)
    codes = codes.reshape(N, K).T
    codes = qtensor._pack_nib4(codes.astype(np.uint8)) if nibble else codes.astype(np.int8)
    planes = lambda a: None if a is None else np.ascontiguousarray(
        a.reshape(N, K // gs).T, np.float32)
    return codes, planes(scales), planes(adds), gs, offset, nibble


@pytest.mark.parametrize("threads", [1, 0])
@pytest.mark.parametrize("t,N,K", REPACK_CASES,
                         ids=[f"{t.name}-{N}x{K}" for t, N, K in REPACK_CASES])
def test_native_repack_matches_extract(t, N, K, threads):
    raw = rand_raw(t, N, K, seed=N + K)
    got = native.repack(raw, int(t), N, K, threads=threads)
    ref = plain_planes(raw, t, N, K)
    for a, b in zip(got, ref):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
        else:
            assert a == b


@pytest.mark.parametrize("t,N,K", REPACK_CASES[1::2],
                         ids=[f"{t.name}-{N}x{K}" for t, N, K in REPACK_CASES[1::2]])
def test_repack_qtensor_same_with_and_without_native(t, N, K, monkeypatch):
    raw = rand_raw(t, N, K, seed=3)
    got = qtensor.repack(raw, t, (N, K), threads=2)
    monkeypatch.setenv("SLT_NO_NATIVE", "1")
    ref = qtensor.repack(raw, t, (N, K))
    for p in qtensor.QTensor.PLANES:
        a, b = getattr(got, p), getattr(ref, p)
        assert (a is None and b is None) or torch.equal(a, b), p


def test_repack_refuses_what_it_does_not_cover():
    """K-quants need whole superblocks, other types take numpy."""
    assert native.repack(rand_raw(T.Q4_K, 4, 256, 0), int(T.Q4_K), 8, 128) is None
    assert native.repack(rand_raw(T.IQ4_XS, 4, 256, 0), int(T.IQ4_XS), 4, 256) is None


def test_two_processes_build_at_once(tmp_path):
    """Two processes that start building the same source together both load
    the one library; no temporary file is left."""
    src = tmp_path / "tokenizer.cpp"
    src.write_bytes((native.NATIVE_DIR / "tokenizer.cpp").read_bytes())
    code = textwrap.dedent(f"""
        import ctypes, pathlib
        from superllama_tpu_torch import native
        p = native.build(pathlib.Path({str(src)!r}), native.FLAGS["tokenizer"],
                         pathlib.Path({str(tmp_path / "b")!r}))
        ctypes.CDLL(str(p)).slt_bpe_new
        print(p)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0]
    assert sorted(f.suffix for f in (tmp_path / "b").iterdir()) == [".lock", ".so"]


def test_broken_source_raises_with_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for broken.cpp.*error: "):
        native.build(src, native.FLAGS["quants"], tmp_path / "b")
    assert not any((tmp_path / "b").glob("*.so")) and not any((tmp_path / "b").glob("*.tmp"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build(native.NATIVE_DIR / "tokenizer.cpp", ["-O0"], tmp_path / "b")


@pytest.fixture
def failed_library(monkeypatch, tmp_path):
    """The library's build gives a file that is no shared library."""
    bad = tmp_path / "libbad.so"
    bad.write_text("not a library")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "build", lambda src, flags: bad)


def tiny_bpe():
    from superllama_tpu_torch.tokenizer import Tokenizer
    from superllama_tpu_torch.tokenizer.vocab import TokenAttr, Vocab

    tokens = [chr(c) for c in range(33, 127)] + ["hi"]
    return Tokenizer(Vocab(model="gpt2", pre="default", tokens=tokens,
                           scores=[0.0] * len(tokens),
                           attrs=[TokenAttr.NORMAL] * len(tokens), merges=["h i"]))


ENTRIES = {
    "dequantize": lambda: tq.dequantize(rand_raw(T.Q4_0, 2, 64, 0), T.Q4_0),
    "quantize": lambda: tq.quantize(np.ones((2, 64), np.float32), T.Q8_0),
    "repack": lambda: qtensor.repack(rand_raw(T.Q4_K, 2, 256, 0), T.Q4_K, (2, 256)),
    "tokenizer": lambda: tiny_bpe().encode("hi"),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_failed_load_raises_everywhere(failed_library, entry):
    """No entry point falls back to numpy (or Python) when the library
    cannot load."""
    with pytest.raises(RuntimeError, match="loading .*libbad.so failed"):
        ENTRIES[entry]()


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_no_native_takes_numpy(failed_library, entry, monkeypatch):
    """``SLT_NO_NATIVE=1`` never touches the library."""
    monkeypatch.setenv("SLT_NO_NATIVE", "1")
    ENTRIES[entry]()
