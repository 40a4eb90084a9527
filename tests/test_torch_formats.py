"""Port parity of every GGUF weight format the JAX package serves: the
decoders, the repack, the GGUF writer and the split tool, and the matmul
kernels' plain versions and wrappers for the twenty formats beyond Q8_0,
Q4_K and Q6_K.

Inputs are seeded numpy floats quantized by the JAX package's ``quant_*``
(and, for the decoders, seeded random block bytes from ``rand_raw``). The
JAX side runs its Pallas kernels in interpret mode, as its own tests do; the
port runs the kernels' plain versions (CPU tensors). Tolerances, as
``tests/test_torch_qmatmul.py`` states them:
 - decoders, repack planes, dequant, the writer's bytes: bit-exact (the
   activation quantizer at every group size: ``test_torch_qmatmul.py``);
 - ``qmv_plain`` against JAX ``_qmatmul_mv``: NMSE < 1e-10 (exact integer
   group dots, f32 sums in another order);
 - ``qmm_plain`` against JAX ``_qmatmul_2d``: NMSE < 1e-7.
The CUDA kernels themselves run only on a GPU (``chip_smoke.py``); here
CUDA-typed CPU tensors and a recording stand-in for their libraries show
what the wrappers launch.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from test_torch_fixtures import cuda_typed, failing_build

from superllama_tpu.gguf import GGMLType, quantize
from superllama_tpu.gguf import quants as jq
from superllama_tpu.gguf.writer import GGUFWriter as JaxWriter
from superllama_tpu.ops import qtensor as jqt
from superllama_tpu.ops.qmatmul import _qmatmul_2d, _qmatmul_mv
from superllama_tpu.tools import gguf_split as jsplit
from superllama_tpu_torch.convert import _qtensor
from superllama_tpu_torch.gguf import GGUFReader, GGUFWriter
from superllama_tpu_torch.gguf.constants import KVALUES_IQ4NL
from superllama_tpu_torch.gguf import quants as tq
from superllama_tpu_torch.models import synthetic as syn
from superllama_tpu_torch.models.synthetic import rand_raw
from superllama_tpu_torch.ops import _build
from superllama_tpu_torch.ops import qmatmul as qm
from superllama_tpu_torch.ops import qtensor as tqt
from superllama_tpu_torch.tools import gguf_split as tsplit

NEW = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.MXFP4,
       GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S,
       GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M, GGMLType.Q2_K,
       GGMLType.Q3_K, GGMLType.Q5_K, GGMLType.Q8_K, GGMLType.TQ1_0, GGMLType.TQ2_0]
ALL = sorted(tqt.REPACKABLE)
ID = lambda t: t.name
# the kernel family of each new format, and its group size and adds
FAMILY = {t: 3 for t in NEW}
FAMILY.update({GGMLType.Q4_0: 4, GGMLType.Q4_1: 4, GGMLType.Q5_K: 5})
# (K, N) of the kernel-parity cells: K 256-512, N 64-128
KN = {t: ((512, 64) if i % 2 else (256, 128)) for i, t in enumerate(NEW)}


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _weights(ttype, N, K, seed=0):
    rng = np.random.default_rng(int(ttype) * 7 + N + K + seed)
    w = (rng.normal(0, 0.4, (N, K)) + 0.05 * np.cos(np.arange(K))).astype(np.float32)
    raw = quantize(w, ttype)
    return raw, jqt.repack(raw, ttype, (N, K)), tqt.repack(raw, ttype, (N, K))


def _x(M, K, seed=0):
    return np.random.default_rng(M * 7 + K + seed).normal(0, 1, (M, K)).astype(np.float32)


# --- tables, grids, decoders -------------------------------------------------


def test_format_tables_match_jax():
    """REPACKABLE (23 types) and COMPACT (3) are the JAX package's, and the
    decoders cover every type the JAX package decodes."""
    assert tqt.REPACKABLE == jqt.REPACKABLE and len(tqt.REPACKABLE) == 23
    assert tqt.COMPACT == jqt.COMPACT == {GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K}
    assert set(tq.DEQUANTIZERS) == set(jq.DEQUANTIZERS)
    assert set(qm._FMT) == tqt.REPACKABLE


def test_iq_grids_match_jax():
    """The port's copy of iq_grids.npz holds the JAX file's arrays, and the
    tables derived from it (grids, sign bytes, the IQ1 delta) are equal."""
    import os

    paths = [os.path.join(os.path.dirname(m.__file__), "iq_grids.npz") for m in (jq, tq)]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in jq._iq_grids().items():
        np.testing.assert_array_equal(tq._iq_grids()[k], v, err_msg=k)
        assert tq._iq_grids()[k].dtype == v.dtype
    np.testing.assert_array_equal(tq._KSIGNS, jq._KSIGNS)
    assert tq._IQ1_DELTA == jq._IQ1_DELTA


@pytest.mark.parametrize("ttype", NEW + [GGMLType.F64], ids=ID)
def test_dequantize_bitexact(ttype):
    """The port's decoder of a JAX-quantized tensor equals the JAX decoder
    bit for bit (and ``dequantize`` reshapes as the JAX one does)."""
    x = np.random.default_rng(int(ttype)).normal(0, 1, (4, 512)).astype(np.float32)
    raw = (x.astype("<f8").view(np.uint8).reshape(-1) if ttype == GGMLType.F64
           else quantize(x, ttype))
    ref = jq.DEQUANTIZERS[ttype](raw)
    np.testing.assert_array_equal(tq.DEQUANTIZERS[ttype](raw), ref)
    np.testing.assert_array_equal(tq.dequantize(raw, ttype, (4, 512)), ref.reshape(4, 512))


@pytest.mark.parametrize("ttype", NEW, ids=ID)
def test_random_blocks_decode_alike(ttype):
    """rand_raw's seeded random block bytes (every bit pattern of codes,
    sub-scales and grid indices; sane d fields) decode alike in both
    packages, finite, at the std rand_raw aims for."""
    N, K = 16, 512
    raw = rand_raw(ttype, N, K, seed=3)
    got = tq.DEQUANTIZERS[ttype](raw)
    np.testing.assert_array_equal(got, jq.DEQUANTIZERS[ttype](raw))
    assert np.isfinite(got).all()
    assert 0.3 < float(np.std(got)) * np.sqrt(K) / 0.6 < 3.0
    assert np.array_equal(rand_raw(ttype, N, K, seed=3), raw)


# --- repack --------------------------------------------------------------------


@pytest.mark.parametrize("ttype", NEW, ids=ID)
def test_repack_planes_bitexact(ttype):
    """Every plane of the port's repack equals the JAX repack's byte for
    byte, with the same group, offset, nibble and compact fields; the plain
    dequant of both is equal."""
    _, j, t = _weights(ttype, 64, 512)
    for name in tqt.QTensor.PLANES:
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert str(b.dtype).split(".")[-1] == str(np.asarray(a).dtype), name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    for attr in ("group", "offset", "nibble", "K", "N", "hi_bits", "sb"):
        assert getattr(t, attr) == getattr(j, attr), attr
    np.testing.assert_array_equal(tqt.dequant_qtensor(t).numpy(),
                                  np.asarray(jqt.dequant_qtensor(j)))


@pytest.mark.parametrize("ttype", [GGMLType.IQ4_XS, GGMLType.Q4_0, GGMLType.Q5_K,
                                   GGMLType.IQ1_M], ids=ID)
def test_jax_qtensor_converts_unchanged(ttype):
    """The conversion of JAX parameters (convert.py) carries a JAX QTensor
    of each family (int8 planar, nibble planar, Q5_K with its hi plane; IQ1_M
    with adds at gs 8) plane for plane."""
    _, j, t = _weights(ttype, 64, 256)
    c = _qtensor(jax.tree_util.tree_map(np.asarray, j), "cpu")
    for name in tqt.QTensor.PLANES:
        a, b = getattr(c, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert (c.group, c.offset, c.nibble, c.hi_bits, c.sb, c.ggml_type) == (
        t.group, t.offset, t.nibble, t.hi_bits, t.sb, t.ggml_type)


# --- the kernels' plain versions against the JAX kernels -------------------


@pytest.mark.parametrize("ttype", NEW, ids=ID)
def test_qmv_plain_matches_jax(ttype):
    """The GEMV's plain version against the JAX kernel in interpret mode
    (its act_quant regime), 5 rows."""
    K, N = KN[ttype]
    _, j, t = _weights(ttype, N, K)
    x = _x(5, K)
    ref = np.asarray(_qmatmul_mv(jnp.asarray(np.pad(x, ((0, 3), (0, 0)))), j,
                                 interpret=True))[:5]
    got = qm.qmatmul(torch.from_numpy(x), t, act_quant=True)
    assert got.shape == (5, N)
    assert _nmse(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("ttype", NEW, ids=ID)
def test_qmm_plain_matches_jax(ttype):
    """The fused dequant + matmul's plain version against the JAX kernel in
    interpret mode, 24 rows in f32."""
    K, N = KN[ttype]
    _, j, t = _weights(ttype, N, K)
    x = _x(24, K)
    ref = np.asarray(_qmatmul_2d(jnp.asarray(x), j, interpret=True))
    got = qm.qmatmul(torch.from_numpy(x), t, force_fused=True)
    assert got.shape == (24, N)
    assert _nmse(got.numpy(), ref) < 1e-7


# --- the wrappers on CUDA tensors -----------------------------------------------


def _cuda(t):
    return dataclasses.replace(t, **{n: cuda_typed(p) for n, p in t.planes().items()})


# each type's repacked planes as the kernels read them: (code bits, hi
# bits, group, scale source, adds, offset)
LAYOUT = {t: (8, 0, 32, "plane", False, 0) for t in (
    GGMLType.Q8_0, GGMLType.Q5_0, GGMLType.MXFP4, GGMLType.IQ4_NL, GGMLType.IQ4_XS,
    GGMLType.IQ2_XXS, GGMLType.IQ3_XXS, GGMLType.IQ3_S)}
LAYOUT.update({GGMLType.Q5_1: (8, 0, 32, "plane", True, 0),
               GGMLType.IQ1_S: (8, 0, 32, "plane", True, 0),
               GGMLType.IQ1_M: (8, 0, 8, "plane", True, 0),
               GGMLType.Q2_K: (8, 0, 16, "plane", True, 0),
               GGMLType.Q3_K: (8, 0, 16, "plane", False, 0),
               GGMLType.IQ2_XS: (8, 0, 16, "plane", False, 0),
               GGMLType.IQ2_S: (8, 0, 16, "plane", False, 0),
               GGMLType.Q8_K: (8, 0, 256, "plane", False, 0),
               GGMLType.TQ1_0: (8, 0, 256, "plane", False, 0),
               GGMLType.TQ2_0: (8, 0, 256, "plane", False, 0),
               GGMLType.Q4_0: (4, 0, 32, "plane", False, 8),
               GGMLType.Q4_1: (4, 0, 32, "plane", True, 0),
               GGMLType.Q4_K: (4, 0, 32, "superblock", True, 0),
               GGMLType.Q5_K: (4, 1, 32, "superblock", True, 0),
               GGMLType.Q6_K: (4, 2, 16, "superblock", False, 32)})


@pytest.mark.parametrize("ttype", ALL, ids=ID)
def test_layout_matches_the_repacked_planes(ttype):
    """``_FMT`` describes each of the 23 types by the planes its repack
    makes: code width (int8 codes (K, N) or nibbles (K/2, N)), hi bits and
    the hi plane's rows, group size and the scale planes' rows, f32 planes
    or superblock sub-scales, adds (the plane or the mins) and offset; and
    ``layout`` reads the same description off the QTensor's fields."""
    K, N = 512, 64
    t = tqt.repack(rand_raw(ttype, N, K, 9), ttype, (N, K))
    lay = qm._FMT[ttype]
    assert tuple(lay) == LAYOUT[ttype] and qm.layout(t) == lay
    assert t.codes.shape == ((K // 2, N) if lay.code_bits == 4 else (K, N))
    assert t.codes.dtype == (torch.uint8 if lay.code_bits == 4 else torch.int8)
    assert (t.hi is None) == (lay.hi_bits == 0)
    if t.hi is not None:
        assert t.hi.shape == (K * lay.hi_bits // 8, N)
    if lay.scales == "plane":
        assert t.scales.shape == (K // lay.group, N) and t.sc is None
        assert (t.adds is not None) == lay.adds
        if lay.adds:
            assert t.adds.shape == (K // lay.group, N)
    else:
        assert t.scales is None and t.sc.shape == (K // lay.group, N)
        assert t.d.shape == (K // 256, N)
        assert (t.mn is not None) == (t.dmin is not None) == lay.adds
    assert t.offset == lay.offset


@pytest.mark.parametrize("ttype", ALL, ids=ID)
def test_check_weight_gives_a_format_id(ttype):
    """Every REPACKABLE type has a kernel format: the layout both kernels
    read (``qmv_fmt``), 0-2 for the three redesigned ones, 0 also for the
    gs-32 int8 formats without adds."""
    _, _, t = _weights(ttype, 64, 256)
    fmt = qm._check_weight(cuda_typed(torch.zeros((1, 256))), _cuda(t))
    assert fmt == qm.qmv_fmt(qm._FMT[ttype])
    assert fmt == {GGMLType.Q8_0: 0, GGMLType.Q4_K: 1, GGMLType.Q6_K: 2}.get(ttype, fmt)


class _Recorder:
    """Stands in for a kernel's C entry: records each call's arguments."""

    def __init__(self):
        self.calls = []
        self.argtypes = None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_libs(monkeypatch):
    """CUDA-typed tensors reach recording qmv / qmm libraries; torch.empty
    records every allocation; the plain versions raise if reached."""
    recs = {"qmv": _Recorder(), "qmm": _Recorder(), "qmm_tc": _Recorder()}
    libs = {"qmv": types.SimpleNamespace(slt_qmv=recs["qmv"]),
            "qmm": types.SimpleNamespace(slt_qmm=recs["qmm"], slt_qmm_tc=recs["qmm_tc"])}
    monkeypatch.setattr(_build, "load", lambda name: libs[name])
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 7)
    allocs = recs["allocs"] = []
    empty = torch.empty

    def recording_empty(*a, **kw):
        t = cuda_typed(empty(*a, **{k: v for k, v in kw.items() if k != "device"}))
        allocs.append(t)
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(qm, "qmv_plain", plain)
    monkeypatch.setattr(qm, "qmm_plain", plain)
    return recs


@pytest.mark.parametrize("ttype", NEW, ids=ID)
def test_wrappers_pass_the_planar_layout(fake_libs, ttype):
    """qmv launches its one kernel once, with the layout's format, the plan,
    the planes (adds included) and the offset, and allocates only the
    output (no split-K partials); qmm's tensor-core (bf16 x) and CUDA-core
    (f32 x) entries get the same layout, adds, group size and offset; each
    launch adds one to the wrapper's count and to its family's."""
    K, N = 1024, 128
    _, _, t = _weights(ttype, N, K)
    t = _cuda(t)
    fam = qm._FAMILY[FAMILY[ttype]]
    ptr = lambda n: None if getattr(t, n) is None else getattr(t, n).data_ptr()
    x = cuda_typed(torch.zeros((8, K), dtype=torch.bfloat16))
    before = (qm.qmv.launches, getattr(qm.qmv, f"launches_{fam}"))
    qm.qmv(x, t, torch.bfloat16)
    assert (qm.qmv.launches, getattr(qm.qmv, f"launches_{fam}")) == (before[0] + 1,
                                                                     before[1] + 1)
    (a,) = fake_libs["qmv"].calls
    kfmt = qm.qmv_fmt(qm._FMT[ttype])
    assert kfmt >= 3 or qm._FMT[ttype] == qm._FMT[GGMLType.Q8_0]
    assert a[:4] == (kfmt, 8, K, N) and a[5] == 1
    assert a[6:14] == tuple(ptr(n) for n in ("codes", "hi", "scales", "sc", "mn", "d", "dmin",
                                             "adds"))
    assert a[14] == t.offset
    assert a[15:18] == tuple(qm.qmv_plan(kfmt, K, N)[:3])
    assert [tuple(o.shape) for o in fake_libs["allocs"]] == [(8, N)]
    for dt, entry in ((torch.bfloat16, "qmm_tc"), (torch.float32, "qmm")):
        before = getattr(qm.qmm, f"launches_{fam}")
        qm.qmm(cuda_typed(torch.zeros((24, K), dtype=dt)), t, dt)
        assert getattr(qm.qmm, f"launches_{fam}") == before + 1
        (a,) = fake_libs[entry].calls
        assert a[0] == kfmt
        i = 12 if entry == "qmm_tc" else 13
        assert a[i:i + 3] == (ptr("adds"), t.group, t.offset)


@pytest.mark.parametrize("ttype", [GGMLType.IQ1_M, GGMLType.Q4_1, GGMLType.Q5_K], ids=ID)
def test_failed_build_raises(monkeypatch, ttype):
    """A CUDA tensor of a new format goes to its kernel: a failed build
    raises, and no plain version runs."""
    build_failed = failing_build(monkeypatch)
    _, _, t = _weights(ttype, 64, 512)
    t = _cuda(t)
    for dt in (torch.float32, torch.bfloat16):
        x = cuda_typed(torch.zeros((4, 512), dtype=dt))
        for fn in (qm.qmv, qm.qmm):
            with pytest.raises(build_failed):
                fn(x, t, torch.float32)


# --- the chip smoke's serving mixes ---------------------------------------------


@pytest.mark.parametrize("ttype", [GGMLType.Q4_0, GGMLType.Q4_K, GGMLType.Q5_K,
                                   GGMLType.Q6_K, GGMLType.IQ4_XS], ids=ID)
def test_rand_planes_has_the_repack_layout(ttype):
    """``rand_planes`` (the serving mixes' weights, made on the device)
    gives what the port's repack gives the same type: the same planes,
    dtypes and shapes, the same group, offset, nibble, hi_bits and sb; its
    dequantized weight a std of about 0.6/sqrt(K), and IQ4_XS codes from
    the IQ4_NL codebook."""
    K, N = 512, 64
    got = syn.rand_planes(ttype, "w", N, K, seed=3, device="cpu")
    ref = tqt.repack(rand_raw(ttype, N, K, 3), ttype, (N, K))
    for name in tqt.QTensor.PLANES:
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert (a.dtype, a.shape) == (b.dtype, b.shape), name
    for attr in ("ggml_type", "group", "offset", "nibble", "hi_bits", "sb", "K", "N"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    std = float(tqt.dequant_qtensor(got).std()) * np.sqrt(K)
    assert 0.3 < std < 1.2, std
    if ttype == GGMLType.IQ4_XS:
        assert set(got.codes.unique().tolist()) <= set(KVALUES_IQ4NL)


@pytest.mark.parametrize("mix", sorted(syn.MIXES))
def test_synthetic_mix_types_and_forward(mix):
    """``synthetic_qparams_mix`` at small widths (one layer, every K a
    multiple of 256): each weight of its mix's type by role, in the
    forward's (K, N); a bf16 token_embd; a prefill's logits finite."""
    from superllama_tpu_torch.models.llama import llama_forward
    from superllama_tpu_torch.runtime.kv_cache import kv_cache_init

    hp = syn.tiny_test_hparams(n_layer=1, n_embd=256, n_ff=512, n_head=4, n_head_kv=2,
                               head_dim=64, head_dim_v=64, n_rot=64)
    p = syn.synthetic_qparams_mix(hp, mix, seed=5, device="cpu")
    block_type, head_type, _ = syn.MIXES[mix]
    E, F, V = hp.n_embd, hp.n_ff, hp.n_vocab
    want = {"output": (head_type, E, V)}
    want.update({role: (block_type(role), K, N) for role, K, N in (
        ("wq", E, 256), ("wk", E, 128), ("wv", E, 128), ("wo", 256, E),
        ("ffn_gate", E, F), ("ffn_up", E, F), ("ffn_down", F, E))})
    for name, (t, K, N) in want.items():
        qt = p["output"] if name == "output" else p["layers"][0][name]
        assert (qt.ggml_type, qt.K, qt.N) == (t, K, N), name
    emb = p["token_embd"]
    assert emb.dtype == torch.bfloat16 and emb.shape == (V, E)
    cache = kv_cache_init(1, 1, 64, hp.n_head_kv, hp.head_dim)
    tokens = torch.arange(8)[None]
    logits, _ = llama_forward(p, hp, tokens, torch.arange(8, dtype=torch.int32)[None], cache)
    assert logits.shape[-1] == V and torch.isfinite(logits).all()


# --- the GGUF writer and the split tool -----------------------------------------


def _write(cls, path, tensors):
    w = cls(str(path), arch="llama")
    w.add("general.name", "t")
    w.add("llama.block_count", 2)
    w.add("llama.rope.freq_base", 10000.0)
    w.add("tokenizer.ggml.tokens", ["a", "b", "<s>"])
    w.add("tokenizer.ggml.scores", np.array([0.0, -1.0, -2.0], np.float32))
    w.add("neg", -3)
    w.add("flag", True)
    w.add("big", 2 ** 40)
    w.add("general.name", "tiny")          # overwrite: last write wins
    for name, (data, t, ne) in tensors.items():
        if ne is None:
            w.add_tensor(name, data, t)
        else:
            w.add_tensor(name, data, t, raw_ne=ne)
    w.write()


def test_writer_bytes_match_jax(tmp_path):
    """The same metadata and tensors (pre-packed block bytes, float arrays
    encoded to F32, F16, BF16 and a block format) give the same file bytes;
    a type without an encoder raises."""
    rng = np.random.default_rng(0)
    f = rng.normal(0, 1, (3, 64)).astype(np.float32)
    tensors = {"a.weight": (quantize(rng.normal(0, 1, (2, 256)).astype(np.float32),
                                     GGMLType.IQ4_XS), GGMLType.IQ4_XS, (256, 2)),
               "b.weight": (f, GGMLType.F32, None), "c.weight": (f, GGMLType.F16, None),
               "d.weight": (f, GGMLType.BF16, None), "e.weight": (f, GGMLType.Q4_0, None)}
    _write(JaxWriter, tmp_path / "j.gguf", tensors)
    _write(GGUFWriter, tmp_path / "t.gguf", tensors)
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()
    with pytest.raises(NotImplementedError):
        GGUFWriter(str(tmp_path / "x.gguf")).add_tensor("q", f, GGMLType.F64)


@pytest.mark.parametrize("path", ["/m/x.gguf", "/m/x-00001-of-00003.gguf",
                                  "/m/x-00003-of-00003.gguf", "x-00002-of-00002.gguf"])
def test_shard_paths_match_jax(path):
    assert tsplit.shard_paths(path) == jsplit.shard_paths(path)
    assert tsplit.shard_name("p", 1, 4) == jsplit.shard_name("p", 1, 4)


def test_split_and_merge_match_jax(tmp_path):
    """The port's split_gguf writes the JAX tool's shard bytes, and its
    merge_gguf puts the tensors back (same names, types and bytes)."""
    rng = np.random.default_rng(1)
    tensors = {f"t{i}.weight": (quantize(rng.normal(0, 1, (2, 256)).astype(np.float32),
                                         GGMLType.Q4_0), GGMLType.Q4_0, (256, 2))
               for i in range(5)}
    src = tmp_path / "m.gguf"
    _write(GGUFWriter, src, tensors)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jp = jsplit.split_gguf(str(src), str(tmp_path / "j" / "m"), n_split=3)
    tp = tsplit.split_gguf(str(src), str(tmp_path / "t" / "m"), n_split=3)
    assert [p.rsplit("/", 1)[1] for p in tp] == [p.rsplit("/", 1)[1] for p in jp]
    for a, b in zip(tp, jp):
        assert open(a, "rb").read() == open(b, "rb").read()
    tsplit.merge_gguf(tp[1], str(tmp_path / "merged.gguf"))
    r0, r1 = GGUFReader(str(src)), GGUFReader(str(tmp_path / "merged.gguf"))
    try:
        assert list(r1.tensors) == list(r0.tensors)
        for name, ti in r0.tensors.items():
            assert r1.tensors[name].ggml_type == ti.ggml_type
            assert np.array_equal(r1.tensors[name].raw(), ti.raw())
        assert "split.count" not in r1.metadata
    finally:
        r0.close()
        r1.close()
