"""The qmv kernel's grid (``qmv_plan``) and its wrapper's one launch for
every weight format, then ``qmv_plain`` and ``quantize_acts`` against the
JAX package at K 4096.

``qmv_plan`` runs here as it runs on the card (it is a function of the
kernel's format and the weight's shape only). The kernel itself runs only
on a GPU (``chip_smoke.py``); here CUDA-typed CPU tensors and a recording
stand-in for its library show what the wrapper launches (the twenty
formats beyond Q8_0, Q4_K and Q6_K from ``rand_raw`` bytes through the
port's repack: no JAX quantizer needed). Tolerances: the plain
version against JAX ``_qmatmul_mv`` in interpret mode, NMSE < 1e-10 (the
integer group dots are exact; only the f32 summation order differs);
``quantize_acts`` bit for bit.
"""

import dataclasses
import inspect
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from test_torch_fixtures import cuda_typed, failing_build

from superllama_tpu.gguf import GGMLType, quantize
from superllama_tpu.ops import qtensor as jqt
from superllama_tpu.ops.qmatmul import _qmatmul_mv, _quantize_acts
from superllama_tpu_torch.models.synthetic import rand_raw
from superllama_tpu_torch.ops import _build
from superllama_tpu_torch.ops import qmatmul as qm
from superllama_tpu_torch.ops import qtensor as tqt

FMT = {GGMLType.Q8_0: 0, GGMLType.Q4_K: 1, GGMLType.Q6_K: 2}
# the qmv kernel's format of every other type (csrc/qmv.cu FMT 0-8)
NEW_FMT = {GGMLType.Q5_0: 0, GGMLType.MXFP4: 0, GGMLType.IQ4_NL: 0, GGMLType.IQ4_XS: 0,
           GGMLType.IQ2_XXS: 0, GGMLType.IQ3_XXS: 0, GGMLType.IQ3_S: 0, GGMLType.Q5_1: 3,
           GGMLType.IQ1_S: 3, GGMLType.Q3_K: 4, GGMLType.IQ2_XS: 4, GGMLType.IQ2_S: 4,
           GGMLType.Q2_K: 4, GGMLType.IQ1_M: 5, GGMLType.Q8_K: 6, GGMLType.TQ1_0: 6,
           GGMLType.TQ2_0: 6, GGMLType.Q4_0: 7, GGMLType.Q4_1: 7, GGMLType.Q5_K: 8}
ALL_FMT = {**FMT, **NEW_FMT}
FMTS = range(9)
UNIT = qm._QMV_UNIT                         # K elements a split unit, by format
SMEM_LIMIT = 227 * 1024                     # shared memory a block may take on the H100
# (K, N) of a decode step's matmuls at Llama-3-8B width: wq/wo, wk/wv, ffn
# gate/up, ffn down, the output head; and at Llama-3.2-1B width (the draft)
KN_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
KN_1B = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048), (2048, 128256)]
# the (K, N) of tests/test_torch_qmatmul.py's SHAPES, and a ragged N
EDGE_KN = [(512, 64), (512, 128), (1024, 96), (768, 64), (768, 128), (544, 128),
           (512, 640), (1024, 1000)]
# the (K, N) the state-space models add: falcon-mamba-7B's ssm_in, ssm_x
# (N = dt rank + 2 d_state), ssm_dt (K = the dt rank, one super-block),
# ssm_out and head; Bamba-9B's ssm_in (N = 2 d_inner + 2 G d_state + heads)
KN_SSM = [(4096, 16384), (8192, 288), (256, 8192), (8192, 4096), (4096, 65024),
          (4096, 16768)]
PLAN_CASES = [(f, K, N) for f in FMTS for K, N in KN_8B + EDGE_KN + KN_1B + KN_SSM
              if K % UNIT[f] == 0]
PLAN_IDS = [f"fmt{f}-{K}x{N}" for f, K, N in PLAN_CASES]


@pytest.mark.parametrize("fmt,K,N", PLAN_CASES, ids=PLAN_IDS)
def test_plan_covers_every_k_unit_once(fmt, K, N):
    """Every K unit belongs to exactly one rank of the cluster, no rank is
    empty, the cluster is at most 8 blocks, and a block's shared memory
    fits the card at every row count."""
    p = qm.qmv_plan(fmt, K, N)
    n_units = K // UNIT[fmt]
    seen = np.zeros(n_units, np.int64)
    for rank in range(p.cl):
        units = range(rank * p.per, min((rank + 1) * p.per, n_units))
        assert len(units) >= 1
        seen[units.start:units.stop] += 1
    assert (seen == 1).all()
    assert 1 <= p.cl <= 8 and p.bn in (128, 64, 32)
    assert p.blocks == -(-N // p.bn) * p.cl
    assert p.smem == max(qm._qmv_smem(fmt, p.bn, rows) for rows in (8, 16)) <= SMEM_LIMIT


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("K,N", KN_8B + KN_1B)
def test_plan_fills_the_card(fmt, K, N):
    """At every 8B decode shape the grid gives each of the H100's 132 SMs
    a block (at the 1B's shapes too, where a grid of 8 ranks can: its k/v,
    (2048, 512), has at most 128 blocks), and two blocks fit an SM's 228 KB
    of shared memory."""
    p = qm.qmv_plan(fmt, K, N)
    n_units = K // UNIT[fmt]
    most = max(-(-N // bn) * min(8, n_units) for bn in (128, 64, 32))
    assert p.blocks >= min(132, most)
    if (K, N) in KN_8B:
        assert p.blocks >= 132
    assert 2 * (p.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("fmt,K,N", [(f, K, N) for f in FMTS for K, N in KN_SSM
                                     if K % UNIT[f] == 0])
def test_plan_fills_the_card_at_the_ssm_shapes(fmt, K, N):
    """At the SSM models' shapes the grid gives the 132 SMs a block where
    the columns and 8 ranks can (ssm_x's 288 columns make 72 at most)."""
    p = qm.qmv_plan(fmt, K, N)
    most = max(-(-N // bn) * min(8, K // UNIT[fmt]) for bn in (128, 64, 32))
    assert p.blocks >= min(132, most)
    assert 2 * (p.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("bn", [128, 64, 32])
def test_smem_allows_two_blocks_an_sm(fmt, bn):
    """Every instantiation (each column tile, 8 and 16 rows) fits two
    blocks in an SM's 228 KB (1 KB of it reserved a block), as the
    kernel's launch bounds ask and the plan's residency table assumes."""
    for rows in (1, 8, 16):
        assert 2 * (qm._qmv_smem(fmt, bn, rows) + 1024) <= 228 * 1024


@pytest.mark.parametrize("ttype", sorted(ALL_FMT), ids=lambda t: t.name)
def test_format_of_each_type(ttype):
    """Each type's layout goes to the kernel format that reads it: 0 the
    int8 gs-32 planes without adds (Q8_0's), 3-6 int8 with adds, gs 16, gs
    8 and gs 256, 7 the nibbles with f32 scales, 1, 2, 8 Q4_K, Q6_K and
    Q5_K compact."""
    assert qm.qmv_fmt(qm._FMT[ttype]) == ALL_FMT[ttype]


@pytest.mark.parametrize("ttype", sorted(ALL_FMT), ids=lambda t: t.name)
def test_group_dot_stays_in_the_magic_range(ttype):
    """The kernel turns each product's s32 sum into an f32 by starting it
    from 1.5 * 2^23's bit pattern, exact while |dot| < 2^22. A group's
    dot at its largest: x codes of magnitude 127 (quantize_acts' most,
    signed as the weights) against the layout's largest code magnitude,
    over the whole group (gs 256: eight m16n8k32 products summed in s32).
    For gs 256 that is 256 * 128 * 127 = 4,161,536 < 4,194,304."""
    t = _port_weight(ttype, 64, 512)
    codes = tqt.unpack_nib4(t.codes, t.K).to(torch.int64) if t.nibble else t.codes.to(torch.int64)
    if t.hi is not None:
        codes = codes + (tqt.unpack_bits(t.hi, t.hi_bits, t.K).to(torch.int64) << 4)
    xq, _, _ = qm.quantize_acts(torch.full((1, 512), -3.0), t.group)
    assert int(xq.abs().max()) == 127
    gs = t.group
    worst = 127 * codes.abs().reshape(512 // gs, gs, 64).sum(dim=1).max()
    assert int(worst) < 2 ** 22
    # the type's most extreme codes the format can hold: int8 -128..127,
    # nibbles 0..15 (+16, +32, +48 from a hi plane)
    top = 128 if t.codes.dtype == torch.int8 else (16 << t.hi_bits) - 1
    assert gs * top * 127 < 2 ** 22


def test_plan_at_the_8b_shapes():
    """The Q4_K grids of a decode step: 128-column tiles under a cluster
    that keeps every block resident at once (6 ranks at q/o, 7 at down, 2
    at gate/up, none at the head; a cluster of 8 holds only 240 blocks of
    the H100's 264), 32-column tiles under 6 ranks at wk/wv (192 blocks)."""
    got = {(K, N): qm.qmv_plan(1, K, N)[:4] for K, N in KN_8B}
    assert got == {(4096, 4096): (128, 6, 3, 192), (4096, 1024): (32, 6, 3, 192),
                   (4096, 14336): (128, 2, 8, 224), (14336, 4096): (128, 7, 8, 224),
                   (4096, 128256): (128, 1, 16, 1002)}
    for K, N in KN_8B[:4]:
        p = qm.qmv_plan(1, K, N)
        assert p.blocks <= qm._QMV_CLUSTER_RESIDENT[p.cl]


def test_plan_is_a_function_of_fmt_k_and_n():
    """The plan takes no row count, so a row's sums are the same in a 1-,
    an 8- and a 16-row call."""
    assert list(inspect.signature(qm.qmv_plan).parameters) == ["fmt", "K", "N"]
    assert qm.qmv_plan(1, 4096, 14336) == qm.qmv_plan(1, 4096, 14336)


def _port_weight(ttype, N, K, seed=0):
    """The port's repack of seeded random block bytes of the type."""
    return tqt.repack(rand_raw(ttype, N, K, seed), ttype, (N, K))


def _weights(ttype, N, K, seed=0):
    rng = np.random.default_rng(int(ttype) + N + K + seed)
    w = (rng.normal(0, 0.4, (N, K)) + 0.05 * np.cos(np.arange(K))).astype(np.float32)
    raw = quantize(w, ttype)
    return jqt.repack(raw, ttype, (N, K)), tqt.repack(raw, ttype, (N, K))


class _Recorder:
    """Stands in for the kernel's C entry: records each call's arguments."""

    def __init__(self):
        self.calls = []
        self.argtypes = None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_qmv(monkeypatch):
    """CUDA-typed tensors reach a recording qmv library; torch.empty records
    every allocation; the plain version raises if reached."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(slt_qmv=rec))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 7)
    allocs = []
    empty = torch.empty

    def recording_empty(*args, **kw):
        kw.pop("device", None)
        t = cuda_typed(empty(*args, **kw))
        allocs.append(t)
        return t

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(qm, "qmv_plain", plain)
    return rec, allocs


@pytest.mark.parametrize("ttype", sorted(ALL_FMT), ids=lambda t: t.name)
@pytest.mark.parametrize("M", [1, 8, 16, 20])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrapper_launches_once_with_the_plan(fake_qmv, ttype, M, dt):
    """One launch a call of at most 16 rows with the type's kernel format,
    the plan's tile, cluster and units, the weight planes (adds included)
    and x as given, the codes' offset, and no allocation but the output
    (20 rows: two calls of 16 and 4): no partials, no second launch."""
    rec, allocs = fake_qmv
    K, N = 1024, 96
    tq = _weights(ttype, N, K)[1] if ttype in FMT else _port_weight(ttype, N, K)
    planes = {n: cuda_typed(p) for n, p in tq.planes().items()}
    tq = dataclasses.replace(tq, **planes)
    x = cuda_typed(torch.zeros((M, K), dtype=dt))
    before = qm.qmv.launches
    out = qm.qmv(x, tq, dt)
    assert out.shape == (M, N) and out.dtype == dt
    chunks = [min(16, M - i) for i in range(0, M, 16)]
    assert qm.qmv.launches - before == len(rec.calls) == len(chunks)
    assert [tuple(a.shape) for a in allocs] == [(m, N) for m in chunks]
    plan = qm.qmv_plan(ALL_FMT[ttype], K, N)
    ptr = lambda name: None if getattr(tq, name) is None else getattr(tq, name).data_ptr()
    for i, (args, rows, o) in enumerate(zip(rec.calls, chunks, allocs)):
        assert args[:4] == (ALL_FMT[ttype], rows, K, N)
        assert args[4] == x.data_ptr() + i * 16 * K * x.element_size()
        assert args[5] == int(dt == torch.bfloat16)
        assert args[6:14] == tuple(ptr(n) for n in ("codes", "hi", "scales", "sc", "mn", "d",
                                                     "dmin", "adds"))
        assert args[14] == tq.offset
        assert args[15:18] == (plan.bn, plan.cl, plan.per)
        assert args[18:] == (o.data_ptr(), int(dt == torch.bfloat16), 7)


def test_wrapper_realigns_x(fake_qmv):
    """x rows are read in 8- and 16-byte words: an x that does not start on
    16 bytes goes in as an aligned copy."""
    rec, _ = fake_qmv
    _, tq = _weights(GGMLType.Q4_K, 64, 512)
    tq = dataclasses.replace(tq, **{n: cuda_typed(p) for n, p in tq.planes().items()})
    x = cuda_typed(torch.zeros(4 * 512 + 1, dtype=torch.bfloat16)[1:].reshape(4, 512))
    assert x.data_ptr() % 16
    qm.qmv(x, tq, torch.bfloat16)
    assert rec.calls[-1][4] % 16 == 0 and rec.calls[-1][4] != x.data_ptr()


# a type of each kernel format
FMT_TYPES = [GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_1, GGMLType.Q3_K,
             GGMLType.IQ1_M, GGMLType.Q8_K, GGMLType.Q4_0, GGMLType.Q5_K]


@pytest.mark.parametrize("ttype", FMT_TYPES, ids=lambda t: t.name)
def test_failed_build_raises(monkeypatch, ttype):
    """A CUDA tensor launches the kernel or raises: when the build fails, qmv
    raises that failure, counts no launch and runs no plain version."""
    build_failed = failing_build(monkeypatch)
    tq = _weights(ttype, 64, 512)[1] if ttype in FMT else _port_weight(ttype, 64, 512)
    tq = dataclasses.replace(tq, **{n: cuda_typed(p) for n, p in tq.planes().items()})
    before = qm.qmv.launches
    with pytest.raises(build_failed):
        qm.qmv(cuda_typed(torch.zeros((8, 512), dtype=torch.bfloat16)), tq, torch.bfloat16)
    assert qm.qmv.launches == before


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


@pytest.mark.parametrize("ttype", list(FMT), ids=lambda t: t.name)
@pytest.mark.parametrize("M", [1, 8, 16])
def test_plain_matches_jax_at_k4096(ttype, M):
    """qmv_plain, which the kernel is held to on the card, against the JAX
    kernel at the decode steps' K, a narrow N."""
    K, N = 4096, 32
    jq, tq = _weights(ttype, N, K, seed=M)
    x = np.random.default_rng(M).normal(0, 1, (M, K)).astype(np.float32)
    xp = np.pad(x, ((0, (-M) % 8), (0, 0)))
    ref = np.asarray(_qmatmul_mv(jnp.asarray(xp), jq, interpret=True))[:M]
    got = qm.qmv_plain(torch.from_numpy(x), tq, torch.float32)
    assert got.shape == (M, N)
    assert _nmse(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("gs", [16, 32])
def test_quantize_acts_edges_match_jax(gs):
    """The quantizer the kernel reproduces, bit for bit against JAX's, on
    rows with an all-zero group, a single large value among small ones, a
    lone negative value, and halves that round to even."""
    rng = np.random.default_rng(gs)
    x = rng.normal(0, 1e-3, (4, 4 * gs)).astype(np.float32)
    x[0, :gs] = 0.0                                   # an all-zero group
    x[1, gs + 3] = 3.0e4                              # one large value
    x[2, 2 * gs:3 * gs] = 0.0
    x[2, 2 * gs + 5] = -7.5                           # a lone negative value
    x[3, :gs] = np.arange(gs, dtype=np.float32) - gs / 2 + 0.5
    x[3, gs - 1] = 127.0                              # codes at exact halves
    xq, sx, xs = qm.quantize_acts(torch.from_numpy(x), gs)
    jxq, jsx, jxs = _quantize_acts(jnp.asarray(x), gs)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    assert (xq.numpy()[0, :gs] == 0).all() and sx.numpy()[0, 0] == 0.0
