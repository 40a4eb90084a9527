"""The tensor-core qmm kernel's layouts, ring and launch arguments for every
weight format.

``qmv`` and ``qmm`` read the 23 repacked types in the same nine layouts
(``qmv_fmt``); qmm's tensor-core kernel has eleven instantiations of them
(layouts 4 and 7 with an f32 adds plane and without). Here: each type's
layout against its repacked planes, each instantiation's ring of stages
under a block's share at two blocks an SM (``_qmm_smem``, the mirror of
``Stage<L, ADDS>`` in csrc/qmm.cu), and what the wrapper hands the
kernel's C entries for every type at 17 and 32 rows. The kernel itself runs
only on a GPU (``chip_smoke.py`` holds each call to its instantiation and
its occupancy on the card); here CUDA-typed CPU tensors and recording
stand-ins for the library show what the wrapper launches. No JAX: the
weights are ``rand_raw`` bytes through the port's repack.
"""

import dataclasses
import types

import pytest
import torch
from test_torch_fixtures import cuda_typed

from superllama_tpu_torch.gguf.constants import GGMLType
from superllama_tpu_torch.models.synthetic import rand_raw
from superllama_tpu_torch.ops import _build
from superllama_tpu_torch.ops import qmatmul as qm
from superllama_tpu_torch.ops import qtensor as tqt

# each type's layout (csrc/qmm.cu and csrc/qmv.cu FMT)
LAYOUT = {GGMLType.Q8_0: 0, GGMLType.Q5_0: 0, GGMLType.MXFP4: 0, GGMLType.IQ4_NL: 0,
          GGMLType.IQ4_XS: 0, GGMLType.IQ2_XXS: 0, GGMLType.IQ3_XXS: 0, GGMLType.IQ3_S: 0,
          GGMLType.Q4_K: 1, GGMLType.Q6_K: 2, GGMLType.Q5_1: 3, GGMLType.IQ1_S: 3,
          GGMLType.Q3_K: 4, GGMLType.IQ2_XS: 4, GGMLType.IQ2_S: 4, GGMLType.Q2_K: 4,
          GGMLType.IQ1_M: 5, GGMLType.Q8_K: 6, GGMLType.TQ1_0: 6, GGMLType.TQ2_0: 6,
          GGMLType.Q4_0: 7, GGMLType.Q4_1: 7, GGMLType.Q5_K: 8}
ALL = sorted(LAYOUT)
ID = lambda t: t.name
GS = (32, 32, 16, 32, 16, 8, 256, 32, 32)        # each layout's group size
NIBBLE = {1, 2, 7, 8}                            # layouts of 4-bit codes
# each instantiation's ring stages: as many as fit at two blocks an SM
# (Q4_K keeps 4; IQ1_M's gs-8 scale and add rows leave room for 2)
STAGES = {(0, False): 3, (1, False): 4, (2, False): 4, (3, True): 3, (4, False): 3,
          (4, True): 3, (5, True): 2, (6, False): 4, (7, False): 5, (7, True): 5,
          (8, False): 5}
BLOCK_SMEM = 113 * 1024                          # a block's share of an H100 SM at two an SM
FAMILY = {GGMLType.Q8_0: None, GGMLType.Q4_K: None, GGMLType.Q6_K: None,
          GGMLType.Q4_0: "nib", GGMLType.Q4_1: "nib", GGMLType.Q5_K: "q5k"}
K, N = 1024, 128                                 # the launch cells' weight
# the served (K, N) (the 8B's q/o, k/v, gate/up, down, the 1B's four) and the
# K split qmm_plan gives each: one block a SM (at most 132) where a block
# then holds at most 16 k-tiles, the fastest split of each on the H100
PLANS = {(4096, 4096): (4, 8), (4096, 1024): (16, 2), (4096, 14336): (2, 16),
         (14336, 4096): (8, 14), (2048, 2048): (8, 2), (2048, 512): (16, 1),
         (2048, 8192): (2, 8), (8192, 2048): (8, 8),
         # the state-space models' (K, N): falcon-mamba-7B's ssm_in, ssm_x,
         # ssm_dt, ssm_out; Bamba-9B's ssm_in
         (4096, 16384): (2, 16), (8192, 288): (32, 2), (256, 8192): (2, 1),
         (8192, 4096): (4, 16), (4096, 16768): (2, 16)}


def _weight(ttype, n=N, k=K):
    return tqt.repack(rand_raw(ttype, n, k, 5), ttype, (n, k))


def _cuda(t):
    return dataclasses.replace(t, **{n: cuda_typed(p) for n, p in t.planes().items()})


_WEIGHTS: dict = {}


def _cuda_weight(ttype):
    if ttype not in _WEIGHTS:
        _WEIGHTS[ttype] = _cuda(_weight(ttype))
    return _WEIGHTS[ttype]


@pytest.mark.parametrize("ttype", ALL, ids=ID)
def test_each_type_has_its_layout(ttype):
    """The type's layout id (one table for both kernels) agrees with
    ``layout()`` of its repacked planes: group size, code width, adds and
    offset; its weights have one of qmm's instantiations."""
    t = _weight(ttype, 64, 256)
    lay = qm.layout(t)
    fmt = qm.qmv_fmt(lay)
    assert fmt == qm.qmv_fmt(qm._FMT[ttype]) == LAYOUT[ttype]
    assert lay.group == GS[fmt]
    assert (lay.code_bits == 4) == (fmt in NIBBLE)
    assert (lay.scales == "superblock") == (fmt in (1, 2, 8))
    if fmt in (3, 5):
        assert t.adds is not None
    if fmt in (0, 6):
        assert not lay.adds and t.adds is None
    if fmt == 0:   # Q8_0's path: int8 codes, no offset
        assert lay.offset == 0 and lay.code_bits == 8
    assert (fmt, t.adds is not None) in qm._QMM_INSTANCES


@pytest.mark.parametrize("fmt,adds", list(STAGES), ids=lambda v: str(v))
def test_qmm_ring_fits_two_blocks_an_sm(fmt, adds):
    """Each instantiation's ring (``_qmm_smem``): its stage count, under a
    block's share at two blocks an SM, at least 3 stages wherever the planes
    allow it, and no room for one more (but Q4_K, which keeps 4)."""
    nst, smem = qm._qmm_smem(fmt, adds)
    assert nst == STAGES[(fmt, adds)]
    assert smem <= BLOCK_SMEM
    stage = (smem - 16 * nst) // nst
    if fmt != 1:
        assert (nst + 1) * (stage + 16) > BLOCK_SMEM
    assert nst >= 3 or 3 * (stage + 16) > BLOCK_SMEM
    assert (fmt, adds) in qm._QMM_INSTANCES


def test_qmm_ring_holds_only_the_rows_a_layout_reads():
    """A stage holds BK / gs scale rows (one at gs 256) and add rows only
    with adds: the planar layouts' stages differ by exactly those rows."""
    row = qm._QMM_BN * 4
    stage = lambda f, a: (lambda n, s: (s - 16 * n) // n)(*qm._qmm_smem(f, a))
    assert stage(4, True) - stage(4, False) == 8 * row          # gs 16: 8 add rows
    assert stage(7, True) - stage(7, False) == 4 * row          # gs 32: 4 add rows
    assert stage(4, False) - stage(0, False) == 4 * row         # gs 16 against gs 32
    assert stage(0, False) - stage(6, False) == 3 * row         # gs 32 against gs 256
    assert stage(5, True) - stage(3, True) == 24 * row          # gs 8 against gs 32, adds


@pytest.mark.parametrize("k,n", list(PLANS), ids=lambda v: str(v))
def test_qmm_plan_at_the_served_shapes(k, n):
    """Each served (K, N) gets its split, which covers every k-tile once
    (no split empty) and takes one block a SM where a block then holds at
    most 16 k-tiles; the plan reads (K, N) only, the same for every
    layout, so a row's sums do not depend on the call's rows."""
    n_split, per = qm.qmm_plan(k, n)
    assert (n_split, per) == PLANS[(k, n)]
    n_tiles, n_col = -(-k // 128), -(-n // 128)
    seen = [0] * n_tiles
    for sp in range(n_split):
        tiles = range(sp * per, min((sp + 1) * per, n_tiles))
        assert len(tiles) >= 1
        for t in tiles:
            seen[t] += 1
    assert seen == [1] * n_tiles
    if n_col * n_split <= 132:
        assert per <= 16
    else:   # one block a SM would leave a block more than 16 k-tiles
        assert -(-n_tiles // (132 // n_col)) > 16


@pytest.fixture
def fake_qmm(monkeypatch):
    """CUDA-typed tensors reach recording stand-ins for qmm's two C entries;
    torch.empty records every allocation; the plain version raises."""
    calls = {"qmm": [], "qmm_tc": []}

    def rec(name):
        def fn(*args):
            calls[name].append(args)
            return 0
        fn.argtypes = None
        return fn

    lib = types.SimpleNamespace(slt_qmm=rec("qmm"), slt_qmm_tc=rec("qmm_tc"))
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 7)
    allocs = calls["allocs"] = []
    empty = torch.empty

    def recording_empty(*a, **kw):
        t = cuda_typed(empty(*a, **{k: v for k, v in kw.items() if k != "device"}))
        allocs.append(t)
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(qm, "qmm_plain", plain)
    return calls


def _family(ttype):
    return FAMILY.get(ttype, "i8")


@pytest.mark.parametrize("M", [17, 32])
@pytest.mark.parametrize("ttype", ALL, ids=ID)
def test_qmm_tc_gets_the_layout_and_plan(fake_qmm, ttype, M):
    """A bf16 call launches the tensor-core entry once with the type's
    layout, its group size, its adds plane or null, its offset and
    qmm_plan's split (partials allocated only when K is split), and adds
    one to the wrapper's count and to its family's."""
    t = _cuda_weight(ttype)
    fam = _family(ttype)
    before = (qm.qmm.launches, fam and getattr(qm.qmm, f"launches_{fam}"))
    out = qm.qmm(cuda_typed(torch.zeros((M, K), dtype=torch.bfloat16)), t, torch.bfloat16)
    assert out.shape == (M, N)
    assert (qm.qmm.launches, fam and getattr(qm.qmm, f"launches_{fam}")) == (
        before[0] + 1, fam and before[1] + 1)
    (a,) = fake_qmm["qmm_tc"]
    assert not fake_qmm["qmm"]
    ptr = lambda n: None if getattr(t, n) is None else getattr(t, n).data_ptr()
    assert a[:4] == (LAYOUT[ttype], M, K, N)
    assert a[5:13] == tuple(ptr(n) for n in ("codes", "hi", "scales", "sc", "mn", "d", "dmin",
                                             "adds"))
    assert a[13:15] == (GS[LAYOUT[ttype]], t.offset)
    n_split, per = qm.qmm_plan(K, N)
    assert a[15:17] == (n_split, per)
    shapes = [tuple(o.shape) for o in fake_qmm["allocs"]]
    assert shapes == [(M, N)] + ([(n_split, M, N)] if n_split > 1 else [])
    assert a[17] == (fake_qmm["allocs"][1].data_ptr() if n_split > 1 else None)


@pytest.mark.parametrize("ttype", ALL, ids=ID)
def test_qmm_f32_entry_gets_the_same_layout(fake_qmm, ttype):
    """f32 x takes the CUDA-core entry, with the same layout id, adds, group
    size and offset (the kernel maps the layout to its own int8, nibble or
    compact path)."""
    t = _cuda_weight(ttype)
    qm.qmm(cuda_typed(torch.zeros((24, K))), t, torch.float32)
    (a,) = fake_qmm["qmm"]
    assert not fake_qmm["qmm_tc"]
    assert a[:4] == (LAYOUT[ttype], 24, K, N)
    assert a[13:16] == (None if t.adds is None else t.adds.data_ptr(), GS[LAYOUT[ttype]],
                        t.offset)
